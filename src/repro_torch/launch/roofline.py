"""Roofline terms of a dry-run record (no hardware needed), the
counterpart of the reference package's ``launch/roofline.py``.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, from
NVIDIA's datasheet (these are the card's published peaks, not
measurements of this repository's code):

    peak bf16 dense tensor compute : 989e12 FLOP/s per card
    peak f32 (CUDA cores)          : 67e12 FLOP/s per card
    HBM3 bandwidth                 : 3.35e12 B/s per card
    NVLink 4 (inside a node of 8)  : 450e9 B/s per direction per card
    InfiniBand NDR (across nodes)  : 50e9 B/s per card (400 Gb/s)

A collective over a group of at most ``GPUS_PER_NODE`` ranks runs on
NVLink; a larger group spans nodes and is held to the InfiniBand rate.

Terms (seconds, per step, per card):
    compute    = flops            / (cards * PEAK_FLOPS)
    memory     = hbm_bytes        / (cards * HBM_BW)
    collective = collective_bytes / (cards * link rate)

The reference parses collective bytes out of XLA's optimized HLO; the
port has no HLO.  Its dry run (``launch/dryrun.py``) runs the real step
with the rank's ``launch/sharding.ParallelContext`` in ``record`` mode,
which logs every collective it runs (op, bytes, group size); the
algorithmic factor below turns those into the bytes a device moves: an
all-reduce moves 2(n-1)/n x its bytes, an all-gather or reduce-scatter
(n-1)/n x the whole tensor's.
"""
from __future__ import annotations

import json
import os
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
PEAK_FLOPS_F32 = 67e12       # f32 FLOP/s per card (CUDA cores)
HBM_BW = 3.35e12             # B/s per card
NVLINK_BW = 450e9            # B/s per direction per card, NVLink 4
IB_BW = 50e9                 # B/s per card, InfiniBand NDR 400 Gb/s
GPUS_PER_NODE = 8

# the names chip_smoke.py's bounds use
HBM_BYTES_PER_S = HBM_BW
PEAK_OPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS}


def link_bw(group_size: int) -> float:
    """The per-card link rate of a collective over ``group_size`` ranks."""
    return NVLINK_BW if group_size <= GPUS_PER_NODE else IB_BW


def _algo_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("all-gather", "reduce-scatter"):
        return (n - 1) / n
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute: one hop


# --------------------------------------------------------------------------- #
# Roofline terms
# --------------------------------------------------------------------------- #
def terms(flops: float, bytes_hbm: float, coll_bytes: float,
          n_chips: int, link: float = NVLINK_BW) -> Dict:
    t_c = flops / (n_chips * PEAK_FLOPS)
    t_m = bytes_hbm / (n_chips * HBM_BW)
    t_x = coll_bytes / (n_chips * link)
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bound": dom[0], "step_s": dom[1],
            "roofline_fraction": (t_c / dom[1]) if dom[1] > 0 else 0.0}


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N per decoded
    token; D = tokens per step."""
    n_active = cfg.n_params(active_only=True)
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch     # decode: 1 token/seq


def collective_seconds(records: list) -> float:
    """Per-card seconds of a rank's collective records (``launch/sharding``
    ``record`` mode), each group at its own link rate."""
    return sum(r["bytes"] * _algo_factor(r["op"], r["n"]) / link_bw(r["n"])
               for r in records)


def summarize(rec: dict, cfg, shape, tp: int = 16, dp: int = 16) -> dict:
    """Combine a dry-run record into the roofline row.  A record is one
    rank's: its counted FLOPs are per card, and its collectives' seconds
    are those of one card at the links' rates.  The dry run counts no
    memory traffic (the reference's came from XLA's cost analysis), so
    the memory term takes ``analysis``'s HBM bytes for ``(tp, dp)``."""
    from repro_torch.launch.analysis import analytic_cell
    n = rec.get("n_devices", tp * dp)
    flops = rec.get("cost", {}).get("flops") or 0.0
    hbm = analytic_cell(cfg, shape, tp=tp, dp=dp)["hbm_bytes"]
    t = terms(flops * n, hbm, 0.0, n)
    t["collective_s"] = rec.get("collectives", {}).get("seconds", 0.0)
    dom = max(("compute", t["compute_s"]), ("memory", t["memory_s"]),
              ("collective", t["collective_s"]), key=lambda kv: kv[1])
    t["bound"], t["step_s"] = dom
    t["roofline_fraction"] = t["compute_s"] / dom[1] if dom[1] > 0 else 0.0
    mf = model_flops(cfg, shape, SHAPE_KIND[shape.name])
    t["model_flops"] = mf
    t["counted_flops_total"] = flops * n
    t["useful_fraction"] = mf / max(flops * n, 1.0)
    t["mfu_at_roofline"] = mf / (n * PEAK_FLOPS * max(t["step_s"], 1e-12))
    return t


SHAPE_KIND = {"train_4k": "train", "prefill_32k": "prefill",
              "decode_32k": "decode", "long_500k": "decode"}


def load_results(out_dir: str):
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                rows.append(json.load(f))
    return rows
