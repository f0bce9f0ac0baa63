"""The port's dry run and roofline (``repro_torch.launch.{shapes,analysis,
roofline,dryrun,report}``) on the CPU, on ``device="meta"``.

* ``analysis`` gives the reference's numbers bit for bit, for every arch,
  shape and (tp, dp) of the report (and (4, 64)).
* The dry run's command line on the (16, 16) ``MeshShape`` for
  ``qwen3-0.6b/train_4k``, ``olmoe-1b-7b/prefill_32k`` (cut to 4 layers)
  and ``hymba-1.5b/long_500k``: ``status: ok``; the argument bytes equal
  the sum over one rank's shard shapes (parameters, AdamW moments, batch
  or cache); the FLOPs ``FlopCounterMode`` counted, times the 256 ranks,
  within ``FLOP_BAND`` of ``analysis.train_flops`` / ``prefill_flops``
  (the counter sees every iteration; the port's departures, such as
  computing only the KV heads a rank reads, keep it within a few per
  cent); the per-layer activation all-reduces over ``model`` (bf16, one
  rank's tokens x d_model) equal ``analysis``'s TP collective bytes: all
  of ``train_collective_bytes`` for training (2 forward and 2 backward a
  layer; remat's recomputed forward is recorded apart), half of it for
  prefill (the forward's 2; the reference's prefill estimate divides the
  training figure by 3), and ``decode_collective_bytes``' layer term
  times the data ranks for a batch of 1 (which does not split over them).
* ``long_500k`` is skipped on a dense arch with the reference's reason,
  and ``report`` renders the table of the records.
* ``roofline.summarize`` turns each record into a row: the counted FLOPs
  over the bf16 peak, ``analysis``' HBM bytes over the HBM rate, the
  recorded collectives' seconds, and the largest of the three as bound.
"""
import json
import os

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import analysis as JA
from repro.launch import shapes as JSH

from repro_torch import configs
from repro_torch.launch import analysis, dryrun, report, roofline, sharding
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as MD

FLOP_BAND = (0.9, 1.1)
CELLS = [("qwen3-0.6b", "train_4k", []),
         ("olmoe-1b-7b", "prefill_32k", ["--layers", "4"]),
         ("hymba-1.5b", "long_500k", [])]


@pytest.mark.parametrize("tp,dp", [(16, 16), (16, 32), (4, 64)])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_analysis_bit_equal_to_reference(arch, tp, dp):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in SH.SHAPES:
        s, js = SH.SHAPES[name], JSH.SHAPES[name]
        assert analysis.analytic_cell(cfg, s, tp, dp) == JA.analytic_cell(jcfg, js, tp, dp)
        assert analysis.hlo_counted_flops(cfg, s) == JA.hlo_counted_flops(jcfg, js)
        for fsdp in (False, True):
            assert (analysis.train_collective_bytes(cfg, s, tp, dp, fsdp)
                    == JA.train_collective_bytes(jcfg, js, tp, dp, fsdp))
        assert (analysis.decode_collective_bytes(cfg, s, tp, dp)
                == JA.decode_collective_bytes(jcfg, js, tp, dp))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    for arch, shape, extra in CELLS:
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", out] + extra)
    recs = {}
    for arch, shape, _ in CELLS:
        with open(os.path.join(out, f"{configs.canonical(arch)}-{shape}-single.json")) as f:
            recs[arch] = json.load(f)
    return out, recs


def _cfg(arch, extra):
    cfg = configs.get(arch)
    if extra:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=int(extra[1]))
    return cfg


def _argument_bytes(cfg, shape, mesh) -> int:
    """One rank's parameters, AdamW moments (training) and inputs, from
    the specs' local shapes."""
    specs = MD.flatten(sharding.param_specs(cfg, MD.param_shapes(cfg), mesh))
    p = sum(int(np.prod(sharding.local_shape(s, specs[k], mesh)))
            for k, s in MD.flatten(MD.param_shapes(cfg)).items())
    per = 4 if cfg.param_dtype == "float32" else 2
    rows = shape.global_batch // 16 if shape.global_batch % 16 == 0 else shape.global_batch
    if shape.kind == "train":
        return p * per + 2 * p * 4 + 4 + rows * shape.seq_len * 4
    if shape.kind == "prefill":
        return p * per + rows * shape.seq_len * 4
    ac = sharding.make_ac(mesh, cfg, mode="record")
    cache = sum(int(np.prod(s)) * (4 if dt == "float32" else 2)
                for s, dt in MD.cache_shapes(cfg, rows, shape.seq_len, ac).values())
    cdt = 2 if cfg.compute_dtype == "bfloat16" else 4
    keep = {"A_log", "dt_bias", "D", "final_norm"}
    w = sum(int(np.prod(sharding.local_shape(s, specs[k], mesh)))
            * (4 if k.split("/")[-1] in keep else cdt)
            for k, s in MD.flatten(MD.param_shapes(cfg)).items())
    return w + cache + rows * 4 * 2


@pytest.mark.parametrize("cell", range(len(CELLS)))
def test_dryrun_record(records, cell):
    arch, shape_name, extra = CELLS[cell]
    rec = records[1][arch]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256
    cfg, shape = _cfg(arch, extra), SH.SHAPES[shape_name]
    mesh = MeshShape((16, 16))
    assert rec["memory"]["argument_bytes"] == _argument_bytes(cfg, shape, mesh)
    assert rec["memory"]["temp_bytes"] > 0
    counted = rec["cost"]["flops"] * 256
    tp, dp, d = 16, 16, cfg.d_model
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
    tokens = rows * (shape.seq_len if shape.kind != "decode" else 1)
    layer = [e for e in rec["collectives"]["by_size"]
             if e["op"] == "all-reduce" and e["axis"] == "model"
             and e["phase"] in ("fwd", "bwd") and e["bytes"] == tokens * d * 2]
    ar = 2 * (tp - 1) / tp
    ours = sum(e["count"] * e["bytes"] * ar for e in layer) * 256
    if shape.kind == "train":
        assert FLOP_BAND[0] <= counted / analysis.train_flops(cfg, shape) <= FLOP_BAND[1]
        assert ours == pytest.approx(
            analysis.train_collective_bytes(cfg, shape, tp, 1, False), rel=1e-12)
        assert sum(e["count"] for e in layer) == 4 * cfg.n_layers
    elif shape.kind == "prefill":
        assert FLOP_BAND[0] <= counted / analysis.prefill_flops(cfg, shape) <= FLOP_BAND[1]
        assert ours == pytest.approx(
            analysis.train_collective_bytes(cfg, shape, tp, 1, False) / 2, rel=1e-12)
    else:
        head = tp * shape.global_batch * cfg.vocab_size * cfg.n_codebooks * 2 * ar
        want = analysis.decode_collective_bytes(cfg, shape, tp, 1) - head
        assert ours == pytest.approx(want * dp, rel=1e-12)


def test_dense_arch_skips_long_context():
    rec = dryrun.run_cell("qwen3-0.6b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == JSH.skip_reason(jconfigs.get("qwen3-0.6b"),
                                            JSH.SHAPES["long_500k"])


def test_report_renders_the_table(records, tmp_path):
    out, recs = records
    path = str(tmp_path / "roofline.md")
    rows = report.main(["--dryrun", out, "--out", path])
    with open(path) as f:
        text = f.read()
    assert text.startswith("| arch | shape | compute |")
    assert len(rows) == len(CELLS)
    for arch, shape, _ in CELLS:
        assert f"| {configs.canonical(arch)} | {shape} |" in text


@pytest.mark.parametrize("cell", range(len(CELLS)))
def test_summarize_row(records, cell):
    arch, shape_name, extra = CELLS[cell]
    rec = records[1][arch]
    cfg, shape = _cfg(arch, extra), SH.SHAPES[shape_name]
    t = roofline.summarize(rec, cfg, shape)
    assert t["compute_s"] == pytest.approx(
        rec["cost"]["flops"] / roofline.PEAK_FLOPS, rel=1e-12)
    hbm = analysis.analytic_cell(cfg, shape, 16, 16)["hbm_bytes"]
    assert t["memory_s"] > 0
    assert t["memory_s"] == pytest.approx(hbm / (256 * roofline.HBM_BW), rel=1e-12)
    assert t["collective_s"] == rec["collectives"]["seconds"] > 0
    terms = {k: t[k + "_s"] for k in ("compute", "memory", "collective")}
    assert t["bound"] == max(terms, key=terms.get)
    assert t["step_s"] == max(terms.values())
    assert t["counted_flops_total"] == rec["cost"]["flops"] * 256
