"""Builds the roofline table from the dry-run JSON records and the
analytic model (``launch/analysis.py``), the counterpart of the reference
package's ``launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report --dryrun results/dryrun

The reference's ``HLOval`` column (XLA's cost analysis against the
analytic FLOPs with every loop counted once) becomes ``counted/analytic``:
the FLOPs ``FlopCounterMode`` counted for one rank, times the ranks,
over ``analysis``'s FLOPs, since the counter sees every iteration of
every loop.  ``temp/dev`` is the dry run's ``temp_bytes`` (the peak of
what the step allocates on a rank, ``dryrun.LiveBytes``).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import configs
from repro_torch.launch import analysis, roofline
from repro_torch.launch.shapes import SHAPES


def _fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def cell_row(arch: str, shape_name: str, rec: dict, tp=16, dp=16):
    # dp folds the pod axis in: multi-pod (2,16,16) -> dp=32, tp=16
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    a = analysis.analytic_cell(cfg, shape, tp=tp, dp=dp)
    n = rec.get("n_devices", 256)
    t = roofline.terms(a["flops"], a["hbm_bytes"], a["collective_bytes"], n,
                       roofline.link_bw(tp))
    mf = roofline.model_flops(cfg, shape, a["kind"])
    t["useful_fraction"] = mf / max(a["flops"], 1.0)
    t["mfu"] = mf / (n * roofline.PEAK_FLOPS * max(t["step_s"], 1e-12))
    counted = (rec.get("cost", {}).get("flops") or 0.0) * n
    t["counted_validation"] = counted / a["flops"] if a["flops"] else float("nan")
    t["analytic"] = a
    t["counted_flops"] = counted
    t["counted_collective_bytes"] = rec.get("collectives", {}).get(
        "total_bytes", 0.0) * n
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dryrun", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/roofline.md")
    args = ap.parse_args(argv)

    rows = []
    for arch in configs.ARCHS:
        for shape_name in SHAPES:
            fn = os.path.join(args.dryrun,
                              f"{arch}-{shape_name}-{args.mesh}.json")
            if not os.path.exists(fn):
                continue
            with open(fn) as f:
                rec = json.load(f)
            if rec["status"] == "skipped":
                rows.append((arch, shape_name, None, rec["reason"]))
                continue
            if rec["status"] != "ok":
                rows.append((arch, shape_name, None, "ERROR: " + rec["error"]))
                continue
            t = cell_row(arch, shape_name, rec,
                         dp=(32 if args.mesh == "multi" else 16))
            t["temp_gib"] = (rec["memory"]["temp_bytes"] or 0) / 2 ** 30
            t["arg_gib"] = (rec["memory"]["argument_bytes"] or 0) / 2 ** 30
            rows.append((arch, shape_name, t, None))

    lines = ["| arch | shape | compute | memory | collective | bound | "
             "roofline-frac | MODEL/analytic | MFU@roof | args/dev | temp/dev | "
             "counted/analytic |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch, shape, t, note in rows:
        if t is None:
            lines.append(f"| {arch} | {shape} | — | — | — | SKIP | — | — | — "
                         f"| — | — | {note[:60]} |")
            continue
        lines.append(
            f"| {arch} | {shape} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"{t['bound']} | {t['roofline_fraction']:.2f} | "
            f"{t['useful_fraction']:.2f} | {t['mfu']:.2f} | "
            f"{t['arg_gib']:.1f}GiB | {t['temp_gib']:.1f}GiB | "
            f"{t['counted_validation']:.2f} |")
    out = "\n".join(lines)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    print(out)
    return rows


if __name__ == "__main__":
    main()
