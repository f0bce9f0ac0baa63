#!/usr/bin/env python3
"""Digests of the lane-packed kernels' outputs, to show that two source
trees' kernels give the same bits.

The parallel and the fan pair (FP and BP, f32 and bf16 tiles) at the cells
of ``chip_smoke.lane_cells()`` (main, 3d128, 3d, fan, fan_curved and
fan_rows), each at its heuristic config, on seeded random tiles at the
kernels' interface.  The geometries come from this checkout's
``chip_smoke.py``; the kernels from the ``repro_torch`` package of the tree
given by ``--src``, which it builds; it needs a CUDA card.

    python3 scripts/lane_bits.py --src src --out new.json
    python3 scripts/lane_bits.py --src /path/to/other/src --out old.json
    python3 scripts/lane_bits.py --compare old.json new.json

``--compare`` prints each (kernel, cell, dtype) and whether its digests
agree, and exits 1 if any differs.
"""
import argparse
import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def cells(src: str) -> dict:
    """name -> (family, geometry, batch): ``chip_smoke.lane_cells()`` of this
    checkout, carried into the ``repro_torch`` package under ``src`` by
    their configs (the same canonical hash in both)."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    here = {name: (fam, geom.to_config(), geom.canonical_hash(), batch)
            for name, (fam, geom, batch) in chip_smoke.lane_cells().items()}
    for mod in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[mod]
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    from repro_torch.core.geometry import from_config
    out = {}
    for name, (fam, cfg, digest, batch) in here.items():
        geom = from_config(cfg)
        if geom.canonical_hash() != digest:
            raise SystemExit(f"{name}: the geometry changed on the way to {src}")
        out[name] = (fam, geom, batch)
    return out


def digests(src: str) -> dict:
    geoms = cells(src)
    import torch
    from repro_torch.kernels import fp_fan, fp_par, tune
    out = {}
    for seed, (name, (fam, geom, batch)) in enumerate(geoms.items()):
        mod = fp_par if fam == "par" else fp_fan
        plan = (fp_par.ParallelPlan if fam == "par" else fp_fan.FanPlan)(geom)
        cfg = (tune.parallel_config if fam == "par" else tune.heuristic_config)(
            geom, batch)
        lanes = batch * geom.n_rows
        gen = torch.Generator().manual_seed(seed)
        vol = torch.rand((geom.vol.nx, geom.vol.ny, lanes), generator=gen)
        sino = torch.randn((geom.n_angles, geom.n_cols, lanes), generator=gen)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for kname, run, x in ((f"fp_{fam}_sf", mod.fp_lanes, vol),
                                  (f"bp_{fam}_sf", mod.bp_lanes, sino)):
                y = run(x.to(dt).cuda(), plan, cfg).cpu()
                out[f"{kname} {name} {dtype}"] = {
                    "sha256": hashlib.sha256(y.numpy().tobytes()).hexdigest(),
                    "finite": bool(torch.isfinite(y).all())}
                print(kname, name, dtype, out[f"{kname} {name} {dtype}"],
                      flush=True)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="the tree's src/ directory")
    ap.add_argument("--out", help="where to write the digests (JSON)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="two digest files to compare")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(pathlib.Path(p).read_text()) for p in args.compare)
        same = True
        for key in sorted(set(a) | set(b)):
            ok = key in a and key in b and a[key] == b[key] and a[key]["finite"]
            same &= ok
            print(f"{key}: {'same bits' if ok else 'DIFFERENT'}")
        print(json.dumps({"same_bits": same, "outputs": len(set(a) | set(b))}))
        return 0 if same else 1
    out = digests(args.src)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
