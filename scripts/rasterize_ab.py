#!/usr/bin/env python3
"""The CT trainer's host batch and step time with the port's phantom
rasterizer (each ellipse tested on its bounding box) against the
whole-grid loop it replaced (every ellipse tested on every sample, the
reference package's way; kept here as ``rasterize_whole_grid``).

For each training geometry at the ``TrainConfig`` defaults (n = 512 unless
``--n``): the median host time of ``CTDataPipeline.batch`` and the median
wall time of a step as ``CTTrainer.fit`` runs it (host batch, FP synthesis,
``train_step``, ``float(loss)``), each rasterizer in the order A B B A on
one trainer.  Both give the same batches bit for bit, which it checks.

    python3 scripts/rasterize_ab.py                  # on the card, n = 512
    python3 scripts/rasterize_ab.py --device cpu --n 32 --steps 1

Writes ``chiprun_out/rasterize_ab.json``.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rasterize_whole_grid(ellipses, vol, supersample=1):
    ss = supersample
    nx, ny = vol.nx * ss, vol.ny * ss
    xs = (np.arange(nx) - (nx - 1) / 2.0) * (vol.dx / ss) + vol.offset_x
    ys = (np.arange(ny) - (ny - 1) / 2.0) * (vol.dy / ss) + vol.offset_y
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    img = np.zeros((nx, ny), np.float32)
    for e in ellipses:
        ca, sa = np.cos(e.angle), np.sin(e.angle)
        xr = (X - e.cx) * ca + (Y - e.cy) * sa
        yr = -(X - e.cx) * sa + (Y - e.cy) * ca
        img += e.rho * (((xr / e.a) ** 2 + (yr / e.b) ** 2) <= 1.0)
    if ss > 1:
        img = img.reshape(vol.nx, ss, vol.ny, ss).mean(axis=(1, 3))
    return img


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch.data import phantoms
    from repro_torch.launch.ct_train import CTTrainer, TrainConfig
    cuda = args.device != "cpu"
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    ways = {"bounding_box": phantoms.rasterize, "whole_grid": rasterize_whole_grid}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {}
    for geometry in ("limited_angle", "sparse_fan", "helical"):
        cfg = TrainConfig(geometry=geometry, n=args.n, steps=1000)
        trainer = CTTrainer(cfg, device=args.device)
        trainer.train_step(*trainer.data(0))        # warm-up
        times = {w: {"batch_ms": [], "step_ms": []} for w in ways}
        step = 1
        for way in ("bounding_box", "whole_grid", "whole_grid", "bounding_box"):
            phantoms.rasterize = ways[way]
            for _ in range(args.steps):
                t = time.perf_counter()
                trainer.pipe.batch(step)
                times[way]["batch_ms"].append((time.perf_counter() - t) * 1e3)
                sync()
                t = time.perf_counter()
                float(trainer.train_step(*trainer.data(step)))
                times[way]["step_ms"].append((time.perf_counter() - t) * 1e3)
                step += 1
        batches = {}
        for way in ways:
            phantoms.rasterize = ways[way]
            batches[way] = trainer.pipe.batch(0)[0]
        phantoms.rasterize = ways["bounding_box"]
        same = bool(np.array_equal(batches["bounding_box"], batches["whole_grid"]))
        out[geometry] = {w: {k: statistics.median(v) for k, v in d.items()}
                         | {"raw": d} for w, d in times.items()}
        out[geometry]["same_batch"] = same
        print(f"{geometry} n={args.n}: " + "; ".join(
            f"{w} batch {out[geometry][w]['batch_ms']:.1f} ms, step "
            f"{out[geometry][w]['step_ms']:.1f} ms" for w in ways)
            + f"; same batch {same}", flush=True)
        if not same:
            return 1
        del trainer
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "rasterize_ab.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
