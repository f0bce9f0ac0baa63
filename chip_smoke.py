#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card at the shapes of
both cells below and of a reduced 128^3 cell (f32 within 2e-4, bf16 within
``BF16_KERNEL_REL_TOL``), then drives the port's main path through its
public API at the paper's sizes:

* main cell — the limited-angle training shape of the reference package's
  ``configs/leap_ct.py:22`` ``limited_angle_geometry(512, 720)``: a 512x512x1
  volume, 720 views over 180 degrees, a 1x768 detector, at batch 8
  (random ellipse phantoms, seeds 0-7, f32).  Dot tests (f32, bf16), the
  autograd gradient against A^T(Ax - y), Shepp-Logan against its analytic
  projection, FBP of a uniform disk, and 50 SIRT iterations.
* 3D cell — ``configs/leap_ct.py:6`` ``table1_geometries()["parallel_512_180"]``:
  a 512^3 volume, 180 views, a 512x768 detector.  One FP, one BP and the dot
  test.

Last, a torch.profiler breakdown of one main-cell projector pair and of the
3D cell's FP and BP says where the device time goes.

Any failed check raises and the script exits non-zero.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits non-zero
and prints no result.  Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every ported kernel with its launches on the main
path, its error against its plain version, and its times.  Details go to
``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet) used for the bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = 2e-4          # kernel vs plain, as tests/test_kernels.py:33-46


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call (CUDA events, warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_s(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def vdot64(a, b) -> float:
    return float((a.double() * b.double()).sum())


def system_matrix(torch, plan, transpose: bool = False):
    """The transaxial SF system matrix (n_angles*n_cols, nx*ny) — or its
    transpose — as CSR, from the plain version's weights.  Used only as the
    library yardstick (torch.sparse.mm); the port never calls it."""
    from repro_torch.kernels.fp_par import _group_weights
    geom = plan.geom
    nu, ny = geom.n_cols, geom.vol.ny
    dt = plan.on(torch.device("cuda"))
    idx, vals = [], []
    for grp in (0, 1):
        ng, nl, _, _ = plan.group(grp, 1)
        table, rows = dt.tables[grp], dt.rows[grp].long()
        if table.shape[0] == 0:
            continue
        gi = torch.arange(ng, device="cuda")[:, None]
        li = torch.arange(nl, device="cuda")[None, :]
        vox = (gi * ny + li if grp == 0 else li * ny + gi).reshape(1, -1)
        for a0 in range(0, table.shape[0], 64):
            a1 = min(table.shape[0], a0 + 64)
            base = (rows[a0:a1] * nu)[:, None]
            for u, w in _group_weights(plan, table[a0:a1], ng, nl):
                keep = w != 0
                r = (base + u)[keep]
                c = vox.expand_as(u)[keep]
                idx.append(torch.stack([c, r]) if transpose else torch.stack([r, c]))
                vals.append(w[keep])
    shape = (geom.n_angles * nu, geom.vol.nx * ny)
    if transpose:
        shape = shape[::-1]
    coo = torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals), shape)
    del idx, vals
    return coo.coalesce().to_sparse_csr()


def kernel_phase(torch, cells, results):
    """Each kernel against its plain version on the card, with times."""
    from repro_torch.kernels import fp_par, precision, tune
    from repro_torch.kernels.fp_par import ParallelPlan
    for cell, (geom, batch, make_g) in cells.items():
        plan = ParallelPlan(geom)
        cfg = tune.heuristic_config(geom, batch)
        lanes = batch * geom.n_rows
        vol_f32 = make_g()                                  # (nx, ny, lanes)
        A = system_matrix(torch, plan)
        nnz = A.values().numel()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            tol = F32_TOL if dtype == torch.float32 else precision.BF16_KERNEL_REL_TOL
            g = vol_f32.to(dtype)
            sino_f32 = fp_par.fp_lanes(vol_f32, plan, cfg)
            q = sino_f32.to(dtype)
            esize = g.element_size()
            for kname, run, plain, x, out_bytes in (
                    ("fp_par_sf", fp_par.fp_lanes, fp_par.fp_lanes_plain, g,
                     geom.n_angles * geom.n_cols * lanes * 4),
                    ("bp_par_sf", fp_par.bp_lanes, fp_par.bp_lanes_plain, q,
                     geom.vol.nx * geom.vol.ny * lanes * 4)):
                k_out = run(x, plan, cfg)
                torch.cuda.synchronize()
                p_out = plain(x, plan)
                err = rel_err(k_out, p_out)
                abs_err = float((k_out - p_out).abs().max())
                check(bool(torch.isfinite(k_out).all()), f"{kname} {cell} {name}: non-finite")
                check(err <= tol, f"{kname} {cell} {name}: |kernel-plain|/|plain| "
                                  f"= {err:.3g} > {tol:.3g}")
                ms = cuda_ms(torch, lambda: run(x, plan, cfg), reps=20)
                plain_ms = cuda_ms(torch, lambda: plain(x, plan), reps=3, warmup=1)
                lib_ms = None
                if dtype == torch.float32:
                    mat = (A if kname == "fp_par_sf"
                           else system_matrix(torch, plan, transpose=True))
                    dense = x.reshape(-1, lanes)
                    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(mat, dense))
                    lib = torch.sparse.mm(mat, dense).reshape(k_out.shape)
                    del mat
                    lib_err = rel_err(k_out, lib)
                    check(lib_err <= tol, f"{kname} {cell}: kernel vs sparse "
                                          f"matrix {lib_err:.3g}")
                del k_out, p_out
                in_bytes = x.numel() * esize + plan.tables[0].nbytes + plan.tables[1].nbytes
                nbytes = in_bytes + out_bytes
                ops = 2.0 * nnz * lanes
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS[name] * 1e3
                row = {"kernel": kname, "cell": cell, "dtype": name,
                       "shape": {"nx": geom.vol.nx, "ny": geom.vol.ny,
                                 "n_angles": geom.n_angles,
                                 "n_cols": geom.n_cols, "lanes": lanes},
                       "config": dataclasses.asdict(cfg),
                       "rel_err": err, "max_abs_err": abs_err, "tol": tol,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "bytes": nbytes, "ops": ops, "nnz": nnz}
                results["kernels"].append(row)
                log(f"kernel {kname:9s} {cell:5s} {name:8s} rel_err {err:.3g} "
                    f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms} "
                    f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")
        del A, vol_f32, g, q, sino_f32
        torch.cuda.empty_cache()


def main_cell(torch, results):
    """The main path, through the public API."""
    from repro_torch import Projector, ProjectorSpec, VolumeGeometry, parallel_beam
    from repro_torch.data.metrics import psnr
    from repro_torch.data.phantoms import (SHEPP_LOGAN, analytic_parallel_projection,
                                           random_ellipse_phantom, shepp_logan_2d)
    from repro_torch.kernels import precision
    from repro_torch.recon import sirt

    vol = VolumeGeometry(512, 512, 1)
    geom = parallel_beam(720, 1, 768, vol, angular_range=180.0)
    dev = torch.device("cuda")
    out = {}
    x = torch.from_numpy(np.stack([random_ellipse_phantom(s, vol)[0]
                                   for s in range(8)])[..., None]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn((8,) + geom.sino_shape, generator=gen, device=dev)

    t_start = time.perf_counter()
    proj = Projector(ProjectorSpec(geom))
    for cdt, tol in ((None, 1e-4), ("bfloat16", precision.BF16_DOT_TOL)):
        p = proj if cdt is None else Projector(ProjectorSpec(geom, compute_dtype=cdt))
        lhs, rhs = vdot64(p(x), y), vdot64(x, p.T(y))
        rel = abs(lhs - rhs) / abs(lhs)
        out[f"dot_{cdt or 'float32'}"] = rel
        log(f"main dot test {cdt or 'float32'}: {rel:.3g} (tol {tol:.3g})")
        check(rel < tol, f"main-cell dot test {cdt}: {rel:.3g} >= {tol:.3g}")

    sino, t_fp = host_s(torch, lambda: proj(x))
    _, t_bp = host_s(torch, lambda: proj.T(sino))
    out["fp_s"], out["bp_s"] = t_fp, t_bp
    check(tuple(sino.shape) == (8,) + geom.sino_shape and bool(torch.isfinite(sino).all()),
          "main-cell sinogram shape/finite")

    xg = (0.5 * x).requires_grad_()
    loss = 0.5 * torch.sum((proj(xg) - sino) ** 2)
    (grad,) = torch.autograd.grad(loss, xg)
    expected = proj.T(proj(xg.detach()) - sino)
    gerr = float((grad - expected).abs().max() / expected.abs().max())
    out["grad_rel_err"] = gerr
    check(torch.allclose(grad, expected, rtol=1e-4,
                         atol=1e-5 * float(expected.abs().max())),
          f"autograd gradient != A^T(Ax - y) (rel {gerr:.3g})")
    log(f"main gradient == A^T(Ax-y): rel {gerr:.3g}")

    s = 0.48 * min(vol.nx * vol.dx, vol.ny * vol.dy)
    ells = [dataclasses.replace(e, cx=e.cx * s, cy=e.cy * s, a=e.a * s, b=e.b * s)
            for e in SHEPP_LOGAN]
    f_sl = torch.from_numpy(shepp_logan_2d(vol)[:, :, None]).to(dev)
    p_sl = proj(f_sl)[:, 0, :].cpu().numpy()
    ana = analytic_parallel_projection(ells, np.asarray(geom.angles), geom.u_coords())
    err = np.abs(p_sl - ana)
    out["analytic_sup"] = float(err.max() / ana.max())
    out["analytic_mean"] = float(err.mean() / ana.mean())
    log(f"main Shepp-Logan vs analytic: sup {out['analytic_sup']:.4f} "
        f"mean {out['analytic_mean']:.4f}")
    check(out["analytic_sup"] < 0.12 and out["analytic_mean"] < 0.02,
          "Shepp-Logan projection vs analytic line integrals")

    X, Y = np.meshgrid(vol.x_coords(), vol.y_coords(), indexing="ij")
    disk = torch.from_numpy((0.02 * ((X ** 2 + Y ** 2) <= 80.0 ** 2))
                            .astype(np.float32)[:, :, None]).to(dev)
    rec = proj.fbp(proj(disk))
    centre = float(rec[224:288, 224:288, 0].mean())
    out["fbp_disk_centre_rel"] = centre / 0.02 - 1.0
    log(f"main FBP disk centre {centre:.6f} (1/mm), rel {out['fbp_disk_centre_rel']:.4f}")
    check(abs(out["fbp_disk_centre_rel"]) < 0.02, "FBP disk centre off by >= 2 %")

    rec_b, t_fbp = host_s(torch, lambda: proj.fbp(sino))
    res, t_sirt = host_s(torch, lambda: sirt(proj, sino, n_iters=50))
    hist = res.residual_history
    check(tuple(hist.shape) == (8, 50), f"residual history shape {tuple(hist.shape)}")
    check(bool((hist[:, -1] < 0.5 * hist[:, 0]).all()), "SIRT residual did not halve")
    out["fbp_s"], out["sirt50_s"] = t_fbp, t_sirt
    out["fbp_psnr"] = float(np.mean([psnr(rec_b[i], x[i]) for i in range(8)]))
    out["sirt_psnr"] = float(np.mean([psnr(res.image[i], x[i]) for i in range(8)]))
    out["sirt_residual_ratio"] = float((hist[:, -1] / hist[:, 0]).max())
    out["main_path_s"] = time.perf_counter() - t_start
    log(f"main FBP PSNR {out['fbp_psnr']:.2f} dB ({t_fbp:.3f} s), SIRT-50 PSNR "
        f"{out['sirt_psnr']:.2f} dB ({t_sirt:.3f} s), residual ratio "
        f"{out['sirt_residual_ratio']:.3g}")
    results["main_cell"] = out


def cell_3d(torch, results):
    from repro_torch import Projector, ProjectorSpec, VolumeGeometry, parallel_beam
    vol = VolumeGeometry(512, 512, 512)
    geom = parallel_beam(180, 512, 768, vol, angular_range=180.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(vol.shape, generator=gen, device="cuda")
    y = torch.randn(geom.sino_shape, generator=gen, device="cuda")
    proj = Projector(ProjectorSpec(geom))
    ax, t_fp = host_s(torch, lambda: proj(x))
    aty, t_bp = host_s(torch, lambda: proj.T(y))
    check(bool(torch.isfinite(ax).all() and torch.isfinite(aty).all()), "3D non-finite")
    lhs, rhs = vdot64(ax, y), vdot64(x, aty)
    rel = abs(lhs - rhs) / abs(lhs)
    check(rel < 1e-4, f"3D dot test {rel:.3g}")
    fp_ms = cuda_ms(torch, lambda: proj(x), reps=3, warmup=1)
    bp_ms = cuda_ms(torch, lambda: proj.T(y), reps=3, warmup=1)
    results["cell_3d"] = {"dot": rel, "fp_first_s": t_fp, "bp_first_s": t_bp,
                          "fp_ms": fp_ms, "bp_ms": bp_ms}
    log(f"3D cell 512^3/180 views: dot {rel:.3g}, FP {fp_ms:.1f} ms, BP {bp_ms:.1f} ms "
        f"(first calls {t_fp:.3f} s / {t_bp:.3f} s)")


def breakdown(torch, name: str, fn, results, reps: int = 3) -> None:
    """Where the time of ``fn`` goes: its median device time (CUDA events),
    then a torch.profiler window over ``reps`` calls — device time by
    kernel and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(torch, fn, reps=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for ev in prof.key_averages():
        # device-side events only: the CPU op that launched a kernel also
        # reports that kernel's time as its own
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / reps, ev.key[:60]))
    rows.sort(reverse=True)
    busy = sum(us for us, _ in rows) * reps / wall_us
    results.setdefault("breakdown", {})[name] = {
        "ms": ms, "device_busy_share": busy,
        "device_us_per_call": [[k, us] for us, k in rows[:10]]}
    log(f"breakdown {name}: {ms:.3f} ms per call, device busy {busy:.3f} of the "
        f"profiled window" + ("" if rows else " (profiler saw no device time)"))
    for us, k in rows[:6]:
        log(f"  {us / 1e3:9.3f} ms  {k}")


def profile_cells(torch, results) -> None:
    """Device-time breakdown of the main cell's projector pair (one training
    step's A then A^T on the batch of 8) and of the 3D cell's FP and BP."""
    from repro_torch import Projector, ProjectorSpec, VolumeGeometry, parallel_beam
    from repro_torch.data.phantoms import random_ellipse_phantom
    vol = VolumeGeometry(512, 512, 1)
    geom = parallel_beam(720, 1, 768, vol, angular_range=180.0)
    proj = Projector(ProjectorSpec(geom))
    x = torch.from_numpy(np.stack([random_ellipse_phantom(s, vol)[0]
                                   for s in range(8)])[..., None]).cuda()
    y = proj(x)
    breakdown(torch, "main_pair", lambda: proj.T(proj(x) - y), results)
    del x, y
    vol3 = VolumeGeometry(512, 512, 512)
    geom3 = parallel_beam(180, 512, 768, vol3, angular_range=180.0)
    proj3 = Projector(ProjectorSpec(geom3))
    x3 = torch.rand(vol3.shape, device="cuda")
    breakdown(torch, "3d_fp", lambda: proj3(x3), results, reps=2)
    y3 = proj3(x3)
    del x3
    breakdown(torch, "3d_bp", lambda: proj3.T(y3), results, reps=2)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    results = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
               "kernels": []}

    from repro_torch import VolumeGeometry, parallel_beam
    from repro_torch.data.phantoms import random_ellipse_phantom
    from repro_torch.kernels import build, fp_par

    t = time.perf_counter()
    build.build_all()
    results["build_s"] = time.perf_counter() - t
    log(f"build {results['build_s']:.1f} s")

    main_vol = VolumeGeometry(512, 512, 1)
    main_geom = parallel_beam(720, 1, 768, main_vol, angular_range=180.0)
    red_geom = parallel_beam(45, 128, 192, VolumeGeometry(128, 128, 128),
                             angular_range=180.0)
    geom_3d = parallel_beam(180, 512, 768, VolumeGeometry(512, 512, 512),
                            angular_range=180.0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cells = {
        "main": (main_geom, 8, lambda: torch.from_numpy(np.stack(
            [random_ellipse_phantom(s, main_vol)[0] for s in range(8)], -1)).cuda()),
        "3d128": (red_geom, 1, lambda: torch.rand((128, 128, 128), generator=gen,
                                                  device="cuda")),
        "3d": (geom_3d, 1, lambda: torch.rand((512, 512, 512), generator=gen,
                                              device="cuda")),
    }
    kernel_phase(torch, cells, results)

    fp_par.reset_launches()
    main_cell(torch, results)
    launches = dict(fp_par.LAUNCHES)
    results["main_launches"] = launches
    log(f"main-path launches {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    fp_par.reset_launches()
    cell_3d(torch, results)
    results["cell_3d"]["launches"] = dict(fp_par.LAUNCHES)
    profile_cells(torch, results)
    torch.cuda.synchronize()

    replaces = {"fp_par_sf": "src/repro/kernels/fp_par.py:122",
                "bp_par_sf": "src/repro/kernels/fp_par.py:264"}
    line = []
    for row in results["kernels"]:
        if row["cell"] != "main" or row["dtype"] != "float32":
            continue
        line.append({"name": row["kernel"], "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/fp_par.cu",
                     "replaces": replaces[row["kernel"]],
                     "launches": launches[row["kernel"]],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
