"""Cone-beam and modular-geometry iterative reconstruction with matched pairs
through the PyTorch/CUDA port: CGLS and FISTA-TV on a 3D cone-beam scan (the
exact cone SF kernels on the card, their plain versions on the host), then
the same object scanned along two tilted arcs, a modular trajectory the SF
kernels do not cover, with CGLS on the Joseph ray-marcher.

    PYTHONPATH=src python examples/iterative_recon_torch.py                # on the GPU
    PYTHONPATH=src python examples/iterative_recon_torch.py --device cpu   # on the host
"""
import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import (Projector, ProjectorSpec, VolumeGeometry,  # noqa: E402
                         cone_beam, modular_beam, resolve_mode)
from repro_torch.data.metrics import psnr  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.recon import cgls, fista_tv  # noqa: E402
from repro_torch.recon.fista_tv import power_iteration  # noqa: E402


def phantom(vol: VolumeGeometry) -> np.ndarray:
    """Two blocks (examples/iterative_recon.py)."""
    f = np.zeros(vol.shape, np.float32)
    f[14:26, 14:30, 4:12] = 0.02
    f[30:40, 10:20, 6:10] = 0.035
    return f


def tilted_arcs(vol: VolumeGeometry):
    """40 views on a non-circular trajectory: the source rides two arcs
    tilted out of the axial plane, the detector faces it through the axis."""
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    tilt = 0.15 * np.sin(2 * ang)
    src = np.stack([200 * np.cos(ang), 200 * np.sin(ang), 40 * tilt], -1)
    ctr = -src * (200.0 / 200.0)
    eu = np.stack([-np.sin(ang), np.cos(ang), np.zeros_like(ang)], -1)
    ev = np.cross(src / np.linalg.norm(src, axis=1, keepdims=True), eu)
    return modular_beam(src, ctr, eu, ev, n_rows=32, n_cols=72, vol=vol,
                        pixel_width=2.0, pixel_height=2.0)


def main(device=None, n_cgls: int = 25, n_fista: int = 40, seed: int = 0,
         verbose: bool = True):
    """Both reconstructions on ``device``; returns their images and PSNRs.
    The noise comes from a CPU generator seeded with ``seed``, and FISTA's
    step from a power iteration started there, so every device gets the
    same inputs."""
    dev = resolve_device(device, "iterative_recon_torch")
    say = print if verbose else (lambda *a: None)
    vol = VolumeGeometry(48, 48, 16)
    geom = cone_beam(n_angles=60, n_rows=32, n_cols=72, vol=vol, sod=200.0,
                     sdd=400.0, pixel_width=2.0, pixel_height=2.0)
    proj = Projector(ProjectorSpec(geom, model="sf"), device=dev)
    say(f"cone-beam scan {geom.sino_shape}, projector {proj}, pair "
        f"{resolve_mode(proj.spec)}")

    gen = torch.Generator().manual_seed(seed)
    f = torch.from_numpy(phantom(vol)).to(dev)
    y = proj(f)
    noise = torch.randn(tuple(y.shape), generator=gen).to(dev)
    y_noisy = y + 0.01 * float(y.abs().max()) * noise

    L = 1.05 * power_iteration(proj, generator=torch.Generator().manual_seed(seed))
    out = {"cgls": cgls(proj, y_noisy, n_iters=n_cgls).image,
           "fista_tv": fista_tv(proj, y_noisy, n_iters=n_fista, beta=2e-3,
                                L=L).image}

    geom_mod = tilted_arcs(vol)
    proj_mod = Projector(ProjectorSpec(geom_mod), device=dev)  # Joseph
    out["modular_cgls"] = cgls(proj_mod, proj_mod(f), n_iters=n_cgls).image
    out["psnr"] = {k: psnr(out[k], f, 0.035)
                   for k in ("cgls", "fista_tv", "modular_cgls")}
    say(f"cone-beam CGLS     PSNR {out['psnr']['cgls']:.2f} dB")
    say(f"cone-beam FISTA-TV PSNR {out['psnr']['fista_tv']:.2f} dB")
    say(f"modular   CGLS     PSNR {out['psnr']['modular_cgls']:.2f} dB")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    main(ap.parse_args().device)
