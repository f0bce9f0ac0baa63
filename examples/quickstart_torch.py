"""Quickstart through the PyTorch/CUDA port: build a geometry, project a
phantom, reconstruct with FBP and SIRT, and take a gradient through the
projector.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # on the host
"""
import argparse
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import Projector, ProjectorSpec, VolumeGeometry, parallel_beam  # noqa: E402
from repro_torch.data.metrics import psnr  # noqa: E402
from repro_torch.data.phantoms import shepp_logan_2d  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.recon import sirt  # noqa: E402


def main(device=None, n: int = 128, n_angles: int = 180, n_iters: int = 50):
    dev = resolve_device(device, "quickstart_torch")
    # 1. describe the scanner (mm units, like the paper)
    vol = VolumeGeometry(nx=n, ny=n, nz=1, dx=1.0, dy=1.0, dz=1.0)
    geom = parallel_beam(n_angles=n_angles, n_rows=1, n_cols=int(1.5 * n),
                         vol=vol, pixel_width=1.0, angular_range=180.0)

    # 2. a differentiable projector.  The ProjectorSpec is the one frozen
    #    description of the operator; it doubles as the op-cache key.
    spec = ProjectorSpec(geom, model="sf")  # Separable Footprint model
    proj = Projector(spec, device=dev)

    # 3. forward project a phantom
    f = torch.from_numpy(shepp_logan_2d(vol)[:, :, None]).to(dev) * 0.02  # 1/mm
    sino = proj(f)
    print(f"volume {tuple(f.shape)} -> sinogram {tuple(sino.shape)} on {dev}")

    # 4. reconstruct — iterative solvers take the spec (or the projector)
    #    and return a ReconResult(image, iterations, residual_history)
    rec_fbp = proj.fbp(sino)
    res = sirt(proj, sino, n_iters=n_iters)
    fbp_db, sirt_db = psnr(rec_fbp, f, 0.02), psnr(res.image, f, 0.02)
    print(f"FBP  PSNR {fbp_db:.2f} dB")
    print(f"SIRT PSNR {sirt_db:.2f} dB "
          f"(residual {float(res.final_residual):.3g} "
          f"after {res.iterations} iters)")

    # 5. gradients flow through the projector (the paper's whole point):
    x = torch.zeros_like(f, requires_grad=True)
    loss = 0.5 * torch.sum((proj(x) - sino) ** 2)
    (g,) = torch.autograd.grad(loss, x)
    expected = proj.T(proj(torch.zeros_like(f)) - sino)
    ok = bool(torch.allclose(g, expected, rtol=1e-4, atol=1e-5))
    print("grad == A^T(Ax - y):", ok)
    return {"fbp_psnr": fbp_db, "sirt_psnr": sirt_db, "grad_ok": ok}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args()
    main(args.device)
