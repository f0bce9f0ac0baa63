"""Helical (spiral) cone-beam reconstruction through the PyTorch/CUDA port's
modular SF pair.

A helical trajectory — source orbiting while translating along the rotation
axis — cannot be expressed by the fixed parallel/fan/cone geometries; it is
the canonical *modular* workload.  ``helical_beam`` emits per-view modular
frames, the modular SF matched pair runs them (the CUDA kernels on the card,
their plain versions on the host), and the iterative solvers work out of
the box because the backprojector is the exact transpose of the forward.

    PYTHONPATH=src python examples/helical_recon_torch.py                # on the GPU
    PYTHONPATH=src python examples/helical_recon_torch.py --device cpu   # on the host
"""
import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import (Projector, ProjectorSpec, VolumeGeometry,  # noqa: E402
                         from_config, helical_beam)
from repro_torch.data.metrics import psnr  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.recon import cgls, fista_tv, sirt  # noqa: E402


def phantom(vol: VolumeGeometry) -> np.ndarray:
    """A synthetic object spanning the full z extent (what the helix is for)."""
    f = np.zeros(vol.shape, np.float32)
    f[9:17, 9:20, 2:14] = 0.02
    f[20:27, 7:13, 5:11] = 0.035
    f[13:19, 21:27, 9:15] = 0.027
    return f


def main(device=None, n_sirt: int = 30, n_cgls: int = 20, n_fista: int = 30):
    dev = resolve_device(device, "helical_recon_torch")
    vol = VolumeGeometry(32, 32, 16)
    geom = helical_beam(n_turns=2.0, pitch=8.0, n_angles=48, n_rows=12,
                        n_cols=48, vol=vol, sod=130.0, sdd=260.0,
                        pixel_width=2.0, pixel_height=2.0)
    src = np.asarray(geom.source_pos)
    print(f"helical scan: {geom.n_angles} views over 2 turns, "
          f"source z {src[0, 2]:.1f} -> {src[-1, 2]:.1f} mm "
          f"(pitch 8 mm/turn)")

    # the same scan is expressible as a config file (from_config round-trip)
    cfg = {"geom_type": "helical", "n_turns": 2.0, "pitch": 8.0,
           "n_angles": 48, "n_rows": 12, "n_cols": 48, "sod": 130.0,
           "sdd": 260.0, "pixel_width": 2.0, "pixel_height": 2.0,
           "volume": {"nx": 32, "ny": 32, "nz": 16}}
    if from_config(cfg).canonical_hash() != geom.canonical_hash():
        raise RuntimeError("from_config does not round-trip the helical scan")

    f = torch.from_numpy(phantom(vol)).to(dev)
    proj = Projector(ProjectorSpec(geom, model="sf"), device=dev)
    y = proj(f)
    print(f"sinogram {tuple(y.shape)}, projector {proj}")

    out = {"sirt_psnr": psnr(sirt(proj, y, n_iters=n_sirt).image, f, 0.035),
           "cgls_psnr": psnr(cgls(proj, y, n_iters=n_cgls).image, f, 0.035),
           "fista_tv_psnr": psnr(fista_tv(proj, y, n_iters=n_fista,
                                          beta=2e-3).image, f, 0.035)}
    print(f"helical SIRT     PSNR {out['sirt_psnr']:.2f} dB")
    print(f"helical CGLS     PSNR {out['cgls_psnr']:.2f} dB")
    print(f"helical FISTA-TV PSNR {out['fista_tv_psnr']:.2f} dB")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    main(ap.parse_args().device)
