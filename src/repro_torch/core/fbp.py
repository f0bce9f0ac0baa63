"""Filtered backprojection (parallel beam).

The backprojection used here is the *textbook interpolation backprojector*
(sample the filtered projection at each voxel's detector coordinate), which
gives quantitatively correct values in 1/mm.  It is its own vectorized
tensor routine rather than the adjoint A^T: the adjoint of the SF forward
model carries path-length weights that are correct for gradients but not
for the FBP inversion formula.

For non-equispaced angles the per-view quadrature weight is half the angular
distance between its neighbours (trapezoid rule).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.filters import filter_sinogram
from repro_torch.core.geometry import CTGeometry

# Views are backprojected in chunks whose (batch x views x rows x voxels)
# interpolation temporaries stay under this many elements.
_CHUNK_ELEMS = 1 << 25


def _angle_weights(angles: np.ndarray, full_range: float) -> np.ndarray:
    """Trapezoid quadrature weights d_phi for (possibly) non-equispaced views."""
    n = len(angles)
    if n == 1:
        return np.asarray([full_range], dtype=np.float32)
    order = np.argsort(angles)
    srt = np.asarray(angles)[order]
    gaps = np.diff(srt)
    w = np.empty(n)
    w[0] = gaps[0] / 2 + (full_range - (srt[-1] - srt[0])) / 2
    w[-1] = gaps[-1] / 2 + (full_range - (srt[-1] - srt[0])) / 2
    w[1:-1] = (gaps[:-1] + gaps[1:]) / 2
    out = np.empty(n)
    out[order] = w
    return out.astype(np.float32)


def _lerp_matrix(src_coords: np.ndarray, dst_coords: np.ndarray) -> np.ndarray:
    """(n_src, n_dst) dense linear-interpolation matrix (zero outside range)."""
    n_src = len(src_coords)
    d = src_coords[1] - src_coords[0] if n_src > 1 else 1.0
    pos = (dst_coords - src_coords[0]) / d
    j = np.floor(pos).astype(int)
    w = pos - j
    M = np.zeros((n_src, len(dst_coords)), dtype=np.float32)
    for k, (jj, ww) in enumerate(zip(j, w)):
        if 0 <= jj < n_src:
            M[jj, k] += 1 - ww
        if 0 <= jj + 1 < n_src:
            M[jj + 1, k] += ww
    return M


def fbp_parallel(sino: torch.Tensor, geom: CTGeometry,
                 filter_name: str = "ramp") -> torch.Tensor:
    """sino: (..., n_angles, n_rows, n_cols) -> (..., nx, ny, nz)."""
    v = geom.vol
    nx, ny, nz = v.shape
    na, nv, nu = geom.sino_shape
    dev = sino.device
    lead = sino.shape[:-3]
    q = filter_sinogram(sino, geom.pixel_width, filter_name)
    q = q.reshape(-1, na, nv, nu)                                # (B, na, nv, nu)
    batch = q.shape[0]
    X = torch.from_numpy(np.repeat(v.x_coords(), ny)).to(dev)   # (nxy,)
    Y = torch.from_numpy(np.tile(v.y_coords(), nx)).to(dev)
    u0, du = float(geom.u_coords()[0]), geom.pixel_width
    Lz = torch.from_numpy(_lerp_matrix(geom.v_coords(), v.z_coords())).to(dev)
    wts = torch.from_numpy(_angle_weights(geom.angles_array(), np.pi)).to(dev)
    angs = torch.from_numpy(geom.angles_array()).to(dev)
    acc = torch.zeros((batch, nx * ny, nz), dtype=q.dtype, device=dev)
    step = max(1, _CHUNK_ELEMS // (batch * nv * nx * ny))
    for a0 in range(0, na, step):
        a1 = min(na, a0 + step)
        c = torch.cos(angs[a0:a1])[:, None]
        s = torch.sin(angs[a0:a1])[:, None]
        ui = (Y * c - X * s - u0) / du                           # (ca, nxy)
        j = torch.floor(ui)
        t = ui - j
        j = j.to(torch.int64)
        qa = q[:, a0:a1]                                         # (B, ca, nv, nu)
        S = 0.0
        for jj, wj in ((j, 1 - t), (j + 1, t)):
            ok = (jj >= 0) & (jj < nu)
            idx = jj.clamp(0, nu - 1)[None, :, None, :].expand(
                batch, a1 - a0, nv, nx * ny)
            S = S + torch.gather(qa, 3, idx) * torch.where(ok, wj, 0.0)[None, :, None, :]
        acc += torch.einsum("bavq,vz,a->bqz", S, Lz, wts[a0:a1])
    return acc.reshape(lead + (nx, ny, nz))


def fbp(sino: torch.Tensor, geom: CTGeometry,
        filter_name: str = "ramp") -> torch.Tensor:
    """Analytic reconstruction.  Parallel beam only in this port so far."""
    if geom.geom_type == "parallel":
        return fbp_parallel(sino, geom, filter_name)
    raise NotImplementedError(
        f"FBP for {geom.geom_type!r} geometry is not ported to PyTorch yet "
        f"(ROADMAP.md queue 1); parallel beam is available")
