"""Filtered backprojection (parallel and fan beam) and FDK (cone beam).

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

from typing import Optional

import numpy as np
import torch

from repro_torch.core.filters import filter_sinogram
from repro_torch.core.geometry import CTGeometry

# Views (and, for FDK, voxels) are backprojected in chunks whose (batch x
# views x rows x voxels) interpolation temporaries stay under this many
# elements.
_CHUNK_ELEMS = 1 << 25
_EPS = 1e-9


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


def _lerp_columns(q: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of q (B, ca, nv, nu) at fractional columns ui
    (ca, n), zero outside the detector: (B, ca, nv, n)."""
    batch, ca, nv, nu = q.shape
    j = torch.floor(ui)
    t = ui - j
    j = j.to(torch.int64)
    S = 0.0
    for jj, wj in ((j, 1 - t), (j + 1, t)):
        ok = (jj >= 0) & (jj < nu)
        idx = jj.clamp(0, nu - 1)[None, :, None, :].expand(
            batch, ca, nv, ui.shape[1])
        S = S + torch.gather(q, 3, idx) * torch.where(ok, wj, 0.0)[None, :, None, :]
    return S


def _grid_xy(geom: CTGeometry, dev: torch.device):
    v = geom.vol
    X = torch.from_numpy(np.repeat(v.x_coords(), v.ny)).to(dev)  # (nxy,)
    Y = torch.from_numpy(np.tile(v.y_coords(), v.nx)).to(dev)
    return X, Y


def _backproject_rows(q: torch.Tensor, geom: CTGeometry, wts: np.ndarray,
                      sample) -> torch.Tensor:
    """sum_a wts[a] * (q[:, a] sampled per voxel, rows lerped onto z):
    q (B, na, nv, nu) -> (B, nxy, nz).  ``sample(c, s)`` gives each voxel's
    fractional detector column and distance weight (or None) in the views
    with cosines c and sines s, each (ca, 1)."""
    v = geom.vol
    nxy = v.nx * v.ny
    batch, na, nv, _ = q.shape
    dev = q.device
    Lz = torch.from_numpy(_lerp_matrix(geom.v_coords(), v.z_coords())).to(dev)
    w = torch.from_numpy(wts).to(dev)
    angs = torch.from_numpy(geom.angles_array()).to(dev)
    acc = torch.zeros((batch, nxy, v.nz), dtype=q.dtype, device=dev)
    step = max(1, _CHUNK_ELEMS // (batch * nv * nxy))
    for a0 in range(0, na, step):
        a1 = min(na, a0 + step)
        ui, wdist = sample(torch.cos(angs[a0:a1])[:, None],
                           torch.sin(angs[a0:a1])[:, None])
        S = _lerp_columns(q[:, a0:a1], ui)                       # (B, ca, nv, nxy)
        if wdist is not None:
            S = S * wdist[None, :, None, :]
        acc += torch.einsum("bavq,vz,a->bqz", S, Lz, w[a0:a1])
    return acc


def fbp_parallel(sino: torch.Tensor, geom: CTGeometry,
                 filter_name: str = "ramp") -> torch.Tensor:
    """sino: (..., n_angles, n_rows, n_cols) -> (..., nx, ny, nz)."""
    v = geom.vol
    na, nv, nu = geom.sino_shape
    lead = sino.shape[:-3]
    q = filter_sinogram(sino, geom.pixel_width, filter_name)
    q = q.reshape(-1, na, nv, nu)                                # (B, na, nv, nu)
    X, Y = _grid_xy(geom, q.device)
    u0, du = float(geom.u_coords()[0]), geom.pixel_width

    def sample(c, s):
        return (Y * c - X * s - u0) / du, None

    acc = _backproject_rows(q, geom, _angle_weights(geom.angles_array(), np.pi),
                            sample)
    return acc.reshape(lead + v.shape)


def _fan_gamma(geom: CTGeometry) -> np.ndarray:
    """Fan angle of each detector column (rad)."""
    us = geom.u_coords()
    if geom.detector_type == "curved":
        return us / geom.sdd
    return np.arctan2(us, geom.sdd)


def parker_weights(geom: CTGeometry) -> np.ndarray:
    """Parker (1982) short-scan weights, shape (n_angles, n_cols).

    Smoothly splits the weight of each conjugate ray pair so a
    ``pi + 2*delta`` scan (delta = half fan angle) integrates like a full
    scan.  Views are referenced to the smallest angle; ranges beyond the
    exact short-scan window are clamped to [0, 1]."""
    gamma = _fan_gamma(geom).astype(np.float64)
    delta = float(np.abs(gamma).max())
    ang = np.asarray(geom.angles_array(), np.float64)
    beta = (ang - ang.min())[:, None]                # (na, 1)
    G = gamma[None, :]                               # (1, nu)
    eps = 1e-6
    w = np.ones_like(beta * G)
    # Conjugate of (beta, gamma) is (beta + pi - 2*gamma, -gamma); the ramp
    # arguments below are complementary for such a pair, so w + w_conj = 1.
    r1 = beta < 2.0 * (delta + G)                    # ramp-up region
    a1 = beta / np.maximum(2.0 * (delta + G), eps)
    w = np.where(r1, np.sin(np.pi / 2.0 * np.clip(a1, 0.0, 1.0)) ** 2, w)
    r3 = beta > np.pi + 2.0 * G                      # ramp-down region
    a3 = (np.pi + 2.0 * delta - beta) / np.maximum(2.0 * (delta - G), eps)
    w = np.where(r3, np.sin(np.pi / 2.0 * np.clip(a3, 0.0, 1.0)) ** 2, w)
    return np.clip(w, 0.0, 1.0).astype(np.float32)


def fbp_fan(sino: torch.Tensor, geom: CTGeometry, filter_name: str = "ramp",
            short_scan: Optional[bool] = None) -> torch.Tensor:
    """Fan-beam FBP (flat = equispaced, curved = equiangular columns):
    sino (..., n_angles, n_rows, n_cols) -> (..., nx, ny, nz).

    Weighting chain (Kak & Slaney ch. 3): cosine pre-weight ``cos(gamma)``,
    ramp filter (with the ``(gamma/sin gamma)^2`` kernel correction for
    curved detectors), then distance-weighted backprojection —
    ``sod^2/ell^2`` at flat-detector scale, ``sod*sdd/L^2`` equiangular.
    ``short_scan=None`` auto-detects: an angular span under ~2*pi enables
    Parker weights (and drops the full-scan double-coverage 1/2)."""
    v = geom.vol
    na, nv, nu = geom.sino_shape
    sod, sdd = geom.sod, geom.sdd
    curved = geom.detector_type == "curved"
    dev = sino.device
    lead = sino.shape[:-3]
    cw = torch.from_numpy(np.cos(_fan_gamma(geom)).astype(np.float32)).to(dev)

    ang = np.asarray(geom.angles_array(), np.float64)
    n = len(ang)
    span = float(ang.max() - ang.min()) * (n / max(n - 1, 1))
    if short_scan is None:
        short_scan = span < 2.0 * np.pi * 0.99
    if short_scan:
        pw = torch.from_numpy(parker_weights(geom)).to(dev)      # (na, nu)
        pre = sino * cw * pw[:, None, :]
        wts = _angle_weights(geom.angles_array(), span)
    else:
        pre = sino * cw
        wts = _angle_weights(geom.angles_array(), 2 * np.pi) / np.float32(2.0)

    q = filter_sinogram(pre, geom.pixel_width, filter_name,
                        equiangular_sdd=sdd if curved else 0.0)
    if not curved:
        # The ramp acts at detector scale; isocenter frequencies are higher
        # by the magnification sdd/sod (same rescale as FDK).
        q = q * (sdd / sod)
    q = q.reshape(-1, na, nv, nu)
    X, Y = _grid_xy(geom, dev)
    u0, du = float(geom.u_coords()[0]), geom.pixel_width

    def sample(c, s):
        ell = torch.clamp(sod - (X * c + Y * s), min=_EPS)      # (ca, nxy)
        t = Y * c - X * s
        if curved:
            return ((sdd * torch.atan2(t, ell) - u0) / du,
                    (sod * sdd) / (ell * ell + t * t))
        return (sdd * t / ell - u0) / du, sod ** 2 / (ell * ell)

    return _backproject_rows(q, geom, wts, sample).reshape(lead + v.shape)


def fbp_cone(sino: torch.Tensor, geom: CTGeometry,
             filter_name: str = "ramp") -> torch.Tensor:
    """FDK reconstruction (flat detector): sino (..., n_angles, n_rows,
    n_cols) -> (..., nx, ny, nz).  Chunked over views and voxel columns so
    that no (views x volume) temporary is built."""
    v = geom.vol
    nx, ny, nz = v.shape
    nxy = nx * ny
    na, nv, nu = geom.sino_shape
    sod, sdd = geom.sod, geom.sdd
    dev = sino.device
    lead = sino.shape[:-3]
    us = torch.from_numpy(geom.u_coords()).to(dev)
    vs = torch.from_numpy(geom.v_coords()).to(dev)
    # cosine pre-weight
    cw = sdd / torch.sqrt(sdd ** 2 + us[None, :] ** 2 + vs[:, None] ** 2)
    q = filter_sinogram(sino * cw, geom.pixel_width, filter_name)
    # The ramp filter acts at detector scale; frequencies at the isocenter
    # are higher by the magnification sdd/sod, so rescale the filtered data.
    q = (q * (sdd / sod)).reshape(-1, na, nv, nu)
    batch = q.shape[0]
    X, Y = _grid_xy(geom, dev)
    Z = torch.from_numpy(v.z_coords()).to(dev)
    u0, du = float(geom.u_coords()[0]), geom.pixel_width
    v0, dv = float(geom.v_coords()[0]), geom.pixel_height
    wts = torch.from_numpy(
        _angle_weights(geom.angles_array(), 2 * np.pi) / np.float32(2.0)).to(dev)
    angs = torch.from_numpy(geom.angles_array()).to(dev)
    acc = torch.zeros((batch, nxy, nz), dtype=q.dtype, device=dev)
    per_voxel = batch * max(nv, nz)
    astep = max(1, _CHUNK_ELEMS // (per_voxel * nxy))
    pstep = max(1, min(nxy, _CHUNK_ELEMS // per_voxel))
    for a0 in range(0, na, astep):
        a1 = min(na, a0 + astep)
        c = torch.cos(angs[a0:a1])[:, None]
        s = torch.sin(angs[a0:a1])[:, None]
        for p0 in range(0, nxy, pstep):
            p1 = min(nxy, p0 + pstep)
            Xp, Yp = X[p0:p1], Y[p0:p1]
            ell = torch.clamp(sod - (Xp * c + Yp * s), min=_EPS)   # (ca, np)
            ui = (sdd * (Yp * c - Xp * s) / ell - u0) / du
            S = _lerp_columns(q[:, a0:a1], ui).transpose(2, 3)    # (B, ca, np, nv)
            vi = (sdd * Z / ell[..., None] - v0) / dv               # (ca, np, nz)
            jv = torch.floor(vi)
            tv = vi - jv
            jv = jv.to(torch.int64)
            val = 0.0
            for jj, wj in ((jv, 1 - tv), (jv + 1, tv)):
                ok = (jj >= 0) & (jj < nv)
                idx = jj.clamp(0, nv - 1)[None].expand(batch, -1, -1, -1)
                val = val + torch.gather(S, 3, idx) * torch.where(ok, wj, 0.0)[None]
            val = val * (sod ** 2 / ell[..., None] ** 2)[None]
            acc[:, p0:p1] += torch.einsum("banz,a->bnz", val, wts[a0:a1])
    return acc.reshape(lead + v.shape)


def fbp(sino: torch.Tensor, geom: CTGeometry, filter_name: str = "ramp",
        short_scan: Optional[bool] = None) -> torch.Tensor:
    """Analytic reconstruction: FBP for parallel and fan beams, FDK for
    flat-detector cone beams.  ``short_scan`` applies only to fan beams
    (Parker weighting; ``None`` auto-detects from the angular span)."""
    if geom.geom_type == "parallel":
        return fbp_parallel(sino, geom, filter_name)
    if geom.geom_type == "fan":
        return fbp_fan(sino, geom, filter_name, short_scan=short_scan)
    if geom.geom_type == "cone":
        if geom.detector_type != "flat":
            raise NotImplementedError("FDK implemented for flat detectors")
        return fbp_cone(sino, geom, filter_name)
    raise NotImplementedError(
        f"FBP needs parallel, fan, or cone geometry, got {geom.geom_type!r}; "
        f"iterative recon (repro_torch.recon) covers the rest")
