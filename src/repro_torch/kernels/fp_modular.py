"""Modular-beam Separable-Footprint forward/back projection pair: per-view
frames (source position, detector centre and axes), which carry helical
scans, per-view detector shifts and non-circular orbits.

CUDA tensors run the hand-written kernels of ``csrc/fp_modular.cu`` (which
replace the TPU kernels ``repro/kernels/fp_modular.py``
``_fp_modular_kernel`` and ``_bp_modular_kernel``); CPU tensors run their
plain PyTorch versions, the exact cone pair's :func:`fp_cone.fp_batch_plain`
and its chunk-by-chunk VJP :func:`fp_cone.bp_batch_plain` on the plan below,
whose axial map (:meth:`ModularPlan.axial`) reads the per-view frame.

The pair covers **axial frames** only (:func:`modular_frames_axial`):
detector rows parallel to the rotation axis (``e_v = ±z``, ``e_u``
transaxial) and the source transaxially outside the volume, at any height.
With ``n`` the in-plane unit normal toward the detector, ``q = (p − s)·e_u``,
``ℓ = (p − s)·n``, ``sdd_a = (c − s)·n`` and ``cu = (s − c)·e_u``, a point
projects to

    u = sdd_a·q/ℓ + cu = SDD_REF·q̂/ℓ,   q̂ = (sdd_a/SDD_REF)·q + (cu/SDD_REF)·ℓ
    v = (z − s_z)·(e_vz·sdd_a)/ℓ + cv

so the cone pair's corner trapezoid applies with one static ``SDD_REF`` (the
median detector distance) on the rescaled and sheared q̂, and the axial
rectangle picks up a per-view signed magnification, source height and row
offset.  :func:`_view_params_modular` gives 24 floats per view: the cone
layout on q̂, then ``e_vz·sdd_a``, ``s_z``, ``cv`` and a pad; the tables are
bit-identical to the reference package's.

Tilted frames and sources inside the volume have no SF pair: the plan raises
``NotImplementedError``, the entry's ``supports`` gate
(:func:`modular_frames_axial`) keeps ``backend="auto"`` off the kernels for
them, and ``backend="auto"`` / ``"ref"`` run them on the Joseph ray-marcher
(``ref.fp_modular_joseph``), as the reference does.  Each kernel wrapper
counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import precision, tune
from repro_torch.kernels.fp_cone import (_EPS, ConePlan, _f32, bp_batch_plain,
                                         bp_unpacked, fp_batch_plain,
                                         fp_unpacked, launch)

__all__ = ["ModularPlan", "LAUNCHES", "reset_launches", "modular_frames_axial",
           "fp_batch", "bp_batch", "fp_batch_plain", "bp_batch_plain",
           "fp_modular_sf", "bp_modular_sf", "register"]

_AXIAL_TOL = 1e-4

# Kernel launches since the last reset_launches(), by kernel.  One call of a
# wrapper launches once per non-empty view group.
LAUNCHES: Dict[str, int] = {"fp_modular_sf": 0, "bp_modular_sf": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# Per-view frames (float64, as the reference)
# --------------------------------------------------------------------------- #
def _frames(geom: CTGeometry):
    """Decompose the per-view modular frames into the kernel's quantities.

    Returns a dict of (na,)-shaped float64 arrays: source ``s``/``sz``,
    in-plane detector axis ``eu``, in-plane unit normal ``n`` oriented
    source -> detector, detector distance ``sdd`` along ``n``, in-plane /
    axial detector offsets ``cu``/``cv``, and the e_v z-sign ``evz``."""
    if geom.geom_type != "modular":
        raise ValueError(f"_frames needs a modular geometry, got "
                         f"geom_type={geom.geom_type!r}")
    s = np.asarray(geom.source_pos, np.float64)
    c = np.asarray(geom.det_center, np.float64)
    eu = np.asarray(geom.det_u, np.float64)
    ev = np.asarray(geom.det_v, np.float64)
    n = np.stack([eu[:, 1] * ev[:, 2], -eu[:, 0] * ev[:, 2],
                  np.zeros(len(eu))], -1)              # eu x ev (axial frames)
    d = c - s
    sdd = np.einsum("ai,ai->a", d, n)
    flip = np.sign(sdd)
    flip[flip == 0] = 1.0
    n = n * flip[:, None]
    sdd = sdd * flip
    return {
        "s": s, "sz": s[:, 2], "eu": eu, "ev": ev, "n": n, "sdd": sdd,
        "cu": -np.einsum("ai,ai->a", d, eu),
        "cv": -np.einsum("ai,ai->a", d, ev),
        "evz": ev[:, 2],
    }


def modular_frames_axial(geom: CTGeometry, fr=None) -> bool:
    """True when the per-view frames are in the axial subclass the SF pair
    supports: unit detector axes, ``e_u`` transaxial, ``e_v = ±ẑ``, a
    non-degenerate detector distance, and the source transaxially outside
    the volume for every view.  ``fr`` accepts a precomputed
    ``_frames(geom)``."""
    if geom.geom_type != "modular":
        return False
    eu = np.asarray(geom.det_u, np.float64)
    ev = np.asarray(geom.det_v, np.float64)
    if not (np.allclose(np.linalg.norm(eu, axis=1), 1.0, atol=_AXIAL_TOL)
            and np.allclose(np.linalg.norm(ev, axis=1), 1.0, atol=_AXIAL_TOL)
            and np.all(np.abs(eu[:, 2]) < _AXIAL_TOL)
            and np.all(np.abs(ev[:, 0]) < _AXIAL_TOL)
            and np.all(np.abs(ev[:, 1]) < _AXIAL_TOL)):
        return False
    fr = _frames(geom) if fr is None else fr
    if np.any(fr["sdd"] <= _AXIAL_TOL):
        return False
    lc, _ = _ell_center(geom, fr)
    return bool(np.all(lc - geom.vol.radius > 1e-3))


def _require_axial(geom: CTGeometry, fr=None) -> None:
    if not modular_frames_axial(geom, fr):
        raise NotImplementedError(
            "the modular SF pair supports axial frames (detector rows "
            "parallel to the rotation axis, source outside the volume); "
            "backend='auto' or 'ref' runs other frames on the Joseph "
            "ray-marcher (model='joseph')")


def _ell_center(geom: CTGeometry, fr) -> Tuple[np.ndarray, float]:
    """Per-view in-plane distance from the source to the volume center along
    the detector normal, plus the volume's transaxial radius."""
    v = geom.vol
    p0 = np.asarray([v.offset_x, v.offset_y])
    lc = np.einsum("ai,ai->a", p0[None, :] - fr["s"][:, :2], fr["n"][:, :2])
    return lc, v.radius


def _mag_bounds_modular(geom: CTGeometry, fr) -> Tuple[float, float]:
    """(mag_min, mag_max) of the unsigned magnification sdd_a/ℓ over all
    views and the volume disk."""
    lc, r = _ell_center(geom, fr)
    mag_min = float(np.min(fr["sdd"] / (lc + r)))
    mag_max = float(np.max(fr["sdd"] / np.maximum(lc - r, 1e-3)))
    return mag_min, mag_max


def footprint_halfwidth_modular(geom: CTGeometry, fr) -> float:
    """A bound, in detector mm, on how far any corner of a voxel projects
    from its centre, the maximum over views.  u = sdd_a·q/ℓ + cu moves at
    most sdd_a/ℓ·sqrt(1 + (q/ℓ)²) per mm in the plane; every point of the
    volume lies within the radius r of the volume centre p0, so ℓ ≥ ℓ_c − r
    and |q| ≤ |q_c| + r with q_c = (p0 − s)·e_u.  The shift cu translates u
    and does not widen it.  A corner lies hypot(dx, dy)/2 from the centre."""
    v = geom.vol
    lc, r = _ell_center(geom, fr)
    p0 = np.asarray([v.offset_x, v.offset_y])
    qc = np.einsum("ai,ai->a", p0[None, :] - fr["s"][:, :2], fr["eu"][:, :2])
    lmin = np.maximum(lc - r, 1e-3)
    t = (np.abs(qc) + r) / lmin
    hw = math.hypot(v.dx, v.dy) / 2.0 * fr["sdd"] / lmin * np.sqrt(1.0 + t * t)
    return float(np.max(hw))


# --------------------------------------------------------------------------- #
# Per-view affine parameters (24 floats)
# --------------------------------------------------------------------------- #
def _view_params_modular(geom: CTGeometry, fr=None
                         ) -> Tuple[np.ndarray, np.ndarray,
                                    np.ndarray, float]:
    """Per-view affine coefficients of q̂(gi, li) and ℓ(gi, li), the rx/ry
    affines, the four corner offsets (dq̂_k, dl_k), and the per-view axial
    frame, split into x-gathered (|n_y| >= |n_x|) and y-gathered groups.

    Layout per view (24 floats; [0:20] is the cone layout evaluated on the
    rescaled/sheared q̂ so the cone corner trapezoid applies with the static
    ``sdd_ref`` returned alongside):

      [Aq, Bq, Cq, Al, Bl, Cl, Arx, Brx, Crx, Ary, Bry, Cry,
       dq0, dl0, dq1, dl1, dq2, dl2, dq3, dl3,
       mags (= e_vz * sdd_a), sz, cv, 0]
    """
    v = geom.vol
    fr = _frames(geom) if fr is None else fr
    x0, y0 = float(v.x_coords()[0]), float(v.y_coords()[0])
    hx, hy = v.dx / 2.0, v.dy / 2.0
    sdd_ref = float(np.median(fr["sdd"]))
    scale = fr["sdd"] / sdd_ref
    shear = fr["cu"] / sdd_ref
    eux, euy = fr["eu"][:, 0], fr["eu"][:, 1]
    nx, ny = fr["n"][:, 0], fr["n"][:, 1]
    sx, sy = fr["s"][:, 0], fr["s"][:, 1]
    # q̂ / ℓ direction cosines along world x/y (per view)
    qx = scale * eux + shear * nx
    qy = scale * euy + shear * ny
    C_off = (x0 - sx, y0 - sy)                        # volume corner - source
    Cq = qx * C_off[0] + qy * C_off[1]
    Cl = nx * C_off[0] + ny * C_off[1]

    def grp(gathered_x: bool):
        if gathered_x:                                # gi -> x, li -> y
            Aq, Bq = qx * v.dx, qy * v.dy
            Al, Bl = nx * v.dx, ny * v.dy
            Arx, Brx = v.dx * np.ones_like(nx), np.zeros_like(nx)
            Ary, Bry = np.zeros_like(nx), v.dy * np.ones_like(nx)
        else:                                         # gi -> y, li -> x
            Aq, Bq = qy * v.dy, qx * v.dx
            Al, Bl = ny * v.dy, nx * v.dx
            Arx, Brx = np.zeros_like(nx), v.dx * np.ones_like(nx)
            Ary, Bry = v.dy * np.ones_like(nx), np.zeros_like(nx)
        cols = [Aq, Bq, Cq, Al, Bl, Cl, Arx, Brx, C_off[0],
                Ary, Bry, C_off[1]]
        for ox in (-hx, hx):
            for oy in (-hy, hy):
                cols.append(qx * ox + qy * oy)        # dq̂
                cols.append(nx * ox + ny * oy)        # dl
        cols += [fr["evz"] * fr["sdd"], fr["sz"], fr["cv"],
                 np.zeros_like(nx)]
        return np.stack(cols, -1).astype(np.float32)

    gx = np.abs(ny) >= np.abs(nx)
    px, py = grp(True), grp(False)
    idx_x = np.nonzero(gx)[0]
    idx_y = np.nonzero(~gx)[0]
    return px[idx_x], py[idx_y], np.concatenate([idx_x, idx_y]), sdd_ref


# --------------------------------------------------------------------------- #
# Plan
# --------------------------------------------------------------------------- #
class ModularPlan(ConePlan):
    """What the modular pair derives from a geometry, once per cached op
    bundle: the cone plan's fields (group tables, sinogram rows, grids as
    the f32 values the kernels receive, device copies) on the 24-float
    tables, with ``sdd`` the static reference distance ``sdd_ref``, plus
    ``mag_bounds`` (min, max unsigned magnification) and ``hw``, the FP
    kernel's footprint half-width bound (:func:`footprint_halfwidth_modular`).
    Raises ``NotImplementedError`` on frames the pair does not cover."""

    def __init__(self, geom: CTGeometry):
        if geom.geom_type != "modular":
            raise ValueError(f"the modular SF pair needs a modular geometry, "
                             f"got {geom.geom_type!r}")
        fr = _frames(geom)
        _require_axial(geom, fr)
        px, py, order, sdd_ref = _view_params_modular(geom, fr)
        self._set(geom, px, py, order, sdd_ref)
        self.sdd_ref = sdd_ref
        self.mag_bounds = _mag_bounds_modular(geom, fr)
        hw = footprint_halfwidth_modular(geom, fr)
        self.hw = _f32(hw)
        # footprint taps of the plain version: a trapezoid at most 2 hw wide
        # and a slice at most dz * mag_max tall, one of margin
        self.taps_u = int(math.ceil(2.0 * hw / geom.pixel_width)) + 2
        self.taps_v = int(math.ceil(geom.vol.dz * self.mag_bounds[1]
                                    / geom.pixel_height)) + 2

    def axial(self, table: torch.Tensor, ell: torch.Tensor, rt2: torch.Tensor,
              zt: torch.Tensor):
        """As :meth:`ConePlan.axial`, on the per-view frame: the slice edges
        map to v = (z ∓ dz/2 − s_z)·mag + cv with the signed magnification
        mag = e_vz·sdd_a/ℓ, sorted (mag may be negative), and the obliquity
        is sqrt(1 + (z − s_z)²/rt2)."""
        mags, sz, cv = (table[:, k].reshape(-1, 1, 1) for k in (20, 21, 22))
        hdz = self.dz / 2.0
        mag = mags / torch.clamp(ell, min=_EPS)              # (nvw, N, 1)
        va = ((zt - hdz) - sz) * mag + cv
        vb = ((zt + hdz) - sz) * mag + cv
        dzs = zt - sz
        obl = torch.sqrt(1.0 + (dzs * dzs) / torch.clamp(rt2, min=_EPS))
        return torch.minimum(va, vb), torch.maximum(va, vb), obl


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def fp_batch(f: torch.Tensor, plan: ModularPlan) -> torch.Tensor:
    """FP at the kernel's interface: (batch, nx, ny, nz) -> (batch, n_angles,
    n_rows, n_cols) f32.  A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version :func:`fp_batch_plain`."""
    if f.device.type == "cpu":
        return fp_batch_plain(f, plan)
    return launch("fp_modular", "fp_modular_sf", f, plan, LAUNCHES)


def bp_batch(q: torch.Tensor, plan: ModularPlan) -> torch.Tensor:
    """BP at the kernel's interface: (batch, n_angles, n_rows, n_cols) ->
    (batch, nx, ny, nz) f32.  A CUDA tensor launches the kernel (the second
    view group adds into the first's output); a CPU tensor runs
    :func:`bp_batch_plain`."""
    if q.device.type == "cpu":
        return bp_batch_plain(q, plan)
    return launch("fp_modular", "bp_modular_sf", q, plan, LAUNCHES)


# --------------------------------------------------------------------------- #
# Public entry points (3D or leading-batch 4D)
# --------------------------------------------------------------------------- #
def fp_modular_sf(f: torch.Tensor, plan: ModularPlan,
                  config: Optional[tune.KernelConfig] = None,
                  compute_dtype=None) -> torch.Tensor:
    """f: (nx, ny, nz) -> sino (n_angles, n_rows, n_cols), or batched f:
    (batch, nx, ny, nz) -> (batch, n_angles, n_rows, n_cols).
    ``compute_dtype`` selects the volume's dtype in the kernel (None =
    follow ``f.dtype``); accumulation is f32 and the result comes back in
    ``f.dtype``.  ``config`` is not read: the launch derives its block from
    the shapes."""
    return fp_unpacked(f, plan, precision.resolve(compute_dtype, f.dtype),
                       lambda x: fp_batch(x, plan))


def bp_modular_sf(sino: torch.Tensor, plan: ModularPlan,
                  config: Optional[tune.KernelConfig] = None,
                  compute_dtype=None) -> torch.Tensor:
    """sino: (n_angles, n_rows, n_cols) -> volume (nx, ny, nz), or batched
    (batch, ...) -> (batch, nx, ny, nz).  Exact transpose of
    :func:`fp_modular_sf`."""
    return bp_unpacked(sino, plan, precision.resolve(compute_dtype, sino.dtype),
                       lambda q: bp_batch(q, plan))


def register() -> None:
    from repro_torch.kernels import ops
    ops.register_kernel("modular", "sf", ModularPlan, fp_modular_sf,
                        bp_modular_sf, fp_batched=fp_modular_sf,
                        bp_batched=bp_modular_sf,
                        supports=modular_frames_axial)
