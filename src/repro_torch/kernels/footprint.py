"""Shared footprint math for the Separable-Footprint (SF) projector model
(Long, Fessler & Balter 2010), on tensors.

The SF model represents the projection of one voxel onto the detector as a
separable product of a *trapezoid* in the transaxial (u) direction and a
*rectangle* in the axial (v) direction.  Detector-pixel weights are exact
integrals of those footprints over the pixel extent.

``kernels/csrc/footprint.cuh`` evaluates the same float expressions on the
device; keep the two in step.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def trapezoid_cdf(t, t0, t1, t2, t3, h):
    """∫_{-inf}^{t} T(u) du for the trapezoid with breakpoints t0<=t1<=t2<=t3
    and plateau height ``h``.  Piecewise quadratic; handles degenerate
    (triangle / rectangle) cases via safe division."""
    d01 = torch.clamp(t1 - t0, min=_EPS)
    d23 = torch.clamp(t3 - t2, min=_EPS)
    tc1 = torch.minimum(torch.maximum(t, t0), t1)
    tc2 = torch.minimum(torch.maximum(t, t1), t2)
    tc3 = torch.minimum(torch.maximum(t, t2), t3)
    rise = (tc1 - t0) ** 2 / (2.0 * d01)
    mid = tc2 - t1
    fall = ((t3 - t2) ** 2 - (t3 - tc3) ** 2) / (2.0 * d23)
    return h * (rise + mid + fall)


def trapezoid_pixel_weight(edge_lo, edge_hi, t0, t1, t2, t3, h):
    """Mean footprint value over a detector pixel [edge_lo, edge_hi]
    (units: mm of path length)."""
    return (trapezoid_cdf(edge_hi, t0, t1, t2, t3, h)
            - trapezoid_cdf(edge_lo, t0, t1, t2, t3, h)) / torch.clamp(
                edge_hi - edge_lo, min=_EPS)


def parallel_footprint(uc, cos_a, sin_a, dx):
    """Transaxial trapezoid breakpoints + amplitude for *parallel* beam.

    uc: detector coordinate of the voxel center (mm), any shape.
    Returns (t0, t1, t2, t3, h)."""
    a = dx * torch.abs(cos_a)
    b = dx * torch.abs(sin_a)
    half_sum = 0.5 * (a + b)
    half_dif = 0.5 * torch.abs(a - b)
    h = dx / torch.maximum(torch.abs(cos_a), torch.abs(sin_a))
    return uc - half_sum, uc - half_dif, uc + half_dif, uc + half_sum, h


def rect_overlap(lo, hi, edge_lo, edge_hi):
    """Mean of a unit-height rectangle [lo, hi] over pixel [edge_lo, edge_hi]
    (dimensionless in [0, 1])."""
    ov = torch.clamp(torch.minimum(hi, edge_hi) - torch.maximum(lo, edge_lo),
                     min=0.0)
    return ov / torch.clamp(edge_hi - edge_lo, min=_EPS)


def fan_transaxial_footprint(x, y, cos_a, sin_a, sod, sdd, dx,
                             curved: bool = False):
    """Exact corner-projection trapezoid for a divergent (fan / cone
    transaxial) beam, in world coordinates.

    x, y: voxel center world coordinates (broadcastable tensors).
    ``curved=False`` projects corners onto a flat detector
    (``u = sdd * q / ell``, equispaced columns); ``curved=True`` onto an
    equiangular arc (``u = sdd * atan2(q, ell)``, u = arc length).
    Returns (t0, t1, t2, t3, h, ell) where ell is the distance from the
    source plane to the voxel along the central-ray direction.  The kernels
    and the plain versions evaluate the same trapezoid from per-view affine
    tables (``fp_cone._corner_trapezoid``); this world-space form is the
    tests' independent witness of those tables (fan and flat cone alike)."""
    hx = 0.5 * dx
    taus = []
    for sx in (-hx, hx):
        for sy in (-hx, hx):
            xx = x + sx
            yy = y + sy
            ell = sod - (xx * cos_a + yy * sin_a)
            q = yy * cos_a - xx * sin_a
            if curved:
                taus.append(sdd * torch.atan2(q, torch.clamp(ell, min=_EPS)))
            else:
                taus.append(sdd * q / torch.clamp(ell, min=_EPS))
    taus = torch.sort(torch.stack(taus, dim=-1), dim=-1).values
    t0, t1, t2, t3 = taus[..., 0], taus[..., 1], taus[..., 2], taus[..., 3]
    # Amplitude: path length of the central ray through the voxel footprint.
    ell_c = sod - (x * cos_a + y * sin_a)
    # transaxial direction of the ray through the voxel center
    rx = x - sod * cos_a
    ry = y - sod * sin_a
    rt = torch.sqrt(rx * rx + ry * ry)
    h = dx / torch.maximum(torch.abs(rx), torch.abs(ry)) * rt
    return t0, t1, t2, t3, h, ell_c
