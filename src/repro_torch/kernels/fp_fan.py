"""Fan-beam Separable-Footprint forward/back projection pair.

CUDA tensors run the hand-written kernels of ``csrc/fp_fan.cu`` (which
replace the TPU kernels ``repro/kernels/fp_fan.py`` ``_fp_fan_kernel`` and
``_bp_fan_kernel``); CPU tensors run their plain PyTorch versions.

The fan beam is the cone beam with the axial magnification collapsed: each
detector row is an independent in-plane fan of the matching z-slab, so the
axial (z -> detector row) footprint is the parallel beam's angle-independent
rectangle overlap, applied as one einsum outside the kernels, and the batch
and the rows share one lane axis exactly as in ``fp_par.py``
(:func:`fp_par.fp_packed` / :func:`fp_par.bp_packed`).  What the kernels
evaluate is the cone pair's transaxial corner-projection trapezoid
(``fp_cone._corner_trapezoid``, ``csrc/footprint.cuh``
``sf_corner_trapezoid``) from the same 20-float view rows
(``fp_cone._view_params_cone``), on a flat (``u = sdd * q / ell``) or
curved (``u = sdd * atan2(q, ell)``) detector.

The plain versions are ``fp_par``'s lane-level ones
(:func:`fp_lanes_plain`, its VJP :func:`bp_lanes_plain`) with the weights of
:meth:`FanPlan.weights`; the kernel wrappers :func:`fp_lanes` /
:func:`bp_lanes` count their launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import fp_par, precision, tune
from repro_torch.kernels.footprint import trapezoid_pixel_weight
from repro_torch.kernels.fp_cone import (_corner_trapezoid, _view_params_cone,
                                         footprint_halfwidth)
from repro_torch.kernels.fp_par import (LanePlan, bp_lanes, bp_lanes_plain,
                                        fp_lanes, fp_lanes_plain)

__all__ = ["FanPlan", "LAUNCHES", "reset_launches", "fp_lanes", "bp_lanes",
           "fp_lanes_plain", "bp_lanes_plain", "fp_fan_sf", "bp_fan_sf",
           "register"]

# Kernel launches since the last reset_launches(), by kernel.  One call of a
# wrapper launches once per non-empty view group.
LAUNCHES: Dict[str, int] = {"fp_fan_sf": 0, "bp_fan_sf": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class FanPlan(LanePlan):
    """The fan SF pair's plan: the lane plan of ``fp_par`` with the 20-float
    corner-projection tables, the source-detector distance, the voxel pitch,
    the footprint half-width bound of the FP kernel's voxel window
    (``fp_cone.footprint_halfwidth``) and the detector type."""

    LIB = "fp_fan"
    KERNELS = ("fp_fan_sf", "bp_fan_sf")
    launches = LAUNCHES

    def __init__(self, geom: CTGeometry):
        if geom.geom_type != "fan":
            raise ValueError(f"the fan SF pair needs a fan geometry, got "
                             f"{geom.geom_type!r}")
        super().__init__(geom, *_view_params_cone(geom))
        self.sdd = float(np.float32(geom.sdd))
        self.dxv = float(np.float32(geom.vol.dx))
        self.hw = float(np.float32(footprint_halfwidth(geom)))
        self.curved = geom.detector_type == "curved"

    def fp_args(self) -> tuple:
        return (self.sdd, self.dxv, self.hw, int(self.curved))

    def bp_args(self) -> tuple:
        return (self.sdd, self.dxv, int(self.curved))

    def weights(self, table: torch.Tensor, ng: int, nl: int):
        """For each footprint tap, the detector column (clamped into range)
        and SF weight (zero off the detector) of every (view, gi, li) in
        ``table``: yields ``(u, w)``, both (n_views, ng * nl)."""
        dev = table.device
        gi = torch.arange(ng, device=dev, dtype=torch.float32)[None, :, None]
        li = torch.arange(nl, device=dev, dtype=torch.float32)[None, None, :]
        t0, t1, t2, t3, h = (
            t.reshape(table.shape[0], ng * nl) for t in _corner_trapezoid(
                table, gi, li, self.sdd, self.dxv, self.curved)[:5])
        nu, e0, du = self.geom.n_cols, self.e0, self.du
        u_first = torch.floor((t0 - e0) / du).to(torch.int64)
        for k in range(self.taps):
            u = u_first + k
            el = e0 + u.to(torch.float32) * du
            w = trapezoid_pixel_weight(el, el + du, t0, t1, t2, t3, h)
            yield u.clamp(0, nu - 1), torch.where((u >= 0) & (u < nu), w, 0.0)


def fp_fan_sf(f: torch.Tensor, plan: FanPlan,
              config: Optional[tune.KernelConfig] = None,
              compute_dtype=None) -> torch.Tensor:
    """f: (nx, ny, nz) -> sino (n_angles, n_rows, n_cols), or lane-packed
    batched f: (batch, nx, ny, nz) -> (batch, n_angles, n_rows, n_cols).
    ``compute_dtype`` selects the tile dtype (None = follow ``f.dtype``);
    accumulation is f32 and the result comes back in ``f.dtype``."""
    cfg = tune.resolve_config(plan.geom, fp_par._batch(f, "volume"), config)
    return fp_par.fp_packed(f, plan, precision.resolve(compute_dtype, f.dtype),
                            lambda g: fp_lanes(g, plan, cfg))


def bp_fan_sf(sino: torch.Tensor, plan: FanPlan,
              config: Optional[tune.KernelConfig] = None,
              compute_dtype=None) -> torch.Tensor:
    """sino: (n_angles, n_rows, n_cols) -> volume (nx, ny, nz), or batched
    (batch, ...) -> (batch, nx, ny, nz).  Exact transpose of
    :func:`fp_fan_sf`."""
    cfg = tune.resolve_config(plan.geom, fp_par._batch(sino, "sinogram"),
                              config)
    return fp_par.bp_packed(sino, plan,
                            precision.resolve(compute_dtype, sino.dtype),
                            lambda q: bp_lanes(q, plan, cfg))


def register() -> None:
    from repro_torch.kernels import ops
    ops.register_kernel("fan", "sf", FanPlan, fp_fan_sf, bp_fan_sf,
                        fp_batched=fp_fan_sf, bp_batched=bp_fan_sf)
