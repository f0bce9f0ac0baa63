"""Plain PyTorch reference projectors (the ``ref`` backend).

What CPU tensors run on, and what ``backend="ref"`` runs on any device: the
plain versions of the CUDA kernels with no kernel launch.  For the
lane-packed pairs (parallel, fan) that is ``fp_par.fp_lanes_plain`` and its
VJP ``fp_par.bp_lanes_plain`` inside the lane packing, with each plan's
footprint weights; for the exact cone and the modular pairs
``fp_cone.fp_batch_plain`` and its VJP ``fp_cone.bp_batch_plain`` on each
plan (a ``ModularPlan`` is a ``ConePlan`` with per-view axial frames).  Each
backprojection is the vector-Jacobian product of the linear forward map, so
it is the exact transpose by construction.

The port carries the Separable-Footprint model for parallel, fan (flat and
curved), flat-detector cone and axial-frame modular beams.  Other
(geometry, model) pairs raise ``NotImplementedError``; ROADMAP.md queue 1
orders their port.

``forward`` maps ``f (nx, ny, nz) -> sino (n_angles, n_rows, n_cols)``, or a
batch ``(B, nx, ny, nz) -> (B, n_angles, n_rows, n_cols)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import fp_cone, fp_fan, fp_modular, fp_par, precision

_PLANS = {("parallel", "sf"): fp_par.ParallelPlan,
          ("fan", "sf"): fp_fan.FanPlan,
          ("cone", "sf"): fp_cone.ConePlan,
          ("modular", "sf"): fp_modular.ModularPlan}


def _plan(geom: CTGeometry, model: str):
    key = (geom.geom_type, model)
    if key not in _PLANS:
        raise NotImplementedError(
            f"no reference projector for {key} in the PyTorch port yet; "
            f"ROADMAP.md queue 1 lists the slices still to port")
    return _PLANS[key](geom)


def _quantize_in(x: torch.Tensor, dtype):
    """Quantize the *data* to the compute dtype (matching the kernels' tile
    cast) but run the reference math in f32: detector-edge coordinates at
    bf16's 8-bit mantissa would corrupt the footprint geometry the kernels
    always derive in f32.  Returns (f32 quantized data, original dtype) or
    (x, None) when the plain f32 path applies unchanged."""
    cdt = precision.resolve(dtype, x.dtype)
    if cdt == torch.float32 and x.dtype == torch.float32:
        return x, None
    return x.to(cdt).to(torch.float32), x.dtype


def forward(f: torch.Tensor, geom: CTGeometry, model: str = "sf",
            dtype=None) -> torch.Tensor:
    """Reference forward projection.  ``dtype`` mirrors the kernels'
    ``compute_dtype`` policy: the volume is quantized to the compute dtype,
    the math runs in f32, and the result comes back in the input's dtype."""
    plan = _plan(geom, model)
    fq, out_dtype = _quantize_in(f, dtype)
    if isinstance(plan, fp_cone.ConePlan):
        out = fp_cone.fp_unpacked(fq, plan, torch.float32,
                                  lambda x: fp_cone.fp_batch_plain(x, plan))
    else:
        out = fp_par.fp_packed(fq, plan, torch.float32,
                               lambda g: fp_par.fp_lanes_plain(g, plan))
    return out if out_dtype is None else out.to(out_dtype)


def adjoint(sino: torch.Tensor, geom: CTGeometry, model: str = "sf",
            dtype=None) -> torch.Tensor:
    """Exact-transpose backprojection: A^T applied to ``sino`` (3D, or 4D
    with a leading batch) — the VJP of :func:`forward`'s plain lane map
    inside the transpose of its packing."""
    plan = _plan(geom, model)
    q, out_dtype = _quantize_in(sino, dtype)
    if isinstance(plan, fp_cone.ConePlan):
        out = fp_cone.bp_unpacked(q, plan, torch.float32,
                                  lambda p: fp_cone.bp_batch_plain(p, plan))
    else:
        out = fp_par.bp_packed(q, plan, torch.float32,
                               lambda p: fp_par.bp_lanes_plain(p, plan))
    return out if out_dtype is None else out.to(out_dtype)
