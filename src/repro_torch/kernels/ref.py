"""Plain PyTorch reference projectors (the ``ref`` backend).

What CPU tensors run on, and what ``backend="ref"`` runs on any device: the
plain versions of the CUDA kernels with no kernel launch.  For the
lane-packed pairs (parallel, fan, and the packed cone pair) that is
``fp_par.fp_lanes_plain`` and its VJP ``fp_par.bp_lanes_plain`` inside the
lane packing, with each plan's footprint weights; for the exact cone and the
modular pairs ``fp_cone.fp_batch_plain`` and its VJP
``fp_cone.bp_batch_plain`` on each plan (a ``ModularPlan`` is a ``ConePlan``
with per-view axial frames).  Each backprojection is the vector-Jacobian
product of the linear forward map, so it is the exact transpose by
construction.

Models:
    * ``sf``     -- Separable Footprint for parallel, fan (flat and curved),
      flat-detector cone and axial-frame modular beams.  Tilted modular
      frames (or a source inside the volume) run the Joseph ray-marcher, as
      the reference's ``fp_modular_sf_ref`` does; a curved-detector cone
      raises, as the reference does.
    * ``joseph`` -- driving-axis linear interpolation (Joseph 1982) for
      parallel, cone (flat and curved) and modular beams
      (:func:`fp_parallel_joseph`, :func:`fp_cone_joseph`,
      :func:`fp_modular_joseph`): plain torch on the tensor's device, with no
      kernel (the reference has none either).

``forward`` maps ``f (nx, ny, nz) -> sino (n_angles, n_rows, n_cols)``, or a
batch ``(B, nx, ny, nz) -> (B, n_angles, n_rows, n_cols)``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import fp_cone, fp_fan, fp_modular, fp_par, precision

_EPS = 1e-9

# Each Joseph step keeps its (batch x views x ...) temporaries under this
# many elements.
_CHUNK_ELEMS = 1 << 23


# --------------------------------------------------------------------------- #
# Joseph projectors (plain torch; batched volumes (B, nx, ny, nz))
# --------------------------------------------------------------------------- #
def _lerp_take(arr: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Linearly interpolate ``arr`` along ``dim`` at float positions ``pos``
    (broadcast against ``arr`` in every other dim).  Out-of-range positions
    contribute zero."""
    n = arr.shape[dim]
    j = torch.floor(pos)
    w = pos - j
    j = j.to(torch.int64)
    valid0 = (j >= 0) & (j <= n - 1)
    valid1 = (j + 1 >= 0) & (j + 1 <= n - 1)
    a0 = torch.take_along_dim(arr, j.clamp(0, n - 1), dim)
    a1 = torch.take_along_dim(arr, (j + 1).clamp(0, n - 1), dim)
    return (a0 * torch.where(valid0, 1.0 - w, 0.0)
            + a1 * torch.where(valid1, w, 0.0))


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _view_chunks(n_views: int, per_view: int):
    step = max(1, _CHUNK_ELEMS // max(per_view, 1))
    for a0 in range(0, n_views, step):
        yield a0, min(n_views, a0 + step)


def _parallel_views(f: torch.Tensor, geom: CTGeometry, a0: int, a1: int):
    """Joseph parallel beam, views a0..a1 of ``f`` (B, nx, ny, nz) ->
    (B, a1 - a0, n_rows, n_cols)."""
    dev = f.device
    v = geom.vol
    nx, ny, nz = v.shape
    xs, ys = _t(v.x_coords(), dev), _t(v.y_coords(), dev)
    us, vs = _t(geom.u_coords(), dev), _t(geom.v_coords(), dev)
    ang = _t(geom.angles_array()[a0:a1], dev)
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    drive_x = torch.abs(c) >= torch.abs(s)                        # (V, 1, 1)
    one = torch.ones_like(c)
    # drive along x: y = x tan + u / cos
    dc = torch.where(drive_x, c, one)
    yi = ((xs[None, :, None] * (s / dc) + us[None, None, :] / dc - v.offset_y)
          / v.dy + (ny - 1) / 2.0)                                # (V, nx, nu)
    gx = _lerp_take(f[:, None], yi[None, :, :, :, None], 3)      # (B, V, nx, nu, nz)
    sx = gx.sum(2) * (v.dx / torch.clamp(torch.abs(c), min=_EPS))[None]
    # drive along y: x = y cot - u / sin
    ds = torch.where(drive_x, one, s)
    xi = ((ys[None, :, None] * (c / ds) - us[None, None, :] / ds - v.offset_x)
          / v.dx + (nx - 1) / 2.0)                                # (V, ny, nu)
    gy = _lerp_take(f.transpose(1, 2)[:, None], xi[None, :, :, :, None], 3)
    sy = gy.sum(2) * (v.dy / torch.clamp(torch.abs(s), min=_EPS))[None]
    srow = torch.where(drive_x[None], sx, sy)                     # (B, V, nu, nz)
    zi = (vs - v.offset_z) / v.dz + (nz - 1) / 2.0                # (nv,)
    p = _lerp_take(srow, zi.reshape(1, 1, 1, -1), 3)              # (B, V, nu, nv)
    return p.transpose(2, 3)


def _cone_views(f: torch.Tensor, geom: CTGeometry, a0: int, a1: int):
    """Joseph cone beam (flat or curved detector, source at z = 0), views
    a0..a1 of ``f`` (B, nx, ny, nz) -> (B, a1 - a0, n_rows, n_cols)."""
    dev = f.device
    v = geom.vol
    nx, ny, nz = v.shape
    xs, ys = _t(v.x_coords(), dev), _t(v.y_coords(), dev)
    us, vs = _t(geom.u_coords(), dev), _t(geom.v_coords(), dev)
    sod, sdd = geom.sod, geom.sdd
    ang = _t(geom.angles_array()[a0:a1], dev)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]      # (V, 1)
    sx, sy = sod * c, sod * s
    if geom.detector_type == "curved":
        gam = us / sdd
        dirx = sdd * (-c * torch.cos(gam) - s * torch.sin(gam))  # (V, nu)
        diry = sdd * (-s * torch.cos(gam) + c * torch.sin(gam))
    else:
        dirx = -sdd * c - us * s
        diry = -sdd * s + us * c
    drive_x = (torch.abs(c) >= torch.abs(s))[None, :, :, None]   # (1, V, 1, 1)

    def project(fv, axis_coords, other_offset, other_d, n_other, src_a, src_b,
                dir_a, dir_b, da):
        # drive along axis a; interpolate along axis b, then z
        den = torch.where(torch.abs(dir_a) > _EPS, dir_a,
                          torch.full_like(dir_a, _EPS))
        t = (axis_coords[None, :, None] - src_a[:, :, None]) / den[:, None, :]
        bpos = src_b[:, :, None] + t * dir_b[:, None, :]          # (V, na_, nu)
        bi = (bpos - other_offset) / other_d + (n_other - 1) / 2.0
        A = _lerp_take(fv[:, None], bi[None, ..., None], 3)       # (B, V, na_, nu, nz)
        zi = ((t[..., None] * vs - v.offset_z) / v.dz
              + (nz - 1) / 2.0)                                   # (V, na_, nu, nv)
        Bz = _lerp_take(A, zi[None], 4)                           # (B, V, na_, nu, nv)
        tin = (t > 0.0) & (t < 1.0)
        Bz = Bz * tin[None, ..., None]
        wt = da * torch.sqrt((dir_a ** 2 + dir_b ** 2)[..., None]
                             + vs ** 2) / torch.clamp(
            torch.abs(dir_a), min=_EPS)[..., None]                # (V, nu, nv)
        return Bz.sum(2) * wt[None]                               # (B, V, nu, nv)

    px = project(f, xs, v.offset_y, v.dy, ny, sx, sy, dirx, diry, v.dx)
    py = project(f.transpose(1, 2), ys, v.offset_x, v.dx, nx, sy, sx, diry,
                 dirx, v.dy)
    return torch.where(drive_x, px, py).transpose(2, 3)


def _modular_views(f: torch.Tensor, geom: CTGeometry, a0: int, a1: int,
                   oversample: float = 2.0):
    """Joseph ray marching through arbitrary source/detector frames, views
    a0..a1 of ``f`` (B, nx, ny, nz) -> (B, a1 - a0, n_rows, n_cols): each
    ray's clip to the volume box in ``n_steps`` midpoint samples, each a
    trilinear interpolation."""
    dev = f.device
    v = geom.vol
    nx, ny, nz = v.shape
    us, vs = _t(geom.u_coords(), dev), _t(geom.v_coords(), dev)
    n_steps = int(np.ceil(oversample * np.sqrt(3) * max(v.shape)))
    bmin = _t([v.x_coords()[0] - v.dx / 2, v.y_coords()[0] - v.dy / 2,
               v.z_coords()[0] - v.dz / 2], dev)
    bmax = _t([v.x_coords()[-1] + v.dx / 2, v.y_coords()[-1] + v.dy / 2,
               v.z_coords()[-1] + v.dz / 2], dev)
    off = _t([v.offset_x, v.offset_y, v.offset_z], dev)
    dd = _t([v.dx, v.dy, v.dz], dev)
    nn = torch.tensor([nx, ny, nz], device=dev)
    src, ctr, eu, ev = (_t(np.asarray(a)[a0:a1], dev)[:, None, None, :]
                        for a in (geom.source_pos, geom.det_center,
                                  geom.det_u, geom.det_v))        # (V, 1, 1, 3)
    d = ctr + us[None, None, :, None] * eu + vs[None, :, None, None] * ev
    dirv = d - src                                                # (V, nv, nu, 3)
    inv = 1.0 / torch.where(torch.abs(dirv) > _EPS, dirv,
                            torch.full_like(dirv, _EPS))
    ta, tb = (bmin - src) * inv, (bmax - src) * inv
    tmin = torch.clamp(torch.amax(torch.minimum(ta, tb), -1), min=0.0)
    tmax = torch.amin(torch.maximum(ta, tb), -1)
    dt = torch.clamp(tmax - tmin, min=0.0) / n_steps              # (V, nv, nu)
    dlen = torch.linalg.vector_norm(dirv, dim=-1)
    # a border of zeros: the corners of a sample outside the volume read it
    fpad = torch.nn.functional.pad(f, (1, 1, 1, 1, 1, 1)).reshape(f.shape[0], -1)
    k = torch.arange(n_steps, device=dev, dtype=torch.float32)
    t = tmin[:, None] + (k[None, :, None, None] + 0.5) * dt[:, None]  # (V, S, nv, nu)
    pt = src[:, None] + t[..., None] * dirv[:, None]              # (V, S, nv, nu, 3)
    fi = (pt - off) / dd + (nn - 1) / 2.0
    j = torch.floor(fi)
    w = fi - j
    j = j.to(torch.int64)
    stride = (ny + 2) * (nz + 2), nz + 2, 1
    ends = []                     # per axis: the two corners' padded offsets
    for ax in range(3):
        ja = torch.clamp(j[..., ax] + 1, 0, int(nn[ax]) + 1)
        jb = torch.clamp(j[..., ax] + 2, 0, int(nn[ax]) + 1)
        ends.append(((ja * stride[ax]).reshape(-1), (jb * stride[ax]).reshape(-1),
                     w[..., ax].reshape(-1)))
    val = 0.0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                flat = ends[0][cx] + ends[1][cy] + ends[2][cz]
                ww = ((ends[0][2] if cx else 1 - ends[0][2])
                      * (ends[1][2] if cy else 1 - ends[1][2])
                      * (ends[2][2] if cz else 1 - ends[2][2]))
                g = torch.gather(fpad, 1, flat.expand(f.shape[0], -1))
                val = val + g * ww
    val = val.reshape((f.shape[0],) + t.shape)
    return val.sum(2) * (dt * dlen)[None]                         # (B, V, nv, nu)


def _per_view(g: CTGeometry) -> int:
    """Elements a view of the parallel or cone Joseph projector keeps."""
    return max(g.vol.nx, g.vol.ny) * g.n_cols * max(g.vol.nz, g.n_rows)


def _modular_per_view(g: CTGeometry, oversample: float = 2.0) -> int:
    """Elements a view of the modular ray-marcher keeps."""
    return (int(np.ceil(oversample * np.sqrt(3) * max(g.vol.shape)))
            * g.n_rows * g.n_cols * 4)


def _run_views(views: Callable, per_view: int, f: torch.Tensor,
               geom: CTGeometry) -> torch.Tensor:
    """A Joseph forward map over every view, chunk by chunk: ``f`` (nx, ny,
    nz) or (B, nx, ny, nz) -> (n_angles, n_rows, n_cols) or (B, ...)."""
    fb = f if f.dim() == 4 else f[None]
    out = torch.cat([views(fb, geom, a0, a1) for a0, a1 in _view_chunks(
        geom.n_angles, fb.shape[0] * per_view)], 1)
    return out if f.dim() == 4 else out[0]


def fp_parallel_joseph(f: torch.Tensor, geom: CTGeometry) -> torch.Tensor:
    """Joseph parallel beam: each ray driven along the axis it is closest
    to, linearly interpolated across it and then axially onto the rows."""
    return _run_views(_parallel_views, _per_view(geom), f, geom)


def fp_cone_joseph(f: torch.Tensor, geom: CTGeometry) -> torch.Tensor:
    """Joseph cone beam on a flat or curved (equiangular) detector, source
    at z = 0: driven along the axis the central ray is closest to,
    interpolated across it and axially, with the ray-length weight."""
    return _run_views(_cone_views, _per_view(geom), f, geom)


def fp_modular_joseph(f: torch.Tensor, geom: CTGeometry,
                      oversample: float = 2.0) -> torch.Tensor:
    """Joseph ray marching through the per-view source and detector frames
    of a modular geometry (any frame: tilted, or a source inside the
    volume); ``oversample`` steps per voxel along the longest diagonal."""
    return _run_views(
        lambda fb, g, a0, a1: _modular_views(fb, g, a0, a1, oversample),
        _modular_per_view(geom, oversample), f, geom)


class JosephPlan:
    """A Joseph projector on one geometry: ``views(f, geom, a0, a1)`` maps a
    batched volume to views a0..a1 of its sinogram, ``per_view(geom)`` the
    elements a view keeps (which sets the chunks)."""

    def __init__(self, geom: CTGeometry, views: Callable, per_view: Callable):
        self.geom = geom
        self.views = views
        self.per_view = per_view(geom)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        return _run_views(self.views, self.per_view, f, self.geom)

    def adjoint(self, q: torch.Tensor) -> torch.Tensor:
        """The VJP of :meth:`forward`, chunk by chunk over the views (each
        chunk's graph is freed before the next): its exact transpose."""
        geom = self.geom
        qb = q if q.dim() == 4 else q[None]
        out = torch.zeros((qb.shape[0],) + geom.vol.shape, dtype=torch.float32,
                          device=q.device)
        for a0, a1 in _view_chunks(geom.n_angles, qb.shape[0] * self.per_view):
            f0 = torch.zeros_like(out, requires_grad=True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(self.views(f0, geom, a0, a1), f0,
                                           qb[:, a0:a1].to(torch.float32))
            out += g
        return out if q.dim() == 4 else out[0]


# --------------------------------------------------------------------------- #
# Dispatch + matched adjoints
# --------------------------------------------------------------------------- #
_PLANS = {("parallel", "sf"): fp_par.ParallelPlan,
          ("fan", "sf"): fp_fan.FanPlan,
          ("cone", "sf"): fp_cone.ConePlan,
          ("modular", "sf"): fp_modular.ModularPlan}

# the Joseph projectors' views and their sizes, by geometry type
_JOSEPH = {"parallel": (_parallel_views, _per_view),
           "cone": (_cone_views, _per_view),
           "modular": (_modular_views, _modular_per_view)}


def _plan(geom: CTGeometry, model: str):
    """The plain pair's plan of (geometry, model).  Tilted modular frames
    under ``sf`` take the Joseph plan, as the reference's
    ``fp_modular_sf_ref`` does; unsupported pairs raise."""
    key = (geom.geom_type, model)
    if key == ("modular", "sf") and not fp_modular.modular_frames_axial(geom):
        model = "joseph"
    if model == "joseph" and geom.geom_type in _JOSEPH:
        return JosephPlan(geom, *_JOSEPH[geom.geom_type])
    if key not in _PLANS:
        raise NotImplementedError(f"no reference projector for {key}")
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
            dtype=None, plan=None) -> torch.Tensor:
    """Reference forward projection.  ``dtype`` mirrors the kernels'
    ``compute_dtype`` policy: the volume is quantized to the compute dtype,
    the math runs in f32, and the result comes back in the input's dtype.
    ``plan`` (default: ``_plan(geom, model)``) may be a lane plan of another
    axial map, as the packed cone pair's."""
    plan = _plan(geom, model) if plan is None else plan
    fq, out_dtype = _quantize_in(f, dtype)
    if isinstance(plan, JosephPlan):
        out = plan.forward(fq)
    elif isinstance(plan, fp_cone.ConePlan):
        out = fp_cone.fp_unpacked(fq, plan, torch.float32,
                                  lambda x: fp_cone.fp_batch_plain(x, plan))
    else:
        out = fp_par.fp_packed(fq, plan, torch.float32,
                               lambda g: fp_par.fp_lanes_plain(g, plan))
    return out if out_dtype is None else out.to(out_dtype)


def adjoint(sino: torch.Tensor, geom: CTGeometry, model: str = "sf",
            dtype=None, plan=None) -> torch.Tensor:
    """Exact-transpose backprojection: A^T applied to ``sino`` (3D, or 4D
    with a leading batch) -- the VJP of :func:`forward`'s plain map."""
    plan = _plan(geom, model) if plan is None else plan
    q, out_dtype = _quantize_in(sino, dtype)
    if isinstance(plan, JosephPlan):
        out = plan.adjoint(q)
    elif isinstance(plan, fp_cone.ConePlan):
        out = fp_cone.bp_unpacked(q, plan, torch.float32,
                                  lambda p: fp_cone.bp_batch_plain(p, plan))
    else:
        out = fp_par.bp_packed(q, plan, torch.float32,
                               lambda p: fp_par.bp_lanes_plain(p, plan))
    return out if out_dtype is None else out.to(out_dtype)
