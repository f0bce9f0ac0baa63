"""Parallel-beam Separable-Footprint forward/back projection pair.

CUDA tensors run the hand-written kernels of ``csrc/fp_par.cu`` (which
replace the TPU kernels ``repro/kernels/fp_par.py`` ``_fp_kernel`` and
``_bp_kernel``); CPU tensors run their plain PyTorch versions
(:func:`fp_lanes_plain`, :func:`bp_lanes_plain`), which evaluate the same
weights from the same per-view tables.  The plain BP is the VJP of the plain
FP, so the port has one plain implementation of the pair; the ``ref``
backend (``kernels/ref.py``) is the lane packing around it.

**Lane packing.**  The axial (z -> detector row) part of the footprint is an
angle-independent banded matrix for parallel beams and is applied as one
einsum outside the kernels.  What remains is the same transaxial operator
for every ``batch x n_rows`` column, so the batch folds into a contiguous
*lane* axis: the kernels see a volume ``(nx, ny, lanes)`` and a sinogram
``(n_angles, n_cols, lanes)``.  For the 2D limited-angle training shape
(nz = 1, n_rows = 1) the lanes are the batch.

**View groups.**  :func:`_view_params` splits the views into an x-gathered
group (|sin| >= |cos|) and a y-gathered group and gives, per view, the
affine ``uc = P*gi + Q*li + R`` of the voxel centre plus the trapezoid
(hs, hd, h).  The tables are bit-identical to the reference package's.  The
kernels read both groups from the one buffer through strides.

The lane packing, the plain versions and the kernel wrappers serve every
lane-packed pair through its :class:`LanePlan` (the fan pair's is
``fp_fan.FanPlan``); a wrapper counts its launches in the ``LAUNCHES`` of
the plan's module, here :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import precision, tune
from repro_torch.kernels.footprint import trapezoid_pixel_weight

# Views are processed in chunks whose (views x voxels x lanes) product stays
# under this many elements, which bounds the plain versions' temporaries.
_CHUNK_ELEMS = 1 << 25

# Kernel launches since the last reset_launches(), by kernel.  One call of a
# wrapper launches once per non-empty view group.
LAUNCHES: Dict[str, int] = {"fp_par_sf": 0, "bp_par_sf": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# Per-view affine coefficients and the axial overlap (static, numpy)
# --------------------------------------------------------------------------- #
def _z_overlap_matrix(geom: CTGeometry) -> np.ndarray:
    """(nz, nv) rectangle-overlap weights for parallel beam (axial separable)."""
    v = geom.vol
    zc = v.z_coords()[:, None]                       # (nz, 1)
    ve = geom.v_coords()[None, :]                    # (1, nv) pixel centers
    lo = np.maximum(zc - v.dz / 2, ve - geom.pixel_height / 2)
    hi = np.minimum(zc + v.dz / 2, ve + geom.pixel_height / 2)
    return (np.maximum(hi - lo, 0.0) / geom.pixel_height).astype(np.float32)


def _view_params(geom: CTGeometry) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split views into x-gathered / y-gathered groups and compute, per view,
    the coefficients of  uc(gi, li) = P*gi + Q*li + R  (detector coordinate of
    the voxel center at gathered-index gi, loop-index li) plus the SF
    trapezoid parameters (hs, hd, h)."""
    v = geom.vol
    ang = geom.angles_array()
    c, s = np.cos(ang), np.sin(ang)
    x0, y0 = float(v.x_coords()[0]), float(v.y_coords()[0])
    a = v.dx * np.abs(c)
    b = v.dx * np.abs(s)
    hs = 0.5 * (a + b)
    hd = 0.5 * np.abs(a - b)
    h = v.dx / np.maximum(np.abs(c), np.abs(s))
    gx = np.abs(s) >= np.abs(c)          # x-gathered group
    # x-gathered: gi = ix, li = iy:  uc = -s*dx*gi + c*dy*li + (c*y0 - s*x0)
    px = np.stack([-s * v.dx, c * v.dy, c * y0 - s * x0, hs, hd, h], -1)
    # y-gathered: gi = iy, li = ix:  uc =  c*dy*gi - s*dx*li + (c*y0 - s*x0)
    py = np.stack([c * v.dy, -s * v.dx, c * y0 - s * x0, hs, hd, h], -1)
    idx_x = np.nonzero(gx)[0]
    idx_y = np.nonzero(~gx)[0]
    return (px[idx_x].astype(np.float32), py[idx_y].astype(np.float32),
            np.concatenate([idx_x, idx_y]))


class _DeviceTables:
    """The plan's tables on one device."""

    def __init__(self, plan: "LanePlan", device: torch.device):
        self.tables = tuple(torch.from_numpy(t).to(device) for t in plan.tables)
        self.rows = tuple(torch.from_numpy(r).to(device) for r in plan.rows)
        self.fz = torch.from_numpy(plan.fz).to(device)


class LanePlan:
    """What a lane-packed pair (parallel here, fan in ``fp_fan.py``) derives
    from a geometry, once per cached op bundle: the two view groups' tables,
    the sinogram row of each group view, the axial overlap matrix, and their
    copies on each device they were used on.

    A subclass names its kernel library and kernels, the launch counts they
    add to, the extra launch arguments of its kernels, and :meth:`weights`,
    the plain version's footprint weights."""

    LIB = ""
    KERNELS: Tuple[str, str] = ("", "")
    launches: Dict[str, int] = {}

    def __init__(self, geom: CTGeometry, px: np.ndarray, py: np.ndarray,
                 order: np.ndarray):
        self.geom = geom
        self.tables = (px, py)
        nax = px.shape[0]
        self.rows = (order[:nax].astype(np.int32), order[nax:].astype(np.int32))
        self.fz = _z_overlap_matrix(geom)
        # Left edge of detector column 0 and the column pitch, as the f32
        # values the kernels receive.
        du = geom.pixel_width
        self.e0 = float(np.float32(float(geom.u_coords()[0]) - du / 2.0))
        self.du = float(np.float32(du))
        self.taps = geom.max_footprint_cols()
        self._on: Dict[str, _DeviceTables] = {}

    def on(self, device: torch.device) -> _DeviceTables:
        key = str(device)
        if key not in self._on:
            self._on[key] = _DeviceTables(self, device)
        return self._on[key]

    def group(self, grp: int, lanes: int) -> Tuple[int, int, int, int]:
        """(ng, nl, gather stride, loop stride) of view group ``grp`` (0: x-
        gathered, 1: y-gathered) in an (nx, ny, lanes) buffer."""
        nx, ny = self.geom.vol.nx, self.geom.vol.ny
        if grp == 0:
            return nx, ny, ny * lanes, lanes
        return ny, nx, lanes, ny * lanes

    def fp_args(self) -> tuple:
        """Launch arguments of the FP kernel after the column pitch."""
        return ()

    def bp_args(self) -> tuple:
        """Launch arguments of the BP kernel after the column pitch."""
        return ()

    def weights(self, table: torch.Tensor, ng: int, nl: int):
        raise NotImplementedError


class ParallelPlan(LanePlan):
    """The parallel SF pair's plan (tables of :func:`_view_params`)."""

    LIB = "fp_par"
    KERNELS = ("fp_par_sf", "bp_par_sf")
    launches = LAUNCHES

    def __init__(self, geom: CTGeometry):
        if geom.geom_type != "parallel":
            raise ValueError(f"the parallel SF pair needs a parallel "
                             f"geometry, got {geom.geom_type!r}")
        super().__init__(geom, *_view_params(geom))

    def weights(self, table: torch.Tensor, ng: int, nl: int):
        return _group_weights(self, table, ng, nl)


# --------------------------------------------------------------------------- #
# Plain versions of the kernels (CPU path and reference on the card)
# --------------------------------------------------------------------------- #
def _group_weights(plan: ParallelPlan, table: torch.Tensor, ng: int, nl: int):
    """For each footprint tap, the detector column (clamped into range) and
    SF weight (zero off the detector) of every (view, gi, li) in ``table``:
    yields ``(u, w)``, both (n_views, ng * nl)."""
    dev = table.device
    gi = torch.arange(ng, device=dev, dtype=torch.float32)[None, :, None]
    li = torch.arange(nl, device=dev, dtype=torch.float32)[None, None, :]
    P, Q, R, hs, hd, h = (table[:, k, None, None] for k in range(6))
    uc = (P * gi + Q * li + R).reshape(table.shape[0], ng * nl)
    P, Q, R, hs, hd, h = (t.reshape(-1, 1) for t in (P, Q, R, hs, hd, h))
    nu, e0, du = plan.geom.n_cols, plan.e0, plan.du
    u_first = torch.floor((uc - hs - e0) / du).to(torch.int64)
    for k in range(plan.taps):
        u = u_first + k
        el = e0 + u.to(torch.float32) * du
        w = trapezoid_pixel_weight(el, el + du, uc - hs, uc - hd, uc + hd,
                                   uc + hs, h)
        yield u.clamp(0, nu - 1), torch.where((u >= 0) & (u < nu), w, 0.0)


def _chunks(n_views: int, per_view: int):
    step = max(1, _CHUNK_ELEMS // max(per_view, 1))
    for a0 in range(0, n_views, step):
        yield a0, min(n_views, a0 + step)


def _fp_plain(g: torch.Tensor, plan: LanePlan,
              tile: torch.Tensor) -> torch.Tensor:
    """The one plain implementation of a lane-packed pair (parallel, fan),
    with the plan's weights: f32 volume (nx, ny, lanes) -> f32 sinogram
    (n_angles, n_cols, lanes), with the weights rounded to ``tile``'s dtype
    as the kernels round them.  Differentiable in ``g``."""
    lanes = g.shape[2]
    nu = plan.geom.n_cols
    dt = plan.on(g.device)
    out = g.new_zeros((plan.geom.n_angles * nu, lanes))
    for grp in (0, 1):
        ng, nl = plan.group(grp, lanes)[:2]
        table, rows = dt.tables[grp], dt.rows[grp].to(torch.int64)
        vox = (g if grp == 0 else g.transpose(0, 1)).reshape(ng * nl, lanes)
        for a0, a1 in _chunks(table.shape[0], ng * nl * lanes):
            base = (rows[a0:a1] * nu)[:, None]
            for u, w in plan.weights(table[a0:a1], ng, nl):
                w = precision.cast_like(w, tile)
                # index_put_ keeps only the index and the weights for the
                # backward (index_add_ would keep every product)
                out.index_put_(((base + u).reshape(-1),),
                               (w[:, :, None] * vox[None]).reshape(-1, lanes),
                               accumulate=True)
    return out.reshape(plan.geom.n_angles, nu, lanes)


def fp_lanes_plain(g: torch.Tensor, plan: LanePlan) -> torch.Tensor:
    """Plain version of the FP kernel: lane-packed volume (nx, ny, lanes),
    f32 or bf16 -> sinogram (n_angles, n_cols, lanes) f32."""
    return _fp_plain(g.to(torch.float32), plan, g)


def bp_lanes_plain(q: torch.Tensor, plan: LanePlan) -> torch.Tensor:
    """Plain version of the BP kernel: lane-packed sinogram (n_angles,
    n_cols, lanes), f32 or bf16 -> volume (nx, ny, lanes) f32.  It is the
    vector-Jacobian product of the plain FP, its exact transpose."""
    vol = plan.geom.vol
    g0 = torch.zeros((vol.nx, vol.ny, q.shape[2]), dtype=torch.float32,
                     device=q.device, requires_grad=True)
    with torch.enable_grad():
        (out,) = torch.autograd.grad(_fp_plain(g0, plan, q), g0,
                                     q.to(torch.float32))
    return out


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_tile(x: torch.Tensor, shape: Tuple[int, ...], what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: tiles must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tile must be contiguous")


def fp_lanes(g: torch.Tensor, plan: LanePlan,
             cfg: tune.KernelConfig) -> torch.Tensor:
    """FP at the kernel's interface: (nx, ny, lanes) -> (n_angles, n_cols,
    lanes) f32.  A CUDA tensor launches the plan's FP kernel (parallel or
    fan); a CPU tensor runs :func:`fp_lanes_plain`."""
    if g.device.type == "cpu":
        return fp_lanes_plain(g, plan)
    from repro_torch.kernels import build
    geom, kname = plan.geom, plan.KERNELS[0]
    lanes = g.shape[-1]
    _check_tile(g, (geom.vol.nx, geom.vol.ny, lanes), kname)
    out = torch.empty((geom.n_angles, geom.n_cols, lanes),
                      dtype=torch.float32, device=g.device)
    dt = plan.on(g.device)
    launch = getattr(build.library(plan.LIB), f"{kname}_launch")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        for grp in (0, 1):
            n = dt.tables[grp].shape[0]
            if n == 0:
                continue
            ng, nl, gs, ls = plan.group(grp, lanes)
            rc = launch(
                _DTYPE_CODE[g.dtype], dt.tables[grp].data_ptr(),
                dt.rows[grp].data_ptr(), n, g.data_ptr(), out.data_ptr(),
                ng, nl, lanes, gs, ls, geom.n_cols, plan.e0, plan.du,
                *plan.fp_args(), cfg.bu, cfg.lg, stream)
            build.check(plan.LIB, rc, f"{kname} launch")
            plan.launches[kname] += 1
    return out


def bp_lanes(q: torch.Tensor, plan: LanePlan,
             cfg: tune.KernelConfig) -> torch.Tensor:
    """BP at the kernel's interface: (n_angles, n_cols, lanes) -> (nx, ny,
    lanes) f32.  A CUDA tensor launches the plan's BP kernel; a CPU tensor
    runs :func:`bp_lanes_plain`."""
    if q.device.type == "cpu":
        return bp_lanes_plain(q, plan)
    from repro_torch.kernels import build
    geom, kname = plan.geom, plan.KERNELS[1]
    lanes = q.shape[-1]
    _check_tile(q, (geom.n_angles, geom.n_cols, lanes), kname)
    out = torch.empty((geom.vol.nx, geom.vol.ny, lanes), dtype=torch.float32,
                      device=q.device)
    dt = plan.on(q.device)
    launch = getattr(build.library(plan.LIB), f"{kname}_launch")
    accumulate = 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for grp in (0, 1):
            n = dt.tables[grp].shape[0]
            if n == 0:
                continue
            ng, nl, gs, ls = plan.group(grp, lanes)
            rc = launch(
                _DTYPE_CODE[q.dtype], dt.tables[grp].data_ptr(),
                dt.rows[grp].data_ptr(), n, q.data_ptr(), out.data_ptr(),
                ng, nl, lanes, gs, ls, geom.n_cols, plan.e0, plan.du,
                *plan.bp_args(), accumulate, cfg.bg, cfg.lg, stream)
            build.check(plan.LIB, rc, f"{kname} launch")
            plan.launches[kname] += 1
            accumulate = 1
    return out


# --------------------------------------------------------------------------- #
# Public entry points (3D or leading-batch 4D)
# --------------------------------------------------------------------------- #
def _batch(x: torch.Tensor, what: str) -> int:
    if x.dim() not in (3, 4):
        raise ValueError(f"expected a 3D or batched 4D {what}, got "
                         f"{tuple(x.shape)}")
    return x.shape[0] if x.dim() == 4 else 1


def fp_packed(f: torch.Tensor, plan: LanePlan, cdt: torch.dtype,
              run: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Lane packing around a lane-level FP ``run`` (kernel or plain): f
    (nx, ny, nz), or (batch, nx, ny, nz) -> sino (n_angles, n_rows, n_cols),
    or (batch, ...).  The axial overlap is one einsum; tiles are cast to
    ``cdt``; the result comes back in ``f.dtype``."""
    batch = _batch(f, "volume")
    geom = plan.geom
    fb = f if f.dim() == 4 else f[None]
    fz = plan.on(f.device).fz
    g = torch.einsum("bxyz,zv->xybv", fb.to(torch.float32), fz)
    g = precision.cast_in(g.reshape(geom.vol.nx, geom.vol.ny, -1), cdt)
    out = run(g.contiguous())                            # (na, nu, B*nv)
    out = out.reshape(geom.n_angles, geom.n_cols, batch, geom.n_rows)
    out = out.permute(2, 0, 3, 1).to(f.dtype).contiguous()
    return out if f.dim() == 4 else out[0]


def bp_packed(sino: torch.Tensor, plan: LanePlan, cdt: torch.dtype,
              run: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The transpose of :func:`fp_packed` around a lane-level BP ``run``:
    sino (n_angles, n_rows, n_cols), or (batch, ...) -> volume (nx, ny, nz),
    or (batch, ...)."""
    batch = _batch(sino, "sinogram")
    geom = plan.geom
    sb = sino if sino.dim() == 4 else sino[None]
    q = sb.permute(1, 3, 0, 2).reshape(geom.n_angles, geom.n_cols, -1)
    acc = run(precision.cast_in(q, cdt).contiguous())   # (nx, ny, B*nv)
    acc = acc.reshape(geom.vol.nx, geom.vol.ny, batch, geom.n_rows)
    out = torch.einsum("xybv,zv->bxyz", acc, plan.on(sino.device).fz)
    out = out.to(sino.dtype).contiguous()
    return out if sino.dim() == 4 else out[0]


def fp_parallel_sf(f: torch.Tensor, plan: ParallelPlan,
                   config: Optional[tune.KernelConfig] = None,
                   compute_dtype=None) -> torch.Tensor:
    """f: (nx, ny, nz) -> sino (n_angles, n_rows, n_cols), or lane-packed
    batched f: (batch, nx, ny, nz) -> (batch, n_angles, n_rows, n_cols).
    ``compute_dtype`` selects the tile dtype (None = follow ``f.dtype``);
    accumulation is f32 and the result comes back in ``f.dtype``."""
    cfg = tune.resolve_config(plan.geom, _batch(f, "volume"), config)
    return fp_packed(f, plan, precision.resolve(compute_dtype, f.dtype),
                     lambda g: fp_lanes(g, plan, cfg))


def bp_parallel_sf(sino: torch.Tensor, plan: ParallelPlan,
                   config: Optional[tune.KernelConfig] = None,
                   compute_dtype=None) -> torch.Tensor:
    """sino: (n_angles, n_rows, n_cols) -> volume (nx, ny, nz), or batched
    (batch, ...) -> (batch, nx, ny, nz).  Exact transpose of
    :func:`fp_parallel_sf`."""
    cfg = tune.resolve_config(plan.geom, _batch(sino, "sinogram"), config)
    return bp_packed(sino, plan, precision.resolve(compute_dtype, sino.dtype),
                     lambda q: bp_lanes(q, plan, cfg))


def register() -> None:
    from repro_torch.kernels import ops
    ops.register_kernel("parallel", "sf", ParallelPlan, fp_parallel_sf,
                        bp_parallel_sf, fp_batched=fp_parallel_sf,
                        bp_batched=bp_parallel_sf)
