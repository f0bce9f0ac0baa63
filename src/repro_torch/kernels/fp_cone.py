"""Exact cone-beam (flat detector) Separable-Footprint forward/back
projection pair, and the divergent-beam weight math it shares with the fan
pair (``fp_fan.py``).

CUDA tensors run the hand-written kernels of ``csrc/fp_cone.cu`` (which
replace the TPU kernels ``repro/kernels/fp_cone.py`` ``_fp_cone_kernel`` and
``_bp_cone_kernel``); CPU tensors run their plain PyTorch versions
(:func:`fp_batch_plain`, :func:`bp_batch_plain`), which evaluate the same
weights from the same per-view tables.  The plain BP is the VJP of the
plain FP, taken chunk by chunk, so the port has one plain implementation of
the pair.

**Weights.**  The transaxial footprint of a voxel is the trapezoid spanned
by the projections of its four corners (:func:`_corner_trapezoid`, the
float expressions of ``csrc/footprint.cuh`` ``sf_corner_trapezoid``); the
axial footprint is the rectangle ``[(z - dz/2), (z + dz/2)] * sdd / ell``
with ``ell`` the voxel centre's distance from the source along the central
ray, times the obliquity ``sqrt(1 + z^2 / rt2)``.  The axial magnification
depends on the voxel, so the batch and the detector rows cannot share one
lane axis as in the parallel and fan pairs: the kernels take the volume
``(batch, nx, ny, nz)`` and give the sinogram ``(batch, n_angles, n_rows,
n_cols)`` as they are.

**View groups.**  :func:`_view_params_cone` splits the views into an
x-gathered group (|sin| >= |cos|) and a y-gathered group and gives, per
view, 20 floats: the affines of the centre's (q, ell) in the voxel indices,
the corner offsets and the affines of the transaxial ray.  The tables are
bit-identical to the reference package's.

The FP kernel gives a block an output tile and walks the tile's voxels in
passes through shared memory; :func:`fp_layout` sizes the tile and the
buffers from the plan.  The BP kernel gives a thread 4 z slices of one
voxel, in warps of 32 neighbouring gathered voxels, and keeps each
slice's axial weights for a view; :func:`bp_layout` bounds the rows a
slice meets.  A curved-detector cone has no SF pair (as in the reference):
its plan raises, and ``model="joseph"`` projects it (``kernels/ref.py``).
Each kernel wrapper counts its launches in :data:`LAUNCHES`.

**The packed pair** (the reference's ``fp_cone_packed`` / ``bp_cone_packed``)
is the small-cone-angle approximation of the exact pair: the axial footprint
at the central magnification ``sdd / sod`` (:func:`_z_overlap_cone_packed`),
applied as one einsum outside the kernels, so that the batch and the
detector rows share one lane axis and the fan pair's entry points
(``fp_fan.fp_fan_sf`` / ``bp_fan_sf``, ``csrc/fp_fan.cu``) carry the
transaxial footprint on a ``fp_fan.ConePackedPlan``.  Its error against the
exact pair is bounded by :func:`cone_packed_error_bound`; ``mode="auto"``
takes it where ``tune.packed_cone_ok`` holds (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import precision, tune
from repro_torch.kernels.footprint import trapezoid_pixel_weight

_EPS = 1e-9

# Each plain-version step keeps its (batch x views x voxels x z) temporaries
# under this many elements.
_CHUNK_ELEMS = 1 << 25

# Kernel launches since the last reset_launches(), by kernel.  One call of a
# wrapper launches once per non-empty view group.
LAUNCHES: Dict[str, int] = {"fp_cone_sf": 0, "bp_cone_sf": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# Divergent-beam weight math (shared with fp_fan.py)
# --------------------------------------------------------------------------- #
def _mag_bounds(geom: CTGeometry) -> Tuple[float, float]:
    """(mag_min, mag_max) transaxial magnification over the volume disk."""
    r = geom.vol.radius
    mag_max = geom.sdd / max(geom.sod - r, 1e-3)
    mag_min = geom.sdd / (geom.sod + r)
    return mag_min, mag_max


def footprint_halfwidth(geom: CTGeometry) -> float:
    """A bound, in detector mm, on how far any corner of a voxel projects
    from its centre.  Every point of the volume lies within its radius r of
    the axis, so ell >= sod - r: on the curved detector du = sdd * d(angle)
    moves at most sdd / ell <= mag_max per mm; on the flat one du = sdd *
    d(q / ell) moves at most mag_max * sqrt(1 + (q / ell)^2) per mm, with
    |q| / ell <= r / (sod - r).  A corner lies dx * sqrt(2) / 2 from the
    centre."""
    _, mag_max = _mag_bounds(geom)
    hw = math.sqrt(2.0) / 2.0 * geom.vol.dx * mag_max
    if geom.detector_type != "curved":
        t = geom.vol.radius / max(geom.sod - geom.vol.radius, 1e-3)
        hw *= math.sqrt(1.0 + t * t)
    return hw


def _corner_trapezoid(P: torch.Tensor, gi: torch.Tensor, li: torch.Tensor,
                      sdd: float, dxv: float, curved: bool):
    """Corner-projection trapezoid of the voxels (gi, li) in the views of
    the 20-float rows ``P`` (n_views, 20); ``gi``, ``li`` broadcast against
    ``P[:, k]``-shaped columns.  Returns (t0, t1, t2, t3, h, rt2, ell): the
    sorted breakpoints, the plateau, the squared transaxial length of the
    ray through the centre and the centre's distance along the central ray.
    Each product and sum is its own rounding, as in the kernels."""
    col = [P[:, k].reshape((-1,) + (1,) * (gi.dim() - 1)) for k in range(20)]
    Aq, Bq, Cq, Al, Bl, Cl, Arx, Brx, Crx, Ary, Bry, Cry = col[:12]
    q0 = Bq * li + Cq
    l0 = Bl * li + Cl
    q = Aq * gi + q0
    ell = Al * gi + l0
    taus = []
    for k in range(4):
        qk = q + col[12 + 2 * k]
        lc = torch.clamp(ell + col[13 + 2 * k], min=_EPS)
        taus.append(sdd * torch.atan2(qk, lc) if curved else (sdd * qk) / lc)
    m1, M1 = torch.minimum(taus[0], taus[1]), torch.maximum(taus[0], taus[1])
    m2, M2 = torch.minimum(taus[2], taus[3]), torch.maximum(taus[2], taus[3])
    ta, tb = torch.maximum(m1, m2), torch.minimum(M1, M2)
    t0, t3 = torch.minimum(m1, m2), torch.maximum(M1, M2)
    t1, t2 = torch.minimum(ta, tb), torch.maximum(ta, tb)
    rx = (Arx * gi + Brx * li) + Crx
    ry = (Ary * gi + Bry * li) + Cry
    rt2 = rx * rx + ry * ry
    h = (dxv * torch.sqrt(rt2)) / torch.clamp(
        torch.maximum(torch.abs(rx), torch.abs(ry)), min=_EPS)
    return t0, t1, t2, t3, h, rt2, ell


def _view_params_cone(geom: CTGeometry) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Per-view affine coefficients of q(gi, li) and ell(gi, li) plus the
    four corner offsets (dq_k, dl_k) and the rx/ry affines, split into the
    x-gathered (|sin|>=|cos|) and y-gathered groups.

    Layout per view (20 floats):
      [Aq, Bq, Cq, Al, Bl, Cl, Arx, Brx, Crx, Ary, Bry, Cry,
       dq0, dl0, dq1, dl1, dq2, dl2, dq3, dl3]
    """
    v = geom.vol
    ang = geom.angles_array()
    c, s = np.cos(ang), np.sin(ang)
    x0, y0 = float(v.x_coords()[0]), float(v.y_coords()[0])
    sod = geom.sod
    hx, hy = v.dx / 2.0, v.dy / 2.0

    def grp(gathered_x: bool):
        if gathered_x:
            # gi -> x, li -> y
            Aq, Bq = -s * v.dx, c * v.dy
            Al, Bl = -c * v.dx, -s * v.dy
            Arx, Brx = v.dx * np.ones_like(c), np.zeros_like(c)
            Ary, Bry = np.zeros_like(c), v.dy * np.ones_like(c)
        else:
            Aq, Bq = c * v.dy, -s * v.dx
            Al, Bl = -s * v.dy, -c * v.dx
            Arx, Brx = np.zeros_like(c), v.dx * np.ones_like(c)
            Ary, Bry = v.dy * np.ones_like(c), np.zeros_like(c)
        Cq = c * y0 - s * x0
        Cl = sod - (c * x0 + s * y0)
        Crx = x0 - sod * c
        Cry = y0 - sod * s
        cols = [Aq, Bq, Cq, Al, Bl, Cl, Arx, Brx, Crx, Ary, Bry, Cry]
        for sx in (-hx, hx):
            for sy in (-hy, hy):
                cols.append(c * sy - s * sx)            # dq
                cols.append(-(c * sx + s * sy))         # dl
        return np.stack(cols, -1).astype(np.float32)

    gx = np.abs(s) >= np.abs(c)
    px, py = grp(True), grp(False)
    idx_x = np.nonzero(gx)[0]
    idx_y = np.nonzero(~gx)[0]
    return px[idx_x], py[idx_y], np.concatenate([idx_x, idx_y])


# --------------------------------------------------------------------------- #
# Plan
# --------------------------------------------------------------------------- #
class _DeviceTables:
    """The plan's tables on one device."""

    def __init__(self, plan: "ConePlan", device: torch.device):
        self.tables = tuple(torch.from_numpy(t).to(device) for t in plan.tables)
        self.rows = tuple(torch.from_numpy(r).to(device) for r in plan.rows)


def _f32(x: float) -> float:
    return float(np.float32(x))


class ConePlan:
    """What the exact cone pair derives from a geometry, once per cached op
    bundle: the two view groups' 20-float tables, the sinogram row of each
    group view, the detector and volume grids as the f32 values the kernels
    receive, and the tables' copies on each device they were used on."""

    def __init__(self, geom: CTGeometry):
        if geom.geom_type != "cone":
            raise ValueError(f"the cone SF pair needs a cone geometry, got "
                             f"{geom.geom_type!r}")
        if geom.detector_type != "flat":
            raise NotImplementedError("SF cone supports flat detectors; "
                                      "use model='joseph' for curved")
        px, py, order = _view_params_cone(geom)
        self._set(geom, px, py, order, geom.sdd)
        self.mag_bounds = _mag_bounds(geom)
        self.hw = _f32(footprint_halfwidth(geom))
        self.taps_u = geom.max_footprint_cols()
        self.taps_v = geom.max_footprint_rows()

    def _set(self, geom: CTGeometry, px: np.ndarray, py: np.ndarray,
             order: np.ndarray, sdd: float) -> None:
        """The fields common to the cone and modular plans."""
        self.geom = geom
        self.tables = (px, py)
        nax = px.shape[0]
        self.rows = (order[:nax].astype(np.int32), order[nax:].astype(np.int32))
        v = geom.vol
        du, dv = geom.pixel_width, geom.pixel_height
        self.e0 = _f32(float(geom.u_coords()[0]) - du / 2.0)
        self.du = _f32(du)
        self.ev0 = _f32(float(geom.v_coords()[0]) - dv / 2.0)
        self.dv = _f32(dv)
        self.z0 = float(v.z_coords()[0])
        self.dz = _f32(v.dz)
        self.sdd = _f32(sdd)
        self.dxv = _f32(v.dx)
        self._on: Dict[str, _DeviceTables] = {}
        self._layouts: Dict[int, "FpLayout"] = {}
        self._bp_layout: Optional["BpLayout"] = None

    def axial(self, table: torch.Tensor, ell: torch.Tensor, rt2: torch.Tensor,
              zt: torch.Tensor):
        """The axial extents [vlo, vhi] (detector mm) of the slices at
        heights ``zt`` (nzc,) and their obliquities, for voxels at central-ray
        distance ``ell`` and squared transaxial ray length ``rt2`` (nvw, N,
        1) in the views of ``table``: (vlo, vhi, obl), each (nvw, N, nzc)."""
        hdz = self.dz / 2.0
        # a tensor numerator: scalar / tensor would multiply by a reciprocal
        mag = ell.new_full((), self.sdd) / torch.clamp(ell, min=_EPS)
        obl = torch.sqrt(1.0 + (zt * zt) / torch.clamp(rt2, min=_EPS))
        return (zt - hdz) * mag, (zt + hdz) * mag, obl

    def on(self, device: torch.device) -> _DeviceTables:
        key = str(device)
        if key not in self._on:
            self._on[key] = _DeviceTables(self, device)
        return self._on[key]

    def group(self, grp: int) -> Tuple[int, int, int, int]:
        """(ng, nl, gather stride, loop stride) of view group ``grp`` (0: x-
        gathered, 1: y-gathered) in an (nx, ny, nz) volume."""
        nx, ny, nz = self.geom.vol.shape
        if grp == 0:
            return nx, ny, ny * nz, nz
        return ny, nx, nz, ny * nz


# --------------------------------------------------------------------------- #
# Plain versions of the kernels (CPU path and reference on the card)
# --------------------------------------------------------------------------- #
def chunk_taps(plan: ConePlan, table: torch.Tensor, ng: int, nl: int,
               z0: int, nzc: int, tile: torch.Tensor):
    """The cone pair's weights for the voxels of one view group in z slices
    ``z0 .. z0 + nzc`` and the views of ``table`` (nvw, 20), one footprint
    tap (detector column x row) at a time — or, given a
    :class:`~repro_torch.kernels.fp_modular.ModularPlan` and its (nvw, 24)
    rows, the modular pair's, whose axial map ``plan.axial`` reads the
    per-view frame: yields ``(pix, wu, wz)`` with
    ``pix`` (nvw, ng * nl, nzc) the pixel ``v * n_cols + u`` within its view
    (clamped into range), ``wu`` (nvw, ng * nl, 1) the transaxial weight
    and ``wz`` (nvw, ng * nl, nzc) the axial weight (zero off the
    detector), rounded to ``tile``'s dtype as the kernels round it.  The
    voxel's weight at ``pix`` is ``wu * wz``."""
    geom = plan.geom
    nu, nv = geom.n_cols, geom.n_rows
    nvw = table.shape[0]
    dev = table.device
    gi = torch.arange(ng, device=dev, dtype=torch.float32)[None, :, None]
    li = torch.arange(nl, device=dev, dtype=torch.float32)[None, None, :]
    t0, t1, t2, t3, h, rt2, ell = (
        t.reshape(nvw, ng * nl, 1) for t in _corner_trapezoid(
            table, gi, li, plan.sdd, plan.dxv, False))
    k = torch.arange(z0, z0 + nzc, device=dev, dtype=torch.float32)
    zt = plan.z0 + k * plan.dz                              # (nzc,)
    vlo, vhi, obl = plan.axial(table, ell, rt2, zt)         # (nvw, N, nzc)
    v_first = torch.floor((vlo - plan.ev0) / plan.dv).to(torch.int64)
    u_first = torch.floor((t0 - plan.e0) / plan.du).to(torch.int64)
    for ku in range(plan.taps_u):
        u = u_first + ku                                    # (nvw, N, 1)
        el = plan.e0 + u.to(torch.float32) * plan.du
        wu = trapezoid_pixel_weight(el, el + plan.du, t0, t1, t2, t3, h)
        wu = torch.where((u >= 0) & (u < nu), wu, 0.0)
        uc = u.clamp(0, nu - 1)
        for kv in range(plan.taps_v):
            v = v_first + kv                                # (nvw, N, nzc)
            elv = plan.ev0 + v.to(torch.float32) * plan.dv
            ov = torch.clamp(torch.minimum(vhi, elv + plan.dv)
                             - torch.maximum(vlo, elv), min=0.0) / plan.dv
            wz = precision.cast_like(ov * obl, tile)
            wz = torch.where((v >= 0) & (v < nv), wz, 0.0)
            yield v.clamp(0, nv - 1) * nu + uc, wu, wz


def _fp_chunk(vox: torch.Tensor, plan: ConePlan, table: torch.Tensor,
              ng: int, nl: int, z0: int, tile: torch.Tensor) -> torch.Tensor:
    """The cone FP of volume slab ``vox`` (batch, ng * nl, nzc) — z slices
    ``z0 .. z0 + nzc`` of one view group, gathered-index major — in the
    views of ``table`` (nvw, 20): a (batch, nvw, n_rows, n_cols) f32
    sinogram.  Linear and differentiable in ``vox``."""
    geom = plan.geom
    nu, nv = geom.n_cols, geom.n_rows
    batch, _, nzc = vox.shape
    nvw = table.shape[0]
    view = torch.arange(batch * nvw, device=vox.device).reshape(batch, nvw, 1, 1)
    out = vox.new_zeros(batch * nvw * nv * nu)
    for pix, wu, wz in chunk_taps(plan, table, ng, nl, z0, nzc, tile):
        val = wu * (wz * vox[:, None])                      # (B, nvw, N, nzc)
        # index_put_ keeps only the index and the weights for the backward
        out.index_put_(((view * (nv * nu) + pix).reshape(-1),),
                       val.reshape(-1), accumulate=True)
    return out.reshape(batch, nvw, nv, nu)


def _chunks(plan: ConePlan, batch: int, n_views: int, n_vox: int):
    """(a0, a1, z0, z1) steps whose temporaries stay under _CHUNK_ELEMS."""
    nz = plan.geom.vol.nz
    zstep = max(1, min(nz, _CHUNK_ELEMS // max(batch * n_vox, 1)))
    astep = max(1, _CHUNK_ELEMS // max(batch * n_vox * zstep, 1))
    for a0 in range(0, n_views, astep):
        for z0 in range(0, nz, zstep):
            yield a0, min(n_views, a0 + astep), z0, min(nz, z0 + zstep)


def _group_volume(f: torch.Tensor, grp: int) -> torch.Tensor:
    """(batch, nx, ny, nz) -> the group's (batch, ng * nl, nz) voxel rows."""
    g = f if grp == 0 else f.transpose(1, 2)
    return g.reshape(f.shape[0], -1, f.shape[3])


def fp_batch_plain(f: torch.Tensor, plan: ConePlan) -> torch.Tensor:
    """Plain version of the FP kernel: volume (batch, nx, ny, nz), f32 or
    bf16 -> sinogram (batch, n_angles, n_rows, n_cols) f32."""
    geom = plan.geom
    dt = plan.on(f.device)
    f32 = f.to(torch.float32)
    out = f32.new_zeros((f.shape[0],) + geom.sino_shape)
    for grp in (0, 1):
        ng, nl = plan.group(grp)[:2]
        table, rows = dt.tables[grp], dt.rows[grp].to(torch.int64)
        vox = _group_volume(f32, grp)
        for a0, a1, z0, z1 in _chunks(plan, f.shape[0], table.shape[0], ng * nl):
            out.index_add_(1, rows[a0:a1], _fp_chunk(
                vox[:, :, z0:z1], plan, table[a0:a1], ng, nl, z0, f))
    return out


def bp_batch_plain(q: torch.Tensor, plan: ConePlan) -> torch.Tensor:
    """Plain version of the BP kernel: sinogram (batch, n_angles, n_rows,
    n_cols), f32 or bf16 -> volume (batch, nx, ny, nz) f32.  The FP is a sum
    of the :func:`_fp_chunk` terms; this is the sum of their vector-Jacobian
    products, the exact transpose, taken one term at a time so that
    autograd never holds more than one term's graph."""
    geom = plan.geom
    dt = plan.on(q.device)
    q32 = q.to(torch.float32)
    batch = q.shape[0]
    nx, ny, nz = geom.vol.shape
    out = q32.new_zeros((batch, nx, ny, nz))
    for grp in (0, 1):
        ng, nl = plan.group(grp)[:2]
        table, rows = dt.tables[grp], dt.rows[grp].to(torch.int64)
        acc = q32.new_zeros((batch, ng * nl, nz))
        for a0, a1, z0, z1 in _chunks(plan, batch, table.shape[0], ng * nl):
            g0 = q32.new_zeros((batch, ng * nl, z1 - z0), requires_grad=True)
            with torch.enable_grad():
                term = _fp_chunk(g0, plan, table[a0:a1], ng, nl, z0, q)
                (grad,) = torch.autograd.grad(term, g0, q32[:, rows[a0:a1]])
            acc[:, :, z0:z1] += grad
        acc = acc.reshape(batch, ng, nl, nz)
        out += acc if grp == 0 else acc.transpose(1, 2)
    return out


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def samples_per_thread(batch: int) -> int:
    """Samples of the batch each cone-family kernel thread carries: all of a
    batch of up to 8 share each weight; batch 1 runs the single-sample
    instance (``csrc/cone_sf.cuh``)."""
    return 8 if batch > 1 else 1


# The FP's block (csrc/cone_sf.cuh SF_FP_THREADS, SF_FP_COLS): threads, and
# detector columns each thread owns in its row.
FP_THREADS = 256
FP_COLS = 4
# Rows of an FP tile at most (one warp of rows per column run).
FP_MAX_ROWS = 32
# FP blocks an SM by samples a block (csrc/cone_sf.cuh SfFpBlocks), and the
# dynamic shared memory each may take so that they fit the H100's 227 KB.
FP_BLOCKS = {1: 3, 8: 2}
FP_SMEM_BUDGET = {1: 72 * 1024, 8: 100 * 1024}
# Row pitches (mm) for which the FP's division by the pitch (csrc/cone_sf.cuh
# ``sf_div_rn``) is proven to round as an IEEE division.
FP_DV_RANGE = (2.0 ** -20, 2.0 ** 20)


@dataclasses.dataclass(frozen=True)
class FpLayout:
    """The FP kernel's tile and shared buffers for one plan and instance
    (:func:`fp_layout`).  ``tv`` x ``tu``: the tile's rows and columns;
    ``ncap``: the columns a voxel's footprint can meet in a tile;
    ``nslice``: the slices of a voxel that can meet a tile's rows;
    ``window``: the voxels of a tile's gather window (the whole line at the
    pole of the gather map); ``smax``, ``emax``: a pass's survivors and
    (survivor, slice) pairs; ``passes``: whether a window can need more
    than one pass; ``smem_bytes``: the block's dynamic shared memory."""
    tv: int
    tu: int
    ncap: int
    nslice: int
    window: int
    smax: int
    emax: int
    passes: bool
    smem_bytes: int


def _fp_smem_words(tv: int, ncap: int, smax: int, emax: int,
                   spt: int) -> int:
    """The FP's shared memory in 4-byte words at a layout, as
    csrc/cone_sf.cuh ``sf_fp_smem_words`` counts it; the first launch of
    each layout on a card checks the two agree (:func:`fp_info`)."""
    nrc = (ncap + 2 * FP_COLS - 2) // FP_COLS
    return (smax * (15 + nrc * FP_COLS) + emax * (3 + spt)
            + 3 * 32 + 2 + (FP_THREADS // tv) * ((smax + 31) // 32)
            + 3 * (FP_THREADS // 32) + 4 + (emax + 3) // 4)


def fp_layout(plan: ConePlan, spt: int) -> FpLayout:
    """Size the FP kernel's tile and shared buffers for ``plan`` (cone or
    modular) and ``spt`` samples per block.  Bounds, each from the plan:

    * a voxel's footprint is at most 2 hw wide, so its pixel range with the
      kernel's margin of one column each side spans at most ceil(2 hw / du)
      + 3 columns;
    * a tile's rows span tv dv of the detector, which a voxel's slices of
      height dz cover at |mag| >= mag_min: its z range, with the kernel's
      margins, holds at most floor(tv dv / (mag_min dz)) + 6 slices;
    * a window holds at most the whole gathered line (ng voxels).

    The buffers take as many survivors a pass as fit FP_SMEM_BUDGET[spt]
    (up to 128: the kernel names a pair's survivor in a byte), and never
    fewer (survivor, slice) pairs than one voxel's nz (so that any one
    voxel fits an empty pass).  Raises when even that does not fit, and for
    a row pitch outside [2^-20, 2^20] (FP_DV_RANGE), where the kernel's
    exact division is not proven."""
    if spt in plan._layouts:
        return plan._layouts[spt]
    if not FP_DV_RANGE[0] <= plan.dv <= FP_DV_RANGE[1]:
        raise ValueError(
            f"the cone-family FP kernel divides by the row pitch exactly "
            f"for pitches in {FP_DV_RANGE} mm, got {plan.dv}")
    geom = plan.geom
    nz, nv = geom.vol.nz, geom.n_rows
    tv = min(nv, FP_MAX_ROWS)
    tu = (FP_THREADS // tv) * FP_COLS
    ncap = min(tu, math.ceil(2.0 * plan.hw / plan.du + 1e-3) + 3)
    nslice = min(nz, math.floor(tv * plan.dv / (plan.mag_bounds[0] * plan.dz)
                                + 1e-3) + 6)
    window = max(plan.group(0)[0], plan.group(1)[0])
    for smax in (128, 96, 64, 48, 32, 24, 16, 12, 8, 4, 2, 1):
        emax = max(nz, smax * nslice)
        words = _fp_smem_words(tv, ncap, smax, emax, spt)
        if 4 * words <= FP_SMEM_BUDGET[spt]:
            break
    else:
        raise ValueError(
            f"the cone-family FP kernel cannot hold one voxel's {nz} slices "
            f"in {FP_SMEM_BUDGET[spt]} bytes of shared memory ({4 * words} "
            f"needed at {spt} samples a block)")
    out = FpLayout(tv, tu, ncap, nslice, window, smax, emax, window > smax,
                   4 * words)
    plan._layouts[spt] = out
    return out


# The BP's block (csrc/cone_sf.cuh SF_THREADS): warps of 32 gathered voxels,
# one li line each; the axial weights a slice keeps a view (SF_BP_ROWS); z
# slices a thread (SF_BP_ZPT); blocks an SM by samples a thread (SfBpBlocks).
BP_THREADS = 128
BP_ROWS = 4
BP_ZPT = 4
BP_BLOCKS = {1: 5, 8: 4}


@dataclasses.dataclass(frozen=True)
class BpLayout:
    """The BP kernel's bound for one plan (:func:`bp_layout`): ``rows``, the
    detector rows one slice's extent can meet with a positive overlap."""
    rows: int

    @property
    def cached(self) -> bool:
        """Whether the kernel keeps each slice's axial weights, formed once
        a view (``rows <= BP_ROWS``), or forms each in its column loop."""
        return self.rows <= BP_ROWS


def bp_layout(plan: ConePlan) -> BpLayout:
    """Bound the rows a slice meets, for the BP kernel on ``plan`` (cone or
    modular): a slice of height dz lands on the detector at |mag| <=
    mag_max, an interval at most dz mag_max long, which meets at most
    floor(dz mag_max / dv) + 2 rows of pitch dv.  Neither the block nor a
    buffer depends on it, so no geometry is refused for it: past BP_ROWS
    the kernel forms each axial weight in its column loop instead of
    keeping it (and a slice past the bound writes NaN).  Raises for a row
    pitch outside FP_DV_RANGE, where the kernels' exact division is not
    proven."""
    if plan._bp_layout is not None:
        return plan._bp_layout
    if not FP_DV_RANGE[0] <= plan.dv <= FP_DV_RANGE[1]:
        raise ValueError(
            f"the cone-family BP kernel divides by the row pitch exactly "
            f"for pitches in {FP_DV_RANGE} mm, got {plan.dv}")
    plan._bp_layout = BpLayout(min(plan.geom.n_rows, math.floor(
        plan.dz * plan.mag_bounds[1] / plan.dv + 1e-3) + 2))
    return plan._bp_layout


def bp_info(lib_name: str, dtype: torch.dtype, spt: int) -> Dict[str, int]:
    """The BP kernel instance of library ``lib_name`` (the cone or the
    modular pair) for ``dtype`` tiles and ``spt`` samples a thread, on this
    card: its block (threads), z slices a thread and resident blocks per SM
    (its shared memory is static)."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.fp_par import _DTYPE_CODE
    fam = lib_name.split("_")[1]
    blocks = ctypes.c_int(0)
    info = getattr(build.library(lib_name), f"bp_{fam}_sf_info")
    build.check(lib_name, info(_DTYPE_CODE[dtype], spt, ctypes.byref(blocks)),
                f"bp_{fam}_sf info")
    return {"threads": BP_THREADS, "z_slices_a_thread": BP_ZPT,
            "blocks_per_sm": blocks.value}


def fp_info(lib_name: str, plan: ConePlan, dtype: torch.dtype,
            spt: int) -> Dict[str, int]:
    """The FP kernel instance of library ``lib_name`` (the cone or the
    modular pair) for ``dtype`` tiles and ``spt`` samples a block, on this
    card, at ``plan``'s :func:`fp_layout`: its tile (rows, columns), dynamic
    shared memory a block (bytes, as the kernel counts it) and resident
    blocks per SM.  Raises when the kernel's count of its shared memory is
    not the host's (``_fp_smem_words``)."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.fp_par import _DTYPE_CODE
    lay = fp_layout(plan, spt)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    info = getattr(build.library(lib_name), f"{lib_name}_sf_info")
    build.check(lib_name, info(_DTYPE_CODE[dtype], spt, lay.tv, lay.ncap,
                               lay.smax, lay.emax, ctypes.byref(smem),
                               ctypes.byref(blocks)), f"{lib_name}_sf info")
    if smem.value != lay.smem_bytes:
        raise RuntimeError(
            f"{lib_name}_sf carves {smem.value} bytes of shared memory from "
            f"the layout {lay}, the host counted {lay.smem_bytes}: "
            f"csrc/cone_sf.cuh sf_fp_smem_words and fp_cone._fp_smem_words "
            f"disagree")
    return {"tile_rows": lay.tv, "tile_cols": lay.tu,
            "smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def division_mismatches(dv: float) -> int:
    """How many floats ov in [dv 2^-126, 2 dv] (every overlap whose quotient
    is a normal float) the FP kernel's division ``sf_div_rn`` divides by the
    row pitch ``dv`` to other bits than ``__fdiv_rn`` does, on the card
    (``fp_cone_div_check``); 0 is the claim."""
    from repro_torch.kernels import build
    dv = np.float32(dv)
    low = float(dv) * 2.0 ** -126
    lo = np.float32(low)
    if float(lo) < low:
        lo = np.nextafter(lo, np.float32(np.inf))
    bits = np.array([lo, 2 * dv], dtype=np.float32).view(np.uint32)
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    build.check("fp_cone", build.library("fp_cone").fp_cone_div_check(
        float(dv), int(bits[0]), int(bits[1]) + 1, bad.data_ptr(), stream),
        "fp_cone_div_check")
    return int(bad.item())


# (library, dtype, samples a block, layout) whose shared memory count the
# kernel has confirmed (fp_info), each once a process.
_CHECKED: set = set()


def launch(lib_name: str, kname: str, x: torch.Tensor, plan: ConePlan,
           counts: Dict[str, int], spt: Optional[int] = None,
           variant: str = "") -> torch.Tensor:
    """Launch the cone-family kernel ``kname`` of library ``lib_name`` (the
    cone or the modular pair) once per non-empty view group on the CUDA
    tensor ``x``, adding one to ``counts[kname]`` per launch.  The FP's last
    arguments are the footprint half-width bound and its :func:`fp_layout`;
    the BP's say whether to add into the output (the second group) or
    overwrite it, and give its :func:`bp_layout` row bound.  ``spt``
    (samples per thread, 1 or 8) defaults to :func:`samples_per_thread`;
    ``variant`` names a build of the library (``build.VARIANTS``: the phase
    profiles)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fp_par import _DTYPE_CODE, _check_tile
    geom = plan.geom
    batch = x.shape[0]
    fp = kname.startswith("fp_")
    in_shape, out_shape = ((geom.vol.shape, geom.sino_shape) if fp
                           else (geom.sino_shape, geom.vol.shape))
    _check_tile(x, (batch,) + in_shape, kname)
    out = torch.empty((batch,) + out_shape, dtype=torch.float32, device=x.device)
    dt = plan.on(x.device)
    run = getattr(build.library(lib_name, variant), f"{kname}_launch")
    spt = samples_per_thread(batch) if spt is None else spt
    if fp:
        lay = fp_layout(plan, spt)
        tail = (plan.hw, lay.tv, lay.ncap, lay.smax, lay.emax)
        if (lib_name, x.dtype, spt, lay) not in _CHECKED:
            fp_info(lib_name, plan, x.dtype, spt)
            _CHECKED.add((lib_name, x.dtype, spt, lay))
    else:
        bp_rows = bp_layout(plan).rows
    accumulate = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for grp in (0, 1):
            n = dt.tables[grp].shape[0]
            if n == 0:
                continue
            ng, nl, gs, ls = plan.group(grp)
            rc = run(
                _DTYPE_CODE[x.dtype], spt, dt.tables[grp].data_ptr(),
                dt.rows[grp].data_ptr(), n, geom.n_angles, batch,
                x.data_ptr(), out.data_ptr(), ng, nl, geom.vol.nz, gs, ls,
                geom.n_cols, geom.n_rows, plan.e0, plan.du, plan.ev0, plan.dv,
                plan.z0, plan.dz, plan.sdd, plan.dxv,
                *(tail if fp else (accumulate, bp_rows)), stream)
            build.check(lib_name, rc, f"{kname} launch")
            counts[kname] += 1
            accumulate = 1
    return out


def fp_batch(f: torch.Tensor, plan: ConePlan) -> torch.Tensor:
    """FP at the kernel's interface: (batch, nx, ny, nz) -> (batch, n_angles,
    n_rows, n_cols) f32.  A CUDA tensor launches the kernel (its launch
    derives the block from the shapes); a CPU tensor runs
    :func:`fp_batch_plain`."""
    if f.device.type == "cpu":
        return fp_batch_plain(f, plan)
    return launch("fp_cone", "fp_cone_sf", f, plan, LAUNCHES)


def bp_batch(q: torch.Tensor, plan: ConePlan) -> torch.Tensor:
    """BP at the kernel's interface: (batch, n_angles, n_rows, n_cols) ->
    (batch, nx, ny, nz) f32.  A CUDA tensor launches the kernel (the second
    view group adds into the first's output); a CPU tensor runs
    :func:`bp_batch_plain`."""
    if q.device.type == "cpu":
        return bp_batch_plain(q, plan)
    return launch("fp_cone", "bp_cone_sf", q, plan, LAUNCHES)


# --------------------------------------------------------------------------- #
# Public entry points (3D or leading-batch 4D)
# --------------------------------------------------------------------------- #
def _as_batch(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() not in (3, 4):
        raise ValueError(f"expected a 3D or batched 4D {what}, got "
                         f"{tuple(x.shape)}")
    return x if x.dim() == 4 else x[None]


def fp_unpacked(f: torch.Tensor, plan: ConePlan, cdt: torch.dtype,
                run: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Around a batch-level FP ``run`` (kernel or plain): f (nx, ny, nz), or
    (batch, nx, ny, nz) -> sino (n_angles, n_rows, n_cols), or (batch, ...).
    The volume is cast to ``cdt``; the result comes back in ``f.dtype``."""
    fb = _as_batch(f, "volume")
    out = run(precision.cast_in(fb, cdt).contiguous()).to(f.dtype)
    return out if f.dim() == 4 else out[0]


def bp_unpacked(sino: torch.Tensor, plan: ConePlan, cdt: torch.dtype,
                run: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The transpose of :func:`fp_unpacked` around a batch-level BP."""
    qb = _as_batch(sino, "sinogram")
    out = run(precision.cast_in(qb, cdt).contiguous()).to(sino.dtype)
    return out if sino.dim() == 4 else out[0]


def fp_cone_sf(f: torch.Tensor, plan: ConePlan,
               config: Optional[tune.KernelConfig] = None,
               compute_dtype=None) -> torch.Tensor:
    """f: (nx, ny, nz) -> sino (n_angles, n_rows, n_cols), or batched f:
    (batch, nx, ny, nz) -> (batch, n_angles, n_rows, n_cols).
    ``compute_dtype`` selects the volume's dtype in the kernel (None =
    follow ``f.dtype``); accumulation is f32 and the result comes back in
    ``f.dtype``.  ``config`` holds the lane-packed kernels' block shapes and
    is not read here: the cone launch derives its block from the shapes."""
    return fp_unpacked(f, plan, precision.resolve(compute_dtype, f.dtype),
                       lambda x: fp_batch(x, plan))


def bp_cone_sf(sino: torch.Tensor, plan: ConePlan,
               config: Optional[tune.KernelConfig] = None,
               compute_dtype=None) -> torch.Tensor:
    """sino: (n_angles, n_rows, n_cols) -> volume (nx, ny, nz), or batched
    (batch, ...) -> (batch, nx, ny, nz).  Exact transpose of
    :func:`fp_cone_sf` (``config`` is not read, as there)."""
    return bp_unpacked(sino, plan, precision.resolve(compute_dtype, sino.dtype),
                       lambda q: bp_batch(q, plan))


# --------------------------------------------------------------------------- #
# Packed (lane-packed) cone pair: small-cone-angle axial pre-resample
# --------------------------------------------------------------------------- #
def _z_overlap_cone_packed(geom: CTGeometry) -> np.ndarray:
    """(nz, nv) axial pre-resample matrix at the *central* magnification.

    The exact pair resamples each volume z-line onto detector rows at the
    voxel's own magnification ``sdd/ell``, which keeps the batch and the rows
    off one lane axis.  The packed approximation freezes the magnification
    at its rotation-axis value ``mag0 = sdd/sod`` (and the axial obliquity
    at the central ray's ``sqrt(1 + z^2/sod^2)``): the z -> row map becomes
    one (nz, nv) rectangle-overlap matrix applied outside the kernels, as
    the parallel and fan pairs' axial separation, and what remains is the
    fan pair's transaxial footprint.  A z-plane at height ``z`` lands
    ``z * (sdd/ell - mag0)`` mm from its exact row
    (:func:`cone_packed_row_shift`).  Float64, as the reference."""
    v = geom.vol
    mag0 = geom.sdd / geom.sod
    dv = geom.pixel_height
    zc = v.z_coords().astype(np.float64)[:, None]            # (nz, 1)
    ve = geom.v_coords().astype(np.float64)[None, :]         # (1, nv)
    vlo = (zc - v.dz / 2.0) * mag0
    vhi = (zc + v.dz / 2.0) * mag0
    ov = np.maximum(np.minimum(vhi, ve + dv / 2.0)
                    - np.maximum(vlo, ve - dv / 2.0), 0.0) / dv
    obl = np.sqrt(1.0 + (zc / geom.sod) ** 2)                # central ray
    return (ov * obl).astype(np.float32)


def _z_edge_extent(geom: CTGeometry) -> float:
    """|z| of the outermost voxel *edge* (mm): the worst-case height."""
    v = geom.vol
    return v.nz * v.dz / 2.0 + abs(v.offset_z)


def half_cone_tangent(geom: CTGeometry) -> float:
    """tan of the half-cone angle the volume's z extent subtends at the
    source (``z_max / sod``, the small parameter of the approximation)."""
    return _z_edge_extent(geom) / geom.sod


def cone_packed_row_shift(geom: CTGeometry) -> float:
    """Worst-case axial footprint displacement of the packed approximation,
    in detector rows: over the volume disk ``ell`` ranges in [sod - R,
    sod + R], so a footprint edge at height ``z`` moves by at most
    ``z_max * max(sdd/(sod-R) - mag0, mag0 - sdd/(sod+R))`` mm on the
    detector (first order in the cone angle; zero in the fan limit)."""
    r = geom.vol.radius
    mag0 = geom.sdd / geom.sod
    dmag = max(geom.sdd / max(geom.sod - r, 1e-3) - mag0,
               mag0 - geom.sdd / (geom.sod + r))
    return _z_edge_extent(geom) * dmag / geom.pixel_height


def cone_packed_error_bound(geom: CTGeometry) -> float:
    """Bound on the relative L2 sinogram error of the packed pair against
    the exact cone pair: twice the row shift (the normalized rectangle
    overlaps are 2-Lipschitz in it) plus the obliquity's second-order term
    ``0.5 tan(theta_half)^2 ((sod/(sod-R))^2 - 1)``."""
    r = geom.vol.radius
    s = cone_packed_row_shift(geom)
    t = half_cone_tangent(geom)
    obl = 0.5 * (t ** 2) * ((geom.sod / max(geom.sod - r, 1e-3)) ** 2 - 1.0)
    return 2.0 * s + obl


def register() -> None:
    from repro_torch.kernels import fp_fan, ops
    ops.register_kernel("cone", "sf", ConePlan, fp_cone_sf, bp_cone_sf,
                        fp_batched=fp_cone_sf, bp_batched=bp_cone_sf,
                        packed_plan=fp_fan.ConePackedPlan,
                        fp_packed=fp_fan.fp_fan_sf, bp_packed=fp_fan.bp_fan_sf,
                        packed_ok=tune.packed_cone_ok)
