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
the plan's module, here :data:`LAUNCHES`, and takes the launch arguments
after the column pitch from the plan (:meth:`LanePlan.fp_tail`,
:meth:`LanePlan.bp_tail`).

**The parallel kernels' layouts** (:meth:`ParallelPlan.fp_layout`,
:meth:`ParallelPlan.bp_layout`) are derived here from the view tables and
the :class:`~repro_torch.kernels.tune.KernelConfig`: the FP's tile of
``bu`` columns and ``8 lg`` lanes (8 or 16 a thread), the loop lines of a chunk, the staged
window's capacity and the weights a (line, column) pair can have; the
BP's block of ``bg`` voxels and the columns a (voxel, view) can meet.
The bounds are proven from the tables (:meth:`ParallelPlan.fp_kw`,
:meth:`~ParallelPlan.fp_wcap`, :meth:`~ParallelPlan.bp_ku`), and
:func:`_tile_window` is the host's copy of the kernel's staged window, so
the CPU tests hold both against the plain version's nonzero weights.  The
FP's shared memory is counted here to choose the layout, the BP's to fit
its block (:func:`bp_fit`: a wide footprint takes whole warps off it), and
both are checked against the kernel's own count at each layout's first
launch (:func:`fp_info`, :func:`bp_info`).  A first index and a count pack
in 16 bits each (``MAX_COUNT``).  The parallel kernels read
16 bytes at a time, so their wrappers pad the lane axis to a multiple of
16 bytes in fresh memory where it is not (``LanePlan.LANE_BYTES``).
"""
from __future__ import annotations

import dataclasses
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

# The parallel kernels (csrc/fp_par.cu): voxels of margin on each side of
# the FP's staged window (PAR_MARGIN); a thread carries 16 lanes when a
# block's lane chunk has at least WIDE_GROUPS groups of 8 (an even number),
# else 8.
PAR_MARGIN = 2
WIDE_GROUPS = 4
# Shared memory a block may use on the card, and the FP's budget: the FP
# takes up to FP_VIEWS neighbouring views a block (while its threads stay
# within FP_THREADS) and a chunk of FP_CHUNKS loop lines, the layout with
# the most views x lines within the budget, a chunk of one line only when
# no other fits, the least shared memory among equals (one view and one
# line, within SMEM_MAX, at least).  Chosen from sweeps on the H100 (PERF.md).
SMEM_MAX = 232448
FP_SMEM_BUDGET = 96 * 1024
FP_CHUNKS = (8, 4, 2, 1)
FP_VIEWS = 4
FP_THREADS = 256
# The FP packs a (line, column)'s first staged row and its count, the BP a
# (voxel, view)'s first column and its count (at most ku + 1), in 16 bits
# each.
MAX_COUNT = 65534
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


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
    """The plan's tables on one device (and the parallel FP's view batches,
    by (group, views a batch), as they are first launched)."""

    def __init__(self, plan: "LanePlan", device: torch.device):
        self.tables = tuple(torch.from_numpy(t).to(device) for t in plan.tables)
        self.rows = tuple(torch.from_numpy(r).to(device) for r in plan.rows)
        self.fz = torch.from_numpy(plan.fz).to(device)
        self.batches: Dict[Tuple[int, int], torch.Tensor] = {}


class LanePlan:
    """What a lane-packed pair (parallel here, fan in ``fp_fan.py``) derives
    from a geometry, once per cached op bundle: the two view groups' tables,
    the sinogram row of each group view, the axial overlap matrix, and their
    copies on each device they were used on.

    A subclass names its kernel library and kernels, the launch counts they
    add to, the launch arguments of its kernels (:meth:`fp_tail`,
    :meth:`bp_tail`), the alignment its kernels need of a tile
    (``LANE_BYTES``: its address and its lanes' bytes a multiple of it; 0:
    none), and :meth:`weights`, the plain version's footprint weights."""

    LIB = ""
    KERNELS: Tuple[str, str] = ("", "")
    LANE_BYTES = 0
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

    def fp_tail(self, grp: int, x: torch.Tensor, cfg: tune.KernelConfig) -> tuple:
        """Every launch argument of the FP kernel of view group ``grp`` on
        tile ``x`` between the column pitch and the stream."""
        raise NotImplementedError

    def bp_tail(self, grp: int, x: torch.Tensor, cfg: tune.KernelConfig,
                accumulate: int) -> tuple:
        """The same for the BP kernel (``accumulate``: add into the output)."""
        raise NotImplementedError

    def weights(self, table: torch.Tensor, ng: int, nl: int):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FpLayout:
    """The FP kernel's launch: ``tu`` columns and ``tl`` threads a column
    of ``lpt`` lanes in each of ``nvb`` views a block (:meth:`ParallelPlan.
    fp_batches`), ``lch`` loop lines a chunk, ``wcap`` staged gi rows,
    ``kw`` weights a (view, line, column) at most; ``smem``: the host's
    count of its dynamic shared memory (bytes; csrc/fp_par.cu
    ``par_fp_smem`` is the kernel's)."""
    tu: int
    tl: int
    lpt: int
    nvb: int
    lch: int
    wcap: int
    kw: int
    smem: int


@dataclasses.dataclass(frozen=True)
class BpLayout:
    """The BP kernel's launch: ``bx`` x ``by`` voxels (gi x li) and ``tl``
    threads a voxel of ``lpt`` lanes a block, ``ku`` columns a (voxel,
    view) pair at most; ``smem``: the host's count of its dynamic shared
    memory (bytes; the C launch's ``bp_smem_bytes`` is the kernel's)."""
    bx: int
    by: int
    tl: int
    lpt: int
    ku: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _floor_pow2(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _lanes_per_thread(groups: int) -> int:
    """Lanes a thread carries for a lane chunk of ``groups`` groups of 8."""
    return 16 if groups >= WIDE_GROUPS and groups % 2 == 0 else 8


def bp_block(cfg: tune.KernelConfig) -> Tuple[int, int, int, int]:
    """The block of a lane-packed BP kernel (parallel, fan), ``(bx, by, tl,
    lpt)``: a chunk of ``cfg.lg`` groups of 8 lanes (rounded down to a power
    of two, at most 64: a voxel's threads share a warp) and ``cfg.bg``
    voxels a block (rounded down to whole warps, at least one), as the
    squarest power-of-two split bx x by."""
    groups = min(_floor_pow2(cfg.lg), 64)
    lpt = _lanes_per_thread(groups)
    tl = groups * 8 // lpt
    per = 32 // tl                      # voxels a warp
    nvox = max(per, cfg.bg // per * per)
    while tl * nvox > 1024:
        nvox -= per
    return _split(nvox, tl, lpt)


def _split(nvox: int, tl: int, lpt: int) -> Tuple[int, int, int, int]:
    by = 1
    while by * by * 4 <= nvox and nvox % (by * 2) == 0:
        by *= 2
    return nvox // by, by, tl, lpt


def bp_fit(cfg: tune.KernelConfig, ku: int, fixed: int,
           kname: str) -> BpLayout:
    """A lane-packed BP's layout for ``cfg`` (:func:`bp_block`) with ``ku``
    columns a (voxel, view): its block's warps each keep a slot of ku + 1
    words a thread in shared memory after ``fixed`` bytes (the fan BP's
    column table), so a wide footprint takes whole warps off the block
    until that memory fits SMEM_MAX."""
    if ku > MAX_COUNT:
        raise ValueError(f"{kname}: {ku} columns a voxel and view exceed the "
                         f"kernel's {MAX_COUNT}")
    bx, by, tl, lpt = bp_block(cfg)
    per = 32 // tl                      # voxels a warp

    def smem(nvox):
        return fixed + (tl * nvox + 31) // 32 * 32 * ((ku | 1) + 1) * 4
    nvox = bx * by
    while smem(nvox) > SMEM_MAX and nvox > per:
        nvox -= per
    if smem(nvox) > SMEM_MAX:
        raise ValueError(
            f"{kname}: a warp's slots for {ku} columns a voxel need "
            f"{smem(nvox)} bytes of shared memory, more than the {SMEM_MAX} "
            f"a block may use")
    if nvox != bx * by:
        bx, by = _split(nvox, tl, lpt)[:2]
    return BpLayout(bx, by, tl, lpt, ku, smem(nvox))


def _tile_window(rows: np.ndarray, e0: float, du: float, u_first: int,
                 u_last: int, l0: int, l1: int, ng: int) -> Tuple[int, int]:
    """The FP kernel's staged window [G0, G1] (empty: G0 > G1) for the tile
    of columns u_first..u_last and loop lines l0..l1 of the block's views,
    whose table rows are ``rows`` (one row a view): csrc/fp_par.cu
    ``par_tile_window``, in the same float32 operations."""
    f = np.float32
    e0, du = f(e0), f(du)
    el = f(e0 + f(f(u_first) * du))
    eh = f(f(e0 + f(f(u_last) * du)) + du)
    xs = []
    for row in np.atleast_2d(rows):
        P, Q, R, hs = (f(v) for v in row[:4])
        rP = f(1) / P
        xs += [f(f(t - f(f(Q * f(l)) + R)) * rP)
               for l in (l0, l1) for t in (f(el - hs), f(eh + hs))]
    if not xs:
        return 0, -1

    def clamp_floor(x, lo, hi):
        return int(np.floor(min(max(x, f(lo)), f(hi))))
    g0 = max(clamp_floor(min(xs), -1, ng) - PAR_MARGIN, 0)
    g1 = min(clamp_floor(max(xs), -1, ng) + 1 + PAR_MARGIN, ng - 1)
    return g0, g1


class ParallelPlan(LanePlan):
    """The parallel SF pair's plan (tables of :func:`_view_params`) and the
    layouts of its kernels."""

    LIB = "fp_par"
    KERNELS = ("fp_par_sf", "bp_par_sf")
    LANE_BYTES = 16
    launches = LAUNCHES

    def __init__(self, geom: CTGeometry):
        if geom.geom_type != "parallel":
            raise ValueError(f"the parallel SF pair needs a parallel "
                             f"geometry, got {geom.geom_type!r}")
        super().__init__(geom, *_view_params(geom))
        self._bounds: Dict[tuple, int] = {}

    def weights(self, table: torch.Tensor, ng: int, nl: int):
        return _group_weights(self, table, ng, nl)

    # -- bounds, from the tables (float64 over the float32 values) -------- #
    def fp_kw(self, grp: int) -> int:
        """Weights a (loop line, column) pair can have in view group
        ``grp``: the voxel centres meeting a pixel lie in an interval of
        du + 2 hs, |P| apart, so at most floor((du + 2 hs) / |P|) + 1 of
        them; one more for rounding."""
        t = self.tables[grp].astype(np.float64)
        if t.shape[0] == 0:
            return 1
        return int(np.floor(np.max((self.du + 2.0 * t[:, 3]) / np.abs(t[:, 0])))) + 2

    def fp_batches(self, grp: int, nvb: int) -> np.ndarray:
        """The FP's batches of view group ``grp``: up to ``nvb`` views a
        batch, consecutive in the table and with P of one sign (the views
        of a batch look at neighbouring voxels: a batch never spans the
        jump of the y-gathered group from 45 to 135 degrees, where P
        flips); (batches, nvb) int32 table indices, -1 in empty slots."""
        P = self.tables[grp][:, 0]
        out, cur = [], []
        for a in range(P.size):
            if cur and (len(cur) == nvb or (P[a] > 0) != (P[cur[0]] > 0)):
                out.append(cur)
                cur = []
            cur.append(a)
        if cur:
            out.append(cur)
        b = np.full((len(out), nvb), -1, np.int32)
        for i, v in enumerate(out):
            b[i, :len(v)] = v
        return b

    def fp_wcap(self, grp: int, tu: int, lch: int, nvb: int) -> int:
        """Rows of the FP's staged window for a tile of ``tu`` columns, a
        chunk of ``lch`` loop lines and a batch of :meth:`fp_batches`: the
        widest span of the window's estimate (:func:`_tile_window`) over the
        batches, tiles and chunks, plus two for its floors, one for rounding
        and the margins.  The span is linear in each view's line, so its
        widest chunk is the first or the last (checked at full length)."""
        key = ("wcap", grp, tu, lch, nvb)
        if key in self._bounds:
            return self._bounds[key]
        t = self.tables[grp].astype(np.float64)
        if t.shape[0] == 0:
            return 1
        b = self.fp_batches(grp, nvb)
        rows = t[np.maximum(b, 0)]                       # (batches, nvb, 6)
        P, Q, R, hs = (rows[..., k, None] for k in range(4))
        ok = (b >= 0)[..., None]
        nl = self.group(grp, 1)[1]
        u0 = np.arange(0, self.geom.n_cols, tu, dtype=np.float64)
        el = self.e0 + u0 * self.du
        eh = self.e0 + (u0 + tu - 1) * self.du + self.du
        last = (nl - 1) // lch * lch
        span = 0.0
        for l0 in (0, last):
            xs = [(edge - (Q * l + R)) / P for l in (l0, l0 + lch - 1)
                  for edge in (el - hs, eh + hs)]
            hi = np.max([np.where(ok, x, -np.inf) for x in xs], axis=(0, 2))
            lo = np.min([np.where(ok, x, np.inf) for x in xs], axis=(0, 2))
            span = max(span, float(np.max(hi - lo)))
        # the window is clamped into the ng gathered voxels
        ng = self.group(grp, 1)[0]
        self._bounds[key] = min(int(np.floor(span)) + 4 + 2 * PAR_MARGIN, ng)
        return self._bounds[key]

    def bp_ku(self) -> int:
        """Columns a (voxel, view) pair can meet: pixels du wide meeting a
        footprint 2 hs wide, at most floor(2 hs / du) + 2; one more for
        rounding."""
        hs = np.concatenate([t[:, 3] for t in self.tables]).astype(np.float64)
        if hs.size == 0:
            return 1
        return int(np.floor(np.max(2.0 * hs / self.du))) + 3

    # -- layouts ------------------------------------------------------------ #
    def fp_layout(self, grp: int, dtype: torch.dtype,
                  cfg: tune.KernelConfig) -> FpLayout:
        """The FP kernel's layout for view group ``grp``: ``cfg.bu`` columns
        and a chunk of ``cfg.lg`` groups of 8 lanes a block, up to
        FP_VIEWS views while the block stays within FP_THREADS threads and
        a chunk of FP_CHUNKS loop lines, chosen as the module's comment
        says."""
        elem = _ELEM[dtype]
        tu, lpt = cfg.bu, _lanes_per_thread(cfg.lg)
        tl, lc, vn = cfg.lg * 8 // lpt, 8 * cfg.lg, 16 // elem
        kw = self.fp_kw(grp)
        if kw > MAX_COUNT:
            raise ValueError(f"fp_par_sf: {kw} weights a column and line "
                             f"exceed the kernel's {MAX_COUNT}")
        most = max(1, min(FP_VIEWS, FP_THREADS // (tl * tu),
                          1024 // (tl * tu)))
        cands = []
        for nvb in range(1, most + 1):
            for lch in FP_CHUNKS:
                wcap = self.fp_wcap(grp, tu, lch, nvb)
                smem = (_align16(wcap * (lch * lc + vn) * elem)
                        + nvb * lch * tu * (kw + 1) * 4 + 32 * nvb + 4)
                cands.append((smem <= FP_SMEM_BUDGET and lch > 1,
                              smem <= FP_SMEM_BUDGET, nvb * lch, -smem, nvb,
                              lch, wcap, smem))
        best = max(cands)
        if not best[1]:       # nothing within the budget: the least memory
            best = max(cands, key=lambda c: (-c[-1], c[2]))
        if best[-1] > SMEM_MAX:
            raise ValueError(
                f"fp_par_sf: a tile of {tu} columns and {lc} lanes needs "
                f"{best[-1]} bytes of shared memory, more than the "
                f"{SMEM_MAX} a block may use; pin a KernelConfig with a "
                f"smaller bu or lg")
        nvb, lch, wcap, smem = best[4:]
        return FpLayout(tu, tl, lpt, nvb, lch, wcap, kw, smem)

    def bp_layout(self, cfg: tune.KernelConfig) -> BpLayout:
        """The BP kernel's layout: :func:`bp_fit` with :meth:`bp_ku`."""
        return bp_fit(cfg, self.bp_ku(), 0, "bp_par_sf")

    def fp_tail(self, grp: int, x: torch.Tensor, cfg: tune.KernelConfig) -> tuple:
        lay = self.fp_layout(grp, x.dtype, cfg)
        if (x.dtype, lay) not in _CHECKED:
            fp_info(lay, x.dtype)
            _CHECKED.add((x.dtype, lay))
        dt = self.on(x.device)
        if (grp, lay.nvb) not in dt.batches:
            dt.batches[(grp, lay.nvb)] = torch.from_numpy(
                self.fp_batches(grp, lay.nvb)).to(x.device)
        b = dt.batches[(grp, lay.nvb)]
        return (b.data_ptr(), b.shape[0], lay.tu, lay.tl, lay.lpt, lay.nvb,
                lay.lch, lay.wcap, lay.kw)

    def bp_tail(self, grp: int, x: torch.Tensor, cfg: tune.KernelConfig,
                accumulate: int) -> tuple:
        lay = self.bp_layout(cfg)
        if (x.dtype, lay) not in _CHECKED:
            bp_info(lay, x.dtype)
            _CHECKED.add((x.dtype, lay))
        return (accumulate, lay.bx, lay.by, lay.tl, lay.lpt, lay.ku)


# (dtype, FpLayout or BpLayout) whose shared memory count the kernel has
# confirmed (fp_info, bp_info), each once a process.
_CHECKED: set = set()


def fp_info(lay: FpLayout, dtype: torch.dtype) -> Dict[str, int]:
    """The FP kernel instance for ``dtype`` tiles at layout ``lay``, on
    this card: its dynamic shared memory a block (bytes, as the kernel
    counts it) and resident blocks per SM.  Raises when the kernel's count
    is not the host's (``lay.smem``)."""
    import ctypes
    from repro_torch.kernels import build
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    build.check("fp_par", build.library("fp_par").fp_par_sf_info(
        _DTYPE_CODE[dtype], lay.tu, lay.tl, lay.lpt, lay.nvb, lay.lch,
        lay.wcap, lay.kw, ctypes.byref(smem), ctypes.byref(blocks)),
        "fp_par_sf info")
    check_smem("fp_par_sf", smem.value, lay)
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def bp_info(lay: BpLayout, dtype: torch.dtype) -> Dict[str, int]:
    """The BP kernel instance for ``dtype`` tiles at layout ``lay``, on
    this card: its dynamic shared memory a block (bytes, as the kernel
    counts it) and resident blocks per SM.  Raises when the kernel's count
    is not the host's (``lay.smem``)."""
    import ctypes
    from repro_torch.kernels import build
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    build.check("fp_par", build.library("fp_par").bp_par_sf_info(
        _DTYPE_CODE[dtype], lay.lpt, lay.bx * lay.by * lay.tl, lay.ku,
        ctypes.byref(smem), ctypes.byref(blocks)), "bp_par_sf info")
    check_smem("bp_par_sf", smem.value, lay)
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def check_smem(kname: str, smem: int, lay) -> None:
    """Raise unless the kernel's count of its shared memory is the host's
    (``lay.smem``)."""
    if smem != lay.smem:
        raise RuntimeError(
            f"{kname} carves {smem} bytes of shared memory from the layout "
            f"{lay}, the host counted {lay.smem}: the C count and the "
            f"layout's disagree")


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


def _aligned(x: torch.Tensor, plan: LanePlan) -> torch.Tensor:
    """``x`` as the plan's kernels can read it: where its address or its
    lanes' bytes are not multiples of ``plan.LANE_BYTES``, a copy in fresh
    memory with its lane axis padded by zeros to such a multiple."""
    n = plan.LANE_BYTES
    lanes = x.shape[-1]
    pad = -lanes % (n // x.element_size()) if n else 0
    if n == 0 or (pad == 0 and x.data_ptr() % n == 0):
        return x
    out = x.new_zeros(x.shape[:-1] + (lanes + pad,))
    out[..., :lanes] = x
    return out


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
    _check_tile(g, (geom.vol.nx, geom.vol.ny, g.shape[-1]), kname)
    lanes, g = g.shape[-1], _aligned(g, plan)
    out = torch.empty((geom.n_angles, geom.n_cols, g.shape[-1]),
                      dtype=torch.float32, device=g.device)
    dt = plan.on(g.device)
    launch = getattr(build.library(plan.LIB), f"{kname}_launch")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        for grp in (0, 1):
            n = dt.tables[grp].shape[0]
            if n == 0:
                continue
            ng, nl, gs, ls = plan.group(grp, g.shape[-1])
            rc = launch(
                _DTYPE_CODE[g.dtype], dt.tables[grp].data_ptr(),
                dt.rows[grp].data_ptr(), n, g.data_ptr(), out.data_ptr(),
                ng, nl, g.shape[-1], gs, ls, geom.n_cols, plan.e0, plan.du,
                *plan.fp_tail(grp, g, cfg), stream)
            build.check(plan.LIB, rc, f"{kname} launch")
            plan.launches[kname] += 1
    return out if out.shape[-1] == lanes else out[..., :lanes].contiguous()


def bp_lanes(q: torch.Tensor, plan: LanePlan,
             cfg: tune.KernelConfig) -> torch.Tensor:
    """BP at the kernel's interface: (n_angles, n_cols, lanes) -> (nx, ny,
    lanes) f32.  A CUDA tensor launches the plan's BP kernel; a CPU tensor
    runs :func:`bp_lanes_plain`."""
    if q.device.type == "cpu":
        return bp_lanes_plain(q, plan)
    from repro_torch.kernels import build
    geom, kname = plan.geom, plan.KERNELS[1]
    _check_tile(q, (geom.n_angles, geom.n_cols, q.shape[-1]), kname)
    lanes, q = q.shape[-1], _aligned(q, plan)
    out = torch.empty((geom.vol.nx, geom.vol.ny, q.shape[-1]),
                      dtype=torch.float32, device=q.device)
    dt = plan.on(q.device)
    launch = getattr(build.library(plan.LIB), f"{kname}_launch")
    accumulate = 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for grp in (0, 1):
            n = dt.tables[grp].shape[0]
            if n == 0:
                continue
            ng, nl, gs, ls = plan.group(grp, q.shape[-1])
            rc = launch(
                _DTYPE_CODE[q.dtype], dt.tables[grp].data_ptr(),
                dt.rows[grp].data_ptr(), n, q.data_ptr(), out.data_ptr(),
                ng, nl, q.shape[-1], gs, ls, geom.n_cols, plan.e0, plan.du,
                *plan.bp_tail(grp, q, cfg, accumulate), stream)
            build.check(plan.LIB, rc, f"{kname} launch")
            plan.launches[kname] += 1
            accumulate = 1
    return out if out.shape[-1] == lanes else out[..., :lanes].contiguous()


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
    cdt = precision.resolve(compute_dtype, f.dtype)
    cfg = tune.resolve_config(plan.geom, _batch(f, "volume"), config,
                              tune.parallel_config, cdt, device=f.device)
    return fp_packed(f, plan, cdt, lambda g: fp_lanes(g, plan, cfg))


def bp_parallel_sf(sino: torch.Tensor, plan: ParallelPlan,
                   config: Optional[tune.KernelConfig] = None,
                   compute_dtype=None) -> torch.Tensor:
    """sino: (n_angles, n_rows, n_cols) -> volume (nx, ny, nz), or batched
    (batch, ...) -> (batch, nx, ny, nz).  Exact transpose of
    :func:`fp_parallel_sf`."""
    cdt = precision.resolve(compute_dtype, sino.dtype)
    cfg = tune.resolve_config(plan.geom, _batch(sino, "sinogram"), config,
                              tune.parallel_config, cdt, device=sino.device)
    return bp_packed(sino, plan, cdt, lambda q: bp_lanes(q, plan, cfg))


def register() -> None:
    from repro_torch.kernels import ops
    ops.register_kernel("parallel", "sf", ParallelPlan, fp_parallel_sf,
                        bp_parallel_sf, fp_batched=fp_parallel_sf,
                        bp_batched=bp_parallel_sf)
