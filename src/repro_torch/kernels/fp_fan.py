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

**The kernels' layouts** are derived here from the
:class:`~repro_torch.kernels.tune.KernelConfig` (``tune.resolve_config``:
a pin, a measured one, or the heuristic ``tune.heuristic_config``): the
FP's tile of ``bu`` columns and ``8 lg`` lanes (8 or 16 a thread), walked
in pieces of ``vcap`` voxels chosen to
fill :data:`FP_SMEM_BUDGET` (:meth:`FanPlan.fp_layout`); the BP's block of
``bg`` voxels (``fp_par.bp_block``).  Both bound the columns one voxel can
meet by :meth:`FanPlan.ku`; the FP's voxel window of a tile and line is
the footprint's half-width bound widened around the tile
(:func:`tile_window`, the host's copy of the kernel's), so the CPU tests
hold both against the plain version's nonzero weights.  The FP's shared
memory is counted here (:func:`_fp_smem`, and the BP's in
``fp_par.bp_fit``) and checked against the kernel's own count at each
layout's first launch (:func:`fp_info`, :func:`bp_info`).  A column count
and a first column pack in 16 bits each; a wide footprint takes whole warps
off the BP's block until its slots fit the card's shared memory.  The
kernels read 16 bytes at a time, so the wrappers pad the lane axis to a
multiple of 16 bytes where it is not (``LANE_BYTES``).

:class:`ConePackedPlan` runs the same kernels on a flat-detector cone
geometry: with :func:`fp_fan_sf` / :func:`bp_fan_sf` it is the packed cone
pair, whose axial map is the central-magnification pre-resample
(``fp_cone._z_overlap_cone_packed``); ``ops`` registers it on the cone
entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import fp_par, precision, tune
from repro_torch.kernels.footprint import trapezoid_pixel_weight
from repro_torch.kernels.fp_cone import (_corner_trapezoid, _view_params_cone,
                                         _z_overlap_cone_packed,
                                         footprint_halfwidth)
from repro_torch.kernels.fp_par import (LanePlan, bp_lanes, bp_lanes_plain,
                                        fp_lanes, fp_lanes_plain)

__all__ = ["FanPlan", "ConePackedPlan", "LAUNCHES", "reset_launches",
           "fp_lanes", "bp_lanes", "fp_lanes_plain", "bp_lanes_plain", "fp_fan_sf", "bp_fan_sf",
           "register", "FanFpLayout", "fp_info", "bp_info", "tile_window",
           "division_mismatches"]

# Kernel launches since the last reset_launches(), by kernel.  One call of a
# wrapper launches once per non-empty view group.
LAUNCHES: Dict[str, int] = {"fp_fan_sf": 0, "bp_fan_sf": 0}

# The FP kernel's shared memory a block: the layout takes the most voxel
# slots a piece within FP_SMEM_BUDGET that are a whole number a thread, and
# one a thread at least where SMEM_MAX allows it, in at most FP_SEGS line
# segments a piece.  Chosen on the H100 (PERF.md).
FP_SMEM_BUDGET = 24 * 1024
FP_SEGS = 16
_MAX_SLOTS = 65535          # a slot index is 16 bits
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class FanFpLayout:
    """The FP kernel's launch: ``tu`` columns and ``tl`` threads a column of
    ``lpt`` lanes a block, pieces of ``vcap`` voxel slots in at most
    ``segs`` line segments, ``ku`` columns a voxel at most; ``smem``: the
    host's count of its dynamic shared memory (bytes; csrc/fp_fan.cu
    ``fan_fp_smem`` is the kernel's)."""
    tu: int
    tl: int
    lpt: int
    nl: int
    vcap: int
    segs: int
    ku: int
    smem: int


def _fp_smem(elem: int, tu: int, lc: int, nl: int, vcap: int, segs: int,
             ku: int) -> int:
    """csrc/fp_fan.cu ``fan_fp_smem``: staged lanes (a slot's row padded by
    16 bytes), the tile's columns, each slot's weights and columns, each
    (segment, column)'s first and last slot, the lines' windows, two piece
    plans and the flags, each 16-byte aligned."""
    a = fp_par._align16
    sc = a(vcap * (lc + 16 // elem) * elem)
    sw = a(sc + tu * 16)
    sr = a(sw + vcap * ku * 4)
    sf = a(sr + vcap * 4)
    sl = a(sf + segs * tu * 2)
    sn = a(sl + segs * tu * 2)
    sp = a(sn + nl * 8)
    sflag = a(sp + 2 * (3 * segs + 3) * 4)
    return sflag + 16


def tile_window(plan: "FanPlan", table_row: np.ndarray, li: int,
                u_first: int, u_last: int, ng: int) -> Tuple[int, int]:
    """The FP kernel's voxel window [g0, g1] on loop line ``li`` for the
    tile of columns u_first..u_last in the view of ``table_row``:
    csrc/footprint.cuh ``sf_gather_window`` at the tile's edges widened by
    the footprint's half-width bound, in the same float32 expressions (nvcc
    may fuse their products, and ``tanf`` may differ in its last bit: the
    window's voxel of margin on each side covers both)."""
    f = np.float32
    e0, du, sdd, hw = f(plan.e0), f(plan.du), f(plan.sdd), f(plan.hw)
    P = table_row.astype(np.float32)
    lo = f(f(e0 + f(f(u_first) * du)) - hw)
    hi = f(f(f(e0 + f(f(u_last) * du)) + du) + hw)
    l = f(li)
    Aq, Al = P[0], P[3]
    q0 = f(f(P[1] * l) + P[2])
    l0 = f(f(P[4] * l) + P[5])
    num, den, whole = [], [], False
    for us in (lo, hi):
        if plan.curved:
            ang = f(us / sdd)
            whole |= abs(ang) > 1.5
            t = f(np.tan(ang))
            num.append(f(f(t * l0) - q0))
            den.append(f(Aq - f(t * Al)))
        else:
            num.append(f(f(us * l0) - f(sdd * q0)))
            den.append(f(f(sdd * Aq) - f(us * Al)))
        whole |= abs(den[-1]) < f(1e-6)
    whole |= (den[0] < 0) != (den[1] < 0)
    if whole:
        return 0, ng - 1
    lim = f(ng + 1.0)
    ga = min(max(f(num[0] / den[0]), f(-2.0)), lim)
    gb = min(max(f(num[1] / den[1]), f(-2.0)), lim)
    return (max(int(math.floor(min(ga, gb))) - 1, 0),
            min(int(math.ceil(max(ga, gb))) + 1, ng - 1))


class FanPlan(LanePlan):
    """The fan SF pair's plan: the lane plan of ``fp_par`` with the 20-float
    corner-projection tables, the source-detector distance, the voxel pitch,
    the footprint half-width bound of the FP kernel's voxel window
    (``fp_cone.footprint_halfwidth``), the detector type, and the layouts of
    its kernels."""

    LIB = "fp_fan"
    KERNELS = ("fp_fan_sf", "bp_fan_sf")
    LANE_BYTES = 16
    launches = LAUNCHES

    def __init__(self, geom: CTGeometry):
        self._accept(geom)
        super().__init__(geom, *_view_params_cone(geom))
        self.sdd = float(np.float32(geom.sdd))
        self.dxv = float(np.float32(geom.vol.dx))
        self.hw = float(np.float32(footprint_halfwidth(geom)))
        self.curved = geom.detector_type == "curved"

    @staticmethod
    def _accept(geom: CTGeometry) -> None:
        if geom.geom_type != "fan":
            raise ValueError(f"the fan SF pair needs a fan geometry, got "
                             f"{geom.geom_type!r}")

    def ku(self) -> int:
        """Columns a (voxel, view) can meet: its footprint spans at most
        2 hw, so it meets at most floor(2 hw / du) + 2 pixels du wide; one
        more for rounding."""
        return int(np.floor(2.0 * self.hw / self.du)) + 3

    def fp_layout(self, grp: int, dtype: torch.dtype,
                  cfg: tune.KernelConfig) -> FanFpLayout:
        """The FP kernel's layout for view group ``grp``: ``cfg.bu`` columns
        and a chunk of ``cfg.lg`` groups of 8 lanes a block, and voxel slots
        a piece as the module's comment says."""
        elem = _ELEM[dtype]
        lpt = fp_par._lanes_per_thread(cfg.lg)
        tu, tl, lc = cfg.bu, cfg.lg * 8 // lpt, 8 * cfg.lg
        nl, ku = self.group(grp, 1)[1], self.ku()
        if ku > fp_par.MAX_COUNT:
            raise ValueError(f"fp_fan_sf: {ku} columns a voxel exceed the "
                             f"kernels' {fp_par.MAX_COUNT}")

        def smem(v):
            return _fp_smem(elem, tu, lc, nl, v, FP_SEGS, ku)

        def most(limit):                     # the most slots within limit
            lo, hi = 0, _MAX_SLOTS
            while lo < hi:
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if smem(mid) <= limit else (lo, mid - 1)
            return lo
        # whole slots a thread (each thread forms as many trapezoids a
        # piece), at least one, where the card allows it
        nt = tu * tl
        vcap = min(max(most(FP_SMEM_BUDGET) // nt, 1) * nt,
                   most(fp_par.SMEM_MAX))
        if vcap < 1:
            raise ValueError(
                f"fp_fan_sf: a tile of {tu} columns and {lc} lanes needs "
                f"{smem(1)} bytes of shared memory, more than the "
                f"{fp_par.SMEM_MAX} a block may use; pin a KernelConfig with a "
                f"smaller bu or lg")
        return FanFpLayout(tu, tl, lpt, nl, vcap, FP_SEGS, ku, smem(vcap))

    def bp_layout(self, cfg: tune.KernelConfig) -> fp_par.BpLayout:
        """The BP kernel's layout: the parallel BP's block for ``cfg`` with
        :meth:`ku` columns a (voxel, view) (``fp_par.bp_fit``), after the
        table of the columns' divisors."""
        return fp_par.bp_fit(cfg, self.ku(),
                             fp_par._align16(8 * self.geom.n_cols), "bp_fan_sf")

    def fp_tail(self, grp: int, x: torch.Tensor, cfg: tune.KernelConfig) -> tuple:
        lay = self.fp_layout(grp, x.dtype, cfg)
        if x.is_cuda and (x.dtype, self.curved, lay) not in _CHECKED:
            fp_info(lay, x.dtype, self.curved)
            _CHECKED.add((x.dtype, self.curved, lay))
        return (self.sdd, self.dxv, self.hw, int(self.curved), lay.tu, lay.tl,
                lay.lpt, lay.vcap, lay.segs, lay.ku)

    def bp_tail(self, grp: int, x: torch.Tensor, cfg: tune.KernelConfig,
                accumulate: int) -> tuple:
        lay = self.bp_layout(cfg)
        if x.is_cuda and (x.dtype, self.curved, lay) not in _CHECKED:
            bp_info(lay, x.dtype, self.curved, self.geom.n_cols)
            _CHECKED.add((x.dtype, self.curved, lay))
        return (self.sdd, self.dxv, int(self.curved), accumulate, lay.bx,
                lay.by, lay.tl, lay.lpt, lay.ku)

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


class ConePackedPlan(FanPlan):
    """The packed cone pair's plan (for :func:`fp_fan_sf` /
    :func:`bp_fan_sf`): the fan plan of a flat-detector cone geometry, whose transaxial footprint is the
    fan pair's, with the axial map at the central magnification
    (``fp_cone._z_overlap_cone_packed``) in place of the fan's rectangle
    overlap.  Its kernels are the fan pair's, and count their launches
    there."""

    def __init__(self, geom: CTGeometry):
        super().__init__(geom)
        self.fz = _z_overlap_cone_packed(geom)

    @staticmethod
    def _accept(geom: CTGeometry) -> None:
        if geom.geom_type != "cone" or geom.detector_type != "flat":
            raise NotImplementedError(
                "packed cone pair supports flat-detector cone geometries "
                f"only, got {geom.geom_type}/{geom.detector_type}")


# (dtype, curved, FanFpLayout or BpLayout) whose shared memory count the
# kernel has confirmed (fp_info, bp_info), each once a process.
_CHECKED: set = set()


def fp_info(lay: FanFpLayout, dtype: torch.dtype, curved: bool) -> Dict[str, int]:
    """The FP kernel instance for ``dtype`` tiles on the ``curved`` or flat
    detector at layout ``lay``, on this card: its dynamic shared memory a
    block (bytes, as the kernel counts it) and resident blocks per SM.
    Raises when the kernel's count is not the host's (``lay.smem``)."""
    import ctypes
    from repro_torch.kernels import build
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    build.check("fp_fan", build.library("fp_fan").fp_fan_sf_info(
        fp_par._DTYPE_CODE[dtype], int(curved), lay.tu, lay.tl, lay.lpt,
        lay.nl, lay.vcap, lay.segs, lay.ku, ctypes.byref(smem),
        ctypes.byref(blocks)), "fp_fan_sf info")
    fp_par.check_smem("fp_fan_sf", smem.value, lay)
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def bp_info(lay: fp_par.BpLayout, dtype: torch.dtype, curved: bool,
            nu: int) -> Dict[str, int]:
    """The BP kernel instance for ``dtype`` tiles on the ``curved`` or flat
    detector at layout ``lay`` with ``nu`` columns, on this card: its
    dynamic shared memory a block (bytes, as the kernel counts it) and
    resident blocks per SM.  Raises when the kernel's count is not the
    host's (``lay.smem``)."""
    import ctypes
    from repro_torch.kernels import build
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    build.check("fp_fan", build.library("fp_fan").bp_fan_sf_info(
        fp_par._DTYPE_CODE[dtype], int(curved), lay.lpt,
        lay.bx * lay.by * lay.tl, nu, lay.ku, ctypes.byref(smem),
        ctypes.byref(blocks)), "bp_fan_sf info")
    fp_par.check_smem("bp_fan_sf", smem.value, lay)
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def division_mismatches(seed: int, n: int) -> int:
    """How many of ``n`` pseudo-random (ov, dv) pairs from ``seed`` the
    kernels' division (csrc/fp_fan.cu ``fan_div_rn``) rounds otherwise than
    ``__fdiv_rn``, on the card."""
    from repro_torch.kernels import build
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    build.check("fp_fan", build.library("fp_fan").fp_fan_div_check(
        seed, n, bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "fp_fan_div_check")
    return int(bad.item())


def fp_fan_sf(f: torch.Tensor, plan: FanPlan,
              config: Optional[tune.KernelConfig] = None,
              compute_dtype=None) -> torch.Tensor:
    """f: (nx, ny, nz) -> sino (n_angles, n_rows, n_cols), or lane-packed
    batched f: (batch, nx, ny, nz) -> (batch, n_angles, n_rows, n_cols).
    ``compute_dtype`` selects the tile dtype (None = follow ``f.dtype``);
    accumulation is f32 and the result comes back in ``f.dtype``."""
    cdt = precision.resolve(compute_dtype, f.dtype)
    cfg = tune.resolve_config(plan.geom, fp_par._batch(f, "volume"), config,
                              dtype=cdt, packed=isinstance(plan, ConePackedPlan),
                              device=f.device)
    return fp_par.fp_packed(f, plan, cdt, lambda g: fp_lanes(g, plan, cfg))


def bp_fan_sf(sino: torch.Tensor, plan: FanPlan,
              config: Optional[tune.KernelConfig] = None,
              compute_dtype=None) -> torch.Tensor:
    """sino: (n_angles, n_rows, n_cols) -> volume (nx, ny, nz), or batched
    (batch, ...) -> (batch, nx, ny, nz).  Exact transpose of
    :func:`fp_fan_sf`."""
    cdt = precision.resolve(compute_dtype, sino.dtype)
    cfg = tune.resolve_config(plan.geom, fp_par._batch(sino, "sinogram"),
                              config, dtype=cdt,
                              packed=isinstance(plan, ConePackedPlan),
                              device=sino.device)
    return fp_par.bp_packed(sino, plan, cdt, lambda q: bp_lanes(q, plan, cfg))


def register() -> None:
    from repro_torch.kernels import ops
    ops.register_kernel("fan", "sf", FanPlan, fp_fan_sf, bp_fan_sf,
                        fp_batched=fp_fan_sf, bp_batched=bp_fan_sf)
