"""Launch configuration of the CUDA projector kernels.

The lane-packed kernels (parallel and fan beam) carry 8 or 16 consecutive
lanes per thread (a lane is one ``batch x detector-row`` column of the
lane-packed layout, contiguous in memory; ``LANES_PER_THREAD`` is a lane
group, 16 from 4 groups a block on), and the threads of a block's lane
chunk share each footprint weight.  Both pairs read the fields as their
tile shape and derive the rest from the shapes:

    lg   groups of 8 lanes a block (the lane chunk: 8 lg lanes, whose
         threads share each weight; a thread carries 16 lanes from 4
         groups on, else 8).  The BP rounds it down to a power of two, at
         most 64 (a voxel's threads share a warp)
    bu   FP: detector columns a block (the tile whose weights are
         evaluated once and whose volume is staged).  The parallel layout
         adds up to ``fp_par.FP_VIEWS`` neighbouring views a block
         (``fp_par.ParallelPlan.fp_layout``); the fan layout walks the
         tile's loop lines in pieces of voxels that fill its shared memory
         budget (``fp_fan.FanPlan.fp_layout``)
    bg   BP: voxels a block, rounded down to whole warps and split into
         the squarest power-of-two tile of gi x li (``fp_par.bp_block``)

The fan pair's heuristic is :func:`heuristic_config`, the parallel pair's
:func:`parallel_config`.  The exact cone and modular kernels have no lane
axis and take no configuration: their launches (``csrc/cone_sf.cuh``
``sf_grid``) derive the block from the detector rows or z slices, and the
samples per thread from the batch (``fp_cone.samples_per_thread``).

The kernels read 16 bytes at a time, and their wrappers pad the lane axis
to a multiple of 16 bytes where it is not one (``fp_par._aligned``).
``resolve_config`` returns an explicit pin when one is given, else the
pair's heuristic.  The packed cone pair (the fan pair's entry points on a
``fp_fan.ConePackedPlan``) runs the fan kernels on batch x detector-row
lanes and takes the fan heuristic.

:func:`packed_cone_ok` is the ``mode="auto"`` gate of the packed cone pair
(``kernels/ops.py``): the packed pair's worst axial footprint displacement
(``fp_cone.cone_packed_row_shift``) at most :func:`packed_cone_tolerance`
detector rows.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from repro_torch.core.geometry import CTGeometry

__all__ = ["KernelConfig", "LANES_PER_THREAD", "PACKED_CONE_DEFAULT_TOL",
           "heuristic_config", "packed_cone_ok", "packed_cone_tolerance",
           "parallel_config", "resolve_config"]

LANES_PER_THREAD = 8        # lanes a group (the kernels' lane vectors)
_THREADS = 128              # threads per block chosen by the heuristics
_MAX_THREADS = 1024
_MAX_GROUPS = 16            # lane groups a block, parallel heuristic
_FAN_MAX_GROUPS = 8         # lane groups a block, fan heuristic


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Block shapes of the lane-packed SF kernel pairs."""

    bu: int = 128    # FP detector columns per block
    bg: int = 128    # BP gathered voxels per block
    lg: int = 1      # lane groups per block (both kernels)

    def __post_init__(self):
        for name in ("bu", "bg", "lg"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v > 0):
                raise ValueError(f"KernelConfig.{name} must be a positive "
                                 f"int, got {v!r}")
        if max(self.bu, self.bg) * self.lg > _MAX_THREADS:
            raise ValueError(
                f"KernelConfig{(self.bu, self.bg, self.lg)} asks for more "
                f"than {_MAX_THREADS} threads per block")

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def heuristic_config(geom: CTGeometry, batch: int = 1) -> KernelConfig:
    """The fan kernels' heuristic: as many lane groups as the lanes need,
    up to 8 (a thread carries 8 lanes, or 16 from 4 groups on; the FP
    stages a voxel's whole lane chunk, so wider chunks leave fewer voxels
    a piece), and blocks of 128 threads: FP tiles of 128 columns at one
    thread a column, fewer as the lane chunk widens; BP blocks likewise
    (PERF.md, the fan pair's sweeps)."""
    lanes = batch * geom.n_rows
    groups = -(-lanes // LANES_PER_THREAD)
    lg = min(_pow2_ceil(groups), _FAN_MAX_GROUPS)
    tl = lg if lg < 4 else lg // 2          # threads an output
    return KernelConfig(bu=_THREADS // tl, bg=_THREADS // tl, lg=lg)


def resolve_config(
        geom: CTGeometry, batch: int, config: Optional[KernelConfig],
        heuristic: Callable[[CTGeometry, int], KernelConfig] = heuristic_config,
) -> KernelConfig:
    """An explicit ``config`` wins, else ``heuristic`` (the fan pair's
    :func:`heuristic_config`, or the parallel pair's :func:`parallel_config`)."""
    return config if config is not None else heuristic(geom, batch)


# The parallel kernels' heuristic, chosen from sweeps on the H100 (PERF.md): a
# lane chunk of up to 16 groups (128 lanes: each weight serves them all);
# FP tiles of 32 columns at 8 lanes, else 16 (with up to FP_VIEWS views a
# block, fp_par.ParallelPlan.fp_layout); BP blocks of 128 threads.


def parallel_config(geom: CTGeometry, batch: int = 1) -> KernelConfig:
    """The parallel kernels' heuristic: as many lane groups as the lanes
    need, up to 16 (a thread carries 8 lanes, or 16 from 4 groups on:
    ``fp_par._lanes_per_thread``); the FP's tile and the BP's block as
    above."""
    lanes = batch * geom.n_rows
    groups = -(-lanes // LANES_PER_THREAD)
    lg = min(_pow2_ceil(groups), _MAX_GROUPS)
    tl = lg if lg < 4 else lg // 2          # threads an output
    return KernelConfig(bu=32 if tl == 1 else 16, bg=128 // tl, lg=lg)


# --------------------------------------------------------------------------- #
# Packed-cone dispatch gate
# --------------------------------------------------------------------------- #
# Default ceiling on the packed approximation's worst-case axial footprint
# displacement (detector rows).  A quarter row keeps the relative error bound
# (2x the shift + the second-order obliquity term, see
# fp_cone.cone_packed_error_bound) well below typical detector noise.
PACKED_CONE_DEFAULT_TOL = 0.25
PACKED_CONE_TOL_ENV = "REPRO_TORCH_PACKED_CONE_TOL"


def packed_cone_tolerance() -> float:
    """Row-shift ceiling for ``mode="auto"`` packed-cone dispatch
    (``REPRO_TORCH_PACKED_CONE_TOL`` overrides the default; a value that is
    not a float raises, rather than dispatching the approximate pair at a
    gate the user did not ask for)."""
    val = os.environ.get(PACKED_CONE_TOL_ENV, "").strip()
    if val:
        try:
            return float(val)
        except ValueError:
            raise ValueError(
                f"{PACKED_CONE_TOL_ENV}={val!r} is not a float") from None
    return PACKED_CONE_DEFAULT_TOL


def packed_cone_ok(geom: CTGeometry) -> bool:
    """True when the packed (lane-packed, axial pre-resample) cone pair is
    within tolerance for this geometry: the ``mode="auto"`` gate."""
    if geom.geom_type != "cone" or geom.detector_type != "flat":
        return False
    from repro_torch.kernels import fp_cone            # late: fp_cone imports us
    return fp_cone.cone_packed_row_shift(geom) <= packed_cone_tolerance()
