"""Launch configuration of the CUDA projector kernels.

The lane-packed kernels (parallel and fan beam) carry ``LANES_PER_THREAD``
consecutive lanes per thread (a lane is one ``batch x detector-row``
column of the lane-packed layout, contiguous in memory), so one footprint
weight serves that many multiply-adds.  A block is a 2D arrangement of threads:

    lg   lane groups per block (threadIdx.x, fastest — neighbouring threads
         read neighbouring lane groups, so loads coalesce when there are
         many lanes)
    bu   FP: detector columns per block (threadIdx.y)
    bg   BP: gathered-axis voxels per block (threadIdx.y)

The exact cone and modular kernels have no lane axis and take no
configuration: their launches (``csrc/cone_sf.cuh`` ``sf_grid``) derive the
block from the detector rows or z slices, and the samples per thread from
the batch (``fp_cone.samples_per_thread``).

The lane axis is masked at its ragged edge inside the kernels; nothing is
padded.  ``resolve_config`` returns an explicit pin when one is given, else
the heuristic below.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.geometry import CTGeometry

__all__ = ["KernelConfig", "LANES_PER_THREAD", "heuristic_config",
           "resolve_config"]

LANES_PER_THREAD = 8        # must equal LPT in csrc/fp_par.cu, fp_fan.cu
_THREADS = 128              # threads per block chosen by the heuristic
_MAX_THREADS = 1024


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
    """128-thread blocks: as many lane groups as the lanes need (up to 4),
    the rest of the block along detector columns / gathered voxels."""
    lanes = batch * geom.n_rows
    groups = -(-lanes // LANES_PER_THREAD)
    lg = min(_pow2_ceil(groups), 4)
    return KernelConfig(bu=_THREADS // lg, bg=_THREADS // lg, lg=lg)


def resolve_config(geom: CTGeometry, batch: int,
                   config: Optional[KernelConfig]) -> KernelConfig:
    """An explicit ``config`` wins, else :func:`heuristic_config`."""
    return config if config is not None else heuristic_config(geom, batch)
