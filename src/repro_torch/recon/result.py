"""Uniform solver result + input coercion for the recon layer.

Every iterative solver returns a :class:`ReconResult` and accepts a
:class:`~repro_torch.core.spec.ProjectorSpec`, an already-built
:class:`~repro_torch.core.projector.Projector` or a
:class:`~repro_torch.core.distributed.DistributedProjector`: the solvers
see the operator through the shapes of this process's pieces
(``local_vol_shape``, ``local_sino_shape``) and the sum of every process's
partial sums (``reduce_partial``), which one device holds whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.projector import Projector
from repro_torch.core.spec import ProjectorSpec

__all__ = ["ReconResult", "as_projector"]


@dataclasses.dataclass(frozen=True)
class ReconResult:
    """What an iterative solver hands back.

    Attributes:
        image:            the reconstruction; leading batch dims (if the
                          sinogram had any) are preserved.
        iterations:       number of outer iterations run.
        residual_history: per-iteration data-residual norm ``||A x_k - y||``
                          (masked where a mask was given), shape
                          ``batch_dims + (iterations,)``.
    """

    image: torch.Tensor
    iterations: int
    residual_history: torch.Tensor

    @property
    def final_residual(self) -> torch.Tensor:
        return self.residual_history[..., -1]


def as_projector(spec_or_projector, device: Optional[torch.device] = None):
    """Coerce a solver's operator argument to a projector object.  A spec is
    realized on ``device`` (the solver passes its data's device); a prebuilt
    :class:`Projector` or
    :class:`~repro_torch.core.distributed.DistributedProjector` passes
    through.  A spec carrying a ``ShardSpec`` needs a mesh, and raises."""
    from repro_torch.core.distributed import DistributedProjector
    if isinstance(spec_or_projector, (Projector, DistributedProjector)):
        return spec_or_projector
    if isinstance(spec_or_projector, ProjectorSpec):
        if spec_or_projector.shard is not None:
            raise ValueError(
                "this ProjectorSpec carries a ShardSpec, which needs a "
                "device mesh to realize — build "
                "DistributedProjector(spec, mesh) and pass that to the "
                "solver instead")
        return Projector(spec_or_projector, device=device)
    raise TypeError(
        f"expected a ProjectorSpec, Projector or DistributedProjector, "
        f"got {type(spec_or_projector).__name__}")

