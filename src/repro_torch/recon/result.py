"""Uniform solver result + input coercion for the recon layer.

Every iterative solver returns a :class:`ReconResult` and accepts either a
:class:`~repro_torch.core.spec.ProjectorSpec` or an already-built
:class:`~repro_torch.core.projector.Projector`; ``sirt`` and ``cgls`` also
take a :class:`~repro_torch.core.distributed.DistributedProjector`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.projector import Projector
from repro_torch.core.spec import ProjectorSpec

__all__ = ["ReconResult", "as_projector", "as_local_projector"]


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


def as_local_projector(spec_or_projector, what: str,
                       device: Optional[torch.device] = None) -> Projector:
    """:func:`as_projector` for the solvers that run on one device only:
    ``fista_tv``'s TV term and the completion helpers take z differences
    and whole-volume steps that cross slabs, so a ``DistributedProjector``
    raises ``NotImplementedError``."""
    projector = as_projector(spec_or_projector, device)
    if not isinstance(projector, Projector):
        raise NotImplementedError(
            f"{what} on a DistributedProjector is not ported: its z "
            f"differences cross slabs (ROADMAP.md, queue 1); sirt and cgls "
            f"run distributed")
    return projector
