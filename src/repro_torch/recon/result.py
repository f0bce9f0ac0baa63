"""Uniform solver result + input coercion for the recon layer.

Every iterative solver returns a :class:`ReconResult` and accepts either a
:class:`~repro_torch.core.spec.ProjectorSpec` or an already-built
:class:`~repro_torch.core.projector.Projector`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

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


def as_projector(spec_or_projector: Union[ProjectorSpec, Projector],
                 device: Optional[torch.device] = None) -> Projector:
    """Coerce a solver's operator argument to a :class:`Projector`.  A spec
    is realized on ``device`` (the solver passes its data's device); a
    prebuilt projector passes through."""
    if isinstance(spec_or_projector, Projector):
        return spec_or_projector
    if isinstance(spec_or_projector, ProjectorSpec):
        return Projector(spec_or_projector, device=device)
    raise TypeError(
        f"expected a ProjectorSpec or Projector, "
        f"got {type(spec_or_projector).__name__}")
