"""Iterative reconstruction on the matched projector pair.

Solvers accept a ``ProjectorSpec`` or ``Projector`` and return a
:class:`~repro_torch.recon.result.ReconResult`; the completion helpers
return tensors."""
from repro_torch.recon.result import ReconResult, as_projector
from repro_torch.recon.sirt import sirt
from repro_torch.recon.cgls import cgls
from repro_torch.recon.fista_tv import fista_tv, power_iteration, tv_norm
from repro_torch.recon.completion import (complete_and_refine,
                                          data_consistency_refine,
                                          projection_residual)

__all__ = ["ReconResult", "as_projector", "sirt", "cgls", "fista_tv",
           "power_iteration", "tv_norm", "complete_and_refine",
           "data_consistency_refine", "projection_residual"]
