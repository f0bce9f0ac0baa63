"""Iterative reconstruction on the matched projector pair.

Solvers accept a ``ProjectorSpec`` or ``Projector`` and return a
:class:`~repro_torch.recon.result.ReconResult`."""
from repro_torch.recon.result import ReconResult, as_projector
from repro_torch.recon.sirt import sirt

__all__ = ["ReconResult", "as_projector", "sirt"]
