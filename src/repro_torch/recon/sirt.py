"""SIRT — Simultaneous Iterative Reconstruction Technique.

x_{k+1} = x_k + lam * C (.) A^T [ R (.) (y - A x_k) ]

with R = 1/row-sums(A), C = 1/col-sums(A) computed matrix-free by projecting
constant images (the system matrix is never materialized).  Relies on the
*matched* A/A^T pair for convergence stability over many iterations.

Leading batch dims on ``y`` are reconstructed jointly: every update is
elementwise or goes through the batch-aware projector, which packs the batch
onto the kernels' lane axis.  Under a
:class:`~repro_torch.core.distributed.DistributedProjector` each rank runs
the loop on its own pieces (``y`` is its piece of the sinogram) and the
residual norms sum over every rank's pieces (``reduce_partial``), so the
history matches the single-device run.
"""
from __future__ import annotations

import torch

from repro_torch.recon.result import ReconResult, as_projector

_EPS = 1e-6

_IMG_AXES = (-3, -2, -1)


def _res_norm(r: torch.Tensor, projector) -> torch.Tensor:
    """Per-sample data-residual norm over the 3 sinogram axes (over every
    rank's pieces under a distributed projector)."""
    return torch.sqrt(projector.reduce_partial(
        torch.sum(torch.square(r), dim=_IMG_AXES), "sino"))


def _safe_inv(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > _EPS, 1.0 / torch.clamp(a, min=_EPS), 0.0)


def sirt(spec_or_projector, y: torch.Tensor, n_iters: int = 50, x0=None,
         lam: float = 1.0, nonneg: bool = True, mask=None) -> ReconResult:
    """Reconstruct from sinogram ``y``.  ``mask`` (optional, broadcastable to
    y) restricts the data term to measured rays (limited-angle / few-view).
    A spec runs on ``y``'s device."""
    projector = as_projector(spec_or_projector, y.device)
    vol_shape = projector.local_vol_shape()
    batch_dims = y.shape[:-3]
    ones_v = torch.ones(vol_shape, dtype=y.dtype, device=y.device)
    ones_s = (torch.ones(projector.local_sino_shape(), dtype=y.dtype,
                         device=y.device) if mask is None else mask)
    rinv = _safe_inv(projector(ones_v))           # 1 / A 1
    cinv = _safe_inv(projector.T(ones_s))         # 1 / A^T 1 (masked)
    if mask is not None:
        rinv = rinv * mask
    x = (torch.zeros(batch_dims + vol_shape, dtype=y.dtype,
                     device=y.device) if x0 is None else x0)
    hist = []
    for _ in range(n_iters):
        r = y - projector(x)
        if mask is not None:
            r = r * mask
        x = x + lam * cinv * projector.T(rinv * r)
        if nonneg:
            x = torch.clamp(x, min=0.0)
        hist.append(_res_norm(r, projector))
    return ReconResult(image=x, iterations=n_iters,
                       residual_history=torch.stack(hist, dim=-1))
