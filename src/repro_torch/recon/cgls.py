"""CGLS — conjugate gradient on the normal equations A^T A x = A^T y.

Mathematically requires the backprojector to be the *exact* adjoint of the
forward projector; with unmatched pairs CG diverges (Zeng & Gullberg 2000) —
the argument for matched pairs.  Supports Tikhonov damping: min ||Ax - y||^2
+ damp ||x||^2, and a ``mask`` restricting the data term to measured rays.

Leading batch dims on ``y`` run independent CG iterations side by side:
every inner product reduces over the three trailing image/sinogram axes
only (keepdim, so the per-sample step sizes broadcast), and one sample at
a time, so that a packed batch gives each sample the bits it gets alone.
A reduction over a ``(batch, ...)`` tensor does not: the device's
reduction splits its work by the number of outputs, and CG's iterations
amplify the last-bit difference (to 4e-4 relative after 20 iterations of
a 1126-column fan scan on an H100, PERF.md).  Under a
:class:`~repro_torch.core.distributed.DistributedProjector` each rank holds
its pieces, and each inner product sums over every rank's pieces of the
sinogram or the volume (``reduce_partial``).
"""
from __future__ import annotations

import torch

from repro_torch.recon.result import ReconResult, as_projector

_IMG_AXES = (-3, -2, -1)


def _dot(a: torch.Tensor, b: torch.Tensor, projector, space: str
         ) -> torch.Tensor:
    """Per-sample inner product over the 3 trailing axes, kept broadcastable;
    each sample reduced on its own (batch-invariant bits), then summed over
    every rank's pieces of the ``space`` ("sino" or "vol") they live in."""
    lead = a.shape[:-3]
    a3, b3 = a.reshape((-1,) + a.shape[-3:]), b.reshape((-1,) + b.shape[-3:])
    out = torch.stack([torch.sum(x * y) for x, y in zip(a3, b3)])
    return projector.reduce_partial(out, space).reshape(lead + (1, 1, 1))


def cgls(spec_or_projector, y: torch.Tensor, n_iters: int = 30, x0=None,
         damp: float = 0.0, mask=None) -> ReconResult:
    """Reconstruct from sinogram ``y``.  A spec runs on ``y``'s device."""
    projector = as_projector(spec_or_projector, y.device)
    A = (lambda x: projector(x) * mask) if mask is not None else projector
    AT = (lambda r: projector.T(r * mask)) if mask is not None else projector.T

    batch_dims = y.shape[:-3]
    x = (torch.zeros(batch_dims + projector.local_vol_shape(), dtype=y.dtype,
                     device=y.device) if x0 is None else x0)
    r = y - A(x)
    if mask is not None:
        r = r * mask
    s = AT(r) - damp * x
    p = s
    gamma = _dot(s, s, projector, "vol")
    hist = []
    for _ in range(n_iters):
        q = A(p)
        delta = (_dot(q, q, projector, "sino")
                 + damp * _dot(p, p, projector, "vol"))
        alpha = gamma / torch.clamp(delta, min=1e-30)
        x = x + alpha * p
        r = r - alpha * q
        s = AT(r) - damp * x
        gamma_new = _dot(s, s, projector, "vol")
        beta = gamma_new / torch.clamp(gamma, min=1e-30)
        p = s + beta * p
        gamma = gamma_new
        hist.append(torch.sqrt(_dot(r, r, projector, "sino")[..., 0, 0, 0]))
    return ReconResult(image=x, iterations=n_iters,
                       residual_history=torch.stack(hist, dim=-1))
