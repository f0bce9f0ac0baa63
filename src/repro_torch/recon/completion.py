"""Sinogram completion + data-consistency refinement.

The inference-time pipeline for limited-angle and few-view CT:

1. a trained network predicts a volume  x_net  from the ill-posed input;
2. the *measured* views are kept and the missing views are filled from the
   forward projection of the prediction;
3. an iterative data-consistency step refines the volume against the
   measured data while staying close to the network prior:

       min_x  0.5 || M (A x - y) ||^2  +  0.5 * beta || x - x_net ||^2

   solved by CG (the objective is quadratic; gradients use the matched pair).

The CG inner products run over every axis, leading batch dims included, as
the reference package's ``jnp.vdot`` does, and over every rank's pieces
(``reduce_partial``) on a
:class:`~repro_torch.core.distributed.DistributedProjector`, where ``x_net``,
``y`` and ``mask`` are this rank's pieces.
"""
from __future__ import annotations

import torch

from repro_torch.recon.result import as_projector


def data_consistency_refine(spec_or_projector, x_net: torch.Tensor,
                            y: torch.Tensor, mask, n_iters: int = 20,
                            beta: float = 0.1) -> torch.Tensor:
    """CG on  (A^T M A + beta I) x = A^T M y + beta x_net.  A spec runs on
    ``y``'s device."""
    projector = as_projector(spec_or_projector, y.device)

    def op(x):
        return projector.T(mask * projector(x)) + beta * x

    def vdot(a, b):
        return projector.reduce_partial(torch.sum(a * b), "vol")

    b = projector.T(mask * y) + beta * x_net
    x = x_net
    r = b - op(x)
    p = r
    rs = vdot(r, r)
    for _ in range(n_iters):
        q = op(p)
        alpha = rs / torch.clamp(vdot(p, q), min=1e-30)
        x = x + alpha * p
        r = r - alpha * q
        rs_new = vdot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


def complete_and_refine(spec_or_projector, x_net: torch.Tensor,
                        y: torch.Tensor, mask, n_iters: int = 20,
                        beta: float = 0.1):
    """The full inference pipeline.  Returns (x_refined, completed_sino)."""
    projector = as_projector(spec_or_projector, y.device)
    x = data_consistency_refine(projector, x_net, y, mask, n_iters, beta)
    completed = mask * y + (1.0 - mask) * projector(x)
    return x, completed


def projection_residual(spec_or_projector, x: torch.Tensor, y: torch.Tensor,
                        mask=None) -> torch.Tensor:
    """Relative projection-consistency residual ``||M (A x - y)|| / ||M y||``:
    0 means the reconstruction explains every measured view exactly, 1 that
    it explains nothing — comparable across geometries and phantom scales."""
    projector = as_projector(spec_or_projector, y.device)
    r = projector(x) - y
    if mask is not None:
        r = r * mask
        y = y * mask
    num = torch.sqrt(projector.reduce_partial(torch.sum(torch.square(r)), "sino"))
    den = torch.clamp(torch.sqrt(projector.reduce_partial(
        torch.sum(torch.square(y)), "sino")), min=1e-12)
    return num / den
