"""FISTA with total-variation regularization:

    min_x  0.5 ||A x - y||^2 + beta * TV(x)

Gradient step through the matched pair (the gradient of the data term is
exactly A^T(Ax - y)); TV proximal step via the dual (Chambolle-style)
projection, a fixed small number of inner iterations.  The Lipschitz constant
of A^T A is estimated matrix-free by power iteration.

All TV operators address the trailing (nx, ny, nz) axes, so leading batch
dims on ``y`` solve a packed batch of independent problems (the momentum
schedule t_k is data-independent and shared).

The TV proximal step differences x and y only, per z slice, so on a
:class:`~repro_torch.core.distributed.DistributedProjector` each rank runs
it on its own z slab with no halo; the power iteration's norm and the
residual history are sums over every rank's pieces (``reduce_partial``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.recon.result import ReconResult, as_projector

_IMG_AXES = (-3, -2, -1)


def tv_norm(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV over the trailing volume axes (per-sample for batches).
    A reporting helper that no solver calls: on a rank's z slab it counts
    only the slab's own z differences, not those across its faces."""
    out = (torch.abs(torch.diff(x, dim=-3)).sum(dim=_IMG_AXES)
           + torch.abs(torch.diff(x, dim=-2)).sum(dim=_IMG_AXES))
    if x.shape[-1] > 1:
        out = out + torch.abs(torch.diff(x, dim=-1)).sum(dim=_IMG_AXES)
    return out


def _grad_op(x: torch.Tensor):
    """Forward differences along x and y, zero at the far edge."""
    gx = torch.cat([torch.diff(x, dim=-3), torch.zeros_like(x[..., :1, :, :])],
                   dim=-3)
    gy = torch.cat([torch.diff(x, dim=-2), torch.zeros_like(x[..., :, :1, :])],
                   dim=-2)
    return gx, gy


def _div_op(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Minus the adjoint of :func:`_grad_op`."""
    dx = px - torch.cat([torch.zeros_like(px[..., :1, :, :]),
                         px[..., :-1, :, :]], dim=-3)
    dy = py - torch.cat([torch.zeros_like(py[..., :, :1, :]),
                         py[..., :, :-1, :]], dim=-2)
    return dx + dy


def tv_prox(x: torch.Tensor, weight, n_inner: int = 10) -> torch.Tensor:
    """prox_{weight * TV}(x) via dual projection (2D TV applied per z-slice)."""
    tau = 0.25
    weight = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    scaled = x / torch.clamp(weight, min=1e-12)
    px, py = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(n_inner):
        gx, gy = _grad_op(_div_op(px, py) * weight - scaled)
        px = px - tau * gx
        py = py - tau * gy
        mag = torch.clamp(torch.sqrt(px ** 2 + py ** 2), min=1.0)
        px, py = px / mag, py / mag
    return x - weight * _div_op(px, py)


def power_iteration(spec_or_projector, n_iters: int = 10, seed: int = 0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Largest eigenvalue of A^T A (matrix-free), from a standard normal
    start over the global volume drawn with ``generator`` (default: a
    generator on the projector's device seeded with ``seed``).  On a
    ``DistributedProjector`` each rank takes its slab of that start
    (``shard_volume``), so every rank runs the iteration one device would;
    the draw holds the whole volume on each rank's device for a moment, so
    a volume that only fits sharded needs ``fista_tv``'s ``L`` given.
    The reference package draws its start with ``jax.random``, so the two
    agree only as estimates of one eigenvalue, not bit for bit."""
    from repro_torch.core.distributed import DistributedProjector
    projector = as_projector(spec_or_projector)
    dev = projector.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(projector.vol_shape(), generator=generator,
                    device=generator.device).to(dev)
    if isinstance(projector, DistributedProjector):
        x = projector.shard_volume(x)
    nrm = None
    for _ in range(n_iters):
        z = projector.T(projector(x))
        nrm = torch.sqrt(projector.reduce_partial(torch.sum(z * z), "vol"))
        x = z / torch.clamp(nrm, min=1e-30)
    return nrm


def fista_tv(spec_or_projector, y: torch.Tensor, n_iters: int = 50,
             beta: float = 1e-3, x0=None, mask=None, L=None,
             nonneg: bool = True, tv_inner: int = 10) -> ReconResult:
    """Reconstruct from sinogram ``y``.  ``L`` is the Lipschitz constant of
    A^T A (None: 1.05 x :func:`power_iteration`).  A spec runs on ``y``'s
    device; on a ``DistributedProjector`` ``y``, ``x0`` and ``mask`` are
    this rank's pieces and the image is its slab."""
    projector = as_projector(spec_or_projector, y.device)
    if L is None:
        # The Lipschitz constant of A^T A is a property of the operator, not
        # the data — one unbatched power iteration covers a packed batch.
        L = power_iteration(projector) * 1.05
    step = 1.0 / L
    batch_dims = y.shape[:-3]
    x = (torch.zeros(batch_dims + projector.local_vol_shape(), dtype=y.dtype,
                     device=y.device) if x0 is None else x0)
    z, t = x, torch.tensor(1.0, dtype=y.dtype, device=y.device)
    hist = []
    for _ in range(n_iters):
        r = projector(z) - y
        if mask is not None:
            r = r * mask
        g = projector.T(r)
        xn = tv_prox(z - step * g, beta * step, tv_inner)
        if nonneg:
            xn = torch.clamp(xn, min=0.0)
        tn = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        z = xn + ((t - 1.0) / tn) * (xn - x)
        x, t = xn, tn
        hist.append(torch.sqrt(projector.reduce_partial(
            torch.sum(torch.square(r), dim=_IMG_AXES), "sino")))
    return ReconResult(image=x, iterations=n_iters,
                       residual_history=torch.stack(hist, dim=-1))
