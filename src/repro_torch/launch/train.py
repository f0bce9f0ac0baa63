"""Data-parallel projector-in-the-loop CT training step, the counterpart of
the reference package's ``launch/train.py`` ``make_ct_dp_train_step``.

    step = make_ct_dp_train_step(spec, mesh, apply_fn, lr=1e-3)
    params, loss = step(params, y)       # on every rank of the mesh

The rest of the reference's ``launch/train.py`` (the language model's
training driver) is not ported here.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core.projector import Projector
from repro_torch.launch.mesh import pmean

__all__ = ["make_ct_dp_train_step"]


def make_ct_dp_train_step(spec, mesh, apply_fn: Callable, lr: float = 1e-3,
                          axis: str = "data",
                          device: Optional[Union[str, torch.device]] = None):
    """Data-parallel projector-in-the-loop CT train step on ``mesh``.

    ``apply_fn(params, y) -> volume(s)`` is the recon network; the loss is
    the projection-consistency term ``0.5 * mean (A x - y)^2`` with the
    differentiable forward projector inside the graph, so gradients flow
    through the matched pair.  Each rank runs the whole projector on its
    contiguous slice of the batch (classic data parallelism: the projector
    stays local; a ``DistributedProjector`` is for a *volume* that outgrows
    a device), then the gradients and the loss are averaged over ``axis``'s
    group.  Returns ``step(params, y) -> (params, loss)``: ``params`` a dict
    of tensors, replicated; ``y`` the global batch, the same on every rank;
    the SGD update ``p - lr * g``.  ``mesh=None`` runs the step on one
    device.  ``device=None`` means ``cuda``."""
    if getattr(spec, "shard", None) is not None:
        spec = spec.replace(shard=None)
    proj = Projector(spec, device)
    if mesh is not None:
        n, k = mesh.shape[axis], mesh.coord(axis)

    def step(params: Dict[str, torch.Tensor], y: torch.Tensor):
        if mesh is not None:
            if y.shape[0] % n:
                raise ValueError(f"batch={y.shape[0]} must divide over the "
                                 f"{n}-way {axis} axis")
            per = y.shape[0] // n
            y = y[k * per:(k + 1) * per]
        leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
        loss = proj.data_consistency(apply_fn(leaves, y), y)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
        if mesh is not None:
            loss, grads = pmean(mesh, axis, loss, grads)
        return {name: p - lr * grads[name] for name, p in params.items()}, loss

    return step
