"""Optimizers with the reference package's semantics (``optim/adamw.py``),
as (init, update) pairs of plain functions on flat dicts of tensors (a
module's ``state_dict`` form)::

    opt = adamw(warmup_cosine(3e-4, 100, 1000))
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

This is not ``torch.optim.AdamW``: ``b2`` defaults to 0.95, the learning
rate is ``schedule(step)`` with ``step`` counted from 1 after the
increment, the update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
and the moments are kept in float32.  The step and the schedule's value
are 0-dim CPU tensors, so an update on the card reads nothing back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable      # (grads, state, params) -> (updates, state)


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-dim int32 on the CPU
    mu: dict
    nu: dict


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        zeros = {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
                 for k, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros,
                          nu={k: z.clone() for k, z in zeros.items()})

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr = schedule(step)
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g32 = g.to(state_dtype)
            m = b1 * state.mu[k] + (1 - b1) * g32
            v = b2 * state.nu[k] + (1 - b2) * torch.square(g32)
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.to(state_dtype))
            updates[k], mu[k], nu[k] = u.to(p.dtype), m, v
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: Optional[dict]


def sgd(schedule: Callable, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mom = ({k: torch.zeros_like(p) for k, p in params.items()}
               if momentum else None)
        return SGDState(step=torch.zeros((), dtype=torch.int32), mom=mom)

    @torch.no_grad()
    def update(grads, state: SGDState, params):
        step = state.step + 1
        lr = schedule(step)
        if momentum:
            mom = {k: momentum * state.mom[k] + g for k, g in grads.items()}
            return {k: -lr * m for k, m in mom.items()}, SGDState(step, mom)
        return {k: -lr * g for k, g in grads.items()}, SGDState(step, None)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, leaf_sums=lambda sq: sq):
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm before.  ``leaf_sums`` (a sharded model's
    ``ParallelContext.leaf_sums``; on one device the identity) adds each
    leaf's sum of squares over the ranks that split it, so that the norm
    is the whole model's."""
    sq = leaf_sums({k: torch.sum(torch.square(g.to(torch.float32)))
                    for k, g in grads.items()})
    gn = torch.sqrt(sum(sq.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gn
