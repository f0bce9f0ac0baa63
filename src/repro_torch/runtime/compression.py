"""Gradient compression for the (slow, inter-pod) data-parallel axis, the
counterpart of the reference package's ``runtime/compression.py``.

Error-feedback 1-bit sign compression (Seide et al. / Bernstein et al.):
the update transmitted per leaf is  sign(g + e) * mean|g + e|  and the
quantization residual e is carried to the next step.  Cuts the all-reduce's
bytes by ~32x against f32 (a sign bit a value and one f32 scale a leaf);
the residual keeps convergence.

Trees are nested dicts of tensors (a model's parameter tree or the flat
dicts of ``optim``); the state (the residuals, f32) has the gradients'
structure.  Usage: wrap the gradient tree before the optimizer::

    res = init_state(params)
    q, res = compress(grads, res)
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def init_state(params):
    """Zero residuals in f32, one per leaf of ``params``, on its device."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


@torch.no_grad()
def compress(grads, residual, leaf_sums=None) -> Tuple[dict, dict]:
    """Returns (decompressed-equivalent grads, new residual).

    The returned grads are what the receiving side reconstructs
    (sign * scale), in each gradient's dtype; in a real deployment only
    (sign bits, scale) cross the link, and the arithmetic here is the
    same.  ``leaf_sums`` (a sharded model's ``ParallelContext.leaf_sums``,
    on a flat dict of gradients) adds each leaf's sum of |x| and count over
    the ranks that split it, so that the scale is the whole leaf's
    ``mean |x|``."""
    if leaf_sums is not None:
        xs = {k: g.to(torch.float32) + residual[k] for k, g in grads.items()}
        st = leaf_sums({k: torch.stack([x.abs().sum(), torch.tensor(
            float(x.numel()), device=x.device)]) for k, x in xs.items()})
        qs = {k: torch.sign(x) * (st[k][0] / st[k][1]) for k, x in xs.items()}
        return ({k: q.to(grads[k].dtype) for k, q in qs.items()},
                {k: xs[k] - q for k, q in qs.items()})
    if isinstance(grads, dict):
        pairs = {k: compress(g, residual[k]) for k, g in grads.items()}
        return ({k: q for k, (q, _) in pairs.items()},
                {k: e for k, (_, e) in pairs.items()})
    x = grads.to(torch.float32) + residual
    q = torch.sign(x) * torch.mean(torch.abs(x))
    return q.to(grads.dtype), x - q


def compressed_bytes(params) -> int:
    """Bytes per step crossing the DP axis with 1-bit EF (sign bits + scale)."""
    return sum(math.ceil(p.numel() / 8) + 4 for p in _leaves(params))
