"""Training, prefill and serving step builders, the counterparts of the
reference package's ``launch/steps.py``.

The prefill and serving steps run without autograd, so a long prompt's
attention takes the forward-only flash kernel; the training step's takes
the forward with statistics and the two backward kernels."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (Optimizer, apply_updates,
                                     clip_by_global_norm)


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                   backend: str = "auto", ac=None):
    """``(loss, grads)`` of ``MD.loss_fn`` at ``params`` (a model tree, a
    rank's shards under ``ac``): the loss detached, the gradients as a flat
    dict (``MD.flatten``'s keys) in the parameters' dtype."""
    leaves = {k: t.detach().requires_grad_()
              for k, t in MD.flatten(params).items()}
    loss = MD.loss_fn(cfg, MD.unflatten(leaves), batch, backend, ac)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(cfg: ModelConfig, opt: Optimizer, ac=None,
                    grad_accum: Optional[int] = None, clip_norm: float = 1.0,
                    compress_fn: Optional[Callable] = None,
                    backend: str = "auto"):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``.

    ``params`` is a model tree (``MD.init_params``); ``opt_state`` is
    ``opt.init(MD.flatten(params))``, since ``optim`` works on flat dicts;
    ``batch`` holds ``tokens`` (B, S) or (B, nq, S), and optionally
    ``vision_embeds`` and ``positions`` (``MD.loss_fn``).  ``grad_accum``
    (None: the config's) splits the batch into that many microbatches of
    consecutive rows, run one after the other: the gradients are summed as
    ``g / grad_accum`` in microbatch order, and ``metrics["loss"]`` is the
    last microbatch's loss, as in the reference (not the mean over the
    microbatches).  Then, in order: under ``ac``, the data-parallel mean
    over ranks (``ac.mean_grads``), ``compress_fn(grads) -> grads`` (e.g.
    ``runtime/compression``), clipping to ``clip_norm`` (``grad_norm`` is
    the norm before it), the optimizer update and ``apply_updates``.  ``backend`` routes the
    long-sequence attention (``models/layers``).

    ``ac`` (the reference's argument) is a rank's
    ``launch/sharding.ParallelContext``: ``params`` and ``opt_state`` are
    then the rank's shards, and the clipping norm adds each leaf's squares
    over the ranks that split it (``ac.leaf_sums``); a ``compress_fn``
    that should see whole leaves takes them from ``ac`` too
    (``launch/train.build``)."""
    if grad_accum is None:
        grad_accum = cfg.grad_accum

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(cfg, params, batch, backend, ac)
        else:
            n = batch["tokens"].shape[0]
            if n % grad_accum:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"grad_accum={grad_accum} microbatches")
            per = n // grad_accum
            grads = None
            for j in range(grad_accum):
                # positions under M-RoPE are (3, B, S): rows on axis 1
                mb = {k: (v[:, j * per:(j + 1) * per] if k == "positions"
                          else v[j * per:(j + 1) * per]) for k, v in batch.items()}
                loss, g = value_and_grad(cfg, params, mb, backend, ac)
                grads = ({k: v / grad_accum for k, v in g.items()}
                         if grads is None else
                         {k: grads[k] + g[k] / grad_accum for k in grads})
        if ac is not None:
            loss, grads = ac.mean_grads(loss, grads)
        if compress_fn is not None:
            grads = compress_fn(grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, *(
            () if ac is None else (ac.leaf_sums,)))
        flat = MD.flatten(params)
        updates, opt_state = opt.update(grads, opt_state, flat)
        params = MD.unflatten(apply_updates(flat, updates))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_prefill_step(cfg: ModelConfig, ac=None, backend: str = "auto"):
    """Forward over the full prompt (``tokens``, and optionally
    ``vision_embeds`` and ``positions``); returns last-position logits (B,
    V), of the first codebook for multi-codebook, all-gathered over V under
    a vocab-parallel ``ac``.  ``backend`` routes the long-sequence
    attention (``layers``)."""

    @torch.no_grad()
    def prefill(params, batch):
        x = MD.forward(cfg, params, batch["tokens"], batch.get("positions"),
                       backend, batch.get("vision_embeds"), ac)
        lg = MD.logits_fn(cfg, params, x[:, -1:], ac=ac)[:, 0]
        return ac.gather_model(lg, -1) if ac is not None and ac.split["vocab"] else lg

    return prefill


def make_serve_step(cfg: ModelConfig, ac=None):
    """One greedy decode iteration: logits -> next token -> updated cache
    (in place).  The tokens are (B,), or (B, n_codebooks) for
    multi-codebook; under ``ac`` every rank of the model group gets the
    whole logits and the same token."""

    @torch.no_grad()
    def serve(params, cache, tokens, position):
        lg, cache = MD.decode_step(cfg, params, cache, tokens, position, ac)
        return lg.argmax(dim=-1).to(torch.int32), lg, cache

    return serve
