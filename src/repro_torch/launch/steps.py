"""Prefill and serving step builders, the counterparts of the reference
package's ``launch/steps.py`` ``make_prefill_step`` and ``make_serve_step``.
``make_train_step`` comes with the LM training loop, on ``optim/``.

Both steps run without autograd, so a long prompt's attention takes the
forward-only flash kernel."""
from __future__ import annotations

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, backend: str = "auto"):
    """Forward over the full prompt; returns last-position logits (B, V).
    ``backend`` routes the long-sequence attention (``layers``)."""

    @torch.no_grad()
    def prefill(params, batch):
        x = MD.forward(cfg, params, batch["tokens"], batch.get("positions"),
                       backend)
        return MD.logits_fn(cfg, params, x[:, -1:])[:, 0]

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One greedy decode iteration: logits -> next token -> updated cache
    (in place)."""

    @torch.no_grad()
    def serve(params, cache, tokens, position):
        lg, cache = MD.decode_step(cfg, params, cache, tokens, position)
        return lg.argmax(dim=-1).to(torch.int32), lg, cache

    return serve
