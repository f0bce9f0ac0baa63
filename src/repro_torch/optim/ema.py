"""Exponential moving average of parameters (the evaluation weights), with
the reference package's semantics (``optim/ema.py``)::

    ema = ema_init(params)
    ema = ema_update(ema, params, decay=0.999)      # once per train step
    metrics = evaluate(ema_params(ema), ...)        # eval on the average

The effective decay ramps as ``min(decay, (1 + t) / (warmup + t))`` at
update ``t`` (1-based), and the average is formed in float32 and cast back
to each parameter's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EmaState(NamedTuple):
    step: torch.Tensor    # 0-dim int32 on the CPU: updates applied
    params: dict          # the averaged tensors, keyed as the parameters


def ema_init(params) -> EmaState:
    """Start the average at the current parameters (a copy; not zeros, which
    would need bias correction wherever the average is read)."""
    return EmaState(step=torch.zeros((), dtype=torch.int32),
                    params={k: p.detach().clone() for k, p in params.items()})


def ema_decay_schedule(step, decay: float, warmup: int) -> torch.Tensor:
    """Effective decay at update ``step`` (1-based), warmed up from ~0."""
    t = torch.as_tensor(step).to(torch.float32)
    return torch.minimum(torch.tensor(decay, dtype=torch.float32),
                         (1.0 + t) / (float(warmup) + t))


@torch.no_grad()
def ema_update(state: EmaState, params, decay: float = 0.999,
               warmup: int = 10) -> EmaState:
    """One EMA step: ``avg <- d * avg + (1 - d) * params`` with the
    warmed-up ``d``."""
    if not 0.0 <= decay < 1.0:
        raise ValueError(f"decay must be in [0, 1), got {decay}")
    if warmup < 1:
        raise ValueError(f"warmup must be >= 1, got {warmup}")
    step = state.step + 1
    d = ema_decay_schedule(step, decay, warmup)
    avg = {k: (d * a.to(torch.float32)
               + (1.0 - d) * params[k].to(torch.float32)).to(a.dtype)
           for k, a in state.params.items()}
    return EmaState(step=step, params=avg)


def ema_params(state: EmaState) -> dict:
    """The averaged parameters (what evaluation should consume)."""
    return state.params
