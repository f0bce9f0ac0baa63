"""Learning-rate schedules: pure functions of the 1-based integer step,
returning a 0-dim float32 tensor (a copy of the reference package's
``optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        frac = torch.clamp(_f32(step) / max(warmup_steps, 1), max=1.0)
        return (lr * frac).to(torch.float32)
    return f


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def f(step):
        t = torch.clamp(_f32(step) / max(decay_steps, 1), max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return (lr * ((1 - alpha) * cos + alpha)).to(torch.float32)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  alpha: float = 0.1):
    def f(step):
        s = _f32(step)
        w = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return (lr * w * ((1 - alpha) * cos + alpha)).to(torch.float32)
    return f
