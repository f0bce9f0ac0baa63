"""Optimizers, EMA and learning-rate schedules of the port, with the
reference package's semantics (``repro/optim``), on flat dicts of
tensors."""
from repro_torch.optim.adamw import (AdamWState, Optimizer, SGDState, adamw,
                                     apply_updates, clip_by_global_norm, sgd)
from repro_torch.optim.ema import (EmaState, ema_decay_schedule, ema_init,
                                   ema_params, ema_update)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)

__all__ = ["Optimizer", "AdamWState", "SGDState", "adamw", "sgd",
           "clip_by_global_norm", "apply_updates", "constant",
           "cosine_decay", "linear_warmup", "warmup_cosine", "EmaState",
           "ema_init", "ema_update", "ema_params", "ema_decay_schedule"]
