"""Synthetic token stream for exercising the LM-architecture configs (a copy
of the reference package's ``data/tokens.py``: numpy only, so both packages
draw the same tokens from the same seed).

Deterministic function of (seed, step, shard); tokens are Zipf-distributed
with a repeating-ngram structure so the loss is learnable."""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1,
                 start_step: int = 0):
        if global_batch % shard_count:
            raise ValueError(f"global_batch={global_batch} must be divisible "
                             f"by shard_count={shard_count} so every data "
                             f"shard gets an equal local batch")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // shard_count
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.step = start_step

    def batch(self, step: int = None) -> np.ndarray:
        step = self.step if step is None else step
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_index]))
        b, t, v = self.local_batch, self.seq_len, self.vocab_size
        # zipf-ish marginal over a capped alphabet + copied spans
        probs = 1.0 / np.arange(1, min(v, 4096) + 1) ** 1.1
        probs /= probs.sum()
        toks = rng.choice(len(probs), size=(b, t), p=probs).astype(np.int32)
        # repeat a prefix span to give the model something to learn
        span = max(4, t // 16)
        toks[:, span:2 * span] = toks[:, :span]
        return toks % v

    def __iter__(self):
        while True:
            yield self.batch()
            self.step += 1

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d):
        self.step = int(d["step"])
