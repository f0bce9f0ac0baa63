"""Deterministic, shardable, prefetching data pipelines (the reference
package's ``data/pipeline.py``).

Every batch is a pure numpy function of (seed, step, sample), so
* restarting from a checkpoint replays the stream exactly;
* each data-parallel worker generates only its shard;
* a background thread keeps one batch ahead of the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.core.geometry import CTGeometry
from repro_torch.data import phantoms


class _Prefetcher:
    """Iterates ``it`` on a daemon thread, ``depth`` items ahead."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


class CTDataPipeline:
    """Generates (phantom volume, view mask) training samples for the
    limited-angle / few-view experiments (paper §4).

    The mask randomizes the available angular range per sample: the paper's
    'augment diverse ill-posed inputs given the training projection data'.
    """

    def __init__(self, geom: CTGeometry, batch_size: int, seed: int = 0,
                 mode: str = "limited_angle", available_deg: float = 60.0,
                 n_views_few: int = 32, shard_index: int = 0,
                 shard_count: int = 1, start_step: int = 0):
        if batch_size % shard_count:
            raise ValueError(f"batch_size={batch_size} must be divisible by "
                             f"shard_count={shard_count} so every data shard "
                             f"gets an equal local batch")
        self.geom = geom
        self.global_batch = batch_size
        self.local_batch = batch_size // shard_count
        self.seed = seed
        self.mode = mode
        self.available_deg = available_deg
        self.n_views_few = n_views_few
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.step = start_step

    def _rng(self, step: int, sample: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, sample]))

    def make_mask(self, rng: np.random.Generator) -> np.ndarray:
        na = self.geom.n_angles
        mask = np.zeros((na,), np.float32)
        if self.mode == "limited_angle":
            n_avail = int(round(na * self.available_deg / 180.0))
            start = int(rng.integers(0, na))
            idx = (start + np.arange(n_avail)) % na
            mask[idx] = 1.0
        elif self.mode == "few_view":
            idx = rng.choice(na, size=self.n_views_few, replace=False)
            mask[idx] = 1.0
        else:
            mask[:] = 1.0
        return mask

    def sample(self, step: int, sample_id: int):
        """One (phantom, view mask) pair.  2D geometries (``vol.nz == 1``)
        get an ``(nx, ny)`` slice; volumetric ones (helical scans) an
        ``(nx, ny, nz)`` volume interpolated along z between two independent
        ellipse keyframes."""
        rng = self._rng(step, sample_id)
        vol = self.geom.vol
        if vol.nz == 1:
            img, _ = phantoms.random_ellipse_phantom(
                int(rng.integers(0, 2 ** 31)), vol)
        else:
            lo, _ = phantoms.random_ellipse_phantom(
                int(rng.integers(0, 2 ** 31)), vol)
            hi, _ = phantoms.random_ellipse_phantom(
                int(rng.integers(0, 2 ** 31)), vol)
            t = (np.arange(vol.nz, dtype=np.float32)
                 / max(vol.nz - 1, 1))[None, None, :]
            img = lo[:, :, None] * (1.0 - t) + hi[:, :, None] * t
        img = img * 0.02  # plausible attenuation scale (1/mm)
        mask = self.make_mask(rng)
        return img.astype(np.float32), mask

    def batch(self, step: int):
        """Local shard of the global batch for ``step``: numpy
        (images, masks)."""
        ids = (self.shard_index * self.local_batch
               + np.arange(self.local_batch))
        imgs, masks = zip(*(self.sample(step, int(i)) for i in ids))
        return np.stack(imgs), np.stack(masks)

    def __iter__(self):
        def gen():
            while True:
                b = self.batch(self.step)
                self.step += 1
                yield b
        return iter(_Prefetcher(gen()))

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: dict):
        if d["seed"] != self.seed:
            raise ValueError(f"data seed mismatch on restore: checkpoint has "
                             f"seed={d['seed']}, pipeline was built with "
                             f"seed={self.seed}; restoring would silently "
                             f"replay a different data stream")
        self.step = int(d["step"])
