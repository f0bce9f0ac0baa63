"""Batched serving: continuous-batching greedy decode, the
counterpart of the reference package's ``launch/serve.py``: on one device,
or on a mesh (``launch/mesh``), each rank holding its shards of the
weights (``launch/sharding``) and its heads' KV cache.

A slot-based scheduler keeps a fixed-shape decode batch full (finished
sequences free their slot for the next queued request), with per-request
max-token / EOS stopping and step-time telemetry.  Prompts are prefilled
token by token through the decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --device cpu --requests 8 --batch-slots 4 --max-new 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import model as MD


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Fixed-slot continuous batching.  Each slot holds one request; the
    KV/SSM cache is (layers, slots, ...) and slots are recycled as requests
    finish (a slot's lanes of every cache entry zeroed on admission).
    ``params`` is a parameter tree on ``device`` (the full one); without
    one the server initializes its own from ``seed``.  The server keeps the
    weights cast to the compute dtype once (``model.compute_params``).

    On a ``mesh`` (every rank of it builds the same ``Server`` and submits
    the same requests) each rank keeps its shards of the weights and its
    heads' cache (``sharding.cache_specs``); the data axes split the
    slots, each data rank decoding its own, and the next tokens are
    all-gathered over them, so that every rank schedules the same way and
    emits the same greedy tokens."""

    def __init__(self, cfg, mesh=None, slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0, device=None,
                 params: Optional[dict] = None):
        self.cfg = cfg
        self.device = resolve_device(device, "Server")
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.mesh = mesh
        self.ac = None if mesh is None else sharding.make_ac(mesh, cfg)
        dp = 1 if self.ac is None else self.ac.dp
        if slots % dp:
            raise ValueError(f"{slots} slots do not split over {dp} data ranks")
        self._local = slots // dp
        self._lo = 0 if self.ac is None else self.ac.data_rank * self._local
        self._step = make_serve_step(cfg, self.ac)
        self.load_params(params if params is not None else MD.init_params(
            cfg, torch.Generator(device=self.device).manual_seed(seed)))
        self.cache = MD.init_cache(cfg, self._local, max_len, self.device, self.ac)
        self.positions = np.zeros(slots, np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.steps = 0

    def load_params(self, params):
        """``params``: the full tree (a rank keeps its shards)."""
        if self.ac is not None:
            params = sharding.shard_params(self.cfg, params, self.mesh,
                                           specs=self.ac.specs)
        self.params = MD.compute_params(self.cfg, params)

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                self.active[s] = self.queue.pop(0)
                self.positions[s] = 0
                if self._lo <= s < self._lo + self._local:
                    for c in self.cache.values():  # reset this slot's lanes
                        c[:, s - self._lo] = 0

    def _slot_token(self, s: int) -> int:
        req = self.active[s]
        if req is None:
            return 0
        pos = int(self.positions[s])
        if pos < len(req.prompt):
            return req.prompt[pos]
        if req.out:
            return req.out[-1]
        return req.prompt[-1]

    def step(self) -> bool:
        """One synchronous decode step across all slots."""
        self._admit()
        if not any(self.active):
            return False
        mine = range(self._lo, self._lo + self._local)
        toks = torch.tensor([self._slot_token(s) for s in mine],
                            dtype=torch.int64, device=self.device)
        if self.cfg.n_codebooks > 1:
            # as the reference: every codebook fed the request's token, the
            # first codebook's greedy token kept
            toks = toks[:, None].expand(self._local, self.cfg.n_codebooks)
        pos = torch.from_numpy(self.positions[self._lo:self._lo + self._local]
                               ).to(self.device)
        nxt, _, self.cache = self._step(self.params, self.cache, toks, pos)
        if self.ac is not None and self.ac.dp > 1:
            nxt = self.ac._all_gather(nxt, 0, "data")
        nxt = nxt.cpu().numpy()
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            self.positions[s] += 1
            pos_s = int(self.positions[s])
            if pos_s >= len(req.prompt):       # generating
                tok = int(nxt[s, 0] if nxt.ndim > 1 else nxt[s])
                req.out.append(tok)
                if (len(req.out) >= req.max_new
                        or (self.eos_id is not None and tok == self.eos_id)
                        or pos_s >= self.max_len - 1):
                    req.done = True
                    self.active[s] = None
        self.steps += 1
        return True

    def run(self) -> List[Request]:
        pending = list(self.queue)
        t0 = time.perf_counter()
        while self.step():
            pass
        dt = time.perf_counter() - t0
        finished = [r for r in pending if r.done]
        if self.steps:
            print(f"[serve] {self.steps} steps, "
                  f"{dt / max(self.steps, 1) * 1e3:.1f} ms/step, "
                  f"{len(finished)} requests")
        return finished


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    srv = Server(cfg, slots=args.batch_slots, max_len=128, device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(3, 10)).tolist()
        srv.submit(Request(rid, prompt, args.max_new))
    done = srv.run()
    for r in done[:4]:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")


if __name__ == "__main__":
    main()
