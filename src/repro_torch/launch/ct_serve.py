"""Recon-as-a-service: geometry-bucketed dynamic batching of CT requests on
one card, the counterpart of the reference package's
``launch/ct_serve.py``.

A scanner farm produces a stream of small reconstruction jobs, most sharing
a handful of protocol geometries.  The server

  * **buckets** incoming requests by ``(tier, solver, spec.bucket_key(),
    solver kwargs)``: two requests share a packed batch only when their
    :class:`~repro_torch.core.spec.ProjectorSpec` keys are equal (the same
    geometry content, kernels, mode and precision) and their solvers and
    settings are the same;
  * **packs** a bucket's requests into one batched dispatch, zero-padded to
    a power-of-two *size class* (at most ``max_batch``): the lane-packed
    kernels fold ``batch x n_rows`` onto their lane axis, so a pack of
    single-row 2D recons runs each projection as one launch per view group;
  * serves **tiered latency classes**: ``interactive`` (single-shot
    FBP / FDK) is dispatched strictly before ``quality`` (the iterative
    sirt / cgls / fista_tv);
  * keeps a **warm request path**: :meth:`CTServer.warm` runs each bucket's
    executor once at every size class on the device, which fills the op
    cache, builds and loads the kernel libraries, moves the plans' tables
    to the card, resolves each lane count's kernel configuration (the
    autotuner's disk cache, ``~/.cache/repro_torch/tune.json``, is read
    before any sweep) and computes FISTA-TV's Lipschitz constant once a
    bucket.  A warmed server then answers traffic with no library built or
    loaded (``repro_torch.kernels.build.loaded``), no op-cache miss
    (``repro_torch.kernels.ops.cache_stats``), no new executor and no
    autotune sweep (``repro_torch.kernels.tune.sweep_count``);
  * **isolates failures** per request: a request that fails validation, or
    whose batch's executor raises, is answered with ``ok=False`` and its
    error; its batch mates are re-run one by one and still succeed.

    >>> srv = CTServer(max_batch=16)          # on "cuda"; device="cpu" asks
    >>> srv.warm(spec, "fbp")                 # for the host
    >>> rid = srv.submit(ReconRequest(spec=spec, sino=y, solver="fbp"))
    >>> done = srv.drain()
    >>> done[rid].image                       # a CPU tensor

A batch is packed with one host stack and one transfer (or one
``torch.stack`` where every sinogram is already on the server's device)
and unpacked with one device-to-host copy; responses hold CPU tensors.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.projector import Projector
from repro_torch.core.spec import ProjectorSpec
from repro_torch.device import resolve_device
from repro_torch.recon import cgls, fista_tv, sirt
from repro_torch.recon.fista_tv import power_iteration
from repro_torch.recon.result import ReconResult

__all__ = ["ReconRequest", "ReconResponse", "CTServer", "TIERS",
           "TIER_SOLVERS", "solver_tier"]

# Latency classes, in strict dispatch-priority order.
TIERS = ("interactive", "quality")
TIER_SOLVERS = {
    "interactive": ("fbp",),                      # single-shot FBP / FDK
    "quality": ("sirt", "cgls", "fista_tv"),      # iterative
}
_SOLVERS = {"sirt": sirt, "cgls": cgls, "fista_tv": fista_tv}


def solver_tier(solver: str) -> str:
    for tier, names in TIER_SOLVERS.items():
        if solver in names:
            return tier
    raise ValueError(f"unknown solver {solver!r}; expected one of "
                     f"{sorted(n for v in TIER_SOLVERS.values() for n in v)}")


@dataclasses.dataclass
class ReconRequest:
    """One reconstruction job: a sinogram (a numpy array or a tensor on any
    device) and the spec of its operator.  ``solver_kwargs`` must be
    JSON-canonicalizable scalars (``n_iters``, ``beta``, ...): they are part
    of the bucket, since a packed batch shares one solver."""

    spec: ProjectorSpec
    sino: Any
    solver: str = "fbp"
    solver_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rid: Optional[int] = None                     # assigned at submit()


@dataclasses.dataclass
class ReconResponse:
    rid: int
    ok: bool
    tier: str
    solver: str
    result: Optional[ReconResult] = None          # None iff not ok
    error: Optional[str] = None
    bucket: Optional[str] = None
    batch_size: int = 0                           # real requests in the pack
    latency_s: float = 0.0                        # submit -> answered

    @property
    def image(self):
        return None if self.result is None else self.result.image


def _size_class(n: int, max_batch: int) -> int:
    """The next power of two >= n, at most max_batch: a bucket has at most
    log2(max_batch) + 1 executors."""
    c = 1
    while c < n and c < max_batch:
        c *= 2
    return c


class CTServer:
    """Geometry-bucketed dynamic batcher over the projector stack.

    Synchronous by design (like :class:`repro_torch.launch.serve.Server`):
    callers ``submit`` then ``drain``/``step``.  ``max_batch=1`` is a serial
    loop over the requests, the baseline that batching is measured against.
    ``device=None`` means ``cuda`` and raises without one; ``device="cpu"``
    runs on the host.
    """

    def __init__(self, max_batch: int = 16,
                 device: Optional[Union[str, torch.device]] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.device = resolve_device(device, "CTServer")
        # bucket key -> FIFO of (request, submit time)
        self._queues: Dict[Tuple, List[Tuple[ReconRequest, float]]] = {}
        self._bucket_meta: Dict[Tuple, ReconRequest] = {}
        # bucket key -> its solver; (bucket key, size class) -> executor
        self._solvers: Dict[Tuple, Any] = {}
        self._executors: Dict[Tuple, Any] = {}
        self._responses: Dict[int, ReconResponse] = {}
        self._next_rid = 0
        #: one record per packed dispatch: {"bucket", "tier", "solver",
        #: "rids", "size_class", "wall_s"}; no record holds two buckets.
        self.dispatch_log: List[Dict[str, Any]] = []

    # -- admission ---------------------------------------------------------- #
    @staticmethod
    def bucket_key(req: ReconRequest) -> Tuple:
        tier = solver_tier(req.solver)
        kwargs = json.dumps(sorted(req.solver_kwargs.items()), default=float)
        return (tier, req.solver, req.spec.bucket_key(), kwargs)

    def submit(self, req: ReconRequest) -> int:
        """Admit one request.  A request that fails validation is answered
        at once (``ok=False``) and never reaches a batch."""
        rid = self._next_rid if req.rid is None else req.rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = dataclasses.replace(req, rid=rid)
        try:
            solver_tier(req.solver)
            if not isinstance(req.spec, ProjectorSpec):
                raise TypeError(f"ReconRequest.spec must be a ProjectorSpec, "
                                f"got {type(req.spec).__name__}")
            expect = req.spec.geom.sino_shape
            if tuple(req.sino.shape) != tuple(expect):
                raise ValueError(f"sinogram shape {tuple(req.sino.shape)} "
                                 f"does not match spec's {tuple(expect)}")
            key = self.bucket_key(req)
        except Exception as e:                    # noqa: BLE001
            self._responses[rid] = ReconResponse(
                rid=rid, ok=False, tier="?", solver=req.solver,
                error=f"{type(e).__name__}: {e}")
            return rid
        self._queues.setdefault(key, []).append((req, time.perf_counter()))
        self._bucket_meta.setdefault(key, req)
        return rid

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # -- executors ---------------------------------------------------------- #
    def _solver_fn(self, req: ReconRequest):
        """The bucket's solver on a batch of sinograms on the device."""
        proj = Projector(req.spec, device=self.device)
        kwargs = dict(req.solver_kwargs)
        if req.solver == "fbp":
            @torch.no_grad()
            def fn(y):
                img = proj.fbp(y, **kwargs)
                hist = torch.zeros(y.shape[:-3] + (0,), dtype=img.dtype,
                                   device=img.device)
                return ReconResult(image=img, iterations=0,
                                   residual_history=hist)
            return fn
        if req.solver == "fista_tv" and "L" not in kwargs:
            # The Lipschitz constant is a property of the operator: compute
            # it once a bucket, when its first executor is built.
            kwargs["L"] = float(power_iteration(proj)) * 1.05
        solve = _SOLVERS[req.solver]
        return torch.no_grad()(lambda y: solve(proj, y, **kwargs))

    def _executor(self, key: Tuple, size: int):
        """The executor of a bucket's size class: the bucket's solver, built
        once a bucket."""
        ex = self._executors.get((key, size))
        if ex is None:
            ex = self._solvers.get(key)
            if ex is None:
                ex = self._solvers[key] = self._solver_fn(self._bucket_meta[key])
            self._executors[(key, size)] = ex
        return ex

    def warm(self, spec: ProjectorSpec, solver: str = "fbp",
             solver_kwargs: Optional[Dict[str, Any]] = None,
             batch_sizes: Optional[Tuple[int, ...]] = None) -> None:
        """Run the bucket's executor once at each size class of
        ``batch_sizes`` (default: every one up to ``max_batch``) on zeros on
        the device, through the same pack and unpack as :meth:`step`.
        After this the bucket's requests build, load, sweep and compile
        nothing (see the module docstring)."""
        proto = ReconRequest(spec=spec, sino=torch.zeros(spec.geom.sino_shape),
                             solver=solver,
                             solver_kwargs=dict(solver_kwargs or {}))
        key = self.bucket_key(proto)
        self._bucket_meta.setdefault(key, proto)
        if batch_sizes is None:
            sizes, c = [], 1
            while c <= self.max_batch:
                sizes.append(c)
                c *= 2
            batch_sizes = tuple(sizes)
        for n in batch_sizes:
            size = _size_class(n, self.max_batch)
            y = self._pack([proto] * n, size)
            self._unpack(self._executor(key, size)(y), n)

    # -- dispatch ----------------------------------------------------------- #
    def _pick_bucket(self) -> Optional[Tuple]:
        """Strict tier priority; FIFO (oldest queued request) within a
        tier so no bucket starves another of the same class."""
        best, best_t = None, None
        for tier in TIERS:                        # priority order
            for key, q in self._queues.items():
                if key[0] != tier or not q:
                    continue
                if best_t is None or q[0][1] < best_t:
                    best, best_t = key, q[0][1]
            if best is not None:
                return best
        return None

    def _on_device(self, x) -> bool:
        return (isinstance(x, torch.Tensor)
                and x.device.type == self.device.type
                and (self.device.index is None
                     or x.device.index == self.device.index))

    def _pack(self, reqs: List[ReconRequest], size: int) -> torch.Tensor:
        """The requests' sinograms as one (size, ...) batch on the device,
        zero-padded, float32 either way: one ``torch.stack`` where they are
        all there already, else one host stack and one transfer."""
        sinos = [r.sino for r in reqs]
        shape = tuple(reqs[0].spec.geom.sino_shape)
        if all(self._on_device(s) for s in sinos):
            pad = [sinos[0].new_zeros(shape)] * (size - len(sinos))
            return torch.stack(sinos + pad).to(torch.float32)
        host = np.zeros((size,) + shape, np.float32)
        for i, s in enumerate(sinos):
            host[i] = (s.detach().cpu().numpy() if isinstance(s, torch.Tensor)
                       else np.asarray(s))
        return torch.from_numpy(host).to(self.device)

    @staticmethod
    def _unpack(out: ReconResult, n: int) -> List[ReconResult]:
        """The first ``n`` members of a batch's result, as CPU tensors, from
        one device-to-host copy."""
        img, hist = out.image, out.residual_history
        size = img.shape[0]
        flat = torch.cat([img.reshape(size, -1),
                          hist.reshape(size, -1).to(img.dtype)], dim=1).cpu()
        nimg = img[0].numel()
        return [ReconResult(image=flat[i, :nimg].view(img.shape[1:]),
                            iterations=out.iterations,
                            residual_history=flat[i, nimg:])
                for i in range(n)]

    def step(self) -> bool:
        """Dispatch one packed batch (the oldest highest-tier bucket).
        Returns False when no work is queued."""
        key = self._pick_bucket()
        if key is None:
            return False
        q = self._queues[key]
        take, q[:] = q[:self.max_batch], q[self.max_batch:]
        reqs = [r for r, _ in take]
        t_sub = [t for _, t in take]
        tier, solver = key[0], key[1]
        n = len(reqs)
        size = _size_class(n, self.max_batch)
        t0 = time.perf_counter()
        try:
            results: List[Optional[ReconResult]] = self._unpack(
                self._executor(key, size)(self._pack(reqs, size)), n)
            errors: List[Optional[str]] = [None] * n
        except Exception:                         # noqa: BLE001
            # Per-request isolation: re-run the batch members one by one so
            # a single poisoned request cannot take down its batch mates.
            results, errors = [], []
            for r in reqs:
                try:
                    results.append(self._unpack(
                        self._executor(key, 1)(self._pack([r], 1)), 1)[0])
                    errors.append(None)
                except Exception as e:            # noqa: BLE001
                    results.append(None)
                    errors.append(f"{type(e).__name__}: {e}")
        t1 = time.perf_counter()
        self.dispatch_log.append({
            "bucket": key[2], "tier": tier, "solver": solver,
            "rids": [r.rid for r in reqs], "size_class": size,
            "wall_s": t1 - t0})
        for r, ts, res, err in zip(reqs, t_sub, results, errors):
            self._responses[r.rid] = ReconResponse(
                rid=r.rid, ok=err is None, tier=tier, solver=solver,
                result=res, error=err, bucket=key[2], batch_size=n,
                latency_s=t1 - ts)
        return True

    def drain(self) -> Dict[int, ReconResponse]:
        """Run steps until every queued request is answered; returns all
        responses accumulated so far, keyed by rid."""
        while self.step():
            pass
        return dict(self._responses)

    def take_responses(self) -> Dict[int, ReconResponse]:
        out, self._responses = self._responses, {}
        return out
