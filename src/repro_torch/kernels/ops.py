"""Public differentiable projection ops.

``forward_project`` / ``back_project`` are linear maps wired together as a
*matched pair* of ``torch.autograd.Function``s:

    d/df 0.5 ||forward_project(f) - y||^2  ==  back_project(forward_project(f) - y)

exactly: the backward of the forward op *is* the back op and vice versa, so
autograd never differentiates through the projector internals.  Each
backward calls the other Function's ``apply``, so gradients of gradients
(``create_graph=True``) work too.

Backends (``ProjectorSpec.backend``):
    * ``auto`` — follow the input: a CUDA tensor runs the registered CUDA
      kernel pair, a CPU tensor the plain reference (``kernels/ref.py``).
    * ``cuda`` — the kernel pair; a CPU tensor raises.
    * ``ref``  — the plain reference, on whatever device the tensor is.

The op cache is a bounded LRU keyed on ``spec.cache_key()`` (geometry
*content* plus model/backend/config/precision and the input dtype), so equal
geometries share one bundle; each bundle derives its per-view tables once
and keeps them on each device it ran on.  :func:`cache_stats` exposes
size/hit/miss counters.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.spec import ProjectorSpec
from repro_torch.kernels import ref


class _KernelEntry(NamedTuple):
    """A registered CUDA kernel pair.  ``plan(geom)`` derives what the pair
    needs from a geometry once per bundle; ``fp``/``bp`` take
    ``(tensor, plan, config=, compute_dtype=)``; the batched variants accept
    a leading batch dimension and fold it into the kernel."""
    plan: Callable
    fp: Callable
    bp: Callable
    fp_batched: Optional[Callable] = None
    bp_batched: Optional[Callable] = None


# {(geom_type, model): _KernelEntry} — filled by the kernels package on import
_KERNEL_TABLE: Dict[Tuple[str, str], _KernelEntry] = {}


def register_kernel(geom_type: str, model: str, plan: Callable, fp: Callable,
                    bp: Callable, fp_batched: Optional[Callable] = None,
                    bp_batched: Optional[Callable] = None) -> None:
    """Register a CUDA kernel pair for one (geometry type, model)."""
    _KERNEL_TABLE[(geom_type, model)] = _KernelEntry(plan, fp, bp, fp_batched,
                                                     bp_batched)


class _Pair:
    """The two raw linear maps of one bundle, in both directions."""

    def __init__(self, fp: Callable, bp: Callable):
        self.fp = fp
        self.bp = bp


class _Forward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair):
        ctx.pair = pair
        return pair.fp(x)

    @staticmethod
    def backward(ctx, g):
        return _Back.apply(g, ctx.pair), None


class _Back(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, pair):
        ctx.pair = pair
        return pair.bp(y)

    @staticmethod
    def backward(ctx, g):
        return _Forward.apply(g, ctx.pair), None


def _make_pair(raw_fp: Callable, raw_bp: Callable) -> Tuple[Callable, Callable]:
    """Wire (A, A^T) together so each is the other's backward."""
    pair = _Pair(raw_fp, raw_bp)
    return (lambda x: _Forward.apply(x, pair)), (lambda y: _Back.apply(y, pair))


class Ops(NamedTuple):
    """Matched differentiable op bundles for one spec: ``kernel`` runs on
    CUDA tensors, ``plain`` is the reference pair (None where the spec
    forbids it)."""
    kernel: Optional[Tuple[Callable, Callable]]
    plain: Optional[Tuple[Callable, Callable]]


def _build(spec: ProjectorSpec) -> Ops:
    geom, model, cdt = spec.geom, spec.model, spec.compute_dtype
    kernel = plain = None
    if spec.backend in ("auto", "cuda"):
        entry = _KERNEL_TABLE.get((geom.geom_type, model))
        if entry is None:
            raise NotImplementedError(
                f"no CUDA kernel pair for {(geom.geom_type, model)} in the "
                f"PyTorch port yet; ROADMAP.md queue 2 lists the kernels "
                f"still to port")
        plan = entry.plan(geom)
        fp = entry.fp_batched or entry.fp
        bp = entry.bp_batched or entry.bp
        kernel = _make_pair(
            lambda f: fp(f, plan, config=spec.config, compute_dtype=cdt),
            lambda p: bp(p, plan, config=spec.config, compute_dtype=cdt))
    if spec.backend in ("auto", "ref"):
        ref._plan(geom, model)                  # unsupported pairs raise here
        plain = _make_pair(lambda f: ref.forward(f, geom, model, dtype=cdt),
                           lambda p: ref.adjoint(p, geom, model, dtype=cdt))
    return Ops(kernel, plain)


# Bounded LRU over op bundles, keyed on ``spec.cache_key()``.
_OPS_CACHE: "OrderedDict[Tuple, Ops]" = OrderedDict()
_OPS_CACHE_SIZE = 256
_STATS = {"hits": 0, "misses": 0}


def _get_bundle(spec: ProjectorSpec, in_dtype: Optional[torch.dtype] = None) -> Ops:
    idt = None if in_dtype is None else str(in_dtype).removeprefix("torch.")
    key = spec.cache_key(idt)
    hit = _OPS_CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        _OPS_CACHE.move_to_end(key)
        return hit
    _STATS["misses"] += 1
    bundle = _build(spec)
    _OPS_CACHE[key] = bundle
    while len(_OPS_CACHE) > _OPS_CACHE_SIZE:
        _OPS_CACHE.popitem(last=False)
    return bundle


def clear_cache() -> None:
    """Drop every cached op bundle."""
    _OPS_CACHE.clear()


def cache_stats() -> Dict[str, int]:
    """Op-cache observability: ``{"size", "hits", "misses"}``."""
    return {"size": len(_OPS_CACHE), **_STATS}


def _pick(bundle: Ops, spec: ProjectorSpec, x: torch.Tensor
          ) -> Tuple[Callable, Callable]:
    """The pair for this tensor: kernels for CUDA tensors (unless the spec
    asks for the reference), the reference for CPU tensors (unless the spec
    demands the kernels, which raises)."""
    if x.device.type == "cuda" and bundle.kernel is not None:
        return bundle.kernel
    if bundle.plain is not None:
        return bundle.plain
    raise ValueError(
        f"backend='cuda' needs a CUDA tensor, got one on {x.device}; use "
        f"backend='auto' or 'ref' for CPU tensors")


def get_ops(spec: ProjectorSpec, x: torch.Tensor) -> Tuple[Callable, Callable]:
    """The (forward, back) matched differentiable pair that ``x`` would run
    through.  Equal specs return the same function objects."""
    return _pick(_get_bundle(spec, x.dtype), spec, x)


def _apply(op: Callable, x: torch.Tensor) -> torch.Tensor:
    """Fold any leading dims beyond one batch dim into one, apply, unfold."""
    extra = x.dim() - 3
    if extra <= 1:
        return op(x)
    lead = x.shape[:extra]
    out = op(x.reshape((-1,) + x.shape[extra:]))
    return out.reshape(lead + out.shape[1:])


def _check_spec(spec) -> None:
    if not isinstance(spec, ProjectorSpec):
        raise TypeError(f"expected a ProjectorSpec, got "
                        f"{type(spec).__name__}")


def forward_project(f: torch.Tensor, spec: ProjectorSpec) -> torch.Tensor:
    """A @ f.  ``f``: (..., nx, ny, nz) -> (..., n_angles, n_rows, n_cols)."""
    _check_spec(spec)
    return _apply(get_ops(spec, f)[0], f)


def back_project(p: torch.Tensor, spec: ProjectorSpec) -> torch.Tensor:
    """A^T @ p.  ``p``: (..., n_angles, n_rows, n_cols) -> (..., nx, ny, nz)."""
    _check_spec(spec)
    return _apply(get_ops(spec, p)[1], p)
