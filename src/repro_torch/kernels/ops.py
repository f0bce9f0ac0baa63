"""Public differentiable projection ops.

``forward_project`` / ``back_project`` are linear maps wired together as a
*matched pair* of ``torch.autograd.Function``s:

    d/df 0.5 ||forward_project(f) - y||^2  ==  back_project(forward_project(f) - y)

exactly: the backward of the forward op *is* the back op and vice versa, so
autograd never differentiates through the projector internals.  Each
backward calls the other Function's ``apply``, so gradients of gradients
(``create_graph=True``) work too.

Backends (``ProjectorSpec.backend``):
    * ``auto`` -- follow the input: a CUDA tensor runs the registered CUDA
      kernel pair, a CPU tensor its plain version (``kernels/ref.py``).  A
      (geometry, model) with no kernel pair (Joseph), or one whose entry's
      ``supports`` gate rejects the geometry (tilted modular frames), runs
      the plain pair on whatever device the tensor is on, as the
      reference's ``auto`` does where it has no Pallas kernel.
    * ``cuda`` -- the kernel pair; a CPU tensor, or a geometry with no kernel
      pair, raises.
    * ``ref``  -- the plain reference, on whatever device the tensor is.

Modes (``ProjectorSpec.mode``, :func:`resolve_mode`): ``exact`` runs the
exact pair; ``packed`` the registered approximate *packed* pair (the cone
pair's lane-packed axial pre-resample), raising where none is registered;
``auto`` the packed pair where its ``packed_ok`` gate accepts the geometry,
else the exact one.  The port's ``auto`` and ``cuda`` backends resolve the
mode as the reference's ``backend="pallas"`` does, ``ref`` as its ``ref``
(always exact).  On a CPU tensor the ``auto`` backend runs the plain version
of whichever pair was resolved.  A registered kernel that fails to build or
launch raises: no path falls back from a kernel to its plain version.

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

from repro_torch.core.geometry import CTGeometry
from repro_torch.core.spec import ProjectorSpec
from repro_torch.kernels import ref


class _KernelEntry(NamedTuple):
    """A registered CUDA kernel pair.  ``plan(geom)`` derives what the pair
    needs from a geometry once per bundle; ``fp``/``bp`` take
    ``(tensor, plan, config=, compute_dtype=)``; the batched variants accept
    a leading batch dimension and fold it into the kernel.  ``fp_packed``/
    ``bp_packed`` on ``packed_plan(geom)`` are an approximate packed pair,
    taken by ``mode="packed"``, or by ``mode="auto"`` where
    ``packed_ok(geom)`` holds; ``supports(geom)`` restricts the entry to the
    geometries its kernels cover."""
    plan: Callable
    fp: Callable
    bp: Callable
    fp_batched: Optional[Callable] = None
    bp_batched: Optional[Callable] = None
    packed_plan: Optional[Callable] = None
    fp_packed: Optional[Callable] = None
    bp_packed: Optional[Callable] = None
    packed_ok: Optional[Callable] = None     # geom -> bool (mode="auto" gate)
    supports: Optional[Callable] = None      # geom -> bool (kernel coverage)


# {(geom_type, model): _KernelEntry} -- filled by the kernels package on import
_KERNEL_TABLE: Dict[Tuple[str, str], _KernelEntry] = {}


def register_kernel(geom_type: str, model: str, plan: Callable, fp: Callable,
                    bp: Callable, fp_batched: Optional[Callable] = None,
                    bp_batched: Optional[Callable] = None,
                    packed_plan: Optional[Callable] = None,
                    fp_packed: Optional[Callable] = None,
                    bp_packed: Optional[Callable] = None,
                    packed_ok: Optional[Callable] = None,
                    supports: Optional[Callable] = None) -> None:
    """Register a CUDA kernel pair for one (geometry type, model), with an
    optional packed pair and its gate, and an optional coverage gate
    (:class:`_KernelEntry`)."""
    _KERNEL_TABLE[(geom_type, model)] = _KernelEntry(
        plan, fp, bp, fp_batched, bp_batched, packed_plan, fp_packed,
        bp_packed, packed_ok, supports)


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


def _resolve_mode(spec: ProjectorSpec) -> str:
    """Collapse ``spec.mode`` to the concrete pair that will dispatch
    ("exact" | "packed"): ``auto``/``cuda`` as the reference's ``pallas``
    backend, ``ref`` as its ``ref``.  The spec has validated its fields."""
    if spec.mode == "exact":
        return "exact"
    geom, model = spec.geom, spec.model
    entry = _KERNEL_TABLE.get((geom.geom_type, model))
    has_packed = (spec.backend in ("auto", "cuda") and entry is not None
                  and entry.fp_packed is not None
                  and entry.bp_packed is not None)
    if spec.mode == "packed":
        if not has_packed:
            raise NotImplementedError(
                f"mode='packed' needs a registered packed kernel pair for "
                f"({geom.geom_type}, {model}) on the auto or cuda backend")
        return "packed"
    # "auto": packed only where the registered gate accepts the geometry
    if has_packed and entry.packed_ok is not None and entry.packed_ok(geom):
        return "packed"
    return "exact"


def resolve_mode(spec_or_geom, model: str = "sf", backend: str = "auto",
                 mode: str = "auto") -> str:
    """The concrete pair ("exact" | "packed") that ``forward_project`` /
    ``back_project`` dispatch for these arguments, given a
    :class:`ProjectorSpec` or a geometry.  The port's backends map onto the
    reference's: ``auto`` and ``cuda`` act as its ``backend="pallas"``
    (``mode="auto"`` is packed where the entry's ``packed_ok`` holds;
    ``mode="packed"`` needs a registered packed pair, else
    ``NotImplementedError``), ``ref`` as its ``ref`` (``auto`` is exact,
    ``packed`` raises).  A spec resolves once, at its first use
    (``ProjectorSpec.resolved_mode``), and keeps its pair: a later change
    of ``REPRO_TORCH_PACKED_CONE_TOL`` moves new specs only."""
    spec = (spec_or_geom if isinstance(spec_or_geom, ProjectorSpec)
            else ProjectorSpec(spec_or_geom, model=model, backend=backend,
                               mode=mode))
    return spec.resolved_mode


def _build(spec: ProjectorSpec, rmode: str) -> Ops:
    geom, model, cdt = spec.geom, spec.model, spec.compute_dtype
    kernel = plain = None
    entry = _KERNEL_TABLE.get((geom.geom_type, model))
    if spec.backend == "cuda" and entry is None:
        raise NotImplementedError(
            f"no CUDA kernel pair for {(geom.geom_type, model)}; "
            f"backend='auto' or 'ref' runs its plain version")
    if (spec.backend == "auto" and entry is not None
            and entry.supports is not None and not entry.supports(geom)):
        entry = None          # the plain pair on every device
    # an explicit backend="cuda" builds the plan, which refuses what the
    # kernels do not cover; the kernel pair and its plain version share it
    plan = None
    if spec.backend in ("auto", "cuda") and entry is not None:
        if rmode == "packed":
            plan = entry.packed_plan(geom)
            fp, bp = entry.fp_packed, entry.bp_packed
        else:
            plan = entry.plan(geom)
            fp = entry.fp_batched or entry.fp
            bp = entry.bp_batched or entry.bp
        kernel = _make_pair(
            lambda f: fp(f, plan, config=spec.config, compute_dtype=cdt),
            lambda p: bp(p, plan, config=spec.config, compute_dtype=cdt))
    if spec.backend in ("auto", "ref"):
        # unsupported pairs raise here
        rplan = ref._plan(geom, model) if plan is None else plan
        plain = _make_pair(
            lambda f: ref.forward(f, geom, model, dtype=cdt, plan=rplan),
            lambda p: ref.adjoint(p, geom, model, dtype=cdt, plan=rplan))
    return Ops(kernel, plain)


# Bounded LRU over op bundles, keyed on ``spec.cache_key()``.
_OPS_CACHE: "OrderedDict[Tuple, Ops]" = OrderedDict()
_OPS_CACHE_SIZE = 256
_STATS = {"hits": 0, "misses": 0}


def _get_bundle(spec: ProjectorSpec, in_dtype: Optional[torch.dtype] = None) -> Ops:
    if spec.shard is not None:
        raise ValueError(
            "spec carries a ShardSpec — the local op cache cannot realize "
            "a sharded layout; build DistributedProjector(spec, mesh) "
            "(repro_torch.core.distributed), or drop the shard with "
            "spec.replace(shard=None) for single-device ops")
    idt = None if in_dtype is None else str(in_dtype).removeprefix("torch.")
    # keyed on the resolved mode: "auto" and an explicit equivalent share one
    # bundle
    rmode = spec.resolved_mode
    key = spec.cache_key(rmode, idt)
    hit = _OPS_CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        _OPS_CACHE.move_to_end(key)
        return hit
    _STATS["misses"] += 1
    bundle = _build(spec, rmode)
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
