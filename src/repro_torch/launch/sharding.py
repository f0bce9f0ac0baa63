"""Tensor (Megatron-style) and FSDP parallelism on a mesh's axes, the
counterpart of the reference package's ``launch/sharding.py``.

Policy (the reference's rules, carried out with explicit collectives on
``torch.distributed`` process groups, since PyTorch has no GSPMD):

    column-parallel weights (wq/wk/wv/w1/w3/in_proj/dt_proj, lm head) shard
    their *output* dim on 'model' and (if fsdp) their input dim on DP;
    row-parallel weights (wo/w2/out_proj/x_proj) the transpose;
    MoE expert tensors shard the expert d_ff on 'model' (EP == TP axis);
    embeddings shard the vocab on 'model';
    optimizer state inherits the parameter specs (ZeRO falls out for free).

Every rule is divisibility-guarded: a dim that does not divide by its axes
stays replicated.  A spec is a tuple with one entry per dim: ``None``,
``"model"``, or a tuple of data axes (FSDP; every axis under
``cfg.pure_dp``).  The leaves' leading codebook or layer axis is never
split: the rules apply to the last dims, as in the reference.

The port departs from ``param_pspec`` in two places, both because a rank
computes on its own columns (``tests/test_torch_sharding.py`` lists them):

* **Head-aligned splits.**  Tensor parallelism cannot split a head:
  ``wq`` and ``wo`` split only where ``n_heads % tp == 0``, ``wk`` and
  ``wv`` only where ``n_kv_heads % tp == 0``; otherwise the leaf stays
  replicated.  Where ``wk``/``wv`` stay replicated while ``wq`` splits,
  every rank computes all KV heads and each of its query heads ``h`` reads
  KV head ``h // G``.  (The reference splits Hymba's ``wq``, 25 x 64
  columns, through a head.)
* **Packed leaves split part by part.**  Mamba's ``in_proj`` (d, 2 di) is
  ``[x | z]``: rank ``r`` holds its slice of ``x`` and its slice of ``z``
  (so it splits only where ``d_inner % tp == 0``), where a contiguous
  split would give one rank all of ``x``.

The decode cache (:func:`cache_specs`) departs from ``cache_pspec`` the
same way: K/V split by KV head only where ``wk`` does (never by head dim),
and a batch that does not divide over the data axes stays replicated there
(the reference shards a batch-1 cache's sequence on the data axes).

:func:`make_ac` returns a rank's :class:`ParallelContext`, the ``ac``
argument of the model functions.  It holds the ``model`` group, the data
groups and the collectives as autograd Functions:

* ``copy`` (to ``model``): forward the identity, backward an all-reduce;
  the input of every column-parallel region, and a replicated tensor whose
  gradient each rank forms only in part (MoE gates, a shared ``wk``);
* ``reduce`` (from ``model``): forward an all-reduce, backward the
  identity; the output of every row-parallel region;
* ``gather_data`` (from the data axes): forward an all-gather of an FSDP
  shard, backward a reduce-scatter.

The collectives are the backend's own, in the tensors' dtype: gloo (torch
2.11 on the H100's host and 2.13 on the CPU) all-reduces, all-gathers and
reduce-scatters bf16 and f16 tensors, on the CPU and on the card.  A
backend that lacks one raises.

In ``record`` mode (``make_ac(..., mode="record")``, the dry run) no
process group exists: every collective returns a tensor of the right
shape and logs ``(op, bytes, group size)``.  ``ac=None`` in the model
functions is one device with no collective.
"""
from __future__ import annotations

import copy as _copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_axes, tp_size
from repro_torch.models.config import ModelConfig

__all__ = ["param_pspec", "param_specs", "batch_pspec", "cache_pspec",
           "cache_specs", "shard_params", "gather_params", "local_shape",
           "make_ac", "ParallelContext"]

# last-two-dims rule per leaf name: (in_rule, out_rule) where rule is
# 'tp' | 'dp' | None  (dp = FSDP axes, only applied when fsdp enabled)
_MATMUL_RULES = {
    "wq": ("dp", "tp"), "wk": ("dp", "tp"), "wv": ("dp", "tp"),
    "wo": ("tp", "dp"),
    "w1": ("dp", "tp"), "w3": ("dp", "tp"), "w2": ("tp", "dp"),
    "in_proj": ("dp", "tp"), "out_proj": ("tp", "dp"),
    "x_proj": ("tp", None), "dt_proj": (None, "tp"),
    "router": ("dp", None),
    "embed": ("tp", "dp"),       # (V, d): vocab on model
    "head": ("dp", "tp"),        # (d, V): vocab on model
}
_VECTOR_RULES = {
    "conv_w": (None, "tp"),      # (K, di)
    "conv_b": ("tp",),
    "dt_bias": ("tp",),
    "D": ("tp",),
    "A_log": ("tp", None),       # (di, N)
}


def _axis_size(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in (
        (axes,) if isinstance(axes, str) else axes)]))


def _axis_ok(dim: int, mesh, axes) -> bool:
    if axes is None:
        return False
    size = _axis_size(mesh, axes)
    return dim % size == 0 and size > 1


def _resolve(rule, mesh, dim: int, fsdp: bool):
    if rule == "tp":
        return "model" if _axis_ok(dim, mesh, "model") else None
    if rule == "dp":
        if not fsdp:
            return None
        dp = data_axes(mesh)
        return dp if _axis_ok(dim, mesh, dp) else None
    return None


def param_pspec(path, shape, mesh, fsdp: bool) -> tuple:
    """The reference's rule for one leaf (``path``: its keys, the last its
    name), before the port's departures."""
    name = str(path[-1])
    nd = len(shape)
    if name in _MATMUL_RULES and nd >= 2:
        rin, rout = _MATMUL_RULES[name]
        spec = [None] * nd
        spec[-2] = _resolve(rin, mesh, shape[-2], fsdp)
        spec[-1] = _resolve(rout, mesh, shape[-1], fsdp)
        return tuple(spec)
    if name in _VECTOR_RULES:
        rules = _VECTOR_RULES[name]
        spec = [None] * nd
        for i, r in enumerate(rules):
            dim_idx = nd - len(rules) + i
            spec[dim_idx] = _resolve(r, mesh, shape[dim_idx], fsdp)
        return tuple(spec)
    return (None,) * nd   # norms, biases, scalars: replicated


def _head_aligned(cfg: ModelConfig, name: str, spec: tuple, tp: int) -> tuple:
    """The port's departures from ``param_pspec`` (the module's docstring)."""
    whole = {"wq": cfg.n_heads, "wo": cfg.n_heads, "wk": cfg.n_kv_heads,
             "wv": cfg.n_kv_heads, "in_proj": cfg.d_inner if cfg.uses_ssm else 1}
    if name in whole and "model" in spec and whole[name] % tp:
        return tuple(None if e == "model" else e for e in spec)
    return spec


def _tree_map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(cfg: ModelConfig, params, mesh, fsdp: Optional[bool] = None):
    """The spec of every leaf of ``params`` (a tree of tensors or shapes)
    on ``mesh``: the counterpart of ``param_shardings``.  ``fsdp`` defaults
    to ``n_params() > 3e9 or pure_dp``; under ``cfg.pure_dp`` every leaf is
    split over every mesh axis on its largest dim that divides (ZeRO-3, no
    TP)."""
    if fsdp is None:
        fsdp = cfg.n_params() > 3e9 or cfg.pure_dp
    axes = tuple(mesh.axis_names)

    def shape_of(leaf):
        return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)

    if cfg.pure_dp:
        def g(path, leaf):
            shape = shape_of(leaf)
            spec = [None] * len(shape)
            if fsdp:
                for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                    if _axis_ok(shape[i], mesh, axes):
                        spec[i] = axes
                        break
            return tuple(spec)
        return _tree_map(g, params)

    tp = tp_size(mesh)

    def f(path, leaf):
        spec = param_pspec(path, shape_of(leaf), mesh, fsdp)
        return _head_aligned(cfg, str(path[-1]), spec, tp)
    return _tree_map(f, params)


# ----------------------------- batches / caches --------------------------- #
def batch_pspec(shape, mesh, batch_dim: int = 0, dp=None) -> tuple:
    dp = dp or data_axes(mesh)
    spec = [None] * len(shape)
    if _axis_ok(shape[batch_dim], mesh, dp):
        spec[batch_dim] = dp
    return tuple(spec)


def cache_pspec(name: str, shape, mesh) -> tuple:
    """The reference's rule: KV cache (L,B,S,KV,hd) / SSM caches
    (L,B,*,di,*)."""
    dp = data_axes(mesh)
    spec = [None] * len(shape)
    if name in ("k", "v"):
        if _axis_ok(shape[1], mesh, dp):
            spec[1] = dp
        elif _axis_ok(shape[2], mesh, dp):
            spec[2] = dp          # long-context batch=1: shard sequence on DP
        if _axis_ok(shape[3], mesh, "model"):
            spec[3] = "model"
        elif _axis_ok(shape[4], mesh, "model"):
            spec[4] = "model"
    elif name == "conv":
        if _axis_ok(shape[1], mesh, dp):
            spec[1] = dp
        if _axis_ok(shape[3], mesh, "model"):
            spec[3] = "model"
    elif name == "ssm":
        if _axis_ok(shape[1], mesh, dp):
            spec[1] = dp
        if _axis_ok(shape[2], mesh, "model"):
            spec[2] = "model"
    return tuple(spec)


def cache_specs(cfg: ModelConfig, shapes: dict, mesh) -> dict:
    """The port's cache layout (``shapes``: name -> shape, as
    ``model.cache_shapes`` gives them): the reference's rule without the
    sequence on the data axes, K/V split by head only where ``wk`` is, and
    the SSM states by channel only where ``in_proj`` is.  Where ``wq``
    splits and ``wk`` does not, K/V's spec says replicated, but a rank
    holds only the KV heads its query heads read (``ac.kv_heads``,
    ``model.cache_shapes(..., ac)``), which no per-dim spec expresses."""
    tp = tp_size(mesh)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape[0] if isinstance(shape[0], tuple) else shape)
        spec = list(cache_pspec(name, shape, mesh))
        if name in ("k", "v"):
            spec[2] = None
            spec[4] = None
            if cfg.n_kv_heads % tp:
                spec[3] = None
        elif cfg.uses_ssm and cfg.d_inner % tp:
            spec = [None if e == "model" else e for e in spec]
        out[name] = tuple(spec)
    return out


# ----------------------------- layouts ------------------------------------ #
def _coord(mesh, entry) -> tuple:
    """(index, count) of this rank along a spec entry's axes (row-major
    over several)."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
    return idx, _axis_size(mesh, axes)


def _packed(name: str) -> bool:
    return name == "in_proj"


def _take(t: torch.Tensor, dim: int, idx: int, n: int, packed: bool):
    if packed:
        parts = t.chunk(2, dim=dim)
        return torch.cat([_take(p, dim, idx, n, False) for p in parts], dim=dim)
    size = t.shape[dim] // n
    return t.narrow(dim, idx * size, size)


def local_shape(shape, spec, mesh) -> tuple:
    """A leaf's shape on one rank of ``mesh``."""
    return tuple(s // (1 if e is None else _axis_size(mesh, e))
                 for s, e in zip(shape, spec))


def shard_params(cfg: ModelConfig, full, mesh, fsdp: Optional[bool] = None,
                 specs=None):
    """This rank's shards of the full tree ``full`` (contiguous copies)."""
    specs = specs if specs is not None else param_specs(cfg, full, mesh, fsdp)

    def f(path, t):
        spec = _get(specs, path)
        for dim, e in enumerate(spec):
            if e is not None:
                idx, n = _coord(mesh, e)
                t = _take(t, dim, idx, n, _packed(path[-1]) and e == "model")
        return t.contiguous()
    return _tree_map(f, full)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _all_gather(t: torch.Tensor, dim: int, group, n: int, packed: bool):
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    if packed:
        halves = [p.chunk(2, dim=dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=dim)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def gather_params(cfg: ModelConfig, shards, mesh, fsdp: Optional[bool] = None,
                  specs=None):
    """The full tree from every rank's shards: the exact inverse of
    :func:`shard_params` (all-gathers over each split dim's group; every
    rank of ``mesh`` must call it)."""
    if specs is None:
        from repro_torch.models import model as MD
        specs = param_specs(cfg, MD.param_shapes(cfg), mesh, fsdp)

    def f(path, t):
        spec = _get(specs, path)
        for dim, e in enumerate(spec):
            if e is not None:
                _, n = _coord(mesh, e)
                t = _all_gather(t, dim, _group(mesh, e), n,
                                _packed(path[-1]) and e == "model")
        return t
    return _tree_map(f, shards)


def _group(mesh, e):
    if isinstance(e, tuple) and tuple(e) == tuple(mesh.axis_names):
        return dist.group.WORLD
    return mesh.group(e)


# ----------------------------- collectives -------------------------------- #
def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class _Copy(torch.autograd.Function):
    """To ``model``: forward the identity, backward an all-reduce."""

    @staticmethod
    def forward(ctx, x, ac):
        ctx.ac = ac
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ac._all_reduce(g, "model", backward=True), None


class _Reduce(torch.autograd.Function):
    """From ``model``: forward an all-reduce, backward the identity."""

    @staticmethod
    def forward(ctx, x, ac):
        return ac._all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _seq_part(ac, t: torch.Tensor) -> torch.Tensor:
    """This rank's part of the sequence (axis 1) of a replicated tensor."""
    size = t.shape[1] // ac.tp
    return t.narrow(1, ac.model_rank * size, size).contiguous()


class _GatherSeq(torch.autograd.Function):
    """Sequence parallelism's region entry: forward an all-gather of the
    sequence over ``model``; backward a reduce-scatter (a split region,
    whose ranks each form part of the gradient) or the rank's part (a
    replicated one, whose ranks all form the whole)."""

    @staticmethod
    def forward(ctx, x, ac, split):
        ctx.ac, ctx.split = ac, split
        return ac._all_gather(x, 1, "model")

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            return ctx.ac._reduce_scatter(g, 1, "model", backward=True), None, None
        return _seq_part(ctx.ac, g), None, None


class _ScatterSeq(torch.autograd.Function):
    """Sequence parallelism's region exit: forward a reduce-scatter of the
    sequence over ``model`` (a split region's partial sums) or the rank's
    part (a replicated region's whole); backward an all-gather."""

    @staticmethod
    def forward(ctx, y, ac, split):
        ctx.ac = ac
        if split:
            return ac._reduce_scatter(y, 1, "model")
        return _seq_part(ac, y)

    @staticmethod
    def backward(ctx, g):
        return ctx.ac._all_gather(g, 1, "model", backward=True), None, None


class _GatherData(torch.autograd.Function):
    """An FSDP shard over the data axes: forward an all-gather along
    ``dim``, backward a reduce-scatter (the sum over the data ranks)."""

    @staticmethod
    def forward(ctx, x, ac, dim):
        ctx.ac, ctx.dim = ac, dim
        return ac._all_gather(x, dim, "data")

    @staticmethod
    def backward(ctx, g):
        return ctx.ac._reduce_scatter(g, ctx.dim, "data", backward=True), None, None


class ParallelContext:
    """One rank's tensor- and data-parallel context (``make_ac``).

    ``tp`` and ``model_rank`` are the ``model`` axis's size and this rank's
    coordinate (1 and 0 under ``cfg.pure_dp``, whose every axis is data);
    ``dp`` and ``data_rank`` the same over the data axes.  ``split`` says
    which parts of the model run on the rank's columns: ``heads`` (wq, wo),
    ``kv`` (wk, wv), ``mlp``, ``moe``, ``ssm``, ``vocab``.  ``specs`` is the
    parameter tree's specs (:func:`param_specs`), ``flat_specs`` the same
    under ``model.flatten``'s keys.  In ``record`` mode
    ``records`` collects a dict per collective: ``op``, ``axis``, ``bytes``
    (of the whole tensor: the all-reduced one, the gathered one, the one
    before its reduce-scatter), ``n`` (the group's size) and ``phase``
    (``fwd``, ``bwd``, or ``recompute``: a forward run again inside the
    backward by remat)."""

    def __init__(self, mesh, cfg: ModelConfig, mode: str = "dist",
                 fsdp: Optional[bool] = None):
        if mode not in ("dist", "record"):
            raise ValueError(f"unknown mode {mode!r}; expected 'dist' or "
                             f"'record'")
        from repro_torch.models import model as MD
        self.mesh, self.cfg, self.mode = mesh, cfg, mode
        self.specs = param_specs(cfg, MD.param_shapes(cfg), mesh, fsdp)
        self.flat_specs = MD.flatten(self.specs)
        if cfg.pure_dp:
            self.tp, self.model_rank = 1, 0
            self.data_axes = tuple(mesh.axis_names)
        else:
            self.tp = tp_size(mesh)
            self.model_rank = mesh.coord("model") if "model" in mesh.shape else 0
            self.data_axes = data_axes(mesh)
        self.data_rank, self.dp = (_coord(mesh, self.data_axes)
                                   if self.data_axes else (0, 1))
        self.records = []
        self.seq = False
        self._groups = {}
        if mode == "dist":
            if self.tp > 1:
                self._groups["model"] = mesh.group("model")
            if self.dp > 1:
                self._groups["data"] = _group(mesh, self.data_axes)
        lay = self.specs["layers"]

        def has(grp, name):
            return grp in lay and "model" in lay[grp][name]
        self.split = {
            "heads": has("attn", "wq"), "kv": has("attn", "wk"),
            "mlp": has("mlp", "w1"), "moe": has("moe", "w1"),
            "ssm": has("ssm", "in_proj"),
            "vocab": "model" in self.specs["embed"]}
        self.fsdp = any(isinstance(e, tuple) for e in _spec_leaves(self.specs))

    def __repr__(self):
        return (f"ParallelContext(tp={self.tp}, model_rank={self.model_rank}, "
                f"dp={self.dp}, data_rank={self.data_rank}, mode={self.mode}, "
                f"split={[k for k, v in self.split.items() if v]})")

    # -- the collectives -------------------------------------------------- #
    def _log(self, op: str, axis: str, t: torch.Tensor, n: int,
             backward: bool) -> None:
        phase = ("bwd" if backward else "recompute" if _in_backward()
                 else "fwd")
        self.records.append({"op": op, "axis": axis, "n": n, "phase": phase,
                             "bytes": t.numel() * t.element_size()})

    def _n(self, axis: str) -> int:
        return self.tp if axis == "model" else self.dp

    def _all_reduce(self, x: torch.Tensor, axis: str, op=None,
                    backward: bool = False) -> torch.Tensor:
        n = self._n(axis)
        if self.mode == "record":
            self._log("all-reduce", axis, x, n, backward)
            return x.clone()
        y = x.contiguous().clone()
        dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=self._groups[axis])
        return y

    def _all_gather(self, x: torch.Tensor, dim: int, axis: str,
                    packed: bool = False, backward: bool = False) -> torch.Tensor:
        n = self._n(axis)
        if self.mode == "record":
            shape = list(x.shape)
            shape[dim] *= n
            y = x.new_empty(shape)
            self._log("all-gather", axis, y, n, backward)
            return y
        return _all_gather(x, dim, self._groups[axis], n, packed)

    def _reduce_scatter(self, g: torch.Tensor, dim: int, axis: str,
                        backward: bool = False) -> torch.Tensor:
        n = self._n(axis)
        idx = self.model_rank if axis == "model" else self.data_rank
        size = g.shape[dim] // n
        if self.mode == "record":
            self._log("reduce-scatter", axis, g, n, backward)
            return g.narrow(dim, idx * size, size).clone()
        parts = [p.contiguous() for p in g.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self._groups[axis])
        return out

    # -- regions (Megatron's f and g; sequence parallelism's pair) -------- #
    def for_seq(self, S: int) -> "ParallelContext":
        """This context for a forward over ``S`` positions: with sequence
        parallelism (``cfg.seq_shard``) where ``S`` splits over ``model``,
        a copy whose residual stream holds the rank's ``S / tp``
        positions; else itself."""
        if self.cfg.seq_shard and self.tp > 1 and S % self.tp == 0 and not self.seq:
            out = _copy.copy(self)
            out.seq = True
            return out
        return self

    def enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """The input of a region of the layer: one whose columns split
        over ``model`` (``split``: forward the identity, backward an
        all-reduce; under sequence parallelism an all-gather of the
        sequence and a reduce-scatter), or one every rank runs whole (the
        identity; the all-gather and the rank's part)."""
        if self.seq:
            return _GatherSeq.apply(x, self, split)
        return self.copy(x) if split else x

    def exit(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """The output of a region: :meth:`enter`'s counterpart (a split
        region's partial sums reduced, or reduce-scattered over the
        sequence; a whole one passed, or cut to the rank's part)."""
        if self.seq:
            return _ScatterSeq.apply(y, self, split)
        return self.reduce(y) if split else y

    def seq_shared(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight used on the rank's positions only (a norm's
        scale, the router): under sequence parallelism its gradient is
        all-reduced over ``model``."""
        return self.copy(w) if self.seq else w

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """To ``model``: the identity, whose gradient is all-reduced."""
        return _Copy.apply(x, self) if self.tp > 1 else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """From ``model``: the all-reduced sum, whose gradient passes."""
        return _Reduce.apply(x, self) if self.tp > 1 else x

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise max over ``model`` (no gradient)."""
        if self.tp == 1:
            return x
        return self._all_reduce(x.detach(), "model", dist.ReduceOp.MAX)

    @torch.no_grad()
    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` all-gathered over ``model`` along ``dim`` (no gradient)."""
        if self.tp == 1:
            return x
        return self._all_gather(x, dim, "model")

    # -- FSDP ---------------------------------------------------------------- #
    def unshard(self, spec: tuple, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a leaf's local tensor, ``spec`` its spec) gathered over
        the data axes where FSDP split it."""
        for dim, e in enumerate(spec):
            if isinstance(e, tuple):
                t = _GatherData.apply(t, self, dim)
        return t

    def unshard_layer(self, lp: dict) -> dict:
        """One layer's groups (``model._layer``) gathered over the data
        axes."""
        if not self.fsdp:
            return lp
        lay = self.specs["layers"]
        return {g: {n: self.unshard(lay[g][n][1:], t) for n, t in ps.items()}
                for g, ps in lp.items()}

    def unshard_top(self, params: dict) -> dict:
        """The tree's top-level leaves (embedding, head, final norm)
        gathered over the data axes; the layers stay as they are."""
        if not self.fsdp:
            return params
        return {k: (v if k == "layers" else self.unshard(self.specs[k], v))
                for k, v in params.items()}

    # -- the model's shapes ---------------------------------------------------- #
    def vocab_range(self) -> tuple:
        """``[lo, hi)`` of the vocabulary this rank's embedding shard holds."""
        V = self.cfg.vocab_size
        if not self.split["vocab"]:
            return 0, V
        per = V // self.tp
        return self.model_rank * per, (self.model_rank + 1) * per

    def kv_heads(self) -> Optional[tuple]:
        """Where ``wq`` splits but ``wk`` does not: ``(lo, hi, idx)``, the
        KV heads ``[lo, hi)`` this rank's query heads read (query head
        ``h`` reads KV head ``h // G``) and each local query head's index
        into them; else None."""
        if not self.split["heads"] or self.split["kv"]:
            return None
        cfg = self.cfg
        hl = cfg.n_heads // self.tp
        G = cfg.n_heads // cfg.n_kv_heads
        kv = (torch.arange(hl) + self.model_rank * hl) // G
        lo, hi = int(kv[0]), int(kv[-1]) + 1
        return lo, hi, kv - lo

    # -- the trainer's reductions ------------------------------------------- #
    def leaf_sums(self, stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-leaf statistics (a tensor of the same shape for every leaf,
        e.g. a sum of squares) added up over the groups each leaf is split
        over, so that a split leaf counts once as a whole and a replicated
        leaf once: one all-reduce over ``model`` and one over the data axes
        at most."""
        specs = self.flat_specs
        names = list(stats)
        t = torch.stack([stats[k] for k in names])
        for axis, flag in (("model", lambda s: "model" in s),
                           ("data", lambda s: any(isinstance(e, tuple) for e in s))):
            mask = [flag(specs[k]) for k in names]
            if self._n(axis) == 1 or not any(mask):
                continue
            m = torch.tensor(mask, device=t.device)
            m = m.reshape((-1,) + (1,) * (t.dim() - 1))
            t = torch.where(m, self._all_reduce(torch.where(m, t, 0), axis), t)
        return dict(zip(names, t.unbind(0)))

    def mean_grads(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
        """``(loss, grads)`` averaged over the data axes: one all-reduce
        of the leaves that the data axes do not split and of the loss; an
        FSDP leaf's gradient is already the sum (its gather's backward) and
        is divided."""
        if self.dp == 1:
            return loss, grads
        specs = self.flat_specs
        whole = [k for k in grads
                 if not any(isinstance(e, tuple) for e in specs[k])]
        flat = torch.cat([grads[k].reshape(-1).float() for k in whole]
                         + [loss.reshape(1).float()])
        flat = self._all_reduce(flat, "data") / self.dp
        parts = torch.split(flat[:-1], [grads[k].numel() for k in whole])
        out = {k: g / self.dp for k, g in grads.items()}
        out.update({k: p.reshape(grads[k].shape).to(grads[k].dtype)
                    for k, p in zip(whole, parts)})
        return flat[-1].to(loss.dtype), out

    # -- the dry run's accounting ---------------------------------------------- #
    def collective_summary(self) -> dict:
        """The records as the dry run's ``collectives``: per op, the count
        and the algorithmic bytes a device moves (``roofline._algo_factor``);
        the same per axis and phase; the seconds at the links' rates; and
        ``by_size``, the count of each distinct (op, axis, phase, group
        size, bytes)."""
        from repro_torch.launch.roofline import _algo_factor, collective_seconds
        per_op: Dict[str, float] = {}
        count: Dict[str, int] = {}
        per_axis: Dict[str, float] = {}
        for r in self.records:
            eff = r["bytes"] * _algo_factor(r["op"], r["n"])
            per_op[r["op"]] = per_op.get(r["op"], 0.0) + eff
            count[r["op"]] = count.get(r["op"], 0) + 1
            key = f"{r['axis']}/{r['phase']}"
            per_axis[key] = per_axis.get(key, 0.0) + eff
        sizes: Dict[tuple, int] = {}
        for r in self.records:
            key = (r["op"], r["axis"], r["phase"], r["n"], r["bytes"])
            sizes[key] = sizes.get(key, 0) + 1
        by_size = [dict(zip(("op", "axis", "phase", "n", "bytes"), k), count=c)
                   for k, c in sorted(sizes.items())]
        return {"per_op_bytes": per_op, "op_counts": count, "by_size": by_size,
                "per_axis_phase_bytes": per_axis,
                "total_bytes": sum(per_op.values()),
                "seconds": collective_seconds(self.records)}


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield from tree


def make_ac(mesh, cfg: ModelConfig, mode: str = "dist",
            fsdp: Optional[bool] = None) -> ParallelContext:
    """This rank's :class:`ParallelContext` on ``mesh`` (a ``Mesh``, or a
    ``MeshShape`` in ``record`` mode), the ``ac`` of the model functions."""
    if mode == "dist" and not hasattr(mesh, "group"):
        raise ValueError("make_ac(mode='dist') needs a Mesh with process "
                         "groups; a MeshShape runs in mode='record'")
    return ParallelContext(mesh, cfg, mode, fsdp)

