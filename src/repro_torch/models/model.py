"""Decoder LM of the dense family, the counterpart of the reference package's
``models/model.py``.

One parameter tree, one ``loss_fn`` (training), one ``forward``/
``logits_fn`` (prefill) and one ``decode_step`` (serving), as functions of
``(cfg, params, ...)`` with the reference's names.  The tree has the
reference's structure: ``embed (n_codebooks, V, d)``, ``final_norm (d,)``,
``head (n_codebooks, d, V)`` unless tied, and ``layers`` holding each
layer's ``attn`` and ``mlp`` weights stacked along a leading ``n_layers``
axis, so :func:`params_from_jax` carries the reference's parameters across
one for one.  :class:`DecoderLM` holds such a tree as the ``nn.Parameter``s
of a module.

The port runs the layers in a Python loop (the reference scans them), with
f32 master parameters cast to the compute dtype per layer, as the
reference's ``_cast_layer``.  Under autograd each layer keeps what
``cfg.remat_policy`` says, as the reference's ``jax.checkpoint`` policies
do (``model.py:194-198`` there): ``"none"`` every activation; ``"full"``
only the layer's input, the layer run again in the backward
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` the outputs of its
2-D matrix products (``aten.mm``, the counterpart of
``dots_with_no_batch_dims_saveable``), the rest run again.  A recomputed
layer gives the bits of its first run, so no policy changes a bit of the
loss or the gradients; on the card ``"full"`` launches the attention's
forward kernel twice a layer.  Only the ``dense`` family with global
attention, one codebook and standard RoPE is ported: other configs raise
``NotImplementedError`` (see ROADMAP.md).  ``backend`` (``"auto"`` or
``"ref"``) picks the route of the long-sequence attention, as in
``layers.attention_train``.
"""
from __future__ import annotations

import functools
import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense",)
REMAT_POLICIES = ("none", "full", "dots")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the PyTorch port runs the {PORTED_FAMILIES} famil(ies); "
            f"{cfg.name!r} is {cfg.family!r}, which is still to be ported "
            f"(see ROADMAP.md)")
    unported = [what for what, on in (
        ("sliding_window", cfg.sliding_window is not None),
        ("n_codebooks > 1", cfg.n_codebooks > 1),
        ("rope='mrope'", cfg.rope == "mrope")) if on]
    if unported:
        raise NotImplementedError(
            f"{cfg.name!r} sets {', '.join(unported)}, which the port's dense "
            f"model does not run yet (see ROADMAP.md)")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------- #
# Parameter shapes / init
# --------------------------------------------------------------------------- #
def layer_param_shapes(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    shapes = {"attn": dict(L.attn_param_shapes(cfg), ln=(d,))}
    if cfg.mlp != "none" and cfg.d_ff > 0:
        shapes["mlp"] = dict(L.mlp_param_shapes(cfg), ln=(d,))
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    lsh = {grp: {n: (cfg.n_layers,) + s for n, s in ps.items()}
           for grp, ps in layer_param_shapes(cfg).items()}
    out = {"embed": (cfg.n_codebooks, V, d), "final_norm": (d,),
           "layers": lsh}
    if not cfg.tie_embeddings:
        out["head"] = (cfg.n_codebooks, d, V)
    return out


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) pairs of a nested dict, in sorted key order (the order
    of the reference's tree flattening)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _unflatten(pairs) -> dict:
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def flatten(tree: dict) -> dict:
    """A parameter tree as one flat dict, ``"layers/attn/wq"``-style keys
    in sorted order (the form ``optim`` works on)."""
    return {"/".join(path): t for path, t in _leaves(tree)}


def unflatten(flat: dict) -> dict:
    """The inverse of :func:`flatten`."""
    return _unflatten((tuple(k.split("/")), t) for k, t in flat.items())


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes in ``cfg.param_dtype`` with no storage:
    ``device="meta"`` tensors (the reference's ``jax.ShapeDtypeStruct``
    tree)."""
    dt = _dtype(cfg.param_dtype)
    return _unflatten((path, torch.empty(shp, dtype=dt, device="meta"))
                      for path, shp in _leaves(param_shapes(cfg)))


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Real initialization, as the reference's (``model.py:72-101``) for
    the dense family: norms one, every weight normal / sqrt(fan_in) with
    fan_in its second-to-last axis.  The tensors are made on the
    generator's device in ``cfg.param_dtype``."""
    dt = _dtype(cfg.param_dtype)
    dev = generator.device
    leaves = []
    for path, shp in _leaves(param_shapes(cfg)):
        name = path[-1]
        if "ln" in name or "norm" in name:
            leaves.append((path, torch.ones(shp, dtype=dt, device=dev)))
        else:
            fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
            w = torch.randn(shp, generator=generator, dtype=dt, device=dev)
            leaves.append((path, w / math.sqrt(max(fan_in, 1))))
    return _unflatten(leaves)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference package's parameter tree (``repro.models.model.
    init_params`` or a trained one), as nested dicts of numpy arrays, as the
    port's tree of tensors on ``device`` (default: the card).  Every leaf's
    shape is checked against :func:`param_shapes`."""
    dev = resolve_device(device, "params_from_jax")
    want = dict(_leaves(param_shapes(cfg)))
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    out = []
    for path, arr in got.items():
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(want[path]):
            raise ValueError(f"{'/'.join(path)}: expected shape "
                             f"{want[path]}, got {tuple(a.shape)}")
        out.append((path, torch.from_numpy(np.array(a, copy=True)).to(dev)))
    return _unflatten(out)


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _cast_layer(lp: dict, dtype: torch.dtype) -> dict:
    return {grp: {n: (t.to(dtype) if t.is_floating_point() else t)
                  for n, t in ps.items()} for grp, ps in lp.items()}


def compute_params(cfg: ModelConfig, params: dict) -> dict:
    """``params`` with every weight that ``forward`` and ``decode_step`` cast
    to the compute dtype on each call (the layers', the embedding and the
    head) cast once; ``final_norm``, which is applied in f32, stays.  Both
    functions give the same values on it, without the per-call casts: a
    decode step would otherwise cast every layer's weights each token."""
    cdt = _dtype(cfg.compute_dtype)
    out = {k: (v if k == "final_norm" else v.to(cdt))
           for k, v in params.items() if k != "layers"}
    out["layers"] = _cast_layer(params["layers"], cdt)
    return out


def _layer(params, i: int) -> dict:
    return {grp: {n: t[i] for n, t in ps.items()}
            for grp, ps in params["layers"].items()}


def _block_train(cfg: ModelConfig, lp, x, positions, backend: str):
    lp = _cast_layer(lp, _dtype(cfg.compute_dtype))
    h = L.rms_norm(x, lp["attn"]["ln"], cfg.norm_eps)
    x = x + L.attention_train(lp["attn"], h, cfg, positions, backend=backend)
    if "mlp" in lp:
        h = L.rms_norm(x, lp["mlp"]["ln"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.mlp)
    return x


# --------------------------------------------------------------------------- #
# Forward (training / prefill)
# --------------------------------------------------------------------------- #
def _embed(cfg: ModelConfig, params, tokens):
    """tokens: (B, S) or (B,)."""
    return params["embed"][0][tokens].to(_dtype(cfg.compute_dtype))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, block):
    """``block`` under ``cfg.remat_policy`` (see the module docstring)."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"expected one of {REMAT_POLICIES}")
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return block
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: ckpt.checkpoint(block, *a, use_reentrant=False, **kw)


def forward(cfg: ModelConfig, params, tokens, positions=None,
            backend: str = "auto"):
    """Final-normed hidden states (B, S, d) in the compute dtype."""
    _check_family(cfg)
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    block = _remat(cfg, functools.partial(_block_train, cfg))
    for i in range(cfg.n_layers):
        x = block(_layer(params, i), x, positions, backend)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_fn(cfg: ModelConfig, params, x):
    head = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
            else params["head"])
    return x @ head[0].to(x.dtype)


def loss_fn(cfg: ModelConfig, params, batch, backend: str = "auto"):
    """batch: {'tokens': (B, S), ['positions']}.  Next-token cross entropy,
    in f32."""
    tokens = batch["tokens"]
    x = forward(cfg, params, tokens, batch.get("positions"), backend)
    logits = logits_fn(cfg, params, x[:, :-1]).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
    return (lse - gold).mean()


# --------------------------------------------------------------------------- #
# Decode (serving)
# --------------------------------------------------------------------------- #
def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """KV cache shapes, (n_layers, batch, seq_len, KV, hd) each."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> dict:
    dev = resolve_device(device, "init_cache")
    dt = _dtype(cfg.compute_dtype)
    return {n: torch.zeros(s, dtype=dt, device=dev)
            for n, s in cache_shapes(cfg, batch, seq_len).items()}


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, position):
    """One decoding step for the whole stack.

    tokens: (B,); position: scalar or (B,) write indices (per-sequence:
    continuous-batching slots may be at different depths).  The cache is
    updated in place (the reference returns a new one; in place saves a
    copy of the cache per step).  Returns (logits (B, V) in the compute
    dtype, cache)."""
    _check_family(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, tokens)[:, None]
    for i in range(cfg.n_layers):
        lp = _cast_layer(_layer(params, i), cdt)
        h = L.rms_norm(x, lp["attn"]["ln"], cfg.norm_eps)
        a, _, _ = L.attention_decode(
            lp["attn"], h, cfg, cache["k"][i], cache["v"][i], position)
        x = x + a
        if "mlp" in lp:
            h = L.rms_norm(x, lp["mlp"]["ln"], cfg.norm_eps)
            x = x + L.mlp_apply(lp["mlp"], h, cfg.mlp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x[:, 0]), cache


# --------------------------------------------------------------------------- #
# Module form
# --------------------------------------------------------------------------- #
class DecoderLM(nn.Module):
    """The parameter tree as the ``nn.Parameter``s of a module, on one
    device (default: the card).  ``params`` is a tree as
    :func:`init_params` or :func:`params_from_jax` make it; without one the
    module initializes its own from ``seed``."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device, "DecoderLM")
        _check_family(cfg)
        self.cfg = cfg
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed))
        self._paths = []
        for path, t in _leaves(params):
            name = "__".join(path)
            self.register_parameter(name, nn.Parameter(t.to(dev)))
            self._paths.append((path, name))

    @property
    def params(self) -> dict:
        """The parameters as the functions' nested tree (the same tensors)."""
        return _unflatten((p, getattr(self, n)) for p, n in self._paths)

    def forward(self, tokens, positions=None) -> torch.Tensor:
        """Logits (B, S, V) in the compute dtype."""
        p = self.params
        return logits_fn(self.cfg, p, forward(self.cfg, p, tokens, positions))
