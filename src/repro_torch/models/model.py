"""Decoder LM covering every family of the repo's configs, the counterpart
of the reference package's ``models/model.py``.

One parameter tree, one ``loss_fn`` (training), one ``forward``/
``logits_fn`` (prefill) and one ``decode_step`` (serving), as functions of
``(cfg, params, ...)`` with the reference's names.  The per-layer block is
selected by ``cfg.family``:

    dense / vlm / audio : [attn] + [mlp]
    moe                 : [attn] + [moe]
    ssm                 : [mamba]
    hybrid (Hymba)      : [attn || mamba  (parallel, mean-fused)] + [mlp]

The tree has the reference's structure: ``embed (n_codebooks, V, d)``,
``final_norm (d,)``, ``head (n_codebooks, d, V)`` unless tied, and
``layers`` holding each layer's ``attn``, ``ssm``, ``moe`` and ``mlp``
groups stacked along a leading ``n_layers`` axis, so
:func:`params_from_jax` carries the reference's parameters across one for
one.  :class:`DecoderLM` holds such a tree as the ``nn.Parameter``s of a
module.

The port runs the layers in a Python loop (the reference scans them), with
f32 master parameters cast to the compute dtype per layer, as the
reference's ``_cast_layer`` (the SSM's ``A_log``, ``dt_bias`` and ``D``
stay f32).  A layer of a windowed stack is windowed or global
(``_layer_windows``): a global layer passes ``window=None`` to the
attention.  Under autograd each layer keeps what ``cfg.remat_policy``
says, as the reference's ``jax.checkpoint`` policies do (``model.py:194-198``
there): ``"none"`` every activation; ``"full"`` only the layer's input, the
layer run again in the backward (``torch.utils.checkpoint``,
non-reentrant); ``"dots"`` the outputs of its 2-D matrix products
(``aten.mm``, the counterpart of ``dots_with_no_batch_dims_saveable``), the
rest run again.  A recomputed layer gives the bits of its first run, so no
policy changes a bit of the loss or the gradients; on the card ``"full"``
launches the attention's forward kernel twice a layer.  ``backend``
(``"auto"`` or ``"ref"``) picks the route of the long-sequence attention, as
in ``layers.attention_train``.

``forward``, ``loss_fn``, ``logits_fn`` and ``decode_step`` take the
reference's ``ac``: here a rank's ``launch/sharding.ParallelContext``
(None: one device, no collective), with ``params`` the rank's shards
(``sharding.shard_params``).  Each part that splits runs on the rank's
columns and reduces its output (``layers``, ``moe``, ``mamba``); a part
the divisibility guard leaves replicated runs whole on every rank and its
output is not reduced (Hymba's 25 heads beside its split Mamba branch).
The embedding is vocab-parallel (ids outside the rank's range masked, then
one reduce), the head column-parallel (a tied head on the embedding's V
shard), the loss a vocab-parallel f32 cross entropy (the max, the sum of
exps and the target logit reduced over ``model``), and the serving logits
all-gathered over V.  FSDP leaves are gathered over the data axes where
they are used (a layer's inside its remat region).
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
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

REMAT_POLICIES = ("none", "full", "dots")
_F32_LEAVES = {"A_log", "dt_bias", "D"}   # SSM dynamics stay f32


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------- #
# Parameter shapes / init
# --------------------------------------------------------------------------- #
def layer_param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    shapes = {}
    if cfg.uses_attention:
        shapes["attn"] = dict(L.attn_param_shapes(cfg), ln=(d,))
    if cfg.uses_ssm:
        shapes["ssm"] = dict(M.ssm_param_shapes(cfg), ln=(d,))
    if cfg.family == "moe":
        shapes["moe"] = dict(MOE.moe_param_shapes(cfg), ln=(d,))
    elif cfg.mlp != "none" and cfg.d_ff > 0:
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
    """Real initialization, as the reference's (``model.py:72-101``): norms
    and the SSM's ``D`` one, ``A_log = log(1..N)`` (f32), ``dt_bias`` the
    inverse softplus of a dt log-uniform in [1e-3, 1e-1], biases (``*_b``)
    zero, every other weight normal / sqrt(fan_in) with fan_in its
    second-to-last axis.  The tensors are made on the generator's device in
    ``cfg.param_dtype``."""
    dt = _dtype(cfg.param_dtype)
    dev = generator.device
    leaves = []
    for path, shp in _leaves(param_shapes(cfg)):
        name = path[-1]
        if "ln" in name or "norm" in name or name == "D":
            t = torch.ones(shp, dtype=dt, device=dev)
        elif name == "A_log":
            t = torch.log(torch.arange(1, shp[-1] + 1, dtype=torch.float32,
                                       device=dev)).expand(shp).contiguous()
        elif name == "dt_bias":
            u = torch.rand(shp, generator=generator, device=dev)
            dtv = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            t = torch.log(torch.expm1(dtv)).to(dt)
        elif name.endswith("_b") or name == "bias":
            t = torch.zeros(shp, dtype=dt, device=dev)
        else:
            fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
            t = torch.randn(shp, generator=generator, dtype=dt, device=dev)
            t = t / math.sqrt(max(fan_in, 1))
        leaves.append((path, t))
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
    return {grp: {n: (t.to(dtype) if t.is_floating_point() and n not in _F32_LEAVES
                      else t)
                  for n, t in ps.items()} for grp, ps in lp.items()}


def compute_params(cfg: ModelConfig, params: dict) -> dict:
    """``params`` with every weight that ``forward`` and ``decode_step`` cast
    to the compute dtype on each call (the layers', the embedding and the
    head) cast once; ``final_norm``, which is applied in f32, the SSM's f32
    leaves, and a multi-codebook embedding, whose codebooks are summed
    before the cast, stay.  Both functions give the same values on it,
    without the per-call casts: a decode step would otherwise cast every
    layer's weights each token."""
    cdt = _dtype(cfg.compute_dtype)
    keep = {"final_norm"} | ({"embed"} if cfg.n_codebooks > 1 else set())
    out = {k: (v if k in keep else v.to(cdt))
           for k, v in params.items() if k != "layers"}
    out["layers"] = _cast_layer(params["layers"], cdt)
    return out


def _layer(params, i: int) -> dict:
    return {grp: {n: t[i] for n, t in ps.items()}
            for grp, ps in params["layers"].items()}


def _layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per layer: True = global attention, False = sliding window.  Every
    ``global_attn_every``-th layer is global, and the last."""
    if cfg.sliding_window is None:
        return np.ones((cfg.n_layers,), bool)
    if cfg.global_attn_every <= 0:
        return np.zeros((cfg.n_layers,), bool)
    g = np.zeros((cfg.n_layers,), bool)
    g[::cfg.global_attn_every] = True
    g[-1] = True
    return g


def _ln(scale, ac):
    """A norm's scale on the residual stream: under sequence parallelism
    a rank applies it to its positions only (``ac.seq_shared``)."""
    return scale if ac is None else ac.seq_shared(scale)


def _block_train(cfg: ModelConfig, lp, x, positions, window: Optional[int],
                 backend: str, ac=None):
    """One layer; ``window`` is this layer's (None: global)."""
    if ac is not None:
        lp = ac.unshard_layer(lp)
    lp = _cast_layer(lp, _dtype(cfg.compute_dtype))
    if cfg.family == "ssm":
        h = L.rms_norm(x, _ln(lp["ssm"]["ln"], ac), cfg.norm_eps)
        return x + M.mamba_train(lp["ssm"], h, cfg, ac=ac)
    h = L.rms_norm(x, _ln(lp["attn"]["ln"], ac), cfg.norm_eps)
    a = L.attention_train(lp["attn"], h, cfg, positions, window=window,
                          backend=backend, ac=ac)
    if cfg.family == "hybrid":
        s = M.mamba_train(lp["ssm"], L.rms_norm(x, _ln(lp["ssm"]["ln"], ac),
                                                cfg.norm_eps), cfg, ac=ac)
        x = x + 0.5 * (a + s)
    else:
        x = x + a
    if "moe" in lp:
        h = L.rms_norm(x, _ln(lp["moe"]["ln"], ac), cfg.norm_eps)
        y, _ = MOE.moe_apply(lp["moe"], h, cfg, ac)    # the aux loss is not added
        x = x + y
    elif "mlp" in lp:
        h = L.rms_norm(x, _ln(lp["mlp"]["ln"], ac), cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.mlp, ac)
    return x


# --------------------------------------------------------------------------- #
# Forward (training / prefill)
# --------------------------------------------------------------------------- #
def _top(params, key: str, ac):
    """A top-level leaf, gathered over the data axes where FSDP split it."""
    if ac is None:
        return params[key]
    return ac.unshard(ac.specs[key], params[key])


def _vocab_split(ac) -> bool:
    return ac is not None and ac.split["vocab"]


def _embed(cfg: ModelConfig, params, tokens, vision_embeds=None, ac=None):
    """tokens: (B, S) or (B, nq, S) for multi-codebook, (B,) or (B, nq) in
    decode; the codebooks' embeddings summed, ``vision_embeds`` (B, n_vis,
    d) put before the text.  Vocab-parallel under ``ac``: each rank looks
    up the ids of its vocabulary range, zeros elsewhere, and one reduce
    adds the ranks' rows (each id's row comes from one rank)."""
    emb = _top(params, "embed", ac)
    if _vocab_split(ac):
        lo, hi = ac.vocab_range()

        def look(e, t):
            inside = (t >= lo) & (t < hi)
            rows = e[torch.where(inside, t - lo, 0)]
            return torch.where(inside[..., None], rows, 0)
    else:
        def look(e, t):
            return e[t]
    if cfg.n_codebooks > 1:
        x = sum(look(emb[q], tokens[:, q]) for q in range(cfg.n_codebooks))
    else:
        x = look(emb[0], tokens)
    if _vocab_split(ac):
        x = ac.reduce(x)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x.to(_dtype(cfg.compute_dtype))


def _positions(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)[None].expand(B, S)
    if cfg.rope == "mrope":
        # text-only stub: all three sections share the temporal index
        return pos[None].expand(3, B, S)
    return pos


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
            backend: str = "auto", vision_embeds=None, ac=None):
    """Final-normed hidden states (B, n_vis + S, d) in the compute dtype.
    ``positions``: (B, n_vis + S), or (3, B, n_vis + S) under M-RoPE.
    Under ``ac`` with ``cfg.seq_shard`` (sequence parallelism, where the
    sequence splits over ``model``) the layers' residual stream holds the
    rank's positions: each region gathers the sequence on entry and
    reduce-scatters it on exit, the norms run on the rank's positions, and
    the final states are gathered whole."""
    x = _embed(cfg, params, tokens, vision_embeds, ac)
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(cfg, B, S, x.device)
    if ac is not None:
        # sequence parallelism: the residual stream holds S / tp positions
        ac = ac.for_seq(S)
        x = ac.exit(x, False)
    block = _remat(cfg, functools.partial(_block_train, cfg))
    for i, is_global in enumerate(_layer_windows(cfg)):
        x = block(_layer(params, i), x, positions,
                  None if is_global else cfg.sliding_window, backend, ac)
    x = L.rms_norm(x, _ln(_top(params, "final_norm", ac), ac), cfg.norm_eps)
    return x if ac is None else ac.enter(x, False)


def logits_fn(cfg: ModelConfig, params, x, codebook: int = 0, ac=None):
    """Logits of ``codebook``; under a vocab-parallel ``ac``, this rank's
    columns of V (column-parallel head)."""
    head = (_top(params, "embed", ac).transpose(1, 2) if cfg.tie_embeddings
            else _top(params, "head", ac))
    if _vocab_split(ac):
        x = ac.copy(x)
    return x @ head[codebook].to(x.dtype)


def _vocab_parallel_ce(logits, labels, ac):
    """Per-position cross entropy of f32 ``logits`` (this rank's columns of
    V): the global max (no gradient), the sum of exps and the target logit
    reduced over ``model``."""
    lo, hi = ac.vocab_range()
    m = ac.reduce_max(logits.detach().amax(dim=-1))
    lse = m + torch.log(ac.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
    inside = (labels >= lo) & (labels < hi)
    gold = torch.gather(logits, -1,
                        torch.where(inside, labels - lo, 0)[..., None].long())[..., 0]
    return lse - ac.reduce(torch.where(inside, gold, 0))


def loss_fn(cfg: ModelConfig, params, batch, backend: str = "auto", ac=None):
    """batch: {'tokens': (B, S) or (B, nq, S), ['vision_embeds'],
    ['positions']}.  Next-token cross entropy in f32, over the text
    positions only (a VLM's vision embeddings have no labels), the mean
    over codebooks."""
    tokens = batch["tokens"]
    ve = batch.get("vision_embeds")
    x = forward(cfg, params, tokens, batch.get("positions"), backend, ve, ac)
    x = x[:, 0 if ve is None else ve.shape[1]:]

    def ce(q, labels):
        logits = logits_fn(cfg, params, x[:, :-1], q, ac).float()
        if _vocab_split(ac):
            return _vocab_parallel_ce(logits, labels, ac).mean()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return (lse - gold).mean()

    if cfg.n_codebooks > 1:
        return sum(ce(q, tokens[:, q, 1:])
                   for q in range(cfg.n_codebooks)) / cfg.n_codebooks
    return ce(0, tokens[:, 1:])


# --------------------------------------------------------------------------- #
# Decode (serving)
# --------------------------------------------------------------------------- #
def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int, ac=None) -> dict:
    """The decode cache's entries as ``(shape, dtype name)``: ``k``/``v``
    (n_layers, batch, s, KV, hd) where attention runs, with ``s`` the window
    where every layer is windowed (a ring buffer) and ``seq_len`` otherwise;
    ``conv`` (n_layers, batch, d_conv - 1, d_inner) and ``ssm`` (n_layers,
    batch, d_inner, d_state) in f32 where an SSM runs.  Under ``ac``, a
    rank's: its KV heads where ``wk`` splits, else the KV heads its query
    heads read (``ac.kv_heads``) where ``wq`` splits; its channels where
    ``in_proj`` splits (``sharding.cache_specs``)."""
    cdt = cfg.compute_dtype
    Lc = cfg.n_layers
    kv = cfg.n_kv_heads
    if ac is not None and ac.split["kv"]:
        kv //= ac.tp
    elif ac is not None and ac.kv_heads() is not None:
        kv = ac.kv_heads()[1] - ac.kv_heads()[0]
    di_n = ac.tp if ac is not None and ac.split["ssm"] else 1
    out = {}
    if cfg.uses_attention:
        s = seq_len
        if cfg.sliding_window is not None and cfg.global_attn_every <= 0:
            s = min(seq_len, cfg.sliding_window)
        shape = (Lc, batch, s, kv, cfg.resolved_head_dim)
        out["k"] = out["v"] = (shape, cdt)
    if cfg.uses_ssm:
        di = cfg.d_inner // di_n
        out["conv"] = ((Lc, batch, cfg.ssm.d_conv - 1, di), cdt)
        out["ssm"] = ((Lc, batch, di, cfg.ssm.d_state), "float32")
    return out


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None, ac=None) -> dict:
    dev = resolve_device(device, "init_cache")
    return {n: torch.zeros(s, dtype=_dtype(dt), device=dev)
            for n, (s, dt) in cache_shapes(cfg, batch, seq_len, ac).items()}


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, position,
                ac=None):
    """One decoding step for the whole stack.

    tokens: (B,) or (B, nq); position: scalar or (B,) write indices
    (per-sequence: continuous-batching slots may be at different depths).
    The cache is updated in place (the reference returns a new one; in
    place saves a copy of the cache per step).  Returns (logits (B, V), or
    (B, nq, V) for multi-codebook, in the compute dtype, cache); under a
    vocab-parallel ``ac`` the logits are all-gathered over V."""
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, tokens, ac=ac)[:, None]
    windowed = cfg.global_attn_every > 0
    for i, is_global in enumerate(_layer_windows(cfg)):
        lp = _layer(params, i)
        if ac is not None:
            lp = ac.unshard_layer(lp)
        lp = _cast_layer(lp, cdt)
        if cfg.uses_attention:
            h = L.rms_norm(x, lp["attn"]["ln"], cfg.norm_eps)
            a, _, _ = L.attention_decode(
                lp["attn"], h, cfg, cache["k"][i], cache["v"][i], position,
                window=cfg.sliding_window,
                is_global=bool(is_global) if windowed else None, ac=ac)
        if cfg.uses_ssm:
            h = L.rms_norm(x, lp["ssm"]["ln"], cfg.norm_eps)
            s, conv, ssm = M.mamba_decode(lp["ssm"], h, cfg, cache["conv"][i],
                                          cache["ssm"][i], ac=ac)
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        if cfg.family == "hybrid":
            x = x + 0.5 * (a + s)
        elif cfg.family == "ssm":
            x = x + s
        else:
            x = x + a
        if "moe" in lp:
            h = L.rms_norm(x, lp["moe"]["ln"], cfg.norm_eps)
            x = x + MOE.moe_apply(lp["moe"], h, cfg, ac)[0]
        elif "mlp" in lp:
            h = L.rms_norm(x, lp["mlp"]["ln"], cfg.norm_eps)
            x = x + L.mlp_apply(lp["mlp"], h, cfg.mlp, ac)
    x = L.rms_norm(x, _top(params, "final_norm", ac), cfg.norm_eps)[:, 0]
    if cfg.n_codebooks > 1:
        lg = torch.stack([logits_fn(cfg, params, x, q, ac)
                          for q in range(cfg.n_codebooks)], dim=1)
    else:
        lg = logits_fn(cfg, params, x, ac=ac)
    return (ac.gather_model(lg, -1) if _vocab_split(ac) else lg), cache


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

    def forward(self, tokens, positions=None, vision_embeds=None) -> torch.Tensor:
        """Logits (B, S, V), or (B, nq, S, V) for multi-codebook, in the
        compute dtype."""
        p = self.params
        x = forward(self.cfg, p, tokens, positions, vision_embeds=vision_embeds)
        if self.cfg.n_codebooks > 1:
            return torch.stack([logits_fn(self.cfg, p, x, q)
                                for q in range(self.cfg.n_codebooks)], dim=1)
        return logits_fn(self.cfg, p, x)
