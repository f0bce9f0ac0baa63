"""Transformer building blocks, the counterparts of the reference package's
``models/layers.py``: norms, RoPE and M-RoPE, GQA attention (full or
sliding-window, the long-sequence flash path, and single-step decode against
a KV cache, a ring buffer where every layer is windowed), and the MLP
variants.

Activations keep the reference's ``(B, S, H, hd)`` layout.  The long branch
of :func:`attention_train` (``S > 2048``) goes through
``repro_torch.kernels.flash``.  Its ``backend`` picks the route, as a
projector spec's does: ``"auto"`` runs the kernels on a CUDA tensor and the
plain version (the reference's 1024-wide chunked online softmax) on a CPU
tensor; ``"ref"`` runs the plain version on any device, the reference that
the kernels are held against on the card.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30

# Sequences longer than this take the flash path (layers.py:128 of the
# reference); it works in chunks of FLASH_CHUNK query rows and keys.
SDPA_MAX_SEQ = 2048
FLASH_CHUNK = 1024

BACKENDS = ("auto", "ref")


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary embeddings
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim / 2,) f32 inverse frequencies, made once per (head_dim,
    theta, device): a decode step applies RoPE twice in every layer."""
    return _rope_freqs(head_dim, theta, torch.device(device or "cpu"))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_section_ids(sections: Tuple[int, ...], device: torch.device):
    """(sum(sections),): each frequency's section, made once per device."""
    return torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                        device=device)


def apply_mrope(x, positions3, sections: Tuple[int, ...],
                theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE.  positions3: (3, ..., S), the temporal,
    height and width ids; ``sections`` split the half-dim, and each section
    rotates with its own ids."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    sec = _mrope_section_ids(tuple(sections), x.device)
    pos = positions3[sec].movedim(0, -1)                    # (..., S, hd/2)
    ang = pos.float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
def _split(ac, part: str) -> bool:
    """Whether ``part`` of the layer runs on this rank's columns."""
    return ac is not None and ac.split[part]


def _qkv(params, x, cfg: ModelConfig, positions, ac=None):
    """q (B,S,H,hd) and k, v (B,S,KV,hd): the rank's heads where ``wq``
    splits (``launch/sharding``): its own KV heads where ``wk`` splits too,
    else the KV heads its query heads read (``ac.kv_heads``; ``_local_kv``
    then gives each query head its own)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    wk, wv = params["wk"], params["wv"]
    qn, kn = params.get("q_norm"), params.get("k_norm")
    if _split(ac, "heads"):
        # replicated leaves whose gradient each rank forms for its heads
        kv = ac.kv_heads()
        if kv is not None:
            cols = slice(kv[0] * hd, kv[1] * hd)
            wk, wv = ac.copy(wk)[:, cols], ac.copy(wv)[:, cols]
        if cfg.qk_norm:
            qn, kn = ac.copy(qn), ac.copy(kn)
    q = (x @ params["wq"]).reshape(B, S, -1, hd)
    k = (x @ wk).reshape(B, S, -1, hd)
    v = (x @ wv).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    if cfg.rope == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    return q, k, v


def _local_kv(t, ac):
    """``t`` (B, T, hi - lo, hd), the KV heads ``ac.kv_heads`` names, as
    one KV head for each of this rank's query heads, where ``wq`` splits
    and ``wk`` does not."""
    kv = ac.kv_heads() if ac is not None else None
    return t if kv is None else t.index_select(2, kv[2].to(t.device))


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,S,H,hd) k,v: (B,T,KV,hd); mask (S,T) bool (True=keep)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def _causal_mask(S: int, T: int, window: Optional[int], device=None):
    """(S, T) keep-mask; a global layer passes ``window=None``."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    m = kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def _flash(q, k, v, window: Optional[int], backend: str):
    """The long branch: (B, S, H, hd) in and out, through the flash module
    on transposed views (no copies: the kernels take strides).  The kernels
    are built for every head dim of the repo's configs
    (``flash.KERNEL_HEAD_DIMS``); another head dim is decided from the
    shape, before any launch: on CUDA tensors it raises
    NotImplementedError, CPU tensors take the plain version there, as the
    wrappers do for every head dim on the CPU."""
    hd = q.shape[-1]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if backend == "ref":
        run = flash.flash_attention_plain
    elif not flash.has_kernel(hd):
        if q.is_cuda:
            raise NotImplementedError(
                f"the flash kernels are built for head dims "
                f"{flash.KERNEL_HEAD_DIMS}, not {hd}: sequences longer than "
                f"{SDPA_MAX_SEQ} at this head dim need its instance in "
                f"kernels/csrc/flash.cu; backend='ref' runs the plain "
                f"attention")
        run = flash.flash_attention_plain
    elif needs_grad:
        run = flash.flash_attention_diff
    else:
        run = flash.flash_attention
    return run(q, k, v, window).transpose(1, 2)


def attention_train(params, x, cfg: ModelConfig, positions,
                    window: Optional[int] = None, backend: str = "auto",
                    ac=None):
    """Full-sequence causal attention, over the last ``window`` keys of each
    query where ``window`` is given (a global layer of a windowed stack
    passes None).  ``S <= 2048``: dense masked softmax; longer: flash
    attention (memory O(S * chunk) instead of O(S^2)), whose
    chunks need ``S % 1024 == 0`` as in the reference, on ``backend``
    (``"auto"`` or ``"ref"``, see the module's docstring).  With ``ac`` (a
    rank's ``launch/sharding.ParallelContext``) the layer is a region
    (``ac.enter`` / ``ac.exit``): where ``wq`` splits, the rank runs its own
    heads and ``wo`` row-parallel, then one reduce."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    tp = _split(ac, "heads")
    if ac is not None:
        x = ac.enter(x, tp)
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions, ac)
    k, v = _local_kv(k, ac), _local_kv(v, ac)
    if S <= SDPA_MAX_SEQ:
        out = _sdpa(q, k, v, _causal_mask(S, S, window, device=x.device), cfg)
    else:
        if S % FLASH_CHUNK:
            raise ValueError(
                f"sequences longer than {SDPA_MAX_SEQ} run the chunked flash "
                f"path, which needs S to be a multiple of {FLASH_CHUNK}; got "
                f"S={S}")
        out = _flash(q, k, v, window, backend)
    out = out.reshape(B, S, -1) @ params["wo"]
    return out if ac is None else ac.exit(out, tp)


def attention_decode(params, x, cfg: ModelConfig, cache_k, cache_v,
                     position, window: Optional[int] = None,
                     is_global: Optional[bool] = None, ac=None):
    """One-token decode.  cache_k/v: (B, S_max, KV, hd), written in place at
    each sequence's slot; position: (B,) per-sequence write index
    (continuous batching: every slot may be at a different depth).  With a
    ``window``, a layer attends to the last ``window`` positions unless
    ``is_global`` (a stack of windowed and global layers passes each layer's
    flag); where ``is_global`` is None and the cache is ``window`` long, the
    cache is a ring buffer written at ``position % window``.  Returns (out
    (B,1,d), cache_k, cache_v).  With ``ac`` whose ``wq`` splits, the
    rank runs its own heads on its heads' cache (where ``wk`` does not
    split, the KV heads its query heads read) and reduces the output."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    if ac is not None:
        x = ac.enter(x, _split(ac, "heads"))
    position = torch.as_tensor(position, dtype=torch.int64,
                               device=x.device).expand(B)
    pos = position[:, None]                                     # (B, 1)
    if cfg.rope == "mrope":
        # decode: all three M-RoPE sections advance with the token index
        pos = pos[None].expand(3, B, 1)
    q, k, v = _qkv(params, x, cfg, pos, ac)
    S_max = cache_k.shape[1]
    ring = window is not None and S_max == window and is_global is None
    slot = position % window if ring else position
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]
    kp = torch.arange(S_max, device=x.device)[None, :]        # (1, S)
    if ring:
        valid = kp < torch.clamp(position + 1, max=window)[:, None]
    else:
        valid = kp <= position[:, None]
        if window is not None and not is_global:
            valid &= kp > position[:, None] - window
    ck, cv = _local_kv(cache_k, ac), _local_kv(cache_v, ac)
    H, KV = q.shape[2], ck.shape[2]
    q = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", q, ck).float()
    s = s / math.sqrt(hd)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, cv).reshape(B, 1, H * hd)
    out = out @ params["wo"]
    return (out if ac is None else ac.exit(out, _split(ac, "heads"))), cache_k, cache_v


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #
def mlp_apply(params, x, kind: str, ac=None):
    """With ``ac`` whose ``w1`` splits: ``w1``/``w3`` column-parallel,
    ``w2`` row-parallel, then one reduce."""
    tp = _split(ac, "mlp")
    if ac is not None:
        x = ac.enter(x, tp)
    if kind == "swiglu":
        y = (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]
    elif kind == "sq_relu":
        y = torch.relu(x @ params["w1"]).square() @ params["w2"]
    elif kind == "gelu":
        y = F.gelu(x @ params["w1"], approximate="tanh") @ params["w2"]
    else:
        raise ValueError(kind)
    return y if ac is None else ac.exit(y, tp)


# --------------------------------------------------------------------------- #
# Parameter shapes (used by model.init_params)
# --------------------------------------------------------------------------- #
def attn_param_shapes(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def mlp_param_shapes(cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
    return {"w1": (d, ff), "w2": (ff, d)}
