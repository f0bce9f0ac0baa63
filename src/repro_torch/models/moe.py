"""Mixture-of-Experts layer (Grok-1 / OLMoE style: softmax router, top-k),
the counterpart of the reference package's ``models/moe.py``.

Three implementations, selected by ``cfg.moe.impl``:

* ``dense``  — every expert runs on every token, combined with the (sparse)
  gate weights: n_experts / top_k times the active FLOPs, no data-dependent
  shapes.
* ``ragged`` — the token slots sorted by expert and each expert's rows
  multiplied by its weights (the reference's ``jax.lax.ragged_dot``; here
  one ``torch.matmul`` per expert on group sizes read once per layer).
* ``gather`` — each sequence (group) dispatches its slots to a per-expert
  capacity buffer (B, E, C, d); slots past the capacity ``C`` are dropped,
  in the order of a stable sort by expert, as in the reference.

Every path sums a token's ``k`` expert outputs in slot order (un-sorted to
``(T, k, d)`` and summed over ``k``), not by scatter-adds, whose order on
the card is not fixed.

Under tensor parallelism (``ac``, a rank's ``launch/sharding.
ParallelContext``, whose expert ``w1`` splits) the expert ``d_ff`` is on
the ``model`` axis (EP == TP, as in the reference): every rank routes
every token with the replicated router, runs its slice of every expert's
FFN, adds up the gated partial outputs, and one reduce sums them
(``_route``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

IMPLS = ("dense", "ragged", "gather")
CAPACITY_FACTOR = 1.25


def moe_param_shapes(cfg: ModelConfig):
    d = cfg.d_model
    m = cfg.moe
    ff = m.expert_d_ff
    shapes = {"router": (d, m.n_experts),
              "w1": (m.n_experts, d, ff), "w2": (m.n_experts, ff, d)}
    if cfg.mlp == "swiglu":
        shapes["w3"] = (m.n_experts, d, ff)
    return shapes


def _act(h, kind: str):
    if kind == "sq_relu":
        return torch.relu(h).square()
    return F.gelu(h, approximate="tanh")


def _expert_ffn(params, x, kind):
    """x: (E, T, d) — per-expert batch (an expanded view is fine)."""
    h = torch.matmul(x, params["w1"])
    h = F.silu(h) * torch.matmul(x, params["w3"]) if kind == "swiglu" else _act(h, kind)
    return torch.matmul(h, params["w2"])


def _router(params, x, cfg: ModelConfig):
    """x: (T, d) -> gates (T, k) f32, experts (T, k), probs (T, E) f32."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, experts, probs


def _aux_loss(probs, experts, E: int):
    """Load-balancing auxiliary loss (Switch-style)."""
    frac_tokens = F.one_hot(experts[..., 0], E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * (frac_tokens * frac_probs).sum()


def _inverse(order):
    """The inverse of permutations along the last axis."""
    inv = torch.empty_like(order)
    idx = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return inv.scatter_(-1, order, idx)


def _tp(ac) -> bool:
    return ac is not None and ac.split["moe"]


def _route(params, x, cfg: ModelConfig, ac):
    """The router's output for x (B, S, d) on a rank, and the experts'
    input (the region's, ``ac.enter``).  The router runs on the rank's
    positions (all of them but under sequence parallelism, where its
    outputs are then gathered); the gates enter the region as the
    experts' input does, since under tensor parallelism each rank forms
    only its part of their gradient."""
    tp = _tp(ac)
    B, S, d = x.shape
    router = {"router": ac.seq_shared(params["router"])}
    gates, experts, probs = _router(router, x.reshape(B * S, d), cfg)
    k = gates.shape[-1]
    gates = ac.enter(gates.reshape(B, S, k), tp)
    if ac.seq:
        experts = ac.gather_model(experts.reshape(B, S, k), 1)
        probs = ac.gather_model(probs.reshape(B, S, -1), 1)
    T = gates.shape[0] * gates.shape[1]
    return ((gates.reshape(T, k), experts.reshape(T, k), probs.reshape(T, -1)),
            ac.enter(x, tp))


def moe_dense(params, x, cfg: ModelConfig, routed=None):
    """x: (B, S, d).  All-experts path.  ``routed``: the router's
    ``(gates, experts, probs)`` for x, made by the caller (else here)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gates, experts, probs = routed or _router(params, xt, cfg)
    E = cfg.moe.n_experts
    ye = _expert_ffn(params, xt[None].expand(E, B * S, d), cfg.mlp)   # (E, T, d)
    # combine: one-hot over the small E axis only (T x k x E)
    onehot = F.one_hot(experts, E).to(x.dtype)
    comb = torch.einsum("tke,tk->te", onehot, gates.to(x.dtype))
    y = torch.einsum("etd,te->td", ye, comb)
    return y.reshape(B, S, d), _aux_loss(probs, experts, E)


def moe_ragged(params, x, cfg: ModelConfig, routed=None):
    """Sorted/grouped-matmul path: FLOPs ~ active params only."""
    B, S, d = x.shape
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    T = B * S
    xt = x.reshape(T, d)
    gates, experts, probs = routed or _router(params, xt, cfg)
    flat_e = experts.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    xs = xt[order // k]                                     # (T*k, d) sorted
    sizes = torch.bincount(flat_e, minlength=E).tolist()

    def grouped(a, w):
        return torch.cat([torch.matmul(part, w[e]) for e, part in
                          enumerate(torch.split(a, sizes)) if sizes[e]])

    h = grouped(xs, params["w1"])
    h = F.silu(h) * grouped(xs, params["w3"]) if cfg.mlp == "swiglu" else _act(h, cfg.mlp)
    ys = grouped(h, params["w2"])                           # (T*k, d)
    ys = ys * gates.reshape(T * k)[order][:, None].to(x.dtype)
    y = ys[_inverse(order)].reshape(T, k, d).sum(dim=1)
    return y.reshape(B, S, d), _aux_loss(probs, experts, E)


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per (group, expert) of ``moe_gather`` for sequences of S."""
    m = cfg.moe
    return max(4, int(round((m.top_k * S / m.n_experts) * CAPACITY_FACTOR)))


def moe_gather(params, x, cfg: ModelConfig, stats=None, routed=None):
    """Grouped capacity-based gather dispatch (GShard-style): each sequence
    puts its token slots, sorted stably by expert, into a per-expert buffer
    of ``capacity(cfg, S)`` rows; a slot past its expert's capacity is
    dropped (its output is zero).  ``stats``, a dict, gets the count of
    dropped slots under ``"dropped"`` (a tensor, added to)."""
    B, S, d = x.shape
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    C = capacity(cfg, S)
    gates, experts, probs = routed or _router(params, x.reshape(B * S, d), cfg)
    flat_e = experts.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=1, stable=True)      # per-group sort
    sorted_e = torch.gather(flat_e, 1, order)
    ids = torch.arange(E, device=x.device).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, ids)
    rank = torch.arange(S * k, device=x.device)[None] - torch.gather(starts, 1, sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)   # E*C = drop bin
    src_tok = order // k                                   # (B, S*k)
    gathered = torch.gather(x, 1, src_tok[:, :, None].expand(B, S * k, d))
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[:, :, None].expand(B, S * k, d), gathered)
    ye = _expert_ffn_grouped(params, buf[:, :-1].reshape(B, E, C, d), cfg.mlp)
    out = torch.cat([ye.reshape(B, E * C, d),
                     torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)], dim=1)
    contrib = torch.gather(out, 1, slot[:, :, None].expand(B, S * k, d))
    sorted_g = torch.gather(gates.reshape(B, S * k).to(x.dtype), 1, order)
    contrib = contrib * sorted_g[:, :, None]
    inv = _inverse(order)
    y = torch.gather(contrib, 1, inv[:, :, None].expand(B, S * k, d))
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()
    return (y.reshape(B, S, k, d).sum(dim=2),
            _aux_loss(probs, experts.reshape(B * S, k), E))


def _expert_ffn_grouped(params, gecd, kind):
    """gecd: (G, E, C, d) -> (G, E, C, d)."""
    h = torch.einsum("gecd,edf->gecf", gecd, params["w1"])
    if kind == "swiglu":
        h = F.silu(h) * torch.einsum("gecd,edf->gecf", gecd, params["w3"])
    else:
        h = _act(h, kind)
    return torch.einsum("gecf,efd->gecd", h, params["w2"])


def moe_apply(params, x, cfg: ModelConfig, ac=None):
    """``(y, aux_loss)`` of ``cfg.moe.impl``'s path; under ``ac`` the layer
    is a region (``ParallelContext.enter`` / ``exit``) and the router runs
    as ``_route`` says."""
    if cfg.moe.impl not in IMPLS:
        raise ValueError(f"unknown moe impl {cfg.moe.impl!r}; expected one of {IMPLS}")
    kw = {}
    if ac is not None:
        kw["routed"], x = _route(params, x, cfg, ac)
    if cfg.moe.impl == "ragged":
        y, aux = moe_ragged(params, x, cfg, **kw)
    elif cfg.moe.impl == "gather":
        y, aux = moe_gather(params, x, cfg, **kw)
    else:
        y, aux = moe_dense(params, x, cfg, **kw)
    return (y if ac is None else ac.exit(y, _tp(ac))), aux
