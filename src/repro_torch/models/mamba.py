"""Mamba-1 selective-state-space block (Falcon-Mamba / Hymba SSM heads),
the counterpart of the reference package's ``models/mamba.py``.

Training and prefill: a chunked selective scan.  Within a chunk the
recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ,   y_t = C_t . h_t + D x_t

is a log-depth inclusive scan (Hillis-Steele: ``log2(chunk)`` rounds, each
combining every position with the one ``2^r`` before it under
``(a1, b1) o (a2, b2) = (a2 a1, b2 + a2 b1)``), in plain PyTorch; chunks are
threaded in order, so the state tensor is (B, chunk, d_inner, N) and not
(B, S, d_inner, N).  The reference runs no Pallas kernel here, and neither
does the port.

Decode: O(1) per token, on a ``conv`` state (the last ``d_conv - 1``
inputs) and an f32 ``ssm`` state.

Under tensor parallelism (``ac``, a rank's ``launch/sharding.
ParallelContext``, whose ``in_proj`` splits) the rank holds its channels
of ``d_inner``: ``in_proj`` column-parallel (its slices of ``x`` and
``z``), the conv, ``dt_bias``, ``A_log`` and ``D`` by channel, ``x_proj``
row-parallel with one reduce before ``dt``, ``B`` and ``C`` (whose
gradient is reduced in turn), ``dt_proj`` column-parallel, the scan on the
rank's channels, ``out_proj`` row-parallel and one reduce; the decode
states hold the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

CHUNK = 512


def ssm_param_shapes(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm.d_state
    R = cfg.ssm.resolved_dt_rank(d)
    K = cfg.ssm.d_conv
    return {"in_proj": (d, 2 * di), "conv_w": (K, di), "conv_b": (di,),
            "x_proj": (di, R + 2 * N), "dt_proj": (R, di), "dt_bias": (di,),
            "A_log": (di, N), "D": (di,), "out_proj": (di, d)}


def _scan(a, b):
    """Inclusive scan along axis 1 of the affine maps ``h -> a h + b``."""
    n, off = a.shape[1], 1
    while off < n:
        a, b = (torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1),
                torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]], dim=1))
        off *= 2
    return a, b


def _ssm_core(params, xc, dt, Bs, Cs, h0, cfg: ModelConfig):
    """One chunk of the selective scan.
    xc (B,C,di), dt (B,C,di), Bs/Cs (B,C,N), h0 (B,di,N); f32."""
    A = -torch.exp(params["A_log"].float())                 # (di, N)
    Abar = torch.exp(dt[..., None] * A)                      # (B,C,di,N)
    Bx = (dt * xc)[..., None] * Bs[:, :, None, :]            # (B,C,di,N)
    Acum, Hcum = _scan(Abar, Bx)
    h = Hcum + Acum * h0[:, None]                            # (B,C,di,N)
    y = torch.einsum("bcdn,bcn->bcd", h, Cs)
    y = y + params["D"].float() * xc
    return y, h[:, -1]


def _tp(ac) -> bool:
    return ac is not None and ac.split["ssm"]


def _dt_B_C(params, x, cfg: ModelConfig, ac=None):
    """x: (B,*,di) -> dt (B,*,di) f32, Bs/Cs (B,*,N) f32."""
    N = cfg.ssm.d_state
    R = cfg.ssm.resolved_dt_rank(cfg.d_model)
    proj = x @ params["x_proj"]                              # (B,*,R+2N)
    if _tp(ac):
        # partial sums over the rank's channels; every rank then uses the
        # whole of dt_r, B and C on its own channels
        proj = ac.copy(ac.reduce(proj))
    dt_r, Bs, Cs = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"] + params["dt_bias"]).float()
    return dt, Bs.float(), Cs.float()


def mamba_train(params, x, cfg: ModelConfig, chunk: int = CHUNK, ac=None):
    """x: (B, S, d) -> (B, S, d)."""
    if ac is not None:
        x = ac.enter(x, _tp(ac))
    B, S, d = x.shape
    K = cfg.ssm.d_conv
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)          # (B,S,di) each
    di = xs.shape[-1]
    # causal depthwise conv along S: the sum of K shifted products, in order
    xpad = F.pad(xs, (0, 0, K - 1, 0))
    xc = sum(xpad[:, i:i + S] * params["conv_w"][i] for i in range(K))
    xc = F.silu(xc + params["conv_b"])
    dt, Bs, Cs = _dt_B_C(params, xc, cfg, ac)
    xcf = xc.float()

    C = min(chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not divisible by the ssm "
                         f"chunk size {C}; pad the sequence or pass a chunk "
                         f"that divides it")
    h = torch.zeros((B, di, cfg.ssm.d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, C):
        part = slice(c0, c0 + C)
        y, h = _ssm_core(params, xcf[:, part], dt[:, part], Bs[:, part],
                         Cs[:, part], h, cfg)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype) * F.silu(z)
    y = y @ params["out_proj"]
    return y if ac is None else ac.exit(y, _tp(ac))


def mamba_decode(params, x, cfg: ModelConfig, conv_state, ssm_state, ac=None):
    """One-token decode.  x: (B, 1, d); conv_state (B, K-1, di);
    ssm_state (B, di, N) f32.  Returns (y (B,1,d), conv_state, ssm_state),
    new tensors."""
    if ac is not None:
        x = ac.enter(x, _tp(ac))
    xs, z = (x @ params["in_proj"]).chunk(2, dim=-1)          # (B,1,di)
    hist = torch.cat([conv_state, xs], dim=1)                 # (B,K,di)
    xc = torch.einsum("bkd,kd->bd", hist, params["conv_w"])[:, None]
    xc = F.silu(xc + params["conv_b"])                        # (B,1,di)
    dt, Bs, Cs = _dt_B_C(params, xc, cfg, ac)
    A = -torch.exp(params["A_log"].float())
    Abar = torch.exp(dt[..., None] * A)[:, 0]                 # (B,di,N)
    Bx = ((dt * xc.float())[..., None] * Bs[:, :, None, :])[:, 0]
    ssm_state = Abar * ssm_state + Bx
    y = torch.einsum("bdn,bn->bd", ssm_state, Cs[:, 0])
    y = y + params["D"].float() * xc[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    y = y @ params["out_proj"]
    return (y if ac is None else ac.exit(y, _tp(ac))), hist[:, 1:], ssm_state
