"""Analytic per-cell FLOP / HBM-byte / collective-byte model, a copy of
the reference package's ``launch/analysis.py`` (pure Python; the tests
hold it to the reference's numbers bit for bit), cross-validated against
the dry run (``launch/dryrun.py``: FLOPs counted by
``torch.utils.flop_counter.FlopCounterMode`` over every iteration, and the
collectives the step ran).  The reference's text follows; its
``cost_analysis`` is XLA's.

Why analytic + HLO instead of HLO alone: ``compiled.cost_analysis()`` counts
each while-loop body ONCE (verified empirically: a 28-layer scanned model
reports ~= embed/head + one layer of flops).  Our programs are built from
loops with *known* trip counts (layer scan = n_layers, flash q/kv chunk loops
= S/chunk, SSM chunk scan = S/chunk), so we (a) compute the full-step numbers
analytically from the architecture and (b) validate the model by
reconstructing what cost_analysis *should* report with every loop counted
once and comparing.  EXPERIMENTS.md reports both and the validation residual.

All numbers are global (whole step, all chips); divide by chips for
per-device.  dtypes: compute bf16(2B), params/optimizer fp32(4B).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig

BF16 = 2
F32 = 4


# --------------------------------------------------------------------------- #
# FLOPs
# --------------------------------------------------------------------------- #
def _attn_flops_per_layer(cfg: ModelConfig, B: int, S: int, causal_waste: bool):
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    proj = 2 * B * S * d * (H * hd + 2 * KV * hd) + 2 * B * S * H * hd * d
    # scores+pv: full S^2 when the chunked path computes masked blocks too
    pairs = S * S if causal_waste else S * (S + 1) // 2
    sdpa = 2 * 2 * B * H * hd * pairs
    return proj + sdpa


def _mlp_flops_per_layer(cfg: ModelConfig, B: int, S: int):
    if cfg.family == "moe":
        m = cfg.moe
        mult = 3 if cfg.mlp == "swiglu" else 2
        router = 2 * B * S * cfg.d_model * m.n_experts
        eff_experts = {"dense": m.n_experts,
                       "ragged": m.top_k,
                       "gather": m.top_k * 1.25}[m.impl]  # capacity factor
        return router + mult * 2 * B * S * cfg.d_model * m.expert_d_ff * eff_experts
    if cfg.mlp == "none" or cfg.d_ff == 0:
        return 0
    mult = 3 if cfg.mlp == "swiglu" else 2
    return mult * 2 * B * S * cfg.d_model * cfg.d_ff


def _ssm_flops_per_layer(cfg: ModelConfig, B: int, S: int):
    d, di = cfg.d_model, cfg.d_inner
    N = cfg.ssm.d_state
    R = cfg.ssm.resolved_dt_rank(d)
    proj = 2 * B * S * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
    conv = 2 * B * S * di * cfg.ssm.d_conv
    # associative scan: ~2 passes of the combine over (di*N) per token,
    # each combine = 3 mul/add on (a,b) pairs
    scan = 2 * 3 * 2 * B * S * di * N
    gate = 4 * B * S * di
    return proj + conv + scan + gate


def flops_per_layer_fwd(cfg: ModelConfig, B: int, S: int,
                        causal_waste: bool = True) -> float:
    f = 0.0
    if cfg.uses_attention and cfg.family != "ssm":
        # sliding-window layers still compute full blocks in the jnp path
        f += _attn_flops_per_layer(cfg, B, S, causal_waste)
    if cfg.uses_ssm:
        f += _ssm_flops_per_layer(cfg, B, S)
    f += _mlp_flops_per_layer(cfg, B, S)
    return f


def embed_head_flops(cfg: ModelConfig, B: int, S: int, train: bool) -> float:
    # embedding lookup ~ free; logits matmul dominates
    lg = 2 * B * S * cfg.d_model * cfg.vocab_size * cfg.n_codebooks
    return lg


def train_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    fwd = cfg.n_layers * flops_per_layer_fwd(cfg, B, S)
    # backward = 2x fwd; full remat recomputes fwd once more
    remat = {"none": 0.0, "dots": 0.5, "full": 1.0}[cfg.remat_policy]
    body = fwd * (3.0 + remat)
    head = embed_head_flops(cfg, B, S, True) * 3.0
    return body + head


def prefill_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    return (cfg.n_layers * flops_per_layer_fwd(cfg, B, S)
            + 2 * B * cfg.d_model * cfg.vocab_size * cfg.n_codebooks)


def decode_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    f = 0.0
    hd = cfg.resolved_head_dim
    for _ in range(1):
        if cfg.uses_attention and cfg.family != "ssm":
            d = cfg.d_model
            H, KV = cfg.n_heads, cfg.n_kv_heads
            proj = 2 * B * d * (H * hd + 2 * KV * hd) + 2 * B * H * hd * d
            ctx = S if cfg.sliding_window is None else (
                S if cfg.global_attn_every > 0 else min(S, cfg.sliding_window))
            sdpa = 2 * 2 * B * H * hd * ctx
            f += proj + sdpa
        if cfg.uses_ssm:
            d, di = cfg.d_model, cfg.d_inner
            N = cfg.ssm.d_state
            R = cfg.ssm.resolved_dt_rank(d)
            f += 2 * B * (d * 2 * di + di * (R + 2 * N) + R * di + di * d) \
                + 2 * B * di * cfg.ssm.d_conv + 6 * B * di * N
        f += _mlp_flops_per_layer(cfg, B, 1)
    f *= cfg.n_layers
    f += 2 * B * cfg.d_model * cfg.vocab_size * cfg.n_codebooks
    return f


# --------------------------------------------------------------------------- #
# HBM bytes (global)
# --------------------------------------------------------------------------- #
def train_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    P = cfg.n_params()
    d = cfg.d_model
    # params fp32: read fwd + read bwd + read remat; grads write+read;
    # adam mu/nu read+write; param write
    param_traffic = P * F32 * (3 + 2 + 4 + 1)
    # residual stream: with full remat only layer inputs are saved:
    # write fwd + read bwd per layer, bf16
    act_traffic = cfg.n_layers * T * d * BF16 * 2
    # per-layer working set (inputs/outputs of the big matmuls), fused
    # conservatively as 4 x residual reads/writes fwd + 8 x bwd(+remat)
    act_traffic += cfg.n_layers * T * d * BF16 * 12
    # logits fp32 write+read
    logits = 2 * T * cfg.vocab_size * cfg.n_codebooks * F32 / max(
        1, 1)  # sharded over model axis but global bytes unchanged
    return param_traffic + act_traffic + logits


def prefill_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    P = cfg.n_params()
    return P * F32 + cfg.n_layers * T * cfg.d_model * BF16 * 8 \
        + 2 * B * cfg.vocab_size * cfg.n_codebooks * F32


def decode_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, S = shape.global_batch, shape.seq_len
    P_active = cfg.n_params(active_only=True)   # MoE ragged reads top-k experts
    if cfg.moe and cfg.moe.impl == "dense":
        P_active = cfg.n_params()
    bts = P_active * F32                        # every weight read per token
    hd = cfg.resolved_head_dim
    if cfg.uses_attention and cfg.family != "ssm":
        ctx = S if (cfg.sliding_window is None or cfg.global_attn_every > 0) \
            else min(S, cfg.sliding_window)
        bts += cfg.n_layers * B * ctx * cfg.n_kv_heads * hd * 2 * BF16  # read K,V
    if cfg.uses_ssm:
        bts += cfg.n_layers * B * cfg.d_inner * cfg.ssm.d_state * F32 * 2
    return bts


# --------------------------------------------------------------------------- #
# Collective bytes (global, analytic; cross-checked vs HLO parse)
# --------------------------------------------------------------------------- #
def train_collective_bytes(cfg: ModelConfig, shape: ShapeSpec,
                           tp: int, dp: int, fsdp: bool) -> float:
    """SUM over devices of bytes crossing each device's links (so that
    dividing by n_chips in roofline.terms gives per-device link time —
    collectives do NOT parallelize across chips the way flops do).

    Per TP activation all-reduce: each of the dp TP-groups all-reduces its
    (T/dp, d) activation; per-device bytes = (T/dp)*d*B*2(tp-1)/tp, and the
    sum over all tp*dp devices is  tp * T * d * B * 2(tp-1)/tp."""
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    d = cfg.d_model
    P = cfg.n_params()
    coll = 0.0
    if tp > 1 and cfg.grad_accum >= 0:
        ar = 2.0 * (tp - 1) / tp
        n_ar = 4 if (cfg.uses_attention and cfg.mlp != "none") else 2
        coll += cfg.n_layers * n_ar * tp * T * d * BF16 * ar
    if dp > 1:
        pbytes = P * (F32 if cfg.param_dtype == "float32" else BF16)
        if fsdp:
            # fwd param all-gather + bwd all-gather + grad reduce-scatter:
            # per-device 3*(P/tp)*(dp-1)/dp; summed over tp*dp devices:
            coll += 3.0 * pbytes * (dp - 1)
        else:
            # gradient all-reduce: per-device (P/tp)*2(dp-1)/dp; summed:
            coll += 2.0 * pbytes * (dp - 1)
    return coll


def decode_collective_bytes(cfg: ModelConfig, shape: ShapeSpec,
                            tp: int, dp: int) -> float:
    B = shape.global_batch
    d = cfg.d_model
    coll = 0.0
    if tp > 1:
        ar = 2.0 * (tp - 1) / tp
        n_ar = 2 if (cfg.uses_attention and cfg.mlp != "none") else 1
        # activations replicated/batch-sharded over dp; per TP-group tensor
        # is (B/dp, d): sum over devices = tp * B * d * ...
        coll += cfg.n_layers * n_ar * tp * B * d * BF16 * ar
        coll += tp * B * cfg.vocab_size * cfg.n_codebooks * BF16 * ar
    return coll


# --------------------------------------------------------------------------- #
def analytic_cell(cfg: ModelConfig, shape: ShapeSpec, tp: int, dp: int,
                  fsdp: bool = None) -> Dict:
    if fsdp is None:
        fsdp = cfg.n_params() > 3e9
    kind = {"train_4k": "train", "prefill_32k": "prefill"}.get(
        shape.name, "decode")
    if kind == "train":
        fl, bts = train_flops(cfg, shape), train_bytes(cfg, shape)
        coll = train_collective_bytes(cfg, shape, tp, dp, fsdp)
    elif kind == "prefill":
        fl, bts = prefill_flops(cfg, shape), prefill_bytes(cfg, shape)
        coll = train_collective_bytes(cfg, shape, tp, dp, False) / 3.0
    else:
        fl, bts = decode_flops(cfg, shape), decode_bytes(cfg, shape)
        coll = decode_collective_bytes(cfg, shape, tp, dp)
    return {"flops": fl, "hbm_bytes": bts, "collective_bytes": coll,
            "kind": kind}


def hlo_counted_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """What cost_analysis is expected to report (every while-loop body
    counted ONCE) — used to validate the analytic model against the
    artifact.  Loops in our programs: grad-accum microbatch scan, layer
    scan, flash q/kv chunk loops, SSM chunk scan (the associative scan
    *within* a chunk is unrolled log-depth ops and is fully counted).

    Validation is meaningful for train/prefill (matmul-dominated); decode
    programs are sub-millisecond and dominated by non-matmul ops that the
    analytic model ignores, so decode ratios >1 are expected."""
    kind = {"train_4k": "train", "prefill_32k": "prefill"}.get(
        shape.name, "decode")
    B, S = shape.global_batch, shape.seq_len
    if kind == "train":
        B = B // max(cfg.grad_accum, 1)   # microbatch loop counted once
    if kind == "decode":
        return decode_flops(cfg, shape) / cfg.n_layers \
            + 2 * B * cfg.d_model * cfg.vocab_size * cfg.n_codebooks
    # one layer, with inner seq chunk loops also counted once
    one_layer = flops_per_layer_fwd(cfg, B, S)
    if cfg.uses_attention and S > 2048 and cfg.family != "ssm":
        # flash: lax.map over q-chunks counted once, inner kv scan once
        hd = cfg.resolved_head_dim
        full_sdpa = 2 * 2 * B * cfg.n_heads * hd * S * S
        cq = min(1024, S)
        ck = min(1024, S)
        one_layer -= full_sdpa * (1.0 - (cq * ck) / (S * S))
    if cfg.uses_ssm:
        # only the chunked scan body is inside a while loop; the projections
        # and conv are full-sequence ops outside it
        chunk = min(512, S)
        scan_part = 2 * 3 * 2 * B * S * cfg.d_inner * cfg.ssm.d_state
        one_layer -= scan_part * (1.0 - chunk / S)
    mult = {"train": 3.0 + {"none": 0, "dots": 0.5, "full": 1.0}[
        cfg.remat_policy], "prefill": 1.0}[kind]
    return one_layer * mult + embed_head_flops(cfg, B, S, kind == "train") \
        * (3.0 if kind == "train" else 1.0 / S)
