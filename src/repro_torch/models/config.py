"""Model configuration for the assigned architecture pool (a copy of the
reference package's ``models/config.py``: pure dataclasses).

One ``ModelConfig`` describes any member of the LM family zoo: dense GQA
transformers, MoE, Mamba-1 SSMs, hybrid (parallel attention+SSM) blocks,
VLM and audio backbones.  ``repro_torch/configs/<id>.py`` instantiates one
per assigned architecture.  The port's model runs every family; the
mesh and compiler knobs (``scan_layers``, ``seq_shard``, ``pure_dp``) are
kept so that a config reads the same in both packages, and the port's eager
model does not read them; it reads ``remat_policy`` (activation
checkpointing, ``models/model.py``) and ``grad_accum``
(``launch/steps.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None      # default: d_model // 16

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(d_model // 16, 1)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    impl: str = "dense"                # "dense" (all-experts) | "ragged" (sorted)
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // n_heads
    mlp: str = "swiglu"                # swiglu | sq_relu | gelu | none
    qk_norm: bool = False
    rope: str = "standard"             # standard | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: layers listed here use full attention; others sliding-window
    sliding_window: Optional[int] = None
    global_attn_every: int = 0         # 0 = all global; k = every k-th layer global
    n_codebooks: int = 1               # musicgen-style multi-codebook heads
    vision_tokens: int = 0             # vlm stub: leading precomputed embeddings
    # numerics / performance knobs (hillclimb levers)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "full"         # none | full | dots
    scan_layers: bool = True
    seq_shard: bool = False            # sequence/context parallelism on 'model'
    grad_accum: int = 1                # microbatches per step (training)
    pure_dp: bool = False              # small models: fold 'model' into DP
                                       # (TP all-reduces vanish; see §Perf)

    def __post_init__(self):
        families = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        if self.family not in families:
            raise ValueError(f"unknown model family {self.family!r}; "
                             f"expected one of {families}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("family='moe' needs a MoEConfig in the `moe` "
                             "field")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"family={self.family!r} needs an SSMConfig in "
                             f"the `ssm` field")
        if self.n_heads and self.n_kv_heads \
                and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} must be divisible by "
                f"n_kv_heads={self.n_kv_heads} (GQA groups query heads "
                f"evenly over kv heads)")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    # ---------------- parameter counting (for roofline MODEL_FLOPS) -------- #
    def param_counts(self) -> dict:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        H, KV = self.n_heads, self.n_kv_heads
        counts = {"embed": V * d * self.n_codebooks, "head": 0 if
                  self.tie_embeddings else V * d * self.n_codebooks,
                  "attn": 0, "mlp": 0, "moe": 0, "moe_active": 0, "ssm": 0}
        L = self.n_layers
        if self.uses_attention:
            counts["attn"] = L * (d * H * hd + 2 * d * KV * hd + H * hd * d)
        if self.mlp != "none" and self.d_ff > 0 and self.family != "moe":
            mult = 3 if self.mlp == "swiglu" else 2
            counts["mlp"] = L * mult * d * ff
        if self.moe:
            eff = self.moe.expert_d_ff
            mult = 3 if self.mlp == "swiglu" else 2
            counts["moe"] = L * self.moe.n_experts * mult * d * eff \
                + L * d * self.moe.n_experts
            counts["moe_active"] = L * self.moe.top_k * mult * d * eff \
                + L * d * self.moe.n_experts
        if self.uses_ssm:
            di = self.d_inner
            N = self.ssm.d_state
            R = self.ssm.resolved_dt_rank(d)
            counts["ssm"] = L * (d * 2 * di + di * self.ssm.d_conv
                                 + di * (R + 2 * N) + R * di + di * N
                                 + 2 * di + di * d)
        return counts

    def n_params(self, active_only: bool = False) -> int:
        c = self.param_counts()
        moe = c["moe_active"] if active_only else c["moe"]
        return c["embed"] + c["head"] + c["attn"] + c["mlp"] + moe + c["ssm"]
