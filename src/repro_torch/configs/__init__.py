"""Architecture registry: one module per assigned architecture (data copies
of the reference package's ``configs/``).

``get(name)``     -> full-scale ModelConfig (the published widths)
``get_smoke(name)`` -> reduced same-family config (CPU smoke tests)
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

# Re-exported alongside the registry so callers can type against the config
# dataclasses without reaching into repro_torch.models.config.
__all__ = ["ARCHS", "ModelConfig", "MoEConfig", "SSMConfig", "get",
           "get_smoke"]

ARCHS = [
    "falcon_mamba_7b", "tinyllama_1_1b", "qwen3_0_6b", "nemotron_4_340b",
    "starcoder2_3b", "grok_1_314b", "olmoe_1b_7b", "hymba_1_5b",
    "qwen2_vl_72b", "musicgen_large",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    n = name.replace("-", "_").replace(".", "_")
    if n not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return n


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.config()


def get_smoke(name: str) -> ModelConfig:
    """Reduced config of the same family: tiny dims, same structural features
    (GQA ratio, qk-norm, MoE top-k, SSM, M-RoPE, codebooks...)."""
    cfg = get(name)
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = kv * max(1, min(cfg.n_heads // max(cfg.n_kv_heads, 1), 4))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4,
                                  top_k=min(cfg.moe.top_k, 2),
                                  expert_d_ff=64)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=8, dt_rank=8)
    return dataclasses.replace(
        cfg,
        n_layers=2, d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=512,
        moe=moe, ssm=ssm,
        sliding_window=(32 if cfg.sliding_window else None),
        global_attn_every=(2 if cfg.global_attn_every else 0),
        vision_tokens=(8 if cfg.vision_tokens else 0),
        mrope_sections=(2, 3, 3) if cfg.rope == "mrope" else cfg.mrope_sections,
        remat_policy="none",
    )
