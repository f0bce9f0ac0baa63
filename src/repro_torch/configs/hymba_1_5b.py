"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
parallel attention + Mamba heads, SWA with periodic global layers,
ssm_state=16.  [arXiv:2411.13676]"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=4,
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001, mlp="swiglu", rope="standard",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        sliding_window=2048, global_attn_every=16,
    )
