"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=8, seq_shard=True,
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
        vocab_size=131072, mlp="gelu", rope="standard",
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=32768),
    )
