"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=4,
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
        vocab_size=49152, mlp="gelu", rope="standard",
    )
