"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE; vision frontend is a stub (input_specs supplies
precomputed patch embeddings).  [arXiv:2409.12191]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=8, seq_shard=True,
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
        vocab_size=152064, mlp="swiglu", rope="mrope",
        mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
        vision_tokens=1024,
    )
