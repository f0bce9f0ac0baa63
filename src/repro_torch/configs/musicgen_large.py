"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, MHA) d_ff=8192,
decoder-only over EnCodec tokens: 4 codebooks (delay pattern applied in the
data layer), vocab 2048 per codebook; EnCodec frontend is a stub.
[arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=4,
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=2048, mlp="gelu", rope="standard",
        n_codebooks=4,
    )
