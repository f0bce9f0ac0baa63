"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba-1, vocab 65024,
ssm_state=16.  [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=8,
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=65024, mlp="none", rope="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    )
