"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — squared-ReLU MLP.  [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        grad_accum=8, seq_shard=True,
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
        vocab_size=256000, mlp="sq_relu", rope="standard",
    )
