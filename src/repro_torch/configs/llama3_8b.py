"""Meta Llama 3 8B: dense GQA, 128k vocab. [arXiv:2407.21783; unverified]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3_8b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    rope_theta=500_000.0,
)
