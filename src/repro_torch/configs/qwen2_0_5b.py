"""Qwen2 0.5B: dense GQA with QKV bias, huge vocab. [arXiv:2407.10671; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_0_5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151_936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2_0_5b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    tie_embeddings=True,
)
