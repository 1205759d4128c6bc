"""AI2 OLMo 1B: dense, non-parametric LayerNorm. [arXiv:2402.00838; hf]

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50_304,
    rope_theta=10_000.0,
    norm="nonparam_ln",      # OLMo uses LayerNorm without learnable scale/bias
    act="swiglu",
    tie_embeddings=True,     # OLMo-1B ties input/output embeddings
)

SMOKE = ModelConfig(
    name="olmo_1b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    norm="nonparam_ln",
    tie_embeddings=True,
)
