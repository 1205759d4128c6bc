"""Zamba2 1.2B: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; hf]

38L d_model=2048 32H (MHA kv=32) d_ff=8192, ssm_state=64.
Realized as 38 Mamba2 layers with a single *shared* attention+MLP block applied
after every 6th mamba layer (see DESIGN.md §8 for the simplification note).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2_1_2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid_shared_every=6,
)

SMOKE = ModelConfig(
    name="zamba2_1_2b_smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    hybrid_shared_every=2,
)
