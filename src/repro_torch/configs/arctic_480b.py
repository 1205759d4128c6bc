"""Snowflake Arctic 480B: dense-MoE hybrid, 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic_480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32_000,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True, expert_sharding="ep"),
    param_dtype="bfloat16",     # 480B: bf16 storage is required to fit a single pod
    remat="full",
)

SMOKE = ModelConfig(
    name="arctic_480b_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, dense_residual=True, expert_sharding="ep"),
    scan_layers=True,
)
