"""xAI Grok-1 314B: MoE, 8 experts top-2. [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok_1_314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    rope_theta=10_000.0,
    # 8 experts < 16-way model axis: shard d_ff inside each expert instead (TP-in-expert)
    moe=MoEConfig(num_experts=8, top_k=2, dense_residual=False, expert_sharding="tp"),
    param_dtype="bfloat16",
    remat="full",
)

SMOKE = ModelConfig(
    name="grok_1_314b_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2, dense_residual=False, expert_sharding="tp"),
)
