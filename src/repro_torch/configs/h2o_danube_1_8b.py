"""H2O Danube 1.8B: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube_1_8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32_000,
    rope_theta=10_000.0,
    sliding_window=4096,     # mistral-style SWA: ring KV cache of window size
)

SMOKE = ModelConfig(
    name="h2o_danube_1_8b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    sliding_window=16,
)
