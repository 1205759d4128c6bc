"""Qwen2-VL 7B backbone: M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
The vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings merged into the token stream, plus 3D (t,h,w) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab=152_064,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),   # t/h/w sections of the 64-dim half-rotary space
    input_mode="embeds",
)

SMOKE = ModelConfig(
    name="qwen2_vl_7b_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    mrope_sections=(4, 2, 2),
    input_mode="embeds",
)
