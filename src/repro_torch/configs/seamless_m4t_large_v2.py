"""SeamlessM4T large v2: encoder-decoder multimodal backbone. [arXiv:2308.11596; hf]

24L (per stack) d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206.
The speech/text modality frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_large_v2",
    family="encdec",
    n_layers=24,            # decoder stack
    encoder_layers=24,      # encoder stack
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    norm="layernorm",
    act="gelu",
    input_mode="embeds",    # encoder consumes precomputed frame embeddings
)

SMOKE = ModelConfig(
    name="seamless_m4t_large_v2_smoke",
    family="encdec",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    norm="layernorm",
    act="gelu",
    input_mode="embeds",
)
