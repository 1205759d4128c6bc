"""Mamba2 780M: attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]

48L d_model=1536, ssm_state=128, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2_780m_smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    tie_embeddings=True,
)
