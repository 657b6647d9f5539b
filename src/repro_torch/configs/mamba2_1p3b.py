"""mamba2-1.3b — attention-free SSM 48L d_model=2048 ssm_state=128 vocab=50280.

SSD (state-space duality) blocks throughout; no attention, no FFN (d_ff=0).
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
