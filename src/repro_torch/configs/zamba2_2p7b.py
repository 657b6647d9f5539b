"""zamba2-2.7b — hybrid 54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64.

Mamba-2 backbone with a shared full-attention block applied periodically
(every 6 SSD layers -> 9 applications over 54 layers). [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_period=6,
    tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    attn_period=2,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
