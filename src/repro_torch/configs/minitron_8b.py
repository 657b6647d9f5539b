"""minitron-8b — dense 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned nemotron. [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    mlp_style="mlp2",  # nemotron-style 2-proj MLP (matches the published 8B size)
    vocab_size=256000,
    head_dim=128,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="minitron-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    mlp_style="mlp2",
    vocab_size=256,
    head_dim=16,
    param_dtype="float32",
    compute_dtype="float32",
)
