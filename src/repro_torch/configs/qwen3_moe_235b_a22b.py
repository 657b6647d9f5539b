"""qwen3-moe-235b-a22b — MoE 94L d_model=4096 64H (GQA kv=4) d_ff=1536 128e top-8.

[hf:Qwen/Qwen3-30B-A3B scaled family; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
    sharding_overrides={"kv_heads": None},  # 4 kv heads < 16-way model axis
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    head_dim=16,
    num_experts=8,
    experts_per_token=2,
    param_dtype="float32",
    compute_dtype="float32",
    sharding_overrides={"kv_heads": None},
)
