"""moonshot-v1-16b-a3b — MoE 48L d_model=2048 16H (kv=16) d_ff=1408 64e top-6.

Kimi/Moonlight family. vocab=163840. [hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    rope_theta=5e4,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    param_dtype="float32",
    compute_dtype="float32",
)
