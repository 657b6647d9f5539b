"""granite-34b — dense 88L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576 vocab=49152.

Llama-style arch, code model. kv=1 cannot shard on the 16-way model axis, so
kv_heads are replicated (see sharding_overrides). [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    mlp_style="mlp2",  # gpt-bigcode-style 2-proj MLP (matches the published 34B size)
    vocab_size=49152,
    rope_theta=1e4,
    sharding_overrides={"kv_heads": None},
)

SMOKE_CONFIG = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    mlp_style="mlp2",
    vocab_size=256,
    param_dtype="float32",
    compute_dtype="float32",
    sharding_overrides={"kv_heads": None},
)
