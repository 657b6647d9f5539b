"""qwen2-vl-7b — VLM backbone 28L d_model=3584 28H (GQA kv=4) d_ff=18944.

M-RoPE (3-section rotary over temporal/height/width), dynamic resolution.
Vision tower is a STUB: input_specs() provides precomputed patch embeddings
and 3-component M-RoPE position ids. 28 heads don't divide 16, so heads are
replicated and d_ff/vocab carry the model axis. [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    num_patches=256,
    rope_theta=1e6,
    sharding_overrides={"heads": None, "kv_heads": None, "qkv": None},
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-7b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(2, 3, 3),  # sums to head_dim/2 = 8
    num_patches=16,
    param_dtype="float32",
    compute_dtype="float32",
    sharding_overrides={"heads": None, "kv_heads": None, "qkv": None},
)
