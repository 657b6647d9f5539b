"""command-r-35b — dense 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

GQA, no bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    qkv_bias=False,
    tie_embeddings=True,  # command-r ties input/output embeddings
    rope_theta=8e6,
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-35b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
