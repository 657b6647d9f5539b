"""whisper-small — enc-dec 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.

Conv audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (seq, d_model). 12 heads don't divide the 16-way model axis, so
attention heads are replicated and the model axis shards d_ff / vocab only
(avoids GSPMD padding 12->16). [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,           # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    tie_embeddings=True,
    norm_eps=1e-5,
    sharding_overrides={"heads": None, "kv_heads": None, "qkv": None},
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-small-smoke",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    sharding_overrides={"heads": None, "kv_heads": None, "qkv": None},
)
