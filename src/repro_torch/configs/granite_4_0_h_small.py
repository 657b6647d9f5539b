"""granite-4.0-h-small — hybrid_moe 40L d_model=4096: Mamba-2 and NoPE GQA
attention (32 q / 8 kv heads of 128) mixers, a 72-expert top-10 MoE with
one shared expert after every mixer.

``layer_types`` puts attention at layers 5, 15, 25 and 35 and Mamba-2
(128 heads of 64, state 128, one group, conv 4, chunk 256) in the other
36. Each layer is h = x + m * mixer(rmsnorm(x)), then
h + m * (moe(rmsnorm(h)) + shared(rmsnorm(h))) with m = 0.22; embeddings
x 12, logits / 16, tied head; routing is dropless: top 10 of the float32
router logits, softmax over those 10.
[hf:ibm-granite/granite-4.0-h-small config.json, model_type
granitemoehybrid]
"""
from repro_torch.configs.base import ModelConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    tie_embeddings=True,
    num_experts=72,
    experts_per_token=10,
    shared_expert_ff=1536,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    layer_types=_PERIOD * 4,
    attention_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    mask_padding=True,
    norm_eps=1e-5,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-4.0-h-small-smoke",
    family="hybrid_moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    tie_embeddings=True,
    num_experts=8,
    experts_per_token=2,
    shared_expert_ff=48,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    ssm_conv=4,
    layer_types=("mamba", "attention", "mamba", "mamba"),
    attention_scale=0.0625,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    mask_padding=True,
    norm_eps=1e-5,
    param_dtype="float32",
    compute_dtype="float32",
)
