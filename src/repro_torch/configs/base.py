"""Config dataclasses for architectures, input shapes, and sharding rules.

A copy of the reference's ``repro.configs.base`` (pure dataclasses), so that
the port imports nothing of ``repro``. Every architecture has a module
``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (full published size)
and ``SMOKE_CONFIG`` (reduced same-family config for CPU tests);
``get_config`` resolves either. The sharding rule table and the perf knobs
are carried over unchanged; the port's single-card serving path reads
neither the rules nor ``remat_policy``/``scan_layers``/``grad_accum``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

# Logical activation/parameter axis names used throughout the model zoo.
# Sharding rules map these to mesh axes (or None = replicated).
LOGICAL_AXES = (
    "batch",      # global batch
    "seq",        # sequence (sequence parallelism between blocks)
    "embed",      # d_model / residual stream
    "heads",      # query heads
    "kv_heads",   # key/value heads
    "qkv",        # fused head*head_dim projection output
    "mlp",        # d_ff
    "vocab",      # vocabulary
    "expert",     # MoE experts
    "state",      # SSM state dim
    "layers",     # stacked-scan leading axis (never sharded)
    "cache_seq",  # KV cache sequence axis
)

# Default sharding rule table: logical axis -> mesh axis (or tuple / None).
# "fsdp_axes" lists mesh axes that shard the *parameter* embed dim (FSDP).
DEFAULT_RULES: Mapping[str, Any] = {
    "batch": ("pod", "data"),   # pod axis silently dropped on single-pod meshes
    "seq": None,
    "embed": None,
    "embed_param": "data",      # FSDP: parameter d_model dim sharded on data
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "state": None,
    "layers": None,
    "cache_seq": None,
    "seq_sp": "model",          # sequence-parallel residual stream between blocks
}


# ModelConfig's fields that the reference's lacks (the hybrid_moe family's)
PORT_ONLY_FIELDS = ("shared_expert_ff", "ssm_conv", "layer_types",
                    "attention_scale", "embedding_multiplier",
                    "residual_multiplier", "logits_scaling", "mask_padding")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    # dense | moe | ssm | hybrid | hybrid_moe | encdec | vlm
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    mlp_style: str = "swiglu"   # swiglu (gate/up/down) | mlp2 (up/down, gelu)
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0       # width of an always-on SwiGLU expert
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 0           # causal depthwise conv width over (x, B, C)
    # --- hybrid (zamba2-style shared attention) ---
    attn_period: int = 0        # apply shared attn block every N ssm layers
    # --- hybrid_moe (granite-4.0-h): a mixer per layer, then an MoE FFN;
    # the family attends without position embeddings (NoPE) and routes
    # dropless (capacity_factor unread) ---
    layer_types: Tuple[str, ...] = ()   # "mamba" | "attention", per layer
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    # --- VLM ---
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    num_patches: int = 0        # patch embeddings supplied by the stub frontend
    # --- positional / numerics ---
    rope_theta: float = 1e6
    attention_scale: float = 0.0        # 0 -> 1 / sqrt(head_dim)
    embedding_multiplier: float = 1.0   # token embeddings scaled on the way in
    residual_multiplier: float = 1.0    # every mixer and FFN output scaled
    logits_scaling: float = 1.0         # logits divided on the way out
    mask_padding: bool = False          # serving masks left-padding
                                        # (the hybrid_moe family only)
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- perf knobs ---
    remat_policy: str = "full"      # full | dots | none
    attention_impl: str = "xla"     # xla | tri | pallas (pallas = kernel K4)
    ssd_impl: str = "xla"           # xla | pallas
    kv_head_replication: int = 1    # duplicate kv heads r# for cache sharding
    scan_layers: bool = True
    grad_accum: int = 1             # microbatch steps per train step
    sharding_overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def effective_kv_heads(self) -> int:
        """KV heads as stored in the decode cache (after replication).

        kv_head_replication r > 1 duplicates each kv head r times —
        mathematically identical attention (GQA group shrinks r#) — so a
        kv-head count that doesn't divide the model axis can still shard
        the cache across it, at r times the cache's memory."""
        return self.num_kv_heads * self.kv_head_replication

    @property
    def resolved_attention_scale(self) -> float:
        return self.attention_scale or 1.0 / self.resolved_head_dim ** 0.5

    @property
    def ssm_heads(self) -> int:
        return self.ssm_expand * self.d_model // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: O(1)-state decode at 500k."""
        return self.family in ("ssm", "hybrid", "hybrid_moe")

    def reference_dict(self) -> dict:
        """``dataclasses.asdict`` without the fields only the port has
        (``PORT_ONLY_FIELDS``) where they keep their defaults: the
        reference's own dict of every config both packages have, so a
        checkpoint's config hash is the same in both."""
        out = dataclasses.asdict(self)
        for f in dataclasses.fields(self):
            if f.name in PORT_ONLY_FIELDS and out[f.name] == f.default:
                del out[f.name]
        return out

    def rules(self) -> dict:
        r = dict(DEFAULT_RULES)
        r.update(self.sharding_overrides)
        return r

    def param_count(self) -> int:
        """Analytic parameter count (matches init; used for 6·N·D roofline)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        plain_ffn = 2 * d * self.d_ff          # up, down (GELU; whisper/mlp2)
        gated_ffn = (3 * d * self.d_ff if self.mlp_style == "swiglu"
                     else plain_ffn)           # gate, up, down (SwiGLU)
        embeds = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            ffn = self.num_experts * gated_ffn + d * self.num_experts  # + router
            per_layer = attn + ffn + 2 * d
            total = self.num_layers * per_layer
        elif self.family == "ssm":
            total = self.num_layers * (_ssd_layer_params(self) + d)
        elif self.family == "hybrid":
            total = self.num_layers * (_ssd_layer_params(self) + d)
            total += attn + gated_ffn + 2 * d   # one shared attention block
        elif self.family == "hybrid_moe":
            n_attn = sum(t == "attention" for t in self.layer_types)
            total = (n_attn * attn
                     + (self.num_layers - n_attn) * _mamba_mixer_params(self)
                     + self.num_layers * (_moe_ffn_params(self) + 2 * d))
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn + plain_ffn + 2 * d)
            dec = self.num_layers * (2 * attn + plain_ffn + 3 * d)
            total = enc + dec + d               # + final encoder norm
        else:  # dense | vlm
            total = self.num_layers * (attn + gated_ffn + 2 * d)
        return total + embeds + d               # + final norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family == "hybrid_moe":
            idle = self.num_experts - self.experts_per_token
            return self.param_count() - self.num_layers * idle * 3 * \
                self.d_model * self.d_ff
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * self.num_experts * 3 * d * self.d_ff
        active_ffn = self.num_layers * self.experts_per_token * 3 * d * self.d_ff
        return dense + active_ffn


def _ssd_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nheads = d_inner // cfg.ssm_head_dim
    # in_proj: z, x, B, C, dt
    in_proj = d * (2 * d_inner + 2 * cfg.ssm_state + nheads)
    out_proj = d_inner * d
    extra = 3 * nheads + d_inner  # A_log, dt_bias, D_skip, norm weight (d_inner)
    return in_proj + out_proj + extra


def _mamba_mixer_params(cfg: ModelConfig) -> int:
    """The hybrid_moe family's Mamba-2 mixer: one in_proj to (z, xBC, dt),
    the depthwise conv over xBC with its bias, A_log, dt_bias, D, the gated
    norm's weight and out_proj."""
    d, di, n, h = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state, \
        cfg.ssm_heads
    conv_dim = di + 2 * n
    return (d * (di + conv_dim + h) + (cfg.ssm_conv + 1) * conv_dim + 3 * h
            + di + di * d)


def _moe_ffn_params(cfg: ModelConfig) -> int:
    """Router, the routed SwiGLU experts and the shared SwiGLU expert."""
    d = cfg.d_model
    return (d * cfg.num_experts + cfg.num_experts * 3 * d * cfg.d_ff
            + 3 * d * cfg.shared_expert_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell (see DESIGN.md S4)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
