"""Decoder-only LM: serving (prefill + decode) and training of the dense,
VLM, MoE, SSM and hybrid families, and serving of the hybrid_moe family.

The port of ``repro.models.lm``: the schema of every decoder-only family,
``prefill``/``decode_step`` and ``forward_train`` for ``"dense"``,
``"vlm"`` (the dense block with M-RoPE over (3, B, S) position ids, and
``patch_embeds`` written over the first rows of the token embedding),
``"moe"`` (the dense block with ``layers.moe_block`` as its FFN, whose
load-balance loss is summed over the layers), ``"ssm"`` (Mamba-2) and
``"hybrid"`` (Mamba-2 with a shared attention block every
``attn_period`` layers, zamba2). The reference's ``jax.lax.scan`` over
the leading "layers" axis becomes a Python loop over it, so
``scan_layers`` changes nothing. In training, each layer body runs under
``_remat``: ``remat_policy="full"`` recomputes it in backward (the
reference's ``nothing_saveable``), ``"dots"`` recomputes it but for its
weight products (``dots_with_no_batch_dims_saveable``), ``"none"`` runs
it plain.

``"hybrid_moe"`` (granite-4.0-h-small, which the reference lacks; serving
only) runs, per layer of ``cfg.layer_types``, a Mamba-2 mixer (in_proj to
z, xBC and dt; a causal depthwise conv over xBC, then SiLU; the SSD scan
plus D x; a gated RMSNorm; out_proj) or a NoPE GQA attention at
``attention_scale``, then a dropless MoE FFN with a shared expert
(``layers.moe_dropless``), each added to the residual times
``residual_multiplier``; embeddings times ``embedding_multiplier``, logits
over ``logits_scaling``. With ``mask_padding`` a batch's ``start`` (B,)
(its left-padding) is masked: dt and the conv inputs are 0 at pads, and
attention keys before the start are masked, so a padded request's logits
are those of the request alone (no other family masks: ``mask_padding``
is refused there). The family attends without position embeddings and
routes dropless, whatever ``capacity_factor`` says. Its prefill scans
with K5 under ``ssd_impl="pallas"``, the kernel writing the final state
decode starts from (``ops.ssd_scan(..., final_state=True)``), and
attends with K4 (scale and ``kv_start``) under
``attention_impl="pallas"``. With a ``DeviceTrace``
(``trace``) each layer call is an ``lm.mamba``, ``lm.attention`` or
``lm.moe`` span with its device time, and the MoE counts its slots
(``moe_slots``) and each call's busiest expert's (``moe_max_expert_slots``)
on the card.

Public surface:
  schema(cfg)                            -> ParamSpec tree
  forward_train(params, batch, cfg)      -> (loss, metrics)
  prefill(params, batch, cfg)            -> (last_logits (B, V), Cache)
  decode_step(params, batch, cache, cfg) -> (logits (B, V), Cache)

Kernels: ``attention_impl="pallas"`` sends attention in prefill and
training through K4 (``kernels.ops.flash_attention``), the hybrid's shared
block included (``"tri"`` takes ``layers.causal_attention_tri``, ``"xla"``
``layers.causal_attention_ref``), and ``ssd_impl="pallas"`` sends the SSD
scan in training through K5 (``kernels.ops.ssd_scan``), as the reference
reaches its Pallas kernels. The ssm and hybrid families serve with the
plain ``layers.ssd_chunked`` (prefill, for its final state) and
``layers.ssd_decode_step`` (decode), as the reference does.

Semantics kept from the reference, faults included:
  * the decode cache is as long as the prompt (Smax = S of the prefill)
    unless ``prefill`` is given a longer ``max_len`` (the serving
    config's), the hybrid's shared-attention cache too; each decode step
    writes at ``min(length, Smax - 1)`` (the clamp of
    ``dynamic_update_slice``), so once the cache is full every new token
    overwrites the last slot, while ``length`` keeps growing;
  * positions are ``arange(S)`` in prefill, whatever the padding, and
    ``cache.length`` in decode, unless the batch brings its own; with
    M-RoPE the batch must bring them, in prefill and in decode.

On a mesh (``shard`` a ``Sharder`` with one; ``train.steps`` builds it)
parameters, batch and caches are DTensors and the reference's constraint
sites redistribute the activations. Attention (every route, K4 included)
and the SSD scan (K5, ``ssd_chunked``, the decode step) run under
``Sharder.local`` with batch on the data axes and heads on the model
axis, so each shard's attention and scan is exact; where the q heads
shard and the kv heads do not, each q head gets a copy of its kv head
first. Host-made constants (positions, masks, RoPE tables) enter as
replicated (``implicit_replication``).
One difference of form: ``decode_step`` writes the new token's k/v and
the new SSM states into the cache tensors in place (the reference returns
new arrays); the returned ``Cache`` shares them, so a caller that needs
the old cache clones it first.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor import empty as dtensor_empty
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import NULL_SHARDER, ParamSpec

__all__ = ["schema", "Cache", "cache_specs", "cache_axes", "forward_train",
           "prefill", "decode_step", "MOE_AUX_WEIGHT"]

Params = Dict[str, Any]
MOE_AUX_WEIGHT = 0.01


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ================================================================ schema ====
def _attn_schema(cfg: ModelConfig, prefix_dims=()) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    lead = prefix_dims
    la = ("layers",) * len(prefix_dims)
    s: Params = {
        "wq": ParamSpec(lead + (d, cfg.num_heads * hd), la + ("embed_param", "qkv")),
        "wk": ParamSpec(lead + (d, cfg.num_kv_heads * hd), la + ("embed_param", "kv_heads")),
        "wv": ParamSpec(lead + (d, cfg.num_kv_heads * hd), la + ("embed_param", "kv_heads")),
        "wo": ParamSpec(lead + (cfg.num_heads * hd, d), la + ("qkv", "embed_param")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(lead + (cfg.num_heads * hd,), la + ("qkv",), init="zeros")
        s["bk"] = ParamSpec(lead + (cfg.num_kv_heads * hd,), la + ("kv_heads",), init="zeros")
        s["bv"] = ParamSpec(lead + (cfg.num_kv_heads * hd,), la + ("kv_heads",), init="zeros")
    return s


def _ffn_schema(cfg: ModelConfig, prefix_dims=()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    lead, la = prefix_dims, ("layers",) * len(prefix_dims)
    if cfg.family == "moe":
        e = cfg.num_experts
        return {
            "router": ParamSpec(lead + (d, e), la + ("embed_param", None)),
            "wi_gate": ParamSpec(lead + (e, d, f), la + ("expert", "embed_param", "mlp")),
            "wi_up": ParamSpec(lead + (e, d, f), la + ("expert", "embed_param", "mlp")),
            "wo": ParamSpec(lead + (e, f, d), la + ("expert", "mlp", "embed_param")),
        }
    if cfg.mlp_style == "mlp2":    # up/down only (granite/minitron style)
        return {
            "wi_up": ParamSpec(lead + (d, f), la + ("embed_param", "mlp")),
            "wo": ParamSpec(lead + (f, d), la + ("mlp", "embed_param")),
        }
    return {
        "wi_gate": ParamSpec(lead + (d, f), la + ("embed_param", "mlp")),
        "wi_up": ParamSpec(lead + (d, f), la + ("embed_param", "mlp")),
        "wo": ParamSpec(lead + (f, d), la + ("mlp", "embed_param")),
    }


def _ssd_schema(cfg: ModelConfig, prefix_dims=()) -> Params:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    lead, la = prefix_dims, ("layers",) * len(prefix_dims)
    return {
        "wz": ParamSpec(lead + (d, di), la + ("embed_param", "mlp")),
        "wx": ParamSpec(lead + (d, di), la + ("embed_param", "mlp")),
        "wB": ParamSpec(lead + (d, n), la + ("embed_param", "state")),
        "wC": ParamSpec(lead + (d, n), la + ("embed_param", "state")),
        "wdt": ParamSpec(lead + (d, h), la + ("embed_param", "heads")),
        "A_log": ParamSpec(lead + (h,), la + ("heads",), init="zeros"),
        "dt_bias": ParamSpec(lead + (h,), la + ("heads",), init="zeros"),
        "D_skip": ParamSpec(lead + (h,), la + ("heads",), init="ones"),
        "norm_w": ParamSpec(lead + (di,), la + ("mlp",), init="ones"),
        "out": ParamSpec(lead + (di, d), la + ("mlp", "embed_param")),
    }


def schema(cfg: ModelConfig) -> Params:
    """Parameter schema for decoder-only families (encdec is whisper's)."""
    d, nl = cfg.d_model, cfg.num_layers
    s: Params = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed_param")),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed_param", "vocab"))
    s["final_norm"] = ParamSpec((d,), ("embed",), init="ones")

    lead = (nl,)
    if cfg.family in ("dense", "vlm", "moe"):
        s["blocks"] = {
            "ln1": ParamSpec(lead + (d,), ("layers", "embed"), init="ones"),
            "ln2": ParamSpec(lead + (d,), ("layers", "embed"), init="ones"),
            **_attn_schema(cfg, lead),
            "ffn": _ffn_schema(cfg, lead),
        }
    elif cfg.family in ("ssm", "hybrid"):
        s["blocks"] = {
            "ln1": ParamSpec(lead + (d,), ("layers", "embed"), init="ones"),
            **_ssd_schema(cfg, lead),
        }
        if cfg.family == "hybrid":
            s["shared_attn"] = {
                "ln1": ParamSpec((d,), ("embed",), init="ones"),
                "ln2": ParamSpec((d,), ("embed",), init="ones"),
                **_attn_schema(cfg),
                "ffn": {
                    "wi_gate": ParamSpec((d, cfg.d_ff), ("embed_param", "mlp")),
                    "wi_up": ParamSpec((d, cfg.d_ff), ("embed_param", "mlp")),
                    "wo": ParamSpec((cfg.d_ff, d), ("mlp", "embed_param")),
                },
            }
    elif cfg.family == "hybrid_moe":
        s.update(_hybrid_moe_schema(cfg))
    else:
        raise ValueError(cfg.family)
    return s


def _layer_counts(cfg: ModelConfig):
    """(attention layers, Mamba-2 layers) of the hybrid_moe pattern."""
    n_attn = sum(t == "attention" for t in cfg.layer_types)
    return n_attn, cfg.num_layers - n_attn


def _hybrid_moe_schema(cfg: ModelConfig) -> Params:
    """Every layer's norms and MoE FFN stacked in ``blocks``, the Mamba-2
    mixers in ``mamba`` and the attention mixers in ``attn``, each stacked
    in the order of ``layer_types``. Matrices are drawn N(0, 1/fan_in),
    the embedding N(0, 0.1^2) (HF's initializer_range), A_log and dt_bias
    by Mamba-2's law (``params.init_params``)."""
    if len(cfg.layer_types) != cfg.num_layers or not set(
            cfg.layer_types) <= {"mamba", "attention"}:
        raise ValueError(f"layer_types {cfg.layer_types} must give "
                         f"'mamba' or 'attention' for each of "
                         f"{cfg.num_layers} layers")
    d, hd, e, f = cfg.d_model, cfg.resolved_head_dim, cfg.num_experts, cfg.d_ff
    di, n, h, fs = (cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_heads,
                    cfg.shared_expert_ff)
    cd = di + 2 * n
    n_attn, n_mamba = _layer_counts(cfg)
    w = lambda lead, *shape, ax=None: ParamSpec(
        (lead,) + shape, ("layers",) + (ax or (None,) * len(shape)),
        init="fan_in")
    ones = lambda lead, *shape: ParamSpec((lead,) + shape,
                                          ("layers",) + (None,) * len(shape),
                                          init="ones")
    L_ = cfg.num_layers
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed_param"),
                           init="fan_in", scale=0.1 * cfg.vocab_size ** 0.5),
        "blocks": {
            "ln1": ones(L_, d), "ln2": ones(L_, d),
            "router": w(L_, d, e),
            "expert_wi": w(L_, e, d, 2 * f,
                           ax=("expert", "embed_param", "mlp")),
            "expert_wo": w(L_, e, f, d, ax=("expert", "mlp", "embed_param")),
            "shared_wi": w(L_, d, 2 * fs), "shared_wo": w(L_, fs, d),
        },
        "mamba": {
            "in_proj": w(n_mamba, d, di + cd + h),
            "conv_w": w(n_mamba, cfg.ssm_conv, cd),
            "conv_b": ParamSpec((n_mamba, cd), ("layers", None),
                                init="zeros"),
            "A_log": ParamSpec((n_mamba, h), ("layers", "heads"),
                               init="a_log"),
            "dt_bias": ParamSpec((n_mamba, h), ("layers", "heads"),
                                 init="dt_bias"),
            "D": ones(n_mamba, h),
            "norm_w": ones(n_mamba, di),
            "out_proj": w(n_mamba, di, d),
        },
        "attn": {
            "wq": w(n_attn, d, cfg.num_heads * hd),
            "wk": w(n_attn, d, cfg.num_kv_heads * hd),
            "wv": w(n_attn, d, cfg.num_kv_heads * hd),
            "wo": w(n_attn, cfg.num_heads * hd, d),
        },
    }


# ================================================================ caches ====
@dataclasses.dataclass
class Cache:
    """Decode-time state: attention caches (L, B, Smax, Hkv_eff, hd) of the
    dense and MoE families; SSM states (L, B, H, P, N) float32 of the ssm
    and hybrid families; the hybrid's shared-attention caches (napps, B,
    Smax, Hkv, hd), one per application; and the (B,) count of tokens
    seen. The hybrid_moe family keeps side by side its attention layers'
    caches in ``k``/``v`` (one per attention layer), its Mamba-2 layers'
    SSM states in ``ssm`` and their last ``ssm_conv - 1`` conv inputs in
    ``conv`` (n_mamba, B, W - 1, conv dim), and each row's first live
    position (its left-padding) in ``start`` (B,)."""
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    shared_k: Optional[torch.Tensor] = None
    shared_v: Optional[torch.Tensor] = None
    length: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None
    start: Optional[torch.Tensor] = None


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """The decode cache as ``meta`` tensors (shapes and types, no memory);
    ``prefill`` allocates it with ``max_len`` = the prompt's length."""
    _check_supported(cfg)
    dt = _dtype(cfg.compute_dtype)
    meta = lambda shp, t=dt: torch.empty(shp, dtype=t, device="meta")
    hd = cfg.resolved_head_dim
    c = Cache(length=meta((batch,), torch.int32))
    if cfg.family == "hybrid_moe":
        n_attn, n_mamba = _layer_counts(cfg)
        shp = (n_attn, batch, max_len, cfg.num_kv_heads, hd)
        c.k, c.v = meta(shp), meta(shp)
        c.ssm = meta((n_mamba, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state), torch.float32)
        c.conv = meta((n_mamba, batch, cfg.ssm_conv - 1,
                       cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state))
        c.start = meta((batch,), torch.int32)
        return c
    if cfg.family in ("dense", "vlm", "moe"):
        shp = (cfg.num_layers, batch, max_len, cfg.effective_kv_heads, hd)
        c.k, c.v = meta(shp), meta(shp)
    else:
        h = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        c.ssm = meta((cfg.num_layers, batch, h, cfg.ssm_head_dim,
                      cfg.ssm_state), torch.float32)
    if cfg.family == "hybrid":
        shp = (cfg.num_layers // cfg.attn_period, batch, max_len,
               cfg.num_kv_heads, hd)
        c.shared_k, c.shared_v = meta(shp), meta(shp)
    return c


def cache_axes(cfg: ModelConfig) -> Cache:
    """Logical axes matching ``cache_specs`` (for shardings)."""
    c = Cache(length=("batch",))
    attn_axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    if cfg.family == "hybrid_moe":
        return Cache(k=attn_axes, v=attn_axes,
                     ssm=("layers", "batch", "heads", None, "state"),
                     conv=("layers", "batch", None, None), length=("batch",),
                     start=("batch",))
    if cfg.family in ("dense", "vlm", "moe"):
        c.k = attn_axes
        c.v = attn_axes
    if cfg.family in ("ssm", "hybrid"):
        c.ssm = ("layers", "batch", "heads", None, "state")
    if cfg.family == "hybrid":
        c.shared_k = attn_axes
        c.shared_v = attn_axes
    return c


def _check_supported(cfg: ModelConfig) -> None:
    families = ("dense", "vlm", "moe", "ssm", "hybrid", "hybrid_moe")
    if cfg.family not in families:
        raise ValueError(
            f"family {cfg.family!r} is not a decoder-only family "
            f"({', '.join(families)}); the encoder-decoder is "
            "models.encdec (model_api.get_module)")
    if cfg.param_dtype != cfg.compute_dtype:
        raise NotImplementedError(
            f"param_dtype {cfg.param_dtype} != compute_dtype "
            f"{cfg.compute_dtype}: no config of the repo mixes them")


# ============================================================== forward =====
def _repeat_heads(t, r: int):
    """(B, S, H, D) -> (B, S, H * r, D), each head repeated ``r`` times in
    place (``repeat_interleave`` on dim 2, as one expand and a view)."""
    B, S, H, D = t.shape
    return t[:, :, :, None].expand(B, S, H, r, D).reshape(B, S, H * r, D)


def _attend(fn, q, k, v, shard):
    """``fn(q, k, v)`` on (B, S, H, D) tensors; on a mesh, under
    ``Sharder.local`` with batch on the data axes and heads on the model
    axis, the kv heads repeated to the q heads' count first where the q
    heads shard and the kv heads do not."""
    if shard.mesh is None:
        return fn(q, k, v)
    pl = shard.placements(q.shape, "batch", None, "heads", None)
    if pl != shard.placements(k.shape, "batch", None, "kv_heads", None):
        r = q.shape[2] // k.shape[2]
        k = _repeat_heads(shard(k, "batch", None, None, None), r)
        v = _repeat_heads(shard(v, "batch", None, None, None), r)
    return shard.local(fn, (q, k, v), (pl, pl, pl), pl)


def _attention(x, p, cfg: ModelConfig, shard, positions, mode: str,
               kv_cache=None, cache_len=None):
    """Self-attention for one block. Returns (out, new_kv): the new (k, v)
    for prefill; for decode the layer's caches, written in place; None for
    train."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(x, p["wq"])
    k = L.dense(x, p["wk"])
    v = L.dense(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard.view(q, (B, S, cfg.num_heads, hd), "batch", None, "heads", None)
    k = shard.view(k, (B, S, cfg.num_kv_heads, hd), "batch", None,
                   "kv_heads", None)
    v = shard.view(v, (B, S, cfg.num_kv_heads, hd), "batch", None,
                   "kv_heads", None)
    if cfg.mrope:
        q = L.apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cfg.kv_head_replication > 1 and mode in ("prefill", "decode"):
        # duplicate kv heads so the cache shards over the model axis
        # (identical math: each q group maps to a copy of its kv head)
        r = cfg.kv_head_replication
        k = shard(_repeat_heads(k, r), "batch", None, "kv_heads", None)
        v = shard(_repeat_heads(v, r), "batch", None, "kv_heads", None)

    if mode in ("train", "prefill"):
        if cfg.attention_impl == "pallas":
            fn = lambda q, k, v: ops.flash_attention(q, k, v, causal=True)  # K4
        elif cfg.attention_impl == "tri":
            fn = L.causal_attention_tri
        else:
            fn = L.causal_attention_ref
        out = _attend(fn, q, k, v, shard)
        new_kv = (k, v) if mode == "prefill" else None
    else:  # decode: S == 1
        kc, vc = kv_cache
        if shard.mesh is None:
            out = _decode_attention(q, k, v, kc, vc, cache_len)
        else:
            # q, k and v take the cache's own placements (batch, and kv
            # heads where they shard), so the in-place write lands in the
            # cache's local shard and each shard's GQA groups are whole
            cpl = kc.placements
            bpl = tuple(q if isinstance(q, Shard) and q.dim == 0
                        else Replicate() for q in cpl)
            out = shard.local(_decode_attention,
                              (q, k, v, kc, vc, cache_len),
                              (cpl,) * 5 + (bpl,), cpl)
        new_kv = (kc, vc)
    out = out.reshape(B, S, cfg.num_heads * hd)
    return L.dense(out, p["wo"]), new_kv


def _decode_attention(q, k, v, kc, vc, cache_len):
    """Write the new token's k/v at ``min(cache_len, Smax - 1)`` (the
    clamp of ``dynamic_update_slice``) into the caches, in place, and
    attend over them."""
    slot = cache_len.long().clamp(0, kc.shape[1] - 1)
    rows = torch.arange(q.shape[0], device=q.device)
    kc[rows, slot] = k[:, 0]
    vc[rows, slot] = v[:, 0]
    return L.decode_attention(q, kc, vc, cache_len + 1)


def _ffn(x, p, cfg: ModelConfig, shard=NULL_SHARDER):
    """Returns (out, aux loss): the MoE block's load-balance loss, None for
    the other families (the reference's 0)."""
    if cfg.family == "moe":
        return L.moe_block(x, p, cfg, shard)
    if cfg.mlp_style == "mlp2":
        h = shard(L.dense(x, p["wi_up"]), "batch", "seq", "mlp")
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return L.dense(h, p["wo"]), None
    return L.swiglu_mlp(x, p["wi_gate"], p["wi_up"], p["wo"], shard), None


def _transformer_block(x, p, cfg, positions, mode, kv_cache=None,
                       cache_len=None, shard=NULL_SHARDER):
    """Returns (out, new_kv, aux loss or None)."""
    h, new_kv = _attention(L.rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg,
                           shard, positions, mode, kv_cache, cache_len)
    x = shard(x + h, "batch", "seq_sp", "embed")
    h, aux = _ffn(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg, shard)
    return shard(x + h, "batch", "seq_sp", "embed"), new_kv, aux


def _ssd_block(x, p, cfg: ModelConfig, shard=NULL_SHARDER,
               mode: str = "train", ssm_state=None):
    """Mamba-2 block. Returns (out, new_state): the final (B, H, P, N)
    float32 state in prefill, the updated state in decode (S == 1, from
    ``ssm_state``), None in train."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    nh = di // cfg.ssm_head_dim
    xin = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    z = L.dense(xin, p["wz"])
    xv = shard(L.dense(xin, p["wx"]), "batch", None, "mlp")
    Bm = L.dense(xin, p["wB"])
    Cm = L.dense(xin, p["wC"])
    u = L.dense(xin, p["wdt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(u, torch.zeros_like(u))       # jax.nn.softplus
    A = -torch.exp(p["A_log"].float())
    xh = xv.reshape(B, S, nh, cfg.ssm_head_dim)
    chunk = min(cfg.ssm_chunk, S)
    new_state = None
    # on a mesh the scans run on local shards: batch on the data axes,
    # heads on the model axis (y's placements ypl, the state's hpl)
    ins = ypl = hpl = None
    if shard.mesh is not None:
        pl = lambda t, *axes: shard.placements(t.shape, *axes)
        ypl = pl(xh, "batch", None, "heads", None)
        hpl = shard.placements((B, nh, cfg.ssm_head_dim, Bm.shape[-1]),
                               "batch", "heads", None, "state")
        ins = (ypl, pl(dt, "batch", None, "heads"), pl(A, "heads"),
               pl(Bm, "batch", None, None), pl(Cm, "batch", None, None))
    if mode == "decode":
        y, new_state = shard.local(
            lambda h, x, dt, A, Bm, Cm: L.ssd_decode_step(
                h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0]),
            (ssm_state, xh, dt, A, Bm, Cm), (hpl,) + (ins or ()),
            (_drop_dim1(ypl), hpl))
        y = y[:, None]
    elif cfg.ssd_impl == "pallas" and mode == "train":
        y = shard.local(lambda *a: ops.ssd_scan(*a, chunk=chunk),   # K5
                        (xh, dt, A, Bm, Cm), ins, ypl)
    else:
        y, h_final = shard.local(lambda *a: L.ssd_chunked(*a, chunk),
                                 (xh, dt, A, Bm, Cm), ins, (ypl, hpl))
        if mode == "prefill":
            new_state = h_final
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rms_norm(y, p["norm_w"], cfg.norm_eps)
    return shard(x + L.dense(y, p["out"]), "batch", "seq_sp", "embed"), \
        new_state


def _drop_dim1(placements):
    """``placements`` of a (B, S, ...) tensor for its (B, ...) slice."""
    if placements is None:
        return None
    return tuple(Shard(q.dim - (q.dim > 1)) if isinstance(q, Shard) else q
                 for q in placements)


# ============================================================ hybrid_moe ====
def _live(cache: Cache, S: int, cfg: ModelConfig):
    """(B, S) bool, the positions at or after each row's start, where the
    config masks its left-padding; else None."""
    if not cfg.mask_padding:
        return None
    pos = torch.arange(S, device=cache.start.device)
    return pos[None, :] >= cache.start[:, None]


def _mamba_mixer(h, p, cfg: ModelConfig, mode: str, cache: Cache, li: int):
    """The hybrid_moe family's Mamba-2 mixer on the normed input ``h`` (B,
    S, D), HF's Mamba2Mixer with one group: in_proj -> (z, xBC, dt); xBC
    through the causal depthwise conv and SiLU -> (x, B, C); dt =
    softplus(dt + dt_bias), A = -exp(A_log); y = SSD(x, dt, A, B, C) +
    D x; out_proj(rmsnorm(y * silu(z))). Prefill leaves layer ``li``'s
    final SSM state and last conv inputs in ``cache``; decode (S == 1)
    steps both in place. At masked pads the conv inputs and dt are 0, so
    neither state sees them."""
    B, S, _ = h.shape
    di, n, H, P = (cfg.ssm_expand * cfg.d_model, cfg.ssm_state,
                   cfg.ssm_heads, cfg.ssm_head_dim)
    W = cfg.ssm_conv
    z, xbc, dt = L.dense(h, p["in_proj"]).split([di, di + 2 * n, H], dim=-1)
    live = None
    if mode == "decode":
        out, state = L.conv_step(cache.conv[li], xbc[:, 0], p["conv_w"],
                                 p["conv_b"])
        cache.conv[li].copy_(state)
        xbc = out[:, None]
    else:
        live = _live(cache, S, cfg)
        if live is not None:
            xbc = xbc.masked_fill(~live[..., None], 0)
        tail = F.pad(xbc, (0, 0, max(W - 1 - S, 0), 0))[:, -(W - 1):]
        cache.conv[li] = tail
        xbc = L.causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc.float()).to(h.dtype)
    x, Bm, Cm = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    if live is not None:
        dt = dt.masked_fill(~live[..., None], 0)
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(B, S, H, P)
    if mode == "decode":
        y, cache.ssm[li] = L.ssd_decode_step(cache.ssm[li], xh[:, 0],
                                             dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        args = (xh.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                Cm.contiguous())
        chunk = min(cfg.ssm_chunk, S)
        if cfg.ssd_impl == "pallas":
            y, cache.ssm[li] = ops.ssd_scan(*args, chunk=chunk,   # K5
                                            final_state=True)
        else:
            y, cache.ssm[li] = L.ssd_chunked(*args, chunk)
    y = y.float() + xh.float() * p["D"].float()[:, None]
    # HF's MambaRMSNormGated: gate, normalize in float32, scale in h's type
    g = y.reshape(B, S, di) * F.silu(z.float())
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return L.dense(p["norm_w"] * g.to(h.dtype), p["out_proj"])


def _nope_attention(h, p, cfg: ModelConfig, mode: str, cache: Cache,
                    li: int):
    """The hybrid_moe family's GQA attention without position embeddings,
    at ``cfg.attention_scale``. Prefill attends causally (K4 under
    ``attention_impl="pallas"``) and writes layer ``li``'s k/v into the
    cache's first S slots; decode writes the new token's at
    ``min(length, Smax - 1)`` and attends over the cache. Keys before a
    row's start are masked where the config masks padding."""
    B, S, _ = h.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = L.dense(h, p["wq"]).view(B, S, nq, hd)
    k = L.dense(h, p["wk"]).view(B, S, nkv, hd)
    v = L.dense(h, p["wv"]).view(B, S, nkv, hd)
    scale = cfg.resolved_attention_scale
    start = cache.start if cfg.mask_padding else None
    kc, vc = cache.k[li], cache.v[li]
    if mode == "prefill":
        if cfg.attention_impl == "pallas":
            out = ops.flash_attention(q, k, v, causal=True, scale=scale,
                                      kv_start=start)                  # K4
        else:
            out = L.causal_attention_ref(q, k, v, scale=scale,
                                         kv_start=start)
        kc[:, :S] = k
        vc[:, :S] = v
    else:
        slot = cache.length.long().clamp(0, kc.shape[1] - 1)
        rows = torch.arange(B, device=h.device)
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
        out = L.decode_attention(q, kc, vc, cache.length + 1, scale=scale,
                                 kv_start=start)
    return L.dense(out.reshape(B, S, nq * hd), p["wo"])


def _span(trace, name: str, **attrs):
    return contextlib.nullcontext() if trace is None else trace.span(
        name, **attrs)


def _hybrid_moe_layers(x, params, cfg: ModelConfig, mode: str, cache: Cache,
                       trace=None):
    """The hybrid_moe layer stack in serving: per layer of
    ``layer_types``, h = x + m * mixer(rmsnorm(x)), then h + m *
    (moe(rmsnorm2(h)) + shared(rmsnorm2(h))), m the residual multiplier."""
    m = cfg.residual_multiplier
    n_attn, n_mamba = _layer_counts(cfg)
    blocks = _unbind_layers(params["blocks"], cfg.num_layers)
    mamba = _unbind_layers(params["mamba"], n_mamba)
    attn = _unbind_layers(params["attn"], n_attn)
    counters = None
    if trace is not None and trace.recording:
        counters = (trace.counter("moe_slots"),
                    trace.counter("moe_max_expert_slots"))
    mi = ai = 0
    for i, kind in enumerate(cfg.layer_types):
        bp = blocks[i]
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        if kind == "mamba":
            with _span(trace, "lm.mamba", layer=i):
                h = _mamba_mixer(h, mamba[mi], cfg, mode, cache, mi)
            mi += 1
        else:
            with _span(trace, "lm.attention", layer=i):
                h = _nope_attention(h, attn[ai], cfg, mode, cache, ai)
            ai += 1
        x = x + h * m
        with _span(trace, "lm.moe", layer=i):
            h = L.moe_dropless(L.rms_norm(x, bp["ln2"], cfg.norm_eps), bp,
                               cfg, counters)
        x = x + h * m
    return x


def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the output of every ``aten.mm``, which
    is a weight product (``layers.dense``), and recompute the rest, the
    attention's and the MoE experts' batched ``aten.bmm`` products
    included, as ``dots_with_no_batch_dims_saveable`` keeps the
    no-batch-dimension ``dot_general``s."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``"full"``: recompute the layer body in backward, saving only its
    input (``jax.checkpoint`` with ``nothing_saveable``); ``"dots"``: the
    same, but the weight products saved in the forward are read back,
    not recomputed (a selective checkpoint); ``"none"``: run it plain."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_weight_products))
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _embed(params, batch, cfg: ModelConfig, shard=NULL_SHARDER):
    """Token embedding, its first rows overwritten by ``patch_embeds`` (B,
    P, D) for the VLM family where the batch has them. Returns (x,
    positions): the batch's, which M-RoPE requires, of shape (3, B, S),
    else ``arange(S)``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if isinstance(tokens, DTensor):
        # the table's FSDP dim gathered: a vocab-sharded lookup of
        # batch-sharded tokens
        x = F.embedding(shard(tokens, "batch", None).long(),
                        shard(params["embed"], "vocab", None))
    else:       # the same op, so that a 1x1 mesh's step is this one's
        x = F.embedding(tokens.long(), params["embed"])
    x = x.to(_dtype(cfg.compute_dtype))
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        if isinstance(x, DTensor):
            # the vocab-sharded lookup's partial sum reduced first
            x = shard(x, "batch", None, "embed")
            x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
        else:
            x[:, :pe.shape[1]] = pe.to(x.dtype)
    x = shard(x, "batch", "seq_sp", "embed")
    positions = batch.get("positions")
    if cfg.mrope:
        if positions is None or tuple(positions.shape) != (3, B, S):
            raise ValueError(
                f"M-RoPE takes batch['positions'] of shape (3, {B}, {S}) "
                "(temporal, height, width ids); got "
                f"{None if positions is None else tuple(positions.shape)}")
    elif positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    return x, positions


def _unembed(x, params, cfg: ModelConfig, shard=NULL_SHARDER):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(x, DTensor):
        return shard(L.dense(x, head), "batch", None, "vocab")
    logits = torch.einsum("bsd,dv->bsv", x, head)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _unbind_layers(blocks, n: int):
    """The stacked block weights as ``n`` per-layer trees of views (no
    copies), one ``unbind`` per leaf. In training its backward stacks the
    layers' gradients once; taking ``blocks[i]`` layer by layer would
    instead scatter each layer's gradient into a zero tensor of the whole
    stack and add the ``n`` of them (memory traffic quadratic in depth)."""
    if isinstance(blocks, torch.Tensor):
        return torch.unbind(blocks, 0)
    per_key = {k: _unbind_layers(v, n) for k, v in blocks.items()}
    return [{k: per_key[k][i] for k in blocks} for i in range(n)]


def _cached_block(x, p, cfg: ModelConfig, shard, positions, mode: str, kc,
                  vc, slot: int, cache_len):
    """A transformer block in serving whose kv cache is ``kc[slot]``,
    ``vc[slot]``: prefill writes it, decode updates it in place."""
    if mode == "prefill":
        x, (k, v), _ = _transformer_block(x, p, cfg, positions, mode,
                                          shard=shard)
        if k.shape[1] == kc.shape[2]:
            kc[slot], vc[slot] = k, v
        else:                   # a cache longer than the prompt
            kc[slot, :, :k.shape[1]], vc[slot, :, :k.shape[1]] = k, v
        return x
    return _transformer_block(x, p, cfg, positions, mode,
                              (kc[slot], vc[slot]), cache_len, shard)[0]


def _run_layers(x, params, cfg: ModelConfig, shard, positions, mode: str,
                cache: Cache):
    """The layer stack in serving, in order: dense or MoE transformer
    blocks (the MoE's aux loss unused, as in the reference); Mamba-2
    blocks; or Mamba-2 blocks with the one ``shared_attn`` block applied
    after layer ``i`` whenever ``i % attn_period == attn_period - 1`` (the
    hybrid), application ``i // attn_period`` keeping its own kv cache.
    Prefill writes each layer's k/v or final state into ``cache``; decode
    updates ``cache`` in place."""
    period = cfg.attn_period
    for i, bp in enumerate(_unbind_layers(params["blocks"], cfg.num_layers)):
        if cfg.family in ("dense", "vlm", "moe"):
            x = _cached_block(x, bp, cfg, shard, positions, mode, cache.k,
                              cache.v, i, cache.length)
            continue
        x, cache.ssm[i] = _ssd_block(
            x, bp, cfg, shard, mode, cache.ssm[i] if mode == "decode" else None)
        if cfg.family == "hybrid" and i % period == period - 1:
            x = _cached_block(x, params["shared_attn"], cfg, shard, positions,
                              mode, cache.shared_k, cache.shared_v,
                              i // period, cache.length)
    return x


def _train_layers(x, params, cfg: ModelConfig, shard, positions):
    """The layer stack in train mode, in order: dense or MoE transformer
    blocks; Mamba-2 blocks; or Mamba-2 blocks with the one ``shared_attn``
    block applied after layer ``idx`` whenever ``idx % attn_period ==
    attn_period - 1`` (the hybrid). Returns (x, the MoE aux losses summed
    over the layers, or None for the other families)."""
    layers = _unbind_layers(params["blocks"], cfg.num_layers)
    if cfg.family in ("dense", "vlm", "moe"):
        def body(xc, i):
            xc, _, aux = _transformer_block(xc, layers[i], cfg, positions,
                                            "train", shard=shard)
            return xc, aux
    elif cfg.family == "ssm":
        def body(xc, i):
            return _ssd_block(xc, layers[i], cfg, shard)[0], None
    else:                                           # hybrid
        period = cfg.attn_period

        def body(xc, i):
            xc = _ssd_block(xc, layers[i], cfg, shard)[0]
            if i % period == period - 1:
                xc = _transformer_block(xc, params["shared_attn"], cfg,
                                        positions, "train", shard=shard)[0]
            return xc, None
    body = _remat(body, cfg)
    aux_total = None
    for i in range(cfg.num_layers):
        x, aux = body(x, i)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


# ================================================================= entry ====
def _replicated_constants(shard):
    """On a mesh, host-made tensors (positions, masks, RoPE tables) enter
    the DTensor program as replicated (``implicit_replication``)."""
    if shard.mesh is None:
        return contextlib.nullcontext()
    return implicit_replication()


def forward_train(params, batch, cfg: ModelConfig, shard=NULL_SHARDER):
    """Next-token cross-entropy in float32. batch: tokens (B, S) int,
    labels (B, S) int (-1 = masked). Returns (total, {"loss", "aux_loss"})
    with total = loss + MOE_AUX_WEIGHT * aux_loss, aux_loss the MoE
    layers' load-balance losses summed (0 for the other families)."""
    with _replicated_constants(shard):
        _check_supported(cfg)
        x, positions = _embed(params, batch, cfg, shard)
        x, aux = _train_layers(x, params, cfg, shard, positions)
        logits = _unembed(x, params, cfg, shard).float()
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        nll = L.grad_placed_as(_token_nll(logits, labels, shard)) * mask
        loss = nll.sum() / mask.sum().clamp(min=1.0)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return loss + MOE_AUX_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


def _token_nll(logits, labels, shard):
    """(B, S) float32 -log softmax(logits)[label] (labels clamped at 0).
    Logits whose vocab is sharded (a DTensor of a mesh whose vocab axis
    has more than one rank) take the vocab-parallel form: each shard's
    max and sum of exponentials, reduced over the vocab shards, and the
    label's logit as a sum over each shard's hits (an id range sharded as
    the vocab, compared with the labels), so that neither the loss nor its
    gradient gathers a (B, S, V) row. Otherwise ``logsumexp`` and a gather
    over whole rows."""
    idx = labels.clamp(min=0)[..., None]
    mesh = getattr(logits, "device_mesh", None)
    if isinstance(logits, DTensor) and any(
            q.is_shard(2) and mesh.size(i) > 1
            for i, q in enumerate(logits.placements)):
        # each reduction over the vocab shards is made whole (batch-sharded,
        # replicated on the vocab axes) at once, so that its gradient meets
        # the vocab-sharded logits without a gather
        whole = lambda t: shard(t, "batch", *(None,) * (t.ndim - 1))
        m = whole(logits.detach().amax(dim=-1, keepdim=True))
        lse = whole((logits - m).exp().sum(dim=-1)).log() + m[..., 0]
        ids = distribute_tensor(
            torch.arange(logits.shape[-1], device=logits.device), mesh,
            [Shard(0) if q.is_shard(2) else Replicate()
             for q in logits.placements], src_data_rank=None)
        hit = (ids == idx).to(logits.dtype).redistribute(
            mesh, logits.placements)
        return lse - whole((logits * hit).sum(dim=-1))
    if isinstance(logits, DTensor):
        logits = shard(logits, "batch", None, None)
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, idx)[..., 0])


def _new_cache(spec: Cache, axes: Cache, device, shard,
               zero: bool = False) -> Cache:
    """Uninitialised cache tensors of ``spec``'s shapes (zeros with
    ``zero``: a cache longer than the prompt, whose unwritten slots a
    decode step reads under its mask); DTensors of the cache axes'
    placements on a mesh."""
    out = {}
    new = torch.zeros if zero else torch.empty
    for f in dataclasses.fields(Cache):
        t = getattr(spec, f.name)
        if t is None:
            continue
        if shard.mesh is None:
            out[f.name] = new(t.shape, dtype=t.dtype, device=device)
        else:
            out[f.name] = dtensor_empty(
                t.shape, dtype=t.dtype, device_mesh=shard.mesh,
                placements=shard.placements(t.shape, *getattr(axes, f.name)))
    return Cache(**out)


def _check_serving(cfg: ModelConfig, shard) -> None:
    if cfg.family == "hybrid_moe" and shard.mesh is not None:
        raise NotImplementedError(
            "the hybrid_moe family serves on one device; it has no mesh "
            "layout")
    if cfg.mask_padding and cfg.family != "hybrid_moe":
        raise NotImplementedError(
            f"mask_padding: only the hybrid_moe family masks its "
            f"left-padding, not {cfg.family!r}")


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, shard=NULL_SHARDER, *,
            max_len: Optional[int] = None, trace=None):
    """Process a full prompt; returns (last_token_logits, Cache). The
    attention caches hold ``max_len`` positions (the prompt's length by
    default; a longer one leaves room for the generated tokens). With
    ``cfg.mask_padding`` the batch's ``start`` (B,) int32 gives each row's
    left-padding (0 if absent). ``trace`` (an ``obs.device.DeviceTrace``)
    times the hybrid_moe family's layer calls."""
    with _replicated_constants(shard):
        _check_serving(cfg, shard)
        B, S = batch["tokens"].shape
        max_len = S if max_len is None else max(int(max_len), S)
        spec = cache_specs(cfg, B, max_len)
        x, positions = _embed(params, batch, cfg, shard)
        cache = _new_cache(spec, cache_axes(cfg), x.device, shard,
                           zero=max_len > S)
        cache.length.fill_(S)
        if cfg.family == "hybrid_moe":
            start = batch.get("start")
            if start is None:
                cache.start.zero_()
            else:
                cache.start.copy_(start)
            x = _hybrid_moe_layers(x, params, cfg, "prefill", cache, trace)
        else:
            x = _run_layers(x, params, cfg, shard, positions, "prefill",
                            cache)
        logits = _unembed(x[:, -1:], params, cfg, shard)
        return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, batch, cache: Cache, cfg: ModelConfig,
                shard=NULL_SHARDER, *, trace=None):
    """One decode step. batch: tokens (B, 1). Returns (logits (B, V), Cache);
    the cache's tensors are updated in place and shared by the result."""
    with _replicated_constants(shard):
        _check_supported(cfg)
        _check_serving(cfg, shard)
        x, positions = _embed(params, batch, cfg, shard)
        if not cfg.mrope and batch.get("positions") is None:
            positions = cache.length[:, None]
        if cfg.family == "hybrid_moe":
            x = _hybrid_moe_layers(x, params, cfg, "decode", cache, trace)
        else:
            x = _run_layers(x, params, cfg, shard, positions, "decode",
                            cache)
        logits = _unembed(x, params, cfg, shard)
        return logits[:, 0], dataclasses.replace(cache,
                                                 length=cache.length + 1)


