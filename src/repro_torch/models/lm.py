"""Decoder-only LM: the dense serving half (prefill + decode).

The port of ``repro.models.lm`` for ``family == "dense"``: the schema of
every decoder-only family, and ``prefill``/``decode_step`` over stacked
layer weights. The reference's ``jax.lax.scan`` over the leading "layers"
axis becomes a Python loop over it; ``scan_layers`` and ``remat_policy``
change nothing in inference and are not read. ``forward_train`` comes with
the training slice; MoE, SSM, hybrid and VLM families with theirs.

Public surface:
  schema(cfg)                            -> ParamSpec tree
  prefill(params, batch, cfg)            -> (last_logits (B, V), Cache)
  decode_step(params, batch, cache, cfg) -> (logits (B, V), Cache)

Semantics kept from the reference, faults included:
  * the decode cache is as long as the prompt (Smax = S of the prefill);
    each decode step writes at ``min(length, Smax - 1)`` (the clamp of
    ``dynamic_update_slice``), so once the cache is full every new token
    overwrites the last slot, while ``length`` keeps growing;
  * positions are ``arange(S)`` in prefill, whatever the padding, and
    ``cache.length`` in decode.
One difference of form: ``decode_step`` writes the new token's k/v into
the cache tensors in place (the reference returns new arrays); the
returned ``Cache`` shares them, so a caller that needs the old cache
clones it first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

__all__ = ["schema", "Cache", "cache_specs", "prefill", "decode_step"]

Params = Dict[str, Any]


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
    else:
        raise ValueError(cfg.family)
    return s


# ================================================================ caches ====
@dataclasses.dataclass
class Cache:
    """Decode-time state of the dense family: attention caches
    (L, B, Smax, Hkv_eff, hd) and the (B,) count of tokens seen. The SSM
    and hybrid states come with their slices."""
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    length: Optional[torch.Tensor] = None


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """The decode cache as ``meta`` tensors (shapes and types, no memory)."""
    _check_supported(cfg)
    shp = (cfg.num_layers, batch, max_len, cfg.effective_kv_heads,
           cfg.resolved_head_dim)
    dt = _dtype(cfg.compute_dtype)
    return Cache(k=torch.empty(shp, dtype=dt, device="meta"),
                 v=torch.empty(shp, dtype=dt, device="meta"),
                 length=torch.empty((batch,), dtype=torch.int32,
                                    device="meta"))


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family; "
            "moe, ssm, hybrid, vlm and encdec come with later slices")
    if cfg.param_dtype != cfg.compute_dtype:
        raise NotImplementedError(
            f"param_dtype {cfg.param_dtype} != compute_dtype "
            f"{cfg.compute_dtype}: no config of the repo mixes them")


# ============================================================== forward =====
def _attention(x, p, cfg: ModelConfig, positions, mode: str,
               kv_cache=None, cache_len=None):
    """Self-attention for one block. Returns (out, (k, v)): the new k/v for
    prefill; for decode the layer's caches, written in place."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dq->bsq", x, p["wq"])
    k = torch.einsum("bsd,dq->bsq", x, p["wk"])
    v = torch.einsum("bsd,dq->bsq", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(B, S, cfg.num_heads, hd), positions,
                     cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, cfg.num_kv_heads, hd), positions,
                     cfg.rope_theta)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)

    if cfg.kv_head_replication > 1:
        # duplicate kv heads (identical math: each q group maps to a copy)
        r = cfg.kv_head_replication
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)

    if mode == "prefill":
        if cfg.attention_impl == "pallas":
            out = ops.flash_attention(q, k, v, causal=True)     # kernel K4
        elif cfg.attention_impl == "tri":
            raise NotImplementedError(
                'attention_impl "tri" (causal_attention_tri) comes with the '
                "training slice")
        else:
            out = L.causal_attention_ref(q, k, v)
        new_kv = (k, v)
    else:  # decode: S == 1
        kc, vc = kv_cache
        # dynamic_update_slice clamps the start into [0, Smax - 1]
        slot = cache_len.long().clamp(0, kc.shape[1] - 1)
        rows = torch.arange(B, device=x.device)
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
        out = L.decode_attention(q, kc, vc, cache_len + 1)
        new_kv = (kc, vc)
    out = out.reshape(B, S, cfg.num_heads * hd)
    return torch.einsum("bsq,qd->bsd", out, p["wo"]), new_kv


def _ffn(x, p, cfg: ModelConfig):
    if cfg.mlp_style == "mlp2":
        h = torch.einsum("bsd,df->bsf", x, p["wi_up"])
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return torch.einsum("bsf,fd->bsd", h, p["wo"])
    return L.swiglu_mlp(x, p["wi_gate"], p["wi_up"], p["wo"])


def _transformer_block(x, p, cfg, positions, mode, kv_cache=None,
                       cache_len=None):
    h, new_kv = _attention(L.rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg,
                           positions, mode, kv_cache, cache_len)
    x = x + h
    x = x + _ffn(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)
    return x, new_kv


def _embed(params, batch, cfg: ModelConfig):
    """Token embedding. Returns (x, positions)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(_dtype(cfg.compute_dtype))
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    return x, positions


def _unembed(x, params, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head)


def _layer(blocks, i: int):
    """Layer i's slice of the stacked block weights (views, no copies)."""
    if isinstance(blocks, torch.Tensor):
        return blocks[i]
    return {k: _layer(v, i) for k, v in blocks.items()}


def _run_layers(x, params, cfg: ModelConfig, positions, mode: str,
                cache: Cache):
    """The layer stack of the dense family, in order. Prefill writes each
    layer's k/v into ``cache``; decode updates ``cache`` in place."""
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        bp = _layer(blocks, i)
        if mode == "prefill":
            x, (k, v) = _transformer_block(x, bp, cfg, positions, mode)
            cache.k[i] = k
            cache.v[i] = v
        else:
            x, _ = _transformer_block(x, bp, cfg, positions, mode,
                                      (cache.k[i], cache.v[i]), cache.length)
    return x


# ================================================================= entry ====
@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Process a full prompt; returns (last_token_logits, Cache)."""
    _check_supported(cfg)
    x, positions = _embed(params, batch, cfg)
    B, S = batch["tokens"].shape
    shp = (cfg.num_layers, B, S, cfg.effective_kv_heads,
           cfg.resolved_head_dim)
    cache = Cache(k=torch.empty(shp, dtype=x.dtype, device=x.device),
                  v=torch.empty(shp, dtype=x.dtype, device=x.device),
                  length=torch.full((B,), S, dtype=torch.int32,
                                    device=x.device))
    x = _run_layers(x, params, cfg, positions, "prefill", cache)
    logits = _unembed(x[:, -1:], params, cfg)
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, batch, cache: Cache, cfg: ModelConfig):
    """One decode step. batch: tokens (B, 1). Returns (logits (B, V), Cache);
    ``cache.k``/``cache.v`` are updated in place and shared by the result."""
    _check_supported(cfg)
    x, positions = _embed(params, batch, cfg)
    if batch.get("positions") is None:
        positions = cache.length[:, None]
    x = _run_layers(x, params, cfg, positions, "decode", cache)
    logits = _unembed(x, params, cfg)
    return logits[:, 0], Cache(k=cache.k, v=cache.v, length=cache.length + 1)
