"""Decoder-only LM: dense serving (prefill + decode) and training of the
dense, SSM and hybrid families.

The port of ``repro.models.lm``: the schema of every decoder-only family,
``prefill``/``decode_step`` for ``family == "dense"``, and
``forward_train`` for ``"dense"``, ``"ssm"`` (Mamba-2) and ``"hybrid"``
(Mamba-2 with a shared attention block every ``attn_period`` layers,
zamba2). The reference's ``jax.lax.scan`` over the leading "layers" axis
becomes a Python loop over it, so ``scan_layers`` changes nothing. In
training, ``remat_policy="full"`` wraps each layer body in
``torch.utils.checkpoint`` (the reference's ``nothing_saveable``), and
``"none"`` runs it plain. MoE and VLM come with their slices.

Public surface:
  schema(cfg)                            -> ParamSpec tree
  forward_train(params, batch, cfg)      -> (loss, metrics)
  prefill(params, batch, cfg)            -> (last_logits (B, V), Cache)
  decode_step(params, batch, cache, cfg) -> (logits (B, V), Cache)

Kernels: ``attention_impl="pallas"`` sends attention in prefill and
training through K4 (``kernels.ops.flash_attention``), and
``ssd_impl="pallas"`` sends the SSD scan in training through K5
(``kernels.ops.ssd_scan``), as the reference reaches its Pallas kernels.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

__all__ = ["schema", "Cache", "cache_specs", "forward_train", "prefill",
           "decode_step"]

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


def _check_supported(cfg: ModelConfig, train: bool = False) -> None:
    families = ("dense", "ssm", "hybrid") if train else ("dense",)
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} in {'training' if train else 'serving'}"
            f": the port runs {', '.join(families)} there so far; the other "
            "families come with later slices")
    if cfg.param_dtype != cfg.compute_dtype:
        raise NotImplementedError(
            f"param_dtype {cfg.param_dtype} != compute_dtype "
            f"{cfg.compute_dtype}: no config of the repo mixes them")


# ============================================================== forward =====
def _attention(x, p, cfg: ModelConfig, positions, mode: str,
               kv_cache=None, cache_len=None):
    """Self-attention for one block. Returns (out, new_kv): the new (k, v)
    for prefill; for decode the layer's caches, written in place; None for
    train."""
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

    if cfg.kv_head_replication > 1 and mode in ("prefill", "decode"):
        # duplicate kv heads (identical math: each q group maps to a copy)
        r = cfg.kv_head_replication
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)

    if mode in ("train", "prefill"):
        if cfg.attention_impl == "pallas":
            out = ops.flash_attention(q, k, v, causal=True)     # kernel K4
        elif cfg.attention_impl == "tri":
            raise NotImplementedError(
                'attention_impl "tri" (causal_attention_tri) comes with the '
                'multi-card LM slice; use "xla" or "pallas"')
        else:
            out = L.causal_attention_ref(q, k, v)
        new_kv = (k, v) if mode == "prefill" else None
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


def _ssd_block(x, p, cfg: ModelConfig):
    """Mamba-2 block in train mode (the reference's ``_ssd_block``; its
    prefill and decode modes come with SSM serving)."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    nh = di // cfg.ssm_head_dim
    xin = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    z = torch.einsum("bsd,de->bse", xin, p["wz"])
    xv = torch.einsum("bsd,de->bse", xin, p["wx"])
    Bm = torch.einsum("bsd,dn->bsn", xin, p["wB"])
    Cm = torch.einsum("bsd,dn->bsn", xin, p["wC"])
    u = torch.einsum("bsd,dh->bsh", xin, p["wdt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(u, torch.zeros_like(u))       # jax.nn.softplus
    A = -torch.exp(p["A_log"].float())
    xh = xv.reshape(B, S, nh, cfg.ssm_head_dim)
    chunk = min(cfg.ssm_chunk, S)
    if cfg.ssd_impl == "pallas":
        y = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)       # kernel K5
    else:
        y, _ = L.ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rms_norm(y, p["norm_w"], cfg.norm_eps)
    return x + torch.einsum("bse,ed->bsd", y, p["out"])


def _remat(fn, cfg: ModelConfig):
    """``"full"``: recompute the layer body in backward, saving only its
    input (``jax.checkpoint`` with ``nothing_saveable``); ``"none"``: run
    it plain."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            'remat_policy "dots" (save the matmul outputs) comes with the '
            'multi-card LM slice; use "full" or "none"')
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


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


def _run_layers(x, params, cfg: ModelConfig, positions, mode: str,
                cache: Cache):
    """The layer stack of the dense family, in order. Prefill writes each
    layer's k/v into ``cache``; decode updates ``cache`` in place."""
    for i, bp in enumerate(_unbind_layers(params["blocks"], cfg.num_layers)):
        if mode == "prefill":
            x, (k, v) = _transformer_block(x, bp, cfg, positions, mode)
            cache.k[i] = k
            cache.v[i] = v
        else:
            x, _ = _transformer_block(x, bp, cfg, positions, mode,
                                      (cache.k[i], cache.v[i]), cache.length)
    return x


def _train_layers(x, params, cfg: ModelConfig, positions):
    """The layer stack in train mode, in order: dense transformer blocks;
    Mamba-2 blocks; or Mamba-2 blocks with the one ``shared_attn`` block
    applied after layer ``idx`` whenever ``idx % attn_period ==
    attn_period - 1`` (the hybrid)."""
    layers = _unbind_layers(params["blocks"], cfg.num_layers)
    if cfg.family == "dense":
        def body(xc, i):
            return _transformer_block(xc, layers[i], cfg, positions,
                                      "train")[0]
    elif cfg.family == "ssm":
        def body(xc, i):
            return _ssd_block(xc, layers[i], cfg)
    else:                                           # hybrid
        period = cfg.attn_period

        def body(xc, i):
            xc = _ssd_block(xc, layers[i], cfg)
            if i % period == period - 1:
                xc = _transformer_block(xc, params["shared_attn"], cfg,
                                        positions, "train")[0]
            return xc
    body = _remat(body, cfg)
    for i in range(cfg.num_layers):
        x = body(x, i)
    return x


# ================================================================= entry ====
def forward_train(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy in float32. batch: tokens (B, S) int,
    labels (B, S) int (-1 = masked). Returns (total, {"loss", "aux_loss"});
    the families ported so far have no auxiliary loss (MoE's router loss
    comes with MoE), so total is the loss and aux_loss 0."""
    _check_supported(cfg, train=True)
    x, positions = _embed(params, batch, cfg)
    x = _train_layers(x, params, cfg, positions)
    logits = _unembed(x, params, cfg).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - picked) * mask
    loss = nll.sum() / mask.sum().clamp(min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"loss": loss, "aux_loss": aux}


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
