"""Decoder-only LM: serving (prefill + decode) and training of the dense,
MoE, SSM and hybrid families.

The port of ``repro.models.lm``: the schema of every decoder-only family,
``prefill``/``decode_step`` and ``forward_train`` for ``"dense"``,
``"moe"`` (the dense block with ``layers.moe_block`` as its FFN, whose
load-balance loss is summed over the layers), ``"ssm"`` (Mamba-2) and
``"hybrid"`` (Mamba-2 with a shared attention block every
``attn_period`` layers, zamba2). The reference's ``jax.lax.scan`` over
the leading "layers" axis becomes a Python loop over it, so
``scan_layers`` changes nothing. In training, ``remat_policy="full"``
wraps each layer body in ``torch.utils.checkpoint`` (the reference's
``nothing_saveable``), and ``"none"`` runs it plain. VLM comes with its
slice.

Public surface:
  schema(cfg)                            -> ParamSpec tree
  forward_train(params, batch, cfg)      -> (loss, metrics)
  prefill(params, batch, cfg)            -> (last_logits (B, V), Cache)
  decode_step(params, batch, cache, cfg) -> (logits (B, V), Cache)

Kernels: ``attention_impl="pallas"`` sends attention in prefill and
training through K4 (``kernels.ops.flash_attention``), the hybrid's shared
block included, and ``ssd_impl="pallas"`` sends the SSD scan in training
through K5 (``kernels.ops.ssd_scan``), as the reference reaches its Pallas
kernels. Serving scans with the plain ``layers.ssd_chunked`` (prefill,
which returns the final state K5 does not) and ``layers.ssd_decode_step``
(decode), as the reference does.

Semantics kept from the reference, faults included:
  * the decode cache is as long as the prompt (Smax = S of the prefill),
    the hybrid's shared-attention cache too; each decode step writes at
    ``min(length, Smax - 1)`` (the clamp of ``dynamic_update_slice``), so
    once the cache is full every new token overwrites the last slot, while
    ``length`` keeps growing;
  * positions are ``arange(S)`` in prefill, whatever the padding, and
    ``cache.length`` in decode.
One difference of form: ``decode_step`` writes the new token's k/v and
the new SSM states into the cache tensors in place (the reference returns
new arrays); the returned ``Cache`` shares them, so a caller that needs
the old cache clones it first.
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
           "decode_step", "MOE_AUX_WEIGHT"]

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
    else:
        raise ValueError(cfg.family)
    return s


# ================================================================ caches ====
@dataclasses.dataclass
class Cache:
    """Decode-time state: attention caches (L, B, Smax, Hkv_eff, hd) of the
    dense and MoE families; SSM states (L, B, H, P, N) float32 of the ssm
    and hybrid families; the hybrid's shared-attention caches (napps, B,
    Smax, Hkv, hd), one per application; and the (B,) count of tokens
    seen."""
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    shared_k: Optional[torch.Tensor] = None
    shared_v: Optional[torch.Tensor] = None
    length: Optional[torch.Tensor] = None


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """The decode cache as ``meta`` tensors (shapes and types, no memory);
    ``prefill`` allocates it with ``max_len`` = the prompt's length."""
    _check_supported(cfg)
    dt = _dtype(cfg.compute_dtype)
    meta = lambda shp, t=dt: torch.empty(shp, dtype=t, device="meta")
    hd = cfg.resolved_head_dim
    c = Cache(length=meta((batch,), torch.int32))
    if cfg.family in ("dense", "moe"):
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


def _check_supported(cfg: ModelConfig) -> None:
    families = ("dense", "moe", "ssm", "hybrid")
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves and trains "
            f"{', '.join(families)} so far; the other families come with "
            "later slices")
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
    """Returns (out, aux loss): the MoE block's load-balance loss, None for
    the other families (the reference's 0)."""
    if cfg.family == "moe":
        return L.moe_block(x, p, cfg)
    if cfg.mlp_style == "mlp2":
        h = torch.einsum("bsd,df->bsf", x, p["wi_up"])
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return torch.einsum("bsf,fd->bsd", h, p["wo"]), None
    return L.swiglu_mlp(x, p["wi_gate"], p["wi_up"], p["wo"]), None


def _transformer_block(x, p, cfg, positions, mode, kv_cache=None,
                       cache_len=None):
    """Returns (out, new_kv, aux loss or None)."""
    h, new_kv = _attention(L.rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg,
                           positions, mode, kv_cache, cache_len)
    x = x + h
    h, aux = _ffn(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)
    return x + h, new_kv, aux


def _ssd_block(x, p, cfg: ModelConfig, mode: str = "train",
               ssm_state=None):
    """Mamba-2 block. Returns (out, new_state): the final (B, H, P, N)
    float32 state in prefill, the updated state in decode (S == 1, from
    ``ssm_state``), None in train."""
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
    new_state = None
    if mode == "decode":
        y, new_state = L.ssd_decode_step(ssm_state, xh[:, 0], dt[:, 0], A,
                                         Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    elif cfg.ssd_impl == "pallas" and mode == "train":
        y = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)       # kernel K5
    else:
        y, h_final = L.ssd_chunked(xh, dt, A, Bm, Cm, chunk)
        if mode == "prefill":
            new_state = h_final
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rms_norm(y, p["norm_w"], cfg.norm_eps)
    return x + torch.einsum("bse,ed->bsd", y, p["out"]), new_state


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


def _cached_block(x, p, cfg: ModelConfig, positions, mode: str, kc, vc,
                  slot: int, cache_len):
    """A transformer block in serving whose kv cache is ``kc[slot]``,
    ``vc[slot]``: prefill writes it, decode updates it in place."""
    if mode == "prefill":
        x, (kc[slot], vc[slot]), _ = _transformer_block(x, p, cfg, positions,
                                                        mode)
        return x
    return _transformer_block(x, p, cfg, positions, mode,
                              (kc[slot], vc[slot]), cache_len)[0]


def _run_layers(x, params, cfg: ModelConfig, positions, mode: str,
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
        if cfg.family in ("dense", "moe"):
            x = _cached_block(x, bp, cfg, positions, mode, cache.k, cache.v,
                              i, cache.length)
            continue
        x, cache.ssm[i] = _ssd_block(
            x, bp, cfg, mode, cache.ssm[i] if mode == "decode" else None)
        if cfg.family == "hybrid" and i % period == period - 1:
            x = _cached_block(x, params["shared_attn"], cfg, positions, mode,
                              cache.shared_k, cache.shared_v, i // period,
                              cache.length)
    return x


def _train_layers(x, params, cfg: ModelConfig, positions):
    """The layer stack in train mode, in order: dense or MoE transformer
    blocks; Mamba-2 blocks; or Mamba-2 blocks with the one ``shared_attn``
    block applied after layer ``idx`` whenever ``idx % attn_period ==
    attn_period - 1`` (the hybrid). Returns (x, the MoE aux losses summed
    over the layers, or None for the other families)."""
    layers = _unbind_layers(params["blocks"], cfg.num_layers)
    if cfg.family in ("dense", "moe"):
        def body(xc, i):
            xc, _, aux = _transformer_block(xc, layers[i], cfg, positions,
                                            "train")
            return xc, aux
    elif cfg.family == "ssm":
        def body(xc, i):
            return _ssd_block(xc, layers[i], cfg)[0], None
    else:                                           # hybrid
        period = cfg.attn_period

        def body(xc, i):
            xc = _ssd_block(xc, layers[i], cfg)[0]
            if i % period == period - 1:
                xc = _transformer_block(xc, params["shared_attn"], cfg,
                                        positions, "train")[0]
            return xc, None
    body = _remat(body, cfg)
    aux_total = None
    for i in range(cfg.num_layers):
        x, aux = body(x, i)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


# ================================================================= entry ====
def forward_train(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy in float32. batch: tokens (B, S) int,
    labels (B, S) int (-1 = masked). Returns (total, {"loss", "aux_loss"})
    with total = loss + MOE_AUX_WEIGHT * aux_loss, aux_loss the MoE
    layers' load-balance losses summed (0 for the other families)."""
    _check_supported(cfg)
    x, positions = _embed(params, batch, cfg)
    x, aux = _train_layers(x, params, cfg, positions)
    logits = _unembed(x, params, cfg).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - picked) * mask
    loss = nll.sum() / mask.sum().clamp(min=1.0)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + MOE_AUX_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Process a full prompt; returns (last_token_logits, Cache)."""
    B, S = batch["tokens"].shape
    spec = cache_specs(cfg, B, S)
    x, positions = _embed(params, batch, cfg)
    cache = Cache(**{f.name: torch.empty(t.shape, dtype=t.dtype,
                                         device=x.device)
                     for f in dataclasses.fields(Cache)
                     if (t := getattr(spec, f.name)) is not None})
    cache.length.fill_(S)
    x = _run_layers(x, params, cfg, positions, "prefill", cache)
    logits = _unembed(x[:, -1:], params, cfg)
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, batch, cache: Cache, cfg: ModelConfig):
    """One decode step. batch: tokens (B, 1). Returns (logits (B, V), Cache);
    the cache's tensors are updated in place and shared by the result."""
    _check_supported(cfg)
    x, positions = _embed(params, batch, cfg)
    if batch.get("positions") is None:
        positions = cache.length[:, None]
    x = _run_layers(x, params, cfg, positions, "decode", cache)
    logits = _unembed(x, params, cfg)
    return logits[:, 0], dataclasses.replace(cache, length=cache.length + 1)
