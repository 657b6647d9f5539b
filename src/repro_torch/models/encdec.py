"""Whisper-style encoder-decoder backbone (the ``"encdec"`` family).

The port of ``repro.models.encdec``. The conv audio frontend is a stub, as
in the reference: the batch brings precomputed frame embeddings (B, S_enc,
d_model). The decoder is at most ``DEC_LEN`` (whisper's 448 target
positions) long.

Caches reuse ``lm.Cache``: ``k``/``v`` hold the decoder's self-attention
cache (L, B, DEC_LEN, Hkv, hd), ``shared_k``/``shared_v`` the
cross-attention k/v of the encoder's output, one per decoder layer (L, B,
S_enc, Hkv, hd). Every attention of this family is the plain one, as in
the reference: bidirectional in the encoder and across, causal
(``layers.causal_attention_ref``) over the decoder's tokens in training,
and against the cache in decode. No kernel is on this path.

Semantics kept from the reference: a decode step writes its k/v at
``min(length, DEC_LEN - 1)`` and adds the position embedding of that row,
so past ``DEC_LEN`` tokens every step overwrites the last slot while
``length`` keeps growing. Differences of form: ``decode_step`` writes the
new token's k/v into the cache tensors in place and returns a ``Cache``
that shares them (as ``lm.decode_step`` does); a decode step takes one
token a sequence, (B, 1), the only shape the reference's callers give it,
and raises for more; the encoder's layers and the decoder's run under
``lm._remat`` in training only (prefill and decode take no gradient).

Public surface:
  schema(cfg)                            -> ParamSpec tree
  forward_train(params, batch, cfg)      -> (loss, metrics)
  prefill(params, batch, cfg)            -> (logits (B, V), Cache)
  decode_step(params, batch, cache, cfg) -> (logits (B, V), Cache)
  cache_specs(cfg, batch, enc_len)       -> Cache of meta tensors
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import (Cache, _attend, _dtype, _remat,
                                   _replicated_constants, _token_nll,
                                   _unbind_layers)
from repro_torch.models.params import NULL_SHARDER, ParamSpec

__all__ = ["DEC_LEN", "schema", "forward_train", "prefill", "decode_step",
           "cache_specs", "cache_axes"]

DEC_LEN = 448

Params = Dict[str, Any]


def _attn_schema(cfg: ModelConfig, lead) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    la = ("layers",) * len(lead)
    return {
        "wq": ParamSpec(lead + (d, cfg.num_heads * hd), la + ("embed_param", "qkv")),
        "wk": ParamSpec(lead + (d, cfg.num_kv_heads * hd), la + ("embed_param", "kv_heads")),
        "wv": ParamSpec(lead + (d, cfg.num_kv_heads * hd), la + ("embed_param", "kv_heads")),
        "wo": ParamSpec(lead + (cfg.num_heads * hd, d), la + ("qkv", "embed_param")),
        "bq": ParamSpec(lead + (cfg.num_heads * hd,), la + ("qkv",), init="zeros"),
        "bv": ParamSpec(lead + (cfg.num_kv_heads * hd,), la + ("kv_heads",), init="zeros"),
    }


def _ln_schema(cfg, lead, name) -> Params:
    la = ("layers",) * len(lead)
    return {
        f"{name}_w": ParamSpec(lead + (cfg.d_model,), la + ("embed",), init="ones"),
        f"{name}_b": ParamSpec(lead + (cfg.d_model,), la + ("embed",), init="zeros"),
    }


def _mlp_schema(cfg, lead) -> Params:
    la = ("layers",) * len(lead)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec(lead + (d, f), la + ("embed_param", "mlp")),
        "bi": ParamSpec(lead + (f,), la + ("mlp",), init="zeros"),
        "wo": ParamSpec(lead + (f, d), la + ("mlp", "embed_param")),
        "bo": ParamSpec(lead + (d,), la + ("embed",), init="zeros"),
    }


def schema(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    enc_lead, dec_lead = (cfg.encoder_layers,), (cfg.num_layers,)
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed_param")),
        "pos_embed": ParamSpec((DEC_LEN, d), (None, "embed_param")),
        "enc_blocks": {
            **_ln_schema(cfg, enc_lead, "ln1"),
            **_ln_schema(cfg, enc_lead, "ln2"),
            "attn": _attn_schema(cfg, enc_lead),
            "mlp": _mlp_schema(cfg, enc_lead),
        },
        "enc_final": {**_ln_schema(cfg, (), "ln")},
        "dec_blocks": {
            **_ln_schema(cfg, dec_lead, "ln1"),
            **_ln_schema(cfg, dec_lead, "ln2"),
            **_ln_schema(cfg, dec_lead, "ln3"),
            "self_attn": _attn_schema(cfg, dec_lead),
            "cross_attn": _attn_schema(cfg, dec_lead),
            "mlp": _mlp_schema(cfg, dec_lead),
        },
        "dec_final": {**_ln_schema(cfg, (), "ln")},
    }


def _sinusoid(S: int, d: int, device) -> torch.Tensor:
    """(S, d) float32: sin then cos of positions times d/2 geometric
    frequencies from 1 to 1/10,000. The reference's float32 arithmetic,
    but exp, sin and cos are taken in float64 and rounded to float32, so
    that the card and the host give the same table: at position 1,499 a
    one-ulp change of a float32 frequency moves its sine by up to 1.8e-4,
    and the card's float32 table read 1.2e-4 away from the host's (an
    H100, ``chip_smoke.py``'s whisper check). The reference's own float32
    table lies as far from this one; at the CPU tests' 64 frames, within
    1e-5."""
    half = d // 2
    arg = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / (half - 1)
    freqs = torch.exp(arg.double()).float()
    t = (torch.arange(S, dtype=torch.float32, device=device)[:, None]
         * freqs).double()
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1).float()


def _heads(t: torch.Tensor, n: int, cfg: ModelConfig, shard,
           axis: str = "heads") -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd); on a mesh the heads shard where
    they divide the model axis (whisper's 12 do not on 16 ranks)."""
    return shard.view(t, (*t.shape[:2], n, cfg.resolved_head_dim), "batch",
                      None, axis, None)


def _qkv(x, p, cfg: ModelConfig, shard):
    """q, k, v of self-attention: k has no bias (whisper's)."""
    q = _heads(L.dense(x, p["wq"]) + p["bq"], cfg.num_heads, cfg, shard)
    k = _heads(L.dense(x, p["wk"]), cfg.num_kv_heads, cfg, shard, "kv_heads")
    v = _heads(L.dense(x, p["wv"]) + p["bv"], cfg.num_kv_heads, cfg, shard,
               "kv_heads")
    return q, k, v


def _lookup(table, idx, shard, axis):
    """Rows ``idx`` (batch-sharded) of ``table``, whose first axis is
    ``axis``; on a mesh its FSDP dim gathered first."""
    if isinstance(idx, DTensor):
        return F.embedding(shard(idx, "batch", *(None,) * (idx.ndim - 1)),
                           shard(table, axis, None))
    return table[idx]


def _proj_out(out, p):
    return L.dense(out.reshape(*out.shape[:2], -1), p["wo"])


def _ln(x, p, name, cfg):
    return L.layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.norm_eps)


def _encoder(params, frames, cfg: ModelConfig, train: bool,
             shard=NULL_SHARDER):
    x = frames.to(_dtype(cfg.compute_dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x = shard(x, "batch", "seq_sp", "embed")
    layers = _unbind_layers(params["enc_blocks"], cfg.encoder_layers)

    def body(xc, i):
        bp = layers[i]
        q, k, v = _qkv(_ln(xc, bp, "ln1", cfg), bp["attn"], cfg, shard)
        xc = xc + _proj_out(_attend(L.bidirectional_attention, q, k, v,
                                    shard), bp["attn"])
        m = bp["mlp"]
        xc = xc + L.gelu_mlp(_ln(xc, bp, "ln2", cfg), m["wi"], m["bi"],
                             m["wo"], m["bo"])
        return shard(xc, "batch", "seq_sp", "embed")

    if train:
        body = _remat(body, cfg)
    for i in range(cfg.encoder_layers):
        x = body(x, i)
    return _ln(x, params["enc_final"], "ln", cfg)


def _cross_kv(params, enc_out, cfg: ModelConfig, shard):
    """Every decoder layer's cross-attention k, v of the encoder's output,
    stacked: two (L, B, S_enc, Hkv, hd) tensors."""
    ks, vs = [], []
    for bp in _unbind_layers(params["dec_blocks"], cfg.num_layers):
        p = bp["cross_attn"]
        ks.append(_heads(L.dense(enc_out, p["wk"]), cfg.num_kv_heads, cfg,
                         shard, "kv_heads"))
        vs.append(_heads(L.dense(enc_out, p["wv"]) + p["bv"],
                         cfg.num_kv_heads, cfg, shard, "kv_heads"))
    return torch.stack(ks), torch.stack(vs)


def _self_decode(q, k, v, kc, vc, length):
    """Write the token's k/v at ``min(length, Smax - 1)`` (the reference's
    clamping ``dynamic_update_slice``), in place, and attend over the
    cache up to that row."""
    slot = length.long().clamp(0, kc.shape[1] - 1)
    rows = torch.arange(q.shape[0], device=q.device)
    kc[rows, slot] = k[:, 0]
    vc[rows, slot] = v[:, 0]
    return L.decode_attention(q, kc, vc, slot + 1)


def _decoder(params, tokens, cfg: ModelConfig, mode: str, cross_kv,
             cache: Cache = None, shard=NULL_SHARDER):
    """The decoder over ``tokens`` (B, S): ``"train"`` (causal over the
    tokens) or ``"decode"`` (S == 1 against ``cache``, whose self-attention
    k/v it writes in place). Returns the logits (B, S, V)."""
    B, S = tokens.shape
    x = _lookup(params["embed"], tokens.long(), shard, "vocab").to(_dtype(cfg.compute_dtype))
    if mode == "decode":
        if S != 1:
            raise ValueError(f"a decode step takes one token a sequence; "
                             f"got {S}")
        pos = cache.length.long().clamp(max=DEC_LEN - 1)
        x = x + _lookup(params["pos_embed"], pos, shard, None)[:, None].to(x.dtype)
    else:
        x = x + params["pos_embed"][:S].to(x.dtype)
    x = shard(x, "batch", None, "embed")
    layers = _unbind_layers(params["dec_blocks"], cfg.num_layers)
    ck_all, cv_all = cross_kv

    def body(xc, i):
        bp = layers[i]
        q, k, v = _qkv(_ln(xc, bp, "ln1", cfg), bp["self_attn"], cfg, shard)
        if mode == "decode":
            kc, vc = cache.k[i], cache.v[i]
            if shard.mesh is None:
                att = _self_decode(q, k, v, kc, vc, cache.length)
            else:       # as lm's decode: the cache's own placements
                cpl = kc.placements
                bpl = tuple(p if isinstance(p, Shard) and p.dim == 0
                            else Replicate() for p in cpl)
                att = shard.local(_self_decode,
                                  (q, k, v, kc, vc, cache.length),
                                  (cpl,) * 5 + (bpl,), cpl)
        else:
            att = _attend(lambda q, k, v: L.causal_attention_ref(
                q, k, v, chunk_q=min(512, S)), q, k, v, shard)
        xc = xc + _proj_out(att, bp["self_attn"])
        p = bp["cross_attn"]
        qx = _heads(L.dense(_ln(xc, bp, "ln2", cfg), p["wq"]) + p["bq"],
                    cfg.num_heads, cfg, shard)
        xc = xc + _proj_out(_attend(L.bidirectional_attention, qx, ck_all[i],
                                    cv_all[i], shard), p)
        m = bp["mlp"]
        xc = xc + L.gelu_mlp(_ln(xc, bp, "ln3", cfg), m["wi"], m["bi"],
                             m["wo"], m["bo"])
        return shard(xc, "batch", None, "embed")

    if mode == "train":
        body = _remat(body, cfg)
    for i in range(cfg.num_layers):
        x = body(x, i)
    x = _ln(x, params["dec_final"], "ln", cfg)
    if isinstance(x, DTensor):
        return shard(L.dense(x, params["embed"].T), "batch", None,
                     "vocab")
    return torch.einsum("bsd,dv->bsv", x, params["embed"].T)


def forward_train(params, batch, cfg: ModelConfig, shard=NULL_SHARDER):
    """Cross-entropy of the decoder in float32. batch: frames (B, S_enc,
    D), tokens (B, DEC) int, labels (B, DEC) int (-1 = masked). Returns
    (loss, {"loss", "aux_loss": 0})."""
    with _replicated_constants(shard):
        enc_out = _encoder(params, batch["frames"], cfg, True, shard)
        logits = _decoder(params, batch["tokens"], cfg, "train",
                          _cross_kv(params, enc_out, cfg, shard),
                          shard=shard).float()
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        nll = L.grad_placed_as(_token_nll(logits, labels, shard)) * mask
        loss = nll.sum() / mask.sum().clamp(min=1.0)
        return loss, {"loss": loss,
                      "aux_loss": torch.zeros((), dtype=torch.float32,
                                              device=loss.device)}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, shard=NULL_SHARDER):
    """Encode the frames, precompute the cross-attention k/v, then decode
    the BOS prompt (B, 1). Returns (logits (B, V), Cache)."""
    with _replicated_constants(shard):
        enc_out = _encoder(params, batch["frames"], cfg, False, shard)
        shared_k, shared_v = _cross_kv(params, enc_out, cfg, shard)
        B = batch["tokens"].shape[0]
        spec = cache_specs(cfg, B, enc_out.shape[1])
        axes = cache_axes()
        if shard.mesh is None:
            zeros = lambda t, ax: torch.zeros(t.shape, dtype=t.dtype,
                                              device=enc_out.device)
        else:
            zeros = lambda t, ax: dtensor_zeros(
                t.shape, dtype=t.dtype, device_mesh=shard.mesh,
                placements=shard.placements(t.shape, *ax))
        cache = Cache(k=zeros(spec.k, axes.k), v=zeros(spec.v, axes.v),
                      shared_k=shared_k, shared_v=shared_v,
                      length=zeros(spec.length, axes.length))
        return decode_step(params, batch, cache, cfg, shard)


@torch.no_grad()
def decode_step(params, batch, cache: Cache, cfg: ModelConfig,
                shard=NULL_SHARDER):
    """One decode step. batch: tokens (B, 1). Returns (logits (B, V),
    Cache); the cache's tensors are updated in place and shared by the
    result."""
    with _replicated_constants(shard):
        logits = _decoder(params, batch["tokens"], cfg, "decode",
                          (cache.shared_k, cache.shared_v), cache, shard)
        return logits[:, 0], Cache(k=cache.k, v=cache.v,
                                   shared_k=cache.shared_k,
                                   shared_v=cache.shared_v,
                                   length=cache.length + 1)


def cache_axes() -> Cache:
    """Logical axes matching ``cache_specs`` (for shardings)."""
    attn = ("layers", "batch", "cache_seq", "kv_heads", None)
    return Cache(k=attn, v=attn, shared_k=attn, shared_v=attn,
                 length=("batch",))


def cache_specs(cfg: ModelConfig, batch: int, enc_len: int) -> Cache:
    """The decode cache as ``meta`` tensors (shapes and types, no memory)."""
    dt = _dtype(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    meta = lambda *shp: torch.empty(shp, dtype=dt, device="meta")
    self_kv = (cfg.num_layers, batch, DEC_LEN, cfg.num_kv_heads, hd)
    cross_kv = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, hd)
    return Cache(k=meta(*self_kv), v=meta(*self_kv), shared_k=meta(*cross_kv),
                 shared_v=meta(*cross_kv),
                 length=torch.empty((batch,), dtype=torch.int32,
                                    device="meta"))
