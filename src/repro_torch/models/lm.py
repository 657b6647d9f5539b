"""Decoder-only LM: serving (prefill + decode) and training of the dense,
VLM, MoE, SSM and hybrid families.

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
reaches its Pallas kernels. Serving scans with the plain ``layers.ssd_chunked`` (prefill,
which returns the final state K5 does not) and ``layers.ssd_decode_step``
(decode), as the reference does.

Semantics kept from the reference, faults included:
  * the decode cache is as long as the prompt (Smax = S of the prefill),
    the hybrid's shared-attention cache too; each decode step writes at
    ``min(length, Smax - 1)`` (the clamp of ``dynamic_update_slice``), so
    once the cache is full every new token overwrites the last slot, while
    ``length`` keeps growing;
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
    families = ("dense", "vlm", "moe", "ssm", "hybrid")
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


def _cached_block(x, p, cfg: ModelConfig, shard, positions, mode: str, kc,
                  vc, slot: int, cache_len):
    """A transformer block in serving whose kv cache is ``kc[slot]``,
    ``vc[slot]``: prefill writes it, decode updates it in place."""
    if mode == "prefill":
        x, (kc[slot], vc[slot]), _ = _transformer_block(
            x, p, cfg, positions, mode, shard=shard)
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


def _new_cache(spec: Cache, axes: Cache, device, shard) -> Cache:
    """Uninitialised cache tensors of ``spec``'s shapes; DTensors of the
    cache axes' placements on a mesh."""
    out = {}
    for f in dataclasses.fields(Cache):
        t = getattr(spec, f.name)
        if t is None:
            continue
        if shard.mesh is None:
            out[f.name] = torch.empty(t.shape, dtype=t.dtype, device=device)
        else:
            out[f.name] = dtensor_empty(
                t.shape, dtype=t.dtype, device_mesh=shard.mesh,
                placements=shard.placements(t.shape, *getattr(axes, f.name)))
    return Cache(**out)


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, shard=NULL_SHARDER):
    """Process a full prompt; returns (last_token_logits, Cache)."""
    with _replicated_constants(shard):
        B, S = batch["tokens"].shape
        spec = cache_specs(cfg, B, S)
        x, positions = _embed(params, batch, cfg, shard)
        cache = _new_cache(spec, cache_axes(cfg), x.device, shard)
        cache.length.fill_(S)
        x = _run_layers(x, params, cfg, shard, positions, "prefill", cache)
        logits = _unembed(x[:, -1:], params, cfg, shard)
        return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, batch, cache: Cache, cfg: ModelConfig,
                shard=NULL_SHARDER):
    """One decode step. batch: tokens (B, 1). Returns (logits (B, V), Cache);
    the cache's tensors are updated in place and shared by the result."""
    with _replicated_constants(shard):
        _check_supported(cfg)
        x, positions = _embed(params, batch, cfg, shard)
        if not cfg.mrope and batch.get("positions") is None:
            positions = cache.length[:, None]
        x = _run_layers(x, params, cfg, shard, positions, "decode", cache)
        logits = _unembed(x, params, cfg, shard)
        return logits[:, 0], dataclasses.replace(cache,
                                                 length=cache.length + 1)


