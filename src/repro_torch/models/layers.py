"""Model-zoo building blocks (pure functions over tensors).

The port of ``repro.models.layers``. Conventions, as in the reference:
  * activations are (batch, seq, ...) in the config's compute dtype;
    softmax, norms and RoPE accumulate in float32;
  * the blocks that the reference constrains take a ``shard`` callable
    (``models.params.Sharder``); ``NULL_SHARDER`` makes it a no-op. On a
    mesh, activations and weights are DTensors; the ops DTensor has no
    sharding strategy for (the MoE dispatch's sort, scatter and cumsum)
    run under ``Sharder.local`` on the batch shard, as the reference
    pins them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.params import NULL_SHARDER

__all__ = ["dense", "rms_norm", "layer_norm", "rope_freqs", "apply_rope",
           "apply_mrope", "causal_attention_ref", "causal_attention_tri",
           "bidirectional_attention", "decode_attention", "swiglu_mlp",
           "gelu_mlp", "moe_block", "moe_dropless", "causal_conv",
           "conv_step", "ssd_chunked", "ssd_decode_step"]

_MASKED = -1e30      # the reference's fill for masked scores


# ------------------------------------------------------- weight products ----
def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) times a weight matrix w (D, F) -> (..., F): the
    reference's no-batch-dimension einsums ("bsd,dq->bsq" and the like),
    taken as one ``aten.mm`` over the flattened rows. ``torch.einsum``
    would dispatch them as ``aten.bmm`` of batch 1, as it does the
    attention's batched score and value products, so the ``"dots"`` remat
    policy (``lm._remat``) could not tell the two apart. On DTensors the
    same product after two explicit gathers: the row dims but the first
    where they are sharded (the sequence-parallel residual's all-gather
    before a weight product, as in Megatron's sequence parallelism: the
    flattened rows keep the batch's sharding only), and w on every mesh
    dim that shards the batch (FSDP's per-layer weight all-gather; left to
    itself DTensor may gather the activations instead). The model axis's
    tensor parallelism is then local: a column-parallel output stays
    sharded, a row-parallel one is a partial sum."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        rows = tuple(Replicate() if isinstance(q, Shard)
                     and 0 < q.dim < x.ndim - 1 else q for q in x.placements)
        if rows != tuple(x.placements):
            x = x.redistribute(mesh, rows)
        whole = tuple(Replicate() if xq.is_shard(0) else wq
                      for xq, wq in zip(rows, w.placements))
        if whole != tuple(w.placements):
            w = w.redistribute(mesh, whole)
        return _PlacedGrad.apply(torch.matmul(x, w))
    return torch.mm(x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1],
                                                          w.shape[-1])


def grad_placed_as(y: torch.Tensor) -> torch.Tensor:
    """``y``; on a DTensor, an identity whose backward redistributes the
    incoming gradient to ``y``'s own placements (a partial sum's as
    replicated). A gradient may arrive laid out otherwise: sequence-
    sharded into a product's backward that flattens its rows, or
    replicated from a full reduction (the loss) into a batch-sharded
    product, whose other operand DTensor would gather to match."""
    return _PlacedGrad.apply(y) if isinstance(y, DTensor) else y


class _PlacedGrad(torch.autograd.Function):
    """``grad_placed_as``'s identity."""

    @staticmethod
    def forward(ctx, y):
        ctx.mesh = y.device_mesh
        ctx.placements = tuple(Replicate() if q.is_partial() else q
                               for q in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to x's type, then scale by weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Mean and (biased) variance in float32, cast back to x's type, then
    scaled and shifted."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotate-half convention."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (D/2,)
    angles = positions[..., None].float() * freqs                  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE (qwen2-vl). x: (B, S, H, D); positions: (3, B, S) int, the
    (temporal, height, width) ids. The D/2 frequency slots are split into
    three contiguous sections of ``sections`` slots, each rotated by its
    own position component; otherwise ``apply_rope``."""
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d_half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (D/2,)
    sec = torch.tensor([c for c, n in enumerate(sections)
                        for _ in range(n)], device=x.device)        # (D/2,)
    # slot j takes component sec[j]'s position: (B, S, D/2)
    pos = positions.movedim(0, -1)[..., sec].float()
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def _gqa_scores_softmax_out(q, k, v, mask, scale):
    """Dense masked attention core. q:(B,Sq,Hq,D) k/v:(B,Sk,Hkv,D); mask
    broadcasts against (B, Hkv, G, Sq, Sk). Scores are formed in the input
    type, then float32; probabilities are cast to v's type before the PV
    product, as in the reference."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def causal_attention_ref(q, k, v, chunk_q: int = 512, *, scale=None,
                         kv_start=None) -> torch.Tensor:
    """Masked-dense causal attention over query chunks of ``chunk_q`` (the
    ``"xla"`` route): the full S^2 scores are computed chunk by chunk and
    the masked half discarded. S must be at most ``chunk_q`` or a multiple
    of it, as in the reference. ``scale`` defaults to 1/sqrt(D). With
    ``kv_start`` ((B,) int, kernel K4's argument) the keys before a row's
    start are masked too, and query rows before it (left-padding) give 0."""
    B, S, Hq, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    cols = torch.arange(S, device=q.device)

    def chunk(lo, n):
        rows = lo + torch.arange(n, device=q.device)
        mask = rows[:, None] >= cols[None, :]
        if kv_start is None:
            return _gqa_scores_softmax_out(q[:, lo:lo + n], k, v, mask, scale)
        st = kv_start.to(q.device).long()[:, None, None, None, None]
        out = _gqa_scores_softmax_out(q[:, lo:lo + n], k, v,
                                      mask & (cols >= st), scale)
        return out.masked_fill((rows[None, :] < st[:, 0, 0, 0])[..., None,
                                                                 None], 0)

    if S <= chunk_q:
        return chunk(0, S)
    if S % chunk_q:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk_q}")
    return torch.cat([chunk(i * chunk_q, chunk_q)
                      for i in range(S // chunk_q)], dim=1)


def _attn_block_stats(q, k, v, mask, scale):
    """Flash-style block attention: the UNNORMALISED (num, m, l) of
    q (B, Sq, Hq, D) against k, v (B, Sk, Hkv, D). num (B, Sq, Hq, D)
    float32 = sum_k exp(s - m) v; m, l (B, Sq, Hq): the row max and the
    denominator. Masked scores are -inf, as in the reference."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v).reshape(
        B, Sq, Hq, D)
    to_bshq = lambda t: t.permute(0, 3, 1, 2).reshape(B, Sq, Hq)
    return num.float(), to_bshq(m), to_bshq(l)


def _merge_stats(a, b):
    """Log-sum-exp merge of two blocks' (num, m, l) over the same rows."""
    (na, ma, la), (nb, mb, lb) = a, b
    m = torch.maximum(ma, mb)
    wa = torch.exp(ma - m)
    wb = torch.exp(mb - m)
    return na * wa[..., None] + nb * wb[..., None], m, la * wa + lb * wb


def causal_attention_tri(q, k, v, depth: int = 3,
                         leaf_chunk: int = 512) -> torch.Tensor:
    """Triangle-decomposed causal attention (the ``"tri"`` route): the
    causal triangle of S is two half-triangles and one unmasked (S/2 x
    S/2) block, recursively to ``depth`` levels or ``leaf_chunk`` rows, so
    at depth d the masked work wasted is 2^-d of the dense baseline's. The
    leaves are masked blocks; the blocks' statistics are merged by
    log-sum-exp, then normalised once, in q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def tri(qc, kc, vc, d):
        Sc = qc.shape[1]
        if d == 0 or Sc <= leaf_chunk:
            i = torch.arange(Sc, device=qc.device)
            return _attn_block_stats(qc, kc, vc, i[:, None] >= i[None, :],
                                     scale)
        h = Sc // 2
        n1, m1, l1 = tri(qc[:, :h], kc[:, :h], vc[:, :h], d - 1)
        lower = tri(qc[:, h:], kc[:, h:], vc[:, h:], d - 1)
        cross = _attn_block_stats(qc[:, h:], kc[:, :h], vc[:, :h], None,
                                  scale)
        n2, m2, l2 = _merge_stats(lower, cross)
        return (torch.cat([n1, n2], dim=1), torch.cat([m1, m2], dim=1),
                torch.cat([l1, l2], dim=1))

    num, _, l = tri(q, k, v, depth)
    return (num / l[..., None]).to(q.dtype)


def bidirectional_attention(q, k, v) -> torch.Tensor:
    """Unmasked attention of q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D)."""
    return _gqa_scores_softmax_out(q, k, v, None, 1.0 / math.sqrt(q.shape[-1]))


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     kv_start=None) -> torch.Tensor:
    """One-token attention against a cache. q:(B,1,Hq,D) cache:(B,Smax,Hkv,D);
    cache_len: (B,) valid lengths (positions >= cache_len are masked out),
    and with ``kv_start`` (B,) the positions before it too. ``scale``
    defaults to 1/sqrt(D)."""
    Smax = k_cache.shape[1]
    pos = torch.arange(Smax, device=q.device)[None, :]
    mask = pos < cache_len[:, None]                                # (B, Smax)
    if kv_start is not None:
        mask = mask & (pos >= kv_start[:, None])
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _gqa_scores_softmax_out(q, k_cache, v_cache,
                                   mask[:, None, None, None], scale)


# ------------------------------------------------------------------ MLP ----
def swiglu_mlp(x, wi_gate, wi_up, wo, shard=NULL_SHARDER) -> torch.Tensor:
    h = shard(dense(x, wi_gate), "batch", "seq", "mlp")
    u = dense(x, wi_up)
    h = F.silu(h.float()).to(x.dtype) * u
    return dense(h, wo)


def gelu_mlp(x, wi, bi, wo, bo) -> torch.Tensor:
    h = dense(x, wi) + bi
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(h, wo) + bo


# ------------------------------------------------------------------ MoE ----
def moe_block(x, p, cfg, shard=NULL_SHARDER):
    """Sort-based top-k MoE with a per-sequence capacity, the reference's
    Megablocks-lite. x: (B, S, D). Returns (out, aux load-balance loss).

    The reference's steps and values: router logits in x's type, then
    float32; softmax; top-k with the gates renormalised; the Switch-style
    aux loss; a stable sort of each sequence's (token, k) slots by expert;
    a slot's rank in its expert's group, kept where rank < C =
    max(1, ceil(K * S * capacity_factor / E)); the kept slots scattered
    into a buffer whose one extra row takes the overflow; the expert
    SwiGLU as batched products; the rows gathered back (a dropped slot
    gives 0), unsorted, and summed weighted by the gates in x's type.

    Two differences of form, none of value:
      * top-k is the first K of a stable descending sort: ``torch.topk``
        breaks ties in another order than ``jax.lax.top_k``, which takes
        the lowest expert first. Ties are common: the logits are rounded
        to x's type before the softmax. The stable sort also makes the
        routing of a remat recompute the forward's own;
      * the buffer is expert-major, (E, B, C, D) where the reference's is
        (B, E, C, D), so that each expert product is one batched matmul
        over contiguous rows; the gather back goes straight from each
        (token, k) slot to its row, where the reference gathers in sorted
        order and then unsorts.

    On a mesh the reference pins every dispatch intermediate to batch-only
    sharding (``x`` to ("batch", None, None), the expert buffer to
    ("batch", "expert", None, None)), so that the dispatch is local to the
    batch shard and only the expert products communicate. The port runs
    the dispatch under ``Sharder.local`` on that batch shard: ``x`` and the
    router whole on the model axis, each expert weight sharded on
    "expert" (its FSDP dim gathered). A model rank routes every token but
    computes the experts it holds; its output is one term of a ``Partial``
    sum over the model axis, and the aux loss is formed from the token
    counts and probability sums, ``Partial`` over the batch shards (the
    sums also over the expert shards, each holding its share)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    if shard.mesh is None:
        y, frac_tokens, frac_probs = _moe_dispatch(
            x, p["router"], p["wi_gate"], p["wi_up"], p["wo"], cfg, 0, False)
        return y, E * torch.sum(frac_tokens * frac_probs)
    mesh = shard.mesh
    x = shard(x, "batch", None, None)
    wpl = shard.placements(p["wi_gate"].shape, "expert", None, None)
    e0 = 0
    for i, q in enumerate(wpl):
        if isinstance(q, Shard):
            e0 = e0 * mesh.size(i) + mesh.get_local_rank(i)
    e0 *= E // math.prod(mesh.size(i) for i, q in enumerate(wpl)
                         if isinstance(q, Shard))
    xpl = x.placements
    ypl = tuple(Partial() if isinstance(w, Shard) else q
                for q, w in zip(xpl, wpl))
    cpl = tuple(Partial() if isinstance(q, Shard) else Replicate()
                for q in xpl)
    # every expert shard routes every token: each returns its share of
    # the probability sums, so that their gradient is taken once
    n_split = mesh.size() // math.prod(
        mesh.size(i) for i, w in enumerate(wpl) if not isinstance(w, Shard))
    ppl = tuple(Partial() if isinstance(q, Shard) or isinstance(w, Shard)
                else Replicate() for q, w in zip(xpl, wpl))
    rep = (Replicate(),) * mesh.ndim

    def local(*a):
        y, counts, probsum = _moe_dispatch(*a, cfg, e0, True)
        return y, counts, probsum / n_split

    y, counts, probsum = shard.local(
        local, (x, p["router"], p["wi_gate"], p["wi_up"], p["wo"]),
        (xpl, rep, wpl, wpl, wpl), (ypl, cpl, ppl))
    n = B * S
    return y, E * torch.sum(counts / n / K * (probsum / n))


def _moe_dispatch(x, router, wi_gate, wi_up, wo, cfg, e0: int, sums: bool):
    """The MoE block on plain tensors, for the experts ``e0 ..
    e0 + wi_gate.shape[0] - 1`` (all of them off a mesh). Returns (out,
    token stat, probability stat): per expert, the fraction of (token, k)
    slots routed to it and its mean probability, or with ``sums`` the
    slot count and the probability sum (summed over batch shards)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    El = wi_gate.shape[0]
    C = max(1, math.ceil(K * S * cfg.capacity_factor / E))
    dev = x.device
    logits = dense(x, router).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[..., :K], idx[..., :K]                    # (B, S, K)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch-style) statistics
    # the (E,) slot counts (bincount's, whose output shape a traced
    # program cannot know); integer sums in float32, exact in any order
    flat = eidx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=dev))
    if sums:
        tok_stat, prob_stat = counts, probs.sum(dim=(0, 1))
    else:
        tok_stat, prob_stat = counts / (B * S) / K, probs.mean(dim=(0, 1))

    sorted_e, order = torch.sort(eidx.reshape(B, S * K), dim=-1, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(B, E).contiguous())
    rank = torch.arange(S * K, device=dev) - torch.gather(starts, 1, sorted_e)
    keep = (rank < C) & (sorted_e >= e0) & (sorted_e < e0 + El)
    b = torch.arange(B, device=dev)[:, None]
    rows = El * B * C                                 # + 1: the overflow row
    row = torch.where(keep, ((sorted_e - e0) * B + b) * C + rank, rows)
    src = (b * S + torch.div(order, K, rounding_mode="floor")).reshape(-1)
    buf = x.new_zeros((rows + 1, D))
    buf.index_put_((row.reshape(-1),), x.reshape(B * S, D)[src])
    buf = buf[:rows].view(El, B * C, D)

    # expert SwiGLU
    h = torch.einsum("ecd,edf->ecf", buf, wi_gate)
    u = torch.einsum("ecd,edf->ecf", buf, wi_up)
    h = F.silu(h.float()).to(x.dtype) * u
    yb = torch.einsum("ecf,efd->ecd", h, wo).reshape(rows, D)

    # each (token, k) slot's row (the overflow reads the last row, then 0)
    back = torch.empty_like(row).scatter_(1, order, row.clamp(max=rows - 1))
    kept = torch.empty_like(keep).scatter_(1, order, keep)
    y = yb[back.reshape(-1)].view(B, S, K, D)
    y = y.masked_fill(~kept.view(B, S, K, 1), 0)
    return (y * gates[..., None].to(x.dtype)).sum(dim=2), tok_stat, prob_stat


# tokens a dropless MoE call dispatches at once: bounds the (T * K, D)
# gathered rows and expert outputs (at 32 x 2,048 tokens, top-10 and D
# 4,096 one whole batch would take 10.7 GB of bf16 transients)
MOE_TOKENS_PER_CALL = 16384


def moe_dropless(x, p, cfg, counters=None):
    """The hybrid_moe family's MoE FFN, dropless, as HF's GraniteMoe
    computes it: router logits in float32, the top K of them (the first K
    of a stable descending sort), a softmax over those K cast to x's type;
    each routed expert's SwiGLU (``expert_wi`` (E, D, 2F): gate, then up;
    ``expert_wo`` (E, F, D)) on its tokens; the outputs weighted by the
    gates and summed; plus the shared SwiGLU expert (``shared_wi`` (D,
    2Fs), ``shared_wo``) on every token.

    Grouped, not capacity-bound: the (token, k) slots are sorted by
    expert (stably) and each expert's contiguous rows go through one
    grouped product (``torch._grouped_mm``, its group ends ``offs`` kept
    on the device), so no slot is dropped and no (E, C, D) buffer is
    padded. ``counters``, two 0-d int64 tensors on x's device, gather the
    slots routed and each call's busiest expert's slots on the card
    (tracing reads them once a batch)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(B * S, D)
    out = torch.empty_like(xf)
    for lo in range(0, B * S, MOE_TOKENS_PER_CALL):
        xc = xf[lo:lo + MOE_TOKENS_PER_CALL]
        T = xc.shape[0]
        logits = dense(xc, p["router"]).float()
        top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        gates = torch.softmax(top[:, :K], dim=-1).to(x.dtype)     # (T, K)
        flat = idx[:, :K].reshape(-1)
        order = torch.argsort(flat, stable=True)
        # (E,) slot counts without bincount's read-back of the largest id
        counts = torch.zeros(E, dtype=torch.int64, device=x.device
                             ).index_add_(0, flat, torch.ones_like(flat))
        if counters is not None:
            counters[0].add_(T * K)
            counters[1].add_(counts.max())
        offs = torch.cumsum(counts, 0).to(torch.int32)
        rows = xc[torch.div(order, K, rounding_mode="floor")]
        g, u = torch._grouped_mm(rows, p["expert_wi"], offs=offs).chunk(
            2, dim=-1)
        y = torch._grouped_mm(F.silu(g.float()).to(x.dtype) * u,
                              p["expert_wo"], offs=offs)
        slots = torch.empty_like(y)
        slots[order] = y
        out[lo:lo + T] = torch.bmm(gates[:, None, :],
                                   slots.view(T, K, D))[:, 0]
    g, u = dense(x, p["shared_wi"]).chunk(2, dim=-1)
    shared = dense(F.silu(g.float()).to(x.dtype) * u, p["shared_wo"])
    return out.view(B, S, D) + shared


# ------------------------------------------------------ Mamba-2's conv ----
def causal_conv(u, w, b):
    """Causal depthwise conv over time with a bias: u (B, S, C), w (W, C),
    b (C,) -> (B, S, C) in u's type, out[t] = b + sum_k w[k] u[t - W + 1
    + k] with u zero before the first position, accumulated in float32."""
    W = w.shape[0]
    S = u.shape[1]
    up = F.pad(u, (0, 0, W - 1, 0)).float()
    acc = b.float().expand(u.shape)
    for k in range(W):
        acc = acc + up[:, k:k + S] * w[k].float()
    return acc.to(u.dtype)


def conv_step(state, u, w, b):
    """One token of ``causal_conv`` from ``state`` (B, W - 1, C), the last
    W - 1 inputs: returns (out (B, C), the new state), computed as the
    full conv computes that position."""
    win = torch.cat([state, u[:, None]], dim=1)                  # (B, W, C)
    acc = b.float().expand(u.shape)
    for k in range(w.shape[0]):
        acc = acc + win[:, k].float() * w[k].float()
    return acc.to(u.dtype), win[:, 1:]


# ---------------------------------------------------------- SSD (Mamba2) ---
def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} log_a[..., k],
    -inf for j > i."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                  # i, j
    idx = torch.arange(Q, device=log_a.device)
    mask = idx[:, None] >= idx[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Mamba-2 SSD (state-space dual) forward, chunked: kernel K5's plain
    version (``kernels/ssd.py``).

    x:  (B, S, H, P)   values
    dt: (B, S, H)      post-softplus step sizes
    A:  (H,)           negative decay rates
    Bm: (B, S, N)      input projections (shared across heads)
    Cm: (B, S, N)      output projections
    Returns y: (B, S, H, P) in x's type and the final state (B, H, P, N)
    in float32. The reference's three-operand einsums are taken as two
    products each, in the reference's order.
    """
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    xr = x.reshape(Bb, nc, chunk, H, P)
    dtr = dt.reshape(Bb, nc, chunk, H)
    Br = Bm.reshape(Bb, nc, chunk, N)
    Cr = Cm.reshape(Bb, nc, chunk, N)

    log_a = (dtr * A).float()                                    # (B,nc,Q,H) <= 0
    log_a = log_a.movedim(-1, 2)                                 # (B,nc,H,Q)
    L = torch.exp(_segsum(log_a))                                # (B,nc,H,Q,Q)

    xdt = (xr * dtr[..., None]).float()                          # (B,nc,Q,H,P)

    # intra-chunk (quadratic within chunk)
    cb = torch.einsum("bcqn,bckn->bcqk", Cr, Br).float()
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * L, xdt)

    # per-chunk outgoing state: sum_i decay(i->end) * dt_i x_i B_i
    decay_out = torch.exp(torch.cumsum(log_a.flip(-1), dim=-1).flip(-1)
                          - log_a)                               # (B,nc,H,Q)
    states = torch.einsum("bcqhp,bcqn->bchpn",
                          decay_out.movedim(2, 3)[..., None] * xdt, Br.float())

    # inter-chunk recurrence; h_prev[c] is the state *before* chunk c
    chunk_decay = torch.exp(log_a.sum(dim=-1))                   # (B,nc,H)
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,H,P,N)

    # inter-chunk contribution: C_t . decay(start->t) . h_prev
    decay_in = torch.exp(torch.cumsum(log_a, dim=-1))            # (B,nc,H,Q)
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", Cr.float(), h_prev)
               * decay_in.movedim(2, 3)[..., None])

    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y.to(x.dtype), h


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """O(1) SSD decode: one token's state update and output.

    h: (B, H, P, N) float32 state; x: (B, H, P); dt: (B, H); A: (H,);
    Bm, Cm: (B, N). Returns y (B, H, P) in x's type and the new float32
    state h * exp(dt A) + (x dt) (x) B."""
    da = torch.exp((dt * A[None, :]).float())                    # (B,H)
    contrib = torch.einsum("bhp,bn->bhpn", (x * dt[..., None]).float(),
                           Bm.float())
    h_new = h * da[..., None, None] + contrib
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float())
    return y.to(x.dtype), h_new
