"""Model-zoo building blocks (pure functions over tensors).

The port of ``repro.models.layers``, the subset that serving and training
of the dense, MoE, SSM and hybrid families run. Conventions, as in the
reference:
  * activations are (batch, seq, ...) in the config's compute dtype;
    softmax, norms and RoPE accumulate in float32;
  * no ``shard`` argument: the port serves on one card.

``apply_mrope`` and ``causal_attention_tri`` come with the slices that run
them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "causal_attention_ref",
           "decode_attention", "swiglu_mlp", "moe_block", "ssd_chunked",
           "ssd_decode_step"]

_MASKED = -1e30      # the reference's fill for masked scores


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to x's type, then scale by weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


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


def causal_attention_ref(q, k, v, chunk_q: int = 512) -> torch.Tensor:
    """Masked-dense causal attention over query chunks of ``chunk_q`` (the
    ``"xla"`` route): the full S^2 scores are computed chunk by chunk and
    the masked half discarded. S must be at most ``chunk_q`` or a multiple
    of it, as in the reference."""
    B, S, Hq, D = q.shape
    scale = 1.0 / math.sqrt(D)
    if S <= chunk_q:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        return _gqa_scores_softmax_out(q, k, v, mask, scale)
    if S % chunk_q:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk_q}")
    cols = torch.arange(S, device=q.device)
    outs = []
    for i in range(S // chunk_q):
        rows = i * chunk_q + torch.arange(chunk_q, device=q.device)
        mask = rows[:, None] >= cols[None, :]
        outs.append(_gqa_scores_softmax_out(
            q[:, i * chunk_q:(i + 1) * chunk_q], k, v, mask, scale))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """One-token attention against a cache. q:(B,1,Hq,D) cache:(B,Smax,Hkv,D);
    cache_len: (B,) valid lengths (positions >= cache_len are masked out)."""
    Smax = k_cache.shape[1]
    mask = (torch.arange(Smax, device=q.device)[None, :]
            < cache_len[:, None])                                  # (B, Smax)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _gqa_scores_softmax_out(q, k_cache, v_cache,
                                   mask[:, None, None, None], scale)


# ------------------------------------------------------------------ MLP ----
def swiglu_mlp(x, wi_gate, wi_up, wo) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, wi_gate)
    u = torch.einsum("bsd,df->bsf", x, wi_up)
    h = F.silu(h.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, wo)


# ------------------------------------------------------------------ MoE ----
def moe_block(x, p, cfg):
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
        order and then unsorts."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(1, math.ceil(K * S * cfg.capacity_factor / E))
    dev = x.device
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[..., :K], idx[..., :K]                    # (B, S, K)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch-style)
    frac_tokens = torch.bincount(eidx.reshape(-1), minlength=E).float() \
        / (B * S) / K
    aux = E * torch.sum(frac_tokens * probs.mean(dim=(0, 1)))

    sorted_e, order = torch.sort(eidx.reshape(B, S * K), dim=-1, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(B, E).contiguous())
    rank = torch.arange(S * K, device=dev) - torch.gather(starts, 1, sorted_e)
    keep = rank < C
    b = torch.arange(B, device=dev)[:, None]
    rows = E * B * C                                  # + 1: the overflow row
    row = torch.where(keep, (sorted_e * B + b) * C + rank, rows)
    src = (b * S + torch.div(order, K, rounding_mode="floor")).reshape(-1)
    buf = x.new_zeros((rows + 1, D))
    buf.index_put_((row.reshape(-1),), x.reshape(B * S, D)[src])
    buf = buf[:rows].view(E, B * C, D)

    # expert SwiGLU
    h = torch.einsum("ecd,edf->ecf", buf, p["wi_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["wi_up"])
    h = F.silu(h.float()).to(x.dtype) * u
    yb = torch.einsum("ecf,efd->ecd", h, p["wo"]).reshape(rows, D)

    # each (token, k) slot's row (the overflow reads the last row, then 0)
    back = torch.empty_like(row).scatter_(1, order, row.clamp(max=rows - 1))
    kept = torch.empty_like(keep).scatter_(1, order, keep)
    y = yb[back.reshape(-1)].view(B, S, K, D)
    y = y.masked_fill(~kept.view(B, S, K, 1), 0)
    return (y * gates[..., None].to(x.dtype)).sum(dim=2), aux


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
