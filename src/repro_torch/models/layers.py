"""Model-zoo building blocks for dense serving (pure functions over tensors).

The port of ``repro.models.layers``, the subset the dense decoder-only
serving path runs. Conventions, as in the reference:
  * activations are (batch, seq, ...) in the config's compute dtype;
    softmax, norms and RoPE accumulate in float32;
  * no ``shard`` argument: the port serves on one card.

``apply_mrope``, ``moe_block``, the SSD blocks and ``causal_attention_tri``
come with the slices that run them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "causal_attention_ref",
           "decode_attention", "swiglu_mlp"]

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

