"""Plain PyTorch versions of the port's model kernels (the allclose ground
truth), as ``repro/kernels/ref.py`` is for the Pallas kernels.

Deliberately simple, unfused and float32-accumulating, so kernel tests
compare against unambiguous math.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref_bhsd", "ssd_ref"]


def attention_ref_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, scale: float = None,
                       kv_start: torch.Tensor = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) — dense masked attention in
    float32 with ``-inf`` masking, cast back to q's type (kernel K4's plain
    version). ``scale`` defaults to 1/sqrt(D); with ``kv_start`` (B,) the
    keys before a row's start are masked and the query rows before it
    give 0, as the kernel writes them."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    kq = k.repeat_interleave(G, dim=1).float()
    vq = v.repeat_interleave(G, dim=1).float()
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    if kv_start is not None:
        pos = torch.arange(S, device=q.device)
        st = kv_start.to(q.device).long()[:, None, None, None]
        live = (pos >= st) & (pos[:, None] >= st)          # (B, 1, S, S)
        mask = mask & live
    s = s.masked_fill(~mask, float("-inf"))
    # a row with no live key (left-padding) gives 0, not NaN
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Sequential SSD recurrence oracle (no chunking).

    x: (B,S,H,P), dt: (B,S,H), A: (H,), Bm/Cm: (B,S,N) -> y: (B,S,H,P).
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T ; y_t = h_t C_t.
    """
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t], dt[:, t]                     # (B,H,P), (B,H)
        da = torch.exp(dtt.float() * A[None, :])        # (B,H)
        contrib = torch.einsum("bhp,bn->bhpn", (xt * dtt[..., None]).float(),
                               Bm[:, t].float())
        h = h * da[..., None, None] + contrib
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype)
