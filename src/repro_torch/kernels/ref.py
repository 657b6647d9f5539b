"""Plain PyTorch versions of the port's model kernels (the allclose ground
truth), as ``repro/kernels/ref.py`` is for the Pallas kernels.

Deliberately simple, unfused and float32-accumulating, so kernel tests
compare against unambiguous math.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref_bhsd"]


def attention_ref_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) — dense masked attention in
    float32 with ``-inf`` masking, cast back to q's type (kernel K4's plain
    version)."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    kq = k.repeat_interleave(G, dim=1).float()
    vq = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
