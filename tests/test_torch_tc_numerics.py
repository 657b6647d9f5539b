"""The rounding points of the bf16 tensor-core kernels K4 and K5, on the CPU.

K4's and K5's bf16 instantiations (``csrc/flash_attention.cu``,
``csrc/ssd.cu``) feed the tensor cores bf16 operands and accumulate in
float32. Where the plain versions keep float32, the kernels round to bf16:

  K4  the probabilities P before P.V (the denominator sums the float32 P);
  K5  the decay-weighted intra-chunk matrix G o exp(cs_i - cs_j) dt_j, the
      state h before C.h (or h split into a bf16 hi + lo pair), and the
      scaled input x o (dt w) of the state update h += (x o dt w)^T . B,
      w = exp(cs_last - cs).

Each test holds a plain float32 emulation of that arithmetic, tile by
tile as the kernel walks it, against the reference's Pallas kernel in
interpret mode on the same numpy-seeded bf16 inputs, within the reference
tests' bf16 tolerances (2e-2 attention, 5e-2 SSD), and prints the largest
error. The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd
from repro.kernels.ssd import ssd_chunk_scan

LOG2E = 1.4426950408889634
NEG_INF = -1e30
TILE = 128            # K4: queries and keys a tile; K5: chunk rows


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


# ------------------------------------------------------------------ K4 ---
def k4_emulation(q, k, v, causal):
    """q (B, Hq, S, D), k/v (B, Hkv, S, D), bf16 -> bf16: 128 x 128 tiles,
    base-2 online softmax in float32, P rounded to bf16 for P.V."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(G, 1).float()
    vf = v.repeat_interleave(G, 1).float()
    scale = np.float32(1.0 / math.sqrt(D)) * np.float32(LOG2E)
    out = torch.empty_like(q)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, min(q0 + TILE, S))
        m = torch.full((B, Hq, len(rows)), NEG_INF)
        l = torch.zeros((B, Hq, len(rows)))
        acc = torch.zeros((B, Hq, len(rows), D))
        n_live = q0 // TILE + 1 if causal else -(-S // TILE)
        for k0 in range(0, min(n_live * TILE, S), TILE):
            cols = torch.arange(k0, min(k0 + TILE, S))
            x = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
                 * float(scale))
            if causal:
                x = x.masked_fill(rows[:, None] < cols[None, :], NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _bf16(p) @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out


K4_CASES = [((1, 8, 2, 256, 128), True), ((1, 8, 2, 256, 128), False),
            ((1, 4, 4, 256, 80), True), ((1, 4, 4, 256, 80), False)]


@pytest.mark.parametrize("shape,causal", K4_CASES)
def test_k4_rounding_matches_pallas_kernel(shape, causal):
    """D 128 with GQA 4:1 (minitron-8b's head shape) and D 80 with
    Hq = Hkv (zamba2-2.7b's shared attention), S 256."""
    B, Hq, Hkv, S, D = shape
    rng = np.random.RandomState(sum(shape))
    q, k, v = (rng.standard_normal((B, h, S, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    want = flash_attention_bhsd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        block_q=TILE, block_k=TILE, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = k4_emulation(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                       causal).float().numpy()
    print(f"K4 emulation {shape} causal={causal}: max |diff| "
          f"{np.abs(got - want).max():.4g}")
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ K5 ---
def k5_emulation(x, dt, A, Bm, Cm, chunk, split_h):
    """x (B, S, H, P), Bm/Cm (B, S, N) bf16; dt (B, S, H), A (H,) float32
    -> y bf16: the chunk's cumulative sum of dt A in float64, decays
    exponentiated in float32 where i >= j only, G o decay dt, h (or its
    hi + lo pair) and x o (dt w) rounded to bf16, float32 sums."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    h = torch.zeros((Bb, H, P, N))
    y = torch.empty_like(x)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        dtc = dt[:, sl].permute(0, 2, 1)                    # (B, H, Q)
        cs = torch.cumsum((dtc * A[:, None]).double(), -1)  # float32 products
        xc = x[:, sl].permute(0, 2, 1, 3).float()           # (B, H, Q, P)
        Bc, Cc = Bm[:, sl].float(), Cm[:, sl].float()       # (B, Q, N)
        G = (Cc @ Bc.transpose(-1, -2))[:, None]            # (B, 1, Q, Q)
        diff = (cs[..., :, None] - cs[..., None, :]).float()
        decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        y_c = _bf16(G * decay * dtc[..., None, :]) @ xc
        if split_h:
            hi = _bf16(h)
            hb = (hi, _bf16(h - hi))
        else:
            hb = (_bf16(h),)
        inter = sum(Cc[:, None] @ part.transpose(-1, -2) for part in hb)
        y_c = torch.exp(cs.float())[..., None] * inter + y_c
        y[:, sl] = y_c.permute(0, 2, 1, 3).to(x.dtype)
        last = cs[..., -1:]
        w = torch.exp((last - cs).float()) * dtc             # (B, H, Q)
        xw = _bf16(xc * w[..., None])                        # (B, H, Q, P)
        h = (torch.exp(last.float())[..., None] * h
             + xw.transpose(-1, -2) @ Bc[:, None])
    return y


K5_CASES = [((1, 256, 4, 64, 64, 128), False),
            ((1, 256, 4, 64, 64, 128), True),
            ((1, 256, 4, 64, 128, 128), False),
            ((1, 256, 4, 64, 128, 128), True)]


@pytest.mark.parametrize("shape,split_h", K5_CASES)
def test_k5_rounding_matches_pallas_kernel(shape, split_h):
    """P 64 with N 64 (zamba2-2.7b's heads) and N 128 (mamba2-1.3b's),
    Q 128, S 256 (the state crosses one chunk boundary); h rounded to bf16
    once, or split into hi + lo."""
    B, S, H, P, N, chunk = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(np.float32)
    want = ssd_chunk_scan(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                          jnp.asarray(A), jnp.asarray(Bm, jnp.bfloat16),
                          jnp.asarray(Cm, jnp.bfloat16), chunk=chunk,
                          interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = k5_emulation(torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
                       torch.from_numpy(A), torch.from_numpy(Bm).bfloat16(),
                       torch.from_numpy(Cm).bfloat16(), chunk,
                       split_h).float().numpy()
    print(f"K5 emulation {shape} h {'hi + lo' if split_h else 'bf16'}: max "
          f"|diff| {np.abs(got - want).max():.4g}")
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
