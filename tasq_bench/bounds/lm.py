"""The LM cell's yardstick: the least time of each K4 and K5 launch from
its arguments, and the model FLOPs of a served request, with the card's
dense bf16 peak.

Each kernel bound is the larger of the bytes the launch has to move,
each input byte read once and each output byte written once, over the
HBM rate, and its operations over the bf16 tensor-core peak:

* K4 (``csrc/flash_attention.cu``), bf16: q, k and v read once at a row's
  live positions, the least the work needs (the kernel skips the key
  tiles before the row's start), o written once at every position (the
  pad rows as 0); 4 D operations (q.k and p.v, a multiply-add each) for each query head
  and each live (query, key) pair: keys at or after the row's start and
  not in its causal future, so a row of n live positions counts
  n (n + 1) / 2 pairs and the left-padding none.
* K5 (``csrc/ssd.cu``): x read and y written (bf16), dt (float32), B and C
  (bf16) read, the final (B, H, P, N) float32 state written; per chunk of
  Q rows and head the causal half of the intra-chunk products, Q (Q + 1)
  (N + P) (C.B^T and its product with x over the pairs i >= j), and
  4 Q N P for the inter-chunk term C.h_prev and the state update.

A request's model FLOPs (``request_flops``) count what serving it needs:
for each real token (the prompt without its padding, and every generated
token but the last, which is never fed back) 2 per active weight of the
layers (the routed experts' top K, the shared expert, the router, the
mixers' projections), the conv, the SSD's recurrence (4 H P N a Mamba-2
layer) and the causal attention over the request's own earlier tokens
(4 Hq D a pair an attention layer); and the tied head, 2 V D, once for
every kept token (the prefill's last position and each decode step).
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
BF16_FLOPS_PER_S = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def _bound(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def k4_flops(S: int, Hq: int, D: int, pads) -> float:
    """Operations of one K4 launch over rows of S positions whose first
    ``pads[b]`` are left-padding."""
    n = S - np.asarray(pads, np.float64)
    return float(4.0 * Hq * D * np.sum(n * (n + 1) / 2))


def k4_bytes(B: int, S: int, Hq: int, Hkv: int, D: int, pads) -> float:
    """Bytes one K4 launch has to move over rows whose first ``pads[b]``
    of S positions are left-padding."""
    live = float(np.sum(S - np.asarray(pads, np.float64)))
    return 2.0 * D * ((Hq + 2 * Hkv) * live + Hq * B * S)


def k4_seconds(B: int, S: int, Hq: int, Hkv: int, D: int, pads) -> float:
    return _bound(k4_bytes(B, S, Hq, Hkv, D, pads),
                  k4_flops(S, Hq, D, pads))


def k5_flops(B: int, S: int, H: int, P: int, N: int, Q: int) -> float:
    Q = min(Q, S)
    per = Q * (Q + 1) * (N + P) + 4.0 * Q * N * P
    return float(B * H * (S // Q) * per)


def k5_seconds(B: int, S: int, H: int, P: int, N: int, Q: int) -> float:
    n_bytes = (2.0 * 2 * B * S * H * P + 4.0 * B * S * H + 2.0 * 2 * B * S
               * N + 4.0 * B * H * P * N)
    return _bound(n_bytes, k5_flops(B, S, H, P, N, Q))


def layer_token_flops(cfg) -> dict:
    """Operations a token makes in each kind of layer, apart from the
    attention's pairs: {"mamba": ..., "attention": ...}."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    di, n, h = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_heads
    cd = di + 2 * n
    ffn = 2 * (d * cfg.num_experts + cfg.experts_per_token * 3 * d * cfg.d_ff
               + 3 * d * cfg.shared_expert_ff)
    mamba = 2 * (d * (di + cd + h) + di * d) + 2 * cfg.ssm_conv * cd \
        + 4 * h * cfg.ssm_head_dim * n
    attn = 2 * (2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd)
    return {"mamba": ffn + mamba, "attention": ffn + attn}


def request_flops(cfg, prompt_tokens: int, kept_tokens: int) -> float:
    """Model FLOPs of serving one request: ``prompt_tokens`` real prompt
    tokens, ``kept_tokens`` generated and kept (above)."""
    per = layer_token_flops(cfg)
    fed = prompt_tokens + max(kept_tokens - 1, 0)     # tokens through layers
    layers = sum(per[t] for t in cfg.layer_types) * fed
    n_attn = sum(t == "attention" for t in cfg.layer_types)
    pairs = fed * (fed + 1) / 2
    attn = 4.0 * cfg.num_heads * cfg.resolved_head_dim * pairs * n_attn
    head = 2.0 * cfg.vocab_size * cfg.d_model * kept_tokens
    return float(layers + attn + head)
