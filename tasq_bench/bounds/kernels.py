"""Least device time of each launch, from its arguments (seconds).

Each bound is the larger of the bytes the launch has to move, each input
byte read once and each output byte written once, over the HBM rate, and
the operations its inputs need over the peak rate of their precision
(``peaks``). The formulas are those the port's chip smoke test uses:

* K1 (AREPAS runtimes, ``csrc/skyline.cu``): every valid skyline second
  read once (4 bytes) and compared and added once per allocation; the
  (J,) row index, (J,) lengths, (J, K) allocations and runtimes.
* K2 (the epoch step, ``csrc/cluster_step.cu``): the (K, L) float64 end
  times and int64 tokens read and written, the (K, Q) queue read, the
  (K, Q) int32 slot map and five (K,) totals written; six operations a
  table entry and six a queue entry.
* K3 (the elastic resize, ``csrc/cluster_step.cu``): each candidate's
  valid skyline seconds once, its nine 8-byte inputs, its 25 output
  bytes; 12 float64 operations of the decision, and one ``pow`` (126
  float64 operations in its SASS, with a product and a compare) for the
  base runtime and for every bisection level still open.
* A decide: the model's multiply-adds (two operations each) over the
  request's real rows and nodes, in float32, and the policy's float64
  work counted as K3's decision.
"""
from __future__ import annotations

import numpy as np

from tasq_bench.bounds import peaks

POW_FLOPS = 126
DECISION_FIXED_FLOPS = 12


def _bound(n_bytes, f32_ops=0.0, f64_ops=0.0, int_ops=0.0):
    return max(n_bytes / peaks.HBM_BYTES_PER_S,
               f32_ops / peaks.F32_OPS_PER_S + f64_ops / peaks.F64_OPS_PER_S
               + int_ops / peaks.INT_OPS_PER_S)


def k1_seconds(valid_seconds: int, J: int, K: int) -> float:
    n_bytes = 4 * (valid_seconds + J + 2 * J * K) + 8 * J
    return _bound(n_bytes, int_ops=2 * K * valid_seconds)


def k2_seconds(K: int, L: int, Q: int) -> float:
    n_bytes = 4 * K * L * 8 + 2 * K * Q * 8 + K * Q * 4 + 5 * K * 8
    return _bound(n_bytes, int_ops=6 * K * L + 6 * K * Q)


def policy_f64_ops(levels: np.ndarray, max_slowdown: float) -> float:
    """float64 operations of the decisions of rows with ``levels`` open
    bisection levels each."""
    C = len(levels)
    pows = int(np.sum(levels)) + C * (max_slowdown > 0)
    return C * DECISION_FIXED_FLOPS + pows * (POW_FLOPS + 2)


def k3_seconds(valid_seconds: int, levels: np.ndarray,
               max_slowdown: float) -> float:
    C = len(levels)
    n_bytes = 4 * valid_seconds + C * (9 * 8 + 4) + C * 25
    return _bound(n_bytes, int_ops=2 * valid_seconds,
                  f64_ops=policy_f64_ops(levels, max_slowdown))


def mlp_flops(dims) -> int:
    """Multiply-adds of one row through an MLP with layer widths
    ``dims`` (input first), two operations each."""
    return int(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def nn_row_flops(in_dim: int, hidden) -> int:
    dims = (in_dim,) + tuple(hidden) + (2,)
    return 2 * in_dim + mlp_flops(dims)           # standardize, MLP


def gnn_row_flops(n_nodes: int, in_dim: int, gcn_dims, head_hidden) -> int:
    """One graph of ``n_nodes`` real nodes: per GCN layer the adjacency
    product and the node-wise linear map; the context, the attention
    logits and the pooled sum; the MLP head."""
    n = int(n_nodes)
    flops, d_in = 0, in_dim
    for d_out in gcn_dims:
        flops += 2 * n * n * d_in + 2 * n * d_in * d_out
        d_in = d_out
    D = d_in
    flops += 2 * D * D + 4 * n * D
    return flops + mlp_flops((D,) + tuple(head_hidden) + (2,))


def decide_seconds(model_f32_flops: float, levels: np.ndarray,
                   max_slowdown: float) -> float:
    """A decide's compute bound: its model products in float32 and its
    policy in float64 (its bytes, a few per row, never bind)."""
    return _bound(0, f32_ops=model_f32_flops,
                  f64_ops=policy_f64_ops(levels, max_slowdown))
