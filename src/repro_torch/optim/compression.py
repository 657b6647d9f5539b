"""int8 gradient compression with error feedback for the cross-pod axis.

The port of ``repro.optim.compression``. Cross-pod links are the slowest
hop of a multi-pod job, so the per-step gradient all-reduce on the
``pod`` axis is the natural target: bf16 -> int8 quarters the payload,
and an error-feedback residual keeps the compression noise from
accumulating into the optimizer.

``compressed_psum`` keeps the reference's math: each rank quantises its
gradient plus residual, the dequantised float32 values are all-reduced
over the group and averaged. The reduction runs on those float32 values,
as the reference's ``psum`` does; it is not int8 on the wire.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["compress_int8", "decompress_int8", "compressed_psum",
           "compress_tree"]


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale): scale =
    max(amax / 127, 1e-12) float32, q = clip(round(x / scale), -127, 127)
    int8, rounding half to even."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce over ``group`` (the process
    group of the mesh's ``pod`` dim, ``mesh.get_group("pod")``; the
    default group if None). Returns (the mean-reduced gradient in
    ``grad``'s dtype, the new float32 residual). Every rank of the group
    must call it."""
    g = grad.float() + residual
    q, scale = compress_int8(g)
    sent = decompress_int8(q, scale)
    new_residual = g - sent
    summed = sent.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return (summed / n).to(grad.dtype), new_residual


def compress_tree(grads: Any, residuals: Any,
                  group: Optional[dist.ProcessGroup] = None
                  ) -> Tuple[Any, Any]:
    """``compressed_psum`` over every leaf of a nested dict (or list) of
    gradients and the matching residuals; returns (grads, residuals) of
    the same structure."""
    if isinstance(grads, dict):
        outs = {k: compress_tree(grads[k], residuals[k], group)
                for k in grads}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    if isinstance(grads, (list, tuple)):
        outs = [compress_tree(g, r, group) for g, r in zip(grads, residuals)]
        return [o[0] for o in outs], [o[1] for o in outs]
    return compressed_psum(grads, residuals, group)
