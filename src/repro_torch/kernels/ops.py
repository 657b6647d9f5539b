"""Public wrappers for the port's kernels.

Each wrapper dispatches on where its tensors lie: a CUDA tensor launches
the hand-written kernel (or the call raises — there is no fallback), a CPU
tensor runs the kernel's plain PyTorch version. ``launch_counts`` reads how
often each kernel was launched; ``reset_launch_counts`` sets the counts to
0, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.arepas import (simulate_runtime_batch,
                                    simulate_runtime_ragged)
from repro_torch.kernels import cluster_step as _cs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import skyline as _sky
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.ref import attention_ref_bhsd

__all__ = ["arepas_runtimes", "arepas_runtimes_ragged", "cluster_epoch_step",
           "cluster_resize_step", "flash_attention", "ssd_scan",
           "launch_counts", "reset_launch_counts"]

# bound on one (rows, K, Smax) int64 intermediate of a plain version
_PLAIN_CHUNK_ELEMS = 1 << 24


def _plain_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")


def _row_chunks(n_rows: int, per_row: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, per_row))
    return [slice(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


def arepas_runtimes(skylines: torch.Tensor, valid_lens: torch.Tensor,
                    allocs: torch.Tensor,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bulk AREPAS: (J, Smax) int32 x (J,) int32 x (J, K) int32 -> (J, K)
    int32 simulated runtimes (kernel K1 on the card). With ``rows`` ((J,)
    int64), ``skylines``/``valid_lens`` are a (U, Smax) / (U,) pool and
    output row j reads pool row ``rows[j]``."""
    if skylines.is_cuda:
        return _sky.skyline_runtimes(skylines, valid_lens, allocs, rows)
    _plain_device(skylines, "arepas_runtimes")
    J, K = allocs.shape
    parts = []
    for s in _row_chunks(J, K * skylines.shape[1]):
        r = torch.arange(s.start, s.stop) if rows is None else rows[s]
        parts.append(simulate_runtime_batch(skylines[r], valid_lens[r],
                                            allocs[s]))
    if not parts:
        return torch.empty((0, K), dtype=torch.int32)
    return torch.cat(parts)


def arepas_runtimes_ragged(values: torch.Tensor, offsets: torch.Tensor,
                           allocs: torch.Tensor) -> torch.Tensor:
    """Bulk AREPAS on the ragged layout: flat int32 ``values`` x (J + 1)
    int64 ``offsets`` x (J, K) int32 allocations -> (J, K) int32 runtimes,
    job j's skyline being ``values[offsets[j]:offsets[j + 1]]`` (kernel K1
    on the card, the same kernel as ``arepas_runtimes``). On the CPU the
    plain version pads a chunk of jobs at a time."""
    if values.is_cuda:
        return _sky.skyline_runtimes_ragged(values, offsets, allocs)
    _plain_device(values, "arepas_runtimes_ragged")
    return simulate_runtime_ragged(values, offsets, allocs, _PLAIN_CHUNK_ELEMS)


def cluster_epoch_step(end_s: torch.Tensor, tokens: torch.Tensor,
                       free: torch.Tensor, q_tok: torch.Tensor,
                       q_end: torch.Tensor, now: float):
    """Fused expire -> release -> admit -> scatter over (K, L) lease tables
    (kernel K2 on the card). Returns (new_end, new_tok, slot_of, n_admit,
    adm_tok, freed, n_expired); see ``kernels/cluster_step.py``."""
    if end_s.is_cuda:
        return _cs.epoch_step(end_s, tokens, free, q_tok, q_end, now)
    _plain_device(end_s, "cluster_epoch_step")
    return _cs.epoch_step_ref(end_s, tokens, free, q_tok, q_end, now)


def cluster_resize_step(vecs: torch.Tensor, sky: torch.Tensor,
                        lens: torch.Tensor, now: float, epoch_s: float, *,
                        policy: AllocationPolicy, cap: int) -> torch.Tensor:
    """Fused priced shrink decision + AREPAS re-simulation + repricing per
    candidate (kernel K3 on the card). ``vecs`` is the (9, C) float64 input
    buffer (``cluster_step.RESIZE_ROWS``, built by ``pack_resize``), whose
    last row is each candidate's row of the resident (U, Smax) / (U,)
    ``sky``/``lens`` pool. Returns the packed output, 25 C bytes;
    ``cluster_step.unpack_resize`` views it as (tgt, sel, rt, new_end)."""
    if vecs.is_cuda:
        return _cs.resize_step(vecs, sky, lens, now, epoch_s, policy=policy,
                               cap=cap)
    _plain_device(vecs, "cluster_resize_step")
    *v, rows = _cs.resize_inputs(vecs)
    parts = [_cs.resize_step_ref(*(t[s] for t in v), sky[rows[s]],
                                 lens[rows[s]], now, epoch_s, policy=policy,
                                 cap=cap)
             for s in _row_chunks(vecs.shape[1], sky.shape[1])]
    if not parts:
        parts = [_cs.resize_step_ref(*v, sky[:0], lens[:0], now, epoch_s,
                                     policy=policy, cap=cap)]
    return _cs.pack_resize_outputs(*(torch.cat(p) for p in zip(*parts)))


# ------------------------------------------------------------ autodiff ---
# The kernels carry no backward. As the reference's ``custom_vjp``s do
# (``repro/kernels/ops.py``: ``_flash_bwd``, ``_ssd_bwd``), each
# ``autograd.Function`` saves its inputs, takes its forward value from the
# kernel (the plain version on CPU tensors), and in backward recomputes the
# plain formulation under autograd and returns its vector-Jacobian product.
def _recompute_vjp(fn, inputs, grad_out):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in inputs]
        out = fn(*leaves)
        wrt = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad_out))
    return [next(grads) if t.requires_grad else None for t in leaves]


def _attention_plain_bshd(q, k, v, causal):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return attention_ref_bhsd(qt, kt, vt, causal=causal).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if q.is_cuda:
            return _fa.flash_attention_bshd(q, k, v, causal=causal)
        _plain_device(q, "flash_attention")
        return _attention_plain_bshd(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        causal = ctx.causal
        grads = _recompute_vjp(
            lambda q, k, v: _attention_plain_bshd(q, k, v, causal),
            ctx.saved_tensors, g)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's type
    (kernel K4 on the card). On the CPU: the plain version, through the
    reference wrapper's transposes. Differentiable: the backward recomputes
    through ``attention_ref_bhsd``."""
    return _FlashAttention.apply(q, k, v, causal)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        if x.is_cuda:
            return _ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
        _plain_device(x, "ssd_scan")
        return _ssd_plain(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, g):
        chunk = ctx.chunk
        grads = _recompute_vjp(
            lambda *a: _ssd_plain(*a, chunk), ctx.saved_tensors, g)
        return (*grads, None)


def _ssd_plain(x, dt, A, Bm, Cm, chunk):
    # imported here so that the kernel layer never imports the model layer
    # when it loads (models.lm imports ops)
    from repro_torch.models.layers import ssd_chunked
    return ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]))[0]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD over (B, S, H, P) values (kernel K5 on the card); see
    ``kernels/ssd.py``. On the CPU: the plain version ``ssd_chunked``.
    Differentiable: the backward recomputes through ``ssd_chunked``."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)


def launch_counts() -> Dict[str, int]:
    return {"arepas_runtimes": _sky.launches,
            "cluster_epoch_step": _cs.epoch_launches,
            "cluster_resize_step": _cs.resize_launches,
            "flash_attention": _fa.launches,
            "ssd_scan": _ssd.launches}


def reset_launch_counts() -> None:
    _sky.launches = 0
    _cs.epoch_launches = 0
    _cs.resize_launches = 0
    _fa.launches = 0
    _ssd.launches = 0
