"""Kernels K2 and K3 — the cluster simulator's fused epoch step and fused
elastic resize on the card (CUDA C++, ``sm_90a``).

They replace the Pallas TPU kernels of ``repro/kernels/cluster_step.py``:
``epoch_step_pallas`` (``_epoch_kernel``) and ``resize_step_pallas``
(``_resize_kernel``). The contract is the reference's float64 jnp twins,
which are what its simulator runs and what its parity tests hold
decision-identical to the unfused loop; the Pallas bodies are f32 only
because Mosaic has no f64. The source is ``repro_torch/csrc/cluster_step.cu``;
its header says what bounds each kernel and what its design does.

``epoch_step_ref`` / ``resize_step_ref`` are the plain PyTorch versions, on
int64 / float64 tensors: the CPU path and the card-side yardstick.
``epoch_step`` / ``resize_step`` take CUDA tensors only, check them,
allocate the outputs, launch on the current stream and raise if the launch
was refused; ``epoch_launches`` / ``resize_launches`` count their launches.
K3 takes its (C,) inputs as one (9, C) buffer of 8-byte rows
(``RESIZE_ROWS``, built by ``pack_resize``) and returns its four outputs
packed in one byte buffer (``unpack_resize``), so that a caller copies
once each way. Callers go through ``kernels/ops.py``, which dispatches on
the device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.allocator import (AllocationPolicy,
                                        choose_tokens_priced_torch)
from repro_torch.core.arepas import simulate_runtime_batch
from repro_torch.kernels import _build

__all__ = ["epoch_step_ref", "resize_step_ref", "epoch_step", "resize_step",
           "EPOCH_STEP_SUPPORTS_PREEMPTION", "cluster_ctas", "epoch_launches",
           "resize_launches", "RESIZE_ROWS", "pack_resize", "unpack_resize",
           "resize_inputs", "pack_resize_outputs"]

# The fused epoch step has no preempt phase: it expires, releases, admits
# and scatters, but cannot checkpoint a victim lease's remaining work back
# into the queue. The simulator consults this flag and falls back to the
# unfused admission loop when preemption is enabled, as the reference does.
EPOCH_STEP_SUPPORTS_PREEMPTION = False

epoch_launches = 0
resize_launches = 0

# K3's inputs: one (9, C) buffer of 8-byte rows in this order; the int64
# rows hold int64 bits in a float64 buffer (a view of it as int64 reads
# them). The last row is each candidate's row of the skyline pool.
RESIZE_ROWS = ("a", "b", "price", "obs", "floor", "done", "cand_tok",
               "cand_end", "rows")
_RESIZE_INT = frozenset({"obs", "floor", "cand_tok", "rows"})
# K3's outputs, packed: tgt (C int64), rt (C int64), new_end (C float64),
# sel (C bytes, 0 or 1), 25 C bytes.
_RESIZE_OUT_BYTES = 25


def pack_resize(a, b, price, obs, floor, done, cand_tok, cand_end, rows,
                out=None) -> np.ndarray:
    """K3's (C,) inputs (array-likes) as one (9, C) float64 host array in
    ``RESIZE_ROWS`` order, the int64 rows stored as their bits. ``out``, a
    (9, C) float64 array (a pinned staging tensor's numpy view, say), is
    filled and returned."""
    vals = (a, b, price, obs, floor, done, cand_tok, cand_end, rows)
    if out is None:
        out = np.empty((len(RESIZE_ROWS), len(vals[0])), np.float64)
    ints = out.view(np.int64)
    for i, (name, v) in enumerate(zip(RESIZE_ROWS, vals)):
        if name in _RESIZE_INT:
            ints[i] = v
        else:
            out[i] = v
    return out


def resize_inputs(vecs: torch.Tensor):
    """The nine (C,) rows of a packed (9, C) K3 input tensor, each in its
    own type (views, no copies), in ``RESIZE_ROWS`` order."""
    ints = vecs.view(torch.int64)
    return tuple(ints[i] if name in _RESIZE_INT else vecs[i]
                 for i, name in enumerate(RESIZE_ROWS))


def pack_resize_outputs(tgt, sel, rt, new_end) -> torch.Tensor:
    """(tgt, sel, rt, new_end) in K3's packed output layout."""
    return torch.cat([t.contiguous().view(torch.uint8)
                      for t in (tgt, rt, new_end, sel)])


def unpack_resize(out: torch.Tensor):
    """(tgt int64, sel bool, rt int64, new_end float64), each (C,): views
    of K3's packed output, a uint8 tensor of 25 C bytes."""
    C = out.shape[0] // _RESIZE_OUT_BYTES
    return (out[:8 * C].view(torch.int64), out[24 * C:].view(torch.bool),
            out[8 * C:16 * C].view(torch.int64),
            out[16 * C:24 * C].view(torch.float64))


# ------------------------------------------------------- plain versions ---
def epoch_step_ref(end_s: torch.Tensor, tokens: torch.Tensor,
                   free: torch.Tensor, q_tok: torch.Tensor,
                   q_end: torch.Tensor, now: float):
    """Fused epoch step: expire -> release -> admit -> scatter.

    end_s/tokens: (K, L) float64 / int64 lease tables (inf / 0 in empty
    slots); free: (K,) int64 free tokens before this epoch's expiry;
    q_tok/q_end: (K, Q) policy-ordered queue heads, zero-padded past each
    shard's queue (``q_end[k, i]`` is the lease end query i gets if
    admitted now); now: the epoch timestamp.

    Returns (new_end, new_tok, slot_of, n_admit, adm_tok, freed,
    n_expired): the updated tables, the int32 lease slot each queue
    position landed in (-1 if not admitted), and (K,) int64 per-shard
    totals. Position i is admitted iff its prefix sum of tokens fits
    ``free + freed``, it holds tokens, and i is below the post-expiry open
    lease slots; the i-th admitted query takes the i-th free slot in slot
    order.
    """
    K, L = end_s.shape
    Q = q_tok.shape[1]
    if Q == 0:            # nothing to admit; the gathers below read column 0
        q_tok, q_end = q_tok.new_zeros((K, 1)), q_end.new_zeros((K, 1))
    expired = (tokens > 0) & (end_s <= now)
    freed = torch.where(expired, tokens, 0).sum(1)
    n_expired = expired.sum(1)
    tok1 = torch.where(expired, 0, tokens)
    end1 = torch.where(expired, math.inf, end_s)

    free_after = free + freed
    open_slots = (tok1 == 0).sum(1)
    csum = torch.cumsum(q_tok, 1)
    qidx = torch.arange(q_tok.shape[1], device=q_tok.device)
    adm = ((csum <= free_after[:, None]) & (q_tok > 0)
           & (qidx[None, :] < open_slots[:, None]))
    n_admit = adm.sum(1)
    adm_tok = torch.where(adm, q_tok, 0).sum(1)

    free_slot = tok1 == 0
    rank = torch.cumsum(free_slot.to(torch.int64), 1) - 1  # slot-order rank
    take = free_slot & (rank < n_admit[:, None])
    src = rank.clamp(0, max(Q - 1, 0))
    new_tok = torch.where(take, torch.gather(q_tok, 1, src), tok1)
    new_end = torch.where(take, torch.gather(q_end, 1, src), end1)

    # invert slot -> queue rank into queue rank -> slot via a dummy column
    col = torch.where(take, src, Q)
    slot_of = torch.full((K, Q + 1), -1, dtype=torch.int32,
                         device=q_tok.device)
    slot_of.scatter_(1, col, torch.arange(L, dtype=torch.int32,
                                          device=q_tok.device).expand(K, L))
    return (new_end, new_tok, slot_of[:, :Q].contiguous(), n_admit, adm_tok,
            freed, n_expired)


def resize_step_ref(a: torch.Tensor, b: torch.Tensor, price: torch.Tensor,
                    obs: torch.Tensor, floor: torch.Tensor,
                    done: torch.Tensor, cand_tok: torch.Tensor,
                    cand_end: torch.Tensor, sky: torch.Tensor,
                    lens: torch.Tensor, now: float, epoch_s: float, *,
                    policy: AllocationPolicy, cap: int):
    """Fused elastic resize: priced decision + AREPAS + reprice.

    Per-candidate (C,) float64 PCC params / price / completed-work
    fraction / lease end, int64 observed tokens / deadline floor / current
    lease, plus (C, Smax) padded skylines and (C,) lengths. Returns (tgt,
    sel, rt, new_end): the int64 shrunk allocation, the bool
    shrink-worthwhile mask, the int64 re-simulated runtime at ``tgt`` and
    the float64 repriced lease end.
    """
    tgt = torch.clamp(choose_tokens_priced_torch(a, b, policy, price, obs),
                      max=cap)
    tgt = torch.maximum(tgt, floor.to(tgt.dtype))
    sel = (tgt < cand_tok) & ((cand_end - now) > epoch_s)
    rt = simulate_runtime_batch(sky, lens, tgt.clamp(min=1)[:, None])[:, 0]
    rt = rt.clamp(min=1).to(cand_tok.dtype)
    remaining = torch.round(rt.to(a.dtype) * (1.0 - done)).clamp(min=1.0)
    return tgt, sel, rt, now + remaining


# ------------------------------------------------------------- launches ---
_loaded = None


def _lib():
    global _loaded
    if _loaded is None:
        _loaded = _bind(_build.load("cluster_step"))
    return _loaded


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (``csrc/cluster_step.cu`` as built, perhaps with other
    compile-time constants) with its C interface typed."""
    lib.epoch_step_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_double] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.epoch_step_launch.restype = ctypes.c_int
    lib.resize_step_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_double] * 4
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 2)
    lib.resize_step_launch.restype = ctypes.c_int
    return lib


def cluster_ctas() -> int:
    """The CTAs of a shard's thread-block cluster in K2's built library
    (``K2_CLUSTER_CTAS`` in ``csrc/cluster_step.cu``, 8 by default)."""
    return int(_lib().epoch_step_cluster_ctas())


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def epoch_step(end_s: torch.Tensor, tokens: torch.Tensor, free: torch.Tensor,
               q_tok: torch.Tensor, q_end: torch.Tensor, now: float):
    """Kernel K2: ``epoch_step_ref``'s contract on CUDA tensors."""
    global epoch_launches
    dev = end_s.device
    if dev.type != "cuda":
        raise ValueError(f"epoch_step runs on the card; got {dev}")
    K, L = end_s.shape
    Q = q_tok.shape[1]
    _check("end_s", end_s, (K, L), torch.float64, dev)
    _check("tokens", tokens, (K, L), torch.int64, dev)
    _check("free", free, (K,), torch.int64, dev)
    _check("q_tok", q_tok, (K, Q), torch.int64, dev)
    _check("q_end", q_end, (K, Q), torch.float64, dev)
    if max(K, L, Q) >= 2**31:
        raise ValueError("dimensions must fit in int32")
    new_end = torch.empty_like(end_s)
    new_tok = torch.empty_like(tokens)
    slot_of = torch.empty((K, Q), dtype=torch.int32, device=dev)
    vecs = torch.empty((4, K), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().epoch_step_launch(
            end_s.data_ptr(), tokens.data_ptr(), free.data_ptr(),
            q_tok.data_ptr(), q_end.data_ptr(), float(now),
            new_end.data_ptr(), new_tok.data_ptr(), slot_of.data_ptr(),
            vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
            vecs[3].data_ptr(), K, L, Q,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"epoch_step_kernel launch failed (cluster of "
                           f"{cluster_ctas()} CTAs): cudaError {err}")
    epoch_launches += 1
    n_admit, adm_tok, freed, n_expired = vecs
    return new_end, new_tok, slot_of, n_admit, adm_tok, freed, n_expired


def resize_step(vecs: torch.Tensor, sky: torch.Tensor, lens: torch.Tensor,
                now: float, epoch_s: float, *, policy: AllocationPolicy,
                cap: int) -> torch.Tensor:
    """Kernel K3: ``resize_step_ref``'s contract on CUDA tensors. ``vecs``
    is the (9, C) float64 input buffer (``RESIZE_ROWS``; ``pack_resize``);
    ``sky``/``lens`` are a resident (U, Smax) / (U,) pool and candidate c
    reads its pool row, ``vecs``' last row (the caller keeps every index
    inside the pool: the launch does not check). Returns the packed
    25 C-byte output (``unpack_resize``)."""
    global resize_launches
    dev = vecs.device
    if dev.type != "cuda":
        raise ValueError(f"resize_step runs on the card; got {dev}")
    C = vecs.shape[-1]
    U, smax = sky.shape
    _check("vecs", vecs, (len(RESIZE_ROWS), C), torch.float64, dev)
    _check("sky", sky, (U, smax), torch.int32, dev)
    _check("lens", lens, (U,), torch.int32, dev)
    if max(C, U, smax) >= 2**31:
        raise ValueError("dimensions must fit in int32")
    out = torch.empty(_RESIZE_OUT_BYTES * C, dtype=torch.uint8, device=dev)
    if C == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().resize_step_launch(
            vecs.data_ptr(), sky.data_ptr(), lens.data_ptr(), float(now),
            float(epoch_s), max(policy.min_gain, 1e-9),
            float(policy.max_slowdown), int(policy.min_tokens),
            int(policy.max_tokens), int(cap), C, smax, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize_step_kernel launch failed: cudaError "
                           f"{err}")
    resize_launches += 1
    return out
