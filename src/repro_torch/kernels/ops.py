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
from repro_torch.core.arepas import simulate_runtime_batch
from repro_torch.kernels import cluster_step as _cs
from repro_torch.kernels import skyline as _sky

__all__ = ["arepas_runtimes", "cluster_epoch_step", "cluster_resize_step",
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


def cluster_resize_step(a, b, price, obs, floor, done, cand_tok, cand_end,
                        sky, lens, now: float, epoch_s: float, *,
                        policy: AllocationPolicy, cap: int,
                        rows: torch.Tensor):
    """Fused priced shrink decision + AREPAS re-simulation + repricing per
    candidate (kernel K3 on the card). Returns (tgt, sel, rt, new_end),
    each (C,); see ``kernels/cluster_step.py``. ``sky``/``lens`` are a
    resident (U, Smax) / (U,) pool and candidate c reads row ``rows[c]``
    (``rows`` (C,) int64)."""
    if a.is_cuda:
        return _cs.resize_step(a, b, price, obs, floor, done, cand_tok,
                               cand_end, sky, lens, now, epoch_s,
                               policy=policy, cap=cap, rows=rows)
    _plain_device(a, "cluster_resize_step")
    C = a.shape[0]
    parts = []
    for s in _row_chunks(C, sky.shape[1]):
        parts.append(_cs.resize_step_ref(
            a[s], b[s], price[s], obs[s], floor[s], done[s], cand_tok[s],
            cand_end[s], sky[rows[s]], lens[rows[s]], now, epoch_s,
            policy=policy, cap=cap))
    if not parts:
        return _cs.resize_step_ref(a, b, price, obs, floor, done, cand_tok,
                                   cand_end, sky[:0], lens[:0], now, epoch_s,
                                   policy=policy, cap=cap)
    return tuple(torch.cat(p) for p in zip(*parts))


def launch_counts() -> Dict[str, int]:
    return {"arepas_runtimes": _sky.launches,
            "cluster_epoch_step": _cs.epoch_launches,
            "cluster_resize_step": _cs.resize_launches}


def reset_launch_counts() -> None:
    _sky.launches = 0
    _cs.epoch_launches = 0
    _cs.resize_launches = 0
