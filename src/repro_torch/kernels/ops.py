"""Public wrappers for the port's kernels.

Each wrapper dispatches on where its tensors lie: a CUDA tensor launches
the hand-written kernel (or the call raises — there is no fallback), a CPU
tensor runs the kernel's plain PyTorch version. ``launch_counts`` reads how
often each kernel was launched; ``reset_launch_counts`` sets the counts to
0, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.arepas import simulate_runtime_batch
from repro_torch.kernels import skyline as _sky

__all__ = ["arepas_runtimes", "launch_counts", "reset_launch_counts"]

# bound on one (jobs, K, Smax) int64 intermediate of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 24


def arepas_runtimes(skylines: torch.Tensor, valid_lens: torch.Tensor,
                    allocs: torch.Tensor) -> torch.Tensor:
    """Bulk AREPAS: (J, Smax) int32 x (J,) int32 x (J, K) int32 -> (J, K)
    int32 simulated runtimes (kernel K1 on the card)."""
    if skylines.is_cuda:
        return _sky.skyline_runtimes(skylines, valid_lens, allocs)
    if skylines.device.type != "cpu":
        raise ValueError(f"arepas_runtimes: unsupported device "
                         f"{skylines.device}")
    J, smax = skylines.shape
    K = allocs.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, K * smax))
    parts = [simulate_runtime_batch(skylines[i:i + step],
                                    valid_lens[i:i + step],
                                    allocs[i:i + step])
             for i in range(0, J, step)]
    if not parts:
        return torch.empty((0, K), dtype=torch.int32)
    return torch.cat(parts)


def launch_counts() -> Dict[str, int]:
    return {"arepas_runtimes": _sky.launches}


def reset_launch_counts() -> None:
    _sky.launches = 0
