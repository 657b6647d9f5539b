"""The one rule for where the port runs.

Entry points take ``device=`` (default ``"cuda"``) and pass it through
``resolve_device``. Asking for the card where there is none is an error,
never a silent move to the CPU: a run that meant to measure or exercise
the card must not finish on the host.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs a CUDA card, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the host")
    return dev
