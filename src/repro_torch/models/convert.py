"""Carry the reference's LM weights into the port.

``params_from_jax`` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``; bf16 leaves may
arrive as float32, which holds every bf16 value exactly) and returns the
same tree of tensors in the config's ``param_dtype`` on ``device``. The
layouts agree: both packages keep (in, out) weight matrices stacked over a
leading layer axis. This module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: Union[str, torch.device, None] = None):
    """On the card unless ``device="cpu"``."""
    dtype = getattr(torch, cfg.param_dtype)
    device = resolve_device(device)

    def one(x):
        if isinstance(x, Mapping):
            return {k: one(v) for k, v in x.items()}
        a = np.array(x, dtype=np.float32)          # a writable copy
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return one(tree)
