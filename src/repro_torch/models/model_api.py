"""Public model API: family dispatch, initialisation and smoke inputs.

The port of ``repro.models.model_api`` for the decoder-only ``lm`` module.
The reference's dry-run surface (``specs``, ``axes``, ``shardings``,
``input_specs``, ``input_axes``) comes with the multi-card slice;
whisper's ``encdec`` with its own.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.params import init_params

__all__ = ["get_module", "schema", "init", "smoke_batch"]


def get_module(cfg: ModelConfig):
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder (whisper) comes with a later slice of the port")
    return lm


def schema(cfg: ModelConfig):
    return get_module(cfg).schema(cfg)


def init(cfg: ModelConfig, generator: torch.Generator,
         device: Union[str, torch.device, None] = None):
    """Seeded weights in ``cfg.param_dtype`` on ``device`` (the card unless
    ``"cpu"``), drawn from ``generator`` on its own device (a CUDA
    generator draws on the card) with the reference's law."""
    return init_params(schema(cfg), generator, cfg.param_dtype,
                       resolve_device(device))


def smoke_batch(cfg: ModelConfig, shape_kind: str, seed: int = 0,
                batch: int = 2, seq: int = 64,
                device: Union[str, torch.device, None] = None
                ) -> Dict[str, Any]:
    """Small concrete batch of tokens (and labels for ``"train"``), drawn
    with numpy from ``seed`` so that both packages can be fed the same; on
    the card unless ``device="cpu"``."""
    get_module(cfg)
    device = resolve_device(device)
    if cfg.family == "vlm":
        raise NotImplementedError("VLM inputs (M-RoPE) come with a later slice")
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": torch.from_numpy(tokens).to(device)}
    if shape_kind == "train":
        labels = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out["labels"] = torch.from_numpy(labels).to(device)
    return out
