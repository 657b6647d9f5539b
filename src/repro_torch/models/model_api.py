"""Public model API: family dispatch, initialisation and smoke inputs.

The port of ``repro.models.model_api``: ``lm`` for the decoder-only
families, ``encdec`` for whisper. The reference's dry-run surface
(``specs``, ``axes``, ``shardings``, ``input_specs``, ``input_axes``)
comes with the multi-card slice.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.params import init_params

__all__ = ["get_module", "schema", "init", "smoke_batch"]


def get_module(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


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
    """Small concrete batch in the reference's layout, drawn with numpy from
    ``seed`` so that both packages can be fed the same; on the card unless
    ``device="cpu"``. Decoder-only: tokens (B, S), and labels for
    ``"train"``; VLM adds ``patch_embeds`` (B, min(num_patches, S), D) and
    ``positions`` (3, B, S), one ``arange`` three times, as the reference
    gives them. encdec: ``frames`` (B, S, D) in the compute type and
    decoder tokens, 16 with their labels for ``"train"``, else one."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    act = getattr(torch, cfg.compute_dtype)
    on = lambda a, dtype=None: torch.from_numpy(a).to(device, dtype)
    tok = lambda *shape: on(rng.randint(0, cfg.vocab_size, shape).astype(
        np.int32))
    if cfg.family == "encdec":
        frames = on(rng.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32), act)
        if shape_kind == "train":
            return {"frames": frames, "tokens": tok(batch, 16),
                    "labels": tok(batch, 16)}
        return {"frames": frames, "tokens": tok(batch, 1)}
    out = {"tokens": tok(batch, seq)}
    if shape_kind == "train":
        out["labels"] = tok(batch, seq)
    if cfg.family == "vlm":
        n = min(cfg.num_patches, seq)
        out["patch_embeds"] = on(rng.standard_normal(
            (batch, n, cfg.d_model)).astype(np.float32), act)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
        out["positions"] = on(np.stack([pos, pos, pos]))
    return out
