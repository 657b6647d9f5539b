"""Analytic MODEL_FLOPS per step: 6*N*D (train) / 2*N*D (inference forward),
with N = active parameter count (MoE: top-k experts only) and D = tokens
processed by the step. A copy of ``repro/roofline/model_flops.py``, the
"useful compute" yardstick of a step's share of the card's peak rate."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["model_flops"]


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder (whisper) comes with a later slice of the port")
    if shape.kind == "train":
        return 6.0 * n_active * B * S
    if shape.kind == "prefill":
        return 2.0 * n_active * B * S
    # decode: one new token per sequence against the cache
    return 2.0 * n_active * B
