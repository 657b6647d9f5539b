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
        # encoder consumes S frames; decoder consumes DEC_LEN (448) tokens.
        from repro_torch.models.encdec import DEC_LEN
        d, f = cfg.d_model, cfg.d_ff
        enc_per_layer = 4 * d * d + 2 * d * f
        n_enc = cfg.encoder_layers * enc_per_layer
        n_dec = n_active - n_enc
        mult = 6.0 if shape.kind == "train" else 2.0
        if shape.kind == "decode":
            return 2.0 * n_dec * B
        return mult * (n_enc * B * S + n_dec * B * min(DEC_LEN, S))
    if shape.kind == "train":
        return 6.0 * n_active * B * S
    if shape.kind == "prefill":
        return 2.0 * n_active * B * S
    # decode: one new token per sequence against the cache
    return 2.0 * n_active * B
