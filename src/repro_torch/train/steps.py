"""Step factories: prefill and decode as plain functions.

The port of ``repro.train.steps`` for serving. PyTorch runs eagerly, so
there is nothing to ``jit``; the factories keep the reference's shape
(``fn(params, batch)``) so that ``launch.serve.Server`` reads the same in
both packages. ``make_train_step`` and the train state come with the
training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_api

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig):
    mod = model_api.get_module(cfg)

    def prefill_step(params, batch):
        return mod.prefill(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    mod = model_api.get_module(cfg)

    def decode_step(params, batch):
        cache = batch["cache"]
        rest = {k: v for k, v in batch.items() if k != "cache"}
        return mod.decode_step(params, rest, cache, cfg)

    return decode_step
