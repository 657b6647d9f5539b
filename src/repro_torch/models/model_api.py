"""Public model API: family dispatch, initialisation, input specs and
smoke inputs.

The port of ``repro.models.model_api``: ``lm`` for the decoder-only
families, ``encdec`` for whisper. ``specs`` and ``input_specs`` are
``meta`` tensors (the reference's ``ShapeDtypeStruct`` stand-ins: shapes
and dtypes, zero allocation), ``axes`` and ``input_axes`` the matching
logical axes, ``shardings`` each parameter's DTensor placements on a
mesh; ``distribute`` puts a tree of full tensors onto a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.lm import Cache
from repro_torch.models.params import (init_params, param_axes, param_shapes,
                                       param_shardings)

__all__ = ["get_module", "schema", "init", "specs", "axes", "shardings",
           "input_specs", "input_axes", "batch_axes", "distribute",
           "smoke_batch"]


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


def specs(cfg: ModelConfig):
    """Parameter ``meta`` tensors: the dry run's stand-in for weights."""
    return param_shapes(schema(cfg), cfg.param_dtype)


def axes(cfg: ModelConfig):
    return param_axes(schema(cfg))


def shardings(cfg: ModelConfig, mesh):
    return param_shardings(schema(cfg), mesh, cfg.rules())


def distribute(tree, placements, mesh):
    """Each tensor of ``tree`` (a nested dict of full tensors) as a DTensor
    on ``mesh`` with the placements of the same leaf of ``placements``,
    cut from its own full copy (every rank holds the same tensor, as
    seeded weights and a restored checkpoint do)."""
    if isinstance(tree, dict):
        return {k: distribute(tree[k], placements[k], mesh) for k in tree}
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


# ------------------------------------------------------------ input specs --
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs for one cell as ``meta`` tensors, with the dtypes of
    the reference's ``ShapeDtypeStruct``s. For decode kinds this includes
    the cache."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.compute_dtype)
    meta = lambda *s, dt=torch.int32: torch.empty(s, dtype=dt, device="meta")
    tok = lambda *s: meta(*s)

    if cfg.family == "encdec":
        if shape.kind == "train":
            return {"frames": meta(B, S, cfg.d_model, dt=act),
                    "tokens": tok(B, encdec.DEC_LEN),
                    "labels": tok(B, encdec.DEC_LEN)}
        if shape.kind == "prefill":
            return {"frames": meta(B, S, cfg.d_model, dt=act),
                    "tokens": tok(B, 1)}
        return {"tokens": tok(B, 1), "cache": encdec.cache_specs(cfg, B, S)}

    batch: Dict[str, Any] = {}
    if shape.kind == "train":
        batch["tokens"] = tok(B, S)
        batch["labels"] = tok(B, S)
    elif shape.kind == "prefill":
        batch["tokens"] = tok(B, S)
    else:  # decode: one new token against a cache of S
        batch["tokens"] = tok(B, 1)
        batch["cache"] = lm.cache_specs(cfg, B, S)

    if cfg.family == "vlm":
        if shape.kind in ("train", "prefill"):
            batch["patch_embeds"] = meta(B, min(cfg.num_patches, S),
                                         cfg.d_model, dt=act)
            batch["positions"] = tok(3, B, S)
        else:
            batch["positions"] = tok(3, B, 1)
    return batch


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Logical axes matching ``input_specs``."""
    if cfg.family == "encdec":
        if shape.kind == "train":
            return {"frames": ("batch", None, None),
                    "tokens": ("batch", None), "labels": ("batch", None)}
        if shape.kind == "prefill":
            return {"frames": ("batch", None, None), "tokens": ("batch", None)}
        return {"tokens": ("batch", None), "cache": encdec.cache_axes()}

    if shape.kind == "train":
        ax = {"tokens": ("batch", None), "labels": ("batch", None)}
    elif shape.kind == "prefill":
        ax = {"tokens": ("batch", None)}
    else:
        ax = {"tokens": ("batch", None), "cache": lm.cache_axes(cfg)}
    if cfg.family == "vlm":
        if shape.kind in ("train", "prefill"):
            ax["patch_embeds"] = ("batch", None, None)
            ax["positions"] = (None, "batch", None)
        else:
            ax["positions"] = (None, "batch", None)
    return ax


_BATCH_AXES = {"tokens": ("batch", None), "labels": ("batch", None),
               "frames": ("batch", None, None),
               "patch_embeds": ("batch", None, None),
               "positions": (None, "batch", None)}


def batch_axes(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The logical axes of a concrete batch's leaves, by name (the
    ``input_axes`` of whatever kind and family the batch is)."""
    return {k: _BATCH_AXES[k] for k in batch}


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
