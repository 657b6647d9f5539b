"""Carry a model trained by the JAX reference into the port.

The reference keeps parameters as nested dicts of arrays with (in, out)
weight matrices; the port keeps ``nn.Module`` state with ``nn.Linear``'s
(out, in) weights. ``params_from_jax`` maps one onto the other, so both
packages compute the same function from the same numbers;
``model_from_jax`` also carries the ``Standardizer`` and ``PCCScaler``
across. Objects of the reference are read by attribute only: this module
imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.featurize import Standardizer
from repro_torch.core.losses import LossWeights
from repro_torch.core.models.base import TorchPCCModel, build_model
from repro_torch.core.models.gnn import GNN, GNNConfig
from repro_torch.core.models.nn import MLP, NNConfig
from repro_torch.core.pcc import PCCScaler

__all__ = ["params_from_jax", "scaler_from_jax", "standardizer_from_jax",
           "model_from_jax"]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _mlp_state(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    state = {}
    for i in range(len(params)):
        layer = params[f"l{i}"]
        state[f"{prefix}layers.{i}.weight"] = _t(layer["w"]).T.contiguous()
        state[f"{prefix}layers.{i}.bias"] = _t(layer["b"])
    return state


def params_from_jax(family: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's ``nn`` / ``gnn`` params -> the port module's
    ``state_dict`` (float32 CPU tensors)."""
    if family == "nn":
        return _mlp_state(params, "")
    if family == "gnn":
        state = {}
        for i in range(len(params["gcn"])):
            layer = params["gcn"][f"g{i}"]
            state[f"gcn.{i}.weight"] = _t(layer["w"]).T.contiguous()
            state[f"gcn.{i}.bias"] = _t(layer["b"])
        state["w_ctx"] = _t(params["w_ctx"])
        state.update(_mlp_state(params["head"], "head."))
        return state
    raise KeyError(f"no parameter layout for family {family!r}; "
                   "known: ('gnn', 'nn')")


def scaler_from_jax(scaler: Any) -> PCCScaler:
    return PCCScaler(float(scaler.mu_a), float(scaler.sd_a),
                     float(scaler.mu_b), float(scaler.sd_b))


def standardizer_from_jax(std: Any) -> Standardizer:
    out = Standardizer.__new__(Standardizer)
    out.mu = np.array(std.mu)
    out.sd = np.array(std.sd)
    return out


def _config(cls, ref_cfg: Any):
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(cls)}
    if "weights" in kw:
        w = kw["weights"]
        kw["weights"] = LossWeights(float(w.w_runtime), float(w.w_distill))
    return cls(**kw)


def model_from_jax(ref_model: Any, device=None) -> TorchPCCModel:
    """A trained reference ``NNModel`` / ``GNNModel`` as the port's model
    on ``device``, serving the same function."""
    family = ref_model.family
    state = params_from_jax(family, ref_model.params)
    scaler = scaler_from_jax(ref_model.scaler)
    std = standardizer_from_jax(ref_model.std)
    if family == "nn":
        cfg = _config(NNConfig, ref_model.cfg)
        model: TorchPCCModel = build_model("nn", cfg=cfg, device=device)
        module = MLP(state["layers.0.weight"].shape[1], cfg.hidden)
    elif family == "gnn":
        cfg = _config(GNNConfig, ref_model.cfg)
        model = build_model("gnn", cfg=cfg,
                            train_cfg=_config(NNConfig, ref_model.train_cfg),
                            device=device)
        module = GNN(state["gcn.0.weight"].shape[1], cfg)
    else:
        raise KeyError(f"cannot carry family {family!r} across")
    module.load_state_dict(state)
    return model.load(module, scaler=scaler, std=std)
