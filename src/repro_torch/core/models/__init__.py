"""PCC model zoo: unified interface + registry over GBDT / NN / GNN."""
from repro_torch.core.models.base import (
    GBDTModel,
    GNNModel,
    NNModel,
    PCCModel,
    TorchPCCModel,
    available_models,
    build_model,
    register_model,
)
from repro_torch.core.models.convert import model_from_jax, params_from_jax
from repro_torch.core.models.gbdt import GBDT, GBDTConfig
from repro_torch.core.models.gnn import GNN, GNNConfig
from repro_torch.core.models.nn import MLP, NNConfig, fit_model, param_count

__all__ = [
    "PCCModel",
    "TorchPCCModel",
    "GBDTModel",
    "NNModel",
    "GNNModel",
    "available_models",
    "build_model",
    "register_model",
    "model_from_jax",
    "params_from_jax",
    "GBDT",
    "GBDTConfig",
    "GNN",
    "GNNConfig",
    "MLP",
    "NNConfig",
    "fit_model",
    "param_count",
]
