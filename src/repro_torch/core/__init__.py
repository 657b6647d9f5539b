"""TASQ core — the paper's primary contribution, ported to PyTorch.

  arepas     — Area-Preserving Allocation Simulator (Algorithm 1)
  pcc        — performance characteristic curve: fit / predict / optimal point
  featurize  — job-level, operator-level, and graph featurization
  dataset    — observed runs -> bulk AREPAS augmentation -> model-ready arrays
  models     — GBDT ("XGBoost"), NN, SimGNN-style GNN
  losses     — LF1 / LF2 / LF3 constrained losses
  curves     — XGBoost SS / PL curve assembly from point predictions
  evaluate   — the three paper metrics (pattern / param MAE / runtime AE)
  selection  — §5.1 stratified job-selection for ground-truth gathering
  allocator  — optimal-token policies (numpy oracles + float64 torch twins)
               + Figure 2 reduction CDF
  pipeline   — end-to-end orchestration (build -> train -> evaluate)
"""
from repro_torch.core import (arepas, curves, evaluate, featurize, losses,
                              pcc, selection)
from repro_torch.core.allocator import (
    AllocationPolicy,
    build_policy,
    choose_tokens,
    choose_tokens_batch,
    choose_tokens_priced,
    choose_tokens_priced_torch,
    choose_tokens_torch,
    min_tokens_within_slowdown,
    min_tokens_within_slowdown_torch,
    token_reduction_cdf,
)
from repro_torch.core.dataset import TasqDataset, build_dataset
from repro_torch.core.models import PCCModel, available_models, build_model
from repro_torch.core.pipeline import TasqConfig, TasqPipeline

__all__ = [
    "arepas", "curves", "evaluate", "featurize", "losses", "pcc", "selection",
    "AllocationPolicy", "build_policy", "choose_tokens", "choose_tokens_batch",
    "choose_tokens_priced", "choose_tokens_priced_torch",
    "choose_tokens_torch", "min_tokens_within_slowdown",
    "min_tokens_within_slowdown_torch", "token_reduction_cdf",
    "TasqDataset", "build_dataset", "TasqConfig",
    "TasqPipeline", "PCCModel", "available_models", "build_model",
]
