"""Unified PCCModel interface + registry (paper §2.2 deploy/allocate stage).

Every model family — GBDT, NN, GNN — predicts a job's performance
characteristic curve ``runtime = b * A^a``; they only differ in what they
consume (aggregated features vs padded plan graphs) and how the (a, b) pair
is produced (batched power-law fit over point predictions vs a decoded
parameter head). ``PCCModel`` pins down one surface for all of them:

  * ``fit(ds, scaler=..., std=...)``        — train on a ``TasqDataset``;
  * ``batch_inputs(ds)``                    — model-ready input arrays;
  * ``predict_params_batch(model_in, ...)`` — (a, b) for a raw batch;
  * ``predict_params(ds)``                  — (a, b) for a dataset;
  * device surface (``supports_fused`` / ``serve_apply``) — a torch
    function ``model_in -> scaled z`` on the model's device, which the
    AllocationService follows with decode and the float64 allocation policy
    without leaving the device.

The registry follows the reference's build-config idiom: a string key
resolves a builder (``build_model("gnn", cfg=..., device=...)``).
``TorchPCCModel`` takes the place of the reference's ``JaxPCCModel``.
"""
from __future__ import annotations

import abc
import itertools
from typing import (Any, Callable, ClassVar, Dict, Optional, Tuple,
                    TYPE_CHECKING, Union)

import numpy as np
import torch
from torch import nn

from repro_torch.core.curves import prediction_fan
from repro_torch.core.featurize import Standardizer
from repro_torch.core.models.gbdt import GBDT, GBDTConfig
from repro_torch.core.models.gnn import GNN, GNNConfig
from repro_torch.core.models.nn import MLP, NNConfig, fit_model
from repro_torch.core.pcc import PCCScaler, fit_pcc_batch_np
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # avoid a runtime cycle: dataset -> featurize only
    from repro_torch.core.dataset import TasqDataset

__all__ = [
    "PCCModel",
    "TorchPCCModel",
    "GBDTModel",
    "NNModel",
    "GNNModel",
    "register_model",
    "build_model",
    "available_models",
]

Device = Union[str, torch.device, None]

_serial = itertools.count()


class PCCModel(abc.ABC):
    """One trained PCC predictor: dataset in, power-law (a, b) out."""

    family: ClassVar[str] = ""

    def __init__(self, device: Device = None) -> None:
        self.device = resolve_device(device)
        self.scaler: Optional[PCCScaler] = None
        self.std: Optional[Standardizer] = None
        self.history: Dict[str, Any] = {}
        # unique per instance: the AllocationService keys its fused
        # executables on it
        self.cache_key: str = f"{self.family}#{next(_serial)}"

    # ------------------------------------------------------------- training --
    @abc.abstractmethod
    def fit(self, ds: "TasqDataset", *, scaler: PCCScaler, std: Standardizer,
            xgb_runtime: Optional[np.ndarray] = None) -> "PCCModel":
        """Train on a dataset. ``xgb_runtime`` feeds the LF3 distillation."""

    # ------------------------------------------------------------ inference --
    @abc.abstractmethod
    def batch_inputs(self, ds: "TasqDataset") -> Dict[str, np.ndarray]:
        """Raw model inputs for a dataset (what ``serve_apply`` consumes)."""

    @abc.abstractmethod
    def predict_params_batch(self, model_in: Dict[str, np.ndarray],
                             ref_alloc: Optional[np.ndarray] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """(a, b) for a raw input batch. ``ref_alloc`` anchors models that
        assemble curves from point predictions (GBDT's prediction fan)."""

    def predict_params(self, ds: "TasqDataset"
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return self.predict_params_batch(self.batch_inputs(ds),
                                         np.asarray(ds.observed_alloc))

    # -------------------------------------------------------- device surface --
    @property
    def supports_fused(self) -> bool:
        """True if ``serve_apply`` runs on the device."""
        return False

    def serve_apply(self, model_in: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, ...) input tensors on the device -> (B, 2) scaled z.
        Standardizes inside, so serving starts from raw features."""
        raise NotImplementedError(f"{self.family} has no device surface")


class TorchPCCModel(PCCModel):
    """Shared device surface for parameter-head models (NN / GNN).

    Inference runs in fixed-size chunks: batches are cut at ``_CHUNK`` rows
    and each chunk is zero-padded to a power-of-two bucket, so memory stays
    bounded at paper scale (the GCN's B*N*N activations would otherwise
    materialize for the whole corpus at once) and the set of shapes stays
    small. Padded rows are inert and sliced off.
    """

    _CHUNK = 1024

    def __init__(self, device: Device = None) -> None:
        super().__init__(device)
        self.module: Optional[nn.Module] = None

    @property
    def supports_fused(self) -> bool:
        return self.module is not None

    @staticmethod
    def _bucket(n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return p

    def to_device(self, model_in: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in model_in.items()}

    @torch.inference_mode()
    def _predict_z(self, model_in: Dict[str, np.ndarray]) -> np.ndarray:
        arrays = {k: np.asarray(v) for k, v in model_in.items()}
        B = next(iter(arrays.values())).shape[0]
        zs = []
        for i in range(0, B, self._CHUNK):
            chunk = {k: v[i:i + self._CHUNK] for k, v in arrays.items()}
            n = next(iter(chunk.values())).shape[0]
            bp = self._bucket(n)
            if bp != n:
                chunk = {k: np.pad(v, [(0, bp - n)] + [(0, 0)] * (v.ndim - 1))
                         for k, v in chunk.items()}
            z = self.serve_apply(self.to_device(chunk))
            zs.append(z[:n].cpu().numpy())
        return np.concatenate(zs) if len(zs) > 1 else zs[0]

    def predict_params_batch(self, model_in, ref_alloc=None):
        a, b = self.scaler.decode(torch.from_numpy(self._predict_z(model_in)))
        return a.numpy(), b.numpy()

    def load(self, module: nn.Module, *, scaler: PCCScaler,
             std: Standardizer) -> "TorchPCCModel":
        """Serve an already-trained module (see ``convert.model_from_jax``)."""
        self.scaler, self.std = scaler, std
        self.module = module.to(self.device)
        return self


# ------------------------------------------------------------------ registry --
_REGISTRY: Dict[str, Callable[..., PCCModel]] = {}


def register_model(name: str):
    """Class decorator: ``@register_model("nn")`` exposes the family to
    ``build_model``."""
    def deco(cls):
        cls.family = name
        _REGISTRY[name] = cls
        return cls
    return deco


def build_model(name: str, **kwargs) -> PCCModel:
    """Construct an untrained PCCModel by family name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown PCC model {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# -------------------------------------------------------------------- GBDT ---
@register_model("gbdt")
class GBDTModel(PCCModel):
    """Histogram-GBDT point predictor -> per-job power-law fit.

    Plays XGBoost's role: predicts runtime at (features ++ log1p tokens)
    points; ``predict_params_batch`` assembles the PL curve from a prediction
    fan around the reference allocation in ONE vectorized pass. Runs on the
    host (numpy); the service decides its (a, b) on the device.
    """

    def __init__(self, cfg: GBDTConfig = GBDTConfig(), device: Device = None):
        super().__init__(device)
        self.cfg = cfg
        self.booster: Optional[GBDT] = None

    def fit(self, ds, *, scaler, std, xgb_runtime=None):
        self.scaler, self.std = scaler, std
        X = ds.xgb_X.copy()
        X[:, :-1] = std(X[:, :-1])
        self.booster = GBDT(self.cfg).fit(X, ds.xgb_y)
        return self

    def batch_inputs(self, ds):
        return {"features": np.asarray(ds.features)}

    def point_predictor(self) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
        """(feature_rows, allocs) -> runtimes, for SS-curve assembly."""
        def f(rows: np.ndarray, allocs: np.ndarray) -> np.ndarray:
            X = np.concatenate(
                [self.std(rows),
                 np.log1p(allocs.astype(np.float64))[:, None]], 1)
            return self.booster.predict(X)
        return f

    def runtime_at(self, ds) -> np.ndarray:
        """Predicted runtime at each job's observed allocation (LF3 teacher)."""
        feats = self.std(ds.features)
        X = np.concatenate([feats, np.log1p(ds.observed_alloc)[:, None]], 1)
        return self.booster.predict(X).astype(np.float32)

    def predict_params_batch(self, model_in, ref_alloc=None):
        feats = np.asarray(model_in["features"])
        if ref_alloc is None:
            raise ValueError("gbdt needs ref_alloc (fan reference) to "
                             "assemble PCC parameters")
        ref = np.asarray(ref_alloc, np.float64)
        B = feats.shape[0]
        fans = np.stack([prediction_fan(r) for r in ref])
        K = fans.shape[1]
        rows = np.repeat(self.std(feats), K, axis=0)
        X = np.concatenate(
            [rows, np.log1p(fans.astype(np.float64)).reshape(-1, 1)], 1)
        preds = self.booster.predict(X).reshape(B, K)
        return fit_pcc_batch_np(fans, preds)


# ---------------------------------------------------------------------- NN ---
@register_model("nn")
class NNModel(TorchPCCModel):
    """Feed-forward MLP over aggregated job features -> scaled PCC params."""

    def __init__(self, cfg: NNConfig = NNConfig(), device: Device = None):
        super().__init__(device)
        self.cfg = cfg
        self._mu: Optional[torch.Tensor] = None
        self._sd: Optional[torch.Tensor] = None

    def fit(self, ds, *, scaler, std, xgb_runtime=None):
        g = torch.Generator().manual_seed(self.cfg.seed)
        module = MLP(ds.features.shape[1], self.cfg.hidden, generator=g)
        self.load(module, scaler=scaler, std=std)
        extras = _loss_extras(ds, scaler, xgb_runtime)
        self.history = fit_model(
            lambda m, mi: m(mi["features"]), self.module,
            {"features": std(ds.features)}, extras, scaler, self.cfg)
        return self

    def load(self, module, *, scaler, std):
        self._mu = torch.from_numpy(std.mu.astype(np.float32)).to(self.device)
        self._sd = torch.from_numpy(std.sd.astype(np.float32)).to(self.device)
        return super().load(module, scaler=scaler, std=std)

    def serve_apply(self, model_in):
        x = (model_in["features"].to(torch.float32) - self._mu) / self._sd
        return self.module(x)

    def batch_inputs(self, ds):
        return {"features": np.asarray(ds.features, np.float32)}


# --------------------------------------------------------------------- GNN ---
@register_model("gnn")
class GNNModel(TorchPCCModel):
    """SimGNN-style GCN over padded plan graphs -> scaled PCC params."""

    def __init__(self, cfg: GNNConfig = GNNConfig(),
                 train_cfg: NNConfig = NNConfig(), device: Device = None):
        super().__init__(device)
        self.cfg = cfg
        self.train_cfg = train_cfg

    def fit(self, ds, *, scaler, std, xgb_runtime=None):
        g = torch.Generator().manual_seed(self.cfg.seed)
        self.load(GNN(ds.graph_features.shape[-1], self.cfg, generator=g),
                  scaler=scaler, std=std)
        extras = _loss_extras(ds, scaler, xgb_runtime)
        inputs = {"features": ds.graph_features, "adj": ds.graph_adj,
                  "mask": ds.graph_mask}
        self.history = fit_model(lambda m, mi: m(mi), self.module, inputs,
                                 extras, scaler, self.train_cfg)
        return self

    def serve_apply(self, model_in):
        return self.module({k: v.to(torch.float32)
                            for k, v in model_in.items()})

    def batch_inputs(self, ds):
        return {"features": np.asarray(ds.graph_features, np.float32),
                "adj": np.asarray(ds.graph_adj, np.float32),
                "mask": np.asarray(ds.graph_mask, np.float32)}


def _loss_extras(ds, scaler: PCCScaler,
                 xgb_runtime: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    return {
        "target_z": scaler.encode(ds.target_a, ds.target_b),
        "observed_alloc": ds.observed_alloc,
        "observed_runtime": ds.observed_runtime,
        "xgb_runtime": (xgb_runtime if xgb_runtime is not None
                        else ds.observed_runtime),
    }
