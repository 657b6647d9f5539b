"""TASQ end-to-end pipeline (paper §2.2, Figure: workload repo -> featurize ->
train -> deploy -> allocate).

One object wires the full reproduction:
  corpus -> observed runs -> AREPAS augmentation (kernel K1 on the card) ->
  featurization -> PCCModel zoo {gbdt, nn, gnn} x {LF1, LF2, LF3} ->
  Tables 4-6 metrics -> allocation decisions; Table 8's ground truth from
  §5.1 re-executions (``ground_truth_records``).

Keys in ``self.models`` are ``"gbdt"`` / ``"nn:<loss>"`` / ``"gnn:<loss>"``,
as in the reference. ``device`` (default ``"cuda"``) is where augmentation
and the NN / GNN run; the GBDT and the featurization run on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api._compat import warn_deprecated
from repro_torch.core.dataset import TasqDataset, build_dataset
from repro_torch.core.evaluate import (CurveEval, eval_pcc_model,
                                       eval_xgb_curves)
from repro_torch.core.featurize import Standardizer
from repro_torch.core.models import (GBDTConfig, GNNConfig, NNConfig,
                                     PCCModel, build_model)
from repro_torch.core.pcc import PCCScaler, fit_pcc_batch_np
from repro_torch.device import resolve_device
from repro_torch.workloads.executor import reexecute_fractions
from repro_torch.workloads.generator import build_corpus

__all__ = ["TasqConfig", "TasqPipeline"]


@dataclasses.dataclass(frozen=True)
class TasqConfig:
    n_train: int = 1500
    n_eval: int = 800            # "next-day" historical evaluation set
    seed: int = 0
    noise_sigma_gt: float = 0.15   # re-execution noise (production jitter)
    gbdt: GBDTConfig = GBDTConfig(n_trees=120, max_depth=6)
    nn: NNConfig = NNConfig(loss="lf2")
    gnn_cfg: GNNConfig = GNNConfig()
    gnn_epochs: int = 40


class TasqPipeline:
    """Build corpora, train the model zoo, evaluate the tables."""

    def __init__(self, cfg: TasqConfig = TasqConfig(),
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_set: Optional[TasqDataset] = None
        self.eval_set: Optional[TasqDataset] = None
        self.scaler: Optional[PCCScaler] = None
        self.std: Optional[Standardizer] = None
        self.models: Dict[str, PCCModel] = {}    # "gbdt" | "nn:lf2" | ...
        self.timings: Dict[str, float] = {}
        self.param_counts: Dict[str, int] = {}

    # ------------------------------------------------------------- corpora --
    def build(self) -> "TasqPipeline":
        c = self.cfg
        t0 = time.time()
        jobs = build_corpus(c.n_train + c.n_eval, seed=c.seed)
        self.timings["corpus_s"] = time.time() - t0
        n_nodes = max(len(j.operators) for j in jobs)
        t0 = time.time()
        self.train_set = build_dataset(jobs[:c.n_train], seed=c.seed,
                                       n_max_nodes=n_nodes,
                                       device=self.device,
                                       timings=self.timings)
        self.eval_set = build_dataset(jobs[c.n_train:], seed=c.seed + 1,
                                      n_max_nodes=n_nodes,
                                      device=self.device,
                                      timings=self.timings)
        self.timings["dataset_s"] = time.time() - t0
        self.scaler = PCCScaler.fit(self.train_set.target_a,
                                    self.train_set.target_b)
        self.std = Standardizer(self.train_set.features)
        return self

    # -------------------------------------------------------------- training --
    def _fit(self, key: str, model: PCCModel,
             xgb_runtime: Optional[np.ndarray] = None) -> PCCModel:
        t0 = time.time()
        model.fit(self.train_set, scaler=self.scaler, std=self.std,
                  xgb_runtime=xgb_runtime)
        self.timings[f"{key}_train_s"] = time.time() - t0
        if model.history.get("epoch_time_s"):
            self.timings[f"{key}_epoch_s"] = float(
                np.mean(model.history["epoch_time_s"]))
        self.models[key] = model
        self.param_counts.setdefault(model.family, model.param_count())
        return model

    def _lf3_teacher(self, loss: str) -> Optional[np.ndarray]:
        """LF3 distills the GBDT's runtime predictions (paper §4.5); the
        teacher is trained on demand."""
        if loss != "lf3":
            return None
        if "gbdt" not in self.models:
            self.train("gbdt")
        return self.models["gbdt"].runtime_at(self.train_set)

    def train(self, family: str, loss: str = "lf2") -> PCCModel:
        """Train one registry family ("gbdt" | "nn" | "gnn"); ``loss`` picks
        the loss of the parameter-head families (ignored by gbdt)."""
        if family == "gbdt":
            return self._fit("gbdt", build_model(
                "gbdt", cfg=self.cfg.gbdt, device=self.device))
        if family == "nn":
            cfg = dataclasses.replace(self.cfg.nn, loss=loss)
            return self._fit(f"nn:{loss}",
                             build_model("nn", cfg=cfg, device=self.device),
                             self._lf3_teacher(loss))
        if family == "gnn":
            train_cfg = dataclasses.replace(self.cfg.nn, loss=loss,
                                            epochs=self.cfg.gnn_epochs,
                                            batch_size=64)
            return self._fit(f"gnn:{loss}",
                             build_model("gnn", cfg=self.cfg.gnn_cfg,
                                         train_cfg=train_cfg,
                                         device=self.device),
                             self._lf3_teacher(loss))
        raise KeyError(f"unknown PCC model family {family!r}; "
                       f"known: ('gbdt', 'gnn', 'nn')")

    # ------------------------------------------- legacy shims (one release) --
    def train_xgb(self) -> None:
        """Deprecated: use ``train("gbdt")``."""
        warn_deprecated("TasqPipeline.train_xgb", 'train("gbdt")')
        self.train("gbdt")

    def train_nn(self, loss: str = "lf2") -> None:
        """Deprecated: use ``train("nn", loss=...)``."""
        warn_deprecated("TasqPipeline.train_nn", 'train("nn", loss=...)')
        self.train("nn", loss=loss)

    def train_gnn(self, loss: str = "lf2") -> None:
        """Deprecated: use ``train("gnn", loss=...)``."""
        warn_deprecated("TasqPipeline.train_gnn", 'train("gnn", loss=...)')
        self.train("gnn", loss=loss)

    # ------------------------------------------------------------ inference --
    def predict_params(self, key: str, ds: TasqDataset
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(a, b) from any trained model, in one batched call."""
        return self.models[key].predict_params(ds)

    def xgb_point_predictor(self):
        """(feature_rows, allocs) -> runtimes, for SS-curve assembly."""
        return self.models["gbdt"].point_predictor()

    # ----------------------------------------------------------- evaluation --
    def evaluate(self, ds: TasqDataset, loss: str) -> Dict[str, CurveEval]:
        """One Tables 4-6 row set on a dataset for one loss function."""
        out: Dict[str, CurveEval] = {}
        gbdt = self.models["gbdt"]
        out["xgboost_ss"] = eval_xgb_curves(
            gbdt.point_predictor(), ds.features, ds.observed_alloc,
            ds.observed_runtime, ds.target_a, ds.target_b, mode="ss")
        out["xgboost_pl"] = eval_pcc_model(gbdt, ds)
        if f"nn:{loss}" in self.models:
            out["nn"] = eval_pcc_model(self.models[f"nn:{loss}"], ds)
        if f"gnn:{loss}" in self.models:
            out["gnn"] = eval_pcc_model(self.models[f"gnn:{loss}"], ds)
        return out

    # ------------------------------------------------- ground-truth dataset --
    def ground_truth_records(self, jobs, fractions=(1.0, 0.8, 0.6, 0.2)):
        """§5.1 re-execution: true runtimes at token fractions, with noise.

        Re-execution is per job on the host (variable-length skylines); the
        PCC fits are one batched float64 call."""
        allocs_all, runtimes_all, skylines_all = [], [], []
        for j in jobs:
            allocs, skylines = reexecute_fractions(
                j, fractions, noise_sigma=self.cfg.noise_sigma_gt,
                seed=self.cfg.seed + 97)
            allocs_all.append(allocs)
            runtimes_all.append([len(s) for s in skylines])
            skylines_all.append(skylines)
        a, b = fit_pcc_batch_np(np.asarray(allocs_all, np.float64),
                                np.asarray(runtimes_all, np.float64))
        return [{"job": j, "allocs": al,
                 "runtimes": np.asarray(rt, np.int64), "skylines": sk,
                 "a": float(ai), "b": float(bi)}
                for j, al, rt, sk, ai, bi in zip(
                    jobs, allocs_all, runtimes_all, skylines_all, a, b)]
