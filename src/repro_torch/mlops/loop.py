"""The closed MLOps loop: monitor -> trigger -> train -> warm -> swap.

``MLOpsLoop`` binds a ``DriftMonitor``, a ``RetrainController`` and an
``Allocator`` into the single hook the cluster simulator calls at each
completion batch (``ClusterSimulator.run(trace, mlops=loop)``). On every
batch it updates the detectors and the training buffer; when the trigger
policy fires it refits off the hot path (on the allocator's device: a
retrain on the card runs kernel K1 in its dataset build), AOT-warms the
new executable grid via ``warm_allocation_stack`` (so the swapped-in model
is never cold — ``stats["compiles"] == 0`` post-swap), atomically swaps it
into the allocator, rebases the detectors, and reports the swap back to
the simulator so the replay continues against the new fabric.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.mlops.drift import DriftMonitor
from repro_torch.mlops.retrain import RetrainController
from repro_torch.obs import NULL_OBS

__all__ = ["MLOpsLoop"]


class MLOpsLoop:
    """Monitor + controller + allocator behind one simulator hook."""

    def __init__(self, allocator, controller: RetrainController,
                 monitor: Optional[DriftMonitor] = None, *,
                 warmup_config=None, obs=None):
        self.allocator = allocator
        self.controller = controller
        self.obs = obs if obs is not None else getattr(allocator, "obs",
                                                       NULL_OBS)
        self.monitor = DriftMonitor(obs=self.obs) if monitor is None \
            else monitor
        self.warmup_config = warmup_config
        self.swaps: List[Dict] = []
        self.error_points: List[Dict] = []     # rolling model-error series
        self._jobs = None                      # trace pool, set per run
        self._roll: List[float] = []

    # ---------------------------------------------------------- run binding --
    def begin_run(self, trace) -> None:
        """Bind this run's unique-query pool (the objects the training
        buffer snapshots). Called by the simulator before the first epoch."""
        self._jobs = trace.jobs

    # -------------------------------------------------------------- the hook --
    def on_completions(self, *, now: float, job_index: np.ndarray,
                       features: np.ndarray, predicted_s: np.ndarray,
                       actual_s: np.ndarray,
                       model_mask: Optional[np.ndarray] = None) -> bool:
        """One completion batch from the simulator. Returns True when a
        hot-swap happened (the simulator then re-points at the new
        service/fabric and bumps the cache model version)."""
        assert self._jobs is not None, "MLOpsLoop.begin_run() not called"
        signals = self.monitor.observe(
            t_s=now, features=features, predicted_s=predicted_s,
            actual_s=actual_s, model_mask=model_mask)

        # rolling model error: mean |log(actual/pred)| of model decisions
        if model_mask is not None and np.any(model_mask):
            p = np.maximum(np.asarray(predicted_s, float)[model_mask], 1e-6)
            a = np.maximum(np.asarray(actual_s, float)[model_mask], 1e-6)
            self._roll.extend(np.abs(np.log(a / p)).tolist())
            self._roll = self._roll[-512:]
            self.error_points.append({
                "t_s": float(now),
                "rolling_model_error": float(np.mean(self._roll)),
                "n": len(self._roll)})

        uniq, counts = np.unique(np.asarray(job_index, np.int64),
                                 return_counts=True)
        self.controller.observe(
            now_s=now, jobs=[self._jobs[int(u)] for u in uniq],
            counts=counts, n_signals=len(signals))
        if not self.controller.should_retrain():
            return False

        bundle = self.controller.retrain(now_s=now)
        report = self.allocator.swap_model(bundle, jobs=self._jobs,
                                           warmup_config=self.warmup_config)
        self.monitor.rebase()
        self.swaps.append({
            "t_s": float(now), "version": bundle.version,
            "trigger": bundle.trigger, "n_train": bundle.n_train,
            "train_s": bundle.train_s,
            "cold_start_s": report.cold_start_s,
            "n_precompiled": report.n_precompiled})
        self.obs.tracer.point("mlops.swap", version=bundle.version,
                              t_sim=now)
        return True

    # ------------------------------------------------------------- reporting --
    def rolling_model_error(self) -> float:
        """Final rolling mean |log(actual/pred)| over model decisions."""
        return float(np.mean(self._roll)) if self._roll else 0.0

    def report(self) -> Dict:
        return {
            "policy": self.controller.policy_name,
            "n_swaps": len(self.swaps),
            "swaps": list(self.swaps),
            "n_drift_signals": len(self.monitor.signals),
            "signals": [s.to_row() for s in self.monitor.signals],
            "rolling_model_error": self.rolling_model_error(),
            "model_version": getattr(self.allocator, "model_version", 0),
        }
