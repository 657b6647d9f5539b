"""Online drift detection over the simulator's decision stream.

``DriftMonitor`` consumes the (features, decision, predicted runtime,
actual runtime) tuples the cluster simulator already produces at every
lease completion and runs two detector families over them:

  * **feature drift** — PSI (population stability index over reference-
    quantile bins, per feature column) and a two-sample KS statistic,
    comparing a frozen reference window against a sliding current window:
    covariate drift (new templates, data-volume growth, new operators)
    moves these even when the model still predicts well;
  * **residual drift** — a two-sided CUSUM over standardized
    log(actual / predicted) runtime residuals of *model-provenance*
    decisions: concept drift (the feature -> runtime map changed under
    the model) accumulates here even when the feature mix looks stable.

Detections are emitted as typed ``DriftSignal``s, counted into the obs
plane (``drift_signals`` counter, ``drift_score`` gauge) and stamped onto
the flight recorder's ``drift_score`` column, so recorded decisions are
attributable to the drift state they were made under. The monitor is
pure-numpy and observation-only: attaching it never perturbs a seeded
replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import NULL_OBS

__all__ = ["CusumDetector", "DriftMonitor", "DriftSignal", "ks_statistic",
           "psi"]

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DriftSignal:
    """One typed drift detection.

    ``kind`` names the detector ("feature_psi" | "feature_ks" |
    "residual_cusum"); ``score`` is the detector statistic at trigger
    time, ``threshold`` the configured trigger level; ``detail`` carries
    detector-specific context (worst feature column, CUSUM side, window
    sizes).
    """
    kind: str
    t_s: float
    score: float
    threshold: float
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_row(self) -> Dict:
        return {"kind": self.kind, "t_s": self.t_s, "score": self.score,
                "threshold": self.threshold, **self.detail}


def psi(reference: np.ndarray, current: np.ndarray,
        n_bins: int = 10) -> float:
    """Population stability index of ``current`` vs ``reference`` over
    reference-quantile bins. ~0 stable; > 0.25 is the classic "population
    has shifted" level."""
    reference = np.asarray(reference, np.float64)
    current = np.asarray(current, np.float64)
    if reference.size < n_bins or current.size == 0:
        return 0.0
    edges = np.quantile(reference, np.linspace(0.0, 1.0, n_bins + 1)[1:-1])
    p = np.bincount(np.searchsorted(edges, reference), minlength=n_bins)
    q = np.bincount(np.searchsorted(edges, current), minlength=n_bins)
    p = np.maximum(p / p.sum(), _EPS)
    q = np.maximum(q / q.sum(), _EPS)
    return float(np.sum((q - p) * np.log(q / p)))


def ks_statistic(reference: np.ndarray, current: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic: sup |ECDF_ref - ECDF_cur|."""
    reference = np.sort(np.asarray(reference, np.float64))
    current = np.sort(np.asarray(current, np.float64))
    if reference.size == 0 or current.size == 0:
        return 0.0
    grid = np.concatenate([reference, current])
    cdf_r = np.searchsorted(reference, grid, side="right") / reference.size
    cdf_c = np.searchsorted(current, grid, side="right") / current.size
    return float(np.max(np.abs(cdf_r - cdf_c)))


class CusumDetector:
    """Two-sided CUSUM over standardized residuals.

    The first ``n_reference`` observations freeze the residual mean/std;
    after that each standardized residual z updates

        S+ = max(0, S+ + z - k)        S- = max(0, S- - z - k)

    and the detector triggers when either side exceeds ``h``. The
    reference mean/std are themselves noisy estimates, so k and h must
    absorb calibration error on top of in-control variance: k = 0.75 and
    h = 10 stay quiet over 300 seeds x 8k stationary samples with sigma
    up to 4 (the hypothesis sweep in tests/test_mlops.py pins this)
    while still flagging a 1-sigma mean shift within ~100 observations.
    """

    def __init__(self, *, k: float = 0.75, h: float = 10.0,
                 n_reference: int = 128):
        assert h > 0 and k >= 0 and n_reference >= 8
        self.k = float(k)
        self.h = float(h)
        self.n_reference = int(n_reference)
        self.reset()

    def reset(self) -> None:
        self._ref: List[float] = []
        self._mu = 0.0
        self._sigma = 1.0
        self.s_pos = 0.0
        self.s_neg = 0.0

    @property
    def calibrated(self) -> bool:
        return len(self._ref) >= self.n_reference

    @property
    def score(self) -> float:
        return max(self.s_pos, self.s_neg)

    def update(self, residuals: np.ndarray) -> bool:
        """Feed residuals; returns True if the trigger level was crossed
        (the statistic keeps accumulating until ``reset()``)."""
        residuals = np.asarray(residuals, np.float64).ravel()
        residuals = residuals[np.isfinite(residuals)]
        if residuals.size == 0:
            return False
        if not self.calibrated:
            take = self.n_reference - len(self._ref)
            self._ref.extend(residuals[:take].tolist())
            residuals = residuals[take:]
            if self.calibrated:
                ref = np.asarray(self._ref)
                self._mu = float(ref.mean())
                self._sigma = float(max(ref.std(), _EPS))
            if residuals.size == 0:
                return False
        for z in (residuals - self._mu) / self._sigma:
            self.s_pos = max(0.0, self.s_pos + z - self.k)
            self.s_neg = max(0.0, self.s_neg - z - self.k)
        return self.score > self.h


class DriftMonitor:
    """Online drift detection over completion tuples.

    ``observe()`` is called with one columnar batch of completions (the
    simulator's step-1 lease expiries) and returns the list of
    ``DriftSignal``s that fired on it. The first ``reference`` feature
    rows freeze the feature-drift baseline; the sliding current window
    holds the last ``window`` rows. ``rebase()`` (called after a model
    hot-swap) restarts every detector so the post-swap regime becomes the
    new normal instead of re-triggering forever.
    """

    def __init__(self, *, reference: int = 256, window: int = 256,
                 min_current: int = 64, psi_threshold: float = 0.25,
                 ks_threshold: float = 0.25, cusum_k: float = 0.75,
                 cusum_h: float = 10.0, cusum_reference: int = 128,
                 obs=None):
        assert reference >= 16 and window >= 16
        self.reference = int(reference)
        self.window = int(window)
        self.min_current = int(min_current)
        self.psi_threshold = float(psi_threshold)
        self.ks_threshold = float(ks_threshold)
        self.cusum = CusumDetector(k=cusum_k, h=cusum_h,
                                   n_reference=cusum_reference)
        self.obs = NULL_OBS if obs is None else obs
        self.signals: List[DriftSignal] = []
        self.n_seen = 0
        self._ref_rows: List[np.ndarray] = []
        self._ref: Optional[np.ndarray] = None   # (R, d) frozen baseline
        self._cur: List[np.ndarray] = []
        self._cur_count = 0

    # --------------------------------------------------------------- state --
    def rebase(self) -> None:
        """Restart every detector (post-hot-swap: new model, new normal)."""
        self._ref_rows, self._ref = [], None
        self._cur, self._cur_count = [], 0
        self.cusum.reset()
        self._stamp_score(0.0)

    @property
    def drift_score(self) -> float:
        """Max detector statistic normalized by its threshold (>= 1 means
        some detector is at trigger level) — the flight-recorder column."""
        scores = [self.cusum.score / self.cusum.h]
        if self._ref is not None and self._cur_count >= self.min_current:
            cur = np.concatenate(self._cur)[-self.window:]
            scores.append(self._psi_max(cur) / self.psi_threshold)
            scores.append(self._ks_max(cur) / self.ks_threshold)
        return float(max(scores))

    def _psi_max(self, cur: np.ndarray) -> float:
        return max(psi(self._ref[:, j], cur[:, j])
                   for j in range(self._ref.shape[1]))

    def _ks_max(self, cur: np.ndarray) -> float:
        return max(ks_statistic(self._ref[:, j], cur[:, j])
                   for j in range(self._ref.shape[1]))

    def _stamp_score(self, score: float) -> None:
        self.obs.metrics.gauge("drift_score").set(score)
        if self.obs.recorder is not None:
            self.obs.recorder.drift_score = score

    # ------------------------------------------------------------- observe --
    def observe(self, *, t_s: float, features: np.ndarray,
                predicted_s: np.ndarray, actual_s: np.ndarray,
                model_mask: Optional[np.ndarray] = None
                ) -> List[DriftSignal]:
        """One completion batch: ``features`` is (n, d); ``predicted_s`` /
        ``actual_s`` are the model-predicted and realized runtimes;
        ``model_mask`` selects the rows whose decision came from the model
        (HISTORY rows carry no model residual). Returns signals fired now.
        """
        features = np.atleast_2d(np.asarray(features, np.float64))
        n = features.shape[0]
        self.n_seen += n
        fired: List[DriftSignal] = []

        # feature windows: fill the frozen reference first, then slide
        if self._ref is None:
            take = self.reference - sum(r.shape[0] for r in self._ref_rows)
            self._ref_rows.append(features[:take])
            if sum(r.shape[0] for r in self._ref_rows) >= self.reference:
                self._ref = np.concatenate(self._ref_rows)
            features = features[take:]
        if self._ref is not None and features.shape[0]:
            self._cur.append(features)
            self._cur_count += features.shape[0]
            while self._cur_count - self._cur[0].shape[0] >= self.window:
                self._cur_count -= self._cur[0].shape[0]
                self._cur.pop(0)

        # residual CUSUM on model-provenance rows
        pred = np.asarray(predicted_s, np.float64).ravel()
        act = np.asarray(actual_s, np.float64).ravel()
        if model_mask is not None:
            mask = np.asarray(model_mask, bool).ravel()
            pred, act = pred[mask], act[mask]
        if pred.size:
            resid = np.log(np.maximum(act, _EPS)
                           / np.maximum(pred, _EPS))
            if self.cusum.update(resid):
                side = "high" if self.cusum.s_pos >= self.cusum.s_neg \
                    else "low"
                fired.append(DriftSignal(
                    kind="residual_cusum", t_s=float(t_s),
                    score=self.cusum.score, threshold=self.cusum.h,
                    detail={"side": side, "n_seen": float(self.n_seen)}))
                self.cusum.reset()

        # window comparisons once the current window is populated enough
        if self._ref is not None and self._cur_count >= self.min_current:
            cur = np.concatenate(self._cur)[-self.window:]
            s_psi = self._psi_max(cur)
            if s_psi > self.psi_threshold:
                fired.append(DriftSignal(
                    kind="feature_psi", t_s=float(t_s), score=s_psi,
                    threshold=self.psi_threshold,
                    detail={"n_seen": float(self.n_seen)}))
            s_ks = self._ks_max(cur)
            if s_ks > self.ks_threshold:
                fired.append(DriftSignal(
                    kind="feature_ks", t_s=float(t_s), score=s_ks,
                    threshold=self.ks_threshold,
                    detail={"n_seen": float(self.n_seen)}))

        if fired:
            self.signals.extend(fired)
            self.obs.metrics.counter("drift_signals").inc(len(fired))
            for sig in fired:
                self.obs.tracer.point("drift.signal", kind=sig.kind,
                                      score=round(sig.score, 4), t_sim=t_s)
        self._stamp_score(self.drift_score)
        return fired
