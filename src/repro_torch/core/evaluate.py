"""Model evaluation metrics (paper §5: the three columns of Tables 4-6/8).

  1. Pattern (Non-Increase): fraction of jobs whose predicted PCC is
     monotone non-increasing — sign test for power-law curves; local grid
     monotonicity within +-40% of the reference for XGBoost SS.
  2. MAE (Curve Params): mean absolute error of the curve parameters in a
     *standardized* space — (a, log b) z-scored by the evaluation targets'
     own mean/std — so both components weigh comparably for every model.
  3. Median AE (Run-Time): median over jobs of |predicted - true| / true at
     the observed token count (percent).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.curves import (
    fit_pl_curve,
    fit_ss_curve,
    prediction_fan,
    ss_non_increasing,
)
from repro_torch.core.pcc import is_non_increasing, pcc_runtime

__all__ = ["CurveEval", "eval_param_curves", "eval_pcc_model",
           "eval_xgb_curves", "standardized_param_mae"]


@dataclasses.dataclass
class CurveEval:
    pattern_non_increase: float      # fraction in [0, 1]
    mae_curve_params: Optional[float]
    median_ae_runtime: float         # relative, e.g. 0.13 == 13%

    def row(self) -> Dict[str, float]:
        return {
            "pattern_non_increase": round(self.pattern_non_increase, 4),
            "mae_curve_params": (None if self.mae_curve_params is None
                                 else round(self.mae_curve_params, 4)),
            "median_ae_runtime": round(self.median_ae_runtime, 4),
        }


def standardized_param_mae(pred_a, pred_b, tgt_a, tgt_b) -> float:
    """MAE over z-scored (a, log b); z-stats from the evaluation targets."""
    tgt_lb = np.log(np.maximum(tgt_b, 1e-9))
    pred_lb = np.log(np.maximum(pred_b, 1e-9))
    sa, sb = tgt_a.std() + 1e-9, tgt_lb.std() + 1e-9
    ma, mb = tgt_a.mean(), tgt_lb.mean()
    za = np.abs((pred_a - ma) / sa - (tgt_a - ma) / sa)
    zb = np.abs((pred_lb - mb) / sb - (tgt_lb - mb) / sb)
    return float(np.mean((za + zb) / 2.0))


def eval_param_curves(pred_a: np.ndarray, pred_b: np.ndarray,
                      tgt_a: np.ndarray, tgt_b: np.ndarray,
                      observed_alloc: np.ndarray,
                      observed_runtime: np.ndarray) -> CurveEval:
    """Evaluate power-law-parameter predictions (NN / GNN / XGBoost PL)."""
    mono = np.array([is_non_increasing(a, b) for a, b in zip(pred_a, pred_b)])
    rt = pcc_runtime(pred_a, pred_b, observed_alloc)
    rel = np.abs(rt - observed_runtime) / np.maximum(observed_runtime, 1e-9)
    return CurveEval(
        pattern_non_increase=float(mono.mean()),
        mae_curve_params=standardized_param_mae(pred_a, pred_b, tgt_a, tgt_b),
        median_ae_runtime=float(np.median(rel)),
    )


def eval_pcc_model(model, ds) -> CurveEval:
    """Evaluate any ``PCCModel`` on a dataset through the unified interface.

    One batched ``predict_params`` call per model — the GBDT assembles its
    power-law fan in a single vectorized pass, NN/GNN run one jitted apply —
    then the standard parameter-curve metrics.
    """
    a, b = model.predict_params(ds)
    return eval_param_curves(a, b, ds.target_a, ds.target_b,
                             ds.observed_alloc, ds.observed_runtime)


def eval_xgb_curves(predict_runtime: Callable[[np.ndarray, np.ndarray], np.ndarray],
                    features: np.ndarray,
                    observed_alloc: np.ndarray,
                    observed_runtime: np.ndarray,
                    tgt_a: np.ndarray, tgt_b: np.ndarray,
                    mode: str = "pl") -> CurveEval:
    """Assemble per-job PCCs from XGBoost point predictions and evaluate.

    predict_runtime(feat_rows, allocs) -> runtimes; feature rows WITHOUT the
    token column (it is appended per fan point here).
    """
    n = features.shape[0]
    mono = np.zeros(n, bool)
    pa = np.zeros(n)
    pb = np.zeros(n)
    rt_ref = np.zeros(n)
    for i in range(n):
        fan = prediction_fan(observed_alloc[i])
        rows = np.repeat(features[i][None, :], fan.size, 0)
        preds = predict_runtime(rows, fan)
        if mode == "pl":
            a, b = fit_pl_curve(fan, preds)
            pa[i], pb[i] = a, b
            mono[i] = is_non_increasing(a, b)
            rt_ref[i] = pcc_runtime(a, b, observed_alloc[i])
        else:  # ss
            curve = fit_ss_curve(fan, preds)
            mono[i] = ss_non_increasing(curve, observed_alloc[i])
            rt_ref[i] = curve(np.asarray([observed_alloc[i]]))[0]
    rel = np.abs(rt_ref - observed_runtime) / np.maximum(observed_runtime, 1e-9)
    return CurveEval(
        pattern_non_increase=float(mono.mean()),
        mae_curve_params=(standardized_param_mae(pa, pb, tgt_a, tgt_b)
                          if mode == "pl" else None),
        median_ae_runtime=float(np.median(rel)),
    )
