"""Loss functions for NN / GNN PCC-parameter models (paper §4.5).

LF1: MAE of the *scaled* curve parameters. Scaling (PCCScaler) keeps the two
     components comparable and makes any decoded prediction monotone
     non-increasing by construction.
LF2: LF1 + w_rt * MAE% of runtime at the observed token count — regularizes
     toward good point predictions on REAL ground truth only (the simulator
     never enters this term; §4.1's second-class-citizen mitigation).
LF3: LF2 + w_distill * mean |NN - XGBoost| runtime (%) at the observed tokens
     — transfer from the strong XGBoost point predictor. (The paper finds
     this redundant; we reproduce that finding.)

All terms are differentiable torch ops. Relative errors are clipped so early
(wild) curve predictions can't blow up training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.core.pcc import PCCScaler, pcc_runtime_torch

__all__ = ["LossWeights", "make_loss", "LOSS_KINDS"]

LOSS_KINDS = ("lf1", "lf2", "lf3")

_REL_CLIP = 5.0  # clip relative runtime errors (training stability)

# Cap on the exponent of b = exp(zb * sd_b + mu_b) inside the loss. float32
# overflows past 88.72; the reference then multiplies the clipped error's
# zero gradient by b = inf, and the NaN reaches every parameter through the
# global-norm clip. That happened on the H100 at 20k jobs (GNN, step 365 of
# 1,248: one batch decoded zb ~ 54). Capped at 88, the loss keeps every
# value and gradient of the reference's wherever its b stays below e^88.
_MAX_LOG_B = 88.0


@dataclasses.dataclass(frozen=True)
class LossWeights:
    w_runtime: float = 0.5    # LF2 penalization weight (tuned so the curve-
    w_distill: float = 0.25   # param MAE of LF2 stays close to LF1, §5.3)


def _param_mae(pred_z: torch.Tensor, tgt_z: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred_z - tgt_z))


def _runtime_rel_err(pred_z, scaler: PCCScaler, alloc, runtime) -> torch.Tensor:
    a, _ = scaler.decode(pred_z)
    log_b = torch.clamp(pred_z[..., 1] * scaler.sd_b + scaler.mu_b,
                        max=_MAX_LOG_B)
    rt = pcc_runtime_torch(a, torch.exp(log_b), alloc)
    rel = torch.abs(rt - runtime) / torch.clamp(runtime, min=1e-6)
    return torch.mean(torch.clamp(rel, 0.0, _REL_CLIP))


def make_loss(kind: str, scaler: PCCScaler,
              weights: LossWeights = LossWeights()) -> Callable:
    """Returns loss(pred_z, batch) -> (scalar, metrics dict).

    batch keys: target_z (B,2); observed_alloc (B,); observed_runtime (B,);
    xgb_runtime (B,) [LF3 only].
    """
    if kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss {kind!r}; known: {LOSS_KINDS}")

    def loss_fn(pred_z: torch.Tensor, batch: Dict
                ) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        l1 = _param_mae(pred_z, batch["target_z"])
        metrics = {"param_mae": l1}
        total = l1
        if kind in ("lf2", "lf3"):
            rt = _runtime_rel_err(pred_z, scaler, batch["observed_alloc"],
                                  batch["observed_runtime"])
            metrics["runtime_mae_pct"] = rt
            total = total + weights.w_runtime * rt
        if kind == "lf3":
            ds = _runtime_rel_err(pred_z, scaler, batch["observed_alloc"],
                                  batch["xgb_runtime"])
            metrics["distill_mae_pct"] = ds
            total = total + weights.w_distill * ds
        metrics["loss"] = total
        return total, metrics

    return loss_fn
