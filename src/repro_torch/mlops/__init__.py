"""``repro_torch.mlops`` — the closed loop of the paper's deployment story:
drifting workloads, online drift detection, periodic retraining, and
zero-downtime model hot-swap.

    monitor  ->  trigger  ->  train  ->  warm  ->  swap
    (PSI/KS +    (cadence- or   (TasqPipeline  (AOT-build     (atomic
     residual     signal-        .train over    the full       repoint;
     CUSUM over   triggered      the training   executable     old
     completion   registry       buffer, off    grid first)    executables
     tuples)      policies)      the hot path)                 retired)

Drift itself is injected by ``repro_torch.workloads.DriftSpec`` (data-volume
growth curves, template-mix rotation, new-operator introduction over
trace time), threaded through both ``generate()`` and ``stream()`` so
fused/streaming replays see the same drifted trace bitwise. The
``MLOpsLoop`` hook plugs into ``ClusterSimulator.run(trace, mlops=...)``;
each refit produces a versioned ``ModelBundle`` that
``Allocator.swap_model`` warms and swaps without ever serving a cold
model (``stats["compiles"] == 0`` after every swap).
"""
from repro_torch.mlops.drift import (CusumDetector, DriftMonitor,
                                     DriftSignal, ks_statistic, psi)
from repro_torch.mlops.loop import MLOpsLoop
from repro_torch.mlops.retrain import (ModelBundle, RetrainController,
                                       RetrainState, TrainingBuffer,
                                       build_retrain_policy,
                                       register_retrain_policy,
                                       retrain_policies)

__all__ = [
    "CusumDetector",
    "DriftMonitor",
    "DriftSignal",
    "MLOpsLoop",
    "ModelBundle",
    "RetrainController",
    "RetrainState",
    "TrainingBuffer",
    "build_retrain_policy",
    "ks_statistic",
    "psi",
    "register_retrain_policy",
    "retrain_policies",
]
