"""Periodic retraining: buffer -> refit -> versioned ``ModelBundle``.

``RetrainController`` closes the paper's deployment loop: completed-query
(job, observed-run) pairs are snapshotted into a bounded, recency-ordered
``TrainingBuffer``; a registered trigger policy (``"cadence"`` — every N
completions — or ``"signal"`` — on accumulated ``DriftSignal``s; the
registry is symmetric to ``register_policy`` / ``register_scheduler_policy``)
decides *when* to refit; the refit itself goes through the one unified
entry point ``TasqPipeline.train(family, loss=...)`` over a dataset built
from the buffer, off the decision hot path, on the controller's device
(default ``"cuda"``): there the dataset's AREPAS augmentation runs kernel
K1 and the model trains on the card. Each refit yields a versioned
``ModelBundle`` ready for ``Allocator.swap_model`` — the zero-downtime
half of the loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.dataset import build_dataset
from repro_torch.core.featurize import Standardizer
from repro_torch.core.pcc import PCCScaler
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_OBS
from repro_torch.workloads.generator import Job

__all__ = ["ModelBundle", "RetrainController", "RetrainState",
           "TrainingBuffer", "build_retrain_policy",
           "register_retrain_policy", "retrain_policies"]


@dataclasses.dataclass
class ModelBundle:
    """One versioned, deployable model: what a refit produces and what
    ``Allocator.swap_model`` consumes. ``version`` is monotonically
    increasing per controller; ``trigger`` records which policy fired."""
    version: int
    family: str
    loss: str
    model: object                     # a trained repro_torch PCCModel
    n_train: int
    trigger: str
    train_s: float
    created_t_s: float                # sim-time of the refit decision

    @property
    def key(self) -> str:
        return f"{self.family}:{self.loss}@v{self.version}"


class TrainingBuffer:
    """Bounded recency buffer of completed unique queries.

    One slot per unique template (re-completion refreshes recency and
    bumps the completion count); ``snapshot(n)`` returns the ``n`` most
    recently completed jobs, newest first — the training set that tracks
    the drifting workload instead of the stationary seed corpus.
    """

    def __init__(self, max_entries: int = 4096):
        assert max_entries >= 1
        self.max_entries = int(max_entries)
        self._jobs: Dict[int, Job] = {}          # insertion = recency order
        self.counts: Dict[int, int] = {}
        self.n_completed = 0

    def __len__(self) -> int:
        return len(self._jobs)

    def add(self, jobs: List[Job], counts: Optional[np.ndarray] = None
            ) -> None:
        for i, job in enumerate(jobs):
            c = int(counts[i]) if counts is not None else 1
            self.n_completed += c
            key = job.job_id
            self.counts[key] = self.counts.get(key, 0) + c
            self._jobs.pop(key, None)            # refresh recency
            self._jobs[key] = job
        while len(self._jobs) > self.max_entries:
            old = next(iter(self._jobs))
            del self._jobs[old]
            del self.counts[old]

    def snapshot(self, n: Optional[int] = None) -> List[Job]:
        jobs = list(self._jobs.values())[::-1]   # newest first
        return jobs if n is None else jobs[:n]


@dataclasses.dataclass
class RetrainState:
    """What a trigger policy sees: counters since the last swap plus the
    buffer fill — enough for cadence, signal, and hybrid policies."""
    now_s: float = 0.0
    completed_since_swap: int = 0
    signals_since_swap: int = 0
    buffer_size: int = 0
    last_swap_s: float = 0.0
    n_swaps: int = 0


_RETRAIN_REGISTRY: Dict[str, callable] = {}


def register_retrain_policy(name: str):
    """``@register_retrain_policy("cadence")`` exposes a trigger-policy
    class — symmetric to ``register_policy`` (allocation) and
    ``register_scheduler_policy`` (admission)."""
    def deco(fn):
        _RETRAIN_REGISTRY[name] = fn
        return fn
    return deco


def build_retrain_policy(name: str, **overrides):
    if name not in _RETRAIN_REGISTRY:
        raise KeyError(f"unknown retrain policy {name!r}; "
                       f"known: {sorted(_RETRAIN_REGISTRY)}")
    return _RETRAIN_REGISTRY[name](**overrides)


def retrain_policies() -> Tuple[str, ...]:
    return tuple(sorted(_RETRAIN_REGISTRY))


@register_retrain_policy("off")
class NeverRetrain:
    """The no-retrain baseline: the model trained once stays forever."""
    name = "off"

    def should_retrain(self, state: RetrainState) -> bool:
        return False


@register_retrain_policy("cadence")
class CadenceRetrain:
    """Refit every ``every`` completions (the fixed-cadence strawman the
    drift benchmark compares signal-triggering against)."""
    name = "cadence"

    def __init__(self, every: int = 2000, min_buffer: int = 64):
        assert every >= 1
        self.every = int(every)
        self.min_buffer = int(min_buffer)

    def should_retrain(self, state: RetrainState) -> bool:
        return (state.completed_since_swap >= self.every
                and state.buffer_size >= self.min_buffer)


@register_retrain_policy("signal")
class SignalRetrain:
    """Refit when the ``DriftMonitor`` has fired: at least ``min_signals``
    typed drift signals since the last swap (and enough buffered jobs to
    make the refit meaningful). ``cooldown_s`` of sim-time between swaps
    keeps a persistently-drifting trace from retraining every epoch."""
    name = "signal"

    def __init__(self, min_signals: int = 1, min_buffer: int = 64,
                 cooldown_s: float = 0.0):
        assert min_signals >= 1
        self.min_signals = int(min_signals)
        self.min_buffer = int(min_buffer)
        self.cooldown_s = float(cooldown_s)

    def should_retrain(self, state: RetrainState) -> bool:
        return (state.signals_since_swap >= self.min_signals
                and state.buffer_size >= self.min_buffer
                and (state.n_swaps == 0
                     or state.now_s - state.last_swap_s >= self.cooldown_s))


class RetrainController:
    """Snapshot completions, decide when to refit, produce ``ModelBundle``s.

    ``observe()`` feeds completed jobs (and any drift signals) in;
    ``should_retrain()`` consults the registered trigger policy;
    ``retrain()`` builds a dataset from the buffer and runs
    ``TasqPipeline.train(family, loss=...)`` on ``device`` — the refit
    happens off the decision hot path (the caller swaps the bundle in
    afterwards). The bundle's model lives on ``device``, which must be the
    allocator's.
    """

    def __init__(self, *, family: str = "nn", loss: str = "lf2",
                 policy: str = "cadence",
                 policy_overrides: Optional[Dict] = None,
                 pipeline_cfg: TasqConfig = TasqConfig(),
                 max_train: int = 400, buffer_max: int = 4096,
                 seed: int = 0, obs=None,
                 device: Union[str, torch.device, None] = None):
        self.family = family
        self.loss = loss
        self.policy = build_retrain_policy(policy, **(policy_overrides or {}))
        self.policy_name = policy
        self.pipeline_cfg = pipeline_cfg
        self.max_train = int(max_train)
        self.buffer = TrainingBuffer(buffer_max)
        self.seed = int(seed)
        self.obs = NULL_OBS if obs is None else obs
        self.device = resolve_device(device)
        self.state = RetrainState()
        self.bundles: List[ModelBundle] = []

    # ------------------------------------------------------------- feeding --
    def observe(self, *, now_s: float, jobs: List[Job],
                counts: Optional[np.ndarray] = None,
                n_completed: Optional[int] = None,
                n_signals: int = 0) -> None:
        self.buffer.add(jobs, counts)
        n = int(n_completed if n_completed is not None
                else (counts.sum() if counts is not None else len(jobs)))
        self.state.now_s = float(now_s)
        self.state.completed_since_swap += n
        self.state.signals_since_swap += int(n_signals)
        self.state.buffer_size = len(self.buffer)

    def should_retrain(self) -> bool:
        return self.policy.should_retrain(self.state)

    # ------------------------------------------------------------- refitting --
    def retrain(self, now_s: Optional[float] = None,
                trigger: Optional[str] = None) -> ModelBundle:
        """One refit over the buffer's freshest ``max_train`` jobs. Resets
        the since-swap counters; the caller installs the bundle."""
        now_s = self.state.now_s if now_s is None else float(now_s)
        version = len(self.bundles) + 1
        jobs = self.buffer.snapshot(self.max_train)
        assert jobs, "retrain() with an empty training buffer"
        t0 = time.time()
        with self.obs.tracer.span("mlops.retrain", version=version,
                                  n_train=len(jobs)):
            n_nodes = max(len(j.operators) for j in jobs)
            train_set = build_dataset(jobs, seed=self.seed + version,
                                      n_max_nodes=n_nodes,
                                      device=self.device)
            pipe = TasqPipeline(self.pipeline_cfg, device=self.device)
            pipe.train_set = train_set
            pipe.eval_set = train_set
            pipe.scaler = PCCScaler.fit(train_set.target_a,
                                        train_set.target_b)
            pipe.std = Standardizer(train_set.features)
            model = pipe.train(self.family, loss=self.loss)
        train_s = time.time() - t0
        bundle = ModelBundle(version=version, family=self.family,
                             loss=self.loss, model=model,
                             n_train=len(jobs),
                             trigger=trigger or self.policy_name,
                             train_s=round(train_s, 3), created_t_s=now_s)
        self.bundles.append(bundle)
        self.obs.metrics.counter("retrains").inc()
        self.obs.metrics.histogram("retrain_train_s", lo=1e-3,
                                   hi=1e4).record(train_s)
        self.state.completed_since_swap = 0
        self.state.signals_since_swap = 0
        self.state.last_swap_s = now_s
        self.state.n_swaps += 1
        return bundle
