"""Frozen copy of ``repro_torch/workloads/generator.py`` (the benchmark's own; later changes to
the program do not reach it).

SCOPE-like synthetic workload generator.

No public SCOPE telemetry exists (the paper's 85k production jobs are
Microsoft-internal), so — per the repro plan in DESIGN.md — we synthesize a
population of analytical jobs whose *published* statistics match §5 of the
paper: right-skewed runtimes and token counts (tokens 1..6287, median ≈ 54,
mean ≈ 154), DAGs of operators grouped into stages, and Table-2 operator
features (cardinalities, costs, partitioning) that are *noisy estimates* of
the quantities that actually drive execution — so learned models can predict
runtime from compile-time features, but imperfectly, as in production.

A Job is:
  operators: feature rows (Table 2) forming a DAG (the "query plan");
  stages:    execution units — ``num_tasks`` parallel tasks of
             ``task_duration`` seconds each, gated on upstream stages.

The executor (executor.py) runs stages under a token cap to produce the
resource-consumption skyline; the generator alone fixes all ground truth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUM_OP_TYPES = 35       # paper Table 2: 35 physical operator types
NUM_PARTITION_TYPES = 4  # paper Table 2: 4 partition types
MAX_TOKENS = 6287        # paper §5: peak tokens observed in the population

# operator band drifted templates draw from under ``DriftSpec.new_op_frac``:
# a fixed tail of the type space, so "new operators" shift both the one-hot
# feature mix (covariate drift the PSI/KS detectors see) and the engine cost
# coefficients behind it (concept drift the residual CUSUM sees)
DRIFT_OP_POOL = tuple(range(NUM_OP_TYPES - 7, NUM_OP_TYPES))

_ENGINE_SEED = 20210415


def _engine_truth_tables(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-op-type cost coefficient and selectivity: the fixed "engine" truth
    table, derived from an explicit seed (no module-level RNG state)."""
    rng = np.random.RandomState(seed)
    coeff = np.exp(rng.uniform(-1.5, 1.5, NUM_OP_TYPES))
    selectivity = np.clip(rng.lognormal(-0.3, 0.6, NUM_OP_TYPES), 0.05, 2.0)
    return coeff, selectivity


OP_COST_COEFF, OP_SELECTIVITY = _engine_truth_tables(_ENGINE_SEED)


@dataclasses.dataclass
class Operator:
    """One physical operator — a node of the query plan DAG (Table 2 features)."""
    op_type: int
    partition_type: int
    est_cardinality: float          # optimizer estimate (noisy)
    input_cardinality: float
    input_children_cardinality: float
    avg_row_length: float
    est_cost: float
    est_exclusive_cost: float
    est_total_cost: float
    num_partitions: int
    num_partitioning_columns: int
    num_sort_columns: int

    def feature_row(self) -> np.ndarray:
        """Continuous+count features (log1p-compressed), then one-hots."""
        cont = np.log1p([
            self.est_cardinality, self.input_cardinality,
            self.input_children_cardinality, self.avg_row_length,
            self.est_cost, self.est_exclusive_cost, self.est_total_cost,
        ])
        cnt = [np.log2(1.0 + self.num_partitions), self.num_partitioning_columns,
               self.num_sort_columns]
        op_1h = np.zeros(NUM_OP_TYPES)
        op_1h[self.op_type] = 1.0
        pt_1h = np.zeros(NUM_PARTITION_TYPES)
        pt_1h[self.partition_type] = 1.0
        return np.concatenate([cont, cnt, op_1h, pt_1h]).astype(np.float32)


OPERATOR_FEATURE_DIM = 7 + 3 + NUM_OP_TYPES + NUM_PARTITION_TYPES  # = 49


@dataclasses.dataclass
class Stage:
    """Execution stage: ``num_tasks`` independent tasks, each one token for
    ``task_duration`` seconds, runnable once every stage in ``deps`` finished."""
    op_ids: List[int]
    num_tasks: int
    task_duration: int
    deps: List[int]


@dataclasses.dataclass
class Job:
    job_id: int
    operators: List[Operator]
    edges: List[Tuple[int, int]]     # operator DAG (src -> dst)
    stages: List[Stage]
    default_tokens: int              # what the "user" asked for

    @property
    def peak_parallelism(self) -> int:
        return max(s.num_tasks for s in self.stages)

    @property
    def total_work(self) -> int:
        """Token-seconds of actual work (area lower bound of any skyline)."""
        return int(sum(s.num_tasks * s.task_duration for s in self.stages))

    def num_operators(self) -> int:
        return len(self.operators)

    def num_stages(self) -> int:
        return len(self.stages)


# ----------------------------------------------------------------- sampling --
def _sample_stage_chain(trng: np.random.RandomState,
                        irng: np.random.RandomState, n_ops: int,
                        input_card: float, nparts: int,
                        op_pool: Optional[Sequence[int]] = None
                        ) -> Tuple[List[Operator], float]:
    """Chain of operators inside one stage; returns (ops, output cardinality).

    Structural draws (operator types, row lengths, partitioning) come from
    the *template* rng; optimizer-estimate noise from the *instance* rng.
    ``op_pool`` restricts the operator-type draw to a subset (drifted
    "new-operator" templates); ``None`` keeps the full-space draw bitwise.
    """
    ops: List[Operator] = []
    card = input_card
    child_card = input_card
    total_cost_acc = 0.0
    for _ in range(n_ops):
        if op_pool is None:
            ot = int(trng.randint(NUM_OP_TYPES))
        else:
            ot = int(op_pool[trng.randint(len(op_pool))])
        out_card = max(1.0, card * OP_SELECTIVITY[ot])
        row_len = float(np.clip(trng.lognormal(4.2, 0.7), 8, 4096))
        true_cost = card * OP_COST_COEFF[ot] * row_len * 1e-6
        noisy = lambda x: float(x * irng.lognormal(0.0, 0.35))
        exc = noisy(true_cost)
        total_cost_acc += exc
        ops.append(Operator(
            op_type=ot,
            partition_type=int(trng.randint(NUM_PARTITION_TYPES)),
            est_cardinality=noisy(out_card),
            input_cardinality=noisy(card),
            input_children_cardinality=noisy(child_card),
            avg_row_length=row_len,
            est_cost=noisy(true_cost),
            est_exclusive_cost=exc,
            est_total_cost=total_cost_acc,
            num_partitions=nparts,
            num_partitioning_columns=int(trng.randint(0, 4)),
            num_sort_columns=int(trng.randint(0, 5)),
        ))
        child_card = card
        card = out_card
    return ops, card


def sample_job(job_id: int, rng: np.random.RandomState,
               template_seed: Optional[int] = None, *,
               volume_scale: float = 1.0,
               op_pool: Optional[Sequence[int]] = None) -> Job:
    """One SCOPE-like job. Widths/durations give the §5 population shape.

    Recurrence: production SCOPE workloads are dominated by *recurring*
    pipelines — the same script re-submitted over fresh data. Passing a
    ``template_seed`` fixes every structural draw (DAG shape, operator
    types, row lengths, partition jitter) while the instance ``rng`` still
    varies the data volume, estimate noise, execution noise, and the user's
    token request. Ad-hoc jobs simply use a fresh template per job.

    ``volume_scale`` multiplies the template's base data volume and
    ``op_pool`` restricts its operator-type draws — the ``DriftSpec``
    levers. At the defaults (1.0, None) the draw sequence is bitwise the
    pre-drift one.
    """
    trng = np.random.RandomState(template_seed if template_seed is not None
                                 else rng.randint(2**31 - 1))
    n_stages = 1 + min(int(trng.geometric(0.30)), 11)
    operators: List[Operator] = []
    edges: List[Tuple[int, int]] = []
    stages: List[Stage] = []
    stage_out_card: List[float] = []
    stage_last_op: List[int] = []
    # instance-level data volume scale (the "fresh day of data")
    base_card = float(np.clip(trng.lognormal(15.2, 1.2), 1e3, 3e10))
    base_card = float(np.clip(base_card * volume_scale, 1e3, 3e10))
    inst_scale = float(rng.lognormal(0.0, 0.5))

    for sid in range(n_stages):
        if sid == 0:
            deps: List[int] = []
            input_card = base_card * inst_scale
        else:
            k = 1 + int(trng.rand() < 0.3)
            deps = sorted(trng.choice(sid, size=min(k, sid), replace=False).tolist())
            input_card = float(sum(stage_out_card[d] for d in deps))

        # SCOPE semantics: the partition count is a compile-time quantity
        # that fixes the stage's task count (width); per-task work follows
        # from rows-per-partition. Both are *observable* through Table-2
        # features (num_partitions exactly, costs noisily) — the learnable
        # signal. Partitioning roughly tracks data volume with 2x jitter.
        nparts = int(2 ** np.clip(
            np.round(np.log2(max(input_card, 1.0) / 5e4)
                     + trng.uniform(-1.0, 1.0)), 0, 13))
        n_ops = 1 + int(trng.geometric(0.45))
        ops, out_card = _sample_stage_chain(trng, rng, min(n_ops, 6),
                                            input_card, nparts,
                                            op_pool=op_pool)
        base = len(operators)
        operators.extend(ops)
        # chain ops within the stage
        for i in range(len(ops) - 1):
            edges.append((base + i, base + i + 1))
        # connect from the last op of each dependency stage
        for d in deps:
            edges.append((stage_last_op[d], base))

        width = int(np.clip(nparts, 1, MAX_TOKENS))
        rows_per_task = input_card / nparts
        coeff = float(np.mean([OP_COST_COEFF[o.op_type] for o in ops]))
        dur = int(np.clip(round(rows_per_task * coeff * 8e-4
                                * rng.lognormal(0.0, 0.25)), 1, 1200))
        stages.append(Stage(op_ids=list(range(base, base + len(ops))),
                            num_tasks=width, task_duration=dur, deps=deps))
        stage_out_card.append(out_card)
        stage_last_op.append(base + len(ops) - 1)

    peak = max(s.num_tasks for s in stages)
    # users rarely allocate thoughtfully: mostly defaults / round numbers
    if rng.rand() < 0.5:
        default = int(rng.choice([20, 50, 100, 200, 500],
                                 p=[0.15, 0.35, 0.30, 0.15, 0.05]))
    else:
        default = int(np.clip(round(peak * rng.lognormal(0.0, 0.6)),
                              1, MAX_TOKENS))
    return Job(job_id=job_id, operators=operators, edges=edges, stages=stages,
               default_tokens=max(1, default))


def build_corpus(n_jobs: int, seed: int = 0, *, recurring_frac: float = 0.8,
                 jobs_per_template: int = 20,
                 rng: Optional[np.random.Generator] = None) -> List[Job]:
    """Corpus with SCOPE-like recurrence: ``recurring_frac`` of jobs are
    instances of a shared template pool; the rest are ad-hoc one-offs.

    All entropy comes from the single explicit ``seed`` (or, when ``rng`` —
    a ``numpy.random.Generator`` — is given, from its stream; ``seed`` is
    then ignored). The draw sequence itself is RandomState-based so corpora
    stay bitwise-stable across releases for a given integer seed.
    """
    if rng is not None:
        seed = int(rng.integers(2**31 - 1))
    rng = np.random.RandomState(seed)
    n_templates = max(1, int(n_jobs * recurring_frac / jobs_per_template))
    template_seeds = rng.randint(2**31 - 1, size=n_templates)
    jobs = []
    for i in range(n_jobs):
        if rng.rand() < recurring_frac:
            ts = int(template_seeds[rng.randint(n_templates)])
            jobs.append(sample_job(i, rng, template_seed=ts))
        else:
            jobs.append(sample_job(i, rng))
    return jobs


# ------------------------------------------------------------------- drift --
@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Workload drift over trace time (the MLOps-loop injector).

    Threaded through the single ``TraceGenerator._event_chunks`` path, so
    ``generate()`` and ``stream()`` see the *same* drifted trace bitwise.
    Three levers, all parameterized by trace-time phase t = event index /
    (n_events - 1):

      * **template-mix rotation** — ``n_new`` drifted templates are
        introduced one at a time, evenly spaced between ``onset`` and the
        end of the trace; the probability that an arrival picks from the
        introduced pool (instead of the stationary Zipf head) ramps
        linearly from 0 at ``onset`` to ``rotation`` at the end;
      * **data-volume growth curve** — the template introduced at phase f
        is sampled with its base cardinality scaled by
        ``volume_growth ** f``: effective data volume grows along the
        introduction curve, exactly the "same script over ever more data"
        recurrence story;
      * **new-operator introduction** — the last ``new_op_frac`` fraction
        of drifted templates draw operators from ``DRIFT_OP_POOL`` only,
        shifting the one-hot feature mix (covariate drift) on top of the
        cost shift (concept drift).

    ``DriftSpec(n_new=0)`` / ``rotation=0.0`` (or ``drift=None`` on the
    generator) is bitwise-inert: the stationary path performs exactly the
    pre-drift RNG draws.
    """
    n_new: int = 64
    onset: float = 0.25
    rotation: float = 0.6
    volume_growth: float = 4.0
    new_op_frac: float = 0.5

    def __post_init__(self):
        assert self.n_new >= 0, self.n_new
        assert 0.0 <= self.onset < 1.0, self.onset
        assert 0.0 <= self.rotation <= 1.0, self.rotation
        assert self.volume_growth > 0.0, self.volume_growth
        assert 0.0 <= self.new_op_frac <= 1.0, self.new_op_frac

    @property
    def active(self) -> bool:
        return self.n_new > 0 and self.rotation > 0.0

    def intro_fracs(self) -> np.ndarray:
        """Trace-time phase at which each drifted template becomes
        pickable (ascending; the template-introduction schedule)."""
        d = np.arange(self.n_new, dtype=np.float64)
        return self.onset + (1.0 - self.onset) * (d + 1.0) / (self.n_new + 1)

    def volume_scales(self) -> np.ndarray:
        """Per-drift-template data-volume multiplier (the growth curve)."""
        return np.asarray(self.volume_growth, np.float64) ** self.intro_fracs()


# ----------------------------------------------------------------- tracing --
@dataclasses.dataclass(frozen=True)
class SLAClass:
    """Per-tenant service class: a bound on end-to-end slowdown (queueing
    wait + execution, relative to the query's observed production runtime)
    and an admission priority (lower = more urgent)."""
    name: str
    slowdown_limit: float
    priority: int


DEFAULT_SLA_CLASSES: Tuple[SLAClass, ...] = (
    SLAClass("interactive", 2.0, 0),
    SLAClass("standard", 4.0, 1),
    SLAClass("batch", 10.0, 2),
)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One query arrival in a cluster trace."""
    query_id: int      # position in the trace
    arrival_s: float
    job_index: int     # index into Trace.jobs (the unique-query pool)
    tenant: int
    sla: int           # index into Trace.sla_classes
    # absolute completion deadline implied by the SLA: arrival plus the
    # class's slowdown limit times the query's ideal (observed) runtime —
    # the quantity EDF admission orders by. inf == no deadline (legacy).
    deadline_s: float = float("inf")


@dataclasses.dataclass
class TraceChunk:
    """One columnar slice of a streamed trace (events [start, start+len)).

    Same columns as ``Trace.arrays()`` — chunks from
    ``TraceGenerator.stream`` concatenate bitwise-identically to the bulk
    ``generate`` columns, so a chunk-driven replay sees the exact trace the
    in-memory path does.
    """
    start: int
    arrival_s: np.ndarray
    job_index: np.ndarray
    tenant: np.ndarray
    sla: np.ndarray
    deadline_s: np.ndarray

    def __len__(self) -> int:
        return len(self.arrival_s)


@dataclasses.dataclass
class TraceStream:
    """A trace too large to materialize: the unique-query pool up front
    (bounded by ``n_unique``, shared by every event), events on demand in
    columnar chunks. ``chunks()`` restarts the stream from event 0 each
    call — the generator children re-derive the same draws."""
    jobs: List[Job]
    skylines: List[np.ndarray]
    sla_classes: Tuple["SLAClass", ...]
    seed: int
    n_events: int
    chunk_size: int
    _generator: "TraceGenerator"
    _cache: Optional[List[TraceChunk]] = None

    def __len__(self) -> int:
        return self.n_events

    def chunks(self):
        if self._cache is not None:
            return iter(self._cache)
        return self._generator._event_chunks(self.n_events, self.chunk_size,
                                             self.skylines)

    def buffer(self) -> "TraceStream":
        """Materialize the chunks once (the MMPP arrival chain is a
        sequential host loop); later ``chunks()`` calls replay the cached
        columns — so a timed replay measures the fabric, not the RNG."""
        if self._cache is None:
            self._cache = list(self.chunks())
        return self


@dataclasses.dataclass
class Trace:
    """A replayable multi-tenant query stream.

    ``jobs`` is the unique-query pool; repeat queries reference the same
    ``job_index`` (the paper's "past observed" case — the identical script
    re-submitted). ``skylines[u]`` is the canonical observed production run
    of pool entry ``u`` at its default allocation: the history the online
    refinement loop replays through AREPAS.
    """
    events: List[TraceEvent]
    jobs: List[Job]
    skylines: List[np.ndarray]
    sla_classes: Tuple[SLAClass, ...]
    seed: int

    def __len__(self) -> int:
        return len(self.events)

    def arrays(self) -> Dict[str, np.ndarray]:
        """Columnar view for vectorized consumption by the simulator."""
        return {
            "arrival_s": np.array([e.arrival_s for e in self.events]),
            "job_index": np.array([e.job_index for e in self.events], np.int64),
            "tenant": np.array([e.tenant for e in self.events], np.int64),
            "sla": np.array([e.sla for e in self.events], np.int64),
            "deadline_s": np.array([e.deadline_s for e in self.events]),
        }

    def repeat_mask(self) -> np.ndarray:
        """(n_events,) bool: query had already appeared earlier in the trace."""
        seen: set = set()
        out = np.zeros(len(self.events), bool)
        for i, e in enumerate(self.events):
            out[i] = e.job_index in seen
            seen.add(e.job_index)
        return out


class TraceGenerator:
    """Synthesize cluster traces, reproducible from one explicit seed.

    All randomness flows from ``np.random.SeedSequence(seed)`` through
    spawned ``numpy.random.Generator`` children (pool / arrivals / popularity
    / tenancy) — no module-level or global RNG state anywhere.

      * arrivals: Markov-modulated Poisson — a calm state at ``rate_qps`` and
        a burst state at ``rate_qps * burst_factor``, switching with
        probabilities ``p_burst`` / ``p_calm`` per event;
      * repeats: query identity drawn from a Zipf-like power law over the
        unique pool (production SCOPE traffic is dominated by recurring
        scripts), so a small head of queries repeats heavily;
      * tenancy: each unique query belongs to one tenant; tenants are spread
        round-robin over the SLA classes.

    ``drift`` (a ``DriftSpec``) injects non-stationarity: extra drifted
    templates appended to the pool and a time-varying pick mixture inside
    ``_event_chunks`` — the one path both ``generate`` and ``stream``
    consume, so bulk and chunked replays stay bitwise-identical under
    drift, and ``drift=None`` draws exactly the stationary streams.
    """

    def __init__(self, seed: int = 0, *, n_unique: int = 256,
                 n_tenants: int = 8, zipf_exponent: float = 1.2,
                 rate_qps: float = 0.5, burst_factor: float = 4.0,
                 p_burst: float = 0.05, p_calm: float = 0.25,
                 sla_classes: Tuple[SLAClass, ...] = DEFAULT_SLA_CLASSES,
                 max_skyline_s: int = 16384,
                 drift: Optional[DriftSpec] = None):
        assert n_unique >= 1 and n_tenants >= 1 and rate_qps > 0
        self.seed = seed
        self.n_unique = n_unique
        self.n_tenants = n_tenants
        self.zipf_exponent = zipf_exponent
        self.rate_qps = rate_qps
        self.burst_factor = burst_factor
        self.p_burst = p_burst
        self.p_calm = p_calm
        self.sla_classes = tuple(sla_classes)
        self.max_skyline_s = max_skyline_s
        self.drift = drift if (drift is not None and drift.active) else None
        self._children = np.random.SeedSequence(seed).spawn(5)

    def _gen(self, i: int) -> np.random.Generator:
        return np.random.default_rng(self._children[i])

    def _build_pool(self) -> Tuple[List[Job], List[np.ndarray]]:
        """Unique-query pool + canonical observed skylines (bounded length).

        With drift, the ``n_new`` drifted templates are appended after the
        stationary pool from the *same* continuing generator stream — the
        stationary prefix stays bitwise the no-drift pool."""
        from tasq_bench.traffic.executor import observed_skyline  # no import cycle
        g = self._gen(0)
        jobs: List[Job] = []
        skylines: List[np.ndarray] = []

        def add(u: int, volume_scale: float = 1.0, op_pool=None) -> None:
            for _ in range(32):  # resample pathologically long-running jobs
                rng = np.random.RandomState(int(g.integers(2**31 - 1)))
                job = sample_job(u, rng, volume_scale=volume_scale,
                                 op_pool=op_pool)
                sky = observed_skyline(job)
                if len(sky) <= self.max_skyline_s:
                    break
            jobs.append(job)
            skylines.append(sky)

        for u in range(self.n_unique):
            add(u)
        if self.drift is not None:
            scales = self.drift.volume_scales()
            n_new_op = int(round(self.drift.n_new * self.drift.new_op_frac))
            for d in range(self.drift.n_new):
                add(self.n_unique + d, volume_scale=float(scales[d]),
                    op_pool=(DRIFT_OP_POOL
                             if d >= self.drift.n_new - n_new_op else None))
        return jobs, skylines

    def _arrival_times(self, n: int) -> np.ndarray:
        g = self._gen(1)
        gaps = np.empty(n)
        burst = False
        for i in range(n):
            rate = self.rate_qps * (self.burst_factor if burst else 1.0)
            gaps[i] = g.exponential(1.0 / rate)
            burst = (g.random() < self.p_burst if not burst
                     else g.random() >= self.p_calm)
        return np.cumsum(gaps)

    def _popularity(self) -> np.ndarray:
        """Zipf weights over the pool, rank order shuffled."""
        g = self._gen(2)
        ranks = g.permutation(self.n_unique)
        p = (1.0 + ranks) ** -self.zipf_exponent
        return p / p.sum()

    def _event_chunks(self, n_events: int, chunk_size: int,
                      skylines: List[np.ndarray]):
        """Yield ``TraceChunk`` slices, bitwise-equal to the bulk columns.

        The MMPP arrival loop carries its (burst state, absolute time)
        across chunks on one continuing generator stream; the identity-pick
        stream draws per chunk from the same ``Generator`` (chunked
        ``choice``/``exponential`` draws concatenate exactly to the bulk
        draw). The absolute-time carry is seeded into the cumsum
        (``cumsum([t_prev, *gaps])[1:]``), reproducing the bulk cumsum's
        left-to-right rounding — plain ``t_prev + cumsum(gaps)`` would not.
        """
        assert chunk_size >= 1
        g_arr = self._gen(1)
        pop = self._popularity()
        g_pick, g_tenant = self._gen(3), self._gen(4)
        drift = self.drift
        n_pool = self.n_unique + (drift.n_new if drift is not None else 0)
        tenant_of_job = g_tenant.integers(self.n_tenants, size=n_pool)
        sla_of_tenant = np.arange(self.n_tenants) % len(self.sla_classes)
        sla_of_job = sla_of_tenant[tenant_of_job]
        limits = np.array([c.slowdown_limit for c in self.sla_classes])
        ideal = np.array([len(s) for s in skylines], np.float64)
        if drift is not None:
            intro = drift.intro_fracs()
            base_cdf = np.cumsum(pop)
        burst = False
        t_prev = 0.0
        start = 0
        while start < n_events:
            m = min(chunk_size, n_events - start)
            gaps = np.empty(m)
            for i in range(m):
                rate = self.rate_qps * (self.burst_factor if burst else 1.0)
                gaps[i] = g_arr.exponential(1.0 / rate)
                burst = (g_arr.random() < self.p_burst if not burst
                         else g_arr.random() >= self.p_calm)
            arrivals = np.cumsum(np.concatenate([[t_prev], gaps]))[1:]
            t_prev = float(arrivals[-1])
            if drift is None:
                picks = g_pick.choice(self.n_unique, size=m, p=pop)
            else:
                # time-varying pick mixture: with probability w(t) (the
                # rotation ramp, gated on at least one introduced template
                # being available at phase t) the arrival picks uniformly
                # from the introduced pool, else from the stationary Zipf
                # head. Two uniforms per event in one (m, 2) block —
                # elementwise stream consumption, so chunked draws
                # concatenate exactly to the bulk draws and phase is a
                # function of the absolute event index, never the chunking.
                u = g_pick.random((m, 2))
                phase = (np.arange(start, start + m, dtype=np.float64)
                         / max(n_events - 1, 1))
                ramp = np.clip((phase - drift.onset)
                               / max(1.0 - drift.onset, 1e-9), 0.0, 1.0)
                n_avail = np.searchsorted(intro, phase, side="right")
                w = drift.rotation * ramp * (n_avail > 0)
                base = np.minimum(
                    np.searchsorted(base_cdf, u[:, 1], side="right"),
                    self.n_unique - 1)
                new = self.n_unique + np.minimum(
                    (u[:, 1] * np.maximum(n_avail, 1)).astype(np.int64),
                    np.maximum(n_avail - 1, 0))
                picks = np.where(u[:, 0] < w, new, base)
            picks = picks.astype(np.int64)
            sla = sla_of_job[picks].astype(np.int64)
            yield TraceChunk(
                start=start, arrival_s=arrivals, job_index=picks,
                tenant=tenant_of_job[picks].astype(np.int64), sla=sla,
                deadline_s=arrivals + limits[sla] * ideal[picks])
            start += m

    def stream(self, n_events: int, chunk_size: int = 65536) -> TraceStream:
        """Chunked trace for replays too large to materialize (the 1M-event
        benchmark): the unique pool is built once, events arrive as
        ``TraceChunk`` columns identical to the bulk ``generate`` trace."""
        jobs, skylines = self._build_pool()
        return TraceStream(jobs=jobs, skylines=skylines,
                           sla_classes=self.sla_classes, seed=self.seed,
                           n_events=n_events, chunk_size=chunk_size,
                           _generator=self)

    def generate(self, n_events: int) -> Trace:
        jobs, skylines = self._build_pool()
        events = []
        for ch in self._event_chunks(n_events, max(n_events, 1), skylines):
            for i in range(len(ch)):
                events.append(TraceEvent(
                    query_id=ch.start + i, arrival_s=float(ch.arrival_s[i]),
                    job_index=int(ch.job_index[i]),
                    tenant=int(ch.tenant[i]), sla=int(ch.sla[i]),
                    deadline_s=float(ch.deadline_s[i])))
        return Trace(events=events, jobs=jobs, skylines=skylines,
                     sla_classes=self.sla_classes, seed=self.seed)


def population_stats(jobs: Sequence[Job]) -> dict:
    toks = np.array([j.default_tokens for j in jobs])
    peaks = np.array([j.peak_parallelism for j in jobs])
    return {
        "n_jobs": len(jobs),
        "tokens_median": float(np.median(toks)),
        "tokens_mean": float(np.mean(toks)),
        "tokens_max": int(np.max(toks)),
        "peak_median": float(np.median(peaks)),
        "peak_max": int(np.max(peaks)),
    }
