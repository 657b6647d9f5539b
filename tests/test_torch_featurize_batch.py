"""The port's column-wise batch featurizers against the per-job functions
they stand for: ``batch_graphs`` equals ``pad_graph`` of every job
stacked, and ``batch_job_features`` equals ``job_features`` of every job
stacked, value for value, dtype and shape, on the CPU. The cases: traces
of several seeds and pool sizes, a drifted trace whose new templates
draw from the drifted operator band, an ``n_max`` above the pool's
largest plan (as ``build_dataset`` passes it), a one-operator job, and a
hand-made plan with duplicate, reversed and self edges. On one trace both
also equal the JAX reference's batch functions.
"""
import numpy as np
import pytest

from repro.core import featurize as ref_featurize
from repro.workloads import TraceGenerator as RefTraceGenerator
from repro_torch.core.featurize import (batch_graphs, batch_job_features,
                                        job_features, pad_graph)
from repro_torch.workloads import DriftSpec, TraceGenerator
from repro_torch.workloads.generator import (DRIFT_OP_POOL, Job, Operator,
                                             Stage)


def _op(op_type, partition_type, k):
    """A hand-made operator whose estimates grow with ``k``."""
    return Operator(op_type=op_type, partition_type=partition_type,
                    est_cardinality=1e3 * k, input_cardinality=2e3 * k,
                    input_children_cardinality=3e3 * k,
                    avg_row_length=40.0 + k, est_cost=0.5 * k,
                    est_exclusive_cost=0.25 * k, est_total_cost=0.75 * k,
                    num_partitions=4 * k, num_partitioning_columns=k % 4,
                    num_sort_columns=k % 5)


def _one_operator():
    return Job(job_id=0, operators=[_op(3, 1, 1)], edges=[],
               stages=[Stage(op_ids=[0], num_tasks=2, task_duration=5,
                             deps=[])], default_tokens=2)


def _odd_edges():
    """Four operators; the edges repeat, reverse and loop on a node."""
    ops = [_op(t, t % 4, k) for k, t in enumerate((0, 34, 17, 9), 1)]
    edges = [(0, 1), (0, 1), (1, 0), (1, 2), (3, 2), (2, 3), (2, 2)]
    return Job(job_id=1, operators=ops, edges=edges,
               stages=[Stage(op_ids=[0, 1, 2, 3], num_tasks=3,
                             task_duration=7, deps=[])], default_tokens=3)


def _trace_jobs(seed, n_unique, **kw):
    return TraceGenerator(seed=seed, n_unique=n_unique, **kw).generate(
        4 * n_unique).jobs


def _drifted():
    jobs = _trace_jobs(5, 24, drift=DriftSpec(n_new=12, new_op_frac=0.5))
    banded = [j for j in jobs
              if all(op.op_type in DRIFT_OP_POOL for op in j.operators)]
    assert banded, "no template drew from the drifted operator band"
    return jobs


CASES = {
    "seed3-pool40": lambda: (_trace_jobs(3, 40), 0),
    "seed11-pool200-zipf0.6": lambda: (
        _trace_jobs(11, 200, zipf_exponent=0.6), 0),
    "drifted": lambda: (_drifted(), 0),
    "n_max-above-largest": lambda: (
        _trace_jobs(7, 30), max(len(j.operators)
                                for j in _trace_jobs(7, 30)) + 9),
    "one-operator": lambda: ([_one_operator()], 0),
    "one-operator-among-others": lambda: (
        _trace_jobs(2, 12) + [_one_operator()], 0),
    "duplicate-reversed-edges": lambda: (
        [_odd_edges(), _one_operator()] + _trace_jobs(4, 6), 0),
}


def _stacked_graphs(jobs, n_max):
    if n_max == 0:
        n_max = max(len(j.operators) for j in jobs)
    return tuple(np.stack(x) for x in zip(*(pad_graph(j, n_max)
                                            for j in jobs)))


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got, want), int(np.sum(got != want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_featurizers_equal_the_per_job_functions(case):
    jobs, n_max = CASES[case]()
    for got, want in zip(batch_graphs(jobs, n_max),
                         _stacked_graphs(jobs, n_max)):
        _assert_same(got, want)
    _assert_same(batch_job_features(jobs),
                 np.stack([job_features(j) for j in jobs]))


def test_batch_featurizers_equal_the_reference():
    jobs = _trace_jobs(13, 60, zipf_exponent=0.8)
    ref_jobs = RefTraceGenerator(seed=13, n_unique=60,
                                 zipf_exponent=0.8).generate(240).jobs
    for got, want in zip(batch_graphs(jobs),
                         ref_featurize.batch_graphs(ref_jobs)):
        _assert_same(got, want)
    _assert_same(batch_job_features(jobs),
                 ref_featurize.batch_job_features(ref_jobs))
