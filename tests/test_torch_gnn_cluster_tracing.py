"""The model path of cluster control traced from inside the port, on the
CPU: the pool's featurization and the work counters of the fabric's
model-path decides.

A small ``run_cluster`` pass of a seeded GNN in the benchmark's
configuration (EDF, elastic resize and pricing, fused K2 / K3, 4 shards)
under ``Obs.enabled()``: one ``cluster.featurize`` span inside
``cluster.setup`` with the pool's family, size and padded node count;
``model_rows`` equal to ``cache_miss``; ``model_nodes``,
``model_adj_entries`` and ``model_adj_slots`` equal to the counts made
here from the trace's plans and the fabric's (K, Bp) blocks. An NN pass
counts ``model_rows`` alone. An untraced pass reads no mask and reports
as the traced one, bit for bit.
"""
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.api import Allocator
from repro_torch.cluster import ClusterConfig
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.featurize import (OPERATOR_FEATURE_DIM, Standardizer,
                                        batch_job_features)
from repro_torch.core.models import build_model
from repro_torch.core.models.gnn import GNN, GNNConfig
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.obs import Obs
from repro_torch.serve import AllocationService
from repro_torch.workloads import TraceGenerator

CFG = ClusterConfig(capacity=2048, epoch_s=4.0, n_shards=4, admission="edf",
                    elastic=True, pricing="elastic", fused=True)
SCALER = PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5)
SERVICE = "repro_torch.serve.service"


def _bucket(n, floor=8):
    """The fabric's block width for a fullest shard of ``n`` rows: the
    next power of two from ``floor``."""
    p = floor
    while p < n:
        p *= 2
    return p


def _model(family, trace):
    """A seeded, untrained model on the CPU; the GNN's last layer scaled
    down so that its raw operator features decode to moderate PCCs."""
    g = torch.Generator().manual_seed(5)
    std = Standardizer(batch_job_features(trace.jobs))
    if family == "nn":
        module = MLP(std.mu.shape[0], (32, 16), generator=g)
        return build_model("nn", device="cpu").load(module, scaler=SCALER,
                                                    std=std)
    cfg = GNNConfig()
    module = GNN(OPERATOR_FEATURE_DIM, cfg, generator=g)
    with torch.no_grad():
        module.head.layers[-1].weight.mul_(1e-3)
    return build_model("gnn", cfg=cfg, device="cpu").load(
        module, scaler=SCALER, std=std)


def _pass(model, trace, obs=None):
    """One ``run_cluster`` pass of a fresh service and allocator on
    ``obs``, and the shard placement of each model-path fabric decide."""
    svc = AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                            device="cpu", obs=obs)
    alloc = Allocator(svc, n_shards=CFG.n_shards, obs=obs)
    fabric = alloc.frontend.fabric
    orig, placed = fabric.decide, []

    def decide(request, context=None):
        if request.model_in is not None:
            placed.append(np.asarray(context.shard_of))
        return orig(request, context)

    fabric.decide = decide
    return alloc.run_cluster(trace, CFG), placed


@pytest.fixture(scope="module")
def trace():
    return TraceGenerator(seed=11, n_unique=48, zipf_exponent=0.6,
                          rate_qps=1.0).generate(240)


@pytest.fixture(scope="module")
def gnn_runs(trace):
    """An untraced and a traced GNN pass, the callers of
    ``np.count_nonzero`` in each, and the traced pass's bundle."""
    model = _model("gnn", trace)
    callers = {}
    mp = pytest.MonkeyPatch()
    orig = np.count_nonzero

    def spy(*a, **k):
        callers[key].add(sys._getframe(1).f_globals.get("__name__"))
        return orig(*a, **k)

    mp.setattr(np, "count_nonzero", spy)
    try:
        key = "untraced"
        callers[key] = set()
        untraced, _ = _pass(model, trace)
        key = "traced"
        callers[key] = set()
        obs = Obs.enabled(capacity=1 << 20)
        traced, placed = _pass(model, trace, obs)
    finally:
        mp.undo()
    return types.SimpleNamespace(untraced=untraced, traced=traced, obs=obs,
                                 placed=placed, callers=callers)


def test_featurize_span_inside_setup(gnn_runs, trace):
    spans = gnn_runs.obs.tracer.spans()
    setup = [s for s in spans if s.name == "cluster.setup"]
    feat = [s for s in spans if s.name == "cluster.featurize"]
    assert len(setup) == len(feat) == 1
    s, f = setup[0], feat[0]
    assert f.depth == s.depth + 1 and s.t0 <= f.t0 <= f.t1 <= s.t1
    n_max = max(len(j.operators) for j in trace.jobs)
    assert f.attrs == {"family": "gnn", "jobs": len(trace.jobs),
                       "n_max": n_max}


def test_model_counters_equal_hand_counts(gnn_runs, trace):
    c = gnn_runs.obs.metrics.snapshot()
    rep = gnn_runs.traced
    miss = ~rep.cache_hits
    jb = trace.arrays()["job_index"][miss]
    n = np.array([len(trace.jobs[j].operators) for j in jb], np.int64)
    N = max(len(j.operators) for j in trace.jobs)
    assert c["model_rows"] == c["cache_miss"] == int(miss.sum()) > 0
    assert c["model_nodes"] == int(n.sum())
    assert c["model_adj_entries"] == int(np.sum(n * n))
    slots = sum(CFG.n_shards * _bucket(np.bincount(
        p, minlength=CFG.n_shards).max()) * N * N for p in gnn_runs.placed)
    assert c["model_adj_slots"] == slots
    assert c["model_adj_entries"] < c["model_adj_slots"]


def test_untraced_pass_reads_no_mask_and_reports_alike(gnn_runs):
    a, b = gnn_runs.untraced, gnn_runs.traced
    assert a.metrics == b.metrics
    assert a.n_epochs == b.n_epochs
    np.testing.assert_array_equal(a.alloc_errors, b.alloc_errors)
    np.testing.assert_array_equal(a.cache_hits, b.cache_hits)
    assert a.service_stats == b.service_stats
    assert SERVICE in gnn_runs.callers["traced"]
    assert SERVICE not in gnn_runs.callers["untraced"]


def test_nn_pass_counts_rows_only(trace):
    obs = Obs.enabled(capacity=1 << 20)
    _pass(_model("nn", trace), trace, obs)
    c = obs.metrics.snapshot()
    assert c["model_rows"] == c["cache_miss"] > 0
    assert not {"model_nodes", "model_adj_entries",
                "model_adj_slots"} & set(c)
    feat = [s for s in obs.tracer.spans() if s.name == "cluster.featurize"]
    assert [f.attrs for f in feat] == [{"family": "nn",
                                        "jobs": len(trace.jobs),
                                        "n_max": 0}]
