"""The fabric's fused GNN decide on the card, after K6: the stage that
cluster control runs for every first sighting of a template.

A seeded GNN (the reference's widths, its last layer scaled so that its
outputs over the plans have mean 0 and spread 1, as a trained model's
scaled targets do) decides plans padded to 50 operators, the node count
of the benchmark's template pool, in (K = 4, Bp) blocks through
``ShardedAllocationService`` on the card and through the same fabric on
the CPU, on the same weights, plans, observed caps and shard placement.
On the card the stage is a captured CUDA graph whose replay runs one K6
and repeats the capture's decisions; its tokens equal the CPU twin's bit
for bit, and its decoded (a, b) lie within 2e-4 of the CPU twin's,
relatively.

Why 2e-4: the model runs in float32, and the card's matrix products sum
in another order than the CPU's, so the decoded (a, b) differ by a few
float32 roundings, amplified by the decode's exponential (the benchmark
read at most 1.13e-5 against a float64 forward, where TF32 reads 3.5e-2).
2e-4 is the limit of the benchmark cell ``gnn-cluster-novel`` on the same
gap; TF32 would exceed it, and the test checks that TF32 is off.

A cluster pass's resident skyline pool, scattered on the card from the
skylines' seconds, equals the padded host construction bit for bit on a
1,024-template trace.

Needs an NVIDIA card: marked ``cuda``; each test decides inside itself
whether a card is present. Run on the card with
``python -m pytest -m cuda tests/test_torch_gnn_cluster_cuda.py``.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.api import AllocationRequest, DecisionContext
from repro_torch.cluster import ClusterConfig
from repro_torch.cluster.simulator import ClusterSimulator
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.featurize import (OPERATOR_FEATURE_DIM, Standardizer,
                                        batch_graphs, batch_job_features)
from repro_torch.core.models import build_model
from repro_torch.core.models.gnn import GNN, GNNConfig
from repro_torch.core.pcc import PCCScaler
from repro_torch.kernels import ops
from repro_torch.serve import AllocationService
from repro_torch.serve.service import ShardedAllocationService
from repro_torch.workloads import TraceGenerator

K, N = 4, 50
ROWS = (5, 61, 230)                 # rows a decide
GAP = 2e-4
SCALER = PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _plans():
    """Graph inputs of the pool's plans with at most N operators, padded to
    N, and each plan's observed tokens."""
    jobs = TraceGenerator(seed=71, n_unique=512,
                          zipf_exponent=0.6).generate(8).jobs
    jobs = [j for j in jobs if j.num_operators() <= N]
    f, adj, mask = batch_graphs(jobs, N)
    obs = np.array([j.default_tokens for j in jobs], np.int64)
    return {"features": f, "adj": adj, "mask": mask}, obs, jobs


def _calibrated(model_in):
    """The seeded GNN with its last layer scaled over ``model_in``."""
    cfg = GNNConfig()
    module = GNN(OPERATOR_FEATURE_DIM, cfg,
                 generator=torch.Generator().manual_seed(71))
    with torch.no_grad():
        z = copy.deepcopy(module).double()(
            {k: torch.from_numpy(v).double() for k, v in model_in.items()})
        m, s = z.mean(0), z.std(0).clamp(min=1e-12)
        last = module.head.layers[-1]
        last.weight.copy_((last.weight.double() / s[:, None]).float())
        last.bias.copy_(((last.bias.double() - m) / s).float())
    return cfg, module


def _fabric(cfg, module, std, device):
    model = build_model("gnn", cfg=cfg, device=device).load(
        copy.deepcopy(module), scaler=SCALER, std=std)
    svc = AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                            device=device)
    return ShardedAllocationService(svc, K)


@pytest.mark.cuda
def test_fused_gnn_decide_on_the_card_matches_the_cpu_twin():
    _need_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    model_in, obs, jobs = _plans()
    cfg, module = _calibrated(model_in)
    std = Standardizer(batch_job_features(jobs))
    card = _fabric(cfg, module, std, "cuda")
    host = _fabric(cfg, module, std, "cpu")
    rng = np.random.RandomState(5)
    worst = 0.0
    for B in ROWS:
        rows = rng.choice(len(obs), B, replace=False)
        req = AllocationRequest(model_in={k: v[rows]
                                          for k, v in model_in.items()},
                                observed_tokens=obs[rows])
        ctx = DecisionContext(shard_of=rng.randint(0, K, B))
        first = card.decide(req, ctx)       # captures the block's graph
        before = ops.launch_counts()["policy_decide"]
        d_card = card.decide(req, ctx)      # replays it
        assert ops.launch_counts()["policy_decide"] == before + 1
        np.testing.assert_array_equal(d_card.tokens, first.tokens)
        d_host = host.decide(req, ctx)
        np.testing.assert_array_equal(d_card.tokens, d_host.tokens)
        for x, y in ((d_card.a, d_host.a), (d_card.b, d_host.b)):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            gap = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            worst = max(worst, float(gap.max()))
        assert np.unique(d_host.tokens).size > 1
    assert worst <= GAP, worst
    graphs = list(card.service.replica.compiled.values())
    assert graphs and all(e.graph is not None for e in graphs)
    assert all(e.specs[0]["adj"][0][2:] == (N, N) for e in graphs)


@pytest.mark.cuda
def test_skyline_pool_on_the_card_equals_the_host_construction():
    _need_card()
    trace = TraceGenerator(seed=71, n_unique=1024,
                           zipf_exponent=0.6).generate(1024)
    model_in, _, jobs = _plans()
    cfg, module = _calibrated(model_in)
    card = _fabric(cfg, module, Standardizer(batch_job_features(jobs)),
                   "cuda")
    sim = ClusterSimulator(card.service, ClusterConfig(n_shards=K),
                           fabric=card)
    lens, peaks, areas = sim._skyline_pool(trace)
    assert sim._sky.is_cuda and sim._sky.dtype == torch.int32
    U, smax = len(trace.jobs), max(len(s) for s in trace.skylines)
    sky = np.zeros((U, smax), np.float32)
    for u, s in enumerate(trace.skylines):
        sky[u, :len(s)] = s
    want = (sky.astype(np.int32),
            np.array([len(s) for s in trace.skylines], np.int32),
            sky.max(axis=1).astype(np.int64),
            sky.sum(axis=1, dtype=np.float64))
    got = (sim._sky.cpu().numpy(), lens, peaks, areas)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(sim._lens.cpu().numpy(), want[1])
