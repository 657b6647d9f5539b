"""The decide stages' allocation policy, ``kernels.ops.policy_decide``, on
the CPU: its plain version is the torch twin (``choose_tokens_torch`` /
``choose_tokens_priced_torch``) plus the runtime ``b * tok**a``, bitwise,
for every registered policy, priced and neutral, with and without observed
caps; every decision stage of ``serve/service.py`` takes its policy from
it, once a stage call; and kernel K6 (``decide_policy_kernel`` in
``csrc/cluster_step.cu``) is K3's priced decision under a name the
benchmark's K1-K3 readers do not match. K6 itself is held to the twin on
the card by ``tests/test_torch_decide_kernel_cuda.py``."""
import re

import numpy as np
import pytest
import torch

from repro_torch.api import AllocationRequest, DecisionContext
from repro_torch.core.allocator import (build_policy, choose_tokens_priced_torch,
                                        choose_tokens_torch)
from repro_torch.core.featurize import Standardizer
from repro_torch.core.models import build_model
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cluster_step as cs
from repro_torch.serve import service
from repro_torch.serve.service import AllocationService, ShardedAllocationService

POLICIES = ("default", "marginal_gain", "bounded_slowdown")
SCALER = PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5)
N_FEATURES = 51


def _rows(seed, n, policy):
    """(a, b, price, observed) float64 / int64 rows over the policy's whole
    range: a in [-2, 0.5] with exact zeros, b in [1e-3, 1e6], prices in
    [0.05, 20], observed caps of 0, 1, min_tokens, max_tokens, inside the
    cell's range and up to 2^40."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-2.0, 0.5, n)
    a[rng.rand(n) < 0.05] = 0.0
    b = 10.0 ** rng.uniform(-3.0, 6.0, n)
    price = 10.0 ** rng.uniform(np.log10(0.05), np.log10(20.0), n)
    obs = rng.randint(2, policy.max_tokens + 1, n).astype(np.int64)
    pick = rng.rand(n)
    obs[pick < 0.2] = (2.0 ** rng.uniform(13, 40, n)).astype(np.int64)[
        pick < 0.2]
    edge = np.array([0, 1, policy.min_tokens, policy.max_tokens, 2**40],
                    np.int64)
    obs[pick > 0.9] = rng.choice(edge, n)[pick > 0.9]
    return a, b, price, obs


def _bits(t):
    return t.numpy().view(np.int64)


def _twin(a, b, policy, price, observed):
    if price is None:
        toks = choose_tokens_torch(a, b, policy, observed)
    else:
        toks = choose_tokens_priced_torch(a, b, policy, price, observed)
    return toks, b * toks.to(a.dtype) ** a


@pytest.mark.parametrize("with_observed", [True, False])
@pytest.mark.parametrize("priced", [True, False])
@pytest.mark.parametrize("name", POLICIES)
def test_policy_decide_on_cpu_is_the_torch_twin(name, priced, with_observed):
    policy = build_policy(name)
    a, b, price, obs = (torch.from_numpy(x) for x in _rows(
        POLICIES.index(name) * 4 + 2 * priced + with_observed, 3000, policy))
    price = price if priced else None
    obs = obs if with_observed else None
    toks, rt = ops.policy_decide(a, b, policy, price, obs)
    want_toks, want_rt = _twin(a, b, policy, price, obs)
    assert toks.dtype == torch.int64 and rt.dtype == torch.float64
    np.testing.assert_array_equal(_bits(toks), _bits(want_toks))
    np.testing.assert_array_equal(_bits(rt), _bits(want_rt))


def _nn_model():
    g = torch.Generator().manual_seed(3)
    feats = np.random.RandomState(4).lognormal(0.0, 1.0, (64, N_FEATURES))
    module = MLP(N_FEATURES, (32, 16), generator=g)
    return build_model("nn", device="cpu").load(
        module, scaler=SCALER, std=Standardizer(feats))


def _stage_call(kind, with_observed, policy, rng, Bp=16):
    """(stage, its CPU arguments, the outputs the torch twin gives)."""
    a, b, price, obs = (torch.from_numpy(x) for x in _rows(rng, Bp, policy))
    obs_in = obs if with_observed else None
    if kind in ("fused", "sharded_fused"):
        model = _nn_model()
        x = {"features": torch.from_numpy(np.random.RandomState(rng).lognormal(
            0.0, 1.0, (Bp, N_FEATURES)).astype(np.float32))}
        make = (service.make_fused_decide if kind == "fused"
                else service.make_sharded_fused_per_shard)
        with torch.inference_mode():
            za, zb = SCALER.decode(model.serve_apply(x))
            toks, rt = _twin(za.double(), zb.double(), policy, None, obs_in)
        return (make(model, policy, with_observed), (x, obs),
                (toks, za, zb, rt))
    if kind == "policy":
        return (service.make_policy_decide(policy, with_observed),
                (a, b, obs), _twin(a, b, policy, None, obs_in))
    if kind == "priced":
        return (service.make_priced_decide(policy, with_observed),
                (a, b, price, obs), _twin(a, b, policy, price, obs_in))
    priced = kind == "sharded_priced"
    return (service.make_sharded_policy_per_shard(policy, with_observed,
                                                  priced),
            (a, b, price, obs),
            _twin(a, b, policy, price if priced else None, obs_in))


@pytest.mark.parametrize("with_observed", [True, False])
@pytest.mark.parametrize("kind", ["policy", "priced", "fused",
                                  "sharded_policy", "sharded_priced",
                                  "sharded_fused"])
def test_stage_factories_take_their_policy_from_ops(monkeypatch, kind,
                                                    with_observed):
    """Each stage calls ``ops.policy_decide`` once, with a price only where
    it prices and a cap only where it honours observed tokens, and returns
    the twin's outputs."""
    calls = []
    real = ops.policy_decide

    def counted(a, b, policy, price=None, observed=None):
        calls.append((price is not None, observed is not None))
        return real(a, b, policy, price, observed)

    monkeypatch.setattr(ops, "policy_decide", counted)
    policy = build_policy("bounded_slowdown")
    stage, args, want = _stage_call(kind, with_observed, policy,
                                    len(kind) + with_observed)
    with torch.inference_mode():
        got = stage(*args)
    assert calls == [(kind in ("priced", "sharded_priced"), with_observed)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def test_every_decide_reaches_the_policy_once_a_stage_call(monkeypatch):
    """Through the service and the fabric on the CPU: the history, priced
    and model paths (the priced model path runs two stages) each call
    ``ops.policy_decide`` once for every stage call ``stats`` counts."""
    calls = []
    real = ops.policy_decide
    monkeypatch.setattr(ops, "policy_decide", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    policy = build_policy("bounded_slowdown")
    svc = AllocationService(_nn_model(), policy, device="cpu")
    fabric = ShardedAllocationService(svc, 4)
    rng = np.random.RandomState(5)
    B = 40
    a, b, price, obs = _rows(6, B, policy)
    x = {"features": rng.lognormal(0.0, 1.0, (B, N_FEATURES)).astype(
        np.float32)}
    shard_of = rng.randint(0, 4, B)
    for engine, ctx in ((svc, {}), (fabric, {"shard_of": shard_of})):
        for req, extra in ((AllocationRequest(a=a, b=b,
                                              observed_tokens=obs), {}),
                           (AllocationRequest(a=a, b=b), {"price": price}),
                           (AllocationRequest(model_in=x,
                                              observed_tokens=obs), {}),
                           (AllocationRequest(model_in=x),
                            {"price": price})):
            calls.clear()
            before = svc.stats["calls"]
            engine.decide(req, DecisionContext(**ctx, **extra))
            assert len(calls) == svc.stats["calls"] - before >= 1


def test_k6_is_k3s_decision_under_its_own_name():
    """K6 calls K3's ``priced_decision`` (one definition of the decision),
    and each fragment by which the benchmark's K1-K3 rooflines find their
    kernels' device time still names one kernel of the port alone."""
    src = {name: (_build.CSRC / f).read_text()
           for name, f in _build.SOURCES.items()}
    kernels = [k for text in src.values() for k in re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", text)]
    assert "decide_policy_kernel" in kernels
    cs_src = src["cluster_step"]
    assert len(re.findall(r"priced_decision\(double a", cs_src)) == 1
    body = cs_src[cs_src.index("decide_policy_kernel(const double*"):]
    assert "priced_decision(" in body[:body.index("\n}\n")]
    for fragment in ("arepas_runtimes_kernel", "epoch_step_kernel",
                     "resize_step_kernel"):
        assert sum(fragment in k for k in kernels) == 1, (fragment, kernels)


def test_the_kernel_wrapper_refuses_host_tensors():
    a = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="runs on the card"):
        cs.policy_decide(a, a, build_policy("default"))
    before = ops.launch_counts()["policy_decide"]
    ops.policy_decide(a, a, build_policy("default"))
    assert ops.launch_counts()["policy_decide"] == before
