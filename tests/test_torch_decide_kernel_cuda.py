"""Kernel K6 (``decide_policy_kernel``, ``csrc/cluster_step.cu``) on the
card: the decide stages' float64 policy through ``ops.policy_decide``.

K6 must be bitwise equal, tokens and runtimes, to its plain version run
eagerly on the card (``choose_tokens_priced_torch`` / ``choose_tokens_torch``
plus ``b * tok**a``) for every registered policy, priced and neutral, with
and without observed caps (0, 1, min_tokens, max_tokens, and past 2^13 up
to 2^40 and beyond 2^48, where the walk stops at 48 levels), at 1, 7, 32
and 16,384 (K x MAX_BATCH) rows and over a million rows in all. A replay
of each decision executable (policy, priced, fused, the fabric's sharded
twins) runs exactly one K6 and no kernel of the torch twin's policy: the
policy executables' other kernels are their output stacking, the fused
ones' the model's and the stacking. Each replay counts its K6 launch.

Needs an NVIDIA card: marked ``cuda``; each test decides inside itself
whether a card is present. Run on the card with
``python -m pytest -m cuda tests/test_torch_decide_kernel_cuda.py``.
"""
import json
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core.allocator import (build_policy, choose_tokens_priced_torch,
                                        choose_tokens_torch)
from repro_torch.core.featurize import Standardizer
from repro_torch.core.models import build_model
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.kernels import ops
from repro_torch.serve.service import (AllocationService,
                                       ShardedAllocationService)

POLICIES = ("default", "marginal_gain", "bounded_slowdown")
ROWS = (1, 7, 32, 16_384, 131_072)
K6 = "decide_policy_kernel"
SCALER = PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5)
N_FEATURES = 51
F64 = torch.float64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _rows(seed, n, policy):
    """(a, b, price, observed) on the card: a in [-2, 0.5] with exact
    zeros, b in [1e-3, 1e6], prices in [0.05, 20], observed caps of 0, 1,
    min_tokens, max_tokens, inside [2, max_tokens], log-uniform from 2^13 to
    2^40, and 2^50 (past the 48 levels of the bisection)."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-2.0, 0.5, n)
    a[rng.rand(n) < 0.05] = 0.0
    b = 10.0 ** rng.uniform(-3.0, 6.0, n)
    price = 10.0 ** rng.uniform(np.log10(0.05), np.log10(20.0), n)
    obs = rng.randint(2, policy.max_tokens + 1, n).astype(np.int64)
    pick = rng.rand(n)
    wide = (2.0 ** rng.uniform(13, 40, n)).astype(np.int64)
    obs[pick < 0.2] = wide[pick < 0.2]
    edge = np.array([0, 1, policy.min_tokens, policy.max_tokens, 2**40,
                     2**50], np.int64)
    obs[pick > 0.9] = rng.choice(edge, n)[pick > 0.9]
    return tuple(torch.from_numpy(x).cuda() for x in (a, b, price, obs))


def _twin(a, b, policy, price, observed):
    if price is None:
        toks = choose_tokens_torch(a, b, policy, observed)
    else:
        toks = choose_tokens_priced_torch(a, b, policy, price, observed)
    return toks, b * toks.to(a.dtype) ** a


def _bits(t):
    return t.cpu().numpy().view(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("with_observed", [True, False])
@pytest.mark.parametrize("priced", [True, False])
@pytest.mark.parametrize("name", POLICIES)
def test_k6_equals_the_torch_twin_bitwise(name, priced, with_observed):
    _need_card()
    policy = build_policy(name)
    for i, n in enumerate(ROWS):
        a, b, price, obs = _rows(1000 * POLICIES.index(name) + 10 * i
                                 + 2 * priced + with_observed, n, policy)
        price = price if priced else None
        obs = obs if with_observed else None
        before = ops.launch_counts()["policy_decide"]
        toks, rt = ops.policy_decide(a, b, policy, price, obs)
        assert ops.launch_counts()["policy_decide"] == before + 1
        want_toks, want_rt = _twin(a, b, policy, price, obs)
        torch.cuda.synchronize()
        assert toks.dtype == torch.int64 and rt.dtype == F64
        np.testing.assert_array_equal(_bits(toks), _bits(want_toks),
                                      err_msg=f"tokens, {n} rows")
        np.testing.assert_array_equal(_bits(rt), _bits(want_rt),
                                      err_msg=f"runtimes, {n} rows")


def _kernels(tmp_path, fn, tag):
    """Names of the kernels ``fn()`` ran on the card, in launch order, from
    the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / f"{tag}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted(
        (e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
        key=lambda e: float(e["ts"]))]


def _host_args(exe, rng, policy):
    def one(spec, i):
        if spec is None:
            return None
        if isinstance(spec, dict):
            return {k: rng.lognormal(0.0, 1.0, s).astype(np.float32)
                    for k, (s, _) in spec.items()}
        shape, dtype = spec
        if dtype == torch.int64:
            return rng.randint(0, policy.max_tokens + 1, shape).astype(
                np.int64)
        if i == 0:
            return rng.uniform(-2.0, 0.5, shape)
        if i == 1:
            return 10.0 ** rng.uniform(-3.0, 6.0, shape)
        return rng.choice([1.0, 1.25, 3.0], shape)
    return [one(s, i) for i, s in enumerate(exe.specs)]


@pytest.mark.cuda
def test_each_replay_runs_one_k6_and_no_kernel_of_the_policy(tmp_path):
    _need_card()
    policy = build_policy("bounded_slowdown")
    g = torch.Generator().manual_seed(3)
    feats = np.random.RandomState(4).lognormal(0.0, 1.0, (64, N_FEATURES))
    model = build_model("nn", device="cuda").load(
        MLP(N_FEATURES, (32, 16), generator=g), scaler=SCALER,
        std=Standardizer(feats))
    svc = AllocationService(model, policy, device="cuda")
    fabric = ShardedAllocationService(svc, 4)
    Bp, K = 32, 4
    cells = {"policy": svc._policy_cell(Bp, True),
             "priced": svc._priced_cell(Bp, True),
             "fused": svc._fused_cell({"features": (Bp, N_FEATURES)}, True),
             "sharded_policy": fabric._sharded_policy_cell(Bp, True, False),
             "sharded_priced": fabric._sharded_policy_cell(Bp, True, True),
             "sharded_fused": fabric._sharded_fused_cell(
                 {"features": (K, Bp, N_FEATURES)}, True)}
    rng = np.random.RandomState(0)
    for kind, (_, build) in cells.items():
        exe = build()
        assert exe.graph is not None
        args = _host_args(exe, rng, policy)
        exe(*args)
        before = ops.launch_counts()["policy_decide"]
        got = _kernels(tmp_path, lambda: exe(*args), kind)
        assert ops.launch_counts()["policy_decide"] == before + 1, kind
        assert sum(K6 in k for k in got) == 1, (kind, got)
        others = [k for k in got if K6 not in k]
        # the same stage's other work, run eagerly: the model (fused) and
        # the stacking of the outputs into the graph's float64 buffer
        dev_args = [None if x is None else
                    {k: torch.from_numpy(v).cuda() for k, v in x.items()}
                    if isinstance(x, dict) else torch.from_numpy(x).cuda()
                    for x in args]
        if "fused" in kind:
            x = {k: v.reshape(-1, N_FEATURES)
                 for k, v in dev_args[0].items()}
            rows = x["features"].shape[0]
            toks = torch.zeros(rows, dtype=torch.int64, device="cuda")
            rt = torch.zeros(rows, dtype=F64, device="cuda")

            def rest():
                za, zb = model.scaler.decode(model.serve_apply(x))
                za.to(F64), zb.to(F64)
                torch.stack([o.to(F64) for o in (toks, za, zb, rt)])
        else:
            rows = dev_args[0].numel()
            toks = torch.zeros(rows, dtype=torch.int64, device="cuda")
            rt = torch.zeros(rows, dtype=F64, device="cuda")

            def rest():
                torch.stack([o.to(F64) for o in (toks, rt)])
        with torch.inference_mode():
            want = _kernels(tmp_path, rest, kind + "_rest")
        assert Counter(others) == Counter(want), (kind, others, want)
        assert not any("pow" in k for k in others), (kind, others)
