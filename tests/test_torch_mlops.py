"""The MLOps loop, port against reference on the CPU: the drift detectors,
``Allocator.swap_model`` and the ``MLOpsLoop`` over a drifted trace.

``mlops/drift.py`` is numpy in both packages and is compared in this
process. The reference's ``swap_model`` and simulator import
``jax.experimental.enable_x64``, which the installed jax no longer has, so
a child process sets the alias ``jax.experimental.enable_x64 =
jax.enable_x64``, trains two reference ``nn`` models, pickles them and
drives ``SEQUENCE`` (the text below, run by both processes) through the
reference's stack; the alias never touches this process. The port drives
the same ``SEQUENCE`` over the two networks carried across with
``model_from_jax``.

Tolerances. Decisions taken from the carried networks have equal tokens;
their decoded parameters may differ in the float32 forward's last bits
(rtol 1e-5, atol 1e-6, as ``test_torch_slice.py``). The loop's refit trains
a new network in each package, from inits drawn by different generators
(``torch.Generator`` and ``jax.random``), so the two refits are different
models: the first swap must come at the same simulated time, after the
same signals and on as many buffered jobs, with every decision before it
equal;
after it each side's rolling model error must fall below its error at the
swap, and the two final errors must lie within 0.25 of each other (the
band ``test_torch_slice.py`` allows trained models, 0.15 in curve MAE and
0.10 in runtime AE, widened for a 100-job, 3-epoch refit).
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from repro.mlops import drift as ref_drift
from repro_torch.api import AllocationRequest, Allocator
from repro_torch.cluster import ClusterConfig
from repro_torch.core.allocator import build_policy
from repro_torch.core.models import NNConfig
from repro_torch.core.models.convert import model_from_jax
from repro_torch.core.pipeline import TasqConfig
from repro_torch.mlops import (MLOpsLoop, ModelBundle, RetrainController,
                               drift)
from repro_torch.obs import Obs
from repro_torch.serve import AllocationService, WarmupConfig
from repro_torch.serve.aot import model_pool_inputs
from repro_torch.workloads import DriftSpec, TraceGenerator

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = dict(n_train=120, n_eval=40, gnn_epochs=2)
SPEC = {"size": SIZE, "policy": "bounded_slowdown",
        "trace": dict(seed=7, n_unique=24, rate_qps=4.0), "n_events": 300,
        "drift_trace": dict(seed=23, n_unique=32, rate_qps=0.2),
        "drift": dict(n_new=48, onset=0.2, rotation=0.7, volume_growth=6.0),
        "drift_events": 1500,
        "cluster": dict(capacity=32768, epoch_s=8.0, n_shards=2),
        "refit": dict(n_train=100, n_eval=20, epochs=3),
        "trigger": dict(min_signals=1, min_buffer=16)}

# Run by both processes; ``api`` names each package's classes.
SEQUENCE = textwrap.dedent("""
    import json
    import numpy as np

    STATS = ("compiles", "calls", "queries", "executables_retired")

    def sequence(api, models, policy, spec):
        out = {}
        trace = api.TraceGenerator(**spec["trace"]).generate(
            spec["n_events"])
        pool = api.model_pool_inputs(models[0], trace.jobs)
        dflt = np.array([j.default_tokens for j in trace.jobs], np.int64)
        req = api.AllocationRequest(model_in=pool, observed_tokens=dflt)
        shard_of = np.arange(len(dflt)) % 2

        # ------------------------------------------------------ hot swap --
        obs = api.Obs.enabled()
        alloc = api.Allocator(api.service(models[0], policy), n_shards=2,
                              obs=obs)
        warm = api.WarmupConfig(max_bucket=64, observed=(True,))
        alloc.warmup(trace=trace, config=warm)
        out["swap/before"] = alloc.decide(req).tokens
        alloc.decide(req, api.DecisionContext(shard_of=shard_of))
        old = alloc.service
        bundle = api.ModelBundle(version=1, family="nn", loss="lf2",
                                 model=models[1], n_train=0,
                                 trigger="manual", train_s=0.0,
                                 created_t_s=0.0)
        rep = alloc.swap_model(bundle, jobs=trace.jobs, warmup_config=warm)
        for tag, ctx in (("model", None),
                         ("sharded", api.DecisionContext(shard_of=shard_of))):
            d = alloc.decide(req, ctx)
            out[f"swap/{tag}/tokens"] = d.tokens
            out[f"swap/{tag}/a"] = np.asarray(d.a)
            out[f"swap/{tag}/b"] = np.asarray(d.b)
        out["swap/counts"] = np.array([
            rep.n_precompiled, alloc.model_version,
            obs.metrics.counter("model_swaps").value,
            obs.metrics.counter("executables_retired").value])
        out["swap/old_stats"] = np.array([old.stats[k] for k in STATS])
        out["swap/new_stats"] = np.array([alloc.service.stats[k]
                                          for k in STATS])
        out["swap/old_is_empty"] = np.array(len(old.replica.compiled))

        # ------------------------------------------------------ the loop --
        dtrace = api.TraceGenerator(
            drift=api.DriftSpec(**spec["drift"]),
            **spec["drift_trace"]).generate(spec["drift_events"])
        alloc = api.Allocator(api.service(models[0], policy), n_shards=2)
        alloc.warmup(trace=dtrace,
                     config=api.WarmupConfig(max_bucket=256))
        r = spec["refit"]
        ctrl = api.controller(policy="signal",
                              policy_overrides=spec["trigger"],
                              max_train=r["n_train"],
                              pipeline_cfg=api.TasqConfig(
                                  n_train=r["n_train"], n_eval=r["n_eval"],
                                  nn=api.NNConfig(epochs=r["epochs"])))
        loop = api.MLOpsLoop(alloc, ctrl,
                             warmup_config=api.WarmupConfig(max_bucket=256))
        rep = alloc.run_cluster(dtrace, api.ClusterConfig(**spec["cluster"]),
                                mlops=loop)
        lr = loop.report()
        out["loop/swaps"] = np.array(
            [[s["t_s"], s["version"], s["n_train"], s["n_precompiled"]]
             for s in lr["swaps"]])
        out["loop/signals"] = np.array(json.dumps(
            [[s["kind"], s["t_s"]] for s in lr["signals"]]))
        out["loop/error_points"] = np.array(
            [[p["t_s"], p["rolling_model_error"], p["n"]]
             for p in loop.error_points])
        out["loop/arrival"] = dtrace.arrays()["arrival_s"]
        out["loop/alloc_errors"] = rep.alloc_errors
        out["loop/cache_hits"] = rep.cache_hits
        out["loop/service_stats"] = np.array(
            [rep.service_stats[k] for k in STATS])
        out["loop/done"] = np.array([rep.metrics["n_completed"],
                                     rep.metrics["n_rejected"]])
        return out
""")

CHILD = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys, types
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.api import Allocator, AllocationRequest, DecisionContext
    from repro.cluster import ClusterConfig
    from repro.core.allocator import build_policy
    from repro.core.models import NNConfig
    from repro.core.pipeline import TasqConfig, TasqPipeline
    from repro.mlops import MLOpsLoop, ModelBundle, RetrainController
    from repro.obs import Obs
    from repro.serve import AllocationService, WarmupConfig
    from repro.serve.aot import model_pool_inputs
    from repro.workloads import DriftSpec, TraceGenerator

    spec, out, model_out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    p = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **spec["size"]))
    p.build()
    models = [p.train("nn")]
    p2 = TasqPipeline(TasqConfig(nn=NNConfig(epochs=6, seed=1),
                                 **spec["size"]))
    for k in ("train_set", "eval_set", "scaler", "std"):
        setattr(p2, k, getattr(p, k))
    models.append(p2.train("nn"))
    with open(model_out + ".tmp", "wb") as f:
        pickle.dump([{"params": jax.tree.map(np.asarray, m.params),
                      "scaler": [float(getattr(m.scaler, k)) for k in
                                 ("mu_a", "sd_a", "mu_b", "sd_b")],
                      "std": [np.asarray(m.std.mu), np.asarray(m.std.sd)],
                      "cfg": m.cfg} for m in models], f)
    os.replace(model_out + ".tmp", model_out)
    exec(sys.argv[4])
    api = types.SimpleNamespace(
        Allocator=Allocator, AllocationRequest=AllocationRequest,
        DecisionContext=DecisionContext, ClusterConfig=ClusterConfig,
        WarmupConfig=WarmupConfig, TraceGenerator=TraceGenerator,
        DriftSpec=DriftSpec, TasqConfig=TasqConfig, NNConfig=NNConfig,
        MLOpsLoop=MLOpsLoop, ModelBundle=ModelBundle, Obs=Obs,
        model_pool_inputs=model_pool_inputs,
        service=lambda m, pol: AllocationService(m, pol),
        controller=lambda **kw: RetrainController(**kw))
    np.savez(out, **sequence(api, models, build_policy(spec["policy"]), spec))
""")


def _models_from_pickle(path):
    with open(path, "rb") as f:
        ds = pickle.load(f)
    return [model_from_jax(types.SimpleNamespace(
        family="nn", params=d["params"], cfg=d["cfg"],
        scaler=types.SimpleNamespace(**dict(zip(
            ("mu_a", "sd_a", "mu_b", "sd_b"), d["scaler"]))),
        std=types.SimpleNamespace(mu=d["std"][0], sd=d["std"][1])),
        device="cpu") for d in ds]


def _port_api():
    from repro_torch.api import DecisionContext
    return types.SimpleNamespace(
        Allocator=Allocator, AllocationRequest=AllocationRequest,
        DecisionContext=DecisionContext, ClusterConfig=ClusterConfig,
        WarmupConfig=WarmupConfig, TraceGenerator=TraceGenerator,
        DriftSpec=DriftSpec, TasqConfig=TasqConfig, NNConfig=NNConfig,
        MLOpsLoop=MLOpsLoop, ModelBundle=ModelBundle, Obs=Obs,
        model_pool_inputs=model_pool_inputs,
        service=lambda m, pol: AllocationService(m, pol, device="cpu"),
        controller=lambda **kw: RetrainController(device="cpu", **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlops")
    out, model_out = tmp / "reference.npz", tmp / "reference_nn.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(SPEC), str(out),
         str(model_out), SEQUENCE], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        while not model_out.exists() and child.poll() is None:
            time.sleep(0.2)
        assert model_out.exists(), "the reference child wrote no models"
        models = _models_from_pickle(model_out)
        ns = {}
        exec(SEQUENCE, ns)
        port = ns["sequence"](_port_api(), models,
                              build_policy(SPEC["policy"]), SPEC)
        log, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, log[-4000:]
    return port, dict(np.load(out))


# ------------------------------------------------------------- detectors --
def test_psi_and_ks_equal_reference():
    rng = np.random.RandomState(3)
    for shift in (0.0, 0.3, 2.0):
        ref_x = rng.normal(0, 1, 500)
        cur = rng.normal(shift, 1 + shift / 4, 300)
        assert drift.psi(ref_x, cur) == ref_drift.psi(ref_x, cur)
        assert drift.ks_statistic(ref_x, cur) == \
            ref_drift.ks_statistic(ref_x, cur)


def test_cusum_equals_reference_on_seeded_residuals():
    rng = np.random.RandomState(4)
    mine, theirs = drift.CusumDetector(), ref_drift.CusumDetector()
    for i in range(60):
        r = rng.normal(0.05 * max(0, i - 20), 0.3, 17)
        assert mine.update(r) == theirs.update(r)
        assert (mine.s_pos, mine.s_neg, mine.score) == \
            (theirs.s_pos, theirs.s_neg, theirs.score)


def test_drift_monitor_signals_equal_reference():
    rng = np.random.RandomState(9)
    mine, theirs = drift.DriftMonitor(), ref_drift.DriftMonitor()
    for i in range(40):
        n = int(rng.randint(5, 60))
        feats = rng.normal(0.04 * i, 1.0, (n, 4))
        pred = rng.uniform(10, 100, n)
        act = pred * np.exp(rng.normal(0.02 * i, 0.2, n))
        mask = rng.rand(n) < 0.7
        got = mine.observe(t_s=8.0 * i, features=feats, predicted_s=pred,
                           actual_s=act, model_mask=mask)
        want = theirs.observe(t_s=8.0 * i, features=feats,
                              predicted_s=pred, actual_s=act,
                              model_mask=mask)
        assert [s.to_row() for s in got] == [s.to_row() for s in want]
        assert mine.drift_score == theirs.drift_score
        if i == 25:
            mine.rebase()
            theirs.rebase()
    assert mine.signals


# --------------------------------------------------------------- hot swap --
def test_swap_model_decisions_and_counters_equal_reference(runs):
    """After ``swap_model`` to the second carried network the model and
    sharded paths decide as the reference's; the swap warmed the same
    number of executables, retired the old service's grid
    (``executables_retired``, ``model_swaps``) and the new service served
    without a build."""
    port, ref = runs
    np.testing.assert_array_equal(port["swap/before"], ref["swap/before"])
    for tag in ("model", "sharded"):
        np.testing.assert_array_equal(port[f"swap/{tag}/tokens"],
                                      ref[f"swap/{tag}/tokens"])
        for k in ("a", "b"):
            np.testing.assert_allclose(port[f"swap/{tag}/{k}"],
                                       ref[f"swap/{tag}/{k}"],
                                       rtol=1e-5, atol=1e-6)
    assert not np.array_equal(port["swap/before"], port["swap/model/tokens"])
    for k in ("counts", "old_stats", "new_stats", "old_is_empty"):
        np.testing.assert_array_equal(port["swap/" + k], ref["swap/" + k],
                                      err_msg=k)
    assert port["swap/new_stats"][0] == 0
    assert port["swap/counts"][2] == 1 and port["swap/counts"][3] > 0


# -------------------------------------------------------------- the loop --
def test_loop_swaps_where_the_reference_does(runs):
    """The signal-triggered loop first swaps at the reference's simulated
    time, after the same signals, refitting on as many buffered jobs and
    warming the same grid; every decision before the swap is equal."""
    port, ref = runs
    assert len(port["loop/swaps"]) >= 1 and len(ref["loop/swaps"]) >= 1
    np.testing.assert_array_equal(port["loop/swaps"][0], ref["loop/swaps"][0])
    t_swap = float(ref["loop/swaps"][0][0])
    sig = lambda z: [s for s in json.loads(str(z["loop/signals"]))
                     if s[1] <= t_swap]
    assert sig(port) == sig(ref)
    pts = lambda z: z["loop/error_points"][
        z["loop/error_points"][:, 0] <= t_swap]
    np.testing.assert_allclose(pts(port), pts(ref), rtol=1e-5)
    # decided before the swap's epoch (see the module docstring)
    pre = ref["loop/arrival"] <= t_swap - SPEC["cluster"]["epoch_s"]
    assert pre.sum() > 0
    for k in ("alloc_errors", "cache_hits"):
        np.testing.assert_array_equal(port["loop/" + k][pre],
                                      ref["loop/" + k][pre], err_msg=k)


def test_loop_after_the_swap_within_the_stated_band(runs):
    """After the swap each package serves its own refit: warm (no build
    on the hot path), every event accounted for, each side's rolling
    model error below its error at the swap, and the final errors within
    0.25 of each other."""
    port, ref = runs
    for side in (port, ref):
        assert side["loop/service_stats"][0] == 0
        assert side["loop/done"].sum() == SPEC["drift_events"]
        t_swap = float(side["loop/swaps"][0][0])
        pts = side["loop/error_points"]
        at_swap = pts[pts[:, 0] <= t_swap][-1, 1]
        assert pts[-1, 1] < at_swap
    assert abs(port["loop/error_points"][-1, 1]
               - ref["loop/error_points"][-1, 1]) <= 0.25
