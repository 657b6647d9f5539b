"""The serving plane, port against reference on the CPU: the micro-batcher
and its helpers, ``Allocator.submit/step/run/decide`` with their counters,
the AOT warmup's executable grid, ``run_streaming`` against
``run_cluster``, and the two-worker ``ServingPlane``.

The reference's serving modules import ``jax.experimental.enable_x64``,
which the installed jax no longer has, so a child process sets the alias
``jax.experimental.enable_x64 = jax.enable_x64``, trains the reference's
``nn`` model, pickles it, and drives ``SEQUENCE`` (the text below, run by
both processes) through the reference's stack; the alias never touches
this process. The port drives the same ``SEQUENCE`` over the reference's
trained network carried across with ``model_from_jax``, so the two sides
decide from the same weights: tokens, reports and ``stats`` (``compiles``
included) must be equal. The network's float32 forward runs in two
frameworks, so decoded parameters and runtimes may differ in their last
bits: they are held to rtol 1e-5 (atol 1e-6), as in
``test_torch_slice.py``. ``serve/batching.py`` needs only numpy and
``repro.api.types``, so it is loaded here by path.
"""
import importlib.util
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest

from repro_torch.api import (AllocationRequest, Allocator, DecisionContext)
from repro_torch.cluster import ClusterConfig
from repro_torch.core.allocator import build_policy
from repro_torch.core.models.convert import model_from_jax
from repro_torch.serve import (AllocationService, ServingPlane, WarmupConfig,
                               batching)
from repro_torch.serve.aot import batch_buckets, model_pool_inputs
from repro_torch.serve.service import ReplicaState
from repro_torch.workloads import TraceGenerator

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = dict(n_train=120, n_eval=40, gnn_epochs=2)
SPEC = {"size": SIZE, "policy": "bounded_slowdown",
        "trace": dict(seed=7, n_unique=24, rate_qps=4.0), "n_events": 400,
        "cluster": dict(capacity=2048, epoch_s=8.0, n_shards=2,
                        admission="edf", elastic=True, pricing="elastic"),
        "warm_bucket": 512}

# Run by both processes; ``api`` names each package's classes.
SEQUENCE = textwrap.dedent("""
    import json
    import numpy as np

    STATS = ("compiles", "calls", "queries", "executables_retired")

    def sequence(api, model, policy, spec):
        out = {}
        trace = api.TraceGenerator(**spec["trace"]).generate(
            spec["n_events"])
        pool = api.model_pool_inputs(model, trace.jobs)
        U = len(trace.jobs)
        dflt = np.array([j.default_tokens for j in trace.jobs], np.int64)
        row = lambda j: {k: v[j] for k, v in pool.items()}

        def stats(tag, alloc):
            out[tag + "/stats"] = np.array([alloc.service.stats[k]
                                            for k in STATS])
            out[tag + "/replicas"] = np.array(
                [[r[k] for k in STATS] for r in alloc.fabric.replica_stats()])

        def decision(tag, d):
            for k in ("tokens", "a", "b", "runtime", "price", "shard"):
                out[f"{tag}/{k}"] = np.asarray(getattr(d, k))

        def drive(tag, alloc, big):
            for i in range(40):
                j = (7 * i) % U
                alloc.submit(i, row(j), int(dflt[j]) if i % 3 else None)
            got = alloc.step()
            out[tag + "/step"] = np.array([got[i] for i in range(40)])
            stats(tag + "/after_step", alloc)
            reqs = [api.AllocationRequest(
                request_id=100 + i, model_in=row((5 * i) % U),
                observed_tokens=int(dflt[(5 * i) % U])) for i in range(300)]
            got = alloc.run(reqs)
            out[tag + "/run"] = np.array([got[100 + i] for i in range(300)])
            stats(tag + "/after_run", alloc)
            jb = (np.arange(big) * 11) % U
            req = api.AllocationRequest(model_in=row(jb),
                                        observed_tokens=dflt[jb])
            d = alloc.decide(req)
            decision(tag + "/model", d)
            price = np.where(np.arange(big) % 3 == 0, 1.5, 1.0)
            decision(tag + "/model_priced",
                     alloc.decide(req, api.DecisionContext(price=price)))
            decision(tag + "/unobserved",
                     alloc.decide(req, api.DecisionContext(observed=False)))
            hist = api.AllocationRequest(a=np.asarray(d.a, np.float64),
                                         b=np.asarray(d.b, np.float64),
                                         observed_tokens=dflt[jb])
            decision(tag + "/history_priced",
                     alloc.decide(hist, api.DecisionContext(price=price)))
            shard_of = alloc.place(jb)
            decision(tag + "/sharded",
                     alloc.decide(req, api.DecisionContext(shard_of=shard_of)))
            decision(tag + "/sharded_history_priced", alloc.decide(
                hist, api.DecisionContext(price=price, shard_of=shard_of)))
            if big > 4096:
                jb = (np.arange(5000) * 3) % U
                decision(tag + "/chunked", alloc.decide(api.AllocationRequest(
                    model_in=row(jb), observed_tokens=dflt[jb])))
            stats(tag + "/end", alloc)

        alloc = api.Allocator(api.service(model, policy), n_shards=2)
        drive("lazy", alloc, 5000)
        alloc = api.Allocator(api.service(model, policy), n_shards=2)
        rep = alloc.warmup(trace=trace, config=api.WarmupConfig(
            max_bucket=spec["warm_bucket"], observed=(True, False)))
        out["warm/counts"] = np.array([rep.n_precompiled,
                                       rep.n_already_cached])
        out["warm/kinds"] = np.array(json.dumps(
            {k: v["n"] for k, v in rep.to_json()["by_kind"].items()}))
        stats("warm/start", alloc)
        drive("warm", alloc, 300)
        cc = api.ClusterConfig(**spec["cluster"])
        for name, run in (
                ("cluster", lambda: alloc.run_cluster(trace, cc)),
                ("streaming", lambda: alloc.run_streaming(
                    trace, cc, chunk=16, backlog=64))):
            r = run()
            out[name + "/metrics"] = np.array(json.dumps(
                {k: float(v) for k, v in r.metrics.items()}))
            out[name + "/alloc_errors"] = r.alloc_errors
            out[name + "/cache_hits"] = r.cache_hits
            out[name + "/n_epochs"] = np.array(r.n_epochs)
            out[name + "/service_stats"] = np.array(
                [r.service_stats[k] for k in STATS])
            out[name + "/replica_queries"] = np.array(
                [x["queries"] for x in r.replica_stats])
        return out
""")

CHILD = textwrap.dedent("""
    import json, os, pickle, sys, types
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.api import Allocator, AllocationRequest, DecisionContext
    from repro.cluster import ClusterConfig
    from repro.core.allocator import build_policy
    from repro.core.models import NNConfig
    from repro.core.pipeline import TasqConfig, TasqPipeline
    from repro.serve import AllocationService, WarmupConfig
    from repro.serve.aot import model_pool_inputs
    from repro.workloads import TraceGenerator

    spec, out, model_out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    p = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **spec["size"]))
    p.build()
    nn = p.train("nn")
    with open(model_out + ".tmp", "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, nn.params),
                     "scaler": [float(getattr(nn.scaler, k)) for k in
                                ("mu_a", "sd_a", "mu_b", "sd_b")],
                     "std": [np.asarray(nn.std.mu), np.asarray(nn.std.sd)],
                     "cfg": nn.cfg}, f)
    os.replace(model_out + ".tmp", model_out)
    exec(sys.argv[4])
    api = types.SimpleNamespace(
        Allocator=Allocator, AllocationRequest=AllocationRequest,
        DecisionContext=DecisionContext, ClusterConfig=ClusterConfig,
        WarmupConfig=WarmupConfig, TraceGenerator=TraceGenerator,
        model_pool_inputs=model_pool_inputs,
        service=lambda m, pol: AllocationService(m, pol))
    np.savez(out, **sequence(api, nn, build_policy(spec["policy"]), spec))
""")


def _nn_from_pickle(path):
    with open(path, "rb") as f:
        d = pickle.load(f)
    ref = types.SimpleNamespace(
        family="nn", params=d["params"], cfg=d["cfg"],
        scaler=types.SimpleNamespace(**dict(zip(
            ("mu_a", "sd_a", "mu_b", "sd_b"), d["scaler"]))),
        std=types.SimpleNamespace(mu=d["std"][0], sd=d["std"][1]))
    return model_from_jax(ref, device="cpu")


def _port_api():
    return types.SimpleNamespace(
        Allocator=Allocator, AllocationRequest=AllocationRequest,
        DecisionContext=DecisionContext, ClusterConfig=ClusterConfig,
        WarmupConfig=WarmupConfig, TraceGenerator=TraceGenerator,
        model_pool_inputs=model_pool_inputs,
        service=lambda m, pol: AllocationService(m, pol, device="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs of ``SEQUENCE``, and the port's model."""
    tmp = tmp_path_factory.mktemp("serving_plane")
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
        assert model_out.exists(), "the reference child wrote no model"
        model = _nn_from_pickle(model_out)
        ns = {}
        exec(SEQUENCE, ns)
        port = ns["sequence"](_port_api(), model,
                              build_policy(SPEC["policy"]), SPEC)
        log, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, log[-4000:]
    return port, dict(np.load(out)), model


def _equal_keys(port, ref, prefix):
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys, prefix
    for k in keys:
        if k.endswith(("/a", "/b", "/runtime")):
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("phase", ["lazy", "warm"])
def test_queued_requests_equal_reference(runs, phase):
    """``submit``/``step`` (mixed hinted and hint-free single requests) and
    ``run`` over a closed set of 300 (two flushes of the 256-row
    micro-batcher) give the reference's tokens."""
    port, ref, _ = runs
    _equal_keys(port, ref, f"{phase}/step")
    _equal_keys(port, ref, f"{phase}/run")


@pytest.mark.parametrize("phase", ["lazy", "warm"])
def test_columnar_decisions_equal_reference(runs, phase):
    """The model, priced, hint-free, history and sharded paths (and, lazy,
    a 5,000-row request served in chunks): tokens, decoded parameters,
    runtimes, prices and shards equal the reference's."""
    port, ref, _ = runs
    for path in ("model", "model_priced", "unobserved", "history_priced",
                 "sharded", "sharded_history_priced", "chunked"):
        if phase == "warm" and path == "chunked":
            continue
        _equal_keys(port, ref, f"{phase}/{path}/")


@pytest.mark.parametrize("phase", ["lazy", "warm"])
def test_stats_equal_reference_after_every_phase(runs, phase):
    """The same request sequence leaves the service's and every fabric
    replica's ``stats`` — ``compiles`` included — equal to the
    reference's: the port builds an executable exactly where the
    reference compiles one."""
    port, ref, _ = runs
    for when in ("after_step", "after_run", "end"):
        _equal_keys(port, ref, f"{phase}/{when}/")


def test_warmup_pins_the_reference_grid_and_replays_without_compiles(runs):
    port, ref, _ = runs
    np.testing.assert_array_equal(port["warm/counts"], ref["warm/counts"])
    assert json.loads(str(port["warm/kinds"])) == \
        json.loads(str(ref["warm/kinds"]))
    # buckets 8..512 x 2 observed modes x (policy, priced, fused) for the
    # service and (2 policy twins, fused) for the fabric
    n = len(batch_buckets(8, SPEC["warm_bucket"])) * 2 * 6
    assert int(port["warm/counts"][0]) == n
    assert port["warm/end/stats"][0] == 0, "a warmed replay built"


def test_run_streaming_equals_run_cluster_and_reference(runs):
    port, ref, _ = runs
    for key in ("metrics", "alloc_errors", "cache_hits", "n_epochs",
                "service_stats", "replica_queries"):
        np.testing.assert_array_equal(port["streaming/" + key],
                                      port["cluster/" + key], err_msg=key)
    _equal_keys(port, ref, "cluster/")
    _equal_keys(port, ref, "streaming/")
    assert json.loads(str(port["cluster/metrics"]))["resize_shrinks"] > 0


def test_serving_plane_two_workers_burst_equals_direct_decide(runs):
    """Two workers drain a 2,000-request burst through a 64-slot backlog:
    every future resolves, to the tokens a direct ``decide`` of the same
    row gives, and the warmed plane builds nothing."""
    _, _, model = runs
    service = AllocationService(model, build_policy(SPEC["policy"]),
                                device="cpu")
    trace = TraceGenerator(**SPEC["trace"]).generate(SPEC["n_events"])
    pool = model_pool_inputs(model, trace.jobs)
    dflt = np.array([j.default_tokens for j in trace.jobs], np.int64)
    U = len(trace.jobs)
    plane = ServingPlane(service, n_workers=2, max_batch=32, backlog=64)
    plane.start(warm_jobs=trace.jobs)
    assert plane.warmup_report.n_precompiled == len(batch_buckets(8, 32)) * 6
    jb = np.arange(2000) % U
    hint = [int(dflt[j]) if i % 5 else None for i, j in enumerate(jb)]
    try:
        futs = [plane.submit({k: v[j] for k, v in pool.items()}, h)
                for j, h in zip(jb, hint)]
        got = np.array([f.result(timeout=120) for f in futs])
    finally:
        plane.stop()
    assert all(f.exception() is None for f in futs)
    assert service.stats["compiles"] == 0
    assert plane.backlog.saturations > 0
    obs = np.array([h if h is not None else service.policy.max_tokens
                    for h in hint], np.int64)
    want = service.decide(AllocationRequest(
        model_in={k: v[jb] for k, v in pool.items()}, observed_tokens=obs))
    np.testing.assert_array_equal(got, want.tokens)


def test_serving_plane_fails_a_batch_and_keeps_serving(runs):
    """A batch whose decide raises fails its futures with the exception;
    the worker goes on to serve the next batch."""
    _, _, model = runs
    service = AllocationService(model, build_policy(SPEC["policy"]),
                                device="cpu")
    trace = TraceGenerator(**SPEC["trace"]).generate(SPEC["n_events"])
    pool = model_pool_inputs(model, trace.jobs)
    plane = ServingPlane(service, n_workers=1, max_batch=4).start()
    try:
        bad = plane.submit({"features": np.zeros(3, np.float32)})
        with pytest.raises(Exception):
            bad.result(timeout=60)
        good = plane.submit({k: v[0] for k, v in pool.items()}, 64)
        assert good.result(timeout=60) >= 1
    finally:
        plane.stop()


# ------------------------------------------------ batching, by path load --
def _reference_batching():
    name = "reference_serve_batching"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "src" / "repro" / "serve" / "batching.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class _Recorder:
    """A stand-in service: records each columnar request and decides
    tokens from the features' sum, so batching alone is compared."""

    def __init__(self):
        self.policy = types.SimpleNamespace(max_tokens=6287)
        self.calls = []

    def decide(self, request):
        self.calls.append(request)
        x = request.model_in["features"]
        toks = x.reshape(x.shape[0], -1).sum(1).astype(np.int64)
        return types.SimpleNamespace(tokens=toks)


def test_shard_positions_and_pad_graph_inputs_equal_reference():
    ref = _reference_batching()
    rng = np.random.RandomState(5)
    for n, k in ((0, 1), (1, 4), (37, 4), (300, 3), (5000, 2)):
        shard_of = rng.randint(0, k, n)
        got = batching.shard_positions(shard_of, k)
        want = ref.shard_positions(shard_of, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for single in (True, False):
        lead = () if single else (3,)
        m = {"features": rng.rand(*lead, 5, 4).astype(np.float32),
             "adj": rng.rand(*lead, 5, 5).astype(np.float32),
             "mask": np.ones(lead + (5,), np.float32)}
        got = batching.pad_graph_inputs(m, 16)
        want = ref.pad_graph_inputs(m, 16)
        for key in m:
            np.testing.assert_array_equal(got[key], want[key])
    for n in (1, 7, 8, 9, 4096, 4097):
        assert batching.batch_bucket(n) == ref.batch_bucket(n)
        assert batching.node_bucket(n) == ref.node_bucket(n)
    with pytest.warns(RuntimeWarning):
        assert batching.node_bucket(5000, cap=4096) == 5000


@pytest.mark.parametrize("graphs", [False, True])
def test_micro_batcher_flushes_equal_reference(graphs):
    """Signature grouping (node buckets for graph inputs), chunking at
    ``max_batch``, the hinted/hint-free observed column, timeout flushes on
    an injected clock and the submission order of the results: the same
    requests give the reference's stacked requests and results."""
    ref = _reference_batching()
    from repro.api.types import AllocationRequest as RefRequest
    rng = np.random.RandomState(11)
    reqs = []
    for i in range(23):
        if graphs:
            n = int(rng.choice([3, 7, 9, 20]))
            m = {"features": rng.rand(n, 4).astype(np.float32),
                 "adj": rng.rand(n, n).astype(np.float32),
                 "mask": np.ones(n, np.float32)}
        else:
            m = {"features": rng.rand(6).astype(np.float32)}
        reqs.append((i, m, None if i % 4 == 0 else int(rng.randint(1, 99))))
    outs = []
    for mod, Req in ((batching, AllocationRequest), (ref, RefRequest)):
        now = [0.0]
        svc = _Recorder()
        mb = mod.MicroBatcher(svc, max_batch=5, max_wait_s=1.0,
                              clock=lambda: now[0])
        results = []
        for i, m, o in reqs:
            mb.submit(Req(request_id=i, model_in=m, observed_tokens=o))
            now[0] += 0.3
            results.append(mb.poll())
        results.append(mb.flush())
        outs.append((results, svc.calls))
    (got, got_calls), (want, want_calls) = outs
    assert [list(r.items()) for r in got] == [list(r.items()) for r in want]
    assert len(got_calls) == len(want_calls)
    for g, w in zip(got_calls, want_calls):
        assert sorted(g.model_in) == sorted(w.model_in)
        for k in w.model_in:
            np.testing.assert_array_equal(g.model_in[k], w.model_in[k])
        if w.observed_tokens is None:
            assert g.observed_tokens is None
        else:
            np.testing.assert_array_equal(g.observed_tokens,
                                          w.observed_tokens)


# ---------------------------------------------------------- ReplicaState --
def test_get_or_build_builds_once_across_racing_threads():
    rs = ReplicaState()
    built, barrier = [], threading.Barrier(8)

    def build():
        built.append(1)
        time.sleep(0.05)
        return lambda: "exe"

    def worker(flags, i):
        barrier.wait()
        rs.begin_dispatch()
        assert rs.get_or_build(("k",), build)() == "exe"
        flags[i] = rs.compile_stalled()

    flags = [None] * 8
    ts = [threading.Thread(target=worker, args=(flags, i)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(built) == 1 and rs.stats["compiles"] == 1
    rs.begin_dispatch()
    rs.get_or_build(("k",), build)
    assert not rs.compile_stalled()          # a cached hit is no compile


def test_install_and_invalidate_count_as_the_reference():
    rs = ReplicaState()
    assert rs.install(("a",), object())
    assert not rs.install(("a",), object())
    assert rs.stats["compiles"] == 0
    rs.get_or_build(("b",), object)
    assert rs.invalidate() == 2
    assert rs.compiled == {} and rs.stats["executables_retired"] == 2
    rs.get_or_build(("a",), object)
    assert rs.stats["compiles"] == 2


def test_concurrent_decides_count_every_call_and_build_each_key_once():
    """Eight threads decide through one service at once, with the
    interpreter's switch interval shortened: every call and query is
    counted, each executable key is built exactly once, and every
    decision equals the single-threaded one."""
    host = types.SimpleNamespace(family="host", supports_fused=False,
                                 device=None)
    service = AllocationService(host, build_policy(SPEC["policy"]),
                                device="cpu")
    rng = np.random.RandomState(2)
    reqs = []
    for B in (3, 9, 17, 40, 100, 5, 33, 70):
        reqs.append(AllocationRequest(
            a=-rng.uniform(0.1, 2.0, B), b=rng.uniform(10, 1e4, B),
            observed_tokens=rng.randint(1, 4000, B)))
    want = [AllocationService(host, build_policy(SPEC["policy"]),
                              device="cpu").decide(r).tokens for r in reqs]
    errors, got = [], {}

    def worker(t):
        try:
            for i in range(40):
                j = (t + i) % len(reqs)
                got[(t, i)] = (j, service.decide(reqs[j]).tokens)
        except BaseException as e:           # reported below
            errors.append(e)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(got) == 8 * 40
    for j, toks in got.values():
        np.testing.assert_array_equal(toks, want[j])
    n_keys = len({batching.batch_bucket(r.batch_size()) for r in reqs})
    assert service.stats["compiles"] == n_keys == len(service.replica.compiled)
    assert service.stats["calls"] == 8 * 40
    assert service.stats["queries"] == sum(
        reqs[j].batch_size() for j, _ in got.values())
