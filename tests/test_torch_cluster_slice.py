"""The cluster slice end to end, port against reference on the CPU:
``ClusterSimulator`` (fused and unfused, 1 and 4 shards, elastic, priced,
preemptive) and ``FusedReplay`` give equal reports on the same trace.

The reference's cluster package imports ``jax.experimental.enable_x64``,
which the installed jax no longer has. A child process sets the alias
``jax.experimental.enable_x64 = jax.enable_x64`` before importing it, runs
the reference simulator, and writes its reports to an ``.npz``; the alias
never touches this process, so the reference's own test files keep
failing as they do without the port. The port runs the same
configurations here, meanwhile.

Both sides decide with the ``gbdt`` family — numpy in both packages, so
the same (a, b) — through the same float64 policy: any difference is the
cluster code's or a kernel's plain version's. One ``nn:lf2`` run carries
the reference's trained network across with ``model_from_jax``.
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

from repro_torch.cluster import (ClusterConfig, ClusterSimulator, FusedReplay,
                                 ReplayConfig)
from repro_torch.core.allocator import build_policy
from repro_torch.core.models.convert import model_from_jax
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.core.models import NNConfig
from repro_torch.serve import AllocationService
from repro_torch.workloads import TraceGenerator

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = dict(n_train=120, n_eval=40, gnn_epochs=2)
POLICY = "bounded_slowdown"
TRACE = dict(seed=33, n_unique=24, rate_qps=1.0)
N_EVENTS = 500
BASE = {
    "fixed": dict(capacity=2048, epoch_s=8.0),
    "edf_elastic": dict(capacity=1024, epoch_s=4.0, admission="edf",
                        elastic=True, pricing="elastic"),
    "k4": dict(capacity=2048, epoch_s=8.0, n_shards=4),
}
CONFIGS = {f"{name}_{mode}": dict(kw, fused=(mode == "fused"))
           for name, kw in BASE.items() for mode in ("unfused", "fused")}
CONFIGS["drf_preempt"] = dict(capacity=2048, epoch_s=8.0, n_shards=4,
                              admission="drf", preemption=True, elastic=True,
                              pricing="elastic")
NN_CONFIG = dict(BASE["edf_elastic"], fused=True)
REPLAY = dict(capacity=65536, n_shards=4, max_leases=1024, epoch_s=60.0,
              queue_block=512)
REPLAY_STREAM = dict(seed=71, n_unique=32, rate_qps=4.0)
REPLAY_KEYS = ("n_admitted", "n_completed", "n_rejected", "n_epochs",
               "mean_utilization")

CHILD = textwrap.dedent("""
    import json, pickle, sys, warnings
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.cluster import (ClusterConfig, ClusterSimulator, FusedReplay,
                               ReplayConfig)
    from repro.core.allocator import build_policy
    from repro.core.models import NNConfig
    from repro.core.pipeline import TasqConfig, TasqPipeline
    from repro.serve import AllocationService
    from repro.workloads import TraceGenerator

    spec = json.loads(sys.argv[1])
    out, model_out = sys.argv[2], sys.argv[3]
    p = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **spec["size"]))
    p.build()
    gbdt, nn = p.train("gbdt"), p.train("nn")
    with open(model_out + ".tmp", "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, nn.params),
                     "scaler": [float(getattr(nn.scaler, k)) for k in
                                ("mu_a", "sd_a", "mu_b", "sd_b")],
                     "std": [np.asarray(nn.std.mu), np.asarray(nn.std.sd)],
                     "cfg": nn.cfg}, f)
    import os
    os.replace(model_out + ".tmp", model_out)
    policy = build_policy(spec["policy"])
    trace = TraceGenerator(**spec["trace"]).generate(spec["n_events"])
    arrays = {}

    def record(tag, rep):
        arrays[tag + "/metrics"] = np.array(json.dumps(
            {k: float(v) for k, v in rep.metrics.items()}))
        arrays[tag + "/cache_stats"] = np.array(json.dumps(
            {k: int(v) for k, v in rep.cache_stats.items()}))
        arrays[tag + "/alloc_errors"] = rep.alloc_errors
        arrays[tag + "/cache_hits"] = rep.cache_hits
        arrays[tag + "/error_t"], arrays[tag + "/error_e"] = rep.error_series
        arrays[tag + "/replica_queries"] = np.array(
            [r["queries"] for r in rep.replica_stats])
        arrays[tag + "/n_epochs"] = np.array(rep.n_epochs)

    warnings.simplefilter("ignore", RuntimeWarning)
    for tag, kw in spec["configs"].items():
        record(tag, ClusterSimulator(AllocationService(gbdt, policy),
                                     ClusterConfig(**kw)).run(trace))
    record("nn", ClusterSimulator(AllocationService(nn, policy),
                                  ClusterConfig(**spec["nn_config"])
                                  ).run(trace))
    stream = TraceGenerator(**spec["replay_stream"]).stream(
        3000, chunk_size=1024).buffer()
    rep = FusedReplay(ReplayConfig(**spec["replay"])).run(stream)
    for k in spec["replay_keys"]:
        arrays["replay/" + k] = np.array(getattr(rep, k))
    np.savez(out, **arrays)
""")


def _as_dict(rep):
    return {"metrics": {k: float(v) for k, v in rep.metrics.items()},
            "cache_stats": {k: int(v) for k, v in rep.cache_stats.items()},
            "alloc_errors": rep.alloc_errors, "cache_hits": rep.cache_hits,
            "error_t": rep.error_series[0], "error_e": rep.error_series[1],
            "replica_queries": np.array([r["queries"]
                                         for r in rep.replica_stats]),
            "n_epochs": rep.n_epochs}


def _reference_view(z, tag):
    return {"metrics": json.loads(str(z[tag + "/metrics"])),
            "cache_stats": json.loads(str(z[tag + "/cache_stats"])),
            **{k: z[f"{tag}/{k}"] for k in ("alloc_errors", "cache_hits",
                                            "error_t", "error_e",
                                            "replica_queries")},
            "n_epochs": int(z[tag + "/n_epochs"])}


def _nn_from_pickle(path):
    with open(path, "rb") as f:
        d = pickle.load(f)
    ref = types.SimpleNamespace(
        family="nn", params=d["params"], cfg=d["cfg"],
        scaler=types.SimpleNamespace(**dict(zip(
            ("mu_a", "sd_a", "mu_b", "sd_b"), d["scaler"]))),
        std=types.SimpleNamespace(mu=d["std"][0], sd=d["std"][1]))
    return model_from_jax(ref, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' reports: the reference's from the child process, the
    port's from this one, computed while the child runs."""
    tmp = tmp_path_factory.mktemp("cluster_slice")
    out, model_out = tmp / "reference.npz", tmp / "reference_nn.pkl"
    spec = {"size": SIZE, "policy": POLICY, "trace": TRACE,
            "n_events": N_EVENTS, "configs": CONFIGS, "nn_config": NN_CONFIG,
            "replay": REPLAY, "replay_stream": REPLAY_STREAM,
            "replay_keys": list(REPLAY_KEYS)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(spec), str(out),
         str(model_out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        pipe = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **SIZE),
                            device="cpu").build()
        policy = build_policy(POLICY)
        gbdt = AllocationService(pipe.train("gbdt"), policy, device="cpu")
        trace = TraceGenerator(**TRACE).generate(N_EVENTS)
        port = {}
        for tag, kw in CONFIGS.items():
            port[tag] = _as_dict(ClusterSimulator(
                gbdt, ClusterConfig(**kw)).run(trace))
        stream = TraceGenerator(**REPLAY_STREAM).stream(
            3000, chunk_size=1024).buffer()
        rep = FusedReplay(ReplayConfig(**REPLAY), device="cpu").run(stream)
        port["replay"] = {k: getattr(rep, k) for k in REPLAY_KEYS}
        while not model_out.exists() and child.poll() is None:
            time.sleep(0.2)
        if model_out.exists():
            nn = AllocationService(_nn_from_pickle(model_out), policy,
                                   device="cpu")
            port["nn"] = _as_dict(ClusterSimulator(
                nn, ClusterConfig(**NN_CONFIG)).run(trace))
        log, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, log[-4000:]
    print(f"cluster slice: reference child and port side took "
          f"{time.perf_counter() - t0:.1f} s together")
    return port, np.load(out)


def _assert_reports_equal(got, want, what):
    assert set(got["metrics"]) == set(want["metrics"]), what
    for k, v in want["metrics"].items():
        g = got["metrics"][k]
        assert g == v or (np.isnan(g) and np.isnan(v)), (what, k, g, v)
    # the reference sorts its cache table again after every change; the
    # port's table is sorted whole only by a refit that fills it empty
    mine, theirs = dict(got["cache_stats"]), dict(want["cache_stats"])
    assert mine.pop("dense_rebuilds") <= len(got["replica_queries"]), what
    theirs.pop("dense_rebuilds")
    assert mine == theirs, what
    for k in ("alloc_errors", "cache_hits", "error_t", "replica_queries"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}/{k}")
    assert np.array_equal(got["error_e"], want["error_e"], equal_nan=True)
    assert got["n_epochs"] == want["n_epochs"], what


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_simulator_report_equals_reference(runs, tag):
    port, ref = runs
    _assert_reports_equal(port[tag], _reference_view(ref, tag), tag)


def test_fused_and_unfused_agree_and_resizes_fire(runs):
    port, _ = runs
    for name in BASE:
        assert port[f"{name}_fused"]["metrics"] == \
            port[f"{name}_unfused"]["metrics"], name
    assert port["edf_elastic_fused"]["metrics"]["resize_shrinks"] > 0
    assert port["drf_preempt"]["metrics"]["preemptions"] > 0


def test_nn_model_run_equals_reference(runs):
    """The reference's trained network, carried across: its float32
    forward runs in two frameworks, so a decode could round differently;
    at this size none does and the reports are equal."""
    port, ref = runs
    assert "nn" in port, "the reference child wrote no model"
    _assert_reports_equal(port["nn"], _reference_view(ref, "nn"), "nn")


def test_fused_replay_equals_reference(runs):
    port, ref = runs
    for k in REPLAY_KEYS:
        assert port["replay"][k] == ref["replay/" + k].item(), k
