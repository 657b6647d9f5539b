"""The legacy allocation API, port against reference on the CPU, and the
small pieces the benchmark runner reads (``PCCModel.param_count``,
``TasqPipeline.param_counts``, ``KernelRoofline.host_fraction``).

Mirrors the reference's own shim tests (``tests/test_serve.py``: the
service's and the fabric's shims warn once and equal ``decide``; the
pipeline's ``train_*`` shims delegate; a shim reached from an internal
module is an error). The reference's ``repro.serve`` imports
``jax.experimental.enable_x64``, which the installed jax no longer has, so
a child process sets the alias ``jax.experimental.enable_x64 =
jax.enable_x64``, trains the reference's ``nn`` and ``gnn`` models,
pickles the ``nn``, and runs every shim on inputs this process also feeds
the port's shims over that network (``model_from_jax``). Tokens must be
equal; the network's float32 forward runs in two frameworks, so decoded
parameters and runtimes of the model path are held to rtol 1e-5 (atol
1e-6), as in ``test_torch_serving_plane.py``, and the policy path's
(float64 in both) bitwise.

``pytest.ini`` escalates the legacy warning only for callers matching
``repro\\.``, which ``repro_torch.`` does not match; here a test-local
filter does it for ``repro_torch\\.`` callers, and an AST scan holds every
module of ``src/repro_torch/`` to calling no shim.
"""
import ast
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time
import types
import warnings

import numpy as np
import pytest

from repro_torch.api import (AllocationRequest, DecisionContext,
                             reset_deprecation_warnings)
from repro_torch.api._compat import PREFIX, warn_deprecated
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.models import NNConfig
from repro_torch.core.models.convert import model_from_jax
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.roofline import analysis as panalysis
from repro_torch.serve import (AllocationResult, AllocationService,
                               ShardedAllocationService)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = dict(n_train=120, n_eval=40, gnn_epochs=2)
K = 3
SERVICE_SHIMS = ("allocate_batch", "allocate_params",
                 "allocate_params_priced", "allocate_dataset")
FABRIC_SHIMS = ("allocate_params", "allocate_params_priced",
                "allocate_batch")
TRAIN_SHIMS = ("train_xgb", "train_nn", "train_gnn")
ROWS = [dict(kernel="k", launches=3, bytes_per_launch=1.5e6, wall_s=2e-3,
             items=7, measured_bw=bw) for bw in (0.0, 1e10, 3.3e9)]

# Run by both processes: every shim on the eval set, the inputs (a, b)
# from the model; ``api`` names each package's classes.
SHIMS = textwrap.dedent("""
    import numpy as np

    def shims(api, model, ds, K):
        svc = api.AllocationService(model, api.AllocationPolicy(
            max_slowdown=0.05))
        fab = api.ShardedAllocationService(api.AllocationService(
            model, api.AllocationPolicy(max_slowdown=0.05)), n_shards=K)
        obs = np.asarray(ds.observed_alloc, np.int64)
        inputs = model.batch_inputs(ds)
        price = np.exp(np.random.RandomState(3).uniform(0, 2, len(obs)))
        shard_of = np.arange(len(obs)) % K
        a, b = model.predict_params(ds)
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        calls = {
            "service/allocate_batch":
                lambda: svc.allocate_batch(inputs, observed_tokens=obs),
            "service/allocate_params":
                lambda: svc.allocate_params(a, b, observed_tokens=obs),
            "service/allocate_params_priced":
                lambda: svc.allocate_params_priced(a, b, price,
                                                   observed_tokens=obs),
            "service/allocate_dataset": lambda: svc.allocate_dataset(ds),
            "fabric/allocate_params":
                lambda: fab.allocate_params(shard_of, a, b,
                                            observed_tokens=obs),
            "fabric/allocate_params_priced":
                lambda: fab.allocate_params_priced(shard_of, a, b, price,
                                                   observed_tokens=obs),
            "fabric/allocate_batch":
                lambda: fab.allocate_batch(shard_of, inputs,
                                           observed_tokens=obs),
        }
        out = {"in/a": a, "in/b": b}
        for name, call in calls.items():
            r = call()
            for f in ("tokens", "a", "b", "runtime"):
                out[f"{name}/{f}"] = np.asarray(getattr(r, f))
        return out
""")

CHILD = textwrap.dedent("""
    import json, os, pickle, sys, types, warnings
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.core.allocator import AllocationPolicy
    from repro.core.models import NNConfig
    from repro.core.pipeline import TasqConfig, TasqPipeline
    from repro.roofline import analysis
    from repro.serve import AllocationService, ShardedAllocationService

    spec, out, model_out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    p = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **spec["size"]))
    p.build()
    nn = p.train("nn")
    p.train("gnn")
    with open(model_out + ".tmp", "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, nn.params),
                     "scaler": [float(getattr(nn.scaler, k)) for k in
                                ("mu_a", "sd_a", "mu_b", "sd_b")],
                     "std": [np.asarray(nn.std.mu), np.asarray(nn.std.sd)],
                     "cfg": nn.cfg}, f)
    os.replace(model_out + ".tmp", model_out)
    exec(sys.argv[4])
    api = types.SimpleNamespace(
        AllocationService=AllocationService, AllocationPolicy=AllocationPolicy,
        ShardedAllocationService=ShardedAllocationService)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        arrays = shims(api, nn, p.eval_set, spec["K"])
    arrays["param_counts"] = np.array(json.dumps(p.param_counts))
    arrays["roofline"] = np.array(json.dumps([
        [r.host_fraction, r.row()["host_bw_frac"]]
        for r in (analysis.kernel_roofline(**kw) for kw in spec["rows"])]))
    np.savez(out, **arrays)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's shim outputs, the port's over the same network, the
    port's pipeline (nn and gnn trained here) and the carried model."""
    tmp = tmp_path_factory.mktemp("legacy_api")
    out, model_out = tmp / "reference.npz", tmp / "reference_nn.pkl"
    spec = {"size": SIZE, "K": K, "rows": ROWS}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(spec), str(out),
         str(model_out), SHIMS], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        pipe = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **SIZE),
                            device="cpu").build()
        pipe.train("nn")
        pipe.train("gnn")
        while not model_out.exists() and child.poll() is None:
            time.sleep(0.2)
        assert model_out.exists(), "the reference child wrote no model"
        model = _nn_from_pickle(model_out)
        ns = {}
        exec(SHIMS, ns)
        api = types.SimpleNamespace(
            AllocationService=lambda m, pol: AllocationService(
                m, pol, device="cpu"),
            AllocationPolicy=AllocationPolicy,
            ShardedAllocationService=ShardedAllocationService)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            port = ns["shims"](api, model, pipe.eval_set, K)
        log, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, log[-4000:]
    return port, dict(np.load(out)), pipe, model


def _count_legacy_warnings(fn, calls: int = 2):
    """Run ``fn`` ``calls`` times from a clean deprecation registry; return
    (results, number of legacy-API DeprecationWarnings emitted)."""
    reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        results = [fn() for _ in range(calls)]
    n = sum(issubclass(x.category, DeprecationWarning)
            and str(x.message).startswith(PREFIX) for x in w)
    return results, n


def _assert_result_is_decision(got, want, what):
    assert isinstance(got, AllocationResult), what
    for field in ("tokens", "a", "b", "runtime"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=what)


def test_service_shims_warn_once_and_match_decide(runs):
    _, _, pipe, model = runs
    ds = pipe.eval_set
    svc = AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                            device="cpu")
    obs = ds.observed_alloc.astype(np.int64)
    inputs = model.batch_inputs(ds)
    price = np.exp(np.random.RandomState(3).uniform(0, 2, len(ds)))
    a, b = model.predict_params(ds)
    cases = {
        "allocate_batch": (
            lambda: svc.allocate_batch(inputs, observed_tokens=obs),
            lambda: svc.decide(AllocationRequest(model_in=inputs,
                                                 observed_tokens=obs))),
        "allocate_params": (
            lambda: svc.allocate_params(a, b, observed_tokens=obs),
            lambda: svc.decide(AllocationRequest(a=a, b=b,
                                                 observed_tokens=obs))),
        "allocate_params_priced": (
            lambda: svc.allocate_params_priced(a, b, price,
                                               observed_tokens=obs),
            lambda: svc.decide(AllocationRequest(a=a, b=b,
                                                 observed_tokens=obs),
                               DecisionContext(price=price))),
        "allocate_dataset": (
            lambda: svc.allocate_dataset(ds),
            lambda: svc.decide(AllocationRequest.from_dataset(model, ds))),
    }
    assert set(cases) == set(SERVICE_SHIMS)
    for name, (legacy, modern) in cases.items():
        (r1, r2), n_warn = _count_legacy_warnings(legacy)
        assert n_warn == 1, (name, n_warn)
        want = modern()
        _assert_result_is_decision(r1, want, name)
        _assert_result_is_decision(r2, want, name)


def test_sharded_shims_warn_once_and_match_decide(runs):
    _, _, pipe, model = runs
    ds = pipe.eval_set
    fabric = ShardedAllocationService(AllocationService(
        model, AllocationPolicy(max_slowdown=0.05), device="cpu"), n_shards=K)
    obs = ds.observed_alloc.astype(np.int64)
    inputs = model.batch_inputs(ds)
    shard_of = np.arange(len(ds)) % K
    price = np.exp(np.random.RandomState(5).uniform(0, 2, len(ds)))
    a, b = model.predict_params(ds)
    cases = {
        "allocate_params": (
            lambda: fabric.allocate_params(shard_of, a, b,
                                           observed_tokens=obs),
            lambda: fabric.decide(
                AllocationRequest(a=a, b=b, observed_tokens=obs),
                DecisionContext(shard_of=shard_of))),
        "allocate_params_priced": (
            lambda: fabric.allocate_params_priced(shard_of, a, b, price,
                                                  observed_tokens=obs),
            lambda: fabric.decide(
                AllocationRequest(a=a, b=b, observed_tokens=obs),
                DecisionContext(price=price, shard_of=shard_of))),
        "allocate_batch": (
            lambda: fabric.allocate_batch(shard_of, inputs,
                                          observed_tokens=obs),
            lambda: fabric.decide(
                AllocationRequest(model_in=inputs, observed_tokens=obs),
                DecisionContext(shard_of=shard_of))),
    }
    assert set(cases) == set(FABRIC_SHIMS)
    for name, (legacy, modern) in cases.items():
        (r1, r2), n_warn = _count_legacy_warnings(legacy)
        assert n_warn == 1, (name, n_warn)
        want = modern()
        _assert_result_is_decision(r1, want, name)
        _assert_result_is_decision(r2, want, name)


@pytest.mark.parametrize("name", [f"service/{s}" for s in SERVICE_SHIMS]
                         + [f"fabric/{s}" for s in FABRIC_SHIMS])
def test_shim_equals_reference_shim(runs, name):
    """The same shim of both packages on the same network and rows: equal
    tokens, and (a, b) and runtimes to the two frameworks' float32
    forward. The policy-path shims, fed the reference's own (a, b), must
    give its tokens and runtimes bitwise (float64 in both packages)."""
    port, ref, pipe, model = runs
    for f in ("tokens", "a", "b", "runtime"):
        np.testing.assert_allclose(port[f"{name}/{f}"], ref[f"{name}/{f}"],
                                   rtol=0 if f == "tokens" else 1e-5,
                                   atol=0 if f == "tokens" else 1e-6,
                                   err_msg=f"{name}/{f}")
    kind, shim = name.split("/")
    if shim not in ("allocate_params", "allocate_params_priced"):
        return
    obs = np.asarray(pipe.eval_set.observed_alloc, np.int64)
    price = np.exp(np.random.RandomState(3).uniform(0, 2, len(obs)))
    a, b = ref["in/a"], ref["in/b"]
    svc = AllocationService(model, AllocationPolicy(max_slowdown=0.05),
                            device="cpu")
    args = (a, b, price) if shim.endswith("priced") else (a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if kind == "service":
            got = getattr(svc, shim)(*args, observed_tokens=obs)
        else:
            fab = ShardedAllocationService(svc, n_shards=K)
            got = getattr(fab, shim)(np.arange(len(obs)) % K, *args,
                                     observed_tokens=obs)
    for f in ("tokens", "a", "b", "runtime"):
        np.testing.assert_array_equal(getattr(got, f), ref[f"{name}/{f}"],
                                      err_msg=f"{name}/{f}")


def test_train_shims_warn_once_and_delegate():
    p = TasqPipeline(TasqConfig(n_train=10, n_eval=5), device="cpu")
    calls = []
    p.train = lambda family, loss="lf2": calls.append((family, loss))

    def all_three():
        p.train_xgb()
        p.train_nn("lf1")
        p.train_gnn("lf3")

    _, n_warn = _count_legacy_warnings(all_three, calls=2)
    assert n_warn == 3
    assert calls == [("gbdt", "lf2"), ("nn", "lf1"), ("gnn", "lf3")] * 2


def test_reset_rearms_the_warning():
    reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        warn_deprecated("X.m", "decide", stacklevel=2)
        warn_deprecated("X.m", "decide", stacklevel=2)
        assert len(w) == 1
        reset_deprecation_warnings()
        warn_deprecated("X.m", "decide", stacklevel=2)
        assert len(w) == 2
    assert str(w[0].message).startswith(PREFIX)
    assert w[0].category is DeprecationWarning
    reset_deprecation_warnings()


@pytest.mark.filterwarnings(
    r"error:repro legacy API:DeprecationWarning:repro_torch\.")
def test_shim_called_from_a_port_module_is_an_error(runs):
    """A real shim reached from a ``repro_torch.*`` frame raises under the
    filter, even after a downstream call warmed the once-registry for the
    same method (the registry is keyed per calling module)."""
    _, _, _, model = runs
    svc = AllocationService(model, AllocationPolicy(), device="cpu")
    a, b = np.array([-0.5]), np.array([100.0])
    reset_deprecation_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        svc.allocate_params(a, b)            # a downstream caller: this test
    import repro_torch.serve.service as svc_mod
    src = ("def _poke(svc, a, b):\n"
           "    return svc.allocate_params(a, b)\n")
    ns = {"__name__": "repro_torch.serve.service"}
    exec(compile(src, svc_mod.__file__, "exec"), ns)
    for _ in range(2):                      # and keeps raising
        with pytest.raises(DeprecationWarning):
            ns["_poke"](svc, a, b)
    reset_deprecation_warnings()


def test_no_port_module_calls_a_shim():
    """By AST: nothing under ``src/repro_torch/`` calls a shim, and only
    the shims themselves call ``warn_deprecated``."""
    shims = set(SERVICE_SHIMS) | set(FABRIC_SHIMS) | set(TRAIN_SHIMS)
    bad = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        inside = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    inside.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            if name in shims:
                bad.append(f"{where} calls {name}")
            if name == "warn_deprecated" and inside.get(id(node)) not in shims:
                bad.append(f"{where} warns outside a shim")
    assert not bad, bad


def test_param_counts_equal_reference(runs):
    """``PCCModel.param_count`` (trainable parameters; GBDT 0) and the
    pipeline's ``param_counts`` for the nn and gnn of the main path."""
    _, ref, pipe, model = runs
    want = json.loads(str(ref["param_counts"]))
    assert pipe.param_counts == want and set(want) == {"nn", "gnn"}
    assert model.param_count() == want["nn"]
    for key in ("nn:lf2", "gnn:lf2"):
        m = pipe.models[key]
        assert m.param_count() == sum(p.numel()
                                      for p in m.module.parameters())
    from repro_torch.core.models import build_model
    assert build_model("gbdt", device="cpu").param_count() == 0


def test_host_fraction_equals_reference(runs):
    _, ref, _, _ = runs
    want = json.loads(str(ref["roofline"]))
    for kw, (frac, row_frac) in zip(ROWS, want):
        r = panalysis.kernel_roofline(**kw)
        assert r.host_fraction == frac
        assert r.row()["host_bw_frac"] == row_frac
