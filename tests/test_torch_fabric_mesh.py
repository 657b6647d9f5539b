"""The allocation fabric on a shard mesh, held on the CPU over gloo ranks
against the one-device fabric, K per-shard services and the reference's
``shard_map`` path.

* K = 2 and K = 4 gloo ranks (child processes joined through a
  ``FileStore`` under ``tmp_path``, as ``test_torch_multirank.py`` does)
  each build ``make_allocation_mesh(K)`` and a ``ShardedAllocationService``
  on it. They load one trained ``nn`` and one ``gnn`` from a file this test
  writes (the reference's networks, carried across with
  ``model_from_jax``); none retrains.
* The policy stages (plain, with observed tokens, priced, both) are
  float64 and element-wise in the rows: every rank's tokens, runtimes and
  ``replica_stats`` must be bitwise those of the one-device fabric, and
  its tokens and ``replica_stats`` those of the reference's fabric on its
  ``shard_map`` path (runtimes to 4 ulp: ``pow`` of two libraries), which
  a child process
  runs on 4 forced host devices (``XLA_FLAGS``) with the ``enable_x64``
  alias the other parity tests use (a mirror of the reference's
  ``test_sharded_service_shard_map_mode_parity``). Under the installed jax
  the reference's ``shard_map`` bodies fail its varying-manual-axes check
  (the bisection's ``fori_loop`` carry starts unvarying and comes out
  varying over "shard"); the child calls ``shard_map`` with
  ``check_rep=False``, which switches that check off and changes no
  value.
* The fused stage (features -> nn / gnn -> decode -> policy) runs a float32
  product over Bp rows on a rank, over K * Bp on one device. Its oracle is
  K single-shard ``AllocationService``s fed the routed partitions at the
  rank's bucket Bp (a mirror of the reference's
  ``test_sharded_fused_path_matches_per_shard_services``): bitwise. Against
  the one-device fabric a token may differ only at a tie of the limit
  within 4 ulp (PERF.md §2, "Decisions right"); the count is printed.
* ``Allocator`` builds the mesh itself from the group, decides, and keeps
  it through ``swap_model``; a warmed fabric on the mesh builds nothing.
* ``run_cluster`` at K = 4 (edf, elastic, priced, fused: K1, K2 and K3 in
  their plain versions, unsharded on every rank) gives every rank the same
  report, equal to the one-device report and to the reference's on its
  mesh.
* ``make_allocation_mesh`` returns None without a group (this process has
  none) and with a group of another size.
* ``Server(mesh=2x2)`` on minitron smoke gives the unsharded ``Server``'s
  tokens on every rank.
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
import torch

from repro_torch.api import (AllocationRequest, Allocator, DecisionContext)
from repro_torch.cluster import ClusterConfig
from repro_torch.core.allocator import AllocationPolicy, build_policy
from repro_torch.core.models import NNConfig
from repro_torch.core.models.convert import model_from_jax
from repro_torch.core.pcc import pcc_runtime
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.launch.mesh import make_allocation_mesh
from repro_torch.serve import AllocationService, ShardedAllocationService
from repro_torch.serve.batching import shard_positions
from repro_torch.workloads import TraceGenerator

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = dict(n_train=120, n_eval=40, gnn_epochs=2)
WORLDS = (2, 4)
FUSED_ROWS = 300
SPEC = {"size": SIZE, "policy": "bounded_slowdown",
        "trace": dict(seed=7, n_unique=24, rate_qps=4.0), "n_events": 400,
        "cluster": dict(capacity=2048, epoch_s=8.0, n_shards=4,
                        admission="edf", elastic=True, pricing="elastic",
                        fused=True),
        "warm_bucket": 512}

# Run by the reference child and by every port rank: the same seeded
# inputs through ``fab.decide``; ``api`` names each package's classes.
COMMON = textwrap.dedent("""
    import json
    import numpy as np

    STATS = ("compiles", "calls", "queries", "executables_retired")
    VARIANTS = ("plain", "observed", "priced", "priced_observed")

    def history_inputs(K, B=1000, seed=0):
        rng = np.random.RandomState(seed)
        a = rng.uniform(-3.0, -1e-4, B)
        b = np.exp(rng.uniform(-1.0, 9.0, B))
        obs = rng.randint(1, 7000, B)
        price = np.exp(rng.uniform(0.0, 2.0, B))
        shard_of = np.minimum(rng.geometric(0.45, B) - 1, K - 1)
        return a, b, obs, price, shard_of

    def history_decisions(api, fab, K):
        a, b, obs, price, shard_of = history_inputs(K)
        out = {}
        for v in VARIANTS:
            d = fab.decide(
                api.AllocationRequest(
                    a=a, b=b, observed_tokens=obs if "observed" in v else None),
                api.DecisionContext(price=price if "priced" in v else None,
                                    shard_of=shard_of))
            out[v + "/tokens"], out[v + "/runtime"] = d.tokens, d.runtime
        out["replica_stats"] = np.array(
            [[r[k] for k in STATS] for r in fab.replica_stats()])
        out["stats"] = np.array([fab.stats[k] for k in STATS])
        return out

    def report_arrays(rep):
        return {"metrics": np.array(json.dumps(
                    {k: float(v) for k, v in rep.metrics.items()})),
                "cache_stats": np.array(json.dumps(
                    {k: int(v) for k, v in rep.cache_stats.items()})),
                "alloc_errors": rep.alloc_errors,
                "cache_hits": rep.cache_hits,
                "error_t": rep.error_series[0],
                "error_e": rep.error_series[1],
                "replica_queries": np.array(
                    [r["queries"] for r in rep.replica_stats]),
                "n_epochs": np.array(rep.n_epochs),
                "compiles": np.array(rep.service_stats["compiles"])}
""")

CHILD = textwrap.dedent("""
    import json, os, pickle, sys, types
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.api import (AllocationRequest, Allocator, DecisionContext)
    from repro.cluster import ClusterConfig
    from repro.core.allocator import AllocationPolicy, build_policy
    from repro.core.models import NNConfig
    from repro.core.pipeline import TasqConfig, TasqPipeline
    from repro.launch.mesh import make_allocation_mesh
    from repro.serve import AllocationService, ShardedAllocationService
    from repro.workloads import TraceGenerator
    import repro.serve.service as rsvc

    # the installed jax checks the varying manual axes of shard_map's
    # bodies, and the policy's bisection carry fails that check: the
    # reference's check_rep=False is that check switched off
    _shard_map = rsvc.shard_map
    rsvc.shard_map = lambda f, mesh, in_specs, out_specs, **kw: _shard_map(
        f, mesh, in_specs, out_specs, check_rep=False)

    spec, out, model_out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert len(jax.devices()) == 4
    p = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **spec["size"]))
    p.build()
    models = {"nn": p.train("nn"), "gnn": p.train("gnn")}
    blob = {}
    for fam, m in models.items():
        blob[fam] = {"params": jax.tree.map(np.asarray, m.params),
                     "scaler": [float(getattr(m.scaler, k)) for k in
                                ("mu_a", "sd_a", "mu_b", "sd_b")],
                     "std": [np.asarray(m.std.mu), np.asarray(m.std.sd)],
                     "cfg": m.cfg,
                     "train_cfg": getattr(m, "train_cfg", None)}
    with open(model_out + ".tmp", "wb") as f:
        pickle.dump(blob, f)
    os.replace(model_out + ".tmp", model_out)
    exec(sys.argv[4])
    api = types.SimpleNamespace(AllocationRequest=AllocationRequest,
                                DecisionContext=DecisionContext)
    arrays = {}
    for K in spec["worlds"]:
        fab = ShardedAllocationService(
            AllocationService(models["nn"], AllocationPolicy(
                max_slowdown=0.05)), K, make_allocation_mesh(K))
        assert fab.mesh is not None, "expected the shard_map path"
        for k, v in history_decisions(api, fab, K).items():
            arrays[f"K{K}/{k}"] = v
        vmap = ShardedAllocationService(
            AllocationService(models["nn"], AllocationPolicy(
                max_slowdown=0.05)), K)
        assert vmap.mesh is None
        for k, v in history_decisions(api, vmap, K).items():
            arrays[f"K{K}/vmap/{k}"] = v
    alloc = Allocator(AllocationService(models["nn"],
                                        build_policy(spec["policy"])),
                      n_shards=4)
    assert alloc.fabric.mesh is not None, "expected the shard_map path"
    trace = TraceGenerator(**spec["trace"]).generate(spec["n_events"])
    rep = alloc.run_cluster(trace, ClusterConfig(**spec["cluster"]))
    for k, v in report_arrays(rep).items():
        arrays["cluster/" + k] = v
    np.savez(out, **arrays)
""")

RANK = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, store, models_path, inputs_path, out, spec = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6], json.loads(sys.argv[7]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.api import (AllocationRequest, Allocator,
                                 DecisionContext)
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.allocator import AllocationPolicy, build_policy
    from repro_torch.launch.mesh import make_allocation_mesh
    from repro_torch.serve import (AllocationService,
                                   ShardedAllocationService, WarmupConfig)
    from repro_torch.workloads import TraceGenerator
    exec(sys.argv[8])
    api = types.SimpleNamespace(AllocationRequest=AllocationRequest,
                                DecisionContext=DecisionContext)
    models = torch.load(models_path, weights_only=False)
    inputs = dict(np.load(inputs_path))
    policy = AllocationPolicy(max_slowdown=0.05)
    res = {}

    mesh = make_allocation_mesh(world)
    assert mesh is not None and mesh.mesh_dim_names == ("shard",)
    assert mesh.size() == world and mesh.get_local_rank() == rank
    assert make_allocation_mesh(world + 1) is None
    assert make_allocation_mesh(1) is None
    svc = AllocationService(models["nn"], policy, device="cpu")
    fab = ShardedAllocationService(svc, world, mesh)
    assert fab.mesh is mesh
    assert ShardedAllocationService(svc, world + 1, mesh).mesh is None
    res.update({"history/" + k: v
                for k, v in history_decisions(api, fab, world).items()})

    shard_of = inputs["shard_of_%d" % world]
    obs = inputs["obs"]
    for fam in ("nn", "gnn"):
        f = ShardedAllocationService(AllocationService(
            models[fam], policy, device="cpu"), world, mesh)
        model_in = {k.split("/", 1)[1]: v for k, v in inputs.items()
                    if k.startswith(fam + "/")}
        d = f.decide(AllocationRequest(model_in=model_in,
                                       observed_tokens=obs),
                     DecisionContext(shard_of=shard_of))
        for k in ("tokens", "a", "b", "runtime"):
            res[f"fused/{fam}/{k}"] = getattr(d, k)

    alloc = Allocator(AllocationService(models["nn"], policy,
                                        device="cpu"), n_shards=world)
    assert alloc.mesh is not None and alloc.fabric.mesh is alloc.mesh
    a, b, hobs, price, hshard = history_inputs(world, B=40, seed=3)
    req = AllocationRequest(a=a, b=b, observed_tokens=hobs)
    ctx = DecisionContext(price=price, shard_of=hshard)
    before = alloc.decide(req, ctx)
    alloc.swap_model(models["gnn"], warmup_config=WarmupConfig(
        max_bucket=64, observed=(True,)))
    assert alloc.fabric.mesh is alloc.mesh
    assert alloc.fabric.model is models["gnn"]
    after = alloc.decide(req, ctx)
    res["swap/before"], res["swap/after"] = before.tokens, after.tokens
    res["swap/compiles"] = np.array(alloc.service.stats["compiles"])

    if world == 4:
        trace = TraceGenerator(**spec["trace"]).generate(spec["n_events"])
        alloc = Allocator(AllocationService(
            models["nn"], build_policy(spec["policy"]), device="cpu"),
            n_shards=4)
        warm = alloc.warmup(trace=trace, config=WarmupConfig(
            max_bucket=spec["warm_bucket"], observed=(True, False)))
        res["warm/n_precompiled"] = np.array(warm.n_precompiled)
        rep = alloc.run_cluster(trace, ClusterConfig(**spec["cluster"]))
        assert alloc.fabric.mesh is not None
        res.update({"cluster/" + k: v for k, v in report_arrays(rep).items()})

        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.serve import Request, ServeConfig, Server
        from repro_torch.models import model_api
        cfg = get_config("minitron-8b-smoke")
        params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
        sc = ServeConfig(batch_size=4, prompt_len=16)
        rng = np.random.RandomState(5)
        reqs = [Request(i, rng.randint(1, cfg.vocab_size, 6 + 2 * i
                                       ).astype(np.int32), 5)
                for i in range(6)]
        want = Server(cfg, sc, params, device="cpu").run(reqs)
        got = Server(cfg, sc, params, device="cpu",
                     mesh=make_smoke_mesh((2, 2))).run(reqs)
        res["server/unsharded"] = np.array([want[i] for i in range(6)])
        res["server/mesh"] = np.array([got[i] for i in range(6)])
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _model_from_blob(fam, d):
    ref = types.SimpleNamespace(
        family=fam, params=d["params"], cfg=d["cfg"],
        train_cfg=d["train_cfg"],
        scaler=types.SimpleNamespace(**dict(zip(
            ("mu_a", "sd_a", "mu_b", "sd_b"), d["scaler"]))),
        std=types.SimpleNamespace(mu=d["std"][0], sd=d["std"][1]))
    return model_from_jax(ref, device="cpu")


def _env(**extra):
    return {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT / "src")] + [p for p in os.environ.get(
                    "PYTHONPATH", "").split(os.pathsep) if p]), **extra}


def _one_device(models, inputs, trace):
    """The one-device fabric's results on the ranks' inputs, and the
    per-shard services' fused oracle at each world's bucket."""
    ns = {}
    exec(COMMON, ns)
    api = types.SimpleNamespace(AllocationRequest=AllocationRequest,
                                DecisionContext=DecisionContext)
    policy = AllocationPolicy(max_slowdown=0.05)
    out = {}
    for K in WORLDS:
        fab = ShardedAllocationService(AllocationService(
            models["nn"], policy, device="cpu"), K)
        assert fab.mesh is None
        out[K] = {"history/" + k: v for k, v in
                  ns["history_decisions"](api, fab, K).items()}
        shard_of, obs = inputs[f"shard_of_{K}"], inputs["obs"]
        _, _, Bp = shard_positions(shard_of, K)
        for fam in ("nn", "gnn"):
            model_in = {k.split("/", 1)[1]: v for k, v in inputs.items()
                        if k.startswith(fam + "/")}
            f = ShardedAllocationService(AllocationService(
                models[fam], policy, device="cpu"), K)
            d = f.decide(AllocationRequest(model_in=model_in,
                                           observed_tokens=obs),
                         DecisionContext(shard_of=shard_of))
            solo = {k: np.zeros_like(getattr(d, k))
                    for k in ("tokens", "a", "b", "runtime")}
            for k in range(K):
                m = shard_of == k
                svc = AllocationService(models[fam], policy, device="cpu",
                                        batch_floor=Bp)
                dk = svc.decide(AllocationRequest(
                    model_in={n: v[m] for n, v in model_in.items()},
                    observed_tokens=obs[m]))
                for n in solo:
                    solo[n][m] = getattr(dk, n)
            for n in solo:
                out[K][f"fused/{fam}/{n}"] = getattr(d, n)
                out[K][f"solo/{fam}/{n}"] = solo[n]
    alloc = Allocator(AllocationService(
        models["nn"], build_policy(SPEC["policy"]), device="cpu"), n_shards=4)
    assert alloc.mesh is None
    rep = alloc.run_cluster(trace, ClusterConfig(**SPEC["cluster"]))
    out["cluster"] = {"cluster/" + k: v
                      for k, v in ns["report_arrays"](rep).items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank results]}, the one-device results and the
    reference's, and the models."""
    tmp = tmp_path_factory.mktemp("fabric_mesh")
    ref_out, blob = tmp / "reference.npz", tmp / "reference_models.pkl"
    spec = dict(SPEC, worlds=list(WORLDS))
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(spec), str(ref_out),
         str(blob), COMMON], cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = []
    try:
        pipe = TasqPipeline(TasqConfig(nn=NNConfig(epochs=4), **SIZE),
                            device="cpu").build()
        while not blob.exists() and child.poll() is None:
            time.sleep(0.2)
        assert blob.exists(), "the reference child wrote no models"
        with open(blob, "rb") as f:
            d = pickle.load(f)
        models = {fam: _model_from_blob(fam, d[fam]) for fam in d}
        models_path = tmp / "models.pt"
        torch.save(models, models_path)
        rng = np.random.RandomState(11)
        jb = rng.randint(0, SIZE["n_eval"], FUSED_ROWS)
        inputs = {"obs": pipe.eval_set.observed_alloc.astype(np.int64)[jb]}
        for fam in ("nn", "gnn"):
            for k, v in models[fam].batch_inputs(pipe.eval_set).items():
                inputs[f"{fam}/{k}"] = v[jb]
        for K in WORLDS:
            inputs[f"shard_of_{K}"] = np.minimum(
                rng.geometric(0.4, FUSED_ROWS) - 1, K - 1)
        inputs_path = tmp / "inputs.npz"
        np.savez(inputs_path, **inputs)
        # each rank writes to its own file: a full pipe would stall a rank
        # while the others wait for it in a collective
        for K in WORLDS:
            store = tmp / f"store{K}"
            for r in range(K):
                with open(tmp / f"rank{K}_{r}.log", "w") as log:
                    ranks.append((K, r, tmp / f"rank{K}_{r}.npz",
                                  subprocess.Popen(
                        [sys.executable, "-c", RANK, str(r), str(K),
                         str(store), str(models_path), str(inputs_path),
                         str(tmp / f"rank{K}_{r}.npz"), json.dumps(SPEC),
                         COMMON], cwd=ROOT, env=_env(), stdout=log,
                        stderr=subprocess.STDOUT)))
        trace = TraceGenerator(**SPEC["trace"]).generate(SPEC["n_events"])
        one = _one_device(models, inputs, trace)
        # the first rank to fail stops the others, which would wait for
        # it in a collective
        procs = [p for *_, p in ranks]
        deadline = time.monotonic() + 600
        while any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        logs = [(K, r, out, p.returncode,
                 (tmp / f"rank{K}_{r}.log").read_text())
                for K, r, out, p in ranks]
        ref_log, _ = child.communicate(timeout=600)
    finally:
        for *_, p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
        if child.poll() is None:
            child.kill()
            child.communicate()
    failed = sorted(logs, key=lambda x: x[3] in (0, -9))
    for K, r, _, rc, log in failed:
        assert rc == 0, f"rank {r} of {K}: {log[-4000:]}"
    assert child.returncode == 0, ref_log[-4000:]
    got = {K: [dict(np.load(out)) for k, r, out, *_ in logs if k == K]
           for K in WORLDS}
    return got, one, dict(np.load(ref_out)), models, inputs


def _is_tie(a, b, t1, t2, observed, policy):
    """Whether the limit lies within 4 ulp of the runtime at the smaller
    token count, or just below the larger: the two tokens then straddle a
    tie that the last bits of ``pow`` may break either way."""
    limit = (1.0 + policy.max_slowdown) * float(pcc_runtime(a, b, observed))
    lo, hi = sorted((int(t1), int(t2)))
    return any(abs(float(pcc_runtime(a, b, t)) - limit)
               <= 4 * np.spacing(limit) for t in (lo, hi - 1))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant",
                         ["plain", "observed", "priced", "priced_observed"])
def test_policy_stage_on_mesh_equals_one_device_and_shard_map(runs, world,
                                                              variant):
    """Tokens bitwise everywhere; runtimes bitwise against the one-device
    fabric. The runtime ``b * tokens ** a`` takes ``pow`` from torch here
    and from XLA in the reference, and the two differ in the last bit of
    about one row in a hundred, so across the packages it is held to 4
    ulp; the reference's ``shard_map`` runtimes must equal its own
    ``vmap`` ones bitwise, as the port's mesh equals its one device."""
    got, one, ref, _, _ = runs
    tok, rt = f"{variant}/tokens", f"{variant}/runtime"
    np.testing.assert_array_equal(ref[f"K{world}/{tok}"],
                                  ref[f"K{world}/vmap/{tok}"])
    np.testing.assert_array_equal(ref[f"K{world}/{rt}"],
                                  ref[f"K{world}/vmap/{rt}"])
    for r, res in enumerate(got[world]):
        for key in (tok, rt):
            np.testing.assert_array_equal(res["history/" + key],
                                          one[world]["history/" + key],
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(res["history/" + tok],
                                      ref[f"K{world}/{tok}"],
                                      err_msg=f"rank {r} {tok} vs shard_map")
        np.testing.assert_allclose(res["history/" + rt],
                                   ref[f"K{world}/{rt}"],
                                   rtol=4 * np.finfo(np.float64).eps, atol=0,
                                   err_msg=f"rank {r} {rt} vs shard_map")


@pytest.mark.parametrize("world", WORLDS)
def test_counters_on_mesh_equal_one_device_and_shard_map(runs, world):
    """``replicas[k].stats`` and the fabric's ``stats`` (its builds too)
    are counted on the host: every rank reads the one-device fabric's and
    the reference's."""
    got, one, ref, _, _ = runs
    for r, res in enumerate(got[world]):
        for k in ("replica_stats", "stats"):
            np.testing.assert_array_equal(res["history/" + k],
                                          one[world]["history/" + k],
                                          err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(res["history/" + k],
                                          ref[f"K{world}/{k}"],
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ["nn", "gnn"])
def test_fused_on_mesh_equals_per_shard_services(runs, world, family):
    got, one, _, models, inputs = runs
    policy = AllocationPolicy(max_slowdown=0.05)
    for r, res in enumerate(got[world]):
        for k in ("tokens", "a", "b", "runtime"):
            np.testing.assert_array_equal(
                res[f"fused/{family}/{k}"], one[world][f"solo/{family}/{k}"],
                err_msg=f"rank {r} {family} {k} vs per-shard services")
    mesh, flat = got[world][0], one[world]
    diff = np.flatnonzero(mesh[f"fused/{family}/tokens"]
                          != flat[f"fused/{family}/tokens"])
    print(f"fused {family} K={world}: {diff.size} token(s) differ from the "
          f"one-device fabric: {diff.tolist()}")
    for i in diff:
        assert _is_tie(float(mesh[f"fused/{family}/a"][i]),
                       float(mesh[f"fused/{family}/b"][i]),
                       mesh[f"fused/{family}/tokens"][i],
                       flat[f"fused/{family}/tokens"][i],
                       int(inputs["obs"][i]), policy), (
            f"row {i}: mesh and one-device tokens differ beyond a tie")


@pytest.mark.parametrize("world", WORLDS)
def test_allocator_builds_the_mesh_and_swap_keeps_it(runs, world):
    """Checked on the ranks: the Allocator's mesh is the group's, the
    swapped fabric sits on the same mesh, and a history decision after a
    warmed swap equals the one before and builds nothing."""
    got, *_ = runs
    for res in got[world]:
        np.testing.assert_array_equal(res["swap/after"], res["swap/before"])
        assert int(res["swap/compiles"]) == 0


def _report(arrays):
    return {k.split("/", 1)[1]: (json.loads(str(v)) if v.dtype.kind == "U"
                                 else v)
            for k, v in arrays.items() if k.startswith("cluster/")}


def _assert_reports_equal(got, want, what):
    assert got["metrics"].keys() == want["metrics"].keys(), what
    for k, v in want["metrics"].items():
        g = got["metrics"][k]
        assert g == v or (np.isnan(g) and np.isnan(v)), (what, k, g, v)
    assert got["cache_stats"] == want["cache_stats"], what
    for k in ("alloc_errors", "cache_hits", "error_t", "replica_queries",
              "n_epochs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}/{k}")
    assert np.array_equal(got["error_e"], want["error_e"], equal_nan=True)


def test_run_cluster_on_k4_mesh_equals_one_device_and_reference(runs):
    got, one, ref, _, _ = runs
    flat, theirs = _report(one["cluster"]), _report(ref)
    # the reference sorts its cache table again after every change; the
    # port's table is sorted whole only by a refit that fills it empty
    rebuilds = flat["cache_stats"]["dense_rebuilds"]
    assert rebuilds <= len(flat["replica_queries"])
    theirs["cache_stats"]["dense_rebuilds"] = rebuilds
    _assert_reports_equal(flat, theirs, "one-device vs reference mesh")
    assert flat["metrics"]["resize_shrinks"] > 0
    for r, res in enumerate(got[4]):
        _assert_reports_equal(_report(res), flat, f"rank {r}")


def test_warmed_mesh_fabric_builds_nothing(runs):
    got, *_ = runs
    for r, res in enumerate(got[4]):
        assert int(res["warm/n_precompiled"]) > 0
        assert int(res["cluster/compiles"]) == 0, f"rank {r} built"


def test_make_allocation_mesh_without_a_group_is_none():
    """This process has no default group (the ranks check a group of
    another size and the K-rank mesh); the fabric and the Allocator then
    decide on one device, as before."""
    assert not torch.distributed.is_initialized()
    for k in (1, 2, 4):
        assert make_allocation_mesh(k) is None
    alloc = Allocator(AllocationService(_StubModel(), AllocationPolicy(),
                                        device="cpu"), n_shards=4)
    assert alloc.mesh is None and alloc.fabric.mesh is None
    d = alloc.decide(AllocationRequest(a=np.array([-0.5, -0.2]),
                                       b=np.array([100.0, 50.0])),
                     DecisionContext(shard_of=np.array([3, 0])))
    assert d.tokens.shape == (2,)


class _StubModel:
    family = "stub"
    cache_key = "stub#0"
    supports_fused = False


def test_server_on_2x2_mesh_equals_unsharded(runs):
    got, *_ = runs
    for r, res in enumerate(got[4]):
        np.testing.assert_array_equal(res["server/mesh"],
                                      res["server/unsharded"],
                                      err_msg=f"rank {r}")
