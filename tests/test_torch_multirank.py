"""The port's multi-card LM stack on several ranks, held on the CPU over
gloo: each rank is a child process (``OMP_NUM_THREADS=1``) that joins a
group through a ``FileStore`` under ``tmp_path`` (no ports to collide
between test workers).

* 4 ranks on a 2x2 ("data", "model") mesh: one sharded train step and a
  sharded prefill of the dense, MoE and hybrid smoke models (minitron,
  moonshot, zamba2) against the port's unsharded step on the same
  weights, and ``compressed_psum`` against numpy of the reference's
  formula;
* an elastic restart: ``run_training`` saves on the 2x2 mesh (4 ranks),
  then restores and resumes on the 1x2 mesh that
  ``ElasticController(MeshPlan(data=2, model=2), chips_per_host=2)``
  proposes after ``host_failed(1)`` (2 ranks), against an uninterrupted
  unsharded run;
* 1 rank on a 1x1 mesh: the port's sharded step of zamba2 smoke (the
  kernels' route, K4 and K5 under ``local_map``, their plain versions on
  the CPU) against the reference's ``make_train_step(cfg,
  Mesh(devices.reshape(1, 1), ...))`` with its Pallas kernels.

Tolerances. Loss: 1e-5 relative (float32 sums over shards in another
order). Updated leaves: 1e-5 of the leaf's largest magnitude (the
reduction order of the gradients' all-reduce). Gradients, which the step
normalises away (AdamW's first update is lr * g / |g|): 1e-4 of the
leaf's largest magnitude; the sharded MoE takes its gate and aux
gradients through other sums, 1e-4 as well (in float64 they agree to
2e-7, so the float32 gap is rounding, not a fault). Prefill logits: 1e-5
of their largest magnitude.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as ref_get_config
from repro.models import model_api as rapi
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init
from repro.train import steps as rsteps
from repro_torch.configs import get_config
from repro_torch.launch import train as ptrain
from repro_torch.launch.elastic import ElasticController, MeshPlan
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import make_train_step, train_state_from_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["minitron-8b", "moonshot-v1-16b-a3b", "zamba2-2.7b"]
ELASTIC_ARCH = "zamba2-2.7b-smoke"
LOOP = dict(steps=6, seq_len=64, global_batch=4, log_every=1, ckpt_every=2)

_PRELUDE = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.configs import get_config
from repro_torch.models import model_api
from repro_torch.train import steps as st
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch import train as ptrain
from repro_torch.launch.elastic import ElasticController, MeshPlan

def clone(t):
    if isinstance(t, dict):
        return {k: clone(v) for k, v in t.items()}
    return t.detach().clone()

def rel(a, b):
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
"""

# 4 ranks: the three archs' steps and prefills, compressed_psum, and the
# elastic run's first half (checkpoints on the 2x2 mesh)
_STEPS = _PRELUDE + """
from repro_torch.optim.compression import compressed_psum
mesh = make_smoke_mesh((2, 2))
res = {}
for arch in %(archs)r:
    cfg = get_config(arch + "-smoke")
    params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = model_api.smoke_batch(cfg, "train", seed=1, device="cpu",
                                  batch=4, seq=64)
    ref = st.train_state_from_params(clone(params))
    tot0, _ = model_api.get_module(cfg).forward_train(ref.params, batch, cfg)
    g0 = torch.autograd.grad(tot0, ref.opt.params)
    ref, rm = st.make_train_step(cfg)(ref, batch)
    state = st.shard_state(st.train_state_from_params(clone(params)), cfg,
                           mesh)
    sb = st.shard_batch(batch, cfg, mesh)
    from repro_torch.models.params import Sharder
    from torch.distributed.tensor.experimental import implicit_replication
    tot1, _ = model_api.get_module(cfg).forward_train(
        state.params, sb, cfg, Sharder(mesh, cfg.rules()))
    with implicit_replication():
        g1 = [g.full_tensor() for g in torch.autograd.grad(
            tot1, state.opt.params)]
    state, m = st.make_train_step(cfg, mesh)(state, sb)
    leaves = [p.full_tensor().detach() for p in st.tree_leaves(state.params)]
    pb = model_api.smoke_batch(cfg, "prefill", seed=2, device="cpu",
                               batch=4, seq=64)
    l0, _ = st.make_prefill_step(cfg)(clone(params), pb)
    dp = model_api.distribute(clone(params), model_api.shardings(cfg, mesh),
                              mesh)
    l1, _ = st.make_prefill_step(cfg, mesh)(dp, st.shard_batch(pb, cfg, mesh))
    res[arch] = {
        "loss_ref": float(rm["loss"]), "loss": float(m["loss"]),
        "leaf_rel": max(rel(a.detach(), b) for a, b in
                        zip(st.tree_leaves(ref.params), leaves)),
        "grad_rel": max(rel(a, b) for a, b in zip(g0, g1)),
        "prefill_rel": rel(l0, l1.full_tensor()),
        "both_sharded": sum(all(q.is_shard() for q in p.placements)
                            for p in st.tree_leaves(state.params))}
rng = np.random.RandomState(100 + rank)
g = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
r = torch.from_numpy(0.01 * rng.standard_normal((3, 5)).astype(np.float32))
mean, new_r = compressed_psum(g, r)
res["psum"] = {"mean": mean.tolist(), "residual": new_r.tolist()}
cfg = get_config(%(elastic)r)
ptrain.run_training(cfg, ptrain.TrainLoopConfig(
    **dict(%(loop)r, steps=4, ckpt_dir=%(ckpt)r)), mesh=mesh,
    log_fn=lambda s: None, device="cpu")
if rank == 0:
    json.dump(res, open(out, "w"))
"""

# 2 ranks: the elastic restart onto the mesh the controller proposes
_RESUME = _PRELUDE + """
ctl = ElasticController(MeshPlan(data=2, model=2), chips_per_host=2)
plan = ctl.host_failed(1)
mesh = plan.build()
cfg = get_config(%(elastic)r)
got = ptrain.run_training(cfg, ptrain.TrainLoopConfig(
    **dict(%(loop)r, ckpt_dir=%(ckpt)r, resume=True)), mesh=mesh,
    log_fn=lambda s: None, device="cpu")
if rank == 0:
    json.dump({"plan": list(plan.shape()), "losses": got["losses"],
               "resumed_from": got["resumed_from"]}, open(out, "w"))
"""

# 1 rank: the port's 1x1 step on the reference's weights
_ONE = _PRELUDE + """
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
mesh = make_smoke_mesh((1, 1))
npz = np.load(%(weights)r)
tree = {}
for k in npz.files:
    node = tree
    *path, leaf = k.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = npz[k]
import dataclasses
cfg = dataclasses.replace(get_config(%(arch)r), attention_impl="pallas",
                          ssd_impl="pallas")
state = st.train_state_from_params(params_from_jax(tree, cfg, "cpu"),
                                   AdamWConfig(warmup_steps=2))
state = st.shard_state(state, cfg, mesh)
b = np.load(%(batch)r)
batch = st.shard_batch({k: torch.from_numpy(b[k]) for k in b.files}, cfg,
                       mesh)
state, m = st.make_train_step(cfg, mesh)(state, batch)
json.dump({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "m": [t.full_tensor().numpy().ravel().tolist()
                 for t in state.opt.m]}, open(out, "w"))
"""


def _launch(code: str, world: int, tmp, name: str):
    """Start ``world`` ranks of ``code``; returns (processes, out path)."""
    path = tmp / f"{name}.py"
    path.write_text(textwrap.dedent(code))
    store, out = str(tmp / f"{name}.store"), str(tmp / f"{name}.json")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(world),
                               store, out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, out


def _join(procs, out, timeout=240):
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(out) as f:
        return json.load(f)


def _ref_tree(arch):
    return jax.tree.map(np.asarray, rapi.init(ref_get_config(arch),
                                              jax.random.PRNGKey(0)))


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    ckpt = str(tmp / "ckpt")
    one_arch = "zamba2-2.7b-smoke"
    tree = _ref_tree(one_arch)
    np.savez(tmp / "w.npz", **_flat(tree))
    # the batch of test_torch_lm_train.py's train-step parity test, whose
    # tolerances it shares
    rng = np.random.RandomState(2)
    batch = {"tokens": rng.randint(0, 256, (4, 32)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 32)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    np.savez(tmp / "b.npz", **batch)
    steps = _launch(_STEPS % dict(archs=ARCHS, elastic=ELASTIC_ARCH,
                                  loop=LOOP, ckpt=ckpt), 4, tmp, "steps")
    one = _launch(_ONE % dict(weights=str(tmp / "w.npz"),
                              batch=str(tmp / "b.npz"), arch=one_arch),
                  1, tmp, "one")
    out = {"steps": _join(*steps), "one": _join(*one), "tree": tree,
           "batch": batch, "one_arch": one_arch}
    out["resume"] = _join(*_launch(
        _RESUME % dict(elastic=ELASTIC_ARCH, loop=LOOP, ckpt=ckpt), 2, tmp,
        "resume"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(runs, arch):
    r = runs["steps"][arch]
    np.testing.assert_allclose(r["loss"], r["loss_ref"], rtol=1e-5)
    assert r["leaf_rel"] <= 1e-5, r
    assert r["grad_rel"] <= 1e-4, r
    # the mesh really shards: leaves split on data (FSDP) and model (TP)
    assert r["both_sharded"] > 0, r


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_unsharded(runs, arch):
    assert runs["steps"][arch]["prefill_rel"] <= 1e-5


def test_compressed_psum_on_four_ranks_is_the_references_formula(runs):
    """Each rank's (g + residual) quantised to int8 with its own scale,
    dequantised, summed over the 4 ranks and averaged; the residual is
    what quantisation dropped (rank 0's)."""
    def send(rank):
        rng = np.random.RandomState(100 + rank)
        g = rng.standard_normal((3, 5)).astype(np.float32)
        r = (0.01 * rng.standard_normal((3, 5))).astype(np.float32)
        x = g + r
        scale = np.maximum(np.abs(x).max() / np.float32(127.0),
                           np.float32(1e-12)).astype(np.float32)
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        sent = q.astype(np.float32) * scale
        return sent, x - sent
    sents = [send(r) for r in range(4)]
    want = sum(s for s, _ in sents) / 4
    got = runs["steps"]["psum"]
    np.testing.assert_allclose(np.asarray(got["mean"]), want, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(got["residual"], np.float32),
                                  sents[0][1])


def test_elastic_restore_resumes_on_the_smaller_mesh(runs):
    """Saved at step 4 on 2x2, restored onto 1x2 (the model degree kept),
    resumed to step 6: the losses are those of an uninterrupted run."""
    r = runs["resume"]
    assert r["plan"] == [1, 2] and r["resumed_from"] == 4
    want = ptrain.run_training(get_config(ELASTIC_ARCH),
                               ptrain.TrainLoopConfig(**LOOP),
                               log_fn=lambda s: None, device="cpu")
    np.testing.assert_allclose(r["losses"], want["losses"][4:], rtol=1e-5)
    plan = ElasticController(MeshPlan(data=2, model=2),
                             chips_per_host=2).host_failed(1)
    assert plan == MeshPlan(data=1, model=2)


def test_one_by_one_mesh_step_matches_the_references(runs):
    """The reference's train step on a 1x1 ``Mesh`` (its sharding
    constraints in place) and the port's on a 1x1 ``DeviceMesh``, on the
    reference's weights and ``test_torch_lm_train.py``'s parity batch,
    held as that test holds the unsharded steps: loss and grad norm to
    1e-5, m (the clipped gradient times 1 - b1) to rtol 1e-4 and atol
    1e-4 of each leaf's largest magnitude. The 1x1 step also equals the
    port's own unsharded step to 1e-6."""
    arch = runs["one_arch"]
    tree, batch = runs["tree"], runs["batch"]
    jcfg = dataclasses.replace(ref_get_config(arch), attention_impl="pallas",
                               ssd_impl="pallas")
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    opt = RefAdamWConfig(warmup_steps=2)
    jstate = rsteps.TrainState(jax.tree.map(jnp.asarray, tree),
                               adamw_init(tree), jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(rsteps.make_train_step(jcfg, mesh, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = runs["one"]
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-5)
    # the 1x1 mesh adds nothing to the port's own unsharded step
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas",
                              ssd_impl="pallas")
    state = train_state_from_params(params_from_jax(tree, cfg, "cpu"),
                                    AdamWConfig(warmup_steps=2))
    _, m = make_train_step(cfg)(state, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-6)
    want = _flat(jax.tree.map(np.asarray, jstate.opt["m"]))
    for g, name in zip(got["m"], sorted(want)):
        w = want[name].ravel()
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
