"""Checkpoints and resumed training, port against reference on the CPU.

``repro_torch.ckpt.CheckpointManager`` against the reference's
``test_ckpt_data.py`` cases (round trip, retention, ``.tmp`` garbage
collection, async write, hash mismatch; ``shardings`` raises here, the
multi-card slice's), then the files across packages: a float32 train
state written by either package restores bitwise in the other, in the
leaf order of the reference's ``TrainState``; a bf16 leaf written by the
reference restores bitwise in the port, while the reference's own restore
of it raises (ROADMAP, reference baseline).

Resumed training: ``run_training`` of both packages, 6 steps with a
checkpoint every 3, then resumed to 10, from the reference's seeded
weights; logged losses within 1e-5 relative (float32 on both sides,
summed in other orders). The reference's resumed run is fed the batches
from step 0 on, not from its checkpoint's step (its pipeline's prefetch
thread starts before the seek): the comparison runs it with that one
step repaired, and ``test_reference_resume_restarts_the_token_stream``
holds the fault as it is.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.data import TokenPipeline as RefPipeline
from repro.launch import train as rtrain
from repro.models import model_api as rapi
from repro.optim.adamw import adamw_init
from repro.train import steps as rsteps
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import train as ptrain
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import (state_from_leaves, state_leaves,
                                     train_state_from_params, tree_leaves)

RESUME_ARCHS = ["minitron-8b-smoke", "zamba2-2.7b-smoke"]
LOOP = dict(seq_len=32, global_batch=4, log_every=1, seed=0, ckpt_every=3)


def _state(seed=0):
    """The reference test's state, as tensors."""
    rng = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)),
        "opt": {"m": torch.zeros((8, 4)), "count": torch.tensor(3)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _bits(x):
    """The bytes of a tensor or array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.asarray(x).tobytes()


# --------------------------------------------------- the reference's cases --
def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    s = _state()
    cm.save(10, s, blocking=True)
    got, step = cm.restore(_state(seed=1))
    assert step == 10
    for a, b in zip(_leaves(s), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_latest_step_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _state(), blocking=True)
    assert cm.latest_step() == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004"]


def test_incomplete_checkpoint_garbage_collected(tmp_path):
    os.makedirs(tmp_path / "step_000000007.tmp")
    cm = CheckpointManager(str(tmp_path))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert cm.latest_step() is None
    with pytest.raises(FileNotFoundError):
        cm.restore(_state())


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` returns before the write; the state changed after it does
    not reach the file (the host snapshot is a copy, not a view)."""
    cm = CheckpointManager(str(tmp_path))
    s = _state()
    want = s["w"].clone()
    cm.save(5, s)                      # non-blocking
    s["w"].add_(1.0)
    cm.wait()
    assert cm.latest_step() == 5
    got, _ = cm.restore(_state(seed=1))
    assert torch.equal(got["w"], want)


def test_config_hash_mismatch_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(), config_hash="aaaa", blocking=True)
    with pytest.raises(AssertionError):
        cm.restore(_state(), expect_config_hash="bbbb")
    assert cm.restore(_state(), expect_config_hash="aaaa")[1] == 1


def test_restore_with_shardings_raises(tmp_path):
    """Restoring onto a mesh is the multi-card slice's."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, _state(), mesh_shape={"data": 4, "model": 2}, blocking=True)
    with pytest.raises(NotImplementedError, match="multi-card"):
        cm.restore(_state(seed=1), shardings={"w": None})


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "moonshot-v1-16b-a3b",
                                  "minitron-8b"])
def test_config_hash_is_the_references(arch):
    for smoke in (False, True):
        assert CheckpointManager.config_hash(get_config(arch, smoke=smoke)) \
            == RefCheckpointManager.config_hash(ref_get_config(arch,
                                                               smoke=smoke))


# ------------------------------------------------------- across packages --
def _weights(arch):
    return jax.tree.map(np.asarray, rapi.init(ref_get_config(arch),
                                              jax.random.PRNGKey(0)))


def _ref_train_state(tree, seed):
    """A reference ``TrainState`` with seeded nonzero m and v."""
    rng = np.random.RandomState(seed)
    rand = lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
        np.float32))
    return rsteps.TrainState(
        jax.tree.map(jnp.asarray, tree),
        {"count": jnp.asarray(7, jnp.int32), "m": jax.tree.map(rand, tree),
         "v": jax.tree.map(lambda a: jnp.abs(rand(a)), tree)},
        jnp.asarray(7, jnp.int32))


def _port_train_state(tree, arch):
    cfg = get_config(arch)
    return train_state_from_params(params_from_jax(tree, cfg, "cpu"))


def test_state_leaves_are_in_the_references_order():
    """Names aside, the port's flat train state has the reference
    ``TrainState``'s leaves: shapes and types in the same order."""
    arch = "zamba2-2.7b-smoke"
    tree = _weights(arch)
    ref = jax.tree.leaves(rsteps.TrainState(tree, adamw_init(tree),
                                            jnp.zeros((), jnp.int32)))
    got = state_leaves(_port_train_state(tree, arch))
    assert [(tuple(a.shape), str(a.dtype)) for a in ref] == [
        (tuple(t.shape), str(t.dtype).split(".")[1]) for t in got]


def test_reference_train_state_restores_bitwise_in_the_port(tmp_path):
    arch = "minitron-8b-smoke"
    tree = _weights(arch)
    ref_state = _ref_train_state(tree, 1)
    RefCheckpointManager(str(tmp_path)).save(7, ref_state, blocking=True)
    like = _port_train_state(tree, arch)
    leaves, step = CheckpointManager(str(tmp_path)).restore(
        state_leaves(like))
    state = state_from_leaves(leaves, like)
    assert step == 7 and state.step == 7 and state.opt.count == 7
    want = jax.tree.leaves(ref_state)
    got = state_leaves(state)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _bits(a) == _bits(np.asarray(b)), i
    n = len(state.opt.params)
    assert all(t.requires_grad for t in tree_leaves(state.params))
    assert state.opt.params[0] is tree_leaves(state.params)[0]
    assert state.opt.m[0] is got[n + 1]


def test_port_train_state_restores_bitwise_in_the_reference(tmp_path):
    arch = "zamba2-2.7b-smoke"
    tree = _weights(arch)
    state = _port_train_state(tree, arch)
    rng = np.random.RandomState(2)
    for m, v in zip(state.opt.m, state.opt.v):
        m.copy_(torch.from_numpy(rng.standard_normal(m.shape).astype(
            np.float32)))
        v.copy_(m.abs())
    state.opt.count, state.step = 5, 5
    CheckpointManager(str(tmp_path)).save(5, state_leaves(state),
                                          blocking=True)
    got, step = RefCheckpointManager(str(tmp_path)).restore(
        rsteps.TrainState(tree, adamw_init(tree), jnp.zeros((), jnp.int32)))
    assert step == 5 and int(got.step) == 5 and int(got.opt["count"]) == 5
    for i, (a, b) in enumerate(zip(jax.tree.leaves(got),
                                   state_leaves(state))):
        assert _bits(np.asarray(a)) == _bits(b), i


def _bf16_tree(seed):
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return w, {"c": np.int32(3), "w": w}


def test_reference_bf16_leaf_restores_bitwise_in_the_port(tmp_path):
    """The reference writes a bf16 leaf as 2-byte records (``|V2``) and
    "bfloat16" in the manifest; the port reads the bits back as
    ``torch.bfloat16``. The reference's own restore of the same file
    raises (jax takes no ``|V2`` array)."""
    w, _ = _bf16_tree(3)
    ref_tree = {"c": jnp.asarray(3, jnp.int32),
                "w": jnp.asarray(w, jnp.bfloat16)}
    RefCheckpointManager(str(tmp_path)).save(1, ref_tree, blocking=True)
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == ["int32", "bfloat16"]
    like = {"c": torch.tensor(0, dtype=torch.int32),
            "w": torch.zeros((3, 5), dtype=torch.bfloat16)}
    got, _ = CheckpointManager(str(tmp_path)).restore(like)
    assert got["w"].dtype == torch.bfloat16 and got["c"].dtype == torch.int32
    assert _bits(got["w"]) == np.asarray(ref_tree["w"]).view(
        np.int16).tobytes()
    assert int(got["c"]) == 3
    with pytest.raises(TypeError, match="V2"):
        RefCheckpointManager(str(tmp_path)).restore(ref_tree)


def test_port_bf16_file_is_the_references(tmp_path):
    """The same bf16 and int32 leaves written by both packages: equal
    manifests (the tree printed alike) and equal ``|V2`` records."""
    w, _ = _bf16_tree(4)
    RefCheckpointManager(str(tmp_path / "ref")).save(
        2, {"c": jnp.asarray(3, jnp.int32), "w": jnp.asarray(w, jnp.bfloat16)},
        blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(
        2, {"c": torch.tensor(3, dtype=torch.int32),
            "w": torch.from_numpy(w).bfloat16()}, blocking=True)
    files = {}
    for side in ("ref", "port"):
        d = tmp_path / side / "step_000000002"
        files[side] = (json.loads((d / "manifest.json").read_text()),
                       np.load(d / "arrays.npz"))
    assert files["port"][0] == files["ref"][0]
    for name in ("leaf_0", "leaf_1"):
        a, b = files["port"][1][name], files["ref"][1][name]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert files["port"][1]["leaf_1"].dtype == np.dtype("V2")


# ------------------------------------------------------- resumed training --
class _SeekingPipeline(RefPipeline):
    """The reference's pipeline with its seek taking effect on a running
    prefetch thread (the thread restarts at the new step)."""

    def seek(self, step):
        running = self._thread is not None
        if running:
            self.stop()
        super().seek(step)
        if running:
            self.start()


def _patch_init(monkeypatch, tree):
    monkeypatch.setattr(rtrain, "init_train_state", lambda c, rng: (
        rsteps.TrainState(jax.tree.map(jnp.asarray, tree), adamw_init(tree),
                          jnp.zeros((), jnp.int32))))
    monkeypatch.setattr(ptrain, "init_train_state", lambda c, g, d, o: (
        train_state_from_params(params_from_jax(tree, c, d), o)))


def _ref_runs(arch, root, monkeypatch, repaired):
    jcfg = dataclasses.replace(ref_get_config(arch), attention_impl="pallas",
                               ssd_impl="pallas")
    if repaired:
        monkeypatch.setattr(rtrain, "TokenPipeline", _SeekingPipeline)
    first = rtrain.run_training(jcfg, rtrain.TrainLoopConfig(
        steps=6, ckpt_dir=root, **LOOP), log_fn=lambda s: None)
    second = rtrain.run_training(jcfg, rtrain.TrainLoopConfig(
        steps=10, ckpt_dir=root, resume=True, **LOOP), log_fn=lambda s: None)
    monkeypatch.setattr(rtrain, "TokenPipeline", RefPipeline)
    return first, second


def _keep_step_6(root):
    """Drop the checkpoints a resumed run wrote after step 6."""
    for name in ("step_000000009", "step_000000010"):
        shutil.rmtree(os.path.join(root, name))


def _port_run(arch, root, steps, resume, **kw):
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas",
                              ssd_impl="pallas")
    return ptrain.run_training(cfg, ptrain.TrainLoopConfig(
        steps=steps, ckpt_dir=root, resume=resume, **LOOP),
        log_fn=lambda s: None, device="cpu", **kw)


@pytest.mark.parametrize("arch", RESUME_ARCHS)
def test_resumed_training_matches_reference(arch, tmp_path, monkeypatch):
    """6 steps with checkpoints at 3 and 6, then resumed from 6 to 10, in
    both packages: losses step by step within 1e-5; the port resumed from
    the reference's checkpoint folder gives the reference's resumed
    losses; the port's resumed losses are its uninterrupted run's, bit for
    bit; the kept checkpoints are the same steps."""
    tree = _weights(arch)
    _patch_init(monkeypatch, tree)
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_first, ref_second = _ref_runs(arch, ref_root, monkeypatch, True)
    first = _port_run(arch, port_root, 6, False)
    second = _port_run(arch, port_root, 10, True)
    assert (first["steps_run"], second["steps_run"]) == (6, 4)
    assert second["resumed_from"] == ref_second["resumed_from"] == 6
    np.testing.assert_allclose(first["losses"], ref_first["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(second["losses"], ref_second["losses"],
                               rtol=1e-5)
    assert sorted(os.listdir(port_root)) == sorted(os.listdir(ref_root)) == [
        "step_000000006", "step_000000009", "step_000000010"]
    # the port resumed from the reference's step-6 checkpoint
    _keep_step_6(ref_root)
    from_ref = _port_run(arch, ref_root, 10, True)
    assert from_ref["resumed_from"] == 6
    np.testing.assert_allclose(from_ref["losses"], ref_second["losses"],
                               rtol=1e-5)
    whole = _port_run(arch, "", 10, False)
    assert whole["losses"][6:] == second["losses"]
    assert whole["losses"][:6] == first["losses"]


def test_reference_resume_restarts_the_token_stream(tmp_path, monkeypatch):
    """The reference's resume as it is: ``TokenPipeline(...).start()``
    then ``seek(start_step)`` (``launch/train.py``), and the prefetch
    thread has read its first step, 0, by then. Its resumed losses are
    those of the port resumed from the same checkpoint on the batches from
    step 0, not from step 6."""
    arch = "minitron-8b-smoke"
    tree = _weights(arch)
    _patch_init(monkeypatch, tree)
    root = str(tmp_path / "ref")
    _, ref_second = _ref_runs(arch, root, monkeypatch, False)
    _keep_step_6(root)
    seeks = []
    monkeypatch.setattr(ptrain.TokenPipeline, "seek",
                        lambda self, step: seeks.append(step))
    from_zero = _port_run(arch, root, 10, True)
    assert seeks == [6]
    np.testing.assert_allclose(from_zero["losses"], ref_second["losses"],
                               rtol=1e-5)
    monkeypatch.undo()
    _patch_init(monkeypatch, tree)
    _keep_step_6(root)
    continued = _port_run(arch, root, 10, True)
    assert np.abs(np.subtract(continued["losses"],
                              ref_second["losses"])).max() > 1e-3


def test_cli_passes_the_checkpoint_options(monkeypatch):
    seen = {}
    monkeypatch.setattr(ptrain, "run_training", lambda cfg, loop: seen.update(
        cfg=cfg, loop=loop) or {"steps_run": 0, "final_loss": 0.0})
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "zamba2-2.7b-smoke", "--steps", "20",
        "--ckpt-dir", "/ck", "--resume"])
    ptrain.main()
    assert seen["cfg"].name == "zamba2-2.7b-smoke"
    assert (seen["loop"].steps, seen["loop"].ckpt_dir, seen["loop"].resume,
            seen["loop"].ckpt_every) == (20, "/ck", True, 50)
