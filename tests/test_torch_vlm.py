"""The VLM family (qwen2-vl), port against reference on the CPU: M-RoPE,
the patch embeddings written over the first rows, prefill and decode with
caller-supplied (3, B, S) positions, ``forward_train`` and its gradients,
and ``train_step``, on the same weights (the reference's initialiser,
carried across by ``params_from_jax``) and the same numpy-seeded inputs.

The positions are those of Qwen2-VL's M-RoPE (arXiv:2409.12191 §2.1):
patch i of a g x g grid takes (t, h, w) = (0, i // g, i % g), and the text
token j after them g + j in all three components. The reference's own
``smoke_batch`` stacks one ``arange`` three times, which makes M-RoPE
equal plain RoPE and would hide a wrong section split; these tests give
distinct ids. Tolerances as in ``test_torch_lm.py``: 1e-4 of the
largest magnitude at model level, 1e-5 at layer level.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import model_api as rapi
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init
from repro.train import steps as rsteps
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm, model_api
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step,
                                     train_state_from_params, tree_leaves)

ARCH = "qwen2-vl-7b-smoke"
B, S = 2, 32


def _close(got, want, what, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def mrope_positions(batch, seq, n_patches, start=0):
    """(3, batch, seq) int32 M-RoPE ids: the first ``n_patches`` tokens on
    a square grid (temporal 0), the rest text continuing from the grid's
    side; ``start`` shifts the text (a decode step's position)."""
    g = int(round(n_patches ** 0.5))
    assert g * g == n_patches
    i = np.arange(n_patches)
    vision = np.stack([np.zeros_like(i), i // g, i % g])
    text = np.broadcast_to(g + start + np.arange(seq - n_patches), (3, seq -
                                                                    n_patches))
    pos = np.concatenate([vision, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, seq)))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's seeded weights as a numpy tree, the qkv biases
    (zero at init) drawn so that they count."""
    tree = jax.tree.map(np.asarray, rapi.init(ref_get_config(ARCH),
                                              jax.random.PRNGKey(0)))
    rng = np.random.RandomState(7)
    for n in ("bq", "bk", "bv"):
        b = tree["blocks"][n]
        tree["blocks"][n] = rng.standard_normal(b.shape).astype(
            np.float32) * 0.5
    return tree


def _both(impl, **overrides):
    jcfg = dataclasses.replace(ref_get_config(ARCH), attention_impl=impl,
                               **overrides)
    cfg = dataclasses.replace(get_config(ARCH), attention_impl=impl,
                              **overrides)
    tree = _weights()
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(
        tree, cfg, "cpu")


def _inputs(cfg, seed, train=False):
    rng = np.random.RandomState(seed)
    n = cfg.num_patches
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "patch_embeds": rng.standard_normal(
                 (B, n, cfg.d_model)).astype(np.float32),
             "positions": mrope_positions(B, S, n)}
    if train:
        batch["labels"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        batch["labels"][0, :5] = -1
    return batch


# ---------------------------------------------------------------- M-RoPE ---
@pytest.mark.parametrize("sections", [(2, 3, 3), (3, 2, 3)])
def test_apply_mrope_matches_reference_with_distinct_ids(sections):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    pos = rng.randint(0, 4096, (3, B, S)).astype(np.int32)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    # angles of up to 4,096 rad: float32 sin/cos of two libraries
    _close(got, want, f"mrope {sections}", 2e-4)


def test_mrope_sections_are_live():
    """With distinct (t, h, w) ids the section split matters: (2, 3, 3)
    and (3, 2, 3) rotate slots 2 by other components and differ, in both
    packages alike; with one id three times M-RoPE is plain RoPE."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.standard_normal((B, S, 4, 16)).astype(
        np.float32))
    pos = torch.from_numpy(mrope_positions(B, S, 16))
    a = L.apply_mrope(x, pos, 1e4, (2, 3, 3))
    b = L.apply_mrope(x, pos, 1e4, (3, 2, 3))
    assert float((a - b).abs().max()) > 1e-2
    ref_b = RL.apply_mrope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()),
                           1e4, (3, 2, 3))
    _close(b, ref_b, "swapped sections", 1e-5)
    same = pos[:1].expand(3, B, S)
    _close(L.apply_mrope(x, same, 1e4, (2, 3, 3)),
           L.apply_rope(x, same[0], 1e4).numpy(), "one id thrice", 1e-6)
    with pytest.raises(ValueError, match="sum"):
        L.apply_mrope(x, pos, 1e4, (2, 2, 3))


# ------------------------------------------------------ prefill, decode ---
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(impl):
    """16 patch embeddings on a 4 x 4 grid then 16 text tokens: prefill
    logits and kv caches, then three greedy decode steps whose positions
    continue the text's, through the step factories on both sides."""
    jcfg, jp, cfg, p = _both(impl)
    batch = _inputs(cfg, 3)
    jl, jc = rsteps.make_prefill_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tl, tc = prefill(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, "prefill logits")
    for name in ("k", "v"):
        _close(getattr(tc, name), getattr(jc, name), f"prefill {name}")
    g = int(round(cfg.num_patches ** 0.5))
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert nxt[:, 0].tolist() == tl.argmax(-1).tolist(), step
        pos = np.full((3, B, 1), g + S - cfg.num_patches + step, np.int32)
        jl, jc = rsteps.make_decode_step(jcfg)(jp, {
            "tokens": jnp.asarray(nxt), "positions": jnp.asarray(pos),
            "cache": jc})
        tl, tc = decode(p, {"tokens": torch.from_numpy(nxt),
                            "positions": torch.from_numpy(pos), "cache": tc})
        _close(tl, jl, f"decode {step} logits")
        for name in ("k", "v"):
            _close(getattr(tc, name), getattr(jc, name),
                   f"decode {step} {name}")
        assert tc.length.tolist() == np.asarray(jc.length).tolist()


def test_patch_embeds_overwrite_the_first_rows():
    """The logits depend on the patch embeddings, and tokens under them
    do not matter; without positions M-RoPE raises, as the reference's
    ``batch["positions"]`` does, in prefill and in decode."""
    _, _, cfg, p = _both("xla")
    batch = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 4).items()}
    base, cache = lm.prefill(p, batch, cfg)
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, :cfg.num_patches] = 0
    assert torch.equal(lm.prefill(p, other, cfg)[0], base)
    moved = dict(batch, patch_embeds=batch["patch_embeds"] + 1.0)
    assert not torch.allclose(lm.prefill(p, moved, cfg)[0], base, atol=1e-3)
    with pytest.raises(ValueError, match="positions"):
        lm.prefill(p, {k: v for k, v in batch.items() if k != "positions"},
                   cfg)
    with pytest.raises(ValueError, match="positions"):
        lm.decode_step(p, {"tokens": batch["tokens"][:, :1]}, cache, cfg)


def test_smoke_batch_is_the_references_layout():
    cfg = get_config(ARCH)
    for kind in ("train", "prefill"):
        got = model_api.smoke_batch(cfg, kind, seed=5, device="cpu")
        want = rapi.smoke_batch(ref_get_config(ARCH), kind,
                                jax.random.PRNGKey(0))
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (kind, k)
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
        assert torch.equal(got["positions"][0], got["positions"][2])


# -------------------------------------------------------------- training ---
def test_forward_train_and_gradients_match_reference():
    """The loss and every gradient on the plain route (the kernel route's
    backward is the plain one's, ``kernels/ops.py``)."""
    jcfg, jp, cfg, p = _both("xla")
    batch = _inputs(cfg, 6, train=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda q: rlm.forward_train(q, jb, jcfg), has_aux=True)(jp)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    total, metrics = lm.forward_train(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    assert float(metrics["aux_loss"]) == 0.0
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


def test_train_step_matches_reference():
    """One AdamW step: the loss to 1e-5; the gradient norm and m to the
    gradients' tolerance (1e-4): the smoke attention's scores are nearly
    one-hot, and the gradients before it move by about 1e-4 of their
    largest value under a float32 rounding of q or k (ROADMAP 3b.1)."""
    jcfg, jp, cfg, p = _both("pallas")
    batch = _inputs(cfg, 8, train=True)
    opt = RefAdamWConfig(warmup_steps=2)
    tree = _weights()
    jstate = rsteps.TrainState(jp, adamw_init(tree), jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(rsteps.make_train_step(jcfg, None, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state_from_params(p, AdamWConfig(**dataclasses.asdict(opt)))
    state, tm = make_train_step(cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.opt["m"]))
    for i, (m, w) in enumerate(zip(state.opt.m, want)):
        np.testing.assert_allclose(m.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"m {i}")


def test_grad_accum_2_raises_in_both_packages():
    """Both packages split every batch leaf along axis 0; for the (3, B,
    S) positions that is the M-RoPE component axis, and 3 does not split
    in two: the reference's reshape raises, and so does the port."""
    jcfg, jp, cfg, p = _both("xla", grad_accum=2)
    batch = _inputs(cfg, 9, train=True)
    tree = _weights()
    jstate = rsteps.TrainState(jp, adamw_init(tree), jnp.zeros((), jnp.int32))
    with pytest.raises(TypeError, match="reshape"):
        rsteps.make_train_step(jcfg)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state_from_params(p)
    with pytest.raises(ValueError, match="positions"):
        make_train_step(cfg)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
