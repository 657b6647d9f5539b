"""The "tri" attention route and the "dots" remat policy, port against
reference on the CPU.

``causal_attention_tri`` splits the causal triangle into two half
triangles and an unmasked block, recursively, and merges the blocks'
statistics by log-sum-exp; it is held to the reference's and to the
port's masked-dense ``causal_attention_ref`` in float32 within 1e-5.
``remat_policy="dots"`` saves the layer bodies' weight products
(``dots_with_no_batch_dims_saveable``): its gradients equal "full"'s
bitwise (the recompute repeats the forward's arithmetic) and the
reference's "dots" to the model-level tolerance (1e-4 of the leaf's
largest magnitude), and a count of the aten products run in backward
shows what each policy recomputes.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import model_api as rapi
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.train.steps import tree_leaves


def _close(got, want, what, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    return jax.tree.map(np.asarray, rapi.init(ref_get_config(arch),
                                              jax.random.PRNGKey(0)))


def _both(arch, **overrides):
    jcfg = dataclasses.replace(ref_get_config(arch), **overrides)
    cfg = dataclasses.replace(get_config(arch), **overrides)
    tree = _weights(arch)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(
        tree, cfg, "cpu")


def _batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": tokens, "labels": labels}


def _port_grads(cfg, p, batch):
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    total, _ = lm.forward_train(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    return total.detach(), torch.autograd.grad(total, leaves)


# ------------------------------------------------------------------ tri ---
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("S,leaf", [(64, 16), (1024, 256)])
def test_causal_attention_tri_matches_reference(S, leaf, depth):
    """GQA (4 query heads over 2 kv heads), float32: against the
    reference's tri and against the port's masked-dense route."""
    rng = np.random.RandomState(S + depth)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = RL.causal_attention_tri(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), depth=depth,
                                   leaf_chunk=leaf)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = L.causal_attention_tri(tq, tk, tv, depth=depth, leaf_chunk=leaf)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got, want, "tri vs reference", 1e-5)
    _close(got, L.causal_attention_ref(tq, tk, tv).numpy(), "tri vs dense",
           1e-5)


def test_tri_route_prefill_decode_and_training_match_reference():
    """minitron-smoke with ``attention_impl="tri"``: prefill logits and
    caches, one decode step, the loss and every gradient."""
    jcfg, jp, cfg, p = _both("minitron-8b-smoke", attention_impl="tri")
    tokens = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jc = rlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    tl, tc = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg)
    _close(tl, jl, "prefill logits")
    _close(tc.k, jc.k, "k cache")
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl, _ = rlm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, jcfg)
    tl, _ = lm.decode_step(p, {"tokens": torch.from_numpy(nxt)}, tc, cfg)
    _close(tl, jl, "decode logits")
    batch = _batch(cfg, 2, 64, 1)
    (jloss, _), jg = jax.value_and_grad(
        lambda q: rlm.forward_train(
            q, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jp)
    total, grads = _port_grads(cfg, p, batch)
    np.testing.assert_allclose(float(total), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        _close(g, w, "tri gradient")


# ----------------------------------------------------------------- dots ---
def test_dots_gradients_equal_full_and_the_references_dots():
    arch = "minitron-8b-smoke"
    jcfg, jp, cfg, p = _both(arch, remat_policy="dots")
    batch = _batch(cfg, 2, 64, 2)
    (jloss, _), jg = jax.value_and_grad(
        lambda q: rlm.forward_train(
            q, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jp)
    total, grads = _port_grads(cfg, p, batch)
    np.testing.assert_allclose(float(total), float(jloss), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        _close(g, w, "dots gradient vs the reference's")
    full = dataclasses.replace(cfg, remat_policy="full")
    f_total, f_grads = _port_grads(full, params_from_jax(
        _weights(arch), full, "cpu"), batch)
    assert torch.equal(total, f_total)
    for g, f in zip(grads, f_grads):
        assert torch.equal(g, f)


class _Products(TorchDispatchMode):
    """Counts the products dispatched: ``aten.mm`` (weight products,
    ``layers.dense``) and ``aten.bmm`` (batched: attention, SSD)."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(cfg, p, batch):
    """(products of the forward, products run in backward). The recompute
    runs each layer body to its end (``set_checkpoint_early_stop(False)``;
    by default it stops after the last tensor backward needs, short of
    the body's last weight products)."""
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    with set_checkpoint_early_stop(False):
        with _Products() as fwd:
            total, _ = lm.forward_train(
                p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
        with _Products() as bwd:
            torch.autograd.grad(total, leaves)
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch", ["minitron-8b-smoke", "zamba2-2.7b-smoke"])
def test_dots_recomputes_no_weight_product(arch):
    """Backward's products under "none" are the gradients' alone. "full"
    adds a recompute of every product of the layer bodies: all the
    forward's weight products (every ``aten.mm`` of the forward lies in a
    layer body) and its batched products but the unembedding's. "dots"
    adds the batched products only: no weight product is recomputed."""
    _, _, cfg, _ = _both(arch)
    batch = _batch(cfg, 2, 32, 3)
    run = {}
    for policy in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        run[policy] = _backward_products(
            c, params_from_jax(_weights(arch), c, "cpu"), batch)
    fwd, none = run["none"]
    assert fwd["mm"] > 0 and fwd["bmm"] > 1
    layer_bmm = fwd["bmm"] - 1                        # the unembedding's
    for policy, (f, _) in run.items():
        assert f == fwd, policy                        # the same forward
    assert run["dots"][1] == {"mm": none["mm"],
                              "bmm": none["bmm"] + layer_bmm}
    assert run["full"][1] == {"mm": none["mm"] + fwd["mm"],
                              "bmm": none["bmm"] + layer_bmm}
