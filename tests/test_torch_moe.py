"""The MoE block, port against reference on the CPU: ``layers.moe_block``
against ``repro.models.layers.moe_block`` (with the reference's null
sharder) on the same numpy-seeded inputs and weights, at the smoke
configs' 8 experts top-2 and at moonshot-v1-16b-a3b's 64 experts top-6
(narrow d_model and d_ff), in float32 and bf16; then the two routings
where the frameworks' top-k differ or the capacity bites: a router of
zeros (every prob ties) and a router that sends every token to one
expert (the overflow dropped).

Tolerances: float32 1e-6 of the output's largest magnitude (the same
products summed in other orders); bf16 1e-2, bf16's own scale (the
output is rounded to bf16 on both sides, as in
``test_torch_lm.py::test_ssd_decode_step_matches_reference``). The aux
loss is float32 on both sides: 1e-6 relative. Every case also holds the
gradient of a seeded projection of the output plus the aux loss, with
respect to x and to every weight, to 1e-5 of its largest magnitude in
float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models.params import NULL_SHARDER
from repro_torch.configs import get_config
from repro_torch.models import layers as L

ARCH = "moonshot-v1-16b-a3b-smoke"
# (experts, top-k, d_model, d_ff): the smoke configs' routing, and
# moonshot-v1-16b-a3b's 64 experts top-6 at narrow widths
SHAPES = {"e8_k2": (8, 2, 64, 64), "e64_k6": (64, 6, 64, 32)}
TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _cfgs(E, K, D, F):
    kw = dict(num_experts=E, experts_per_token=K, d_model=D, d_ff=F)
    return (dataclasses.replace(ref_get_config(ARCH), **kw),
            dataclasses.replace(get_config(ARCH), **kw))


def _inputs(E, K, D, F, B=2, S=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "wi_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wi_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wo": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _both(x, p, E, K, D, F, dtype):
    """(reference's out, aux; port's out, aux), out as float32 numpy."""
    jcfg, cfg = _cfgs(E, K, D, F)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, ja = RL.moe_block(jnp.asarray(x, jd), {k: jnp.asarray(v, jd) for k, v
                                              in p.items()}, jcfg,
                          NULL_SHARDER)
    ty, ta = L.moe_block(torch.from_numpy(x).to(td),
                         {k: torch.from_numpy(v).to(td) for k, v in
                          p.items()}, cfg)
    assert ty.dtype == td and ty.shape == x.shape and ta.dtype == torch.float32
    return (np.asarray(jy.astype(jnp.float32)), float(ja),
            ty.float().numpy(), float(ta))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_block_matches_reference(shape, dtype):
    E, K, D, F = SHAPES[shape]
    x, p = _inputs(E, K, D, F)
    jy, ja, ty, ta = _both(x, p, E, K, D, F, dtype)
    _close(ty, jy, TOL[dtype], "out")
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_block_gradients_match_reference(shape):
    """Gradients through the dispatch (gather, scatter into the buffer,
    gather back), the gates and the aux loss's softmax, float32."""
    E, K, D, F = SHAPES[shape]
    x, p = _inputs(E, K, D, F, seed=1)
    w = np.random.RandomState(2).standard_normal(x.shape).astype(np.float32)
    jcfg, cfg = _cfgs(E, K, D, F)

    def jloss(x, p):
        y, aux = RL.moe_block(x, p, jcfg, NULL_SHARDER)
        return jnp.sum(y * w) + 3.0 * aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = L.moe_block(tx, tp, cfg)
    (torch.sum(y * torch.from_numpy(w)) + 3.0 * aux).backward()
    _close(tx.grad.numpy(), np.asarray(jgx), 1e-5, "d x")
    for k in p:
        _close(tp[k].grad.numpy(), np.asarray(jgp[k]), 1e-5, f"d {k}")


def test_topk_ties_take_the_lowest_expert_as_the_reference():
    """A router of zeros: every prob is 1/E, so every top-k is a tie. The
    reference's ``lax.top_k`` picks experts 0..K-1; ``torch.topk`` picks
    others, so a port on it would route to other experts. The port's
    block equals the reference's (and the output differs from a block
    routed through experts K..2K-1, so the case can tell)."""
    E, K, D, F = SHAPES["e64_k6"]
    x, p = _inputs(E, K, D, F, seed=3)
    p["router"][:] = 0
    probs = np.full((4, E), 1.0 / E, np.float32)
    assert np.asarray(jax.lax.top_k(probs, K)[1]).tolist() == [
        list(range(K))] * 4
    assert torch.topk(torch.from_numpy(probs), K).indices.tolist() != [
        list(range(K))] * 4
    jy, ja, ty, ta = _both(x, p, E, K, D, F, "float32")
    _close(ty, jy, TOL["float32"], "out")
    assert ta == ja
    shifted = dict(p)
    for k in ("wi_gate", "wi_up", "wo"):
        shifted[k] = np.roll(p[k], -K, axis=0)      # experts K.. in front
    _, _, other, _ = _both(x, shifted, E, K, D, F, "float32")
    assert np.abs(other - jy).max() > 1e-2


def test_overflow_past_capacity_is_dropped_as_the_reference():
    """A router that sends every token first to expert 3 (then, on a tie
    among the rest, to expert 0): each expert takes C = ceil(K S 1.25 / E)
    = 20 of the 64 tokens of a sequence, in token order, and the other
    44 get nothing from either. Output and aux equal the reference's."""
    E, K, D, F = SHAPES["e8_k2"]
    x, p = _inputs(E, K, D, F, seed=4)
    x = np.abs(x)
    p["router"][:] = 0
    p["router"][:, 3] = 1.0
    C = int(np.ceil(K * x.shape[1] * 1.25 / E))
    jy, ja, ty, ta = _both(x, p, E, K, D, F, "float32")
    _close(ty, jy, TOL["float32"], "out")
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    # experts 3 and 0 each take every token (1/K of the slots); expert 3's
    # prob is 1 to float32, expert 0's e^-sum(x): aux = E (1/K) 1
    assert ta == pytest.approx(E / K, rel=1e-6)
    assert (np.abs(ty[:, :C]).max(axis=-1) > 0).all()
    assert not ty[:, C:].any()
