"""The port's PCC models against the reference's, from the same numbers:
reference parameters carried by ``params_from_jax``, inputs made with
numpy from a seed and fed to both packages.

Tolerances: float32 throughout; the two frameworks sum matrix products
and reductions in different orders, so forward passes, decode and losses
agree to rtol 1e-5 (plus atol 1e-6 on the GNN's outputs, some of which
cross zero after a four-layer chain of O(1) values). Three optimizer
steps compound that through AdamW's normalised updates: rtol 1e-4, with
atol 1e-7 for parameters that are still near zero (biases start at 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import make_loss as ref_make_loss
from repro.core.models.gnn import GNNConfig as RefGNNConfig
from repro.core.models.gnn import gnn_apply as ref_gnn_apply
from repro.core.models.gnn import make_gnn as ref_make_gnn
from repro.core.models.nn import NNConfig as RefNNConfig
from repro.core.models.nn import fit_model as ref_fit_model
from repro.core.models.nn import make_nn as ref_make_nn
from repro.core.models.nn import mlp_apply as ref_mlp_apply
from repro.core.pcc import PCCScaler as RefScaler
from repro_torch.core.losses import make_loss
from repro_torch.core.models import GNN, GNNConfig, MLP, NNConfig, fit_model
from repro_torch.core.models.convert import params_from_jax, scaler_from_jax

N_IN, N_NODES, P_OP = 11, 9, 7


def _np_params(params):
    return jax.tree.map(np.asarray, params)


def _graphs(rng, B):
    feats = rng.randn(B, N_NODES, P_OP).astype(np.float32)
    n = rng.randint(1, N_NODES + 1, size=B)
    mask = (np.arange(N_NODES)[None, :] < n[:, None]).astype(np.float32)
    A = (rng.rand(B, N_NODES, N_NODES) < 0.3).astype(np.float32)
    A = np.maximum(A, A.transpose(0, 2, 1)) + np.eye(N_NODES)[None]
    A = A * mask[:, :, None] * mask[:, None, :]
    deg = A.sum(-1)
    dinv = np.where(deg > 0, 1 / np.sqrt(np.maximum(deg, 1e-9)), 0)
    adj = (A * dinv[:, :, None] * dinv[:, None, :]).astype(np.float32)
    return {"features": feats * mask[..., None], "adj": adj, "mask": mask}


def _targets(rng, B):
    a = -rng.uniform(0.05, 1.5, size=B)
    b = np.exp(rng.uniform(2, 9, size=B))
    scaler = RefScaler.fit(a, b)
    alloc = rng.randint(10, 3000, size=B).astype(np.float32)
    extras = {"target_z": scaler.encode(a, b), "observed_alloc": alloc,
              "observed_runtime": (b * alloc ** a * rng.uniform(
                  0.7, 1.4, size=B)).astype(np.float32),
              "xgb_runtime": (b * alloc ** a).astype(np.float32)}
    return scaler, extras


def _to_torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _nn_pair(seed):
    params, _ = ref_make_nn(N_IN, RefNNConfig(hidden=(32, 16), seed=seed))
    module = MLP(N_IN, (32, 16))
    module.load_state_dict(params_from_jax("nn", _np_params(params)))
    return params, module


def _gnn_pair(seed):
    params, _ = ref_make_gnn(P_OP, RefGNNConfig(seed=seed))
    module = GNN(P_OP, GNNConfig())
    module.load_state_dict(params_from_jax("gnn", _np_params(params)))
    return params, module


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_forward_matches_reference(seed):
    params, module = _nn_pair(seed)
    x = np.random.RandomState(seed).randn(64, N_IN).astype(np.float32)
    want = ref_mlp_apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_gnn_forward_matches_reference(seed):
    params, module = _gnn_pair(seed)
    g = _graphs(np.random.RandomState(seed), 32)
    want = ref_gnn_apply(params, {k: jnp.asarray(v) for k, v in g.items()})
    with torch.no_grad():
        got = module(_to_torch(g))
    _close(got, want, atol=1e-6)


def test_scaler_decode_matches_reference():
    rng = np.random.RandomState(3)
    scaler, _ = _targets(rng, 50)
    # include |z| far out, where softplus must not become the identity
    z = np.concatenate([rng.randn(200, 2) * 2, rng.randn(20, 2) * 40]
                       ).astype(np.float32)
    ra, rb = scaler.decode(jnp.asarray(z))
    a, b = scaler_from_jax(scaler).decode(torch.from_numpy(z))
    _close(a, ra)
    _close(b, rb)
    assert torch.all(a < 0) and torch.all(b > 0)


@pytest.mark.parametrize("kind", ["lf1", "lf2", "lf3"])
def test_losses_match_reference(kind):
    rng = np.random.RandomState(4)
    scaler, extras = _targets(rng, 128)
    pred = (scaler.encode(-rng.uniform(0.05, 1.5, 128),
                          np.exp(rng.uniform(2, 9, 128)))
            + rng.randn(128, 2).astype(np.float32) * 0.3)
    want, want_m = ref_make_loss(kind, scaler)(
        jnp.asarray(pred), {k: jnp.asarray(v) for k, v in extras.items()})
    got, got_m = make_loss(kind, scaler_from_jax(scaler))(
        torch.from_numpy(pred), _to_torch(extras))
    _close(got, want)
    assert set(got_m) == set(want_m)
    for k in want_m:
        _close(got_m[k], want_m[k])


@pytest.mark.parametrize("family,kind", [("nn", "lf2"), ("nn", "lf3"),
                                         ("gnn", "lf2")])
def test_three_fit_steps_match_reference(family, kind):
    rng = np.random.RandomState(5)
    n, bs = 96, 32                      # nb = 3 steps in one epoch
    scaler, extras = _targets(rng, n)
    if family == "nn":
        params, module = _nn_pair(0)
        inputs = {"features": rng.randn(n, N_IN).astype(np.float32)}
        ref_apply = lambda p, mi: ref_mlp_apply(p, mi["features"])
        port_apply = lambda m, mi: m(mi["features"])
    else:
        params, module = _gnn_pair(0)
        inputs = _graphs(rng, n)
        ref_apply = ref_gnn_apply
        port_apply = lambda m, mi: m(mi)
    cfg = dict(lr=3e-3, epochs=1, batch_size=bs, loss=kind, seed=11)
    ref_params, ref_hist = ref_fit_model(ref_apply, params, inputs, extras,
                                         scaler, RefNNConfig(**cfg))
    hist = fit_model(port_apply, module, inputs, extras,
                     scaler_from_jax(scaler), NNConfig(**cfg))
    _close(hist["loss"], ref_hist["loss"], rtol=1e-5)
    want = params_from_jax(family, _np_params(ref_params))
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("kind", ["lf2", "lf3"])
def test_loss_gradient_finite_where_reference_b_overflows(kind):
    """A prediction whose b = exp(zb * sd_b + mu_b) overflows float32: the
    reference's gradient is NaN (0 * inf behind the error clip), the port's
    is finite and its loss value is the reference's."""
    rng = np.random.RandomState(6)
    scaler, extras = _targets(rng, 16)
    pred = scaler.encode(-rng.uniform(0.1, 1.0, 16),
                         np.exp(rng.uniform(2, 9, 16)))
    pred[3, 1] = (100.0 - scaler.mu_b) / scaler.sd_b     # exp(100) = inf
    ref_fn = ref_make_loss(kind, scaler)
    ref_extras = {k: jnp.asarray(v) for k, v in extras.items()}
    ref_val = ref_fn(jnp.asarray(pred), ref_extras)[0]
    ref_grad = jax.grad(lambda z: ref_fn(z, ref_extras)[0])(jnp.asarray(pred))
    assert not np.all(np.isfinite(np.asarray(ref_grad)))
    z = torch.from_numpy(pred).requires_grad_(True)
    val, _ = make_loss(kind, scaler_from_jax(scaler))(z, _to_torch(extras))
    val.backward()
    assert torch.all(torch.isfinite(z.grad))
    _close(val.detach(), ref_val)
