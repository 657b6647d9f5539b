"""The encoder-decoder (whisper), port against reference on the CPU: its
layers (``layer_norm``, ``gelu_mlp``, ``bidirectional_attention``), the
schema, ``prefill`` (logits, the cross-attention cache ``shared_k/v`` and
the self-attention cache) and decode steps, the decode clamp past
``DEC_LEN``, ``forward_train`` and its gradients, the step factories and
the model FLOPs, on the same weights (the reference's initialiser,
carried across by ``params_from_jax``) and the same numpy-seeded inputs.
Tolerance: 1e-4 of the largest magnitude at model level, 1e-5 at layer
level (float32 on both sides, summed in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShape
from repro.models import encdec as renc
from repro.models import layers as RL
from repro.models import model_api as rapi
from repro.roofline.model_flops import model_flops as ref_model_flops
from repro.train import steps as rsteps
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.serve import ServeConfig, Server
from repro_torch.models import encdec, model_api
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.roofline import model_flops
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     tree_leaves, tree_unflatten)

ARCH = "whisper-small-smoke"
B, S_ENC = 2, 64
# The gradients' tolerance, 5e-3 of the leaf's largest magnitude, not 1e-4:
# the reference's law draws a stacked block weight with std 1/sqrt(layers)
# (0.71 at depth 2, d_model 64), so the smoke attention is nearly one-hot
# and the gradients are ill-conditioned. Measured against the port run in
# float64 throughout: the port's float32 gradients lie within 6.7e-4 of
# their maximum, the reference's within 2.2e-3; a relative 1e-7 of noise
# on the attention's q alone moves them by 8.8e-4. Every forward value
# (logits, caches, the loss) is held to 1e-4 / 1e-5.
GRAD_TOL = 5e-3


def _close(got, want, what, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's seeded weights as a numpy tree; the biases and the
    layer-norm shifts (zero at init) drawn so that they count."""
    tree = jax.tree.map(np.asarray, rapi.init(ref_get_config(ARCH),
                                              jax.random.PRNGKey(0)))
    rng = np.random.RandomState(7)

    def draw(t, name=""):
        if isinstance(t, dict):
            return {k: draw(v, k) for k, v in t.items()}
        if name.startswith("b") or name.endswith("_b"):
            return rng.standard_normal(t.shape).astype(np.float32) * 0.3
        return t
    return draw(tree)


def _both(**overrides):
    jcfg = dataclasses.replace(ref_get_config(ARCH), **overrides)
    cfg = dataclasses.replace(get_config(ARCH), **overrides)
    tree = _weights()
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(
        tree, cfg, "cpu")


def _frames(cfg, seed):
    return np.random.RandomState(seed).standard_normal(
        (B, S_ENC, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- layers ---
def test_layer_norm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 30 + 7
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    _close(L.layer_norm(_t(x), _t(w), _t(b), 1e-5), want, "layer_norm", 1e-5)
    got = L.layer_norm(_t(x).bfloat16(), _t(w).bfloat16(), _t(b).bfloat16(),
                       1e-5)
    want_b = RL.layer_norm(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                           1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want_b.astype(jnp.float32)))


def test_gelu_mlp_matches_reference():
    """The tanh GELU (``jax.nn.gelu``'s default) between two biased
    products; the exact erf GELU would not pass."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32) * 3
    wi, wo = (rng.standard_normal(s).astype(np.float32) / 8
              for s in ((64, 128), (128, 64)))
    bi, bo = rng.standard_normal(128), rng.standard_normal(64)
    args = [x, wi, bi.astype(np.float32), wo, bo.astype(np.float32)]
    want = RL.gelu_mlp(*(jnp.asarray(a) for a in args))
    got = L.gelu_mlp(*(_t(a) for a in args))
    _close(got, want, "gelu_mlp", 1e-5)
    h = _t(x) @ _t(wi) + _t(args[2])
    exact = torch.nn.functional.gelu(h) @ _t(wo) + _t(args[4])
    with pytest.raises(AssertionError):
        _close(exact, want, "erf gelu", 1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_bidirectional_attention_matches_reference(hq, hkv):
    rng = np.random.RandomState(2)
    q = rng.standard_normal((2, 9, hq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 30, hkv, 16)).astype(np.float32)
            for _ in range(2))
    want = RL.bidirectional_attention(*(jnp.asarray(a) for a in (q, k, v)))
    _close(L.bidirectional_attention(_t(q), _t(k), _t(v)), want,
           "bidirectional", 1e-5)


@pytest.mark.parametrize("arch", ["whisper-small", "whisper-small-smoke"])
def test_schema_matches_reference(arch):
    got = {k: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
           for k, s in _flat(model_api.schema(get_config(arch))).items()}
    want = {k: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
            for k, s in _flat(rapi.schema(ref_get_config(arch))).items()}
    assert got == want
    assert "bk" not in model_api.schema(get_config(arch))["enc_blocks"]["attn"]


def test_params_carry_across_and_init_draws_the_tree():
    cfg = get_config(ARCH)
    p = params_from_jax(_weights(), cfg, "cpu")
    assert sorted(p) == ["dec_blocks", "dec_final", "embed", "enc_blocks",
                         "enc_final", "pos_embed"]
    for name, t in _flat(p).items():
        np.testing.assert_array_equal(t.numpy(), _flat(_weights())[name])
    drawn = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(t.shape) for k, t in _flat(drawn).items()} == {
        k: tuple(t.shape) for k, t in _flat(p).items()}


# ------------------------------------------------------ prefill, decode ---
def _run_both(jcfg, jp, cfg, p, frames, n_decode):
    bos = np.full((B, 1), 3, np.int32)
    jl, jc = rsteps.make_prefill_step(jcfg)(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(bos)})
    tl, tc = make_prefill_step(cfg)(
        p, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(bos)})
    _close(tl, jl, "prefill logits")
    for name in ("k", "v", "shared_k", "shared_v"):
        assert tuple(getattr(tc, name).shape) == getattr(jc, name).shape
        _close(getattr(tc, name), getattr(jc, name), f"prefill {name}")
    assert tc.ssm is None and jc.ssm is None
    decode = make_decode_step(cfg)
    for step in range(n_decode):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert nxt[:, 0].tolist() == tl.argmax(-1).tolist(), step
        jl, jc = rsteps.make_decode_step(jcfg)(
            jp, {"tokens": jnp.asarray(nxt), "cache": jc})
        tl, tc = decode(p, {"tokens": torch.from_numpy(nxt), "cache": tc})
        _close(tl, jl, f"decode {step} logits")
        for name in ("k", "v"):
            _close(getattr(tc, name), getattr(jc, name), f"decode {step} {name}")
        assert tc.length.tolist() == np.asarray(jc.length).tolist()
    return tl, tc


def test_prefill_and_decode_match_reference():
    """64 stub frames encoded, the BOS prompt decoded (prefill), then
    three greedy decode steps."""
    jcfg, jp, cfg, p = _both()
    _run_both(jcfg, jp, cfg, p, _frames(cfg, 3), 3)


def test_decode_past_dec_len_is_clamped_as_the_reference(monkeypatch):
    """With DEC_LEN cut to 4 in both packages, 6 decode steps: from the
    4th token on each step writes the last cache slot and adds the last
    position embedding, while the length keeps counting."""
    monkeypatch.setattr(renc, "DEC_LEN", 4)
    monkeypatch.setattr(encdec, "DEC_LEN", 4)
    jcfg, _, cfg, _ = _both()
    tree = jax.tree.map(np.asarray, rapi.init(jcfg, jax.random.PRNGKey(1)))
    assert tree["pos_embed"].shape == (4, cfg.d_model)
    _, tc = _run_both(jcfg, jax.tree.map(jnp.asarray, tree), cfg,
                      params_from_jax(tree, cfg, "cpu"), _frames(cfg, 4), 6)
    assert tc.k.shape[2] == 4 and tc.length.tolist() == [7, 7]


def test_decode_takes_one_token_and_server_refuses_encdec():
    _, _, cfg, p = _both()
    _, cache = encdec.prefill(p, {"frames": _t(_frames(cfg, 5)),
                                  "tokens": torch.zeros((B, 1), dtype=torch.int32)},
                              cfg)
    with pytest.raises(ValueError, match="one token"):
        encdec.decode_step(p, {"tokens": torch.zeros((B, 2), dtype=torch.int32)},
                           cache, cfg)
    with pytest.raises(ValueError, match="make_prefill_step"):
        Server(cfg, ServeConfig(), p, device="cpu")
    with pytest.raises(ValueError, match="make_prefill_step"):
        Server(get_config("qwen2-vl-7b-smoke"), ServeConfig(), p, device="cpu")


# -------------------------------------------------------------- training ---
def test_forward_train_and_gradients_match_reference():
    """The encoder over 64 frames and the decoder over 16 tokens with
    their labels (five masked): the loss and every gradient under remat
    "full", against the reference's; under "dots" the port's are
    bitwise "full"'s."""
    jcfg, jp, cfg, p = _both()
    rng = np.random.RandomState(6)
    batch = {"frames": _frames(cfg, 6),
             "tokens": rng.randint(0, cfg.vocab_size, (B, 16)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (B, 16)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    (jl, jm), jg = jax.value_and_grad(
        lambda q: renc.forward_train(q, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, jcfg),
        has_aux=True)(jp)
    runs = {}
    for remat in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=remat)
        leaves = tree_leaves(params_from_jax(_weights(), c, "cpu"))
        for t in leaves:
            t.requires_grad_(True)
        total, metrics = encdec.forward_train(
            tree_unflatten(p, leaves),
            {k: torch.from_numpy(v) for k, v in batch.items()}, c)
        runs[remat] = (total.detach(), torch.autograd.grad(total, leaves))
    total, grads = runs["full"]
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    assert float(metrics["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    want = _flat(jax.tree.map(np.asarray, jg))
    assert len(want) == len(grads)
    for (name, w), g in zip(sorted(want.items()), grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(np.abs(w).max()),
                                   err_msg=name)
    assert torch.equal(runs["dots"][0], total)
    for g, d in zip(grads, runs["dots"][1]):
        assert torch.equal(g, d)


def test_smoke_batch_is_the_references_layout():
    cfg = get_config(ARCH)
    for kind in ("train", "prefill"):
        got = model_api.smoke_batch(cfg, kind, seed=1, device="cpu")
        want = rapi.smoke_batch(ref_get_config(ARCH), kind,
                                jax.random.PRNGKey(0))
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (kind, k)
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
    assert model_api.get_module(cfg) is encdec


@pytest.mark.parametrize("kind,S,Bn", [("train", 1500, 8), ("prefill", 1500, 8),
                                       ("decode", 1, 64), ("train", 128, 2)])
def test_model_flops_match_reference(kind, S, Bn):
    for arch in ("whisper-small", "whisper-small-smoke"):
        assert model_flops(get_config(arch), ShapeConfig(
            kind, S, Bn, kind)) == ref_model_flops(
                ref_get_config(arch), RefShape(kind, S, Bn, kind))
