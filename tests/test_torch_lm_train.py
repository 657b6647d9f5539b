"""The LM training path, port against reference on the CPU: the Mamba-2
and hybrid blocks, ``forward_train`` and its gradients, one ``train_step``
(with and without gradient accumulation), ``run_training``'s logged
losses, the optimizer, the token pipeline and the model FLOPs, on the same
weights (the reference's initialiser, carried across by
``params_from_jax``) and the same numpy-seeded batches.

Tolerances. Losses: 1e-5 relative (float32 on both sides, summed in other
orders by XLA and by PyTorch's CPU kernels). Gradients, element by
element: rtol 1e-4 and atol 1e-4 of the leaf's largest magnitude (the
model-level tolerance of ``test_torch_lm.py``). The gradients of the
embedding and of the norm weights are sums over every position, which the
two frameworks take in other orders: they differ by up to 7.4e-5 of the
leaf's largest value (minitron-smoke's embedding), so an absolute 1e-5
fails a few elements of values near 1 while every other leaf agrees to
2e-5 of its maximum. After an AdamW step the parameters agree only to
2·lr: at step 1 the update is lr·g/(|g| + eps), so where a gradient is
near zero a rounding difference in g flips the sign of a whole step of
size lr; the optimizer's m and v, which carry g itself, are held to the
gradients' tolerance instead (v, quadratic in g, to twice it).
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
from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefPipeline
from repro.launch import train as rtrain
from repro.models import lm as rlm
from repro.models import model_api as rapi
from repro.models.params import NULL_SHARDER
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init, adamw_update
from repro.roofline.model_flops import model_flops as ref_model_flops
from repro.train import steps as rsteps
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as ptrain
from repro_torch.models import lm, model_api
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.roofline import model_flops
from repro_torch.train.steps import (make_train_step, train_state_from_params,
                                     tree_leaves)

TRAIN_ARCHS = ["zamba2-2.7b-smoke", "mamba2-1.3b-smoke", "minitron-8b-smoke",
               "moonshot-v1-16b-a3b-smoke", "qwen3-moe-235b-a22b-smoke"]
# The gradient tolerance of the MoE smoke configs, 1e-3 of the leaf's
# largest magnitude, not 1e-4: their attention (d_model 64 over heads of
# 16, weights of std 1/sqrt(2)) gives nearly one-hot scores whose float32
# softmax backward rounds the leaves before it (wq, wk, ln1, the
# embedding) to up to 5.2e-4 of their maximum in the port and 1.6e-4 in
# the reference, both measured against the port run in float64; every
# leaf after the attention agrees to 1e-4. The MoE block's own gradients
# agree to 1e-5 (``test_torch_moe.py``).
GRAD_TOL = {"moonshot-v1-16b-a3b-smoke": 1e-3,
            "qwen3-moe-235b-a22b-smoke": 1e-3}


def _cfgs(arch, impl, **overrides):
    kw = dict(attention_impl=impl, ssd_impl=impl, **overrides)
    return (dataclasses.replace(ref_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's seeded weights as a numpy tree."""
    return jax.tree.map(np.asarray, rapi.init(ref_get_config(arch),
                                              jax.random.PRNGKey(0)))


def _batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1                              # masked positions
    return {"tokens": tokens, "labels": labels}


def _flat(tree):
    """{path: numpy array} of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in sorted(tree)
                for p, v in _flat(tree[k]).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().numpy()
    return {"": np.asarray(tree, np.float32)}


def _port_grads(cfg, tree, batch):
    p = params_from_jax(tree, cfg, "cpu")
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    total, metrics = lm.forward_train(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(total, leaves)
    for t, g in zip(leaves, grads):
        t.grad = g
    return float(total.detach()), metrics, _flat(
        _map(p, lambda t: t.grad))


def _grad_close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------- forward_train ---
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_and_gradients_match_reference(arch, impl):
    """zamba2 (hybrid: Mamba-2 + shared attention every 2nd layer), mamba2
    (ssm), minitron (dense), moonshot and qwen3-moe (MoE: the total adds
    0.01 x the layers' load-balance losses) smoke configs; "pallas" sends
    the SSD scan and attention through the kernel wrappers (their plain
    versions on the CPU; the reference's Pallas kernels in interpret
    mode)."""
    jcfg, cfg = _cfgs(arch, impl)
    tree = _weights(arch)
    batch = _batch(cfg, 2, 64, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: rlm.forward_train(p, jb, jcfg), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    tl, tm, tg = _port_grads(cfg, tree, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    if cfg.family == "moe":
        assert float(tm["aux_loss"]) > 0
        np.testing.assert_allclose(float(tm["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=1e-5)
    else:
        assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    want = _flat(jg)
    assert sorted(tg) == sorted(want)
    for name in want:
        _grad_close(tg[name], want[name], GRAD_TOL.get(arch, 1e-4), name)


def test_full_width_zamba2_blocks_match_reference():
    """One Mamba-2 layer and the shared attention block of zamba2-2.7b at
    its published widths (d_model 2,560, 80 SSD heads of 64, state 64,
    32 heads of 80 over 32 kv heads, d_ff 10,240), B 1, S 128, float32,
    through the plain and the kernel routes; numpy weights of std
    1/sqrt(fan-in)."""
    jcfg0, cfg0 = _cfgs("zamba2-2.7b", "xla", param_dtype="float32",
                        compute_dtype="float32")
    d, di = cfg0.d_model, cfg0.d_model * cfg0.ssm_expand
    h, n, f = di // cfg0.ssm_head_dim, cfg0.ssm_state, cfg0.d_ff
    assert (d, h, cfg0.ssm_head_dim, n, cfg0.num_heads, cfg0.num_kv_heads,
            cfg0.resolved_head_dim, f) == (2560, 80, 64, 64, 32, 32, 80,
                                           10240)
    rng = np.random.RandomState(21)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    ssd_p = {"ln1": 1 + 0.1 * w(d), "wz": w(d, di), "wx": w(d, di),
             "wB": w(d, n), "wC": w(d, n), "wdt": w(d, h),
             "A_log": 0.5 * w(h), "dt_bias": w(h), "D_skip": 1 + w(h),
             "norm_w": 1 + 0.1 * w(di), "out": w(di, d)}
    attn_p = {"ln1": 1 + 0.1 * w(d), "ln2": 1 + 0.1 * w(d),
              "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
              "ffn": {"wi_gate": w(d, f), "wi_up": w(d, f), "wo": w(f, d)}}
    x = rng.standard_normal((1, 128, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (1, 128))
    jt = lambda t: _map(t, jnp.asarray)
    tt = lambda t: _map(t, lambda a: torch.from_numpy(np.array(a)))
    for impl in ("xla", "pallas"):
        jcfg, cfg = _cfgs("zamba2-2.7b", impl, param_dtype="float32",
                          compute_dtype="float32")
        want, _ = rlm._ssd_block(jnp.asarray(x), jt(ssd_p), jcfg,
                                 NULL_SHARDER, "train")
        got, state = lm._ssd_block(torch.from_numpy(x), tt(ssd_p), cfg)
        assert state is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"ssd block {impl}")
        want, _, _ = rlm._transformer_block(jnp.asarray(x), jt(attn_p), jcfg,
                                            NULL_SHARDER, jnp.asarray(pos),
                                            "train")
        got, kv, aux = lm._transformer_block(torch.from_numpy(x), tt(attn_p),
                                             cfg, torch.from_numpy(pos),
                                             "train")
        assert kv is None and aux is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"shared attention {impl}")


# ------------------------------------------------------------ train step ---
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    """One AdamW step on zamba2-smoke, batch 4 (two microbatches of 2 with
    ``grad_accum=2``): loss, grad norm, lr, m and v to the gradients'
    tolerance; parameters to 2·lr (see the module docstring)."""
    arch = "zamba2-2.7b-smoke"
    jcfg, cfg = _cfgs(arch, "pallas", grad_accum=grad_accum)
    opt = RefAdamWConfig(warmup_steps=2)
    tree = _weights(arch)
    batch = _batch(cfg, 4, 32, 2)
    jstate = rsteps.TrainState(jax.tree.map(jnp.asarray, tree),
                               adamw_init(tree), jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(rsteps.make_train_step(jcfg, None, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state_from_params(params_from_jax(tree, cfg, "cpu"),
                                    AdamWConfig(**dataclasses.asdict(opt)))
    step = make_train_step(cfg)
    state, tm = step(state, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert state.step == int(jstate.step) == 1
    assert state.opt.count == int(jstate.opt["count"]) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    names = sorted(_flat(tree))
    for what, got, want, tol in (("m", state.opt.m, jstate.opt["m"], 1e-4),
                                 ("v", state.opt.v, jstate.opt["v"], 2e-4)):
        want = _flat(jax.tree.map(np.asarray, want))
        for name, g in zip(names, got):
            _grad_close(g.numpy(), want[name], tol, f"{what} {name}")
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    for name, p in zip(names, tree_leaves(state.params)):
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=2 * tm["lr"], rtol=1e-6,
                                   err_msg=f"params {name}")


def test_grad_accum_takes_the_mean_of_microbatch_gradients():
    """Two microbatches of 2 give (g1 + g2) / 2 in float32, and the metrics
    of the last microbatch, as the reference's scan does."""
    arch = "mamba2-1.3b-smoke"
    _, cfg = _cfgs(arch, "xla")
    tree = _weights(arch)
    batch = _batch(cfg, 4, 32, 3)
    halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    grads = [_port_grads(cfg, tree, hb) for hb in halves]
    mean = {k: (grads[0][2][k] + grads[1][2][k]) / 2 for k in grads[0][2]}
    acc_cfg = dataclasses.replace(cfg, grad_accum=2)
    state = train_state_from_params(params_from_jax(tree, acc_cfg, "cpu"))
    seen = []
    real = state.opt.update

    def spy(grads):
        seen.extend(g.clone() for g in grads)
        return real(grads)

    state.opt.update = spy
    _, metrics = make_train_step(acc_cfg)(state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    for name, g in zip(sorted(mean), seen):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), mean[name], atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(grads[1][1]["loss"]), rtol=1e-6)


@pytest.mark.parametrize("arch", ["zamba2-2.7b-smoke", "mamba2-1.3b-smoke"])
def test_run_training_losses_match_reference(arch, monkeypatch):
    """``run_training`` for 5 steps (seq 32, batch 4, the reference loop's
    AdamW with 20 warm-up steps, a loss logged every step), both packages
    starting from the reference's seeded weights: the logged losses agree
    step by step."""
    jcfg, cfg = _cfgs(arch, "pallas")
    loop = dict(steps=5, seq_len=32, global_batch=4, log_every=1, seed=0)
    tree = _weights(arch)
    monkeypatch.setattr(rtrain, "init_train_state", lambda c, rng: (
        rsteps.TrainState(jax.tree.map(jnp.asarray, tree), adamw_init(tree),
                          jnp.zeros((), jnp.int32))))
    monkeypatch.setattr(ptrain, "init_train_state", lambda c, g, d, o: (
        train_state_from_params(params_from_jax(tree, c, d), o)))
    logs = []
    want = rtrain.run_training(jcfg, rtrain.TrainLoopConfig(**loop),
                               log_fn=lambda s: None)
    got = ptrain.run_training(cfg, ptrain.TrainLoopConfig(**loop),
                              log_fn=logs.append, device="cpu")
    assert got["steps_run"] == want["steps_run"] == 5
    assert got["resumed_from"] == want["resumed_from"] == 0
    assert len(logs) == 5 and logs[-1].startswith("[train] step 5/5 loss")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["final_loss"] == got["losses"][-1]


@pytest.mark.parametrize("policy", ["full", "none"])
def test_remat_recomputes_each_layer_once_in_backward(policy, monkeypatch):
    """With ``remat_policy="full"`` every layer body runs twice a step (the
    forward, then the recompute in backward), so the SSD and attention
    wrappers are entered 2 x layers and 2 x applications times; with
    ``"none"`` once. On the card these are the kernels' launch counts."""
    calls = {"ssd": 0, "attn": 0}
    for cls, key in ((ops._SSDScan, "ssd"), (ops._FlashAttention, "attn")):
        real = cls.forward

        def counted(ctx, *a, _real=real, _key=key):
            calls[_key] += 1
            return _real(ctx, *a)

        monkeypatch.setattr(cls, "forward", staticmethod(counted))
    arch = "zamba2-2.7b-smoke"
    _, cfg = _cfgs(arch, "pallas", remat_policy=policy)
    tree = _weights(arch)
    state = train_state_from_params(params_from_jax(tree, cfg, "cpu"))
    make_train_step(cfg)(state, {k: torch.from_numpy(v) for k, v in
                                 _batch(cfg, 2, 32, 4).items()})
    passes = 2 if policy == "full" else 1
    assert calls == {"ssd": passes * cfg.num_layers,
                     "attn": passes * cfg.num_layers // cfg.attn_period}


# ---------------------------------------------------- the chip's route check
def _route_distance(cfg, tree, batch):
    """The metrics of ``chip_smoke.py``'s route check: relative loss
    difference and global relative gradient difference of the "pallas"
    route against the "xla" route."""
    out = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl, ssd_impl=impl)
        loss, _, grads = _port_grads(c, tree, batch)
        out[impl] = (loss, grads)
    (lk, gk), (lx, gx) = out["pallas"], out["xla"]
    num = sum(float(((gk[k] - gx[k]) ** 2).sum()) for k in gx) ** 0.5
    den = sum(float((gx[k] ** 2).sum()) for k in gx) ** 0.5
    return abs(lk - lx) / abs(lx), num / den


@pytest.mark.parametrize("fault", ["none", "ssd_decay_dropped",
                                   "attention_not_causal"])
def test_route_check_catches_a_faulty_kernel(fault, monkeypatch):
    """``chip_smoke.py``'s route-check bounds (loss 1e-5 relative,
    gradient 1e-3 of its norm) on zamba2-smoke: a right route passes; a K5
    that drops the decay or a K4 that is not causal, standing in for the
    kernel in the forward while the backward stays the plain one, fails,
    one of the two measures by at least 10 times its bound (decay dropped:
    7e-3 and 1.0; not causal: 1.3e-5 and 0.66)."""
    import chip_smoke
    if fault == "ssd_decay_dropped":
        def forward(ctx, x, dt, A, Bm, Cm, chunk):
            ctx.save_for_backward(x, dt, A, Bm, Cm)
            ctx.chunk = chunk
            return ops._ssd_plain(x, dt, A * 0, Bm, Cm, chunk)
        monkeypatch.setattr(ops._SSDScan, "forward", staticmethod(forward))
    elif fault == "attention_not_causal":
        def forward(ctx, q, k, v, causal):
            ctx.save_for_backward(q, k, v)
            ctx.causal = causal
            return ops._attention_plain_bshd(q, k, v, False)
        monkeypatch.setattr(ops._FlashAttention, "forward",
                            staticmethod(forward))
    arch = "zamba2-2.7b-smoke"
    _, cfg = _cfgs(arch, "xla")
    loss_rel, grad_rel = _route_distance(cfg, _weights(arch),
                                         _batch(cfg, 2, 64, 5))
    holds = (loss_rel <= chip_smoke.ROUTE_LOSS_RTOL
             and grad_rel <= chip_smoke.ROUTE_GRAD_RTOL)
    assert holds == (fault == "none"), (loss_rel, grad_rel)
    if fault != "none":
        assert (loss_rel > 10 * chip_smoke.ROUTE_LOSS_RTOL
                or grad_rel > 10 * chip_smoke.ROUTE_GRAD_RTOL)


# ------------------------------------------------------ trees, optimizer ---
@pytest.mark.parametrize("arch", ["zamba2-2.7b-smoke", "mamba2-1.3b-smoke"])
def test_ssm_and_hybrid_trees_init_and_convert(arch):
    """``model_api.init`` draws the ssm and hybrid trees (shared_attn
    included) with the reference's names, shapes and dtype, and
    ``params_from_jax`` carries the reference's own draw across exactly."""
    cfg = get_config(arch)
    tree = _weights(arch)
    p = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = {k: v.shape for k, v in _flat(p).items()}
    assert shapes == {k: v.shape for k, v in _flat(tree).items()}
    assert ("shared_attn/ffn/wi_gate/" in shapes) == (cfg.family == "hybrid")
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    got = _flat(params_from_jax(tree, cfg, "cpu"))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    n = sum(t.numel() for t in tree_leaves(p))
    assert n == sum(v.size for v in _flat(tree).values())


def test_adamw_update_matches_reference():
    """Three updates of a bf16 tree from float32 gradients (clipping
    active): parameters, m and v against ``adamw_update``."""
    rng = np.random.RandomState(8)
    shapes = {"a": (33, 17), "b": (5,), "c": (4, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = RefAdamWConfig(warmup_steps=2, total_steps=10)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    js = adamw_init(jp)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    opt = AdamW(tree_leaves(tp), AdamWConfig(**dataclasses.asdict(cfg)))
    for i in range(3):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = adamw_update(jp, {k: jnp.asarray(v) for k, v in
                                       g.items()}, js, cfg)
        tm = opt.update([torch.from_numpy(g[k]) for k in sorted(g)])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for j, k in enumerate(sorted(shapes)):
            np.testing.assert_allclose(opt.m[j].numpy(), np.asarray(
                js["m"][k]), rtol=1e-5, atol=1e-7, err_msg=f"m {k} {i}")
            np.testing.assert_allclose(opt.v[j].numpy(), np.asarray(
                js["v"][k]), rtol=1e-5, atol=1e-7, err_msg=f"v {k} {i}")
            # bf16 parameters: at most one bf16 step apart
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
                rtol=2 ** -7, atol=1e-6, err_msg=f"p {k} {i}")


def test_token_pipeline_is_the_references():
    """Same batches for the same seed, from ``batch_at`` and through the
    prefetch thread, and the same skip-ahead."""
    kw = dict(vocab_size=300, seq_len=24, global_batch=4, seed=3)
    ref, port = RefPipeline(RefDataConfig(**kw)), TokenPipeline(
        DataConfig(**kw))
    for step in (0, 1, 7):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    port.start()
    try:
        port.seek(0)
        for step in range(3):
            np.testing.assert_array_equal(next(port)["tokens"],
                                          ref.batch_at(step)["tokens"])
    finally:
        port.stop()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-1.3b",
                                  "minitron-8b", "qwen3-moe-235b-a22b",
                                  "moonshot-v1-16b-a3b"])
def test_model_flops_are_the_references(arch):
    for kind, S, B in (("train", 2048, 8), ("prefill", 2048, 8),
                       ("decode", 1, 64)):
        assert model_flops(get_config(arch), ShapeConfig(
            kind, S, B, kind)) == ref_model_flops(
                ref_get_config(arch), RefShape(kind, S, B, kind))
    with pytest.raises(NotImplementedError):
        model_flops(get_config("whisper-small"),
                    ShapeConfig("t", 128, 1, "train"))


def test_run_training_refuses_the_paths_of_later_slices(monkeypatch):
    """Meshes are not ported: asking for one raises rather than running
    without it; the loop's defaults are the reference's, field for
    field."""
    assert dataclasses.asdict(ptrain.TrainLoopConfig()) == dataclasses.asdict(
        rtrain.TrainLoopConfig())
    cfg = get_config("mamba2-1.3b-smoke")
    with pytest.raises(NotImplementedError, match="multi-card"):
        ptrain.run_training(cfg, ptrain.TrainLoopConfig(), mesh=object(),
                            device="cpu")
    monkeypatch.setattr("sys.argv", ["train", "--arch", cfg.name,
                                     "--mesh", "2x2"])
    with pytest.raises(NotImplementedError, match="multi-card"):
        ptrain.main()
