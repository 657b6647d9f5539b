"""The LM serving path, port against reference on the CPU: configs,
schemas, layers, ``prefill`` and ``decode_step`` of the dense, MoE, SSM and
hybrid families, on the same weights (the reference's initialiser, carried
across by ``params_from_jax``) and the same numpy-seeded tokens.

Tolerance of the model-level comparisons: float32 on both sides, summed
in other orders by XLA and by PyTorch's CPU kernels, through up to two
layers whose weights the reference's law draws with std 1/sqrt(layers)
(activations of tens to hundreds): ``rtol`` 1e-4 and ``atol`` 1e-4 of
the compared array's largest magnitude. Layer-level comparisons take
float32's own scale (1e-5).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import model_api as rapi
from repro.models.params import NULL_SHARDER
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm, model_api
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import ParamSpec, map_specs

DECODER_ARCHS = [a for a in ARCH_IDS if a != "whisper-small"]
PARITY_ARCHS = ["minitron-8b", "command-r-35b", "qwen2-72b", "zamba2-2.7b",
                "mamba2-1.3b", "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]
CACHE_FIELDS = ("k", "v", "ssm", "shared_k", "shared_v")


def _close(got, want, what, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_copies_of_the_reference(arch):
    """The reference's dict of the config; the fields only the port has
    (the hybrid_moe family's) keep their defaults, so it leaves them out."""
    for kw in ({}, {"smoke": True}, {"optimized": True}):
        assert (get_config(arch, **kw).reference_dict()
                == dataclasses.asdict(ref_get_config(arch, **kw))), kw


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), tuple(tree.axes), tree.init,
                     tree.scale)}


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_schema_matches_reference(arch):
    """Every decoder-only family's full-size schema: same names, shapes,
    logical axes and initialisers (no memory is allocated)."""
    assert _flat(model_api.schema(get_config(arch))) == _flat(
        rapi.schema(ref_get_config(arch)))


def test_init_follows_the_reference_law():
    cfg = get_config("minitron-8b-smoke")
    p = model_api.init(cfg, torch.Generator().manual_seed(3), "cpu")
    again = model_api.init(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(p["blocks"]["wq"], again["blocks"]["wq"])
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    # fan-in is the first dim of a matrix: the layer axis for blocks
    for name, t, fan_in in (("embed", p["embed"], cfg.vocab_size),
                            ("wi_up", p["blocks"]["ffn"]["wi_up"],
                             cfg.num_layers)):
        assert t.dtype == torch.float32
        assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.05, name
    bf = model_api.init(dataclasses.replace(cfg, param_dtype="bfloat16"),
                        torch.Generator().manual_seed(3), "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    specs = map_specs(lambda s: s, model_api.schema(cfg))
    assert isinstance(specs["embed"], ParamSpec)


# ---------------------------------------------------------------- layers ---
def test_rms_norm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 30
    w = rng.standard_normal(64).astype(np.float32)
    want = RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(L.rms_norm(_t(x), _t(w), 1e-6), want, "rms_norm", 1e-5)
    # bf16: the cast to the input type comes before the weight multiply
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    got = L.rms_norm(xb, wb, 1e-6)
    want_b = RL.rms_norm(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(w, jnp.bfloat16), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want_b.astype(jnp.float32)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
    pos = rng.randint(0, 4096, (2, 7)).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # angles of up to 4,096 rad: float32 sin/cos of two libraries
    _close(L.apply_rope(_t(x), torch.from_numpy(pos), theta), want, "rope",
           2e-4)


def _ffn_params(cfg, seed):
    rng = np.random.RandomState(seed)
    d, f = cfg.d_model, cfg.d_ff
    names = ["wi_up", "wo"] if cfg.mlp_style == "mlp2" else ["wi_gate",
                                                             "wi_up", "wo"]
    return {n: (rng.standard_normal((f, d) if n == "wo" else (d, f))
                / np.sqrt(d)).astype(np.float32) for n in names}


@pytest.mark.parametrize("arch", ["minitron-8b", "command-r-35b"])
def test_ffn_block_matches_reference(arch):
    """mlp2 (GELU, tanh approximation as jax.nn.gelu's default) and
    swiglu."""
    cfg = get_config(arch, smoke=True)
    p = _ffn_params(cfg, 2)
    x = np.random.RandomState(3).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32) * 3
    want, _ = rlm._ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                        p.items()}, ref_get_config(arch,
                                                                   smoke=True),
                       NULL_SHARDER)
    got, aux = lm._ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    assert aux is None             # the reference's 0: no load-balance loss
    _close(got, want, arch, 1e-5)
    if cfg.mlp_style == "mlp2":     # the exact erf GELU would not pass
        h = _t(x) @ _t(p["wi_up"])
        exact = torch.nn.functional.gelu(h) @ _t(p["wo"])
        assert float((exact - got).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_reference(dtype):
    """One token through the SSD recurrence at zamba2-2.7b's head shape
    (H 80, P 64, N 64): output and new state. bf16 x, B, C as in serving
    (the state stays float32); the output is rounded to bf16 on both
    sides, so it is held to bf16's own scale (1e-2)."""
    rng = np.random.RandomState(17)
    B, H, P, N = 2, 80, 64, 64
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 2.0, (B, H)).astype(np.float32)
    A = -rng.uniform(0.1, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, N)).astype(np.float32)
    Cm = rng.standard_normal((B, N)).astype(np.float32)
    jd = getattr(jnp, dtype)
    want_y, want_h = RL.ssd_decode_step(
        jnp.asarray(h), jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(Bm, jd), jnp.asarray(Cm, jd))
    td = getattr(torch, dtype)
    y, h_new = L.ssd_decode_step(_t(h), _t(x).to(td), _t(dt), _t(A),
                                 _t(Bm).to(td), _t(Cm).to(td))
    assert y.dtype == td and h_new.dtype == torch.float32
    _close(h_new, want_h, "state", 1e-5)
    _close(y, np.asarray(want_y.astype(jnp.float32)), "y",
           1e-5 if dtype == "float32" else 1e-2)


def test_decode_attention_matches_reference():
    rng = np.random.RandomState(4)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    clen = np.array([1, 7, 12], np.int32)          # 12 > Smax: all slots
    want = RL.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, clen)))
    got = L.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(clen))
    _close(got, want, "decode_attention", 1e-5)


def test_chunked_causal_attention_matches_reference():
    """The "xla" route past one chunk (S 1,024 in chunks of 512)."""
    rng = np.random.RandomState(5)
    q = rng.standard_normal((1, 1024, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1024, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1024, 2, 16)).astype(np.float32)
    want = RL.causal_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v))
    _close(L.causal_attention_ref(_t(q), _t(k), _t(v)), want, "chunked",
           1e-5)
    with pytest.raises(ValueError, match="multiple"):
        L.causal_attention_ref(*(torch.zeros((1, 600, 2, 16)),) * 3)


# --------------------------------------------------- prefill and decode ---
@functools.lru_cache(maxsize=None)
def _weights(arch, **overrides):
    """The reference's seeded weights for a config, as a numpy tree (qkv
    biases, zero at init, are drawn so that they count)."""
    jcfg = dataclasses.replace(ref_get_config(arch), **overrides)
    tree = jax.tree.map(np.asarray, rapi.init(jcfg, jax.random.PRNGKey(0)))
    if jcfg.qkv_bias:
        rng = np.random.RandomState(7)
        for n in ("bq", "bk", "bv"):
            b = tree["blocks"][n]
            tree["blocks"][n] = rng.standard_normal(b.shape).astype(
                np.float32) * 0.5
    return tree


def _both(arch, impl, **overrides):
    jcfg = dataclasses.replace(ref_get_config(arch), attention_impl=impl,
                               **overrides)
    cfg = dataclasses.replace(get_config(arch), attention_impl=impl,
                              **overrides)
    tree = _weights(arch, **overrides)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(tree, cfg, "cpu"))


def _close_caches(tc, jc, what, tol):
    """Every field of the reference's cache (k, v; ssm; shared_k,
    shared_v, by family) against the port's; the port has no others."""
    for name in CACHE_FIELDS:
        want = getattr(jc, name)
        assert (getattr(tc, name) is None) == (want is None), (what, name)
        if want is not None:
            assert tuple(getattr(tc, name).shape) == want.shape, (what, name)
            _close(getattr(tc, name), want, f"{what} {name} cache", tol)
    assert tc.length.tolist() == np.asarray(jc.length).tolist()


def _run_both(jcfg, jp, cfg, p, tokens, n_decode, tol=1e-4):
    """Prefill then ``n_decode`` greedy steps on both sides, comparing the
    logits and the caches after each."""
    jl, jc = rlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    tl, tc = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg)
    _close(tl, jl, "prefill logits", tol)
    _close_caches(tc, jc, "prefill", tol)
    for step in range(n_decode):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = rlm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, jcfg)
        tl, tc = lm.decode_step(p, {"tokens": torch.from_numpy(nxt)}, tc, cfg)
        _close(tl, jl, f"decode {step} logits", tol)
        _close_caches(tc, jc, f"decode {step}", tol)
    return tl, tc


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    """minitron (mlp2, GELU), command-r (swiglu, tied embeddings), qwen2
    (qkv bias), zamba2 (hybrid: Mamba-2 layers and a shared attention
    block with one kv cache an application), mamba2 (ssm), moonshot (MoE,
    8 experts top-2) and qwen3-moe (MoE with GQA): prefill logits and
    caches (attention, SSM states, shared attention), then three decode
    steps. S 32 is one SSD chunk of the smoke configs; the hybrid applies
    its shared block twice; a MoE decode step routes one token a
    sequence at capacity 1."""
    jcfg, jp, cfg, p = _both(arch + "-smoke", impl)
    tokens = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    _run_both(jcfg, jp, cfg, p, tokens, 3)


FULL_WIDTH = dict(num_layers=1, vocab_size=1024, param_dtype="float32",
                  compute_dtype="float32")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_full_width_minitron_layer_matches_reference(impl):
    """minitron-8b's published widths (d_model 4,096, 32 query heads over 8
    kv heads of 128, d_ff 16,384) at depth 1 and a 1,024-token
    vocabulary, float32, S 128: prefill and one decode step.

    At depth 1 the reference's law draws block weights with std 1 (their
    fan-in is the layer axis), so scores reach thousands and the softmax is
    nearly one-hot: float32 rounding of a score (1e-7 of ~4,000) shifts
    the weights of near-tied keys by a few 1e-4. Tolerance 1e-3 of the
    largest magnitude."""
    jcfg, jp, cfg, p = _both("minitron-8b", impl, **FULL_WIDTH)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (4096, 32, 8, 128, 16384)
    tokens = np.random.RandomState(12).randint(
        0, cfg.vocab_size, (1, 128)).astype(np.int32)
    _run_both(jcfg, jp, cfg, p, tokens, 1, tol=1e-3)


def test_decode_cache_write_is_clamped_at_the_prompt_length():
    """The cache is as long as the prompt; each decode write lands at
    min(length, Smax - 1), so slot Smax - 1 is overwritten and the other
    slots stay equal, while ``length`` keeps growing (the reference's
    ``dynamic_update_slice`` clamp)."""
    jcfg, jp, cfg, p = _both("minitron-8b-smoke", "xla")
    S = 8
    tokens = np.random.RandomState(13).randint(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    tl, cache = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg)
    before_k, before_v = cache.k.clone(), cache.v.clone()
    assert cache.k.shape[2] == S
    for step in range(2):
        nxt = tl.argmax(-1).to(torch.int32)[:, None]
        tl, cache = lm.decode_step(p, {"tokens": nxt}, cache, cfg)
        assert cache.length.tolist() == [S + 1 + step] * 2
        assert cache.k.shape[2] == S
        assert torch.equal(cache.k[:, :, :S - 1], before_k[:, :, :S - 1])
        assert torch.equal(cache.v[:, :, :S - 1], before_v[:, :, :S - 1])
        assert not torch.equal(cache.k[:, :, S - 1], before_k[:, :, S - 1])
        before_k, before_v = cache.k.clone(), cache.v.clone()
    jl, jc = rlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = rlm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc, jcfg)
    _close(cache.k, jc.k, "clamped k cache")
    _close(tl, jl, "logits after the clamped writes")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_full_width_zamba2_layers_match_reference(impl):
    """zamba2-2.7b's published widths (d_model 2,560, 80 SSD heads of 64
    with state 64, 32 attention heads of 80, d_ff 10,240) at depth 2 with
    the shared block after layer 1 (attn_period 2), a 1,024-token
    vocabulary, float32, S 256 (two SSD chunks): prefill logits, SSM
    states and shared caches, then one decode step. As in the minitron
    layer test, depth-2 weights have std 1/sqrt(2); tolerance 1e-3 of the
    largest magnitude."""
    jcfg, jp, cfg, p = _both("zamba2-2.7b", impl, attn_period=2,
                             **{**FULL_WIDTH, "num_layers": 2})
    assert (cfg.d_model, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
            cfg.ssm_state, cfg.num_heads, cfg.resolved_head_dim,
            cfg.d_ff) == (2560, 80, 64, 32, 80, 10240)
    tokens = np.random.RandomState(18).randint(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)
    _run_both(jcfg, jp, cfg, p, tokens, 1, tol=1e-3)


def test_hybrid_shared_cache_write_is_clamped_at_the_prompt_length():
    """The decode-cache fault of the reference holds for the hybrid's
    shared attention too: each application's cache is as long as the
    prompt, and every decode step overwrites its last slot."""
    jcfg, jp, cfg, p = _both("zamba2-2.7b-smoke", "xla")
    S = 8
    tokens = np.random.RandomState(19).randint(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    tl, cache = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg)
    napps = cfg.num_layers // cfg.attn_period
    assert cache.shared_k.shape[:3] == (napps, 2, S) and cache.k is None
    before = cache.shared_k.clone()
    jl, jc = rlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    for step in range(2):
        nxt = tl.argmax(-1).to(torch.int32)[:, None]
        tl, cache = lm.decode_step(p, {"tokens": nxt}, cache, cfg)
        jl, jc = rlm.decode_step(jp, {"tokens": jnp.asarray(nxt.numpy())},
                                 jc, jcfg)
        assert cache.shared_k.shape[2] == S
        assert torch.equal(cache.shared_k[:, :, :S - 1],
                           before[:, :, :S - 1])
        assert not torch.equal(cache.shared_k[:, :, S - 1],
                               before[:, :, S - 1])
        before = cache.shared_k.clone()
        _close_caches(cache, jc, f"clamped step {step}", 1e-4)
    _close(tl, jl, "logits after the clamped writes")


def test_left_padding_is_not_masked_and_positions_are_arange():
    """Prompts left-padded with token 0 go in unmasked at positions
    arange(S): the padding changes the logits, in both packages alike."""
    jcfg, jp, cfg, p = _both("minitron-8b-smoke", "pallas")
    rng = np.random.RandomState(14)
    short = rng.randint(1, cfg.vocab_size, (2, 5)).astype(np.int32)
    padded = np.zeros((2, 12), np.int32)
    padded[:, -5:] = short
    jl, _ = rlm.prefill(jp, {"tokens": jnp.asarray(padded)}, jcfg)
    tl, _ = lm.prefill(p, {"tokens": torch.from_numpy(padded)}, cfg)
    _close(tl, jl, "left-padded prefill")
    explicit = {"tokens": torch.from_numpy(padded),
                "positions": torch.arange(12).expand(2, 12)}
    assert torch.equal(lm.prefill(p, explicit, cfg)[0], tl)
    unpadded, _ = lm.prefill(p, {"tokens": torch.from_numpy(short)}, cfg)
    assert not torch.allclose(unpadded, tl, atol=1e-3)


def test_decode_positions_are_the_cache_length():
    _, _, cfg, p = _both("qwen2-72b-smoke", "xla")
    tokens = np.random.RandomState(15).randint(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, cache = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg)
    nxt = torch.tensor([[3], [4]], dtype=torch.int32)
    default, _ = lm.decode_step(p, {"tokens": nxt}, lm.Cache(
        k=cache.k.clone(), v=cache.v.clone(), length=cache.length), cfg)
    explicit, _ = lm.decode_step(p, {"tokens": nxt, "positions":
                                     cache.length[:, None]}, cache, cfg)
    assert torch.equal(default, explicit)


def test_kv_head_replication_is_identical_math():
    jcfg, jp, cfg, p = _both("minitron-8b-smoke", "pallas",
                             kv_head_replication=2)
    tokens = np.random.RandomState(16).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tl, tc = _run_both(jcfg, jp, cfg, p, tokens, 1)
    assert tc.k.shape[3] == 2 * cfg.num_kv_heads
    base = dataclasses.replace(cfg, kv_head_replication=1)
    bl, _ = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, base)
    rl, _ = lm.prefill(p, {"tokens": torch.from_numpy(tokens)}, cfg)
    _close(rl, bl.numpy(), "replicated vs not", 1e-5)


def test_cache_specs_match_reference():
    for arch in ("minitron-8b", "qwen2-72b", "zamba2-2.7b", "mamba2-1.3b"):
        spec = lm.cache_specs(get_config(arch), 8, 2048)
        ref = rlm.cache_specs(ref_get_config(arch), 8, 2048)
        for name in CACHE_FIELDS + ("length",):
            got, want = getattr(spec, name), getattr(ref, name)
            assert (got is None) == (want is None), (arch, name)
            if want is not None:
                assert got.device.type == "meta"
                assert tuple(got.shape) == want.shape, (arch, name)
                assert str(got.dtype).split(".")[1] == str(want.dtype), (
                    arch, name)


def test_argmax_takes_the_first_maximum_in_both_frameworks():
    x = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]], np.float32)
    assert (torch.argmax(torch.from_numpy(x), -1).tolist()
            == np.asarray(jnp.argmax(jnp.asarray(x), -1)).tolist() == [1, 0])


def test_paths_of_later_slices_raise(tmp_path):
    """Every path of the port is ported; the multi-card ones raise where
    their inputs are wrong rather than falling back: a ``Sharder`` on a
    mesh takes DTensors only, the dry run refuses a process without its
    fake group, a mesh plan refuses a group of another size, and a
    restore onto a mesh needs the mesh."""
    import types

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import dryrun
    from repro_torch.launch.elastic import MeshPlan
    from repro_torch.models.params import Sharder
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.empty(2, 4))
    with pytest.raises(TypeError, match="DTensor"):
        Sharder(mesh, {"batch": "data"})(torch.ones(4, 3), "batch", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        dryrun.lower_cell("minitron-8b", "train_4k", multi_pod=False)
    with pytest.raises(RuntimeError, match="process group"):
        MeshPlan(data=2, model=2).build()
    cm = CheckpointManager(str(tmp_path))
    state = {"w": torch.ones(3)}
    cm.save(1, state, blocking=True)
    with pytest.raises(ValueError, match="mesh"):
        cm.restore(state, shardings={"w": None})
    assert torch.equal(cm.restore(state)[0]["w"], state["w"])
