"""granite-4.0-h-small's family (hybrid_moe) on the CPU against the plain
reference ``tasq_bench/reference/granite_hybrid.py``, on the smoke config
(4 layers: mamba, attention, mamba, mamba; d_model 64; 8 experts top-2
and a shared expert; state 16, conv 4) with seeded random weights; and
the new arguments of the kernels' plain versions.

Tolerances, as a share of the reference logits' spread (their standard
deviation over the vocabulary at each position, ``logit_gap``): float32
on both sides differs only by the order of sums (the chunked scan
against the reference's quadratic form, grouped against dense expert
products), 1e-6 of the spread at most here, so the model-level checks
take 2e-5. The same model in bf16 reads above 1e-3
(``test_bf16_fails_the_float32_tolerance``), so the tolerance refuses a
lower precision.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, ServeConfig, Server
from repro_torch.models import layers as L
from repro_torch.models import lm, model_api
from repro_torch.models.params import param_shapes
from repro_torch.obs import Obs

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from tasq_bench.reference import granite_hybrid as R       # noqa: E402

ARCH = "granite-4.0-h-small"
TOL = 2e-5


def _model(seed=0, **kw):
    cfg = dataclasses.replace(get_config(ARCH + "-smoke"), **kw)
    p = model_api.init(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")
    return cfg, p


def _reference(cfg, p, tokens, control=False):
    return R.forward(torch.as_tensor(tokens), R.tree_weights(
        p, cfg.layer_types), R.dims(dataclasses.asdict(cfg)), control)


def _serve(cfg, p, tokens, n_new, start=None, max_len=None):
    """Prefill ``tokens`` (B, S) then decode ``n_new`` tokens teacher-forced
    on ``n_new`` given ones: logits (B, 1 + n_new, V)."""
    prompt, nxt = tokens[:, :-n_new], tokens[:, -n_new:]
    batch = {"tokens": torch.from_numpy(prompt)}
    if start is not None:
        batch["start"] = torch.tensor(start, dtype=torch.int32)
    logits, cache = lm.prefill(p, batch, cfg, max_len=max_len)
    out = [logits]
    for t in range(n_new):
        logits, cache = lm.decode_step(
            p, {"tokens": torch.from_numpy(nxt[:, t:t + 1])}, cache, cfg)
        out.append(logits)
    return torch.stack(out, dim=1)


def test_param_count_equals_init():
    cfg, p = _model()
    n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(p))
    assert n == cfg.param_count()
    full = get_config(ARCH)
    shapes = param_shapes(model_api.schema(full), full.param_dtype)
    assert sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        shapes)) == full.param_count() == 32_207_337_984
    idle = (full.num_experts - full.experts_per_token) * 3 * 4096 * 768
    assert full.active_param_count() == full.param_count() - 40 * idle


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_then_decode_match_the_reference(impl):
    """Prefill of 32 tokens (two SSD chunks), then 5 decode steps through
    the cache (every layer's kv, SSM and conv state), against the
    reference's full forward at every position."""
    cfg, p = _model(attention_impl=impl, ssd_impl=impl)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 37)).astype(np.int32)
    got = _serve(cfg, p, toks, 5, max_len=37)
    for b in range(2):
        want = _reference(cfg, p, toks[b])[31:]
        assert R.logit_gap(got[b], want) < TOL


def test_bf16_fails_the_float32_tolerance():
    cfg, p = _model()
    bf = dataclasses.replace(cfg, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    pb = torch.utils._pytree.tree_map(lambda t: t.to(torch.bfloat16), p)
    toks = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (1, 37)).astype(np.int32)
    want = _reference(cfg, p, toks[0])[31:]
    assert R.logit_gap(_serve(cfg, p, toks, 5, max_len=37)[0], want) < TOL
    assert R.logit_gap(_serve(bf, pb, toks, 5, max_len=37)[0],
                       want) > 50 * TOL
    # and the reference one precision lower, the cell's control
    assert R.logit_gap(_reference(cfg, p, toks[0], control=True)[31:],
                       want) > 50 * TOL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_left_padded_request_equals_itself_unpadded(impl):
    """Row 0 padded by 16 (a whole SSD chunk and the conv's reach), row 1
    by 3 (inside the conv's reach): the prefill's and three decode steps'
    logits agree with the reference's forward of the unpadded request,
    and row 0's with the program's own unpadded run, to float32's sums."""
    cfg, p = _model(attention_impl=impl, ssd_impl=impl)
    rng = np.random.RandomState(3)
    lens = (16, 29)
    rows = [rng.randint(1, cfg.vocab_size, n + 3).astype(np.int32)
            for n in lens]
    padded = np.zeros((2, 32 + 3), np.int32)
    for i, r in enumerate(rows):
        padded[i, 32 - lens[i]:] = r
    got = _serve(cfg, p, padded, 3, start=[32 - n for n in lens], max_len=35)
    for i, r in enumerate(rows):
        assert R.logit_gap(got[i], _reference(cfg, p, r)[-4:]) < TOL
    alone = _serve(cfg, p, rows[0][None], 3, max_len=len(rows[0]))
    assert R.logit_gap(got[0], alone[0]) < TOL
    # unmasked, the pads are read: a different result
    cfg_u = dataclasses.replace(cfg, mask_padding=False)
    unmasked = _serve(cfg_u, p, padded, 3, max_len=35)
    alone = _serve(cfg, p, rows[0][None], 3, max_len=len(rows[0]))
    assert R.logit_gap(unmasked[0], alone[0]) > 1e-3


def test_dropless_routing_under_a_skewed_router():
    """Every token's router prefers expert 0: a capacity dispatch keeps
    C = ceil(K S 1.25 / E) slots an expert and drops the rest; the
    dropless MoE keeps them all and equals the reference's dense MoE."""
    cfg, p = _model()
    bp = {k: v[0] for k, v in p["blocks"].items()}
    bp["router"] = bp["router"].clone()
    bp["router"][:, 0] += 0.5      # inputs of mean 0.5: expert 0 on top
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4)) + 0.5
    logits = x @ bp["router"]
    assert (logits.argmax(-1) == 0).float().mean() > 0.9
    got = L.moe_dropless(x, bp, cfg)
    ref_p = {k: v.float() for k, v in bp.items()}
    dims = R.dims(dataclasses.asdict(cfg))
    for b in range(2):
        want = R._moe(x[b], ref_p, dims, torch.matmul)
        torch.testing.assert_close(got[b], want, atol=1e-5, rtol=1e-5)
    # the capacity dispatch at the moe family's 1.25 would have dropped
    K, E = cfg.experts_per_token, cfg.num_experts
    C = math.ceil(K * 32 * 1.25 / E)
    assert int((logits.argmax(-1) == 0).sum(-1).max()) > C
    counters = (torch.zeros((), dtype=torch.int64),
                torch.zeros((), dtype=torch.int64))
    L.moe_dropless(x, bp, cfg, counters)
    assert int(counters[0]) == 2 * 32 * K
    assert int(counters[1]) > C


def test_conv_state_decode_equals_the_full_conv():
    g = torch.Generator().manual_seed(5)
    u = torch.randn(2, 11, 24, generator=g)
    w, b = torch.randn(4, 24, generator=g), torch.randn(24, generator=g)
    full = L.causal_conv(u, w, b)
    state = torch.zeros(2, 3, 24)
    for t in range(11):
        out, state = L.conv_step(state, u[:, t], w, b)
        assert torch.equal(out, full[:, t])
    assert torch.equal(state, u[:, -3:])


def test_server_honours_max_len():
    """Decoding past the prompt with ``max_len`` >= prompt + new tokens
    matches the full forward of the prompt and the decoded tokens (dense
    minitron smoke: RoPE positions, every token its own cache slot);
    without it the cache stays prompt-long (the reference's clamp)."""
    cfg = get_config("minitron-8b-smoke")
    p = model_api.init(cfg, torch.Generator().manual_seed(6), device="cpu")
    prompt = np.random.RandomState(6).randint(
        0, cfg.vocab_size, 16).astype(np.int32)
    for max_len, want_len in ((None, 16), (20, 20)):
        steps = []
        server = Server(cfg, ServeConfig(batch_size=1, prompt_len=16,
                                         max_len=max_len), p, device="cpu")
        dec = server._decode

        def record(params, batch, **kw):
            logits, cache = dec(params, batch, **kw)
            steps.append((logits, cache.k.shape[2]))
            return logits, cache

        server._decode = record
        out = server.run([Request(0, prompt, 5)])[0]
        assert {n for _, n in steps} == {want_len}
    seq = np.concatenate([prompt, out])
    for t, (logits, _) in enumerate(steps):
        full, _ = lm.prefill(p, {"tokens": torch.from_numpy(
            seq[None, :17 + t])}, cfg)
        torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)


def test_server_traces_a_batch():
    """Spans ``lm.batch`` > ``lm.prefill`` / ``lm.decode`` > ``lm.mamba`` /
    ``lm.attention`` / ``lm.moe``, one a layer call, and the counters;
    off the card no span has ``device_ms``."""
    cfg, p = _model()
    obs = Obs.enabled()
    server = Server(cfg, ServeConfig(batch_size=2, prompt_len=32,
                                     max_len=36), p, device="cpu", obs=obs)
    rng = np.random.RandomState(7)
    server.run([Request(0, rng.randint(0, 256, 20).astype(np.int32), 4),
                Request(1, rng.randint(0, 256, 32).astype(np.int32), 3)])
    names = [s.name for s in obs.tracer.spans()]
    steps = 3
    assert names.count("lm.batch") == 1
    assert names.count("lm.prefill") == 1 and names.count("lm.decode") == 3
    assert names.count("lm.moe") == 4 * (1 + steps)
    assert names.count("lm.mamba") == 3 * (1 + steps)
    assert names.count("lm.attention") == 1 + steps
    snap = obs.metrics.snapshot()
    assert snap["lm_prompt_tokens"] == 52 and snap["lm_pad_tokens"] == 12
    assert snap["lm_generated_tokens"] == 7 and snap["lm_decode_steps"] == 3
    K = cfg.experts_per_token
    assert snap["moe_slots"] == 4 * (2 * 32 + steps * 2) * K
    assert 0 < snap["moe_max_expert_slots"] <= snap["moe_slots"]
    assert not any("device_ms" in s.attrs for s in obs.tracer.spans())


# -------------------------------------------- the kernels' plain versions --
def test_plain_attentions_take_scale_and_kv_start():
    """``causal_attention_ref`` (the model's) and ``attention_ref_bhsd``
    (K4's) agree with each other and with each row attended alone over
    its live keys; query rows before the start give 0; the defaults are
    today's bits."""
    from repro_torch.kernels.ref import attention_ref_bhsd
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(3, 20, h, 16, generator=g) for h in (4, 2, 2))
    start = torch.tensor([0, 5, 20], dtype=torch.int32)
    a = L.causal_attention_ref(q, k, v, scale=0.1, kv_start=start)
    b = attention_ref_bhsd(*(t.transpose(1, 2) for t in (q, k, v)),
                           scale=0.1, kv_start=start).transpose(1, 2)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    s = 5
    alone = L.causal_attention_ref(q[1:2, s:], k[1:2, s:], v[1:2, s:],
                                   scale=0.1)
    torch.testing.assert_close(a[1:2, s:], alone, atol=1e-6, rtol=1e-6)
    assert not a[1, :s].any() and not a[2].any() and not b[2].any()
    assert torch.equal(L.causal_attention_ref(q, k, v),
                       L.causal_attention_ref(q, k, v, scale=0.25))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    assert torch.equal(attention_ref_bhsd(qt, kt, vt),
                       attention_ref_bhsd(qt, kt, vt, scale=0.25))


def test_ssd_chunked_final_state_is_the_recurrence():
    """``ssd_chunked``'s final state (what K5 now returns) against the
    sequential recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T."""
    g = torch.Generator().manual_seed(9)
    B, S, H, P, N = 2, 48, 3, 8, 16
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g))
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    _, h = L.ssd_chunked(x, dt, A, Bm, Cm, 16)
    want = torch.zeros(B, H, P, N)
    for t in range(S):
        want = (want * torch.exp(dt[:, t] * A)[..., None, None]
                + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                               Bm[:, t]))
    torch.testing.assert_close(h, want, atol=1e-5, rtol=1e-5)


def test_mask_padding_is_refused_outside_hybrid_moe():
    """Only the hybrid_moe family masks its left-padding; another family
    given ``mask_padding`` refuses to serve instead of ignoring it."""
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"),
                              mask_padding=True)
    p = model_api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "start": torch.tensor([3], dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="mask_padding"):
        lm.prefill(p, batch, cfg)
