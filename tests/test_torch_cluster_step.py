"""Kernels K2 and K3's plain versions against the reference's float64 jnp
twins (and K2's against the reference's Pallas kernel in interpret mode),
on the same seeded inputs. Card-side tests are in
``tests/test_torch_kernels_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.allocator import build_policy as ref_build_policy
from repro.kernels.cluster_step import epoch_step_pallas as ref_epoch_pallas
from repro.kernels.cluster_step import epoch_step_ref as ref_epoch_ref
from repro.kernels.cluster_step import resize_step_pallas as ref_resize_pallas
from repro.kernels.cluster_step import resize_step_ref as ref_resize_ref
from repro_torch.core.allocator import build_policy, choose_tokens_priced_torch
from repro_torch.kernels import ops
from repro_torch.kernels.cluster_step import (epoch_step_ref, pack_resize,
                                              resize_step_ref, unpack_resize)

NOW = 100.0


def _epoch_case(name, seed=0, K=3, L=64, Q=32):
    """(end_s, tokens, free, q_tok, q_end) for one named edge case."""
    rng = np.random.RandomState(seed)
    live = rng.rand(K, L) < 0.6
    tokens = np.where(live, rng.randint(1, 50, (K, L)), 0).astype(np.int64)
    # half-second grid: exact in f32 too; some leases end exactly at NOW
    end = np.where(live, NOW + rng.randint(-20, 40, (K, L)) * 0.5, np.inf)
    free = rng.randint(0, 200, K).astype(np.int64)
    q_tok = rng.randint(1, 40, (K, Q)).astype(np.int64)
    q_tok[:, Q - 5:] = 0                       # padded tail
    q_end = NOW + rng.randint(1, 500, (K, Q)).astype(np.float64)
    if name == "all_expired":
        end = np.where(live, NOW - 1.0, np.inf)
    elif name == "full_table":                 # open slots bind
        tokens = rng.randint(1, 5, (K, L)).astype(np.int64)
        end = NOW + 10.0 + rng.randint(0, 9, (K, L))
        tokens[:, :3] = 2
        end[:, :3] = NOW - 1.0                 # 3 slots free up
        free = np.full(K, 10_000, np.int64)
    elif name == "free_binds":
        end = np.where(live, NOW + 50.0, np.inf)
        free = np.array([0, 7, 41][:K], np.int64)
    elif name == "empty_queue":
        q_tok[:] = 0
        q_end[:] = 0.0
    elif name == "end_equals_now":
        end = np.where(live, NOW, np.inf)
    elif name == "no_queue":                   # Q = 0: expiry alone
        q_tok, q_end = q_tok[:, :0], q_end[:, :0]
    return end, tokens, free, q_tok, q_end


CASES = ["random", "all_expired", "full_table", "free_binds", "empty_queue",
         "end_equals_now"]


@pytest.mark.parametrize("name", CASES + ["no_queue"])
def test_epoch_step_ref_equals_reference_f64(name):
    end, tokens, free, q_tok, q_end = _epoch_case(name)
    got = epoch_step_ref(*(torch.from_numpy(x) for x in
                           (end, tokens, free, q_tok, q_end)), NOW)
    with jax.enable_x64():
        want = ref_epoch_ref(*(jnp.asarray(x) for x in
                               (end, tokens, free, q_tok, q_end)),
                             jnp.asarray(NOW, jnp.float64))
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3].sum() > 0 or name in ("empty_queue", "no_queue")


@pytest.mark.parametrize("name", CASES)
def test_epoch_step_ref_agrees_with_pallas_interpret(name):
    """The TPU kernel itself (f32 tables, interpret mode) admits and
    scatters exactly as the port's plain version."""
    end, tokens, free, q_tok, q_end = _epoch_case(name, seed=1)
    got = epoch_step_ref(*(torch.from_numpy(x) for x in
                           (end, tokens, free, q_tok, q_end)), NOW)
    want = ref_epoch_pallas(*(jnp.asarray(x) for x in
                              (end, tokens, free, q_tok, q_end)),
                            NOW, interpret=True)
    new_tok, slot_of, n_admit = want[1], want[2], want[3]
    freed, n_expired = want[5], want[6]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(new_tok))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(slot_of))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(n_admit))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(freed))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(n_expired))


def _resize_inputs(seed, C=48, smax=300):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, smax + 1, C).astype(np.int32)
    sky = np.zeros((C, smax), np.int32)
    for c in range(C):
        blk = rng.choice([1, 5, 40])
        sky[c, :lens[c]] = np.repeat(rng.randint(0, 300, lens[c] // blk + 1),
                                     blk)[:lens[c]]
    a = -rng.uniform(0.01, 2.5, C)
    a[:3] = [0.0, 0.3, -1e-4]                 # flat / rising curves
    b = np.exp(rng.uniform(0.0, 10.0, C))
    obs = rng.randint(1, 3000, C).astype(np.int64)
    cand_tok = rng.randint(1, 3000, C).astype(np.int64)
    cand_end = NOW + rng.randint(0, 100, C).astype(np.float64)
    return a, b, obs, cand_tok, cand_end, sky, lens


@pytest.mark.parametrize("policy_name", ["bounded_slowdown", "default"])
@pytest.mark.parametrize("price", [1.0, 1.5, 4.0])
def test_resize_step_ref_equals_reference_f64(policy_name, price):
    a, b, obs, cand_tok, cand_end, sky, lens = _resize_inputs(
        int(price * 10) + len(policy_name))
    C = a.size
    pr = np.full(C, price)
    policy, ref_policy = (build_policy(policy_name),
                          ref_build_policy(policy_name))
    cap = 1500
    for done_v in (0.0, 0.5, 0.999):
        done = np.full(C, done_v)
        for flo_kind in ("below", "above"):
            # a floor of 1 sits below every decision; one past the cap
            # sits above it
            flo = (np.ones(C, np.int64) if flo_kind == "below"
                   else cap + 1 + np.arange(C, dtype=np.int64) % 9)
            got = resize_step_ref(
                *(torch.from_numpy(x) for x in
                  (a, b, pr, obs, flo, done, cand_tok, cand_end, sky, lens)),
                NOW, 8.0, policy=policy, cap=cap)
            with jax.enable_x64():
                want = ref_resize_ref(
                    *(jnp.asarray(x) for x in
                      (a, b, pr, obs, flo, done, cand_tok, cand_end,
                       sky.astype(np.float32), lens)),
                    jnp.asarray(NOW, jnp.float64), 8.0, policy=ref_policy,
                    cap=cap)
                want = [np.asarray(w) for w in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
            if flo_kind == "above":
                assert np.all(got[0].numpy() == flo)


def test_resize_step_ref_agrees_with_pallas_interpret():
    """The TPU kernel itself (f32, interpret mode) decides, re-simulates
    and reprices as the port's plain version, on the reference test's own
    inputs and tolerance (tests/test_cluster_step.py::
    test_resize_pallas_interpret_matches_f32_twin)."""
    from repro.core.allocator import AllocationPolicy as RefPolicy
    from repro_torch.core.allocator import AllocationPolicy
    rng = np.random.default_rng(3)
    C, smax, cap = 4, 64, 256
    lens = rng.integers(8, smax, C).astype(np.int32)
    sky = np.zeros((C, smax), np.float32)
    for i, ln in enumerate(lens):
        sky[i, :ln] = rng.integers(1, 50, ln)
    vecs = [np.asarray(x, np.float32) for x in (
        rng.uniform(-0.9, -0.2, C), lens * 4.0, rng.uniform(1.0, 2.0, C),
        rng.integers(8, 200, C), rng.integers(1, 4, C),
        rng.uniform(0.0, 0.9, C), rng.integers(8, 200, C),
        rng.uniform(100, 400, C))]
    want = ref_resize_pallas(*(jnp.asarray(x) for x in vecs),
                             jnp.asarray(sky), jnp.asarray(lens),
                             jnp.asarray(50.0, jnp.float32), 8.0,
                             policy=RefPolicy(max_slowdown=0.05), cap=cap,
                             time_block=32, interpret=True)
    kinds = (np.float64, np.float64, np.float64, np.int64, np.int64,
             np.float64, np.int64, np.float64)
    got = resize_step_ref(
        *(torch.from_numpy(x.astype(k)) for x, k in zip(vecs, kinds)),
        torch.from_numpy(sky.astype(np.int32)), torch.from_numpy(lens), 50.0,
        8.0, policy=AllocationPolicy(max_slowdown=0.05), cap=cap)
    for name, g, w in zip(("tgt", "sel", "rt", "new_end"), got, want):
        np.testing.assert_allclose(np.asarray(w, np.float64),
                                   g.numpy().astype(np.float64), rtol=1e-6,
                                   err_msg=name)
    assert got[1].any() and (got[2] > 1).all()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    end, tokens, free, q_tok, q_end = _epoch_case("random", seed=3)
    t = [torch.from_numpy(x) for x in (end, tokens, free, q_tok, q_end)]
    got = ops.cluster_epoch_step(*t, NOW)
    want = epoch_step_ref(*t, NOW)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, b, obs, cand_tok, cand_end, sky, lens = _resize_inputs(5)
    C = a.size
    vecs = (a, b, np.full(C, 1.5), obs, np.ones(C, np.int64),
            np.full(C, 0.25), cand_tok, cand_end)
    policy = build_policy("bounded_slowdown")
    want = resize_step_ref(*(torch.from_numpy(x) for x in vecs),
                           torch.from_numpy(sky), torch.from_numpy(lens), NOW,
                           8.0, policy=policy, cap=900)
    # through a row index into a pool (reversed rows + 5 spare rows), the
    # inputs in one packed buffer and the outputs in another
    pool = np.concatenate([sky[::-1], np.zeros((5, sky.shape[1]), np.int32)])
    pool_lens = np.concatenate([lens[::-1], np.ones(5, np.int32)])
    rows = torch.arange(C - 1, -1, -1)
    packed = torch.from_numpy(pack_resize(*vecs, rows.numpy()))
    out = ops.cluster_resize_step(packed, torch.from_numpy(pool),
                                  torch.from_numpy(pool_lens), NOW, 8.0,
                                  policy=policy, cap=900)
    assert out.dtype == torch.uint8 and out.shape == (25 * C,)
    got = unpack_resize(out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    rt = ops.arepas_runtimes(torch.from_numpy(pool),
                             torch.from_numpy(pool_lens),
                             want[0].clamp(min=1).to(torch.int32)[:, None],
                             rows=rows)
    assert torch.equal(rt[:, 0].clamp(min=1).long(), want[2])
    at, bt, ot = (torch.from_numpy(x) for x in (a, b, obs))
    pt = torch.full((C,), 1.5, dtype=torch.float64)
    toks, runtime = ops.policy_decide(at, bt, policy, pt, ot)
    want_toks = choose_tokens_priced_torch(at, bt, policy, pt, ot)
    assert torch.equal(toks, want_toks)
    assert torch.equal(runtime, bt * want_toks.double() ** at)
    assert ops.launch_counts() == {"arepas_runtimes": 0,
                                   "cluster_epoch_step": 0,
                                   "cluster_resize_step": 0,
                                   "policy_decide": 0,
                                   "flash_attention": 0, "ssd_scan": 0}
