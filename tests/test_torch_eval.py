"""The paper's evaluation path, port against reference on the CPU:
Figure 2 (``min_tokens_within_slowdown``, its batched twin and
``token_reduction_cdf``), the jnp PCC fit ``fit_pcc_batch``, the host batch
policies, and Table 8 (``ground_truth_records``, ``xgb_point_predictor``
and the rows the reference runner's table8 computes from them).

Tolerances: tokens, reduction fractions, re-executions and the float64
fits are compared for equality; the float32 fit within 1e-5 relative (two
frameworks' float32 logs and sums); Table 8's NN row within 1e-4 (a float32
network in two frameworks, as in ``test_torch_slice.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocator as rall
from repro.core import pcc as rpcc
from repro.core.dataset import build_dataset as ref_build_dataset
from repro.core.evaluate import eval_pcc_model as ref_eval_pcc_model
from repro.core.evaluate import eval_xgb_curves as ref_eval_xgb_curves
from repro.core.featurize import batch_job_features as ref_features
from repro.core.models import NNConfig as RefNNConfig
from repro.core.pipeline import TasqConfig as RefTasqConfig
from repro.core.pipeline import TasqPipeline as RefTasqPipeline
from repro.core.selection import select_jobs as ref_select_jobs
from repro.workloads.executor import observed_skyline as ref_observed_skyline
from repro.workloads.generator import build_corpus as ref_corpus
from repro_torch.core import allocator as al
from repro_torch.core.dataset import build_dataset, ragged_skylines
from repro_torch.core.evaluate import eval_pcc_model, eval_xgb_curves
from repro_torch.core.featurize import batch_job_features
from repro_torch.core.models.convert import model_from_jax
from repro_torch.core.pcc import fit_pcc_batch
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.core.selection import select_jobs
from repro_torch.workloads.executor import observed_skyline
from repro_torch.workloads.generator import build_corpus

SLOWDOWNS = [0.0, 0.05, 0.5]


@pytest.fixture(scope="module")
def fig2_jobs():
    """Skylines and requested tokens of a seed-21 corpus (the runner's fig2
    seed), plus a job asking fewer tokens than its skyline's peak and a
    1-second skyline; the reference's corpus gives the same skylines."""
    jobs = build_corpus(40, seed=21)
    sky = [observed_skyline(j) for j in jobs]
    ref_sky = [ref_observed_skyline(j) for j in ref_corpus(40, seed=21)]
    for s, r in zip(sky, ref_sky):
        np.testing.assert_array_equal(s, r)
    toks = [j.default_tokens for j in jobs]
    peaky = max(range(len(sky)), key=lambda i: int(sky[i].max()))
    sky.append(sky[peaky].copy())
    toks.append(int(sky[peaky].max()) // 3)
    sky.append(np.array([7], np.int64))
    toks.append(12)
    return sky, toks


def _vmapped_jnp_twin(sky, toks, slowdown):
    """``jax.vmap`` of the reference's jnp twin over padded skylines,
    in float64 as the reference runs it."""
    smax = max(len(s) for s in sky)
    pad = np.zeros((len(sky), smax), np.int32)
    for i, s in enumerate(sky):
        pad[i, :len(s)] = s
    with jax.enable_x64(True):
        fn = jax.vmap(lambda s, n, t: rall.min_tokens_within_slowdown_jnp(
            s, n, t, slowdown))
        out = fn(jnp.asarray(pad), jnp.asarray([len(s) for s in sky],
                                                 jnp.int32),
                 jnp.asarray(toks, jnp.int64))
        return np.asarray(out)


@pytest.mark.parametrize("slowdown", SLOWDOWNS)
def test_min_tokens_within_slowdown_matches_reference(fig2_jobs, slowdown):
    """The numpy oracle (copied), the batched twin on the ragged layout
    (plain AREPAS on the CPU) and the reference's oracle and vmapped jnp
    twin all give the same tokens."""
    sky, toks = fig2_jobs
    want = [rall.min_tokens_within_slowdown(s, t, slowdown)
            for s, t in zip(sky, toks)]
    got = [al.min_tokens_within_slowdown(s, t, slowdown)
           for s, t in zip(sky, toks)]
    assert got == want
    values, offsets = ragged_skylines(sky)
    twin = al.min_tokens_within_slowdown_torch(
        torch.from_numpy(values), torch.from_numpy(offsets),
        torch.tensor(toks), slowdown)
    assert twin.dtype == torch.int64
    assert twin.tolist() == want
    np.testing.assert_array_equal(_vmapped_jnp_twin(sky, toks, slowdown),
                                  want)
    assert 1 <= want[-1] <= 7                  # the 1-second skyline
    assert want[-2] <= toks[-2] < int(sky[-2].max())


def test_bisection_makes_one_arepas_call_a_round_and_stops_when_closed(
        fig2_jobs, monkeypatch):
    """Each round is one call over every job, (J, 1) allocations at least
    1; the loop ends when no row is open, after ceil(log2(max tokens))
    rounds at most."""
    from repro_torch.kernels import ops
    sky, toks = fig2_jobs
    values, offsets = ragged_skylines(sky)
    calls = []
    real = ops.arepas_runtimes_ragged

    def counted(v, o, allocs):
        calls.append(allocs.clone())
        return real(v, o, allocs)

    monkeypatch.setattr(ops, "arepas_runtimes_ragged", counted)
    al.min_tokens_within_slowdown_torch(
        torch.from_numpy(values), torch.from_numpy(offsets),
        torch.tensor(toks), 0.05)
    assert 1 <= len(calls) <= int(np.ceil(np.log2(max(toks))))
    for allocs in calls:
        assert allocs.shape == (len(sky), 1) and allocs.dtype == torch.int32
        assert int(allocs.min()) >= 1
    calls.clear()
    al.min_tokens_within_slowdown_torch(
        torch.from_numpy(values[:0]), torch.zeros(1, dtype=torch.int64),
        torch.zeros(0, dtype=torch.int64), 0.0)
    assert calls == []
    with pytest.raises(ValueError, match="int32"):
        al.min_tokens_within_slowdown_torch(
            torch.from_numpy(values), torch.from_numpy(offsets),
            torch.full((len(sky),), 2 ** 31, dtype=torch.int64), 0.0)


@pytest.mark.parametrize("slowdown", [0.0, 0.05])
def test_token_reduction_cdf_is_the_reference_bitwise(fig2_jobs, slowdown):
    sky, toks = fig2_jobs
    r, frac = al.token_reduction_cdf(sky, toks, max_slowdown=slowdown,
                                     device="cpu")
    rr, rfrac = rall.token_reduction_cdf(sky, toks, max_slowdown=slowdown)
    np.testing.assert_array_equal(r, rr)
    np.testing.assert_array_equal(frac, rfrac)
    assert frac.shape == (101,) and frac[0] == 1.0


def _fit_inputs():
    rng = np.random.RandomState(8)
    J, K = 64, 6
    allocs = rng.randint(1, 500, (J, K)).astype(np.float32)
    runtimes = (rng.uniform(10, 1e4, (J, 1))
                * allocs ** -rng.uniform(0.1, 1.5, (J, 1))
                * rng.uniform(0.9, 1.1, (J, K))).astype(np.float32)
    allocs[0] = 37                                      # flat: one allocation
    runtimes[1, 2] = 0.0                                # clamped at 1e-9
    mask = (rng.rand(J, K) < 0.7).astype(np.float32)
    mask[2] = 0
    mask[2, 3] = 1                                      # one valid point
    mask[3] = 0                                         # none
    return allocs, runtimes, mask


@pytest.mark.parametrize("masked", [False, True])
def test_fit_pcc_batch_matches_reference(masked):
    allocs, runtimes, mask = _fit_inputs()
    m = mask if masked else None
    a, b = fit_pcc_batch(torch.from_numpy(allocs), torch.from_numpy(runtimes),
                         None if m is None else torch.from_numpy(m))
    ra, rb = rpcc.fit_pcc_batch(jnp.asarray(allocs), jnp.asarray(runtimes),
                                None if m is None else jnp.asarray(m))
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=1e-5)
    assert float(a[0]) == 0.0 and float(np.asarray(ra)[0]) == 0.0
    if masked:
        assert float(a[2]) == 0.0 and float(a[3]) == 0.0


def _policy_inputs(seed, J=400):
    rng = np.random.RandomState(seed)
    a = -rng.uniform(0.0, 2.5, J)
    a[rng.rand(J) < 0.15] = 0.1
    b = np.exp(rng.uniform(0, 12, J))
    obs = rng.randint(1, 7000, J).astype(np.int64)
    price = np.where(np.arange(J) % 3 == 0, 1.5, 1.0)
    return a, b, obs, price


@pytest.mark.parametrize("observed", [True, False])
@pytest.mark.parametrize("policy_name", ["default", "bounded_slowdown"])
def test_batch_policies_equal_the_reference_scalar_loop(policy_name,
                                                        observed):
    """The reference's batch wrappers need ``jax.experimental.enable_x64``,
    gone from the installed jax, so the port's are held to the loop of the
    reference's scalar oracles their docstrings promise to equal."""
    a, b, obs, price = _policy_inputs(len(policy_name) + observed)
    policy = al.build_policy(policy_name)
    rpolicy = rall.build_policy(policy_name)
    o = obs if observed else None
    got = al.choose_tokens_batch(a, b, policy, o, device="cpu")
    want = [rall.choose_tokens(a[i], b[i], rpolicy,
                               int(obs[i]) if observed else None)
            for i in range(len(a))]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    got = al.choose_tokens_priced_batch(a, b, policy, price, o, device="cpu")
    want = [rall.choose_tokens_priced(a[i], b[i], rpolicy, price[i],
                                      int(obs[i]) if observed else None)
            for i in range(len(a))]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- Table 8 ---
SIZE = dict(n_train=120, n_eval=40)


@pytest.fixture(scope="module")
def table8():
    """The runner's table8 at a sixth of its size: a 100-job seed-61 pool,
    tokens 10-500, 20 selected (seed 1); the reference pipeline trains
    gbdt and nn, the port's pipeline trains its own gbdt and carries the
    nn across."""
    rp = RefTasqPipeline(RefTasqConfig(nn=RefNNConfig(epochs=4), **SIZE))
    rp.build()
    rp.train("gbdt")
    rp.train("nn")
    pp = TasqPipeline(TasqConfig(**SIZE), device="cpu")
    pp.build()
    pp.train("gbdt")
    pp.models["nn:lf2"] = model_from_jax(rp.models["nn:lf2"], device="cpu")
    jobs, rjobs = build_corpus(100, seed=61), ref_corpus(100, seed=61)
    feats = batch_job_features(jobs)
    toks = np.array([j.default_tokens for j in jobs])
    mask = (toks >= 10) & (toks <= 500)
    idx = select_jobs(feats, feats, mask, n_target=20, seed=1).indices
    ridx = ref_select_jobs(ref_features(rjobs), ref_features(rjobs), mask,
                           n_target=20, seed=1).indices
    np.testing.assert_array_equal(idx, ridx)
    return rp, pp, [jobs[i] for i in idx], [rjobs[i] for i in idx]


def test_ground_truth_records_equal_reference(table8):
    rp, pp, sel, rsel = table8
    got = pp.ground_truth_records(sel)
    want = rp.ground_truth_records(rsel)
    assert len(got) == len(want) == len(sel) > 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["job"].job_id == w["job"].job_id
        for k in ("allocs", "runtimes"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        assert len(g["skylines"]) == len(w["skylines"]) == 4
        for s, t in zip(g["skylines"], w["skylines"]):
            np.testing.assert_array_equal(s, t)
        assert type(g["a"]) is type(w["a"]) is float
        assert (g["a"], g["b"]) == (w["a"], w["b"])


def _gt_dataset(build, recs, sel, n_nodes, **kw):
    ds = build(sel, seed=99, n_max_nodes=n_nodes, **kw)
    return dataclasses.replace(
        ds,
        target_a=np.array([min(r["a"], -1e-4) for r in recs], np.float32),
        target_b=np.array([max(r["b"], 1e-3) for r in recs], np.float32),
        observed_alloc=np.array([r["allocs"][0] for r in recs], np.float32),
        observed_runtime=np.array([r["runtimes"][0] for r in recs],
                                  np.float32))


def test_table8_rows_match_reference(table8):
    """The runner's table8 rows on the re-executed ground truth: XGBoost-SS
    through ``xgb_point_predictor`` and XGBoost-PL (the GBDT, a numpy copy:
    equal) and the NN (within 1e-4)."""
    rp, pp, sel, rsel = table8
    n_nodes = rp.train_set.graph_features.shape[1]
    gt = _gt_dataset(build_dataset, pp.ground_truth_records(sel), sel,
                     n_nodes, device="cpu")
    rgt = _gt_dataset(ref_build_dataset, rp.ground_truth_records(rsel), rsel,
                      n_nodes)
    f, rf = pp.xgb_point_predictor(), rp.xgb_point_predictor()
    alloc = np.full(len(gt), 50.0, np.float32)
    np.testing.assert_array_equal(f(gt.features, alloc),
                                  rf(rgt.features, alloc))
    args = (gt.observed_alloc, gt.observed_runtime, gt.target_a, gt.target_b)
    rows = {"xgboost_ss": eval_xgb_curves(f, gt.features, *args, mode="ss"),
            "xgboost_pl": eval_pcc_model(pp.models["gbdt"], gt),
            "nn": eval_pcc_model(pp.models["nn:lf2"], gt)}
    rargs = (rgt.observed_alloc, rgt.observed_runtime, rgt.target_a,
             rgt.target_b)
    rrows = {"xgboost_ss": ref_eval_xgb_curves(rf, rgt.features, *rargs,
                                               mode="ss"),
             "xgboost_pl": ref_eval_pcc_model(rp.models["gbdt"], rgt),
             "nn": ref_eval_pcc_model(rp.models["nn:lf2"], rgt)}
    for name in ("xgboost_ss", "xgboost_pl"):
        assert rows[name].row() == rrows[name].row(), name
    got, want = dataclasses.asdict(rows["nn"]), dataclasses.asdict(rrows["nn"])
    assert got["pattern_non_increase"] == want["pattern_non_increase"]
    for k in ("mae_curve_params", "median_ae_runtime"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
