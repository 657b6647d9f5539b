"""The first slice end to end, port against reference on the CPU:
corpus -> bulk AREPAS -> datasets -> trained model -> ``decide``.

Reference decisions are rebuilt from the reference's own pieces
(``serve_apply`` -> ``scaler.decode`` -> float64 -> numpy ``choose_tokens``),
which is what its fused service computes.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.allocator import build_policy as ref_build_policy
from repro.core.allocator import choose_tokens as ref_choose_tokens
from repro.core.allocator import choose_tokens_priced as ref_choose_priced
from repro.core.evaluate import eval_pcc_model as ref_eval_pcc_model
from repro.core.models import NNConfig as RefNNConfig
from repro.core.pipeline import TasqConfig as RefTasqConfig
from repro.core.pipeline import TasqPipeline as RefTasqPipeline
from repro_torch.api import (AllocationRequest, Allocator, AllocatorConfig,
                             DecisionContext, Provenance)
from repro_torch.core.allocator import build_policy
from repro_torch.core.evaluate import eval_pcc_model
from repro_torch.core.models import NNConfig
from repro_torch.core.models.convert import model_from_jax
from repro_torch.core.pipeline import TasqConfig, TasqPipeline
from repro_torch.serve import AllocationService

SIZE = dict(n_train=120, n_eval=40, gnn_epochs=2)
POLICY = "bounded_slowdown"


@pytest.fixture(scope="module")
def ref():
    p = RefTasqPipeline(RefTasqConfig(nn=RefNNConfig(epochs=4), **SIZE))
    p.build()
    for family in ("nn", "gnn", "gbdt"):
        p.train(family)
    return p


def _allocator(model):
    return Allocator(AllocationService(model, build_policy(POLICY),
                                       device="cpu"))


def _ref_fused_tokens(ref_model, ds, observed):
    inputs = {k: jnp.asarray(v) for k, v in ref_model.batch_inputs(ds).items()}
    a, b = ref_model.scaler.decode(ref_model.serve_apply(ref_model.params,
                                                         inputs))
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    policy = ref_build_policy(POLICY)
    return a64, b64, np.array([ref_choose_tokens(a64[i], b64[i], policy,
                                                 int(observed[i]))
                               for i in range(len(a64))])


@pytest.mark.parametrize("key", ["nn:lf2", "gnn:lf2"])
def test_decide_matches_reference_fused_math(ref, key):
    ref_model = ref.models[key]
    model = model_from_jax(ref_model, device="cpu")
    ds = ref.eval_set
    observed = np.asarray(ds.observed_alloc, np.int64)
    d = _allocator(model).decide(AllocationRequest.from_dataset(model, ds))
    a64, b64, want = _ref_fused_tokens(ref_model, ds, observed)
    # float32 forward in two frameworks: see test_torch_models.py
    np.testing.assert_allclose(d.a, a64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.b, b64, rtol=1e-5)
    np.testing.assert_array_equal(d.tokens, want)
    assert np.all(d.provenance == Provenance.MODEL)
    np.testing.assert_allclose(d.runtime, b64 * want.astype(float) ** a64,
                               rtol=1e-4)


@pytest.mark.parametrize("observed", [True, False])
def test_history_and_priced_paths_match_oracle(ref, observed):
    model = model_from_jax(ref.models["nn:lf2"], device="cpu")
    alloc = _allocator(model)
    ds = ref.eval_set
    obs = np.asarray(ds.observed_alloc, np.int64)
    price = np.where(np.arange(len(ds)) % 2 == 0, 1.5, 4.0)
    ctx = DecisionContext(price=price, observed=observed)
    policy = ref_build_policy(POLICY)
    cap = lambda i: int(obs[i]) if observed else None

    hist = alloc.decide(AllocationRequest.from_params(ds.target_a,
                                                      ds.target_b, obs), ctx)
    want = [ref_choose_priced(float(ds.target_a[i]), float(ds.target_b[i]),
                              policy, price[i], cap(i))
            for i in range(len(ds))]
    np.testing.assert_array_equal(hist.tokens, want)
    assert np.all(hist.provenance == Provenance.HISTORY)
    np.testing.assert_array_equal(hist.price, price)

    fused = alloc.decide(AllocationRequest.from_dataset(model, ds), ctx)
    want = [ref_choose_priced(float(fused.a[i]), float(fused.b[i]), policy,
                              price[i], cap(i)) for i in range(len(ds))]
    np.testing.assert_array_equal(fused.tokens, want)
    assert np.all(fused.provenance == Provenance.MODEL)


def test_port_pipeline_end_to_end(ref):
    """``Allocator.from_config`` on the CPU: datasets equal the reference's,
    its decisions are the oracle's, the GBDT host path decides as the
    reference's GBDT, ``evaluate`` gives the reference's XGBoost rows, and
    LF3 trains from the GBDT teacher."""
    cfg = AllocatorConfig(pipeline=TasqConfig(nn=NNConfig(epochs=4), **SIZE))
    alloc = Allocator.from_config(cfg, device="cpu")
    pipe = alloc.pipeline
    for mine, theirs in ((pipe.train_set, ref.train_set),
                         (pipe.eval_set, ref.eval_set)):
        for name in ("features", "target_a", "target_b", "xgb_X", "xgb_y"):
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(theirs, name))
    ds = pipe.eval_set
    obs = np.asarray(ds.observed_alloc, np.int64)
    d = alloc.decide(AllocationRequest.from_dataset(alloc.model, ds))
    policy = ref_build_policy(POLICY)
    np.testing.assert_array_equal(
        d.tokens, [ref_choose_tokens(float(d.a[i]), float(d.b[i]), policy,
                                     int(obs[i])) for i in range(len(ds))])

    # GBDT: numpy on both sides, same data and seed -> the same (a, b)
    gbdt = pipe.train("gbdt")
    dg = _allocator(gbdt).decide(AllocationRequest.from_dataset(gbdt, ds))
    ra, rb = ref.models["gbdt"].predict_params(ref.eval_set)
    np.testing.assert_array_equal(dg.a, ra)
    np.testing.assert_array_equal(dg.b, rb)
    np.testing.assert_array_equal(
        dg.tokens, [ref_choose_tokens(ra[i], rb[i], policy, int(obs[i]))
                    for i in range(len(ds))])

    got, want = pipe.evaluate(ds, "lf2"), ref.evaluate(ref.eval_set, "lf2")
    assert set(got) == {"xgboost_ss", "xgboost_pl", "nn"} <= set(want)
    assert got["xgboost_ss"].row() == want["xgboost_ss"].row()
    assert got["xgboost_pl"].row() == want["xgboost_pl"].row()

    lf3 = pipe.train("nn", loss="lf3")
    assert np.all(np.isfinite(lf3.history["loss"]))
    a3, b3 = lf3.predict_params(ds)
    assert np.all(a3 <= 0) and np.all(b3 > 0)


def test_trained_port_model_within_band_of_reference():
    """Training quality, not bitwise: inits come from different generators
    (torch.Generator vs jax.random). At 120 jobs and the default 60 epochs
    the seed-to-seed spread of either package is about 0.06 in curve-param
    MAE and 0.05 in median runtime AE; the band is a little over twice
    that."""
    ref_p = RefTasqPipeline(RefTasqConfig(**SIZE)).build()
    port_p = TasqPipeline(TasqConfig(**SIZE), device="cpu").build()
    want = ref_eval_pcc_model(ref_p.train("nn"), ref_p.eval_set)
    got = eval_pcc_model(port_p.train("nn"), port_p.eval_set)
    assert got.pattern_non_increase == want.pattern_non_increase == 1.0
    assert abs(got.mae_curve_params - want.mae_curve_params) <= 0.15
    assert abs(got.median_ae_runtime - want.median_ae_runtime) <= 0.10


def test_sharded_fabric_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        Allocator.from_config(AllocatorConfig(n_shards=2), device="cpu")
