"""The benchmark's plain reference against the port at a small size, on
the same inputs: AREPAS runtimes, the allocation policy, the PCC models'
decoded parameters, the epoch step, the elastic resize and the cache
refit."""
import numpy as np
import torch

import tasq_bench_tiny                                      # noqa: F401
from tasq_bench import weights
from tasq_bench.reference import arepas, featurize
from tasq_bench.reference import cluster as ref_cluster
from tasq_bench.reference import model as ref_model
from tasq_bench.reference import policy as ref_policy
from tasq_bench.traffic.build import make_trace

CFG = {"nn": {"family": "nn", "model": {"hidden": [32, 16]}},
       "gnn": {"family": "gnn",
               "model": {"gcn_dims": [64, 64, 32], "head_hidden": [16]}}}
POLICY = ref_policy.Policy()


def _trace():
    return make_trace({"n_unique": 24}, 7, 50)


def test_arepas_and_refit_equal_the_port():
    from repro_torch.core.arepas import simulate_runtime
    from repro_torch.cluster.pcc_cache import PCCCache
    tr = _trace()
    for s in tr.skylines[:12]:
        for a in (1, 3, int(s.max()), int(s.max()) + 1):
            assert arepas.runtime(s, a) == simulate_runtime(s, a)
    sky = tr.skylines
    U, smax = len(sky), max(len(s) for s in sky)
    pool = np.zeros((U, smax), np.int32)
    for u, s in enumerate(sky):
        pool[u, :len(s)] = s
    obs = np.array([j.default_tokens for j in tr.jobs])
    peaks = pool.max(1)
    rows = np.arange(U)
    a, b = PCCCache(device="cpu").refine_batch(
        rows, torch.from_numpy(pool), torch.from_numpy(
            np.array([len(s) for s in sky], np.int32)), obs, peaks,
        rows=rows, areas=pool.sum(1).astype(np.float64))
    ra, rb = ref_cluster.refit(sky, obs, peaks)
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(b, rb)


def test_policy_equals_the_port_oracle():
    from repro_torch.core.allocator import (AllocationPolicy,
                                            choose_tokens_priced)
    rng = np.random.RandomState(0)
    a = -rng.uniform(0.05, 1.5, 300)
    b = np.exp(rng.uniform(2, 9, 300))
    obs = rng.randint(1, 3000, 300)
    price = rng.choice([1.0, 1.5, 4.0], 300)
    got = ref_policy.choose_tokens(a, b, obs, POLICY, price)
    pp = AllocationPolicy(max_slowdown=0.05)
    want = [choose_tokens_priced(a[i], b[i], pp, price[i], int(obs[i]))
            for i in range(300)]
    np.testing.assert_array_equal(got, want)


def test_models_decode_as_the_port():
    tr = _trace()
    for fam, cfg in CFG.items():
        tensors, w = weights.draw(cfg, 11, "cpu")
        scaler = weights.make_scaler(tr.skylines,
                                     [j.default_tokens for j in tr.jobs])
        mu, sd = weights.make_standardizer(
            featurize.batch_job_features(tr.jobs))
        weights.calibrate(tensors, w, tr.jobs, mu, sd)
        model = weights.program_model(cfg, tensors, scaler, mu, sd, "cpu")
        if fam == "nn":
            x = {"features": featurize.batch_job_features(tr.jobs)}
            z = ref_model.nn_z(x["features"], mu, sd, w)
        else:
            f, adj, m = featurize.batch_graphs(tr.jobs)
            x = {"features": f, "adj": adj, "mask": m}
            z = ref_model.gnn_z(f, adj, m, w)
        a, b = model.predict_params_batch(x)
        ra, rb = ref_model.decode(z, scaler)
        np.testing.assert_allclose(a, ra, rtol=1e-5)
        np.testing.assert_allclose(b, rb, rtol=1e-5)
        assert np.all(ra < 0) and np.all(np.isfinite(rb))


def test_cluster_steps_equal_the_port_plain_versions():
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.kernels.cluster_step import (epoch_step_ref,
                                                  resize_step_ref)
    rng = np.random.RandomState(3)
    K, L, Q, now = 4, 64, 16, 100.0
    live = rng.rand(K, L) < 0.6
    tok = np.where(live, rng.randint(1, 50, (K, L)), 0).astype(np.int64)
    end = np.where(live, now + rng.randint(-20, 40, (K, L)), np.inf)
    args = [torch.from_numpy(x) for x in (
        end, tok, np.array([30, 0, 500, 7], np.int64),
        rng.randint(0, 40, (K, Q)).astype(np.int64),
        now + rng.randint(1, 90, (K, Q)).astype(np.float64))]
    for g, w in zip(ref_cluster.epoch_step(*args, now),
                    epoch_step_ref(*args, now)):
        assert torch.equal(g, w)
    tr = _trace()
    C = 10
    a = -rng.uniform(0.1, 1.0, C)
    b = np.exp(rng.uniform(3, 8, C))
    price = rng.choice([1.0, 4.0], C)
    obs = np.array([j.default_tokens for j in tr.jobs[:C]])
    floor = rng.randint(1, 5, C)
    done = rng.uniform(0, 0.9, C)
    cand_tok, cand_end = obs.copy(), now + rng.uniform(10, 500, C)
    sky = tr.skylines[:C]
    smax = max(len(s) for s in sky)
    pad = np.zeros((C, smax), np.int32)
    for i, s in enumerate(sky):
        pad[i, :len(s)] = s
    want = resize_step_ref(
        *(torch.from_numpy(np.asarray(x)) for x in (
            a, b, price, obs, floor, done, cand_tok, cand_end)),
        torch.from_numpy(pad), torch.tensor([len(s) for s in sky],
                                            dtype=torch.int32),
        now, 15.0, policy=AllocationPolicy(max_slowdown=0.05), cap=6000)
    got = ref_cluster.resize(a, b, price, obs, floor, done, cand_tok,
                             cand_end, sky, now, 15.0, POLICY, 6000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
