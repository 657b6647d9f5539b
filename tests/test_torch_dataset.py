"""The port's ``build_dataset`` (one bulk AREPAS call) against the
reference's (one oracle call per job and allocation): equal field by
field on the same seeded corpus."""
import numpy as np
import pytest

from repro.core.dataset import build_dataset as ref_build_dataset
from repro.workloads import build_corpus as ref_build_corpus
from repro_torch.core.dataset import build_dataset
from repro_torch.workloads import build_corpus

ARRAY_FIELDS = ("features", "graph_features", "graph_adj", "graph_mask",
                "observed_alloc", "observed_runtime", "target_a", "target_b",
                "xgb_X", "xgb_y", "xgb_job")
RECORD_FIELDS = ("skyline", "observed_tokens", "observed_runtime",
                 "peak_usage", "aug_allocs", "aug_runtimes", "pcc_a", "pcc_b")


@pytest.mark.parametrize("noise_sigma,seed", [(0.0, 0), (0.15, 3)])
def test_dataset_equals_reference(noise_sigma, seed):
    jobs = build_corpus(60, seed=7)
    ref_jobs = ref_build_corpus(60, seed=7)
    n_nodes = max(len(j.operators) for j in jobs)
    port = build_dataset(jobs, noise_sigma=noise_sigma, seed=seed,
                         n_max_nodes=n_nodes, device="cpu")
    ref = ref_build_dataset(ref_jobs, noise_sigma=noise_sigma, seed=seed,
                            n_max_nodes=n_nodes)
    assert len(port) == len(ref) == 60
    for name in ARRAY_FIELDS:
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for rp, rr in zip(port.records, ref.records):
        assert rp.job.job_id == rr.job.job_id
        for name in RECORD_FIELDS:
            got, want = getattr(rp, name), getattr(rr, name)
            assert np.asarray(got).dtype == np.asarray(want).dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    # the AREPAS grid really went below the observed peak for most jobs
    below = sum(int(np.any(r.aug_runtimes > r.observed_runtime))
                for r in port.records)
    assert below > 30
