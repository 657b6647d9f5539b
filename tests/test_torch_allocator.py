"""The port's float64 torch allocation policies against the reference's
numpy oracles: bitwise-equal tokens over every registered policy x price x
observed/unobserved, with a mix of degenerate (a >= 0) curves."""
import numpy as np
import pytest
import torch

from repro.core.allocator import available_policies as ref_policies
from repro.core.allocator import build_policy as ref_build_policy
from repro.core.allocator import choose_tokens as ref_choose_tokens
from repro.core.allocator import choose_tokens_priced as ref_choose_priced
from repro_torch.core.allocator import (available_policies, build_policy,
                                        choose_tokens_priced_torch,
                                        choose_tokens_torch)


def _params(seed, J=300):
    rng = np.random.RandomState(seed)
    a = -rng.uniform(0.0, 2.5, size=J)
    a[rng.rand(J) < 0.15] = rng.uniform(0.0, 0.3, size=1)   # a >= 0 rows
    a[:3] = [0.0, -0.0, 1e-12]
    b = np.exp(rng.uniform(0, 12, size=J))
    obs = rng.randint(1, 7000, size=J).astype(np.int64)
    return a, b, obs


def test_policy_registry_matches_reference():
    assert available_policies() == ref_policies()
    for name in available_policies():
        assert (dataclass_dict(build_policy(name))
                == dataclass_dict(ref_build_policy(name)))


def dataclass_dict(p):
    return {k: getattr(p, k) for k in ("min_gain", "max_slowdown",
                                       "min_tokens", "max_tokens")}


@pytest.mark.parametrize("observed", [True, False])
@pytest.mark.parametrize("price", [1.0, 1.5, 4.0])
@pytest.mark.parametrize("policy_name", ["default", "marginal_gain",
                                         "bounded_slowdown"])
def test_torch_policy_equals_numpy_oracle(policy_name, price, observed):
    policy = build_policy(policy_name)
    ref_policy = ref_build_policy(policy_name)
    a, b, obs = _params(len(policy_name) * 10 + int(price * 2) + observed)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    obs_t = torch.from_numpy(obs) if observed else None
    priced = choose_tokens_priced_torch(
        at, bt, policy, torch.full_like(at, price), obs_t).numpy()
    want_priced = [ref_choose_priced(a[i], b[i], ref_policy, price,
                                     int(obs[i]) if observed else None)
                   for i in range(len(a))]
    np.testing.assert_array_equal(priced, want_priced)
    if price == 1.0:
        plain = choose_tokens_torch(at, bt, policy, obs_t).numpy()
        want = [ref_choose_tokens(a[i], b[i], ref_policy,
                                  int(obs[i]) if observed else None)
                for i in range(len(a))]
        np.testing.assert_array_equal(plain, want)
        assert plain.dtype == np.int64
