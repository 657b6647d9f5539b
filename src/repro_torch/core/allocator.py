"""Optimal token allocation from a PCC (paper §1-2, Figure 2/3).

Two allocation policies:
  * marginal-gain cut-off (§2.1): keep adding tokens while each additional
    token still buys >= ``min_gain`` relative runtime improvement; for the
    power law this closes to A* = |a| / min_gain;
  * bounded-slowdown: the smallest allocation whose predicted runtime stays
    within ``max_slowdown`` of the full-allocation runtime — the policy
    behind Figure 2's "5% performance loss" curve.

The numpy oracles (``choose_tokens``, ``choose_tokens_priced``,
``min_tokens_within_slowdown``) and the policy registry are copied from the
JAX package. ``choose_tokens_torch`` / ``choose_tokens_priced_torch`` are
their float64 PyTorch twins: the same fixed 48-step int64 bisection as the
reference's jnp twins, vectorized over (J,) parameter tensors on any device.
They return the oracle's tokens whenever ``pow`` rounds as numpy's does;
PyTorch's CPU ``pow`` and CUDA's double ``pow`` may differ from it in the
last bit, which can only flip a decision where ``b * t**a`` lies within an
ulp or so of the limit. ``choose_tokens_batch`` /
``choose_tokens_priced_batch`` run them on numpy arrays. The serving
layer's decide stages take their policy from ``kernels.ops.policy_decide``:
on the card one launch of kernel K6, which walks the same bisection in a
warp as kernel K3 does and is bitwise equal to these twins; the twins are
its plain version and the CPU path.

``token_reduction_cdf`` reproduces Figure 2 from AREPAS-simulated skylines:
``min_tokens_within_slowdown_torch`` bisects every job at once on the
ragged skyline layout, one AREPAS call (kernel K1 on the card) a round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import arepas
from repro_torch.core.pcc import pcc_runtime
from repro_torch.device import resolve_device

__all__ = ["AllocationPolicy", "available_policies", "build_policy",
           "choose_tokens", "choose_tokens_torch", "choose_tokens_batch",
           "choose_tokens_priced", "choose_tokens_priced_torch",
           "choose_tokens_priced_batch", "min_tokens_within_slowdown",
           "min_tokens_within_slowdown_torch", "register_policy",
           "token_reduction_cdf"]

# Bisection ranges are token counts (< 2^48 by a huge margin); a fixed
# iteration count keeps the search free of host round trips — extra
# iterations are no-ops, exactly like the scalar loop's termination.
_BISECT_ITERS = 48


@dataclasses.dataclass(frozen=True)
class AllocationPolicy:
    min_gain: float = 0.01          # stop when +1 token gains < 1% runtime
    max_slowdown: float = 0.0       # acceptable runtime increase vs full alloc
    min_tokens: int = 1
    max_tokens: int = 6287


# ---------------------------------------------------------- policy registry --
_POLICY_REGISTRY: dict = {}


def register_policy(name: str):
    """``@register_policy("bounded_slowdown")`` exposes a builder —
    ``(**overrides) -> AllocationPolicy`` — to ``build_policy``."""
    def deco(fn):
        _POLICY_REGISTRY[name] = fn
        return fn
    return deco


def build_policy(name: str = "default", **overrides) -> AllocationPolicy:
    """Construct an ``AllocationPolicy`` by registered name; keyword
    overrides win over the preset's fields."""
    if name not in _POLICY_REGISTRY:
        raise KeyError(f"unknown allocation policy {name!r}; "
                       f"known: {sorted(_POLICY_REGISTRY)}")
    return _POLICY_REGISTRY[name](**overrides)


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICY_REGISTRY))


@register_policy("default")
def _default_policy(**overrides) -> AllocationPolicy:
    """Paper defaults: marginal-gain cut-off only."""
    return AllocationPolicy(**overrides)


@register_policy("marginal_gain")
def _marginal_gain_policy(**overrides) -> AllocationPolicy:
    """§2.1 gain cut-off alone (explicitly no slowdown bisection)."""
    overrides.setdefault("max_slowdown", 0.0)
    return AllocationPolicy(**overrides)


@register_policy("bounded_slowdown")
def _bounded_slowdown_policy(**overrides) -> AllocationPolicy:
    """Figure 2's "5% performance loss" operating point."""
    overrides.setdefault("max_slowdown", 0.05)
    return AllocationPolicy(**overrides)


# ------------------------------------------------------------ numpy oracles --
def choose_tokens(a: float, b: float, policy: AllocationPolicy,
                  observed_tokens: Optional[int] = None) -> int:
    """Pick the allocation for a job from its (predicted) PCC parameters.

    Delegates to ``choose_tokens_priced`` at the neutral price — an exact
    no-op (every priced operation multiplies by 1.0).
    """
    return choose_tokens_priced(a, b, policy, 1.0, observed_tokens)


def choose_tokens_priced(a: float, b: float, policy: AllocationPolicy,
                         price: float,
                         observed_tokens: Optional[int] = None) -> int:
    """Cost-aware allocation: ``price`` scales both policy knobs.

    The marginal-gain threshold becomes ``min_gain * price`` (each token must
    buy ``price``-times more runtime to stay worth leasing) and the slowdown
    budget becomes ``max_slowdown * price`` (a pressured class accepts more
    stretch). Both shrink the decision monotonically in ``price``;
    ``price == 1`` is exactly ``choose_tokens``.
    """
    hi = policy.max_tokens if observed_tokens is None else observed_tokens
    eff_gain = max(policy.min_gain, 1e-9) * price
    if a >= 0:   # degenerate / flat curve: minimum allocation is optimal
        t_gain = policy.min_tokens
    else:
        t_gain = int(np.clip(np.round(abs(a) / eff_gain),
                             policy.min_tokens, hi))
    if policy.max_slowdown <= 0:
        return t_gain
    base = pcc_runtime(a, b, hi)
    limit = (1.0 + policy.max_slowdown * price) * base
    lo, hi_s = policy.min_tokens, hi
    while lo < hi_s:                      # smallest A with rt <= limit
        mid = (lo + hi_s) // 2
        if pcc_runtime(a, b, mid) <= limit:
            hi_s = mid
        else:
            lo = mid + 1
    return max(min(t_gain, policy.max_tokens), lo)


# ------------------------------------------------------------- torch twins --
def choose_tokens_torch(a: torch.Tensor, b: torch.Tensor,
                        policy: AllocationPolicy,
                        observed_tokens: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(J,) float64 params -> (J,) int64 tokens: ``choose_tokens`` as a
    vectorized twin, at the neutral price."""
    return choose_tokens_priced_torch(a, b, policy, a.new_ones(()),
                                      observed_tokens)


def choose_tokens_priced_torch(a: torch.Tensor, b: torch.Tensor,
                               policy: AllocationPolicy, price: torch.Tensor,
                               observed_tokens: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """(J,) float64 params and prices -> (J,) int64 tokens:
    ``choose_tokens_priced`` as a vectorized twin. ``observed_tokens`` is an
    optional (J,) integer tensor capping the search per job."""
    dt = a.dtype
    lo0 = policy.min_tokens
    hi = (torch.full(a.shape, policy.max_tokens, dtype=torch.int64,
                     device=a.device)
          if observed_tokens is None else observed_tokens.to(torch.int64))
    eff_gain = max(policy.min_gain, 1e-9) * price
    a_star = torch.abs(a) / eff_gain
    t_gain = torch.round(a_star).clamp(min=lo0).minimum(hi.to(dt))
    t_gain = t_gain.to(torch.int64)
    t_gain = torch.where(a >= 0, lo0, t_gain)
    if policy.max_slowdown <= 0:
        return t_gain

    base = b * hi.to(dt) ** a
    limit = (1.0 + policy.max_slowdown * price) * base
    lo = torch.full(a.shape, lo0, dtype=torch.int64, device=a.device)
    hi_s = hi.clone()
    for _ in range(_BISECT_ITERS):
        cond = lo < hi_s
        mid = (lo + hi_s) // 2
        ok = b * mid.to(dt) ** a <= limit
        lo = torch.where(cond & ~ok, mid + 1, lo)
        hi_s = torch.where(cond & ok, mid, hi_s)
    return torch.maximum(t_gain.clamp(max=policy.max_tokens), lo)


def _host_batch(fn, arrays, observed_tokens, device) -> np.ndarray:
    dev = resolve_device(device)
    args = [torch.from_numpy(np.asarray(x, np.float64)).to(dev)
            for x in arrays]
    obs = (None if observed_tokens is None else torch.from_numpy(
        np.asarray(observed_tokens, np.int64)).to(dev))
    return fn(*args, obs).cpu().numpy()


def choose_tokens_batch(a: np.ndarray, b: np.ndarray,
                        policy: AllocationPolicy = AllocationPolicy(),
                        observed_tokens: Optional[np.ndarray] = None,
                        device: Union[str, torch.device, None] = None
                        ) -> np.ndarray:
    """Batched allocation decisions, equal to a ``choose_tokens`` loop:
    one float64 ``choose_tokens_torch`` call over (J,) parameter arrays, on
    the card unless ``device="cpu"``."""
    return _host_batch(lambda at, bt, obs: choose_tokens_torch(
        at, bt, policy, obs), (a, b), observed_tokens, device)


def choose_tokens_priced_batch(a: np.ndarray, b: np.ndarray,
                               policy: AllocationPolicy, price: np.ndarray,
                               observed_tokens: Optional[np.ndarray] = None,
                               device: Union[str, torch.device, None] = None
                               ) -> np.ndarray:
    """Batched priced decisions, equal to a ``choose_tokens_priced`` loop:
    one float64 ``choose_tokens_priced_torch`` call over (J,)
    parameter/price arrays, on the card unless ``device="cpu"``."""
    return _host_batch(lambda at, bt, pt, obs: choose_tokens_priced_torch(
        at, bt, policy, pt, obs), (a, b, price), observed_tokens, device)


# ---------------------------------------------- Figure 2 (AREPAS bisection) --
def min_tokens_within_slowdown(skyline: np.ndarray, observed_tokens: int,
                               max_slowdown: float) -> int:
    """Smallest allocation whose AREPAS-simulated runtime stays within
    (1 + max_slowdown) of the observed runtime. Exact bisection: AREPAS
    runtime is non-increasing in the allocation."""
    base = len(skyline)
    limit = (1.0 + max_slowdown) * base
    lo, hi = 1, max(observed_tokens, 1)
    while lo < hi:
        mid = (lo + hi) // 2
        if arepas.simulate_runtime(skyline, mid) <= limit:
            hi = mid
        else:
            lo = mid + 1
    return lo


def min_tokens_within_slowdown_torch(values: torch.Tensor,
                                     offsets: torch.Tensor,
                                     observed_tokens: torch.Tensor,
                                     max_slowdown: float) -> torch.Tensor:
    """``min_tokens_within_slowdown`` for every job at once: (J,) int64
    tokens on the tensors' device. The skylines are in the ragged layout
    (flat int32 ``values``, (J + 1) int64 ``offsets``); ``observed_tokens``
    is (J,) integer.

    Each round of the bisection is one ``arepas_runtimes_ragged`` call with
    allocations (J, 1) = max(mid, 1) (kernel K1 on the card); ``lo``,
    ``hi`` and the limit (1 + max_slowdown) * len are int64 / float64, as
    in the reference's jnp twin. It runs at most ``_BISECT_ITERS`` rounds
    and stops once no row is open (one host check a round): a converged
    row never moves again, so the result is the same."""
    from repro_torch.kernels import ops   # here: ops imports this module
    lens = offsets[1:] - offsets[:-1]
    limit = (1.0 + max_slowdown) * lens.to(torch.float64)
    lo = torch.ones_like(lens)
    hi = observed_tokens.to(device=lens.device, dtype=torch.int64).clamp(min=1)
    if hi.numel() and int(hi.max()) > torch.iinfo(torch.int32).max:
        raise ValueError("observed_tokens past int32: AREPAS takes int32 "
                         "allocations")
    for _ in range(_BISECT_ITERS):
        open_ = lo < hi
        if not bool(open_.any()):
            break
        mid = (lo + hi) // 2
        rt = ops.arepas_runtimes_ragged(
            values, offsets, mid.clamp(min=1).to(torch.int32)[:, None])
        ok = rt[:, 0].to(torch.float64) <= limit
        lo = torch.where(open_ & ~ok, mid + 1, lo)
        hi = torch.where(open_ & ok, mid, hi)
    return lo


def token_reduction_cdf(skylines: Sequence[np.ndarray],
                        observed_tokens: Sequence[int],
                        max_slowdown: float = 0.0, grid: int = 101,
                        device: Union[str, torch.device, None] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Figure 2: CDF of potential token-request reduction.

    Returns (reduction_grid in [0,1], fraction of jobs achieving >= r). The
    skylines are packed into the ragged layout once and bisected together
    on ``device`` (the card unless ``"cpu"``)."""
    # imported here: dataset imports this module, through kernels.ops
    from repro_torch.core.dataset import ragged_skylines
    dev = resolve_device(device)
    values, offsets = ragged_skylines(skylines)
    obs = np.asarray(observed_tokens, np.int64)
    best = min_tokens_within_slowdown_torch(
        torch.from_numpy(values).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(obs).to(dev), max_slowdown).cpu().numpy()
    reductions = 1.0 - best / np.maximum(obs, 1)
    r = np.linspace(0, 1, grid)
    frac = (reductions[None, :] >= r[:, None]).mean(1)
    return r, frac
