"""PCC — Performance Characteristic Curve (paper §2.1, §4.1).

``runtime = b * A^a`` with a < 0 < b: a two-parameter power law relating token
allocation A to job runtime. Amdahl's law is the a = -1 special case. Fitting
is linear regression in log-log space; monotone non-increase is guaranteed by
construction when the signs of a and b differ.

``PCCScaler`` is the paper's "parameter scaling": NN/GNN heads predict the
*scaled* parameters; decoding maps them back through sign-guaranteeing
bijections (a = -softplus(.), b = exp(.)), so every prediction — however far
off — is a monotonically non-increasing curve. This is what gives NN/GNN the
100% non-increase rows of Tables 4-6.

The numpy fits are copied from the JAX package unchanged; ``fit_pcc_batch``,
``pcc_runtime_torch`` and ``PCCScaler.decode`` are the PyTorch counterparts of
its jnp functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "fit_pcc",
    "fit_pcc_batch",
    "fit_pcc_batch_np",
    "pcc_runtime",
    "pcc_runtime_torch",
    "is_non_increasing",
    "optimal_tokens",
    "PCCScaler",
]


# ------------------------------------------------------------------ fitting --
def fit_pcc(allocs: np.ndarray, runtimes: np.ndarray,
            weights: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """Least-squares power-law fit in log-log space. Returns (a, b).

    allocs/runtimes: (K,) positive. weights: optional per-point weights.
    """
    A = np.log(np.asarray(allocs, np.float64))
    R = np.log(np.maximum(np.asarray(runtimes, np.float64), 1e-9))
    w = np.ones_like(A) if weights is None else np.asarray(weights, np.float64)
    wm = w / np.sum(w)
    Am, Rm = np.sum(wm * A), np.sum(wm * R)
    var = np.sum(wm * (A - Am) ** 2)
    if var < 1e-12:  # single distinct allocation: flat curve through the point
        return 0.0, float(np.exp(Rm))
    a = float(np.sum(wm * (A - Am) * (R - Rm)) / var)
    b = float(np.exp(Rm - a * Am))
    return a, b


def fit_pcc_batch_np(allocs: np.ndarray, runtimes: np.ndarray,
                     weights: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized float64 twin of ``fit_pcc``: (J, K) -> (a (J,), b (J,)).

    Same operations in the same order as the scalar fit, so each row is
    bitwise-identical to ``fit_pcc(allocs[j], runtimes[j])`` — callers can
    batch per-job loops without changing results.
    """
    A = np.log(np.asarray(allocs, np.float64))
    R = np.log(np.maximum(np.asarray(runtimes, np.float64), 1e-9))
    w = np.ones_like(A) if weights is None else np.asarray(weights, np.float64)
    wm = w / np.sum(w, axis=-1, keepdims=True)
    Am = np.sum(wm * A, -1, keepdims=True)
    Rm = np.sum(wm * R, -1, keepdims=True)
    var = np.sum(wm * (A - Am) ** 2, -1)
    cov = np.sum(wm * (A - Am) * (R - Rm), -1)
    a = np.where(var < 1e-12, 0.0, cov / np.maximum(var, 1e-300))
    b = np.where(var < 1e-12, np.exp(Rm[..., 0]),
                 np.exp(Rm[..., 0] - a * Am[..., 0]))
    return a, b


def fit_pcc_batch(allocs: torch.Tensor, runtimes: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched log-log fit in float32 on the tensors' device: (J, K) ->
    (a (J,), b (J,)). ``mask`` (J, K) weighs each point (0 drops it). The
    jnp fit's operations in its order: a row whose weighted allocations
    have no spread (var <= 1e-12) gets a = 0 and b = exp(mean log
    runtime)."""
    A = torch.log(allocs.to(torch.float32))
    R = torch.log(runtimes.to(torch.float32).clamp(min=1e-9))
    w = torch.ones_like(A) if mask is None else mask.to(torch.float32)
    wn = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    Am = (wn * A).sum(-1, keepdim=True)
    Rm = (wn * R).sum(-1, keepdim=True)
    var = (wn * (A - Am) ** 2).sum(-1)
    cov = (wn * (A - Am) * (R - Rm)).sum(-1)
    a = torch.where(var > 1e-12, cov / var.clamp(min=1e-12),
                    torch.zeros_like(var))
    b = torch.exp(Rm[..., 0] - a * Am[..., 0])
    return a, b


def pcc_runtime(a: float, b: float, allocs) -> np.ndarray:
    return b * np.power(np.asarray(allocs, np.float64), a)


def pcc_runtime_torch(a: torch.Tensor, b: torch.Tensor,
                      allocs: torch.Tensor) -> torch.Tensor:
    """b * A^a in a grad-safe form (exp/log), float32 like the reference."""
    return b * torch.exp(a * torch.log(allocs.to(torch.float32)))


def is_non_increasing(a: float, b: float) -> bool:
    """PCC trend check: non-increasing iff signs of a and b differ (§4.1)."""
    return bool(b > 0 and a <= 0) or bool(b < 0 and a >= 0)


# ------------------------------------------------------- optimal allocation --
def optimal_tokens(a: float, b: float, *, gain_threshold: float = 0.01,
                   lo: int = 1, hi: int = 100_000) -> int:
    """Smallest allocation past which marginal gains fall below the threshold.

    The user-facing termination condition of §2.1: stop adding tokens once one
    more token improves runtime by less than ``gain_threshold`` (relative).
    For the power law, |f'(A)|/f(A) = |a|/A, so A* = |a| / gain_threshold.
    """
    if a >= 0:  # degenerate / flat curve: minimum allocation is optimal
        return lo
    a_star = abs(a) / max(gain_threshold, 1e-9)
    return int(np.clip(np.round(a_star), lo, hi))


# ------------------------------------------------------------ target scaling --
@dataclasses.dataclass(frozen=True)
class PCCScaler:
    """Bijective, sign-guaranteeing encoding of (a, b) for model targets.

    encode: za = (softplus^-1(-a) - mu_a) / sd_a ;  zb = (log b - mu_b) / sd_b
    decode: a  = -softplus(za * sd_a + mu_a)     ;  b  = exp(zb * sd_b + mu_b)

    Any (za, zb) in R^2 decodes to a < 0 < b — a monotonically non-increasing
    PCC by construction. mu/sd standardize the two targets so neither
    dominates the LF1 loss (paper §4.5).
    """
    mu_a: float
    sd_a: float
    mu_b: float
    sd_b: float

    @staticmethod
    def _softplus_inv(y: np.ndarray) -> np.ndarray:
        y = np.maximum(y, 1e-6)
        return y + np.log1p(-np.exp(-y))

    @classmethod
    def fit(cls, a: np.ndarray, b: np.ndarray) -> "PCCScaler":
        ra = cls._softplus_inv(-np.asarray(a, np.float64))
        rb = np.log(np.maximum(np.asarray(b, np.float64), 1e-9))
        return cls(float(np.mean(ra)), float(np.std(ra) + 1e-9),
                   float(np.mean(rb)), float(np.std(rb) + 1e-9))

    def encode(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """(N,) a<0, (N,) b>0 -> (N, 2) scaled targets."""
        za = (self._softplus_inv(-np.asarray(a, np.float64)) - self.mu_a) / self.sd_a
        zb = (np.log(np.maximum(np.asarray(b, np.float64), 1e-9)) - self.mu_b) / self.sd_b
        return np.stack([za, zb], -1).astype(np.float32)

    def decode(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., 2) scaled predictions -> (a, b), signs guaranteed.

        softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it
        (``torch.nn.functional.softplus`` returns x itself above 20)."""
        za, zb = z[..., 0], z[..., 1]
        a = -torch.logaddexp(za * self.sd_a + self.mu_a, za.new_zeros(()))
        b = torch.exp(zb * self.sd_b + self.mu_b)
        return a, b

    def decode_np(self, z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        za, zb = np.asarray(z)[..., 0], np.asarray(z)[..., 1]
        a = -np.logaddexp(0.0, za * self.sd_a + self.mu_a)
        b = np.exp(zb * self.sd_b + self.mu_b)
        return a, b
