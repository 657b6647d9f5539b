"""Kernel K5's contract on the CPU, and the gradients of both
differentiable kernel wrappers (K4, K5).

The port's plain version ``ssd_chunked`` (and ``ops.ssd_scan`` on CPU
tensors) against the reference's Pallas kernel ``ssd_chunk_scan`` run in
interpret mode and against the sequential oracle ``ssd_ref``, on the same
numpy-seeded inputs, drawn as the reference's kernel test draws them.

Tolerances: 2e-5 in float32 and 5e-2 in bf16, the reference's own
(``tests/test_kernels.py``): the chunked form takes exp of differences of
a cumulative sum of dt * A that reaches ~-300 at Q = 256, where one
float32 ulp is 3e-5, so two summation orders of the same formula differ
by a few 1e-5 relative. Gradients: 1e-4, as the reference's gradient
test states it. The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro.kernels import ssd_scan as ref_ssd_scan
from repro.kernels.ref import ssd_ref as ref_ssd_ref
from repro.kernels.ssd import ssd_chunk_scan
from repro.models.layers import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.ssd import ssd_chunk_scan as port_kernel
from repro_torch.models.layers import ssd_chunked

# (B, S, H, P, N, chunk): the reference test's SSD_SHAPES
SSD_SHAPES = [
    (1, 128, 2, 32, 64, 64),
    (2, 256, 4, 64, 128, 128),
    (2, 512, 1, 16, 32, 128),
    (1, 256, 3, 64, 64, 256),          # single chunk == S
]
# zamba2-2.7b's and mamba2-1.3b's head shapes (H, P, N, Q) at S 256
MODEL_SHAPES = [(1, 256, 80, 64, 64, 128), (1, 256, 64, 64, 128, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(shape, seed):
    """x normal; dt softplus(normal); A -exp(normal / 2); B, C normal /
    sqrt(N); float32 numpy."""
    B, S, H, P, N, _ = shape
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) / np.sqrt(N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _cast(arrays, dtype_name, lib):
    """x, B and C in the working type; dt and A stay float32."""
    jdt, tdt, _ = DTYPES[dtype_name]
    out = []
    for i, a in enumerate(arrays):
        if lib == "jax":
            out.append(jnp.asarray(a, jdt if i in (0, 3, 4) else jnp.float32))
        else:
            t = torch.from_numpy(a)
            out.append(t.to(tdt) if i in (0, 3, 4) else t)
    return out


@functools.lru_cache(maxsize=None)
def _pallas(shape, dtype_name):
    """The reference's Pallas kernel in interpret mode, float32 numpy."""
    args = _cast(_inputs(shape, sum(shape)), dtype_name, "jax")
    out = ssd_chunk_scan(*args, chunk=shape[5], interpret=True)
    assert out.dtype == DTYPES[dtype_name][0]
    return np.asarray(out.astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


CASES = [(s, d) for s in SSD_SHAPES for d in DTYPES]


@pytest.mark.parametrize("shape,dtype_name", CASES)
def test_plain_version_matches_pallas_kernel(shape, dtype_name):
    args = _cast(_inputs(shape, sum(shape)), dtype_name, "torch")
    y, h = ssd_chunked(*args, min(shape[5], shape[1]))
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert h.dtype == torch.float32 and h.shape == (shape[0], shape[2],
                                                    shape[3], shape[4])
    _close(y, _pallas(shape, dtype_name), DTYPES[dtype_name][2])


@pytest.mark.parametrize("shape,dtype_name", CASES)
def test_ops_wrapper_on_cpu_matches_pallas_kernel(shape, dtype_name):
    args = _cast(_inputs(shape, sum(shape)), dtype_name, "torch")
    got = ops.ssd_scan(*args, chunk=shape[5])
    _close(got, _pallas(shape, dtype_name), DTYPES[dtype_name][2])


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_plain_version_matches_sequential_oracle(shape):
    """The chunked form against the step-by-step recurrence, and the
    port's oracle against the reference's (float32)."""
    arrays = _inputs(shape, sum(shape))
    t = _cast(arrays, "float32", "torch")
    want = ssd_ref(*t)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(ref_ssd_ref(*_cast(arrays, "float32",
                                                     "jax"))),
        atol=1e-5, rtol=1e-5)
    _close(ssd_chunked(*t, min(shape[5], shape[1]))[0], want.numpy(), 2e-5)


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_model_head_shapes_match_pallas_kernel(shape):
    """zamba2's 80 heads of 64 over state 64, mamba2's 64 over 128, at a
    CPU-sized sequence: the plain version and the final state against the
    reference's chunked layer and its Pallas kernel."""
    arrays = _inputs(shape, sum(shape))
    t = _cast(arrays, "float32", "torch")
    j = _cast(arrays, "float32", "jax")
    y, h = ssd_chunked(*t, shape[5])
    ry, rh = ref_ssd_chunked(*j, shape[5])
    _close(y, np.asarray(ry), 2e-5)
    _close(h, np.asarray(rh), 2e-5)
    _close(y, _pallas(shape, "float32"), 2e-5)


def test_chunk_must_divide_the_sequence():
    args = _cast(_inputs((1, 96, 2, 16, 16, 64), 0), "float32", "torch")
    with pytest.raises(ValueError, match="multiple"):
        ssd_chunked(*args, 64)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the host: only ``ops.ssd_scan``
    takes the plain version, and only for CPU tensors."""
    args = _cast(_inputs((1, 64, 2, 16, 16, 64), 0), "float32", "torch")
    with pytest.raises(ValueError, match="runs on the card"):
        port_kernel(*args, chunk=64)


def test_decay_is_never_exponentiated_above_the_diagonal():
    """dt * A of -200 a step: exp(cs_i - cs_j) for i < j would be +inf, and
    inf * 0 NaN. The plain version (and its gradient) stays finite."""
    shape = (1, 64, 2, 16, 16, 64)
    x, dt, A, Bm, Cm = _inputs(shape, 4)
    dt[:] = 200.0
    A[:] = -1.0
    t = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    y = ops.ssd_scan(*t, chunk=64)
    assert bool(torch.isfinite(y).all())
    grads = torch.autograd.grad(y.sum(), t)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# -------------------------------------------------------------- gradients ---
def _vjp_both(port_fn, ref_fn, arrays, seed):
    """Gradients of sum(out * w) through the port (autograd) and through
    the reference (``jax.vjp``), float32, same inputs and cotangent."""
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = port_fn(*t)
    w = np.random.RandomState(seed).standard_normal(
        tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad(out, t, torch.from_numpy(w))
    ref_out, vjp = jax.vjp(ref_fn, *(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=2e-5, rtol=2e-5)
    return got, vjp(jnp.asarray(w))


@pytest.mark.parametrize("shape", [(2, 256, 2, 32, 64, 64),
                                   (1, 128, 3, 16, 32, 128)])
def test_ssd_scan_gradients_match_reference(shape):
    """``ops.ssd_scan``'s backward (autograd of the recomputed plain
    version) against ``jax.vjp`` of the reference's ``ops.ssd_scan``
    (``custom_vjp`` through ``ssd_chunked``), for x, dt, A, B and C."""
    arrays = _inputs(shape, 11)
    chunk = shape[5]
    got, want = _vjp_both(
        lambda *a: ops.ssd_scan(*a, chunk=chunk),
        lambda *a: ref_ssd_scan(*a, chunk=chunk), arrays, 12)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 128, 2, 2, 32), (2, 128, 4, 2, 32),
                                   (1, 128, 4, 4, 80)])
def test_flash_attention_gradients_match_reference(shape):
    """``ops.flash_attention``'s backward against ``jax.vjp`` of the
    reference's ``ops.flash_attention`` (``custom_vjp`` through
    ``attention_ref_bhsd``): MHA as the reference's test, GQA, and
    zamba2's head dim 80 with Hq == Hkv. (B, S, Hq, Hkv, D)."""
    B, S, Hq, Hkv, D = shape
    rng = np.random.RandomState(13)
    arrays = [rng.standard_normal((B, S, h, D)).astype(np.float32)
              for h in (Hq, Hkv, Hkv)]
    got, want = _vjp_both(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
        lambda q, k, v: ref_flash(q, k, v, causal=True, block_q=128,
                                  block_k=128), arrays, 14)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
