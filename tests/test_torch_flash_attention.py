"""Kernel K4's contract on the CPU: the port's ``ops.flash_attention`` (the
plain version, on CPU tensors) and ``attention_ref_bhsd`` against the
reference's Pallas kernel ``flash_attention_bhsd`` run in interpret mode,
on the same seeded inputs.

Tolerances: 2e-5 in float32 (two float32 softmax-attention computations
that sum in different orders: the online softmax of the Pallas body
against a dense softmax) and 2e-2 in bf16 (both compute in float32 and
round the output to bf16 once: at most one bf16 step apart), as the
reference's own kernel test states them. The kernel itself runs only on
the card (``tests/test_torch_kernels_cuda.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash_bshd
from repro.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.ref import attention_ref_bhsd

# (B, Hq, Hkv, S, D, block_q, block_k): the reference test's ATTN_SHAPES,
# then one minitron-8b head shape at a CPU-sized sequence
ATTN_SHAPES = [
    (1, 2, 2, 128, 64, 128, 128),      # MHA
    (2, 4, 2, 256, 64, 128, 128),      # GQA group 2
    (1, 8, 1, 256, 128, 128, 128),     # MQA
    (2, 4, 4, 512, 32, 256, 128),      # rectangular blocks
]
MINITRON_HEADS = (1, 32, 8, 512, 128, 512, 512)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed):
    B, Hq, Hkv, S, D = shape[:5]
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, h, S, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


@functools.lru_cache(maxsize=None)
def _reference(shape, causal, dtype_name):
    """The Pallas kernel in interpret mode, as float32 numpy (B, Hq, S, D)."""
    jdt = DTYPES[dtype_name][0]
    q, k, v = (jnp.asarray(x, jdt) for x in _inputs(shape, len(shape)))
    out = flash_attention_bhsd(q, k, v, causal=causal, block_q=shape[5],
                               block_k=shape[6], interpret=True)
    assert out.dtype == jdt
    return np.asarray(out.astype(jnp.float32))


def _port_inputs(shape, dtype_name):
    tdt = DTYPES[dtype_name][1]
    return [torch.from_numpy(x).to(tdt) for x in _inputs(shape, len(shape))]


CASES = [(s, c, d) for s in ATTN_SHAPES for c in (True, False)
         for d in DTYPES] + [(MINITRON_HEADS, True, "float32")]


@pytest.mark.parametrize("shape,causal,dtype_name", CASES)
def test_plain_version_matches_pallas_kernel(shape, causal, dtype_name):
    q, k, v = _port_inputs(shape, dtype_name)
    got = attention_ref_bhsd(q, k, v, causal=causal)
    tol = DTYPES[dtype_name][2]
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               _reference(shape, causal, dtype_name),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,causal,dtype_name", CASES)
def test_ops_wrapper_on_cpu_matches_pallas_kernel(shape, causal, dtype_name):
    """The (B, S, H, D) wrapper on CPU tensors: the plain version through
    the reference wrapper's layout."""
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _port_inputs(shape, dtype_name))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == q.dtype
    tol = DTYPES[dtype_name][2]
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(),
                               _reference(shape, causal, dtype_name),
                               atol=tol, rtol=tol)


def test_bshd_layout_matches_reference_wrapper():
    """ops.flash_attention keeps the reference wrapper's (B, S, H, D)."""
    rng = np.random.RandomState(1)
    q = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 64)).astype(np.float32)
    want = np.asarray(ref_flash_bshd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     block_q=128, block_k=128,
                                     interpret=True))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_kernel_wrapper_takes_only_card_tensors():
    """On the host there is no kernel: the kernel wrapper raises, and the
    public wrapper refuses devices it has no path for."""
    q = torch.zeros((1, 8, 2, 16))
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="runs on the card"):
        flash_attention_bshd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(*(torch.zeros((1, 8, 2, 16), device="meta"),) * 3)
    assert ops.launch_counts()["flash_attention"] == before


def test_roofline_bound_is_the_larger_term():
    """K4's bound at the LM slice's prefill is its operations at the bf16
    tensor-core rate; a row without operations (K1-K3) keeps the bytes
    term alone."""
    from repro_torch.roofline import H100, kernel_roofline
    B, Hq, Hkv, S, D = 8, 32, 8, 2048, 128
    n_bytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    n_ops = 4 * B * Hq * D * S * S / 2
    k4 = kernel_roofline("flash_attention", launches=2,
                         bytes_per_launch=n_bytes, wall_s=0.02,
                         flops_per_launch=n_ops)
    assert k4.bound_s == 2 * n_ops / H100.bf16_tensor_flops
    assert abs(k4.bound_s / 2 * 1e3 - 0.27794) < 1e-4
    k2 = kernel_roofline("cluster_epoch_step", launches=93,
                         bytes_per_launch=1376448, wall_s=0.05)
    assert k2.bound_s == 93 * 1376448 / H100.hbm_bw
    assert "flops_per_launch" not in k2.row()
