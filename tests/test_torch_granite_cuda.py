"""The hybrid_moe family's kernel arguments on the card: K4 with a softmax
scale and per-row ``kv_start`` (left-padding), K5 with its final state,
each against its plain PyTorch version, and granite-4.0-h-small's smoke
config served on the card against the float32 plain reference.

Needs an NVIDIA card and nvcc: marked ``cuda``, and each test decides
inside itself whether a card is present, so it skips on CPU-only hosts.
Run on the card with
``python -m pytest -m cuda tests/test_torch_granite_cuda.py``.

Tolerances are those of ``tests/test_torch_kernels_cuda.py`` for the
kernels (float32: 2e-5, sums in another order; bf16: 2e-2 for K4 and
5e-2 for K5, bf16's rounding of p and of x o dt w before the tensor-core
products); the SSD state in bf16 is held to 5e-2 of its largest
magnitude, the same rounding summed over a chunk.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
K4_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
K5_TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _attn_plain(q, k, v, scale, kv_start):
    from repro_torch.kernels.ref import attention_ref_bhsd
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return attention_ref_bhsd(qt, kt, vt, causal=True, scale=scale,
                              kv_start=kv_start).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 2048, 32, 8, 128),
                                   (3, 300, 4, 2, 64)])
def test_k4_scale_and_kv_start_equal_plain_version(shape, dtype):
    """granite's attention (Hq 32 over Hkv 8, D 128, scale 1/128) and a
    ragged S: starts 0, inside a tile, on a tile edge and past every
    query; the rows before a start are 0 in both."""
    _need_card()
    B, S, Hq, Hkv, D = shape
    g = torch.Generator("cuda").manual_seed(S)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda").to(dt)
               for h in (Hq, Hkv, Hkv))
    start = torch.tensor([0, 127, 128, S][:B], dtype=torch.int32,
                         device="cuda")
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, scale=1 / 128,
                              kv_start=start)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = _attn_plain(q, k, v, 1 / 128, start)
    tol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for b in range(B):
        assert not got[b, :int(start[b])].any()
    # the defaults are today's call
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       ops.flash_attention(q, k, v, causal=True, scale=None,
                                           kv_start=None))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1024, 128, 64, 128, 256),
                                   (2, 512, 8, 64, 64, 128),
                                   (1, 256, 4, 16, 16, 64)])
def test_k5_final_state_equals_plain_version(shape, dtype):
    """granite's scan (H 128, P 64, N 128, Q 256) and two others: y and
    the final (B, H, P, N) state against ``ssd_chunked``'s."""
    _need_card()
    from repro_torch.models.layers import ssd_chunked
    B, S, H, P, N, Q = shape
    g = torch.Generator("cuda").manual_seed(S + H)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    dt = getattr(torch, dtype)
    args = [rnd(B, S, H, P).to(dt),
            torch.nn.functional.softplus(rnd(B, S, H) - 3.0),
            -torch.exp(rnd(H) * 0.5), (rnd(B, S, N) / N ** 0.5).to(dt),
            (rnd(B, S, N) / N ** 0.5).to(dt)]
    before = ops.launch_counts()["ssd_scan"]
    y, h = ops.ssd_scan(*args, chunk=Q, final_state=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    y_want, h_want = ssd_chunked(*args, min(Q, S))
    tol = K5_TOL[dtype]
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    scale = float(h_want.abs().max())
    torch.testing.assert_close(h, h_want, atol=tol * scale, rtol=tol)
    assert torch.equal(ops.ssd_scan(*args, chunk=Q), y)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_granite_smoke_served_on_card_equals_the_reference(impl):
    """The smoke config in float32 through ``Server.run`` on the card, the
    kernels' float32 paths under "pallas": every generated position's
    logits against the plain reference's full forward of the unpadded
    request (teacher-forced on the served tokens), within 1e-4 of the
    logits' spread (float32 sums in other orders, the kernels' included)."""
    _need_card()
    sys.path.insert(0, str(ROOT))
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import model_api
    from tasq_bench.reference import granite_hybrid as R
    cfg = dataclasses.replace(get_config("granite-4.0-h-small-smoke"),
                              attention_impl=impl, ssd_impl=impl)
    p = model_api.init(cfg, torch.Generator("cuda").manual_seed(3))
    rng = np.random.RandomState(3)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, n).astype(np.int32), 6)
            for i, n in enumerate((64, 23, 40))]
    seen = []
    server = Server(cfg, ServeConfig(batch_size=3, prompt_len=64,
                                     max_len=70), p)
    dec = server._decode

    def record(params, batch, **kw):
        logits, cache = dec(params, batch, **kw)
        seen.append(logits.float().cpu())
        return logits, cache

    server._decode = record
    out = server.run(reqs)
    weights = R.tree_weights(p, cfg.layer_types)
    dims = R.dims(dataclasses.asdict(cfg))
    for i, r in enumerate(reqs):
        toks = np.concatenate([r.prompt, out[r.request_id][:-1]])
        want = R.forward(torch.from_numpy(toks).cuda(), weights, dims)
        got = torch.stack([s[i] for s in seen])
        assert R.logit_gap(got, want[-len(seen):].cpu()) < 1e-4
