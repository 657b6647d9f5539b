"""The LM cell's per-layer readers on a made-up trace: each reads what its
docstring says, and returns None where the run gave it nothing; and the
LM bounds (``bounds/lm.py``) grow with the work."""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

import tasq_bench_tiny                                      # noqa: F401
from tasq_bench.bounds import lm as bounds

BENCH = Path(__file__).resolve().parents[1]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "tasq_bench_test_metric_lm", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, t0, t1, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, depth=0, attrs=attrs)


TRACED = {
    "spans": [_span("lm.batch", 0.0, 3.0),
              _span("lm.prefill", 0.0, 1.0, device_ms=900.0),
              _span("lm.moe", 0.1, 0.2, layer=0, device_ms=300.0),
              _span("lm.decode", 1.0, 1.004, step=0, device_ms=20.0),
              _span("lm.moe", 1.0, 1.001, layer=0, device_ms=8.0),
              _span("lm.decode", 1.004, 1.010, step=1, device_ms=30.0),
              _span("lm.moe", 1.004, 1.005, layer=0, device_ms=12.0)],
    "counters": {"lm_pad_tokens": 40, "lm_prompt_tokens": 60,
                 "moe_slots": 720, "moe_max_expert_slots": 30},
    "num_experts": 72, "run_window_s": 2.0,
    "kernel_s": {"void tc::flash_attention_tc<128>(...)": 0.004,
                 "void tc::ssd_tc<64, 128>(...)": 0.002,
                 "void simt::ssd_kernel<float, 16, 16>(...)": 0.002},
    "bound_s": {"K4": 0.001, "K5": 0.002},
    "model_flops": 989.4e12,
}
WANT = {"prefill_ms.lm": 900.0, "decode_step_ms.lm": 25.0,
        "decode_host_ms.lm": 5.0, "moe_share.lm": 100.0 * 320 / 950,
        "expert_imbalance.lm": 3.0, "pad_share.lm": 40.0,
        "k4_roofline.lm": 25.0, "k5_roofline.lm": 50.0,
        "step_mfu.lm": 50.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    read = _reader(name)
    assert read(SimpleNamespace(traced=TRACED)) == pytest.approx(WANT[name])
    assert read(SimpleNamespace(traced={})) is None


def test_every_lm_reader_is_tested():
    names = {p.name[:-3] for p in (BENCH / "metrics").glob("*.lm.py")}
    assert names == set(WANT)


@dataclasses.dataclass
class _Cfg:
    d_model: int = 64
    resolved_head_dim: int = 16
    num_heads: int = 4
    num_kv_heads: int = 2
    ssm_expand: int = 2
    ssm_state: int = 16
    ssm_heads: int = 8
    ssm_head_dim: int = 16
    ssm_conv: int = 4
    num_experts: int = 8
    experts_per_token: int = 2
    d_ff: int = 32
    shared_expert_ff: int = 48
    vocab_size: int = 256
    layer_types: tuple = ("mamba", "attention")


def test_bounds_grow_with_the_work():
    # K4: a row of n live positions has n (n + 1) / 2 pairs, 4 D ops each
    assert bounds.k4_flops(4, 1, 8, [0]) == 4 * 8 * 10
    assert bounds.k4_flops(4, 1, 8, [4]) == 0
    assert bounds.k4_seconds(2, 2048, 32, 8, 128, [0, 0]) > \
        bounds.k4_seconds(2, 2048, 32, 8, 128, [1024, 0])
    # the pad rows' q, k and v are not needed; their o rows are written
    full = bounds.k4_bytes(2, 2048, 32, 8, 128, [0, 0])
    assert full == 2 * 2 * 2048 * 128 * (2 * 32 + 2 * 8)
    assert full - bounds.k4_bytes(2, 2048, 32, 8, 128, [1024, 0]) == \
        2 * 1024 * 128 * (32 + 2 * 8)
    assert bounds.k5_seconds(2, 4096, 128, 64, 128, 256) > \
        bounds.k5_seconds(2, 2048, 128, 64, 128, 256)
    assert bounds.k5_flops(1, 256, 1, 64, 128, 256) == \
        256 * 257 * 192 + 4 * 256 * 128 * 64
    cfg = _Cfg()
    assert bounds.request_flops(cfg, 100, 8) > bounds.request_flops(cfg, 50, 8)
    assert bounds.request_flops(cfg, 50, 9) > bounds.request_flops(cfg, 50, 8)
    # the head once a kept token, the layers once a token fed back
    head = 2 * 256 * 64
    per = bounds.layer_token_flops(cfg)
    one = bounds.request_flops(cfg, 1, 1)
    assert one == per["mamba"] + per["attention"] + 4 * 4 * 16 + head
