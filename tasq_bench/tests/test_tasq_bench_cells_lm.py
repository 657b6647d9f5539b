"""The LM cell ``granite-h-small-chat``: its cell and configuration files
against ``BENCHMARK.json`` and the port's configuration, and tiny CPU runs
of its window kind (``lm_batches``) at the smoke config's size: a sound
run is correct and traces, the control and two planted kernel faults are
not, and a checkout whose port lacks the architecture stops at set-up."""
import json
from pathlib import Path

import pytest

import tasq_bench_tiny
from tasq_bench import harness

BENCH = Path(__file__).resolve().parents[1]
CELL = "granite-h-small-chat"
TINY = {"arch": "granite-4.0-h-small-smoke", "batch_size": 4,
        "prompt_len": 32, "median_len": 16, "min_len": 4,
        "max_new_tokens": 4}


def _files():
    cell = harness.load_json(BENCH / "cells" / f"{CELL}.json")
    config = harness.load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell, config


def _run(monkeypatch, **kw):
    from tasq_bench.drivers import lm_batches
    monkeypatch.setattr(lm_batches, "POOL_BATCHES", 3)
    cell, config = _files()
    cell["limits"]["min_rows"] = 1
    ctx = harness.Context(cell=cell, config=config, seed=tasq_bench_tiny.SEED,
                          seconds=0.3, t0=0.0, device="cpu", size=TINY,
                          **{"trace": False, **kw})
    res = harness.run_cell(ctx)
    return all(c.ok for c in res.checks) and res.failed == 0, res, ctx


def test_files_agree_with_the_manifest_and_the_port():
    from repro_torch.configs import get_config
    m = harness.manifest()
    work = {w["name"]: w for w in m["workloads"]}[CELL]
    cell, config = _files()
    assert (cell["config"], cell["traffic"], cell["kind"]) == (
        work["config"], work["traffic"], "lm_batches")
    assert work["chips"] == 1
    entry = {c["name"]: c for c in m["configs"]}[cell["config"]]
    assert entry["file"] == f"tasq_bench/configs/{cell['config']}.json"
    assert set(entry["reduced"]) == {"num_hidden_layers", "layer_types",
                                     "weights"}
    pub = config["published"]
    assert config["num_hidden_layers"] == len(config["layer_types"]) == 20
    assert config["layer_types"] == pub["layer_types"][:20]
    assert pub["num_hidden_layers"] == len(pub["layer_types"]) == 40
    full = get_config(config["arch"])
    assert full.layer_types == tuple(pub["layer_types"])
    assert (full.d_model, full.num_experts, full.experts_per_token,
            full.d_ff, full.shared_expert_ff, full.vocab_size) == (
        config["hidden_size"], config["num_local_experts"],
        config["num_experts_per_tok"], config["intermediate_size"],
        config["shared_intermediate_size"], config["vocab_size"])
    assert full.attention_scale == config["attention_multiplier"]
    assert full.residual_multiplier == config["residual_multiplier"]
    assert full.embedding_multiplier == config["embedding_multiplier"]
    assert full.logits_scaling == config["logits_scaling"]
    assert CELL in {e["name"]: e for e in m["end_to_end"]}[
        "events_per_s"]["workloads"]
    lm = [e for e in m["per_layer"] if e["name"].endswith(".lm")]
    assert len(lm) == 9 and all(e["workloads"] == [CELL] for e in lm)
    assert json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_sound_run_is_correct_and_traces(monkeypatch):
    ok, res, ctx = _run(monkeypatch, trace=True)
    assert ok, [(c.name, c.value, c.limit) for c in res.checks]
    assert res.metrics["events_per_s"] > 0 and res.attempted >= 4
    assert res.extra["window"]["tokens_kept"] == 4 * res.extra[
        "window"]["batches"] * TINY["max_new_tokens"]
    per = harness.read_per_layer(ctx)
    # the CPU records spans and counters, but no device time or profile
    for name in ("pad_share.lm", "expert_imbalance.lm", "decode_host_ms.lm",
                 "step_mfu.lm"):
        assert name in per, name
    for name in ("prefill_ms.lm", "k4_roofline.lm", "k5_roofline.lm"):
        assert name not in per, name


def test_control_is_not_correct(monkeypatch):
    ok, res, _ = _run(monkeypatch, control=True)
    assert not ok
    assert {c.name: c.ok for c in res.checks}["logit_gap_mean"] is False


def _kv_start_ignored(k4):
    def fault(q, k, v, **kw):
        kw.pop("kv_start", None)
        return k4(q, k, v, **kw)
    return fault


def _state_zeroed(k5):
    def fault(*args, **kw):
        out = k5(*args, **kw)
        return (out[0], out[1].zero_()) if kw.get("final_state") else out
    return fault


@pytest.mark.parametrize("name,fault", [
    ("flash_attention", _kv_start_ignored), ("ssd_scan", _state_zeroed)])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    """K4 ignoring a row's start (the padded rows' first positions move)
    and K5's final state zeroed (every decode position moves) fail the
    check; sound runs pass it (above)."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, name, fault(getattr(ops, name)))
    ok, res, _ = _run(monkeypatch)
    assert not ok
    assert {c.name: c.ok for c in res.checks}["logit_gap"] is False


def test_a_port_without_the_architecture_stops_at_set_up(monkeypatch):
    from repro_torch import configs
    from tasq_bench.drivers import lm_batches
    monkeypatch.setattr(configs, "PORT_ARCH_MODULES", {})
    drawn = []
    monkeypatch.setattr(lm_batches, "_requests",
                        lambda *a: drawn.append(a))
    with pytest.raises(KeyError):
        _run(monkeypatch)
    assert not drawn
