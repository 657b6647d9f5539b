"""``run.py`` as the benchmark's driver calls it: without the cards a
cell asks for, or without the port beside it, it exits non-zero and
prints no result; on a card (marked ``cuda``) a short run of a cell is
correct and its last line carries every key the contract reads."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tasq_bench_tiny import card                             # noqa: F401

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "nn-cluster-recurring", "--seed", "4294967311",
        "--seconds", "2", "--trace", "0"]


def _run(cwd, timeout=120):
    return subprocess.run([sys.executable, "tasq_bench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_result_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tasq_bench", tmp_path / "tasq_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    r = _run(ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"events_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
