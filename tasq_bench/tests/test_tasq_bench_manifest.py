"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
sources against its isolation rules: names, units and lengths use only
the allowed characters; every configuration, cell and per-layer metric
has its file; no module of the benchmark imports the JAX stack or the
JAX package (top-level names compared whole, so ``repro_torch`` passes),
and the reference imports nothing of the port."""
import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _names():
    m = MANIFEST
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            yield e["name"]
    for w in m["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in m["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_units_texts_and_keys():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = m["end_to_end"] + m["per_layer"]
    for e in metrics:
        assert UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher"), e
    for e in m["configs"] + m["workloads"]:
        assert TEXT.match(e["why"]), e
    for e in m["per_layer"]:
        assert TEXT.match(e["layer"]) and e["moves"] in {
            x["name"] for x in m["end_to_end"]}, e
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for word in m["command"]:
        assert TEXT.match(word) and not word.startswith("/")
    assert 1 <= m["run_seconds"] <= 51
    assert len({e["name"] for e in metrics}) == len(metrics)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_has_its_file():
    m = MANIFEST
    for c in m["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"]), c
    for path in sorted((BENCH / "cells").glob("*.json")):
        cell = json.loads(path.read_text())
        assert cell["name"] == path.stem
        assert (BENCH / "configs" / f"{cell['config']}.json").is_file()
    for w in m["workloads"]:
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                      w["traffic"])
        assert (BENCH / "drivers" / f"{cell['kind']}.py").is_file()
        assert w["chips"] == 1
    for e in m["per_layer"]:
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file(), e
        for w in e.get("workloads", []):
            assert w in {x["name"] for x in m["workloads"]}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_port_in_reference(path):
    tops = set(_imports(path))
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in tops, path
