"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

``run.py`` calls ``main``. Everything that belongs to one configuration,
one cell or one per-layer metric is found by name: the configuration's
file is the one ``BENCHMARK.json`` gives, the cell's traffic and limits
are in ``cells/<cell>.json``, its window kind is a driver in
``drivers/<kind>.py`` and each per-layer metric is read by
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number or None).

A driver's ``run(ctx)`` builds the program's system from the seed, warms
every shape the cell uses, measures for ``ctx.seconds`` and then holds
what the window produced against the reference. It returns a ``Result``.
With ``--trace 1`` it also fills ``ctx.traced`` (spans, counters, the
device profile, the recorded launches), from which the per-layer readers
take their numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

# top-level module names the measured process may not hold once the window
# has closed: the JAX stack and the JAX package the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})

# how long a traced run profiles the device: a closed-loop window its first
# seconds, an open-loop window its last (its sender never waits on the
# profiler)
PROFILE_S = 2.0


@dataclasses.dataclass
class Check:
    """One number compared with its limit: at most ``limit``, or at least
    it where ``at_least``."""
    name: str
    value: float
    limit: float
    at_least: bool = False

    @property
    def ok(self) -> bool:
        if self.at_least:
            return self.value >= self.limit
        return self.value <= self.limit


@dataclasses.dataclass
class Result:
    attempted: int
    failed: int
    metrics: Dict[str, float]            # end-to-end, by name
    checks: List[Check]
    memory_peak_bytes: int
    extra: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    cell: Dict                           # cells/<name>.json
    config: Dict                         # the configuration's file
    seed: int
    seconds: float
    trace: bool
    t0: float                            # process start (host clock)
    device: str = "cuda"
    control: bool = False                # judge the control, not the program
    fault: Optional[str] = None          # a planted fault (tests only)
    size: Optional[Dict] = None          # overrides of the traffic (tests)
    traced: Dict = dataclasses.field(default_factory=dict)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_context(name: str, seed: int, seconds: float, trace: bool,
                 t0: float, **kw) -> Context:
    bench = manifest()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = load_json(HERE / "cells" / f"{name}.json")
    config = load_json(ROOT / cfg_entry["file"])
    if cell["config"] != w["config"] or cell["traffic"] != w["traffic"]:
        raise SystemExit(f"cells/{name}.json disagrees with BENCHMARK.json")
    return Context(cell=cell, config=config, seed=seed, seconds=seconds,
                   trace=trace, t0=t0, **kw)


def run_cell(ctx: Context) -> Result:
    driver = importlib.import_module(f"tasq_bench.drivers.{ctx.cell['kind']}")
    return driver.run(ctx)


# ------------------------------------------------------------- metrics --
def _reports(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def end_to_end_names(cell: str) -> List[str]:
    return [m["name"] for m in manifest()["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def read_per_layer(ctx: Context) -> Dict[str, Dict]:
    """Every per-layer metric of the cell, from its reader; a reader that
    finds nothing returns None and its metric is left out."""
    bench = manifest()
    name = ctx.cell["name"]
    e2e = end_to_end_names(name)
    out = {}
    for m in bench["per_layer"]:
        if not _reports(m, name, e2e):
            continue
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "tasq_bench_metric_" + m["name"].replace(".", "_").replace(
                "-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# -------------------------------------------------------------- device --
def device_info(count: int, memory_peak_bytes: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory_peak_bytes)}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only the first run of a cell there builds."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="judge the reference in the next lower precision "
                        "in the program's place (not part of a benchmark "
                        "run)")
    args = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port's package src/repro_torch is not in this checkout",
              file=sys.stderr)
        return 2
    _set_cache_dirs()
    import torch
    ctx = cell_context(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0, control=bool(args.control))
    bench = {w["name"]: w for w in manifest()["workloads"]}
    chips = int(bench[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    res = run_cell(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"the measured process loaded {bad}", file=sys.stderr)
        return 3
    if ctx.trace:
        metrics = read_per_layer(ctx)
    else:
        metrics = {m["name"]: {"value": res.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in manifest()["end_to_end"]
                   if m["name"] in end_to_end_names(args.workload)}
    line = {"correct": all(c.ok for c in res.checks) and res.failed == 0,
            "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics,
            "device": device_info(chips, res.memory_peak_bytes)}
    if ctx.trace:
        line["device"]["busy_s"] = ctx.traced["busy_s"]
        line["device"]["window_s"] = ctx.traced["window_s"]
        line["breakdown"] = ctx.traced["breakdown"]
    line.update(res.extra)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                               "at_least": c.at_least}
                      for c in res.checks}
    for c in res.checks:
        print(f"check {c.name} = {c.value!r} ("
              f"{'at least' if c.at_least else 'limit'} {c.limit!r})"
              f"{'' if c.ok else '  FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
