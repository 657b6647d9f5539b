"""Multi-pod dry run on a fake process group.

The port of ``repro.launch.dryrun``. For every (architecture x input-shape
x mesh) cell:
  1. build the production mesh (``launch.mesh``) over a ``fake`` process
     group of the mesh's size (256 or 512 ranks in one process);
  2. run the train/prefill/decode step once on DTensors of ``FakeTensor``s
     on the CPU device (zero allocation) with the state, parameter and
     batch placements of ``train.steps``: every DTensor op must have a
     sharding strategy and every redistribute a collective, or the trace
     raises, as an XLA compile fails on a bad sharding;
  3. count rank 0's local program while it runs
     (``roofline.LocalProgramCounter``): FLOPs, bytes and collectives per
     chip, as the reference's per-partition HLO gives them, and the peak
     of live fake bytes;
  4. write the reference's record: memory, costs, collectives and the
     three-term roofline on the H100's data-sheet rates.

The process owns its process group, as the reference's owns
``XLA_FLAGS``: one process has one default group, and ``lower_cell``
raises in a process whose group is not ``fake`` of the mesh's size
(``main`` starts one child per mesh size for ``--multi-pod both``). The
kernels' CUDA branch is never taken: the tensors are on the CPU device,
and, as in the reference's dry run, every config's ``attention_impl`` and
``ssd_impl`` is ``"xla"``.

Calibration, kept from the reference: its roofline costs come from 1- and
2-unit probes (``grad_accum=1``; the hybrid's unit is ``attn_period``; the
encoder-decoder probes encoder and decoder depth apart) extrapolated
linearly, cost(L) = cost(1u) + (L/u - 1) * (cost(2u) - cost(1u)). XLA
counts a scan body once, so the reference needs them; the port's trace
is unrolled, so its full-depth gate trace counts every layer already
(``gate_cost_analysis``), and the probes must agree with it.

Memory: ``argument_size_in_bytes`` is the local shard bytes of the
inputs; ``temp_size_in_bytes`` the peak of live fake bytes made during
the step less its new outputs; ``output_size_in_bytes`` the local bytes
of the outputs, ``alias_size_in_bytes`` those updated in place (the
train state, a decode cache). An estimate from tensor lifetimes, not
XLA's buffer assignment. ``lower_s`` is the gate trace's seconds; nothing
is compiled (``compile_s`` 0).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, ModelConfig,
                                 cell_is_runnable, get_config, get_shape)
from repro_torch.launch.mesh import make_production_mesh, mesh_chips, mesh_name
from repro_torch.models import model_api
from repro_torch.roofline import model_flops
from repro_torch.roofline.analysis import LocalProgramCounter, roofline_terms
from repro_torch.train.steps import (batch_shardings, make_decode_step,
                                     make_prefill_step, make_train_step,
                                     state_leaves, train_state_from_params)

__all__ = ["init_fake_group", "trace_cell", "calibrated_costs", "lower_cell",
           "main"]


def init_fake_group(world_size: int) -> None:
    """This process's default group: ``fake`` of ``world_size`` ranks, this
    one rank 0. Raises if a default group exists already or the backend
    is missing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _check_group(chips: int) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"the dry run needs a fake process group of "
                           f"{chips} ranks (init_fake_group)")
    backend, world = dist.get_backend(), dist.get_world_size()
    if backend != "fake" or world != chips:
        raise RuntimeError(f"the dry run needs a fake process group of "
                           f"{chips} ranks; this process has {backend!r} "
                           f"of {world}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree) -> float:
    total = 0
    for t in _leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return float(total)


def _fake_dtensors(specs, placements, mesh):
    """``meta`` specs as DTensors of fake tensors with ``placements``."""
    from torch.distributed.tensor import empty as dt_empty
    if isinstance(specs, dict):
        return {k: _fake_dtensors(specs[k], placements[k], mesh)
                for k in specs}
    if isinstance(specs, model_api.Cache):
        return model_api.Cache(**{
            f.name: _fake_dtensors(t, getattr(placements, f.name), mesh)
            for f in dataclasses.fields(specs)
            if (t := getattr(specs, f.name)) is not None})
    return dt_empty(specs.shape, dtype=specs.dtype, device_mesh=mesh,
                    placements=placements)


def trace_cell(cfg: ModelConfig, shape, mesh) -> Tuple[Dict[str, Any],
                                                       Dict[str, float], float]:
    """Run one step on fake DTensors under a ``LocalProgramCounter``.
    Returns (costs {"flops", "bytes", "coll", "coll_bytes"}, memory
    analysis, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    batch_sh = batch_shardings(cfg, shape, mesh)
    # the mesh's own rank tensors are real: let them in
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_dtensors(model_api.specs(cfg),
                                model_api.shardings(cfg, mesh), mesh)
        batch = _fake_dtensors(model_api.input_specs(cfg, shape), batch_sh,
                               mesh)
        if shape.kind == "train":
            state = train_state_from_params(params)
            step, args = make_train_step(cfg, mesh), (state, batch)
            arg_bytes = _local_bytes(state_leaves(state)) + _local_bytes(batch)
        elif shape.kind == "prefill":
            step, args = make_prefill_step(cfg, mesh), (params, batch)
            arg_bytes = _local_bytes(params) + _local_bytes(batch)
        else:
            step, args = make_decode_step(cfg, mesh), (params, batch)
            arg_bytes = _local_bytes(params) + _local_bytes(batch)
        counter = LocalProgramCounter()
        t0 = time.time()
        with counter:
            out = step(*args)
        seconds = time.time() - t0
        if shape.kind == "train":
            aliased = _local_bytes(state_leaves(out[0]))
            out_bytes = aliased + _local_bytes(out[1])
        elif shape.kind == "decode":
            aliased = _local_bytes(args[1]["cache"])
            out_bytes = _local_bytes(out)
        else:
            aliased = 0.0
            out_bytes = _local_bytes(out)
    fresh = out_bytes - aliased
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": float(max(counter.peak_bytes - fresh, 0.0)),
           "generated_code_size_in_bytes": 0.0,
           "alias_size_in_bytes": aliased}
    costs = {"flops": counter.flops, "bytes": counter.bytes,
             "coll": {k: dict(v) for k, v in counter.collectives.items()},
             "coll_bytes": counter.collective_bytes}
    return costs, mem, seconds


def _extrapolate(base: Dict, *deltas: Tuple[Dict, float]) -> Dict:
    """cost(full) = cost(base probe) + sum_i n_extra_i * (probe_i - base)."""
    out = {"flops": base["flops"], "bytes": base["bytes"],
           "coll_bytes": base["coll_bytes"], "coll": {}}
    for k in ("flops", "bytes", "coll_bytes"):
        for d, n in deltas:
            out[k] += n * max(d[k] - base[k], 0.0)
    for kind in base["coll"]:
        b = base["coll"][kind]["bytes"]
        c = base["coll"][kind]["count"]
        for d, n in deltas:
            b += n * max(d["coll"][kind]["bytes"] - base["coll"][kind]["bytes"], 0.0)
            c += n * max(d["coll"][kind]["count"] - base["coll"][kind]["count"], 0)
        out["coll"][kind] = {"bytes": b, "count": c}
    return out


def calibrated_costs(cfg: ModelConfig, shape, mesh) -> Dict[str, Any]:
    """1-unit/2-unit probe traces -> full-depth roofline costs, with the
    probes at ``grad_accum=1`` (N microbatches of B/N tokens do the work
    of one full-batch step)."""
    cfg = dataclasses.replace(cfg, grad_accum=1)
    if cfg.family == "encdec":
        mk = lambda e, d: dataclasses.replace(
            cfg, encoder_layers=e, num_layers=d, scan_layers=False)
        c11 = trace_cell(mk(1, 1), shape, mesh)[0]
        c21 = trace_cell(mk(2, 1), shape, mesh)[0]
        c12 = trace_cell(mk(1, 2), shape, mesh)[0]
        return _extrapolate(c11,
                            (c21, cfg.encoder_layers - 1),
                            (c12, cfg.num_layers - 1))
    unit = cfg.attn_period if cfg.family == "hybrid" else 1
    mk = lambda L: dataclasses.replace(cfg, num_layers=L, scan_layers=False)
    c1 = trace_cell(mk(unit), shape, mesh)[0]
    c2 = trace_cell(mk(2 * unit), shape, mesh)[0]
    return _extrapolate(c1, (c2, cfg.num_layers / unit - 1))


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               cfg_override: Optional[ModelConfig] = None,
               calibrate: bool = True, optimized: bool = False,
               mesh=None) -> Dict[str, Any]:
    """Trace one cell; return the reference's dry-run/roofline record.
    ``mesh`` (default: the production mesh) must span the process's
    fake group."""
    cfg = (cfg_override if cfg_override is not None
           else get_config(arch, optimized=optimized, multi_pod=multi_pod))
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why,
                "mesh": "2x16x16" if multi_pod else "16x16"}
    if mesh is None:
        _check_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    _check_group(chips)
    name = mesh_name(mesh)

    gate_costs, mem, t_trace = trace_cell(cfg, shape, mesh)
    costs = calibrated_costs(cfg, shape, mesh) if calibrate else gate_costs
    mf = model_flops(cfg, shape)
    rep = roofline_terms(
        arch=arch, shape=shape_name, mesh=name, chips=chips,
        hlo_flops=costs["flops"], hlo_bytes=costs["bytes"],
        coll_bytes=costs["coll_bytes"], model_flops=mf,
        bytes_per_device=float(mem.get("argument_size_in_bytes", 0.0))
        + float(mem.get("temp_size_in_bytes", 0.0)))
    return {
        "arch": arch, "shape": shape_name, "mesh": name, "chips": chips,
        "kind": shape.kind,
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "cost_analysis": {"flops": costs["flops"],
                          "bytes_accessed": costs["bytes"]},
        "gate_cost_analysis": {"flops": gate_costs["flops"],
                               "bytes_accessed": gate_costs["bytes"]},
        "memory_analysis": mem,
        "collectives": costs["coll"],
        "collective_bytes": costs["coll_bytes"],
        "model_flops": mf,
        "calibrated": calibrate,
        "roofline": rep.row(),
        "remat": cfg.remat_policy,
        "attention_impl": cfg.attention_impl,
        "overrides": dict(cfg.sharding_overrides),
    }


def _run_cells(cells, multi_pod: bool, out_dir: str, optimized: bool) -> int:
    """Trace ``cells`` in this process (its group: fake of the mesh's
    size); returns the count of failures."""
    init_fake_group(512 if multi_pod else 256)
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}|{shape}|{'2x16x16' if multi_pod else '16x16'}"
        t0 = time.time()
        try:
            rec = lower_cell(arch, shape, multi_pod=multi_pod,
                             optimized=optimized)
        except Exception as e:
            failures += 1
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if multi_pod else "16x16",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
        else:
            if "skipped" in rec:
                print(f"[skip] {tag}: {rec['skipped']}", flush=True)
            else:
                r = rec["roofline"]
                print(f"[ ok ] {tag}: trace {rec['lower_s']}s "
                      f"cell {time.time() - t0:.1f}s "
                      f"step {r['step_ms']}ms dominant={r['dominant']} "
                      f"useful={r['useful_flops_frac']} "
                      f"bytes/dev={r['bytes_per_device_gb']}GB", flush=True)
        if out_dir:
            fn = f"{arch}_{shape}_{rec.get('mesh', 'NA')}.json".replace("/", "-")
            with open(os.path.join(out_dir, fn), "w") as f:
                json.dump(rec, f, indent=1)
    dist.destroy_process_group()
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--multi-pod", choices=("on", "off", "both"), default="off")
    ap.add_argument("--out", default="", help="directory for JSON records")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-arch OPT_PACKS")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if args.multi_pod == "both":      # one process (one group) per mesh
        failed = False
        for mp in ("off", "on"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--multi-pod", mp, "--out", args.out]
            cmd += ["--all"] if args.all else ["--arch", args.arch,
                                               "--shape", args.shape]
            cmd += ["--optimized"] if args.optimized else []
            failed |= subprocess.run(cmd).returncode != 0
        if failed:
            raise SystemExit("dry-run cell(s) failed")
        return
    failures = _run_cells(cells, args.multi_pod == "on", args.out,
                          args.optimized)
    if failures:
        raise SystemExit(f"{failures} dry-run cell(s) failed")


if __name__ == "__main__":
    main()
