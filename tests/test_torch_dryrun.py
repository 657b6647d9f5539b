"""The port's dry run (``repro_torch.launch.dryrun``) on small fake meshes.

Each dry run owns its process (a ``fake`` process group of the mesh's
size), so every case runs in a child process; the children start
together in one module fixture.

* the three arch pairs of ``test_dryrun_small.py`` (dense + MoE, SSM +
  hybrid, encoder-decoder + VLM), train, prefill and decode of each smoke
  config on a 2x4 fake mesh: FLOPs > 0, and every train step
  communicates;
* a product replicated across ``model`` reports per-chip FLOPs = global /
  data, not global / chips (the count reads rank 0's local program);
* the collectives counted on a fake 2x2 mesh equal those counted in a
  real 2x2 gloo run of the same train step: kinds, counts and bytes;
* the calibrated 1- and 2-layer probes of a 4-layer dense smoke model
  equal its full unrolled trace;
* ``roofline_terms``, ``parse_hlo_collectives`` and ``collective_bytes``
  equal the reference's on ``test_launch.py``'s HLO snippet and on
  seeded inputs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.roofline import analysis as ranalysis
from repro_torch.roofline import analysis as panalysis

ROOT = os.path.join(os.path.dirname(__file__), "..")
PAIRS = [("qwen2-72b", "qwen3-moe-235b-a22b"), ("mamba2-1.3b", "zamba2-2.7b"),
         ("whisper-small", "qwen2-vl-7b")]

_CELLS = """
import dataclasses, json, sys
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh
dryrun.init_fake_group(8)
mesh = make_smoke_mesh((2, 4))
out = {}
for arch in %(archs)r:
    cfg = get_config(arch, smoke=True)
    for kind in ("train", "prefill", "decode"):
        shape = dataclasses.replace(get_shape("train_4k"), seq_len=64,
                                    global_batch=4, kind=kind)
        rec = dryrun.lower_cell(arch, shape, multi_pod=False,
                                cfg_override=cfg, mesh=mesh,
                                calibrate=False)
        out[f"{arch}:{kind}"] = {
            "flops": rec["cost_analysis"]["flops"],
            "coll_bytes": rec["collective_bytes"],
            "keys": sorted(rec), "mem": sorted(rec["memory_analysis"]),
            "roofline": sorted(rec["roofline"])}
json.dump(out, open(sys.argv[1], "w"))
"""

# fake 2x2: the replicated product, the train step's collectives, and the
# probes against the full trace
_FAKE = """
import dataclasses, json, sys
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.roofline import LocalProgramCounter
dryrun.init_fake_group(4)
mesh = make_smoke_mesh((2, 2))
out = {}
with FakeTensorMode(allow_non_fake_inputs=True):
    x = distribute_tensor(torch.empty(64, 128), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(128, 256), mesh,
                          [Replicate(), Replicate()], src_data_rank=None)
    with LocalProgramCounter() as c:
        x @ w
    out["replicated_flops"] = c.flops
shape = dataclasses.replace(get_shape("train_4k"), seq_len=64,
                            global_batch=4)
costs, _, _ = dryrun.trace_cell(get_config("minitron-8b", smoke=True),
                                shape, mesh)
out["coll"] = costs["coll"]
cfg = dataclasses.replace(get_config("minitron-8b", smoke=True),
                          num_layers=4)
out["full"] = dryrun.trace_cell(cfg, shape, mesh)[0]
out["calibrated"] = dryrun.calibrated_costs(cfg, shape, mesh)
json.dump(out, open(sys.argv[1], "w"))
"""

# real gloo 2x2, 4 ranks: the same train step under the same counter
_GLOO = """
import dataclasses, json, sys
import torch
import torch.distributed as dist
rank, store, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import model_api
from repro_torch.roofline import LocalProgramCounter
from repro_torch.train import steps as st
mesh = make_smoke_mesh((2, 2))
cfg = get_config("minitron-8b", smoke=True)
params = model_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
state = st.shard_state(st.train_state_from_params(params), cfg, mesh)
b = {"tokens": torch.zeros(4, 64, dtype=torch.int32),
     "labels": torch.zeros(4, 64, dtype=torch.int32)}
batch = st.shard_batch(b, cfg, mesh)
step = st.make_train_step(cfg, mesh)
with LocalProgramCounter() as c:
    step(state, batch)
if rank == 0:
    json.dump(c.collectives, open(path, "w"))
"""


def _popen(code, args, tmp, name):
    path = tmp / f"{name}.py"
    path.write_text(textwrap.dedent(code))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, str(path), *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, out, timeout=400):
    for p in procs:
        log = p.communicate(timeout=timeout)[0]
        assert p.returncode == 0, log[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    jobs = {}
    for i, archs in enumerate(PAIRS):
        out = tmp / f"cells{i}.json"
        jobs[archs] = ([_popen(_CELLS % {"archs": list(archs)}, [out], tmp,
                               f"cells{i}")], out)
    jobs["fake"] = ([_popen(_FAKE, [tmp / "fake.json"], tmp, "fake")],
                    tmp / "fake.json")
    gloo = tmp / "gloo.json"
    jobs["gloo"] = ([_popen(_GLOO, [r, tmp / "store", gloo], tmp, "gloo")
                     for r in range(4)], gloo)
    return {k: _wait(*v) for k, v in jobs.items()}


@pytest.mark.parametrize("archs", PAIRS)
def test_smoke_cells_trace_on_a_2x4_fake_mesh(runs, archs):
    out = runs[archs]
    ref_keys = {"arch", "shape", "mesh", "chips", "kind", "lower_s",
                "compile_s", "cost_analysis", "gate_cost_analysis",
                "memory_analysis", "collectives", "collective_bytes",
                "model_flops", "calibrated", "roofline", "remat",
                "attention_impl", "overrides"}
    for arch in archs:
        for kind in ("train", "prefill", "decode"):
            rec = out[f"{arch}:{kind}"]
            assert rec["flops"] > 0, (arch, kind, rec)
            assert set(rec["keys"]) == ref_keys
            assert set(rec["mem"]) == {
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes",
                "alias_size_in_bytes"}
            assert set(rec["roofline"]) == set(ranalysis.roofline_terms(
                arch="a", shape="s", mesh="m", chips=1, hlo_flops=1.0,
                hlo_bytes=1.0, coll_bytes=1.0, model_flops=1.0).row())
        # sharded train steps must communicate
        assert out[f"{arch}:train"]["coll_bytes"] > 0, arch


def test_a_product_replicated_across_model_counts_per_chip(runs):
    """(64 x 128) @ (128 x 256), rows sharded on data (2), replicated on
    model (2): rank 0 multiplies 32 rows, global / data; a count of the
    global program over the chips would report global / 4."""
    global_flops = 2 * 64 * 128 * 256
    assert runs["fake"]["replicated_flops"] == global_flops / 2


def test_fake_mesh_collectives_equal_a_real_gloo_run(runs):
    fake, real = runs["fake"]["coll"], runs["gloo"]
    assert fake == real
    assert sum(v["count"] for v in real.values()) > 0


def test_calibrated_probes_equal_the_full_unrolled_trace(runs):
    full, cal = runs["fake"]["full"], runs["fake"]["calibrated"]
    for k in ("flops", "bytes", "coll_bytes"):
        np.testing.assert_allclose(cal[k], full[k], rtol=1e-12, err_msg=k)
    for kind, v in full["coll"].items():
        assert cal["coll"][kind]["count"] == v["count"], kind
        np.testing.assert_allclose(cal["coll"][kind]["bytes"], v["bytes"],
                                   rtol=1e-12, err_msg=kind)


HLO_SNIPPET = """
  %p = bf16[128,256]{1,0} parameter(0)
  %all-reduce.1 = f32[256,4096]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[16,16]<=[256], use_global_device_ids=true, to_apply=%add
  %ag = bf16[64,512]{1,0} all-gather(%x), channel_id=2, replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[32,32]{1,0} reduce-scatter(%y), channel_id=3, replica_groups=[8,2]<=[16], to_apply=%add
  %all-gather-start.1 = (bf16[8,16]{1,0}, bf16[32,16]{1,0}) all-gather-start(%z), channel_id=4, replica_groups={{0,1,2,3}}, dimensions={0}
  %all-gather-done.1 = bf16[32,16]{1,0} all-gather-done(%all-gather-start.1)
  %a2a = s8[4,64]{1,0} all-to-all(%q), channel_id=5, replica_groups={{0,1}}
  %cp = f32[16]{0} collective-permute(%r), channel_id=6, source_target_pairs={{0,1}}
"""


def test_hlo_parser_and_roofline_are_the_references():
    assert (panalysis.parse_hlo_collectives(HLO_SNIPPET)
            == ranalysis.parse_hlo_collectives(HLO_SNIPPET))
    assert (panalysis.collective_bytes(HLO_SNIPPET)
            == ranalysis.collective_bytes(HLO_SNIPPET))
    tpu = panalysis.Hardware(name="tpu-v5e", hbm_bw=819e9,
                             bf16_tensor_flops=197e12, link_bw=50e9,
                             hbm_per_chip=16e9)
    rng = np.random.RandomState(0)
    for _ in range(20):
        kw = dict(arch="a", shape="s", mesh="16x16",
                  chips=int(rng.choice([16, 256, 512])),
                  hlo_flops=float(rng.uniform(1e9, 1e15)),
                  hlo_bytes=float(rng.uniform(1e6, 1e12)),
                  coll_bytes=float(rng.uniform(0, 1e11)),
                  model_flops=float(rng.uniform(1e12, 1e18)),
                  bytes_per_device=float(rng.uniform(0, 1e11)))
        got = panalysis.roofline_terms(**kw, hw=tpu)
        want = ranalysis.roofline_terms(**kw)
        assert got.row() == want.row()
        assert got.step_time_s == want.step_time_s
    h100 = panalysis.H100
    assert (h100.link_bw, h100.hbm_per_chip) == (50e9, 80e9)
    rep = panalysis.roofline_terms(arch="a", shape="s", mesh="16x16",
                                   chips=256, hlo_flops=989e12,
                                   hlo_bytes=0.0, coll_bytes=0.0,
                                   model_flops=989e12 * 256)
    assert abs(rep.compute_s - 1.0) < 1e-12 and rep.dominant == "compute"
    assert dataclasses.is_dataclass(rep)
