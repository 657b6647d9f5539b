"""The port's launch layer against the reference: the elastic controller,
int8 gradient compression, and the chip allocator over dry-run records.

* ``ElasticController`` plans equal the reference's over seeded
  failure/recovery sequences, raising where it raises;
* ``compress_int8`` / ``decompress_int8`` are bitwise the reference's;
* ``compressed_psum`` on a one-rank gloo group (a child process) equals
  the reference's under a one-device ``shard_map``;
* ``step_time_curve``, ``allocate_chips(_batch)`` and
  ``load_dryrun_record`` equal the reference's on fabricated records and
  on records of the port's own dry run (smoke configs on a 2x4 fake mesh,
  made in a child): chips equal, (a, b) within 1e-9 relative. The
  reference's batched policy needs the ``jax.experimental.enable_x64``
  alias, which only its child process sets.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.elastic import ElasticController as RefController
from repro.launch.elastic import MeshPlan as RefPlan
from repro.optim import compression as rcomp
from repro_torch.core import chip_allocator as pca
from repro_torch.launch.elastic import ElasticController, MeshPlan
from repro_torch.optim import compression as pcomp

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _child(code, *args, timeout=300, alias=False):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    pre = ("import jax, jax.experimental; "
           "jax.experimental.enable_x64 = jax.enable_x64\n" if alias else "")
    p = subprocess.run([sys.executable, "-c", pre + textwrap.dedent(code),
                        *map(str, args)], capture_output=True, text=True,
                       env=env, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


# ----------------------------------------------------------------- elastic --
@pytest.mark.parametrize("seed", range(6))
def test_elastic_plans_are_the_references(seed):
    rng = np.random.RandomState(seed)
    data, model, pods = (int(rng.choice([2, 4, 8, 16])),
                         int(rng.choice([1, 2, 4])), int(rng.choice([1, 2])))
    cph = int(rng.choice([1, 2, 4]))
    kw = dict(chips_per_host=cph, min_data=int(rng.choice([1, 2])))
    port = ElasticController(MeshPlan(data, model, pods), **kw)
    ref = RefController(RefPlan(data, model, pods), **kw)
    assert port.total_hosts == ref.total_hosts
    for _ in range(12):
        host = int(rng.randint(0, max(port.total_hosts, 1) + 1))
        event = "host_failed" if rng.rand() < 0.6 else "host_recovered"
        try:
            want = getattr(ref, event)(host)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="insufficient"):
                getattr(port, event)(host)
            assert "insufficient" in str(e)
            return
        got = getattr(port, event)(host)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.shape(), got.axes(), got.chips) == (
                want.shape(), want.axes(), want.chips)
        assert port.status() == ref.status()


# ------------------------------------------------------------- compression --
@pytest.mark.parametrize("seed", range(4))
def test_int8_compression_is_bitwise_the_references(seed):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((37, 11)) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]            # ties: half to even
    if seed == 3:
        x[:] = 0.0                               # the scale's floor
    q, s = pcomp.compress_int8(torch.from_numpy(x))
    rq, rs = rcomp.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(s.item()).tobytes() == np.asarray(rs).tobytes()
    d = pcomp.decompress_int8(q, s)
    rd = rcomp.decompress_int8(rq, rs)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    assert pcomp.decompress_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


_PSUM_ONE = """
import json, sys
import numpy as np, torch, torch.distributed as dist
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import compressed_psum as ref_psum
from repro_torch.optim.compression import compressed_psum
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1), rank=0,
                        world_size=1)
rng = np.random.RandomState(5)
g = rng.standard_normal((6, 7)).astype(np.float32)
r = (0.01 * rng.standard_normal((6, 7))).astype(np.float32)
out, res = compressed_psum(torch.from_numpy(g), torch.from_numpy(r))
mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
f = jax.shard_map(lambda a, b: ref_psum(a, b, "pod"), mesh=mesh,
                  in_specs=(P(), P()), out_specs=(P(), P()))
want, wres = f(jnp.asarray(g), jnp.asarray(r))
print(json.dumps({"eq": bool(np.array_equal(out.numpy(), np.asarray(want))),
                  "req": bool(np.array_equal(res.numpy(), np.asarray(wres)))}))
"""


def test_compressed_psum_on_one_rank_is_the_references(tmp_path):
    out = json.loads(_child(_PSUM_ONE, tmp_path / "store").splitlines()[-1])
    assert out == {"eq": True, "req": True}


# ----------------------------------------------------------- chip allocator --
_PORT_RECORDS = """
import dataclasses, json, os, sys
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_smoke_mesh
dryrun.init_fake_group(8)
mesh = make_smoke_mesh((2, 4))
for arch, shape_name, kind in (("minitron-8b", "train_4k", "train"),
                               ("zamba2-2.7b", "prefill_32k", "prefill"),
                               ("moonshot-v1-16b-a3b", "train_4k", "train")):
    shape = dataclasses.replace(get_shape(shape_name), seq_len=64,
                                global_batch=4, kind=kind)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False,
                            cfg_override=get_config(arch, smoke=True),
                            mesh=mesh)
    with open(os.path.join(sys.argv[1], f"{arch}_{shape_name}_2x4.json"),
              "w") as f:
        json.dump(rec, f)
"""

_REF_ALLOC = """
import glob, json, os, sys
from repro.core.chip_allocator import (allocate_chips, allocate_chips_batch,
                                       load_dryrun_record, step_time_curve)
recs = [load_dryrun_record(p) for p in sorted(glob.glob(
    os.path.join(sys.argv[1], "*.json")))]
out = []
for kw in ({}, {"min_gain": 0.02, "max_chips": 1024}):
    allocs = allocate_chips_batch(recs, **kw)
    out.append([[a.chips, a.pcc_a, a.pcc_b, a.predicted_step_s,
                 a.dominant_at_choice, a.reference_chips] for a in allocs])
single = allocate_chips(recs[0])
curves = [[c.tolist(), t.tolist(), d] for c, t, d in
          (step_time_curve(r, (16, 64, 256, 1024)) for r in recs)]
print(json.dumps({"batch": out, "single": [single.chips, single.pcc_a,
                                           single.pcc_b],
                  "curves": curves}))
"""


def _fabricated(tmp_path):
    rng = np.random.RandomState(11)
    for i in range(8):
        rec = {"arch": f"arch{i}", "shape": "train_4k",
               "chips": int(rng.choice([256, 512])),
               "roofline": {"compute_ms": float(rng.uniform(1, 500)),
                            "memory_ms": float(rng.uniform(1, 200)),
                            "collective_ms": float(rng.uniform(0, 300))}}
        with open(tmp_path / f"arch{i}_train_4k_16x16.json", "w") as f:
            json.dump(rec, f)


def _check_against_reference(records_dir):
    import glob
    want = json.loads(_child(_REF_ALLOC, records_dir,
                             alias=True).splitlines()[-1])
    recs = [pca.load_dryrun_record(p) for p in sorted(glob.glob(
        os.path.join(records_dir, "*.json")))]
    for kw, w in zip(({}, {"min_gain": 0.02, "max_chips": 1024}),
                     want["batch"]):
        got = pca.allocate_chips_batch(recs, device="cpu", **kw)
        assert [a.chips for a in got] == [x[0] for x in w]
        np.testing.assert_allclose([a.pcc_a for a in got], [x[1] for x in w],
                                   rtol=1e-9)
        np.testing.assert_allclose([a.pcc_b for a in got], [x[2] for x in w],
                                   rtol=1e-9)
        np.testing.assert_allclose([a.predicted_step_s for a in got],
                                   [x[3] for x in w], rtol=1e-9)
        assert [a.dominant_at_choice for a in got] == [x[4] for x in w]
        assert [a.reference_chips for a in got] == [x[5] for x in w]
    single = pca.allocate_chips(recs[0], device="cpu")
    assert single.chips == want["single"][0]
    np.testing.assert_allclose([single.pcc_a, single.pcc_b],
                               want["single"][1:], rtol=1e-9)
    for rec, (c, t, d) in zip(recs, want["curves"]):
        gc, gt, gd = pca.step_time_curve(rec, (16, 64, 256, 1024))
        assert gc.tolist() == c and gd == d
        np.testing.assert_allclose(gt, t, rtol=1e-12)
    return recs


def test_chip_allocator_is_the_references_on_fabricated_records(tmp_path):
    _fabricated(tmp_path)
    _check_against_reference(str(tmp_path))
    rec = pca.load_dryrun_record(str(tmp_path), "arch3", "train_4k")
    assert rec["arch"] == "arch3"
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "x_y_16x16.json", "w") as f:
        json.dump({"arch": "x", "skipped": "quadratic"}, f)
    with pytest.raises(ValueError, match="unusable"):
        pca.load_dryrun_record(str(bad), "x", "y")


def test_chip_allocator_is_the_references_on_the_ports_dry_run(tmp_path):
    _child(_PORT_RECORDS, tmp_path)
    recs = _check_against_reference(str(tmp_path))
    assert {r["mesh"] for r in recs} == {"2x4"}
    assert all(r["roofline"]["step_ms"] > 0 for r in recs)
