"""The allocation fabric on a NCCL shard mesh: one rank a card.

``K`` ranks (child processes, ``torch.cuda.set_device(rank)``, a NCCL group
over a ``FileStore``) each build ``Allocator(service, n_shards=K)``, whose
``make_allocation_mesh`` gives the ``("shard",)`` mesh of the group, so the
fabric decides each shard on its own card and gathers the outputs on the
cards (``MeshExecutable``'s NCCL branch). On the same seeded network every
rank must give, bitwise: the priced history path of the one-device fabric
(the same K shards on the rank's card, no mesh); the fused path of K
single-shard services fed the routed partitions at the rank's bucket Bp;
and the one-device fabric's cluster report (edf, elastic, priced, fused:
K1, K2 and K3 on each rank's card). A warmed fabric builds nothing.

Needs ``K`` NVIDIA cards: marked ``cuda``, and the test decides inside
itself whether they are present, so it skips elsewhere. Run on four cards
with ``python -m pytest -m cuda tests/test_torch_fabric_mesh_cuda.py``.
"""
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = 4

RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.api import AllocationRequest, Allocator, DecisionContext
from repro_torch.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.core.featurize import Standardizer, batch_job_features
from repro_torch.core.models import build_model
from repro_torch.core.models.nn import MLP
from repro_torch.core.pcc import PCCScaler
from repro_torch.serve import AllocationService, ShardedAllocationService
from repro_torch.serve.batching import shard_positions
from repro_torch.workloads import TraceGenerator

trace = TraceGenerator(seed=7, n_unique=30, rate_qps=4.0).generate(600)
feats = batch_job_features(trace.jobs)
module = MLP(feats.shape[1], (32, 16),
             generator=torch.Generator().manual_seed(3))
model = build_model("nn", device="cuda").load(
    module, scaler=PCCScaler(mu_a=-0.2, sd_a=0.8, mu_b=5.0, sd_b=1.5),
    std=Standardizer(feats))
policy = AllocationPolicy(max_slowdown=0.05)

alloc = Allocator(AllocationService(model, policy, device="cuda"),
                  n_shards=world)
mesh = alloc.mesh
assert mesh is not None and alloc.fabric.mesh is mesh
assert mesh.device_type == "cuda" and mesh.get_local_rank() == rank
assert dist.get_backend(mesh.get_group()) == "nccl"
one = ShardedAllocationService(AllocationService(model, policy,
                                                 device="cuda"), world)
assert one.mesh is None
alloc.warmup(trace=trace)

B = 1500
rng = np.random.RandomState(0)
jb = rng.randint(0, len(trace.jobs), B)
obs = np.array([trace.jobs[j].default_tokens for j in jb], np.int64)
shard_of = alloc.place(jb)
d = one.decide(AllocationRequest(model_in={"features": feats[jb]},
                                 observed_tokens=obs))
price = np.exp(rng.uniform(0.0, 1.0, B))
hist = AllocationRequest(a=np.asarray(d.a, np.float64),
                         b=np.asarray(d.b, np.float64), observed_tokens=obs)
hctx = DecisionContext(price=price, shard_of=shard_of)
got, want = alloc.decide(hist, hctx), one.decide(hist, hctx)
for k in ("tokens", "runtime"):
    np.testing.assert_array_equal(getattr(got, k), getattr(want, k))

fused = AllocationRequest(model_in={"features": feats[jb]},
                          observed_tokens=obs)
got = alloc.decide(fused, DecisionContext(shard_of=shard_of))
_, _, Bp = shard_positions(shard_of, world)
for s in range(world):
    m = shard_of == s
    ds = AllocationService(model, policy, device="cuda",
                           batch_floor=Bp).decide(AllocationRequest(
        model_in={"features": feats[jb][m]}, observed_tokens=obs[m]))
    for k in ("tokens", "a", "b", "runtime"):
        np.testing.assert_array_equal(getattr(got, k)[m], getattr(ds, k))
assert alloc.service.stats["compiles"] == 0, alloc.service.stats

cfg = ClusterConfig(capacity=2048, epoch_s=8.0, n_shards=world,
                    admission="edf", elastic=True, pricing="elastic",
                    fused=True)
rep = alloc.run_cluster(trace, cfg)
base = ClusterSimulator(one.service, cfg, fabric=one).run(trace)
assert dict(rep.metrics) == dict(base.metrics)
np.testing.assert_array_equal(rep.alloc_errors, base.alloc_errors)
np.testing.assert_array_equal(rep.cache_hits, base.cache_hits)
assert rep.cache_stats == base.cache_stats
assert [r["queries"] for r in rep.replica_stats] == \\
    [r["queries"] for r in base.replica_stats]
assert rep.metrics["resize_shrinks"] > 0
assert rep.service_stats["compiles"] == 0, rep.service_stats
print(f"rank {rank}: fabric on the NCCL mesh == one device", flush=True)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_fabric_on_a_nccl_mesh_equals_one_device(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < K:
        pytest.skip(f"needs {K} CUDA cards")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    # each rank writes to its own file: a full pipe would stall a rank
    # while the others wait for it in a collective
    logs = [tmp_path / f"rank{r}.log" for r in range(K)]
    procs = []
    try:
        for r in range(K):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", RANK, str(r), str(K),
                     str(tmp_path / "store")], cwd=ROOT, env=env,
                    stdout=out, stderr=subprocess.STDOUT))
        # the first rank to fail stops the others, which would wait for
        # it in a collective
        deadline = time.monotonic() + 600
        while any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    first = next((r for r, rc in enumerate(rcs) if rc not in (0, -9)), 0)
    assert rcs == [0] * K, (rcs, logs[first].read_text()[-4000:])
    for log in logs:
        assert "== one device" in log.read_text(), log.read_text()[-2000:]
