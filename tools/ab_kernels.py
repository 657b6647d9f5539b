#!/usr/bin/env python3
"""Kernels K1 and K2 of two checkouts of this repo, timed on one NVIDIA
card in one command: how a kernel change is held against its parent.

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 tools/ab_kernels.py build/parent [--out build/ab.json]
    python3 tools/ab_kernels.py build/parent --cluster-path

The inputs are made once and saved under ``build/ab_kernels/``:
  K1 main     the main path's 25,000 observed skylines (20,000 + 5,000
              jobs of the seed-0 corpus, as ``TasqPipeline.build`` draws
              them) x the dataset's 8 allocation columns;
  K1 cluster  28 queries x 1 allocation through a row index into a
              (256, 15,325) pool of step-function skylines of at most
              1,833 s (the cluster path's largest batch's shape);
  K2 replay   random lease tables at the replay's K 4, L 8,192, Q 4,096;
  K2 cluster  the same at the cluster path's longest queue, Q 14.
Each checkout then runs in a process of its own, in the order parent,
change, change, parent, through its own ``repro_torch.kernels.ops``
(K1 on the main path takes the layout the checkout's ``build_dataset``
passes: the padded (J, Smax) array where ``ops`` has no ragged entry, else
the ragged one; the padded form is timed too). For every case it prints
  ms         ``chip_smoke.kernel_ms`` of this checkout (L2 flushed, the
             host's launch work hidden behind a spin on the card);
  ms_nospin  the same without the spin, as ``kernel_ms`` timed before it:
             the host's work in the call adds to a small kernel's time;
  host_us    the host's time in one wrapper call (checks, allocations, the
             launch), the mean of 300 calls issued back to back;
  call_us    one call and a synchronisation on the host clock, the median
             of 300: what a caller that waits for the result pays.
Both checkouts' outputs must be equal, bit for bit. Exits non-zero if they
are not, or if a process fails.

``--cluster-path`` times the fused cluster path instead, end to end:
``chip_smoke.py``'s configuration (EDF admission, elastic pricing, 4
shards, capacity 24,576, the seed-71 10,000-event trace) on a model
trained on 2,000 + 500 jobs, two timed runs after a 1,000-event warm-up,
in the same order of processes; where K2's library can be rebuilt with
other constants (``cluster_step._bind``), the change also runs K2 built
for clusters of 16 CTAs. It prints events/s, the launches of one run and
a digest of the report (its metrics and per-decision errors), which must
agree between K2's builds within a process.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DATA = os.path.join(ROOT, "build", "ab_kernels", "inputs.npz")


def make_inputs(np) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.dataset import AREPAS_FRACTIONS, ragged_skylines
    from repro_torch.workloads.executor import observed_skyline
    from repro_torch.workloads.generator import build_corpus
    jobs = build_corpus(25_000, seed=0)
    skylines = [observed_skyline(j, noise_sigma=0.0, seed=int(i >= 20_000))
                for i, j in enumerate(jobs)]
    values, offsets = ragged_skylines(skylines)
    allocs = np.array([[max(1, int(round(f * j.default_tokens)))
                        for f in AREPAS_FRACTIONS] for j in jobs], np.int32)
    rng = np.random.RandomState(1)
    pool = np.zeros((256, 15_325), np.int32)
    plens = rng.randint(100, 1834, 256).astype(np.int32)
    for u in range(256):
        pool[u, :plens[u]] = np.repeat(rng.randint(1, 600, plens[u] // 60 + 1),
                                       60)[:plens[u]]
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    np.savez(DATA, values=values, offsets=offsets, allocs=allocs, pool=pool,
             plens=plens, rows=rng.randint(0, 256, 28),
             a1=rng.randint(1, 600, (28, 1)).astype(np.int32))


def k2_args(np, torch, K, L, Q, seed):
    rng = np.random.RandomState(seed)
    now = 1000.0
    live = rng.rand(K, L) < 0.7
    tokens = np.where(live, rng.randint(1, 64, (K, L)), 0).astype(np.int64)
    end = np.where(live, now + rng.randint(-200, 400, (K, L)) * 0.5, np.inf)
    free = rng.randint(0, 30 * Q, K).astype(np.int64)
    q_tok = rng.randint(1, 64, (K, Q)).astype(np.int64)
    q_end = now + rng.randint(1, 5000, (K, Q)).astype(np.float64)
    return [torch.from_numpy(x).cuda()
            for x in (end, tokens, free, q_tok, q_end)], now


def host_us(torch, fn, n=300):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def call_us(np, torch, fn, n=300):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def worker(src: str) -> int:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.kernels import ops     # before chip_smoke adds ROOT/src
    if not os.path.abspath(ops.__file__).startswith(os.path.abspath(src)):
        raise RuntimeError(f"{ops.__file__} is not under {src}")
    sys.path.insert(1, ROOT)
    from chip_smoke import kernel_ms
    d = np.load(DATA)
    dev = "cuda"
    values = torch.from_numpy(d["values"]).to(dev)
    offsets = torch.from_numpy(d["offsets"]).to(dev)
    allocs = torch.from_numpy(d["allocs"]).to(dev)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int32)
    J, smax = allocs.shape[0], int(lens.max())
    pad = torch.zeros((J, smax), dtype=torch.int32, device=dev)
    row = torch.repeat_interleave(torch.arange(J, device=dev), lens.long())
    pad[row, torch.arange(values.numel(), device=dev) - offsets[:-1][row]] = \
        values
    del row
    pool = torch.from_numpy(d["pool"]).to(dev)
    plens = torch.from_numpy(d["plens"]).to(dev)
    rows = torch.from_numpy(d["rows"]).to(dev)
    a1 = torch.from_numpy(d["a1"]).to(dev)
    cases = {}
    if hasattr(ops, "arepas_runtimes_ragged"):
        cases["K1 main (ragged)"] = lambda: ops.arepas_runtimes_ragged(
            values, offsets, allocs)
    cases["K1 main (padded)"] = lambda: ops.arepas_runtimes(pad, lens, allocs)
    cases["K1 cluster 28 x 1"] = lambda: ops.arepas_runtimes(pool, plens, a1,
                                                             rows=rows)
    for name, (K, L, Q) in (("K2 replay", (4, 8192, 4096)),
                            ("K2 cluster", (4, 8192, 14))):
        args, now = k2_args(np, torch, K, L, Q, L + Q)
        cases[f"{name} ({K}, {L}, {Q})"] = (
            lambda a=args, t=now: ops.cluster_epoch_step(*a, t))
    for name, fn in cases.items():
        out = fn()
        out = out if isinstance(out, (tuple, list)) else (out,)
        digest = hashlib.sha256(b"".join(
            o.contiguous().cpu().numpy().tobytes() for o in out)).hexdigest()
        rec = {"case": name, "ms": kernel_ms(fn),
               "ms_nospin": kernel_ms(fn, spin=False),
               "host_us": host_us(torch, fn), "call_us": call_us(np, torch, fn),
               "out_sha256": digest[:16], "ops": ops.__file__}
        print("AB " + json.dumps(rec), flush=True)
    return 0


def cluster_worker(src: str) -> int:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.api import Allocator, AllocatorConfig
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cluster_step as k2
    from repro_torch.serve import AllocationService
    from repro_torch.workloads import TraceGenerator
    if not os.path.abspath(ops.__file__).startswith(os.path.abspath(src)):
        raise RuntimeError(f"{ops.__file__} is not under {src}")
    alloc = Allocator.from_config(AllocatorConfig(
        family="nn", loss="lf2", pipeline=TasqConfig(n_train=2000,
                                                     n_eval=500)),
        device="cuda")
    fab = Allocator(AllocationService(alloc.model, alloc.policy,
                                      device="cuda"), n_shards=4)
    trace = TraceGenerator(seed=71, n_unique=256).generate(10_000)
    warm = TraceGenerator(seed=72, n_unique=256).generate(1_000)
    cfg = ClusterConfig(admission="edf", capacity=24_576, n_shards=4,
                        elastic=True, pricing="elastic", fused=True)
    builds = [None] + (["K2_CLUSTER_CTAS=16"] if hasattr(k2, "_bind") else [])
    for build in builds:
        if build:
            k2._loaded = k2._bind(_build.load("cluster_step", (build,)))
        fab.run_cluster(warm, cfg)
        for _ in range(2):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            r = fab.run_cluster(trace, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            digest = hashlib.sha256(
                json.dumps(r.metrics, sort_keys=True).encode()
                + np.asarray(r.alloc_errors).tobytes()).hexdigest()[:16]
            rec = {"case": f"cluster fused, K2 {build or 'as built'}",
                   "ev_s": r.n_events / wall, "wall_s": wall,
                   "epochs": r.n_epochs, "launches": ops.launch_counts(),
                   "report_sha256": digest, "ops": ops.__file__}
            print("AB " + json.dumps(rec), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="root of the parent's checkout")
    ap.add_argument("--out", default=None, help="write the records as JSON")
    ap.add_argument("--cluster-path", action="store_true",
                    help="time the fused cluster path end to end")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        return (cluster_worker if a.cluster_path else worker)(a.worker)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA card visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if not a.cluster_path:
        t0 = time.perf_counter()
        make_inputs(np)
        print(f"inputs {time.perf_counter() - t0:.1f} s", flush=True)
    trees = {"parent": os.path.join(os.path.abspath(a.parent), "src"),
             "change": os.path.join(ROOT, "src")}
    records, bad = [], 0
    for label in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               a.parent, "--worker", trees[label]]
                              + ["--cluster-path"] * a.cluster_path,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("AB "):
                rec = dict(json.loads(line[3:]), tree=label)
                records.append(rec)
                if a.cluster_path:
                    print(f"{label:6s} {rec['case']:34s} {rec['ev_s']:.1f} "
                          f"ev/s ({rec['wall_s']:.3f} s, {rec['epochs']} "
                          f"epochs); launches {rec['launches']}; report "
                          f"{rec['report_sha256']}", flush=True)
                else:
                    print(f"{label:6s} {rec['case']:28s} ms {rec['ms']:.4f}  "
                          f"ms_nospin {rec['ms_nospin']:.4f}  host_us "
                          f"{rec['host_us']:.1f}  call_us "
                          f"{rec['call_us']:.1f}  out {rec['out_sha256']}",
                          flush=True)
        if a.cluster_path:
            seen = {r["report_sha256"] for r in records[-4:]
                    if r["tree"] == label}
            if label == "change" and len(seen) != 1:
                print("change: K2's builds gave different reports")
                bad += 1
    digests = {}
    for rec in records if not a.cluster_path else ():
        key = rec["case"].replace(" (padded)", "").replace(" (ragged)", "")
        digests.setdefault(key, set()).add(rec["out_sha256"])
    for key, seen in digests.items():
        if len(seen) != 1:
            print(f"{key}: outputs differ between the checkouts")
            bad += 1
    if a.out:
        with open(a.out, "w") as f:
            json.dump(records, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
