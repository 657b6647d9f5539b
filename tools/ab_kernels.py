#!/usr/bin/env python3
"""Kernels K1, K2 and K3 of two checkouts of this repo, timed on one
NVIDIA card in one command: how a kernel change is held against its
parent.

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
  K2 cluster  the same at the cluster path's longest queue, Q 14;
  K3 (c), (a), (b)  ``tools/probe_kernels.py``'s three record shapes of
              K3 (``k3_cases``), (a) drawn from the same 25,000 observed
              skylines (their observed tokens the jobs' default tokens),
              its pool padded on the card.
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
             of 300: what a caller that waits for the result pays;
  resize_us  K3 only: the simulator's ``ClusterSimulator._fused_resize``
             (host inputs in, host outputs out: its copies, the launch
             and the read-back) on the same batch, the median of 300.
Both checkouts' outputs must be equal, bit for bit. Exits non-zero if they
are not, or if a process fails.

``--cluster-path`` times the fused cluster path instead, end to end:
``chip_smoke.py``'s configuration (EDF admission, elastic pricing, 4
shards, capacity 24,576, the seed-71 10,000-event trace) on a model
trained on 2,000 + 500 jobs, two timed runs after a 1,000-event warm-up,
in the same order of processes. It prints events/s, the launches of one
run and a digest of the report (its metrics and per-decision errors),
which must be the same in every process.
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
    sys.path.insert(0, HERE)
    from probe_kernels import k3_cases
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
    k3 = {}
    obs = np.array([j.default_tokens for j in jobs], np.int64)
    for i, (name, case) in enumerate(k3_cases(np, (skylines, obs),
                                              pad=False).items()):
        for k, v in case["vecs"].items():
            k3[f"k3_{i}_{k}"] = v
        for k in ("rows", "now", "epoch_s", "cap", "max_slowdown"):
            k3[f"k3_{i}_{k}"] = np.asarray(case[k])
        if "pick" in case:          # (a): the pool is padded on the card
            k3[f"k3_{i}_pick"] = case["pick"]
        else:
            k3[f"k3_{i}_sky"], k3[f"k3_{i}_lens"] = case["sky"], case["lens"]
        k3[f"k3_{i}_name"] = np.asarray(name)
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    np.savez(DATA, values=values, offsets=offsets, allocs=allocs, pool=pool,
             plens=plens, rows=rng.randint(0, 256, 28),
             a1=rng.randint(1, 600, (28, 1)).astype(np.int32), **k3)


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
    outputs, resize = {}, {}
    for name, (fn, outs, fused) in k3_worker_cases(np, torch, d, values,
                                                   offsets).items():
        cases[name], outputs[name], resize[name] = fn, outs, fused
    for name, fn in cases.items():
        out = outputs[name]() if name in outputs else fn()
        out = out if isinstance(out, (tuple, list)) else (out,)
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(o.cpu().numpy() if hasattr(o, "cpu") else o
                                 ).tobytes() for o in out)).hexdigest()
        rec = {"case": name, "ms": kernel_ms(fn),
               "ms_nospin": kernel_ms(fn, spin=False),
               "host_us": host_us(torch, fn), "call_us": call_us(np, torch, fn),
               "out_sha256": digest[:16], "ops": ops.__file__}
        if name in resize:
            got = resize[name]()
            rec["resize_us"] = call_us(np, torch, resize[name])
            rec["resize_sha256"] = hashlib.sha256(b"".join(
                np.ascontiguousarray(o).tobytes() for o in got)).hexdigest()[:16]
        print("AB " + json.dumps(rec), flush=True)
    return 0


def k3_worker_cases(np, torch, d, values, offsets):
    """{case: (launch, outputs, fused_resize)} for K3's three shapes in
    this checkout: ``launch`` one wrapper call (the packed-buffer interface
    where the checkout has it, else one tensor an input), ``outputs`` its
    (tgt, sel, rt, new_end) and ``fused_resize`` one call of the
    simulator's ``_fused_resize`` on the same batch, on host arrays."""
    from types import SimpleNamespace
    from repro_torch.cluster import ClusterConfig
    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.kernels import cluster_step as k3
    from repro_torch.kernels import ops
    from repro_torch.obs import NULL_OBS
    keys = ("a", "b", "price", "obs", "floor", "done", "cand_tok", "cand_end")
    cases, i = {}, 0
    while f"k3_{i}_name" in d:
        get = lambda k, i=i: d[f"k3_{i}_{k}"]
        vecs = {k: get(k) for k in keys}
        rows_np = get("rows").astype(np.int64)
        now, epoch_s, cap = float(get("now")), float(get("epoch_s")), int(get("cap"))
        policy = AllocationPolicy(max_slowdown=float(get("max_slowdown")))
        if f"k3_{i}_pick" in d:
            pick = torch.from_numpy(get("pick")).cuda()
            lens = (offsets[pick + 1] - offsets[pick]).to(torch.int32)
            sky = torch.zeros((len(pick), int(lens.max())), dtype=torch.int32,
                              device="cuda")
            for r, j in enumerate(pick.tolist()):
                n = int(lens[r])
                sky[r, :n] = values[int(offsets[j]):int(offsets[j]) + n]
        else:
            sky = torch.from_numpy(get("sky")).cuda()
            lens = torch.from_numpy(get("lens")).cuda()
        rows = torch.from_numpy(rows_np).cuda()
        if hasattr(k3, "pack_resize"):
            packed = torch.from_numpy(k3.pack_resize(
                *(vecs[k] for k in keys), rows_np)).cuda()
            fn = (lambda p=packed, s=sky, l=lens, t=now, e=epoch_s, po=policy,
                  c=cap: ops.cluster_resize_step(p, s, l, t, e, policy=po,
                                                 cap=c))
            outs = lambda fn=fn: k3.unpack_resize(fn())
        else:
            v = [torch.from_numpy(np.ascontiguousarray(vecs[k])).cuda()
                 for k in keys]
            fn = (lambda v=v, s=sky, l=lens, t=now, e=epoch_s, po=policy,
                  c=cap, r=rows: ops.cluster_resize_step(
                      *v, s, l, t, e, policy=po, cap=c, rows=r))
            outs = fn
        sim = ClusterSimulator.__new__(ClusterSimulator)
        sim.device, sim.obs = torch.device("cuda"), NULL_OBS
        sim.cfg = ClusterConfig(epoch_s=epoch_s)
        sim.service = SimpleNamespace(policy=policy)
        sim._sky, sim._lens, sim._stage = sky, lens, None
        host = [np.ascontiguousarray(vecs[k]) for k in keys]
        fused = (lambda sim=sim, h=host, r=rows_np, t=now, c=cap:
                 sim._fused_resize(*h, r, t, c))
        cases[f"K3 {get('name')}"] = (fn, outs, fused)
        i += 1
    return cases


def cluster_worker(src: str) -> int:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.api import Allocator, AllocatorConfig
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.kernels import ops
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
        rec = {"case": "cluster fused", "ev_s": r.n_events / wall,
               "wall_s": wall, "epochs": r.n_epochs,
               "launches": ops.launch_counts(), "report_sha256": digest,
               "ops": ops.__file__}
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
                    extra = (f"  resize_us {rec['resize_us']:.1f}"
                             if "resize_us" in rec else "")
                    print(f"{label:6s} {rec['case']:28s} ms {rec['ms']:.4f}  "
                          f"ms_nospin {rec['ms_nospin']:.4f}  host_us "
                          f"{rec['host_us']:.1f}  call_us "
                          f"{rec['call_us']:.1f}{extra}  out "
                          f"{rec['out_sha256']}", flush=True)
    digests = {}
    for rec in records:
        if a.cluster_path:
            digests.setdefault(rec["case"], set()).add(rec["report_sha256"])
            continue
        key = rec["case"].replace(" (padded)", "").replace(" (ragged)", "")
        digests.setdefault(key, set()).add(rec["out_sha256"])
        if "resize_sha256" in rec:
            digests.setdefault(key + " _fused_resize", set()).add(
                rec["resize_sha256"])
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
