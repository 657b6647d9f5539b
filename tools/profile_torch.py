#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on one NVIDIA card.

    python3 tools/profile_torch.py [--n-train 20000] [--n-eval 5000]

Builds the main path as ``chip_smoke.py`` does (``Allocator.from_config``,
nn / lf2, on the card), then traces windows of it with ``torch.profiler``:

  * ``decide`` of the first 256 and the first 4,096 evaluation jobs, after
    three warm-up calls (the first builds the bucket's CUDA graph, so the
    window times a graph replay), and at 256 the same decision by the
    eager fused stage (``chip_smoke.eager_decide``), op by op;
  * the serving plane: 256 single-query requests through a warmed
    two-worker ``ServingPlane`` (micro-batches of at most 32);
  * one NN training epoch (``fit_model``, 1 epoch, from a fresh model);
  * one ``build_dataset``-sized K1 launch on the training skylines, in
    the ragged layout ``build_dataset`` passes;
  * the cluster path: ``Allocator.run_cluster`` (fused: K1, K2, K3) on the
    first ``CLUSTER_EVENTS`` events of the preempt_cluster trace, in the
    chip smoke's edf-elastic K = 4 configuration;
  * the replay path: ``FusedReplay`` (K2 every epoch) on a
    ``REPLAY_EVENTS``-event stream of the fused_cluster benchmark;
  * the LM serving path as ``chip_smoke.py`` drives it: minitron-8b at
    full width and depth (bf16, seeded random weights,
    ``attention_impl="pallas"``), one prefill of 8 x 2,048 tokens (K4 in
    every layer) and one decode step on its cache, each after a warm-up;
    the same two windows for zamba2-2.7b (hybrid: K4 in each of the 9
    shared-attention applications of the prefill, the SSD scan by the
    plain ``ssd_chunked`` and ``ssd_decode_step``) and for
    moonshot-v1-16b-a3b (MoE: K4 in all 48 layers of the prefill; the
    routing's sorts, gathers and scatters and the expert products are
    plain PyTorch, whose kernels the top-8 list of each LM window names);
  * the LM training path as ``chip_smoke.py`` drives it: one train step of
    zamba2-2.7b at full width and depth (bf16, seeded random weights,
    ``ssd_impl = attention_impl = "pallas"``, remat "full", 8 x 2,048
    tokens of the ported token pipeline), after a warm-up step.

The two windows are cuts of ``chip_smoke.py``'s 10,000-event cluster run
and 1,000,000-event replay, so that the trace stays small.

The two cluster windows also print the device operations per epoch, so
one can tell whether the path is bound by the host, by kernel launches or
by device work.

For each window it prints the host-clock wall time (ending in a
synchronise), the device busy time (the union of kernel, memcpy and
memset intervals in the trace), the device's idle share of the wall time,
the number of device operations, and the kernels that took the most
device time. The last line is one JSON object with the same numbers.
Needs a card; exits non-zero without one.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(1, os.path.join(HERE, ".."))          # chip_smoke

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CLUSTER_EVENTS = 2_000              # of chip_smoke.py's 10,000
REPLAY_EVENTS = 200_000             # of chip_smoke.py's 1,000,000


def trace_window(name, fn, top=5):
    """Run ``fn`` once under the profiler; return the window's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ops)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:                       # union of intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_name = {}
    for e in ops:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    row = {"window": name, "wall_ms": wall_s * 1e3,
           "device_busy_ms": busy_us / 1e3,
           "idle_share": (1.0 - busy_us / 1e6 / wall_s) if ops else None,
           "device_ops": len(ops),
           "top": [{"name": n[:90], "ms": us / 1e3} for n, us in top_k]}
    busy = (f"device busy {row['device_busy_ms']:.3f} ms, idle share "
            f"{row['idle_share']:.4f}" if ops else
            "device busy not measured (no device events in the trace)")
    print(f"{name}: wall {row['wall_ms']:.3f} ms; {busy}; "
          f"{len(ops)} device ops", flush=True)
    for t in row["top"]:
        print(f"    {t['ms']:10.3f} ms  {t['name']}", flush=True)
    return row


def lm_windows(arch):
    """A prefill window and a decode-step window of the LM serving path on
    ``arch``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm, model_api
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
    params = model_api.init(cfg, torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 2048)).astype(np.int32)).cuda()
    logits, cache = lm.prefill(params, {"tokens": tokens}, cfg)   # warm
    del logits, cache
    res = {}
    prefill = trace_window(f"LM prefill {arch}, 8 x 2048",
                           lambda: res.setdefault("p", lm.prefill(
                               params, {"tokens": tokens}, cfg)), top=8)
    logits, cache = res.pop("p")
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    _, cache = lm.decode_step(params, {"tokens": nxt}, cache, cfg)  # warm
    decode = trace_window(f"LM decode step {arch}, batch 8",
                          lambda: lm.decode_step(params, {"tokens": nxt},
                                                 cache, cfg), top=8)
    return [prefill, decode]


def train_window():
    """One training step of zamba2-2.7b (K5 in every Mamba-2 layer, K4 in
    every shared-attention application, forward and remat recompute)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("zamba2-2.7b"),
                              attention_impl="pallas", ssd_impl="pallas")
    state = init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                             opt_cfg=AdamWConfig(warmup_steps=20))
    step = make_train_step(cfg)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                                    global_batch=8, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                pipe.batch_at(i).items()} for i in range(2)]
    step(state, batches[0])                                       # warm
    return [trace_window("LM train step zamba2-2.7b, 8 x 2048",
                         lambda: step(state, batches[1]))]


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-train", type=int, default=20_000)
    ap.add_argument("--n-eval", type=int, default=5_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA card visible", file=sys.stderr)
        return 2

    from repro_torch.api import AllocationRequest, Allocator, AllocatorConfig
    from repro_torch.core.dataset import AREPAS_FRACTIONS, ragged_skylines
    from repro_torch.core.models import build_model
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    cfg = AllocatorConfig(family="nn", loss="lf2", pipeline=TasqConfig(
        n_train=args.n_train, n_eval=args.n_eval))
    alloc = Allocator.from_config(cfg, device="cuda")
    pipe = alloc.pipeline
    request = AllocationRequest.from_dataset(alloc.model, pipe.eval_set)

    rows = []
    for batch in (256, 4096):
        req = request.narrow(slice(0, batch))
        for _ in range(3):
            alloc.decide(req)
        rows.append(trace_window(f"decide batch {batch} (CUDA graph)",
                                 lambda: alloc.decide(req)))
    from chip_smoke import PLANE_EVENTS, PLANE_TRACE, eager_decide
    req = request.narrow(slice(0, 256))
    eager = lambda: eager_decide(alloc.model, alloc.policy, req.model_in,
                                 req.observed_tokens)
    for _ in range(3):
        eager()
    rows.append(trace_window("decide batch 256 (eager stage)", eager))

    from repro_torch.serve import AllocationService, ServingPlane
    from repro_torch.serve.aot import model_pool_inputs
    from repro_torch.workloads import TraceGenerator
    trace = TraceGenerator(**PLANE_TRACE).generate(PLANE_EVENTS)
    pool = model_pool_inputs(alloc.model, trace.jobs)
    plane = ServingPlane(AllocationService(alloc.model, alloc.policy,
                                           device="cuda"),
                         n_workers=2, max_batch=32, backlog=64)
    plane.start(warm_jobs=trace.jobs)

    def burst():
        n = len(pool["features"])
        futs = [plane.submit({k: v[i % n] for k, v in pool.items()}, 50 + i)
                for i in range(256)]
        for f in futs:
            f.result(timeout=60)
    burst()
    try:
        rows.append(trace_window("plane, 256 single requests", burst))
    finally:
        plane.stop()

    nn_cfg = dataclasses.replace(alloc.model.cfg, epochs=1)
    model = build_model("nn", cfg=nn_cfg, device="cuda")
    rows.append(trace_window("nn train, 1 epoch", lambda: model.fit(
        pipe.train_set, scaler=pipe.scaler, std=pipe.std)))
    steps = len(pipe.train_set) // nn_cfg.batch_size
    print(f"    ({steps} steps in the epoch)", flush=True)

    recs = pipe.train_set.records
    values, offsets = ragged_skylines([r.skyline for r in recs])
    allocs = np.array([[max(1, int(round(f * r.observed_tokens)))
                        for f in AREPAS_FRACTIONS] for r in recs], np.int32)
    args_d = [torch.from_numpy(x).cuda() for x in (values, offsets, allocs)]
    ops.arepas_runtimes_ragged(*args_d)
    rows.append(trace_window("K1 on the training set (ragged)",
                             lambda: ops.arepas_runtimes_ragged(*args_d)))
    from repro_torch.cluster import ClusterConfig, FusedReplay, ReplayConfig
    trace = TraceGenerator(seed=71, n_unique=256).generate(CLUSTER_EVENTS)
    cfg = ClusterConfig(admission="edf", capacity=24_576, n_shards=4,
                        elastic=True, pricing="elastic", fused=True)
    cluster = Allocator(alloc.service, n_shards=4)
    cluster.run_cluster(trace, cfg)              # warm: kernels built
    reps = {}
    row = trace_window(f"cluster fused, {len(trace)} events",
                       lambda: reps.setdefault("c", cluster.run_cluster(
                           trace, cfg)))
    row["epochs"] = reps["c"].n_epochs
    row["device_ops_per_epoch"] = row["device_ops"] / row["epochs"]
    print(f"    ({row['epochs']} epochs, {row['device_ops_per_epoch']:.1f} "
          f"device ops an epoch)", flush=True)
    rows.append(row)

    stream = TraceGenerator(seed=71, n_unique=256, rate_qps=100.0).stream(
        REPLAY_EVENTS).buffer()
    replay = FusedReplay(ReplayConfig(
        capacity=4_194_304, n_shards=4, max_leases=8192, epoch_s=480.0,
        queue_block=4096, max_queue=len(stream) + 1), device="cuda")
    replay.run(stream)                           # warm: decisions cached
    row = trace_window(f"replay, {len(stream)} events",
                       lambda: reps.setdefault("r", replay.run(stream)))
    row["epochs"] = reps["r"].n_epochs
    row["device_ops_per_epoch"] = row["device_ops"] / row["epochs"]
    print(f"    ({row['epochs']} epochs, {row['device_ops_per_epoch']:.1f} "
          f"device ops an epoch)", flush=True)
    rows.append(row)
    del args_d, replay, cluster, alloc
    torch.cuda.empty_cache()
    for arch in ("minitron-8b", "zamba2-2.7b", "moonshot-v1-16b-a3b"):
        rows += lm_windows(arch)
        torch.cuda.empty_cache()
    rows += train_window()
    print(json.dumps({"device": smi[0], "windows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
