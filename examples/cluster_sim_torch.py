"""Cluster simulation quickstart on the PyTorch port: a multi-tenant query
stream through the serving stack, end to end (``repro_torch``; the twin of
``examples/cluster_sim_torch.py``, with ``--device``: the card, ``cuda``, by
default, where the simulator's AREPAS runs on kernel K1 and ``--fused``
runs K2 and K3).

  1. build the whole serving stack declaratively — pipeline, NN PCC model,
     policy, mesh, fabric, router — from one AllocatorConfig
     (repro_torch.api.Allocator.from_config),
  2. synthesize a bursty, Zipf-repeated, SLA-tagged trace (TraceGenerator),
  3. replay it through the allocator's fabric against a finite token pool
     with priority admission (repro_torch.cluster) — every decision flows through
     the typed AllocationRequest -> decide() -> AllocationDecision protocol,
  4. watch the online PCC refinement loop: repeat queries graduate from the
     learned model to their exact-history PCCCache entry, and the
     allocation error vs the exact-PCC oracle collapses,
  5. optionally switch the scheduler: --admission edf --elastic
     --pricing elastic replays the same trace under deadline-aware EDF
     admission with lease resizing and per-SLA-class repricing, and prints
     the cost / SLA delta vs. the priority/fixed baseline; --admission
     edf_aging adds starvation aging, and --admission drf --preempt runs
     dominant-resource-fair admission with checkpoint-and-requeue
     preemption (preempted remainders re-enter the queue as fresh typed
     requests and may land on another shard),
  6. optionally shard the fabric: --shards K replays through K racks behind
     consistent-hash routing (--load-factor tunes the router's bounded-load
     factor) and prints the per-shard utilization / imbalance / spill
     summary from the fabric metrics columns,
  7. optionally run the epoch loop through the fused cluster kernels:
     --fused routes expire/release/admit/scatter through the
     single-launch `cluster_epoch_step` path (decision-identical to the
     unfused loop; see tests/test_cluster.py),
  8. optionally record the run through the observability plane:
     --trace-out writes a Perfetto/Chrome trace_event timeline of the
     replay (open at https://ui.perfetto.dev), --metrics-out writes the
     metrics snapshot (counters + decision-latency histograms), and either
     flag prints the decision-latency percentiles,
  9. optionally drift the workload and close the retraining loop:
     --drift makes the generator rotate in previously-unseen templates
     with growing resource volume mid-trace
     (repro_torch.workloads.DriftSpec), and --retrain-every N attaches
     the mlops loop (repro_torch.mlops): a
     DriftMonitor watches features and prediction residuals online while
     a cadence-policy RetrainController refits the PCC model every N
     completions and hot-swaps it in with zero decision downtime (the
     incoming service is AOT-warmed off the hot path before the atomic
     repoint).

Run:  PYTHONPATH=src python examples/cluster_sim_torch.py [--events 3000]
      PYTHONPATH=src python examples/cluster_sim_torch.py --admission edf \
          --elastic --pricing elastic
      PYTHONPATH=src python examples/cluster_sim_torch.py --shards 4 --fused
      PYTHONPATH=src python examples/cluster_sim_torch.py \
          --trace-out trace.json --metrics-out metrics.json
      PYTHONPATH=src python examples/cluster_sim_torch.py --drift \
          --retrain-every 800
"""
import argparse

import numpy as np

from repro_torch.api import Allocator, AllocatorConfig
from repro_torch.cluster import ClusterConfig
from repro_torch.core.models import NNConfig
from repro_torch.core.pipeline import TasqConfig
from repro_torch.mlops import DriftMonitor, MLOpsLoop, RetrainController
from repro_torch.obs import Obs, write_trace
from repro_torch.workloads import DriftSpec, TraceGenerator


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--events", type=int, default=3000)
    ap.add_argument("--n-train", type=int, default=300)
    ap.add_argument("--n-unique", type=int, default=96)
    ap.add_argument("--admission", default="priority",
                    choices=("fifo", "priority", "edf", "edf_aging", "drf"))
    ap.add_argument("--elastic", action="store_true",
                    help="resize running leases under pressure / idleness")
    ap.add_argument("--preempt", action="store_true",
                    help="checkpoint-and-requeue preemption (needs a "
                         "victim-aware admission policy, e.g. --admission "
                         "drf)")
    ap.add_argument("--pricing", default="fixed",
                    choices=("fixed", "elastic"))
    ap.add_argument("--shards", type=int, default=1,
                    help="replicas in the sharded serving fabric")
    ap.add_argument("--load-factor", type=float, default=1.25,
                    help="router bounded-load factor (>= 1)")
    ap.add_argument("--fused", action="store_true",
                    help="run the epoch loop through the fused cluster "
                         "kernels (decision-identical)")
    ap.add_argument("--trace-out", default="", metavar="TRACE.json",
                    help="write the replay as a Perfetto/Chrome "
                         "trace_event file (ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="", metavar="METRICS.json",
                    help="write the obs metrics snapshot (counters, "
                         "gauges, latency histograms)")
    ap.add_argument("--drift", action="store_true",
                    help="rotate unseen, higher-volume templates into the "
                         "mix mid-trace (workload drift)")
    ap.add_argument("--retrain-every", type=int, default=0, metavar="N",
                    help="refit the PCC model every N completions and "
                         "hot-swap it in with zero decision downtime "
                         "(0 = retraining off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.shards < 1:
        ap.error("--shards must be >= 1")
    obs = Obs.enabled() if (args.trace_out or args.metrics_out) else None

    print("training the cold-path PCC model ...")
    allocator = Allocator.from_config(AllocatorConfig(
        family="nn", loss="lf2", policy="bounded_slowdown",
        n_shards=args.shards, load_factor=args.load_factor,
        pipeline=TasqConfig(n_train=args.n_train, n_eval=60,
                            nn=NNConfig(epochs=15))), obs=obs,
        device=args.device)

    drift = DriftSpec(n_new=args.n_unique // 2, onset=0.25, rotation=0.6,
                      volume_growth=4.0) if args.drift else None
    gen = TraceGenerator(seed=23, n_unique=args.n_unique, n_tenants=6,
                         rate_qps=0.5, drift=drift)
    trace = gen.generate(args.events)
    print(f"trace: {len(trace)} queries over {len(trace.jobs)} unique "
          f"scripts, {trace.events[-1].arrival_s/60:.0f} min of arrivals, "
          f"{np.mean(trace.repeat_mask()):.0%} repeats")

    mlops = None
    if args.retrain_every > 0:
        mlops = MLOpsLoop(
            allocator,
            RetrainController(
                family="nn", policy="cadence",
                policy_overrides={"every": args.retrain_every},
                pipeline_cfg=TasqConfig(n_train=args.n_train, n_eval=60,
                                        nn=NNConfig(epochs=15)),
                max_train=args.n_train, obs=obs, device=args.device),
            DriftMonitor(obs=obs))

    capacity = 8192 // args.shards * args.shards   # equal per-shard slices
    report = allocator.run_cluster(
        trace, ClusterConfig(capacity=capacity, n_shards=args.shards,
                             load_factor=args.load_factor, fused=args.fused,
                             preemption=args.preempt),
        admission=args.admission, elastic=args.elastic, pricing=args.pricing,
        mlops=mlops)

    print(f"\n{report.summary()}")
    m = report.metrics
    if args.shards > 1:
        utils = [m.get(f"utilization_shard{k}", 0.0)
                 for k in range(args.shards)]
        print(f"  fabric: {args.shards} shards | per-shard util "
              + " ".join(f"{u:.2f}" for u in utils)
              + f" | imbalance {m.get('shard_imbalance', 1.0):.2f}x"
              + f" | spilled {m.get('n_spilled', 0)} "
              f"({m.get('spill_rate', 0.0):.1%})")
        shares = [r["queries"] for r in report.replica_stats]
        print(f"  decisions per replica: {shares}")
    if args.preempt:
        print(f"  preemption: {m.get('preemptions', 0)} leases checkpointed "
              f"({m.get('preempted_tokens_reclaimed', 0)} tokens reclaimed)")
    if args.admission != "priority" or args.elastic or args.pricing != "fixed":
        # same fabric topology, scheduler knobs at defaults: the printed
        # delta isolates the scheduler change, not the sharding change
        base = allocator.run_cluster(
            trace, ClusterConfig(capacity=capacity, n_shards=args.shards,
                                 load_factor=args.load_factor))
        bm = base.metrics
        print(f"  vs priority/fixed baseline: "
              f"cost cut {1 - m['cost_token_s']/bm['cost_token_s']:.1%}, "
              f"SLA violations {bm['sla_violation_rate']:.1%} -> "
              f"{m['sla_violation_rate']:.1%}, "
              f"mean price {m.get('mean_price', 1.0):.2f}, "
              f"resizes {m.get('resize_shrinks', 0)} shrink / "
              f"{m.get('resize_grows', 0)} grow")
    print(f"  allocation error vs exact-PCC oracle: "
          f"model path {m.get('alloc_error_model', 0):.2f}, "
          f"cache path {m.get('alloc_error_cache', 0):.2f}")
    t, err = report.error_series
    ok = ~np.isnan(err)
    t, err = t[ok], err[ok]
    if t.size >= 4:
        q = np.array_split(np.arange(t.size), 4)
        print("  mean decision error by trace quarter:",
              "  ".join(f"{np.nanmean(err[i]):.2f}" for i in q))
    print(f"  cache: {report.cache_stats}")
    if mlops is not None:
        print(f"  mlops: {len(mlops.monitor.signals)} drift signals, "
              f"{len(mlops.swaps)} hot-swaps, model v"
              f"{mlops.allocator.model_version}, rolling model error "
              f"{mlops.rolling_model_error():.3f}")
        for s in mlops.swaps:
            print(f"    swap v{s['version']} @ t={s['t_s']:.0f}s "
                  f"({s['trigger']}): {s['n_train']} jobs, train "
                  f"{s['train_s']:.1f}s, warm {s['cold_start_s']:.1f}s "
                  f"({s['n_precompiled']} executables) — all off the "
                  "decision hot path")

    if obs is not None:
        h = obs.metrics.histogram("decision_latency_s")
        if h.n:
            print(f"  decision latency (cached calls, n={h.n}): "
                  f"p50 {h.percentile(50)*1e3:.2f}ms  "
                  f"p99 {h.percentile(99)*1e3:.2f}ms  "
                  f"p999 {h.percentile(99.9)*1e3:.2f}ms")
        if args.trace_out:
            n = write_trace(args.trace_out, obs.tracer.records())
            print(f"  perfetto trace ({n} events) -> {args.trace_out} "
                  "(open at https://ui.perfetto.dev)")
        if args.metrics_out:
            obs.metrics.save(args.metrics_out)
            print(f"  metrics snapshot -> {args.metrics_out}")


if __name__ == "__main__":
    main()
