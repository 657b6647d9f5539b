#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root; needs 1 card

Phases (any failure raises and exits non-zero; nothing is caught):
  set-up     card name, ``nvidia-smi`` name and power limit, and the build
             of every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc
             per source, all started together);
  main path  ``Allocator.from_config`` (nn, lf2) on 20,000 + 5,000 jobs,
             then ``decide`` on the whole evaluation set, with the kernel
             launch counts set to 0 just before and read just after; its
             tokens are held against the numpy ``choose_tokens`` oracle on
             the returned (a, b), a flip allowed only where ``b * t**a`` lies
             within 4 ulp of the limit (CUDA's double ``pow`` is not
             correctly rounded); the history and priced paths likewise;
             decide latency at batch 256 and 4096;
  K1         every skyline of the 25,000-job corpus x 8 allocations through
             the kernel, bitwise against its plain PyTorch version on the
             card (in chunks of at most 2^29 (job, allocation, second)
             elements: whole, its int64 intermediates would not fit) and
             against the numpy oracle on a 1,000-job sample; times of
             kernel, plain version and bound;
  K3 (a)     kernel K3 (fused priced shrink + AREPAS + reprice) on 4,096
             candidates drawn from the same 25,000 skylines, read through a
             row index into the resident K1 pool: bitwise against its plain
             version, tokens against the numpy oracle (4-ulp allowance),
             runtimes against the numpy AREPAS oracle on 500 candidates;
  GNN        the gnn family trained on the same dataset (4 epochs) and one
             GNN decide, checked as the main path's;
  cluster    the second path: ``Allocator.run_cluster`` with the main
             path's nn model on the preempt_cluster benchmark's "edf" arm
             (10,000 events, K = 4 shards of one card, elastic, priced),
             fused (K2 + K3) and unfused (K1 only); the two reports must be
             equal, and the launch counts show which kernels each ran;
  K3 (c)     an untimed fused rerun (its report equal to the fused run's)
             that records the run's largest K1 batch and the arguments of
             its largest K3 batch; K3 on that batch, checked as in (a),
             gives K3's record;
  replay     the third path: ``FusedReplay`` on the fused_cluster
             benchmark's 1,000,000-event stream (K2 every epoch, K1 for the
             pre-decision): conservation, events/s, the H100 roofline row;
  K2         kernel K2 vs its plain version at (K=4, L=8,192, Q=4,096) on
             tables with one edge case per shard; times and bound;
  K3 (b)     kernel K3 on the fused_cluster benchmark's C=512, Smax=512
             batch, checked as in (a); times and bound.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, where no card is visible.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_TRAIN, N_EVAL = 20_000, 5_000     # the paper trains on 85k jobs
GNN_EPOCHS = 4                      # the reference default is 40
PLAIN_ELEMS = 1 << 29              # (jobs, K, Smax) elements per plain call
ORACLE_SAMPLE = 1_000
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, data sheet
CUDA_CORE_OPS_PER_S = 67e12         # H100 SXM non-tensor rate, data sheet
FP64_OPS_PER_S = 34e12              # H100 SXM non-tensor float64, data sheet
CLUSTER_EVENTS = 10_000             # preempt_cluster at scale 1
REPLAY_EVENTS = 1_000_000           # fused_cluster at scale 1
K3_CANDIDATES = 4_096


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_tokens(tokens, a, b, observed, policy, price=None, cap=None,
                 floor=None):
    """Hold card tokens against the numpy oracle (then min(cap) and
    max(floor) where given, as kernel K3 applies them); returns the number
    of flips at ties within 4 ulp of the limit and raises on any other
    mismatch."""
    import numpy as np
    from repro_torch.core.allocator import choose_tokens_priced
    from repro_torch.core.pcc import pcc_runtime
    flips = 0
    for i in range(len(tokens)):
        p = 1.0 if price is None else float(price[i])
        ai, bi, hi = float(a[i]), float(b[i]), int(observed[i])
        want = choose_tokens_priced(ai, bi, policy, p, hi)
        if cap is not None:
            want = min(want, int(cap))
        if floor is not None:
            want = max(want, int(floor[i]))
        if int(tokens[i]) == want:
            continue
        limit = (1.0 + policy.max_slowdown * p) * float(pcc_runtime(ai, bi, hi))
        t1, t2 = sorted((int(tokens[i]), want))
        near = any(abs(float(pcc_runtime(ai, bi, t)) - limit)
                   <= 4 * np.spacing(limit) for t in (t1, t2 - 1))
        if not near:
            raise AssertionError(
                f"row {i}: card tokens {int(tokens[i])} != oracle {want} "
                f"(a={ai!r}, b={bi!r}, observed={hi}, price={p})")
        flips += 1
    return flips


def check_decision(d, observed, policy, what):
    import numpy as np
    B = len(observed)
    assert d.tokens.shape == (B,) and d.tokens.dtype == np.int64, what
    for name in ("a", "b", "runtime", "cost"):
        assert np.all(np.isfinite(getattr(d, name))), (what, name)
    assert np.all(d.a <= 0) and np.all(d.b > 0), what
    assert np.all((d.tokens >= policy.min_tokens) & (d.tokens <= observed)), what
    flips = check_tokens(d.tokens, d.a, d.b, observed, policy, d.price)
    log(f"{what}: {B} decisions; tokens == numpy oracle except {flips} "
        f"flip(s) within 4 ulp of the limit")
    return flips


def decide_latency_ms(alloc, request, batch, reps=20):
    import numpy as np
    req = request.narrow(slice(0, batch))
    for _ in range(3):
        alloc.decide(req)
    times = []
    for _ in range(reps):
        _, dt = sync_time(lambda: alloc.decide(req))
        times.append(dt * 1e3)
    return float(np.median(times))


def kernel_ms(fn, reps=30):
    """Median CUDA-event time of ``fn`` with the 50 MB L2 flushed before
    each launch."""
    import numpy as np
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def k3_inputs(np, rng, lens, obs, a, b):
    """(C,) candidate vectors for kernel K3 around given PCCs."""
    C = len(obs)
    return dict(a=np.asarray(a, np.float64), b=np.asarray(b, np.float64),
                price=rng.choice([1.0, 1.5, 4.0], C),
                obs=np.asarray(obs, np.int64),
                floor=np.where(rng.rand(C) < 0.25,
                               rng.randint(1, 2000, C), 1).astype(np.int64),
                done=rng.choice([0.0, 0.25, 0.5, 0.999], C),
                cand_tok=np.asarray(obs, np.int64),
                cand_end=rng.uniform(100.0, 5000.0, C))


def k3_phase(name, sky, lens, rows, vecs, now, epoch_s, policy, cap,
             sky_np, lens_np, rows_np):
    """Kernel K3 vs its plain version (bitwise), the numpy oracles, and its
    times; returns (kernel record fields, flips)."""
    import numpy as np
    import torch
    from repro_torch.core.arepas import simulate_runtime
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_step import resize_step_ref
    keys = ("a", "b", "price", "obs", "floor", "done", "cand_tok",
            "cand_end")
    v = [torch.from_numpy(vecs[k]).cuda() for k in keys]
    C = len(rows_np)
    run_kernel = lambda: ops.cluster_resize_step(
        *v, sky, lens, now, epoch_s, policy=policy, cap=cap, rows=rows)
    chunk = max(1, PLAIN_ELEMS // sky.shape[1])

    def run_plain():
        parts = [resize_step_ref(*[t[i:i + chunk] for t in v],
                                 sky[rows[i:i + chunk]],
                                 lens[rows[i:i + chunk]], now, epoch_s,
                                 policy=policy, cap=cap)
                 for i in range(0, C, chunk)]
        return [torch.cat(p) for p in zip(*parts)]

    got = run_kernel()
    want, _ = sync_time(run_plain)
    max_abs_err = 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        diff = (g.double() - w.double()).abs().max()
        max_abs_err = max(max_abs_err, float(diff))
        assert torch.equal(g, w), f"{name}: K3 != plain version"
    tgt = got[0].cpu().numpy()
    rt = got[2].cpu().numpy()
    flips = check_tokens(tgt, vecs["a"], vecs["b"], vecs["obs"], policy,
                         vecs["price"], cap=cap, floor=vecs["floor"])
    sample = np.random.RandomState(1).choice(C, min(500, C), replace=False)
    for c in sample:
        r = int(rows_np[c])
        want_rt = max(simulate_runtime(sky_np[r, :lens_np[r]],
                                       max(int(tgt[c]), 1)), 1)
        assert int(rt[c]) == want_rt, (name, int(c), int(rt[c]), want_rt)
    ms = kernel_ms(run_kernel)
    _, plain_s = sync_time(run_plain)
    valid = int(lens_np[rows_np].clip(0, sky.shape[1]).sum())
    n_bytes = 4 * valid + C * (8 * 8 + 4 + 8) + C * (8 + 1 + 8 + 8)
    n_int_ops = 2 * valid
    n_f64_ops = C * (4 * 48 + 12)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (n_int_ops / CUDA_CORE_OPS_PER_S
              + n_f64_ops / FP64_OPS_PER_S) * 1e3
    log(f"K3 {name}: {C} candidates, {valid} valid skyline seconds; == "
        f"plain version (bitwise); tokens == numpy oracle except {flips} "
        f"flip(s) within 4 ulp; rt == numpy AREPAS on {len(sample)}; kernel "
        f"{ms:.4f} ms (median of 30, L2 flushed), plain {plain_s * 1e3:.3f} "
        f"ms, bound {max(bytes_ms, ops_ms):.5f} ms ({n_bytes} bytes; ops "
        f"{ops_ms:.5f} ms)")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}, flips


def k2_phase():
    """Kernel K2 vs its plain version at the replay's shapes, on tables
    with one edge case per shard; returns the kernel record fields."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_step import epoch_step_ref
    K, L, Q = 4, 8192, 4096
    rng = np.random.RandomState(12)
    now = 1000.0
    live = rng.rand(K, L) < 0.7
    tokens = np.where(live, rng.randint(1, 64, (K, L)), 0).astype(np.int64)
    end = np.where(live, now + rng.randint(-200, 400, (K, L)) * 0.5, np.inf)
    end[1] = np.where(live[1], now - 1.0, np.inf)         # all expire
    tokens[2] = rng.randint(1, 64, L)                     # full table:
    end[2] = now + 5.0                                    # open slots bind
    end[2, :37] = now - 3.0
    end[3] = np.where(live[3], now + 10.0, np.inf)        # a few end ==
    end[3, :20] = np.where(live[3, :20], now, np.inf)     # now exactly
    free = np.array([5000, 0, 10 ** 9, 3], np.int64)      # 3: free binds
    q_tok = rng.randint(1, 64, (K, Q)).astype(np.int64)
    q_tok[:, Q - 100:] = 0
    q_end = now + rng.randint(1, 5000, (K, Q)).astype(np.float64)
    args = [torch.from_numpy(x).cuda() for x in (end, tokens, free, q_tok,
                                                  q_end)]
    got = ops.cluster_epoch_step(*args, now)
    want, _ = sync_time(lambda: epoch_step_ref(*args, now))
    max_abs_err = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert torch.equal(g, w), "K2 != plain version"
        finite = torch.isfinite(g.double()) & torch.isfinite(w.double())
        if bool(finite.any()):
            max_abs_err = max(max_abs_err, float(
                (g.double() - w.double())[finite].abs().max()))
    n_admit = got[3].cpu().numpy()
    log(f"K2 == plain version at K={K}, L={L}, Q={Q} (bitwise); admitted "
        f"{n_admit.tolist()}, expired {got[6].cpu().numpy().tolist()}")
    n_exp = got[6].cpu().numpy()
    assert n_admit[2] == 37 and n_admit[0] > 0 and n_exp[1] == live[1].sum()
    assert 0 < n_admit[3] < Q - 100 and n_exp[3] == live[3, :20].sum()
    ms = kernel_ms(lambda: ops.cluster_epoch_step(*args, now))
    _, plain_s = sync_time(lambda: epoch_step_ref(*args, now))
    n_bytes = 4 * K * L * 8 + 2 * K * Q * 8 + K * Q * 4 + 5 * K * 8
    n_ops = 6 * K * L + 6 * K * Q
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    log(f"K2: {ms:.4f} ms (median of 30, L2 flushed); plain version "
        f"{plain_s * 1e3:.3f} ms; bound {max(bytes_ms, ops_ms):.5f} ms "
        f"({n_bytes} bytes at 3.35 TB/s)")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def cluster_phase(alloc):
    """The cluster path, fused and unfused, through ``run_cluster``; then an
    untimed fused rerun that records the run's batch sizes and holds kernel
    K3 against its plain version on the largest batch the path gave it.
    Returns the fused run's launch counts, K3's record fields at that
    batch and its flip count."""
    import numpy as np
    import torch
    from repro_torch.cluster import ClusterConfig, ClusterSimulator
    from repro_torch.kernels import ops
    from repro_torch.workloads import TraceGenerator
    t0 = time.perf_counter()
    trace = TraceGenerator(seed=71, n_unique=256).generate(CLUSTER_EVENTS)
    log(f"cluster trace: {len(trace)} events, {len(trace.jobs)} templates, "
        f"longest skyline {max(len(s) for s in trace.skylines)} s "
        f"({time.perf_counter() - t0:.3f} s)")
    reports, counts = {}, {}
    for fused in (False, True):
        cfg = ClusterConfig(admission="edf", capacity=24_576, n_shards=4,
                            elastic=True, pricing="elastic", fused=fused)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = alloc.run_cluster(trace, cfg)
        wall = time.perf_counter() - t0
        counts[fused] = ops.launch_counts()
        reports[fused] = rep
        m = rep.metrics
        log(f"cluster {'fused' if fused else 'unfused'}: {rep.n_events} "
            f"events, {rep.n_epochs} epochs, {wall:.3f} s wall, "
            f"{rep.n_events / wall:.1f} events/s; launches {counts[fused]}; "
            f"resize shrinks {int(m.get('resize_shrinks', 0))}")
        log(f"  {rep.summary()}")
    base, fused = reports[False], reports[True]
    assert dict(base.metrics) == dict(fused.metrics), "fused != unfused"
    np.testing.assert_array_equal(base.alloc_errors, fused.alloc_errors)
    np.testing.assert_array_equal(base.cache_hits, fused.cache_hits)
    np.testing.assert_array_equal(base.error_series[0], fused.error_series[0])
    assert np.array_equal(base.error_series[1], fused.error_series[1],
                          equal_nan=True)
    assert base.cache_stats == fused.cache_stats
    m = fused.metrics
    assert m["n_completed"] + m["n_rejected"] == CLUSTER_EVENTS
    assert m.get("resize_shrinks", 0) > 0, "no shrink fired"
    assert counts[True]["cluster_epoch_step"] > 0
    assert counts[True]["cluster_resize_step"] > 0
    assert counts[False]["cluster_epoch_step"] == 0
    assert counts[False]["cluster_resize_step"] == 0
    assert counts[True]["arepas_runtimes"] > 0
    assert counts[False]["arepas_runtimes"] > 0
    log("cluster: fused report == unfused report (metrics, alloc_errors, "
        "cache_hits, error_series, cache_stats)")

    # the untimed rerun: the largest K1 batch (the reference pads to a
    # 4,096-row bucket and asserts past it; the port takes any size) and
    # the arguments of the largest K3 batch
    seen = {"K1": 0, "K3": None}

    class Recording(ClusterSimulator):
        def _true_runtimes(self, jb, tokens):
            seen["K1"] = max(seen["K1"], len(jb))
            return super()._true_runtimes(jb, tokens)

        def _fused_resize(self, a, b, price, obs, floor, done, cand_tok,
                          cand_end, jb, now, cap_shard):
            if seen["K3"] is None or len(a) > len(seen["K3"]["a"]):
                f64 = lambda x: np.array(x, np.float64)
                i64 = lambda x: np.array(x, np.int64)
                seen["K3"] = dict(
                    a=f64(a), b=f64(b), price=f64(price), obs=i64(obs),
                    floor=i64(floor), done=f64(done), cand_tok=i64(cand_tok),
                    cand_end=f64(cand_end), jb=i64(jb), now=float(now),
                    cap=int(cap_shard), sky=self._sky, lens=self._lens)
            return super()._fused_resize(a, b, price, obs, floor, done,
                                         cand_tok, cand_end, jb, now,
                                         cap_shard)

    cfg = ClusterConfig(admission="edf", capacity=24_576, n_shards=4,
                        elastic=True, pricing="elastic", fused=True)
    again = Recording(alloc.service, cfg, fabric=alloc.fabric,
                      obs=alloc.obs).run(trace)
    assert dict(again.metrics) == dict(fused.metrics), "rerun differs"
    big = seen["K3"]
    log(f"cluster: rerun metrics == fused run's; largest K1 batch "
        f"{seen['K1']}, largest K3 batch {len(big['a'])}")
    rows_np = big["jb"]
    k3_c, flips = k3_phase(
        "(c) cluster path's largest batch", big["sky"], big["lens"],
        torch.from_numpy(rows_np).cuda(), big, big["now"], cfg.epoch_s,
        alloc.service.policy, big["cap"], big["sky"].cpu().numpy(),
        big["lens"].cpu().numpy(), rows_np)
    return counts[True], k3_c, flips


def replay_phase():
    from repro_torch.cluster import FusedReplay, ReplayConfig
    from repro_torch.kernels import ops
    from repro_torch.workloads import TraceGenerator
    t0 = time.perf_counter()
    stream = TraceGenerator(seed=71, n_unique=256, rate_qps=100.0).stream(
        REPLAY_EVENTS).buffer()
    log(f"replay stream: {len(stream)} events "
        f"({time.perf_counter() - t0:.3f} s on the host)")
    cfg = ReplayConfig(capacity=4_194_304, n_shards=4, max_leases=8192,
                       epoch_s=480.0, queue_block=4096,
                       max_queue=len(stream) + 1)
    ops.reset_launch_counts()
    rep = FusedReplay(cfg, device="cuda").run(stream)
    counts = ops.launch_counts()
    assert rep.n_admitted + rep.n_rejected == rep.n_events, "conservation"
    assert rep.n_completed == rep.n_admitted, "leases outstanding"
    assert rep.launches == rep.n_epochs
    assert counts["cluster_epoch_step"] >= rep.launches
    assert counts["arepas_runtimes"] >= 1
    log(f"replay: {rep.summary()}; wall {rep.wall_s} s; launches {counts}")
    log(f"replay roofline: {json.dumps(rep.roofline.row())}")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2

    from repro_torch.api import (AllocationRequest, Allocator,
                                 AllocatorConfig, DecisionContext)
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.core.arepas import simulate_runtime, simulate_runtime_batch
    from repro_torch.core.dataset import AREPAS_FRACTIONS, pad_skylines
    from repro_torch.core.evaluate import eval_pcc_model
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.serve import AllocationService

    # ---------------------------------------------------------------- set-up
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi[0])
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s for {sorted(libs)}")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ------------------------------------------------------------- main path
    cfg = AllocatorConfig(family="nn", loss="lf2", pipeline=TasqConfig(
        n_train=N_TRAIN, n_eval=N_EVAL, gnn_epochs=GNN_EPOCHS))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    alloc = Allocator.from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    from_config_s = time.perf_counter() - t0
    pipe = alloc.pipeline
    ds = pipe.eval_set
    request = AllocationRequest.from_dataset(alloc.model, ds)
    d, decide_s = sync_time(lambda: alloc.decide(request))
    launches = ops.launch_counts()
    log(f"main path launches: {launches}")
    assert launches["arepas_runtimes"] >= 1, "build did not launch K1"
    t = pipe.timings
    log(f"from_config: {from_config_s:.3f} s = corpus {t['corpus_s']:.3f} s "
        f"+ datasets {t['dataset_s']:.3f} s (host skylines "
        f"{t['skylines_s']:.3f} s, host padding {t['pad_s']:.3f} s, copies + "
        f"K1 + copy back {t['arepas_s']:.3f} s, fits/features "
        f"{t['assemble_s']:.3f} s) + nn train {t['nn:lf2_train_s']:.3f} s "
        f"({t['nn:lf2_epoch_s'] * 1e3:.1f} ms/epoch); "
        f"decide {len(ds)} jobs: {decide_s:.3f} s")
    observed = np.asarray(ds.observed_alloc, np.int64)
    flips = check_decision(d, observed, alloc.policy, "nn decide (model path)")
    ev = eval_pcc_model(alloc.model, ds)
    log(f"nn eval: {ev.row()}")
    assert ev.pattern_non_increase == 1.0 and np.isfinite(ev.median_ae_runtime)

    price = np.where(np.arange(len(ds)) % 3 == 0, 1.5, 1.0)
    dh = alloc.decide(AllocationRequest.from_params(ds.target_a, ds.target_b,
                                                    observed),
                      DecisionContext(price=price))
    flips += check_decision(dh, observed, alloc.policy,
                            "history path, priced")
    dp = alloc.decide(request, DecisionContext(price=price))
    flips += check_decision(dp, observed, alloc.policy, "model path, priced")
    lat = {b: decide_latency_ms(alloc, request, b) for b in (256, 4096)}
    log(f"decide latency (median of 20, host clock): batch 256 "
        f"{lat[256]:.3f} ms, batch 4096 {lat[4096]:.3f} ms")

    # -------------------------------------------------------------------- K1
    recs = pipe.train_set.records + ds.records
    sky_np, lens_np = pad_skylines([r.skyline for r in recs])
    allocs_np = np.array([[max(1, int(round(f * r.observed_tokens)))
                           for f in AREPAS_FRACTIONS] for r in recs], np.int32)
    sky = torch.from_numpy(sky_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    allocs = torch.from_numpy(allocs_np).cuda()
    J, K = allocs.shape
    log(f"K1 inputs: skylines {tuple(sky.shape)} int32, allocations "
        f"{tuple(allocs.shape)}; valid seconds {int(lens_np.sum())}")
    chunk = max(1, PLAIN_ELEMS // (K * sky.shape[1]))
    run_kernel = lambda: ops.arepas_runtimes(sky, lens, allocs)
    run_plain = lambda: torch.cat([
        simulate_runtime_batch(sky[i:i + chunk], lens[i:i + chunk],
                               allocs[i:i + chunk])
        for i in range(0, J, chunk)])
    got = run_kernel()
    plain, _ = sync_time(run_plain)
    max_abs_err = int((got.long() - plain.long()).abs().max())
    assert torch.equal(got, plain), f"K1 != plain version (max {max_abs_err})"
    log(f"K1 == plain version on {J} jobs x {K} allocations (bitwise; "
        f"plain in {chunk}-job chunks)")
    got_np = got.cpu().numpy()
    sample = np.random.RandomState(0).choice(J, ORACLE_SAMPLE, replace=False)
    for j in sample:
        for k in range(K):
            want = simulate_runtime(sky_np[j, :lens_np[j]], int(allocs_np[j, k]))
            assert got_np[j, k] == want, (int(j), k, int(got_np[j, k]), want)
    log(f"K1 == numpy oracle on a {ORACLE_SAMPLE}-job sample (bitwise)")
    k1_ms = kernel_ms(run_kernel)
    _, plain_s = sync_time(run_plain)
    n_bytes = 4 * (int(lens_np.sum()) + J + 2 * J * K)
    n_ops = 2 * K * int(lens_np.sum())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"K1: {k1_ms:.4f} ms (median of 30, L2 flushed); plain version "
        f"{plain_s * 1e3:.3f} ms; bound {bound_ms:.4f} ms "
        f"({n_bytes} bytes at 3.35 TB/s; ops {ops_ms:.4f} ms)")
    kernels = [{
        "name": "arepas_runtimes", "route": "cuda",
        "source": "src/repro_torch/csrc/skyline.cu",
        "replaces": "src/repro/kernels/skyline.py:117",
        "launches": launches["arepas_runtimes"], "max_abs_err": max_abs_err,
        "ms": k1_ms, "plain_ms": plain_s * 1e3, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]
    del allocs, got, plain

    # ---------------------------------------------------------------- K3 (a)
    rng = np.random.RandomState(3)
    rows_np = np.sort(rng.choice(J, K3_CANDIDATES, replace=False))
    tgt_a = np.concatenate([pipe.train_set.target_a, ds.target_a])[rows_np]
    tgt_b = np.concatenate([pipe.train_set.target_b, ds.target_b])[rows_np]
    obs_all = np.array([r.observed_tokens for r in recs], np.int64)
    k3_vecs = k3_inputs(np, rng, lens_np, obs_all[rows_np], tgt_a, tgt_b)
    k3_a, k3_flips = k3_phase(
        "(a) corpus", sky, lens, torch.from_numpy(rows_np).cuda(), k3_vecs,
        50.0, 15.0, alloc.policy, 6_144, sky_np, lens_np, rows_np)
    flips += k3_flips
    del sky, lens

    # ------------------------------------------------------------------- GNN
    t0 = time.perf_counter()
    gnn = pipe.train("gnn", loss="lf2")
    torch.cuda.synchronize()
    log(f"gnn train ({GNN_EPOCHS} epochs): {time.perf_counter() - t0:.3f} s")
    gnn_service = AllocationService(gnn, alloc.policy, device="cuda")
    dg, dg_s = sync_time(lambda: gnn_service.decide(
        AllocationRequest.from_dataset(gnn, ds)))
    log(f"gnn decide {len(ds)} jobs: {dg_s:.3f} s")
    flips += check_decision(dg, observed, alloc.policy, "gnn decide")
    log(f"gnn eval: {eval_pcc_model(gnn, ds).row()}")
    del gnn, gnn_service, sky_np

    # ------------------------------------------------- cluster path (fused)
    cluster_counts, k3_c, k3_flips = cluster_phase(
        Allocator(AllocationService(alloc.model, alloc.policy,
                                    device="cuda"), n_shards=4))
    flips += k3_flips

    # --------------------------------------------------------- replay path
    replay_phase()

    # -------------------------------------------------------------------- K2
    k2 = k2_phase()
    kernels.append({
        "name": "cluster_epoch_step", "route": "cuda",
        "source": "src/repro_torch/csrc/cluster_step.cu",
        "replaces": "src/repro/kernels/cluster_step.py:246",
        "launches": cluster_counts["cluster_epoch_step"], **k2,
        "library_ms": None})

    # ---------------------------------------------------------------- K3 (b)
    rng = np.random.default_rng(7)
    n_cand, smax_b = 512, 512
    sky_b = np.zeros((n_cand, smax_b), np.int32)
    lens_b = rng.integers(8, smax_b // 2, n_cand).astype(np.int32)
    for i, ln in enumerate(lens_b):
        sky_b[i, :ln] = rng.integers(1, 64, ln)
    obs_b = rng.integers(4, 256, n_cand).astype(np.int64)
    vecs_b = dict(a=np.full(n_cand, -0.7), b=lens_b.astype(np.float64) * 8.0,
                  price=np.full(n_cand, 1.4), obs=obs_b,
                  floor=np.ones(n_cand, np.int64),
                  done=rng.uniform(0, 0.8, n_cand), cand_tok=obs_b.copy(),
                  cand_end=rng.uniform(100, 500, n_cand))
    rows_b = np.arange(n_cand)
    k3_b, k3_flips = k3_phase(
        "(b) benchmark batch", torch.from_numpy(sky_b).cuda(),
        torch.from_numpy(lens_b).cuda(), torch.from_numpy(rows_b).cuda(),
        vecs_b, 50.0, 8.0, AllocationPolicy(max_slowdown=0.05), 65_536,
        sky_b, lens_b, rows_b)
    flips += k3_flips
    kernels.append({
        "name": "cluster_resize_step", "route": "cuda",
        "source": "src/repro_torch/csrc/cluster_step.cu",
        "replaces": "src/repro/kernels/cluster_step.py:413",
        "launches": cluster_counts["cluster_resize_step"], **k3_c,
        "library_ms": None})
    log(f"K3 record: shapes of (c); (a): {json.dumps(k3_a)}; (b): "
        f"{json.dumps(k3_b)}")
    log(f"pow tie flips, all paths: {flips}")

    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
