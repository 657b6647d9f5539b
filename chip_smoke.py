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
  GNN        the gnn family trained on the same dataset (4 epochs) and one
             GNN decide, checked as the main path's.

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


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_tokens(tokens, a, b, observed, policy, price=None):
    """Hold card tokens against the numpy oracle; returns the number of
    flips at ties within 4 ulp of the limit and raises on any other
    mismatch."""
    import numpy as np
    from repro_torch.core.allocator import choose_tokens_priced
    from repro_torch.core.pcc import pcc_runtime
    flips = 0
    for i in range(len(tokens)):
        p = 1.0 if price is None else float(price[i])
        ai, bi, hi = float(a[i]), float(b[i]), int(observed[i])
        want = choose_tokens_priced(ai, bi, policy, p, hi)
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2

    from repro_torch.api import (AllocationRequest, Allocator,
                                 AllocatorConfig, DecisionContext)
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
    del sky, lens, allocs, got, plain

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
    log(f"pow tie flips, all paths: {flips}")

    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
