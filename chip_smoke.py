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
             the kernel in the ragged layout the main path gives it (flat
             values and offsets: the valid seconds only, their bytes on the
             card printed), bitwise against its plain PyTorch version on
             the card (padded a chunk of jobs at a time, at most 2^29 (job,
             allocation, second) elements a chunk) and against the numpy
             oracle on a 1,000-job sample; times of kernel, plain version
             and bound;
  K3 (a)     kernel K3 (fused priced shrink + AREPAS + reprice) on 4,096
             candidates drawn from the same 25,000 skylines, read through a
             row index into a pool of the candidates' padded skylines:
             bitwise against its plain version, tokens against the numpy
             oracle (4-ulp allowance), runtimes against the numpy AREPAS
             oracle on 500 candidates;
  GNN        the gnn family trained on the same dataset (4 epochs) and one
             GNN decide, checked as the main path's;
  eval       the paper's evaluation on the main path's pipeline: Figure 2
             (``token_reduction_cdf`` at slowdowns 0 and 0.05 over the
             25,000 corpus skylines on the card, K1 one launch a bisection
             round, the launches counted from 0 around each call and
             matched to the rounds; the tokens, bisected again on the
             ragged corpus the main path holds on the card, against the
             CPU twin on a seeded 2,000-job sample and the numpy oracle on
             300 jobs, 0 mismatches; K1 at its (J, 1) shape against its
             plain version, timed with its bound); §5.1 selection at the
             runner's fig10 settings (KS before and after); Table 8 (the
             gbdt trained on the same dataset; ``ground_truth_records`` on
             the table8 selection, the xgboost_ss, xgboost_pl, nn and gnn
             rows); ``choose_tokens_batch`` and ``choose_tokens_priced_batch``
             at batch 4,096 against the scalar oracles (4-ulp allowance);
  cluster    the second path: ``Allocator.run_cluster`` with the main
             path's nn model on the preempt_cluster benchmark's "edf" arm
             (10,000 events, K = 4 shards of one card, elastic, priced),
             on an allocator whose executable grid was warmed first (CUDA
             graphs, buckets 8..4096), fused (K2 + K3) and unfused (K1
             only); the two reports must be equal and build nothing, and
             the launch counts show which kernels each ran;
  K3 (c)     an untimed fused rerun (its report equal to the fused run's)
             that records the arguments of the run's largest K1 and K3
             batches and of its K2 launch with the longest queue; K1 on its
             batch and K2 on its tables, each bitwise against its plain
             version and timed beside its bound (the two kernels as the
             cluster path launches them); K3 on its batch, checked as in
             (a), gives K3's record;
  replay     the third path: ``FusedReplay`` on the fused_cluster
             benchmark's 1,000,000-event stream (K2 every epoch, K1 for the
             pre-decision): conservation, events/s, the H100 roofline row;
  K2         kernel K2 (one thread-block cluster a shard) vs its plain
             version at the replay's (K=4, L=8,192, Q=4,096) on tables with
             one edge case per shard; times and bound;
  K3 (b)     kernel K3 on the fused_cluster benchmark's C=512, Smax=512
             batch, checked as in (a); times and bound;
  plane      the serving plane over the main path's nn model: (1) the
             AOT grid to bucket 4,096, both observed modes, priced, as CUDA
             graphs (cost, memory before, after and after a model swap);
             a decide at every bucket bitwise equal to the eager stage
             (``eager_decide``: the same stage run op by op) and to the
             numpy oracle, with no build; decide latency graph against
             eager at batch 256 and 4,096; (2) the aot_serving benchmark's
             row: a two-worker ``ServingPlane`` (max_batch 32, backlog 64)
             on the 2,000-event seed-19 trace, 500 sequential decides (p50,
             p99, the first), a 2,000-request burst (saturations), every
             future held to the decision its batch recorded (flight
             recorder) and that to the numpy oracle, none failed, no
             build; (3) ``run_streaming`` on the cluster path's warmed
             allocator: its report equals the fused ``run_cluster``'s, no
             build, K1, K2 and K3 launched; (4) the drift_cluster
             benchmark at scale 1 (10,000 events, 128 templates + 128
             drifted, 0.2 qps, capacity 32,768, K = 2): the "off" arm and
             the warmed "signal" arm, which must swap, each retrain
             launching K1 and every swapped-in service building nothing;
  K4         kernel K4 (causal GQA flash attention) against its plain
             version at the LM slice's prefill shape (B 8, Hq 32, Hkv 8,
             S 2048, D 128, causal), at zamba2-2.7b's shared attention
             (B 8, Hq = Hkv = 32, S 2048, D 80) and at the MoE models'
             prefills (moonshot Hq = Hkv = 16; qwen3-moe Hq 64 over Hkv 4,
             a GQA group of 16; D 128) in bf16 (2e-2) and float32
             (2e-5), and at the reference test's MHA, GQA, MQA and
             rectangular shapes and two ragged ones (S 1,000 at D 128,
             S 2,047 at D 80), causal and not, and on q, k, v at an offset
             that is not 16-byte aligned; two bf16 runs bitwise
             equal; times of kernel, plain version and
             ``scaled_dot_product_attention`` (L2 flushed) at the four LM
             shapes, and the bound;
  LM         the fourth path: ``Server.run`` on minitron-8b at full width
             and depth (32 layers, d_model 4096, bf16, seeded random
             weights drawn on the card), ``attention_impl="pallas"``, 16
             requests of 256-2,048 prompt tokens and 32 new tokens each at
             batch 8 x 2,048: two prefills (K4 in every layer) and 62
             decode steps. K4 must launch exactly 32 x 2 times; every token
             lies in the vocabulary; the first batch's prefill, rerun, gives
             the served first tokens again. The same batch then goes through
             the model's first ``LM_CHECK_LAYERS`` layers with the same
             weights in float32, once through K4 (``"pallas"``) and once
             through plain attention (``"xla"``): their last-token logits
             must agree within ``LM_LOGIT_TOL`` standard deviations. The
             distance of the two routes at full depth in bf16 is printed,
             not held (random weights make that network chaotic).
  hybrid     SSM and hybrid serving: ``Server.run`` on zamba2-2.7b at full
             width and depth (54 Mamba-2 layers, a shared attention block
             after every 6th, bf16, seeded random weights,
             ``attention_impl="pallas"``), the same 16 requests at batch
             8 x 2,048: K4 must launch 9 x 2 times (once an application a
             prefill; decode runs plain attention on the shared caches, the
             scan runs ``ssd_chunked`` and ``ssd_decode_step``, K5 0 times);
             the first batch's first 6 layers in float32 (one application)
             through K4 and through plain attention: last-token logits
             within ``LM_LOGIT_TOL`` std; then mamba2-1.3b at full width and
             depth, one batch of 8 x 2,048 and 3 decode steps, no kernel.
  MoE        the MoE family: ``Server.run`` on moonshot-v1-16b-a3b at full
             width and depth (48 layers, 64 experts top-6, 28.06 B
             parameters in bf16 drawn on the card), the LM path's 16
             requests at batch 8 x 2,048: K4 must launch 48 x 2 times;
             decode ms beside the bound of reading every weight (the
             reference's dense expert products at capacity 1) and the kv
             cache; the first batch's prefill rerun gives the served first
             tokens; its first ``LM_CHECK_LAYERS`` layers in float32, K4
             route vs plain route within ``LM_LOGIT_TOL`` std; then
             qwen3-moe-235b-a22b at full width, depth cut to
             ``QWEN3_MOE_LAYERS`` (its 470 GB of bf16 weights fit no
             card), one batch, K4 4 times, held the same way; then one
             ``train_step`` of moonshot at full width, depth
             ``MOE_TRAIN_LAYERS``, 8 x 2,048 tokens: loss and aux loss
             finite, K4 2 x 2 times (forward and remat recompute).
  K5         kernel K5 (Mamba-2 SSD chunk scan) against its plain version
             ``ssd_chunked`` at the reference test's SSD_SHAPES and at
             zamba2-2.7b's (8, 2048, 80, 64, 64) and mamba2-1.3b's
             (8, 2048, 64, 64, 128) training shapes, in float32 (2e-5) and
             bf16 (5e-2), in bf16 at every (P, N) it is compiled for, at a
             512-row chunk (the CUDA-core kernel in bf16) and on x, B, C
             at an offset that is not 16-byte aligned;
             two bf16 runs bitwise equal; times of kernel and plain
             version (L2 flushed) and the bound at the two model shapes;
  gradients  both ``autograd.Function``s (K4, K5) against autograd of their
             plain versions at small float32 shapes (1e-4);
  training   the fifth path: ``run_training`` on zamba2-2.7b at full width
             and depth (54 layers, bf16, seeded random weights drawn on the
             card, ``ssd_impl = attention_impl = "pallas"``, remat "full"),
             ``TRAIN_STEPS`` steps of 8 x 2,048 tokens from the ported
             ``TokenPipeline``: K5 must launch 2 x 54 and K4 2 x 9 times a
             step (forward and the remat recompute), every loss finite; step
             times (CUDA events), tokens/s, model FLOPs / step time / 989
             TFLOP/s and peak memory are printed;
  route      float32, zamba2-2.7b's first ``ROUTE_LAYERS`` layers (one
             shared-attention application), the same weights and batch:
             loss and every gradient of the kernel route against the plain
             route (``"xla"``), within ``ROUTE_LOSS_RTOL`` (loss, relative)
             and ``ROUTE_GRAD_RTOL`` (global norm of the gradient
             difference over the gradient's); then the same check with K5
             given A = 0 (its decay dropped) must fail them.
  ckpt       checkpointed, resumable training: ``run_training`` on
             zamba2-2.7b at full width, depth ``CKPT_LAYERS`` (one
             shared-attention application, 4.26 GB a checkpoint), K4 and
             K5 on: ``CKPT_STEPS`` steps uninterrupted; ``CKPT_EVERY``
             steps checkpointed at the last into a folder under
             ``build/`` (removed after); a new run resumed from it to
             ``CKPT_STEPS``. ``resumed_from`` must be ``CKPT_EVERY``, the
             restored leaves must equal the save's host snapshot bitwise,
             the losses the uninterrupted run's (within 1e-5, printed
             whether bitwise), K5 and K4 launched in the resumed steps;
             the snapshot's, write's and restore's seconds, bytes and
             MB/s printed.

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
# float64 operations of one libdevice pow on sm_90a: 41 DFMA (2 each), 35
# DADD and 9 DMUL in its SASS (``tools/probe_kernels.py k3`` reads them with
# cuobjdump; a static count, special-case branches included)
POW_FLOPS = 126
# the decision's flops besides the pows: the gain cut-off (product,
# quotient, rint, two clamps) and the limit (two products, a sum)
K3_FIXED_FLOPS = 12
CLUSTER_EVENTS = 10_000             # preempt_cluster at scale 1
CLUSTER_CFG = dict(admission="edf", capacity=24_576, n_shards=4,
                   elastic=True, pricing="elastic")
PLANE_TRACE = dict(seed=19, n_unique=64, rate_qps=8.0)   # aot_serving's
PLANE_EVENTS = 2_000
DRIFT_EVENTS, DRIFT_UNIQUE = 10_000, 128   # drift_cluster at scale 1
REPLAY_EVENTS = 1_000_000           # fused_cluster at scale 1
K3_CANDIDATES = 4_096
BF16_TENSOR_OPS_PER_S = 989e12      # H100 SXM dense bf16, data sheet
# kernel K4's checks: (B, Hq, Hkv, S, D); tests/test_kernels.py's
# ATTN_SHAPES, then a ragged GQA sequence at D 128 and a ragged one at D 80
# (rows and keys past S meet the bf16 kernel's zero-filled tiles)
ATTN_SHAPES = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 256, 128),
               (2, 4, 4, 512, 32), (2, 4, 1, 1000, 128), (1, 4, 4, 2047, 80)]
LM_ATTN_SHAPE = (8, 32, 8, 2048, 128)
LM_ARCH = "minitron-8b"
LM_REQUESTS, LM_NEW_TOKENS = 16, 32
# max |K4 route - plain route| / std over the last-token logits of the
# float32 rerun at LM_CHECK_LAYERS layers. On a layer's own q, k, v the
# two agree to a few 1e-6 std in float32; a wrong mask, head map or scale
# moves the logits by O(1) std (two unrelated unit-std vectors differ by
# 1.13 on average). At full depth no such bound holds: random weights
# give scores of std ~100, nearly one-hot attention, and a rounding
# difference at a near-tied key grows layer by layer.
LM_CHECK_LAYERS = 2
LM_LOGIT_TOL = 1e-3
# kernel K5's checks: (B, S, H, P, N, chunk); the reference test's
# SSD_SHAPES, then zamba2-2.7b's and mamba2-1.3b's training shapes
SSD_SHAPES = [(1, 128, 2, 32, 64, 64), (2, 256, 4, 64, 128, 128),
              (2, 512, 1, 16, 32, 128), (1, 256, 3, 64, 64, 256)]
ZAMBA2_SSD_SHAPE = (8, 2048, 80, 64, 64, 128)
MAMBA2_SSD_SHAPE = (8, 2048, 64, 64, 128, 128)
SSD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}   # the reference test's
# K5's bf16 kernel at every (P, N) it is compiled for
SSD_INSTANCES = [(2, 256, 3, P, N, 128) for P in (16, 32, 64)
                 for N in (16, 32, 64, 128)]
# K5 in bf16 at a chunk longer than the tensor-core kernel's 256 rows
SSD_LONG_CHUNK = (1, 1024, 2, 64, 64, 512)
# kernel K4 at zamba2-2.7b's shared attention: (B, Hq, Hkv, S, D)
ZAMBA2_ATTN_SHAPE = (8, 32, 32, 2048, 80)
# the training path: zamba2-2.7b at full width and depth
TRAIN_ARCH = "zamba2-2.7b"
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 5, 2048, 8
# the route check: float32, the first ROUTE_LAYERS layers (one shared
# attention application), same weights and batch, kernel route ("pallas")
# against plain route ("xla"): |loss_k - loss_x| / |loss_x| and
# |grad_k - grad_x| / |grad_x| (global norms over every parameter).
# Both routes take the same backward (the plain formulation), so only the
# forward values differ: by float32 rounding (~1e-6 relative) where the
# kernels are right, by O(1) where one is wrong.
# What it catches: a faulty K5 (route_phase shows it: K5 with its decay
# dropped reads a gradient distance of order 1 against the 1e-3 bound).
# What it cannot catch: a non-causal K4 (on the card it read loss 7.3e-7
# and gradient 3.8e-4, inside both bounds: the shared block's output is
# small next to the residual stream). K4's causality rests on k4_phase,
# which holds the causal kernel to its plain version at D = 80.
ROUTE_LAYERS = 6
ROUTE_LOSS_RTOL = 1e-5
ROUTE_GRAD_RTOL = 1e-3
# Figure 2 on the main path's corpus: the runner's two slowdowns; the card's
# tokens held to the CPU twin on a seeded sample (all 25,000 jobs would
# take the host minutes) and to the numpy oracle on a smaller one
FIG2_SLOWDOWNS = (0.0, 0.05)
FIG2_TWIN_SAMPLE = 2_000
FIG2_ORACLE_SAMPLE = 300
# SSM and hybrid serving: zamba2-2.7b as the LM path serves minitron-8b,
# its K4 route held to the plain route over the first HYBRID_CHECK_LAYERS
# layers in float32 (one shared-attention application, after layer 5) to
# LM_LOGIT_TOL; mamba2-1.3b one batch of SSM_NEW_TOKENS new tokens
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_CHECK_LAYERS = 6
SSM_ARCH = "mamba2-1.3b"
SSM_NEW_TOKENS = 4
# the MoE family: moonshot-v1-16b-a3b at full width and depth served as
# the LM path serves minitron-8b; qwen3-moe-235b-a22b at full width with
# its depth cut to QWEN3_MOE_LAYERS of 94 (470 GB of bf16 weights fit no
# card), one batch; one train step of moonshot at full width, depth cut
# to MOE_TRAIN_LAYERS. K4 at both models' prefill shapes: (B, Hq, Hkv, S,
# D), keyed by their records' names
MOE_ARCH = "moonshot-v1-16b-a3b"
QWEN3_MOE_ARCH = "qwen3-moe-235b-a22b"
QWEN3_MOE_LAYERS = 4
MOE_TRAIN_LAYERS = 2
MOE_ATTN_SHAPES = {"flash_attention_moe_h16": (8, 16, 16, 2048, 128),
                   "flash_attention_moe_gqa16": (8, 64, 4, 2048, 128)}
# checkpointed training: zamba2-2.7b at full width, depth CKPT_LAYERS (one
# shared-attention application): CKPT_STEPS uninterrupted, then
# CKPT_EVERY steps checkpointed and a resumed run to CKPT_STEPS
CKPT_LAYERS = 6
CKPT_STEPS, CKPT_EVERY = 6, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(log_text):
    """(kernel, "registers ...; spills ...") for each entry function in
    nvcc's ``-Xptxas -v`` output, names demangled where ``c++filt`` is."""
    import shutil
    out, fn, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split(":")[-1].strip()
        elif "Used" in line and "registers" in line and fn is not None:
            out.append([fn, line.split(":", 1)[-1].strip() + "; " + spill])
            fn, spill = None, ""
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt", "-p"], input="\n".join(
            f for f, _ in out), capture_output=True, text=True).stdout
        for row, name in zip(out, names.splitlines()):
            row[0] = name
    return [tuple(row) for row in out]


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


def decide_latency_ms(fn, reps=20):
    """Median host-clock ms of ``reps`` synchronised calls of ``fn`` (a
    decide), after three unrecorded calls."""
    import numpy as np
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _, dt = sync_time(fn)
        times.append(dt * 1e3)
    return float(np.median(times))


def kernel_ms(fn, reps=30, spin=True):
    """Median CUDA-event time of ``fn`` with the 50 MB L2 flushed before
    each launch. A spin of about half a millisecond on the card follows the
    flush, so that the host's work in ``fn`` (checks, allocations, the
    launch call) is done before the start event is reached: the events
    then time the card's work alone, however small. ``spin=False`` times
    as this function did before that spin: the host's work then adds to
    small kernels' times (``tools/ab_kernels.py`` reports both)."""
    import numpy as np
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bisection_levels(a, b, price, obs, policy):
    """(C,) int64: the iterations of ``choose_tokens_priced_torch``'s
    48-step bisection in which its interval is still open (lo < hs) on
    these inputs, the same arithmetic as the plain version; the other
    iterations change nothing. 0 everywhere without a slowdown bound."""
    import torch
    levels = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    if policy.max_slowdown <= 0:
        return levels
    hi = obs.to(torch.int64)
    limit = (1.0 + policy.max_slowdown * price) * (b * hi.to(a.dtype) ** a)
    lo = torch.full_like(hi, policy.min_tokens)
    hs = hi.clone()
    for _ in range(48):
        cond = lo < hs
        levels += cond
        mid = (lo + hs) // 2
        ok = b * mid.to(a.dtype) ** a <= limit
        lo = torch.where(cond & ~ok, mid + 1, lo)
        hs = torch.where(cond & ok, mid, hs)
    return levels


def k3_inputs(np, rng, obs, a, b):
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
    from repro_torch.kernels.cluster_step import (pack_resize,
                                                  resize_step_ref,
                                                  unpack_resize)
    keys = ("a", "b", "price", "obs", "floor", "done", "cand_tok",
            "cand_end")
    v = [torch.from_numpy(np.ascontiguousarray(vecs[k])).cuda() for k in keys]
    packed = torch.from_numpy(pack_resize(*(vecs[k] for k in keys),
                                          rows_np)).cuda()
    C = len(rows_np)
    run_kernel = lambda: ops.cluster_resize_step(
        packed, sky, lens, now, epoch_s, policy=policy, cap=cap)
    chunk = max(1, PLAIN_ELEMS // sky.shape[1])

    def run_plain():
        parts = [resize_step_ref(*[t[i:i + chunk] for t in v],
                                 sky[rows[i:i + chunk]],
                                 lens[rows[i:i + chunk]], now, epoch_s,
                                 policy=policy, cap=cap)
                 for i in range(0, C, chunk)]
        return [torch.cat(p) for p in zip(*parts)]

    got = unpack_resize(run_kernel())
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
    # the bound: each valid second and each input and output byte once;
    # the operations these inputs need: a compare and an add a second, and
    # per candidate the decision's fixed flops, a pow for the base and one
    # for every bisection level still open (``bisection_levels``) with its
    # product and compare
    valid = int(lens_np[rows_np].clip(0, sky.shape[1]).sum())
    levels = int(bisection_levels(v[0], v[1], v[2], v[3], policy).sum())
    n_bytes = 4 * valid + C * (9 * 8 + 4) + C * (8 + 1 + 8 + 8)
    n_int_ops = 2 * valid
    n_f64_ops = (C * K3_FIXED_FLOPS + (levels + C * (policy.max_slowdown > 0))
                 * (POW_FLOPS + 2))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (n_int_ops / CUDA_CORE_OPS_PER_S
              + n_f64_ops / FP64_OPS_PER_S) * 1e3
    longest = int(lens_np[rows_np].clip(0, sky.shape[1]).max(initial=0))
    log(f"K3 {name}: {C} candidates, {valid} valid skyline seconds (longest "
        f"{longest}), "
        f"{levels} open bisection levels ({levels / max(C, 1):.2f} a "
        f"candidate); == plain version (bitwise); tokens == numpy oracle "
        f"except {flips} flip(s) within 4 ulp; rt == numpy AREPAS on "
        f"{len(sample)}; kernel {ms:.4f} ms (median of 30, L2 flushed), "
        f"plain {plain_s * 1e3:.3f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
        f"({n_bytes} bytes; {n_f64_ops} float64 ops, ops {ops_ms:.6f} ms)")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}, flips


def k2_check_and_time(name, args, now):
    """Kernel K2 vs its plain version (bitwise) on ``args`` (end_s, tokens,
    free, q_tok, q_end on the card), then its times and bound; returns
    (record fields, kernel output)."""
    import torch
    from repro_torch.kernels import cluster_step, ops
    from repro_torch.kernels.cluster_step import epoch_step_ref
    got = ops.cluster_epoch_step(*args, now)
    want, _ = sync_time(lambda: epoch_step_ref(*args, now))
    max_abs_err = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert torch.equal(g, w), f"K2 != plain version ({name})"
        finite = torch.isfinite(g.double()) & torch.isfinite(w.double())
        if bool(finite.any()):
            max_abs_err = max(max_abs_err, float(
                (g.double() - w.double())[finite].abs().max()))
    K, L = args[0].shape
    Q = args[3].shape[1]
    ms = kernel_ms(lambda: ops.cluster_epoch_step(*args, now))
    _, plain_s = sync_time(lambda: epoch_step_ref(*args, now))
    n_bytes = 4 * K * L * 8 + 2 * K * Q * 8 + K * Q * 4 + 5 * K * 8
    n_ops = 6 * K * L + 6 * K * Q
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    log(f"K2 {name} (K={K}, L={L}, Q={Q}): == plain version (bitwise); "
        f"admitted {got[3].cpu().numpy().tolist()}, expired "
        f"{got[6].cpu().numpy().tolist()}; clusters of "
        f"{cluster_step.cluster_ctas()} CTAs; {ms:.4f} ms (median of 30, L2 "
        f"flushed); plain version {plain_s * 1e3:.3f} ms; bound "
        f"{max(bytes_ms, ops_ms):.5f} ms ({n_bytes} bytes at 3.35 TB/s)")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}, got


def k2_phase():
    """Kernel K2 vs its plain version at the replay's shapes, on tables
    with one edge case per shard; returns the kernel record fields."""
    import numpy as np
    import torch
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
    rec, got = k2_check_and_time("at the replay's shape, edge tables", args,
                                 now)
    n_admit = got[3].cpu().numpy()
    n_exp = got[6].cpu().numpy()
    assert n_admit[2] == 37 and n_admit[0] > 0 and n_exp[1] == live[1].sum()
    assert 0 < n_admit[3] < Q - 100 and n_exp[3] == live[3, :20].sum()
    return rec


def cluster_phase(alloc, trace):
    """The cluster path, fused and unfused, through ``run_cluster``; then an
    untimed fused rerun that records the run's batch sizes and holds
    kernels K1, K2 and K3 against their plain versions on the largest
    batch (K2: the longest queue) the path gave each. Returns the fused
    run's launch counts, the record fields of K1, K2 and K3 there, K3's
    flip count and the fused run's report."""
    import numpy as np
    import torch
    import repro_torch.cluster.pool as pool_mod
    from repro_torch.cluster import ClusterConfig, ClusterSimulator
    from repro_torch.kernels import ops
    reports, counts = {}, {}
    for fused in (False, True):
        cfg = ClusterConfig(**CLUSTER_CFG, fused=fused)
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
    # 4,096-row bucket and asserts past it; the port takes any size), the
    # arguments of the largest K3 batch and of the K2 launch with the
    # longest queue (ties: the first)
    seen = {"K1": None, "K2": None, "K3": None}
    kernel_step = pool_mod.cluster_epoch_step

    def recording_step(end_s, tokens, free, q_tok, q_end, now):
        if seen["K2"] is None or q_tok.shape[1] > seen["K2"][0][3].shape[1]:
            seen["K2"] = ([t.clone() for t in (end_s, tokens, free, q_tok,
                                               q_end)], float(now))
        return kernel_step(end_s, tokens, free, q_tok, q_end, now)

    class Recording(ClusterSimulator):
        def _true_runtimes(self, jb, tokens):
            if seen["K1"] is None or len(jb) > len(seen["K1"][0]):
                seen["K1"] = (np.array(jb, np.int64),
                              np.array(tokens, np.int64), self._sky,
                              self._lens)
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

    cfg = ClusterConfig(**CLUSTER_CFG, fused=True)
    pool_mod.cluster_epoch_step = recording_step
    try:
        again = Recording(alloc.service, cfg, fabric=alloc.fabric,
                          obs=alloc.obs).run(trace)
    finally:
        pool_mod.cluster_epoch_step = kernel_step
    assert dict(again.metrics) == dict(fused.metrics), "rerun differs"
    big = seen["K3"]
    log(f"cluster: rerun metrics == fused run's; largest K1 batch "
        f"{len(seen['K1'][0])}, largest K3 batch {len(big['a'])}, K2's "
        f"longest queue {tuple(seen['K2'][0][3].shape)}")
    k1_c = k1_batch_phase(*seen["K1"])
    k2_c, _ = k2_check_and_time("at the cluster path's longest queue",
                                *seen["K2"])
    rows_np = big["jb"]
    k3_c, flips = k3_phase(
        "(c) cluster path's largest batch", big["sky"], big["lens"],
        torch.from_numpy(rows_np).cuda(), big, big["now"], cfg.epoch_s,
        alloc.service.policy, big["cap"], big["sky"].cpu().numpy(),
        big["lens"].cpu().numpy(), rows_np)
    return counts[True], k1_c, k2_c, k3_c, flips, fused


def eager_on_card(stage, *args):
    """A decision stage run eagerly on the card on host inputs (numpy
    arrays, dicts of them, or None), as the service ran its stages before
    they were CUDA graphs: one copy in per input, the stage, the outputs
    stacked and copied back once."""
    import numpy as np
    import torch

    def dev(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: dev(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()
    with torch.inference_mode():
        outs = stage(*[dev(x) for x in args])
        host = torch.stack([o.to(torch.float64) for o in outs]).cpu().numpy()
    return [h.astype(torch.empty(0, dtype=o.dtype).numpy().dtype)
            for h, o in zip(host, outs)]


def eager_decide(model, policy, model_in, observed):
    """The model path decided eagerly on the card: the rows padded to their
    bucket, the fused stage through ``eager_on_card``; returns (tokens, a,
    b, runtime) of the unpadded rows."""
    import numpy as np
    from repro_torch.serve.batching import batch_bucket, pad_to
    from repro_torch.serve.service import make_fused_decide
    B = len(next(iter(model_in.values())))
    Bp = batch_bucket(B)
    out = eager_on_card(
        make_fused_decide(model, policy, observed is not None),
        {k: pad_to(np.asarray(v, np.float32), Bp)
         for k, v in model_in.items()},
        None if observed is None else pad_to(np.asarray(observed, np.int64),
                                             Bp))
    return [o[:B] for o in out]


def plane_phase(model, policy, request, observed, cluster_alloc, cluster_cfg,
                cluster_trace, fused_report):
    """The serving plane on the card (the main path's trained nn:lf2):
    (1) the AOT grid to bucket 4,096 in both observed modes, priced, as
    CUDA graphs: its cost and memory, a decide at every bucket bitwise
    against the eager stage and against the numpy oracle with no build,
    graph against eager decide latency, the memory after a model swap;
    (2) the reference's aot_serving row: a 2-worker ``ServingPlane``, 500
    sequential decides, a 2,000-request burst, every future checked;
    (3) ``run_streaming`` on the cluster path's warmed allocator, its
    report equal to the fused ``run_cluster``'s; (4) the drift_cluster
    benchmark's signal and off arms at scale 1. Returns the launch counts
    of the streaming run and of the drift signal arm, and the ``pow`` tie
    flips against the numpy oracle."""
    import numpy as np
    import torch
    from repro_torch.api import AllocationRequest, Allocator, DecisionContext
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.core.models import NNConfig
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.kernels import ops
    from repro_torch.mlops import MLOpsLoop, RetrainController
    from repro_torch.obs import FlightRecorder, Obs
    from repro_torch.serve import AllocationService, ServingPlane, WarmupConfig
    from repro_torch.serve.aot import batch_buckets, model_pool_inputs
    from repro_torch.serve.service import make_priced_decide
    from repro_torch.workloads import DriftSpec, TraceGenerator
    MiB = 2 ** 20

    # -------------------------------------------------- (1) the AOT grid
    trace = TraceGenerator(**PLANE_TRACE).generate(PLANE_EVENTS)
    grid = WarmupConfig(max_bucket=4096, observed=(True, False), priced=True)
    alloc = Allocator(AllocationService(model, policy, device="cuda"))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    rep = alloc.warmup(trace=trace, config=grid)
    torch.cuda.synchronize()
    mem1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    log(f"plane warmup: {rep.n_precompiled} executables (CUDA graphs) in "
        f"{rep.cold_start_s:.3f} s (capture {rep.capture_s:.3f} s, warm "
        f"{rep.warm_s:.3f} s); by kind "
        f"{json.dumps({k: v['n'] for k, v in rep.to_json()['by_kind'].items()})}"
        f"; memory allocated {mem0 / MiB:.1f} -> {mem1 / MiB:.1f} MiB "
        f"(+{(mem1 - mem0) / MiB:.1f}), reserved {res1 / MiB:.1f} MiB")
    assert rep.n_precompiled == len(batch_buckets()) * 2 * (3 + 3)
    svc = alloc.service
    n = len(observed)
    price = np.where(np.arange(n) % 3 == 0, 1.5, 1.0)
    flips = 0
    for Bp in batch_buckets():
        req = request.narrow(slice(0, Bp))
        obs_b = observed[:Bp]
        for wo in (True, False):
            d = alloc.decide(req, DecisionContext(observed=wo))
            want = eager_decide(model, policy, req.model_in,
                                obs_b if wo else None)
            for got, w, name in zip((d.tokens, d.a, d.b, d.runtime), want,
                                    ("tokens", "a", "b", "runtime")):
                assert got.dtype == w.dtype and np.array_equal(got, w), \
                    (Bp, wo, name)
            flips += check_tokens(d.tokens, d.a, d.b,
                                  obs_b if wo else np.full(
                                      Bp, policy.max_tokens), policy)
        hist = AllocationRequest(a=d.a.astype(np.float64),
                                 b=d.b.astype(np.float64),
                                 observed_tokens=obs_b)
        dh = alloc.decide(hist, DecisionContext(price=price[:Bp]))
        want = eager_on_card(make_priced_decide(policy, True),
                             hist.a, hist.b, price[:Bp], obs_b)
        assert np.array_equal(dh.tokens, want[0]), (Bp, "priced")
        assert np.array_equal(dh.runtime, want[1]), (Bp, "priced")
        flips += check_tokens(dh.tokens, hist.a, hist.b, obs_b, policy,
                              price[:Bp])
    assert svc.stats["compiles"] == 0, svc.stats
    log(f"plane: a decide at every bucket 8..4096 (model path in both "
        f"observed modes, priced history path) == the eager stage bitwise "
        f"(tokens, a, b, runtime) and == the numpy oracle except {flips} "
        f"flip(s) within 4 ulp; stats {svc.stats}")
    lat = {}
    for B in (256, 4096):
        req = request.narrow(slice(0, B))
        lat[B] = (decide_latency_ms(lambda: alloc.decide(req)),
                  decide_latency_ms(lambda: eager_decide(
                      model, policy, req.model_in, req.observed_tokens)))
    assert svc.stats["compiles"] == 0
    log(f"decide latency (median of 20, host clock), graph vs eager: "
        f"batch 256 {lat[256][0]:.3f} vs {lat[256][1]:.3f} ms, batch 4096 "
        f"{lat[4096][0]:.3f} vs {lat[4096][1]:.3f} ms")
    swap = alloc.swap_model(model, jobs=trace.jobs, warmup_config=grid)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem2, res2 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    d = alloc.decide(request.narrow(slice(0, 1000)))
    assert alloc.service.stats["compiles"] == 0 and svc.stats[
        "executables_retired"] == rep.n_precompiled
    log(f"plane swap_model: {swap.n_precompiled} executables in "
        f"{swap.cold_start_s:.3f} s, {rep.n_precompiled} retired; memory "
        f"allocated after the swap {mem2 / MiB:.1f} MiB, reserved "
        f"{res2 / MiB:.1f} MiB (one grid, not two)")
    assert mem2 - mem0 <= 1.05 * (mem1 - mem0) + MiB, (mem0, mem1, mem2)
    del alloc, svc

    # ------------------------------- (2) the reference's aot_serving row
    pool = model_pool_inputs(model, trace.jobs)
    n_pool = len(pool["features"])
    row = lambda i: {k: v[i % n_pool] for k, v in pool.items()}
    plain = AllocationPolicy()
    cold = AllocationService(model, plain, device="cuda")
    cold_ms = []
    for i in range(100):
        req = AllocationRequest(model_in={k: v[None] for k, v in
                                          row(i).items()},
                                observed_tokens=np.array([50 + i]))
        t0 = time.perf_counter()
        cold.decide(req)
        cold_ms.append((time.perf_counter() - t0) * 1e3)
    recorder = FlightRecorder(sample_rate=1.0, max_rows=10_000)
    obs = Obs.enabled(recorder=recorder)
    warm_svc = AllocationService(model, plain, device="cuda", obs=obs)
    plane = ServingPlane(warm_svc, n_workers=2, max_batch=32, backlog=64,
                         obs=obs)
    plane.start(warm_jobs=trace.jobs,
                warmup=WarmupConfig(max_bucket=32, observed=(True, False)))
    wrep = plane.warmup_report
    hints, futs, warm_ms = [], [], []
    try:
        for i in range(500):
            t0 = time.perf_counter()
            f = plane.submit(row(i), observed_tokens=50 + i)
            f.result(timeout=60)
            warm_ms.append((time.perf_counter() - t0) * 1e3)
            futs.append(f)
            hints.append(50 + i)
        t0 = time.perf_counter()
        for i in range(2000):
            futs.append(plane.submit(row(i), observed_tokens=600 + i))
            hints.append(600 + i)
        for f in futs:
            f.result(timeout=120)
        burst_s = time.perf_counter() - t0
    finally:
        plane.stop()
    bad = [f.exception() for f in futs if f.exception() is not None]
    assert not bad, bad[:3]
    assert warm_svc.stats["compiles"] == 0, warm_svc.stats
    rows = recorder.rows()
    assert len(rows) == len(futs) == recorder.n_seen
    by_hint = {r["observed_tokens"]: r for r in rows}
    assert len(by_hint) == len(rows)
    got = np.array([f.result() for f in futs])
    rec = [by_hint[h] for h in hints]
    assert np.array_equal(got, [r["tokens"] for r in rec])
    pf = check_tokens(got, [r["a"] for r in rec], [r["b"] for r in rec],
                      hints, plain)
    warm_ms = np.asarray(warm_ms)
    log(f"plane (aot_serving): {wrep.n_precompiled} executables warmed in "
        f"{wrep.cold_start_s:.3f} s; cold lazy service first request "
        f"{cold_ms[0]:.3f} ms, p99 {np.percentile(cold_ms, 99):.3f} ms; warm "
        f"plane first {warm_ms[0]:.3f} ms, p50 "
        f"{np.percentile(warm_ms, 50):.3f} ms, p99 "
        f"{np.percentile(warm_ms, 99):.3f} ms; burst of 2000 in "
        f"{burst_s:.3f} s ({2000 / burst_s:.1f} requests/s), backlog "
        f"saturations {plane.backlog.saturations}; {len(futs)} futures, "
        f"none failed, each == its batch's recorded decision == the numpy "
        f"oracle except {pf} flip(s); compiles {warm_svc.stats['compiles']}")

    # ------------------------------------------------- (3) run_streaming
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stream = cluster_alloc.run_streaming(cluster_trace, cluster_cfg)
    wall = time.perf_counter() - t0
    stream_counts = ops.launch_counts()
    assert dict(stream.metrics) == dict(fused_report.metrics), \
        "run_streaming != run_cluster"
    np.testing.assert_array_equal(stream.alloc_errors,
                                  fused_report.alloc_errors)
    np.testing.assert_array_equal(stream.cache_hits, fused_report.cache_hits)
    assert stream.cache_stats == fused_report.cache_stats
    assert stream.replica_stats == fused_report.replica_stats
    assert stream.service_stats == fused_report.service_stats
    assert stream.service_stats["compiles"] == 0, stream.service_stats
    assert min(stream_counts[k] for k in ("arepas_runtimes",
                                          "cluster_epoch_step",
                                          "cluster_resize_step")) > 0
    log(f"streaming: run_streaming report == run_cluster's (fused; metrics, "
        f"alloc_errors, cache_hits, cache and replica stats); "
        f"{stream.n_events / wall:.1f} events/s vs run_cluster's "
        f"{fused_report.events_per_s:.1f}; compiles 0; launches "
        f"{stream_counts}")

    # ------------------------------------------------ (4) the drift loop
    class Retrains(RetrainController):
        """Counts kernel K1's launches inside each refit."""
        k1 = ()

        def retrain(self, *a, **kw):
            before = ops.launch_counts()["arepas_runtimes"]
            bundle = super().retrain(*a, **kw)
            self.k1 += (ops.launch_counts()["arepas_runtimes"] - before,)
            return bundle

    drift_trace = TraceGenerator(
        seed=71, n_unique=DRIFT_UNIQUE, rate_qps=0.2, drift=DriftSpec(
            n_new=DRIFT_UNIQUE, onset=0.15, rotation=0.7,
            volume_growth=6.0)).generate(DRIFT_EVENTS)
    span_s = float(drift_trace.arrays()["arrival_s"][-1])
    ccfg = ClusterConfig(capacity=32_768, n_shards=2)
    refit = TasqConfig(n_train=400, n_eval=100, nn=NNConfig(epochs=30))
    drift_policy = AllocationPolicy(max_slowdown=0.05)
    arms = {}
    drift_counts = None
    for arm, overrides, warmed in (
            ("off", {}, False),
            ("signal", {"min_signals": 3, "cooldown_s": span_s / 5}, True)):
        da = Allocator(AllocationService(model, drift_policy,
                                         device="cuda"), n_shards=2)
        t0 = time.perf_counter()
        if warmed:
            da.warmup(trace=drift_trace)
        ctrl = Retrains(family="nn", policy=arm, policy_overrides=overrides,
                        pipeline_cfg=refit, max_train=400, seed=7,
                        device="cuda")
        loop = MLOpsLoop(da, ctrl)
        ops.reset_launch_counts()
        drep = da.run_cluster(drift_trace, ccfg, mlops=loop)
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
        m = drep.metrics
        arms[arm] = dict(
            swaps=len(loop.swaps), signals=len(loop.monitor.signals),
            rolling_model_error=loop.rolling_model_error(),
            sla_violation_rate=m.get("sla_violation_rate"),
            alloc_error_model=m.get("alloc_error_model"),
            compiles=drep.service_stats["compiles"], k1_per_retrain=ctrl.k1,
            warm_s=[round(s["cold_start_s"], 3) for s in loop.swaps],
            train_s=[s["train_s"] for s in loop.swaps],
            wall_s=round(wall, 3), events_per_s=drep.events_per_s)
        log(f"drift {arm}: {json.dumps(arms[arm])}; launches {counts}")
        assert m["n_completed"] + m["n_rejected"] == DRIFT_EVENTS
        if arm == "signal":
            drift_counts = counts
            assert len(loop.swaps) >= 1, "the signal arm never swapped"
            assert drep.service_stats["compiles"] == 0, drep.service_stats
            assert len(ctrl.k1) == len(loop.swaps) and min(ctrl.k1) > 0, \
                "a retrain did not launch K1"
    log(f"drift arms (drift_cluster, {DRIFT_EVENTS} events over "
        f"{span_s:.0f} s): signal {arms['signal']['swaps']} swap(s), "
        f"rolling model error {arms['signal']['rolling_model_error']:.4f} "
        f"vs off {arms['off']['rolling_model_error']:.4f}, SLA violation "
        f"rate {arms['signal']['sla_violation_rate']:.4f} vs "
        f"{arms['off']['sla_violation_rate']:.4f}")
    return stream_counts, drift_counts, flips + pf


def k1_batch_phase(jb, tokens, sky, lens):
    """Kernel K1 as the cluster path launches it: on the run's largest
    batch (one allocation per query, skylines read through a row index
    into the run's resident pool ``sky``, ``lens``), against its plain
    version (bitwise), timed with its bound; returns the record fields."""
    import numpy as np
    import torch
    from repro_torch.core.arepas import simulate_runtime, simulate_runtime_batch
    from repro_torch.kernels import ops
    rows = torch.from_numpy(jb).cuda()
    allocs = torch.from_numpy(np.maximum(tokens, 1).astype(np.int32)[:, None]
                              ).cuda()
    run_kernel = lambda: ops.arepas_runtimes(sky, lens, allocs, rows=rows)
    run_plain = lambda: simulate_runtime_batch(sky[rows], lens[rows], allocs)
    got = run_kernel()
    want, _ = sync_time(run_plain)
    max_abs_err = int((got.long() - want.long()).abs().max())
    assert torch.equal(got, want), "K1 != plain version on the cluster batch"
    for j in range(len(jb)):
        r = int(jb[j])
        assert int(got[j, 0]) == simulate_runtime(
            sky[r, :int(lens[r])].cpu().numpy(), int(allocs[j, 0])), j
    ms = kernel_ms(run_kernel)
    _, plain_s = sync_time(run_plain)
    batch_lens = lens[rows].clamp(min=0, max=sky.shape[1])
    valid, J, K = int(batch_lens.sum()), len(jb), 1
    n_bytes = 4 * (valid + J + 2 * J * K) + 8 * J
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * K * valid / CUDA_CORE_OPS_PER_S * 1e3
    log(f"K1 at the cluster path's largest batch ({J} queries, {valid} valid "
        f"skyline seconds, longest {int(batch_lens.max())} s): == plain "
        f"version (bitwise); {ms:.4f} ms (median of 30, L2 flushed); "
        f"plain {plain_s * 1e3:.3f} ms; bound {max(bytes_ms, ops_ms):.6f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; {n_bytes} "
        f"bytes, ops {ops_ms:.6f} ms); == numpy oracle on all {J}")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def replay_phase():
    """The replay path; returns its K2 launches."""
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
    return counts["cluster_epoch_step"]


def attn_inputs(shape, dtype, seed):
    """Seeded (B, S, H, D) q, k, v on the card in ``dtype``."""
    import numpy as np
    import torch
    B, Hq, Hkv, S, D = shape
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
        np.float32)).to("cuda", dtype) for h in (Hq, Hkv, Hkv)]


def offset_view(t):
    """A contiguous copy of ``t`` one element past a fresh allocation: not
    16-byte aligned."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


def attn_plain(q, k, v, causal):
    from repro_torch.kernels.ref import attention_ref_bhsd
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return attention_ref_bhsd(qt, kt, vt, causal=causal).transpose(1, 2)


def k4_phase():
    """Kernel K4 against its plain version at the reference test's shapes,
    at the LM serving slice's prefill shape, at zamba2-2.7b's shared
    attention (D 80, Hq == Hkv) and at the MoE models' prefill shapes
    (moonshot Hq = Hkv = 16, qwen3-moe a GQA group of 16); returns K4's
    record fields at those four shapes (bf16, causal)."""
    import torch
    from repro_torch.kernels import ops
    checks = [(shape, causal, dtype) for shape in ATTN_SHAPES
              for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    record_shapes = (LM_ATTN_SHAPE, ZAMBA2_ATTN_SHAPE,
                     *MOE_ATTN_SHAPES.values())
    checks += [(shape, True, dtype) for shape in record_shapes
               for dtype in (torch.bfloat16, torch.float32)]
    errs = {}
    for i, (shape, causal, dtype) in enumerate(checks):
        q, k, v = attn_inputs(shape, dtype, i)
        got = ops.flash_attention(q, k, v, causal=causal)
        want = attn_plain(q, k, v, causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        assert got.dtype == dtype and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        errs[(shape, causal, str(dtype))] = err
        del q, k, v, got, want
    log(f"K4 == plain version at {len(checks)} (shape, causal, type) "
        f"cases; max abs errors: " + "; ".join(
            f"{s} {'causal' if c else 'full'} {d[6:]}: {e:.3g}"
            for (s, c, d), e in errs.items()))
    # q, k, v one element past a fresh allocation: copied, then launched
    q, k, v = attn_inputs((2, 4, 2, 256, 128), torch.bfloat16, 31)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(*(offset_view(t) for t in (q, k, v)))
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = attn_plain(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    log(f"K4 on an offset view (not 16-byte aligned), bf16: launched, max "
        f"|diff| {float((got.float() - want.float()).abs().max()):.3g}")
    del q, k, v, got, want
    q, k, v = attn_inputs(LM_ATTN_SHAPE, torch.bfloat16, 1)
    first = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(first, ops.flash_attention(q, k, v, causal=True)), \
        "K4 bf16 is not deterministic"
    log(f"K4 bf16 at {LM_ATTN_SHAPE}: two runs bitwise equal")
    del q, k, v, first
    return {shape: dict(max_abs_err=errs[(shape, True, str(torch.bfloat16))],
                        **k4_times(shape))
            for shape in record_shapes}


def k4_times(shape):
    """K4's, its plain version's and SDPA's times at ``shape`` (bf16,
    causal, L2 flushed) and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.roofline import kernel_roofline
    B, Hq, Hkv, S, D = shape
    q, k, v = attn_inputs(shape, torch.bfloat16, 99)
    run_kernel = lambda: ops.flash_attention(q, k, v, causal=True)
    ms = kernel_ms(run_kernel, reps=10)
    plain_ms = kernel_ms(lambda: attn_plain(q, k, v, True), reps=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True).transpose(1, 2)
    sdpa_err = float((run_kernel().float() - sdpa.float()).abs().max())
    n_bytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    n_flops = 4 * B * Hq * D * S * S / 2
    roof = kernel_roofline("flash_attention", launches=1,
                           bytes_per_launch=n_bytes, wall_s=ms / 1e3,
                           flops_per_launch=n_flops)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / BF16_TENSOR_OPS_PER_S * 1e3
    log(f"K4 at {shape} bf16 causal: {ms:.3f} ms (median of 10, L2 "
        f"flushed) = {n_flops / ms / 1e9:.1f} TFLOP/s; plain version "
        f"{plain_ms:.3f} ms; SDPA {library_ms:.3f} ms (|K4 - SDPA| max "
        f"{sdpa_err:.3g}); bound {roof.bound_s * 1e3:.4f} ms (operations "
        f"{ops_ms:.4f} ms at 989 TFLOP/s, bytes {bytes_ms:.4f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": roof.bound_s * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def ssd_inputs(shape, dtype, seed):
    """Seeded x, dt, A, B, C on the card, drawn as the reference's kernel
    test draws them: x normal; dt softplus(normal) in float32; A =
    -exp(normal / 2); B, C normal / sqrt(N)."""
    import torch
    import torch.nn.functional as F
    B, S, H, P, N, _ = shape
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    return (rnd(B, S, H, P).to(dtype), F.softplus(rnd(B, S, H)),
            -torch.exp(rnd(H) * 0.5), (rnd(B, S, N) / N ** 0.5).to(dtype),
            (rnd(B, S, N) / N ** 0.5).to(dtype))


def ssd_plain(args, chunk):
    from repro_torch.models.layers import ssd_chunked
    return ssd_chunked(*args, min(chunk, args[0].shape[1]))[0]


def ssd_bound_ms(shape, itemsize):
    """(bound ms, "bytes" or "operations"): x and y, dt, A, B and C moved
    once; 2 Q^2 (N + P) + 4 Q N P operations a chunk and head at the bf16
    tensor-core rate."""
    B, S, H, P, N, chunk = shape
    Q = min(chunk, S)
    n_bytes = 2 * B * S * H * P * itemsize + B * S * H * 4 + H * 4 \
        + 2 * B * S * N * itemsize
    n_ops = (2 * Q * Q * (N + P) + 4 * Q * N * P) * B * H * (S // Q)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / BF16_TENSOR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def k5_phase():
    """Kernel K5 (SSD chunk scan) against its plain version at the
    reference test's shapes and at zamba2's and mamba2's training shapes,
    float32 and bf16, and in bf16 at every (P, N) it is compiled for; two
    bf16 runs bitwise equal; returns K5's record fields (zamba2's shape,
    bf16)."""
    import torch
    from repro_torch.kernels import ops
    errs = {}
    cases = [(shape, dtype)
             for shape in SSD_SHAPES + [ZAMBA2_SSD_SHAPE, MAMBA2_SSD_SHAPE]
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in SSD_INSTANCES]
    for shape, dtype in cases:
        args = ssd_inputs(shape, dtype, len(errs))
        got = ops.ssd_scan(*args, chunk=shape[5])
        want = ssd_plain(args, shape[5])
        torch.cuda.synchronize()
        tol = SSD_TOL[str(dtype)[6:]]
        assert got.dtype == dtype and got.shape == args[0].shape
        assert bool(torch.isfinite(got).all()), (shape, dtype)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        errs[(shape, str(dtype)[6:])] = err
        del args, got, want
    log(f"K5 == plain version at {len(errs)} (shape, type) cases; max abs "
        "errors: " + "; ".join(f"{s} {d}: {e:.3g}"
                               for (s, d), e in errs.items()))
    # the two inputs the bf16 tensor-core kernel cannot take as they are: a
    # 512-row chunk (the CUDA-core kernel in bf16 runs) and x, B, C one
    # element past a fresh allocation (copied, then launched)
    for what, shape, moved in (("512-row chunk", SSD_LONG_CHUNK, ()),
                               ("offset view", SSD_SHAPES[1], (0, 3, 4))):
        args = ssd_inputs(shape, torch.bfloat16, 41)
        call = [offset_view(t) if i in moved else t
                for i, t in enumerate(args)]
        before = ops.launch_counts()["ssd_scan"]
        got = ops.ssd_scan(*call, chunk=shape[5])
        assert ops.launch_counts()["ssd_scan"] == before + 1
        want = ssd_plain(args, shape[5])
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                                   rtol=5e-2)
        log(f"K5 {what} {shape} bf16: launched, max |diff| "
            f"{float((got.float() - want.float()).abs().max()):.3g}")
        del args, call, got, want
    args = ssd_inputs(ZAMBA2_SSD_SHAPE, torch.bfloat16, 1)
    first = ops.ssd_scan(*args, chunk=ZAMBA2_SSD_SHAPE[5])
    assert torch.equal(first, ops.ssd_scan(*args, chunk=ZAMBA2_SSD_SHAPE[5])),\
        "K5 bf16 is not deterministic"
    log(f"K5 bf16 at {ZAMBA2_SSD_SHAPE}: two runs bitwise equal")
    del args, first
    rec = None
    for shape in (ZAMBA2_SSD_SHAPE, MAMBA2_SSD_SHAPE):
        args = ssd_inputs(shape, torch.bfloat16, 7)
        ms = kernel_ms(lambda: ops.ssd_scan(*args, chunk=shape[5]), reps=10)
        plain_ms = kernel_ms(lambda: ssd_plain(args, shape[5]), reps=3)
        bound, by = ssd_bound_ms(shape, 2)
        log(f"K5 at {shape} bf16: {ms:.4f} ms (median of 10, L2 flushed); "
            f"plain version {plain_ms:.3f} ms; bound {bound:.4f} ms ({by})")
        if rec is None:
            rec = {"max_abs_err": errs[(shape, "bfloat16")], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": None}
        del args
    return rec


def grad_phase():
    """Both ``autograd.Function``s (K4, K5) against autograd of their plain
    versions on the card, float32, at small shapes: forward within the
    kernels' float32 tolerances, every input gradient within 1e-4."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator("cuda").manual_seed(5)
    cases = []
    q, k, v = (torch.randn((2, 256, h, 80), generator=g, device="cuda")
               for h in (4, 2, 2))
    cases.append(("flash_attention", (q, k, v),
                  lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                  lambda q, k, v: attn_plain(q, k, v, True), 2e-5))
    args = ssd_inputs((2, 256, 4, 64, 64, 128), torch.float32, 6)
    cases.append(("ssd_scan", args,
                  lambda *a: ops.ssd_scan(*a, chunk=128),
                  lambda *a: ssd_plain(a, 128), 2e-5))
    for name, inputs, fn, plain, tol in cases:
        outs = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            y = f(*leaves)
            w = torch.randn(y.shape, generator=torch.Generator(
                "cuda").manual_seed(9), device="cuda")
            outs.append((y.detach(), torch.autograd.grad(
                (y * w).sum(), leaves)))
        (yk, gk), (yp, gp) = outs
        torch.testing.assert_close(yk, yp, atol=tol, rtol=tol)
        for i, (a, b) in enumerate(zip(gk, gp)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                       msg=f"{name} grad {i}")
        log(f"{name}: autograd.Function == autograd of the plain version "
            f"(forward max |diff| {float((yk - yp).abs().max()):.3g}, "
            f"{len(gk)} input gradients within 1e-4)")


def train_phase():
    """The training path: ``run_training`` on zamba2-2.7b at full width and
    depth with K5 in every Mamba-2 layer and K4 in every shared-attention
    application. Returns (K5 launches, K4 launches)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.roofline import model_flops
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), attention_impl="pallas",
                              ssd_impl="pallas")
    loop = TrainLoopConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0, log_every=1)
    log(f"train {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, shared attention "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim} every {cfg.attn_period} layers, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_count()} "
        f"parameters in {cfg.param_dtype}, remat {cfg.remat_policy}, "
        f"grad_accum {cfg.grad_accum}; {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        "a step")
    marks = []

    def log_step(line):          # called once a step, after its loss sync
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        log(line)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    ops.reset_launch_counts()
    out, wall = sync_time(lambda: run_training(cfg, loop, log_fn=log_step))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train launches: {counts}")
    napps = cfg.num_layers // cfg.attn_period
    micro = TRAIN_STEPS * max(cfg.grad_accum, 1)
    passes = 2 if cfg.remat_policy == "full" else 1
    assert counts["ssd_scan"] == micro * passes * cfg.num_layers, counts
    assert counts["flash_attention"] == micro * passes * napps, counts
    losses = out["losses"]
    assert out["steps_run"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
    assert all(np.isfinite(losses)), losses
    times = [a.elapsed_time(b) for a, b in zip([start] + marks[:-1], marks)]
    steady = float(np.sum(times[1:])) / (TRAIN_STEPS - 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    log(f"train: {TRAIN_STEPS} steps in {wall:.3f} s wall (weights drawn on "
        f"the card included); step ms (CUDA events) {times}; steady step "
        f"{steady:.1f} ms (steps 2-{TRAIN_STEPS}: their total over their count) = "
        f"{tokens / steady * 1e3:.1f} tokens/s; model FLOPs {flops:.4g} a "
        f"step = {flops / (steady / 1e3) / 1e12:.2f} TFLOP/s = "
        f"{flops / (steady / 1e3) / BF16_TENSOR_OPS_PER_S:.4f} of 989 "
        f"TFLOP/s; peak device memory {peak:.2f} GiB; losses {losses}")
    return counts["ssd_scan"], counts["flash_attention"]


def route_setup():
    """zamba2-2.7b's first ROUTE_LAYERS layers in float32 (the float32
    draw of the training run's own initial weights: seed 0, the 54-layer
    law, then sliced) and the pipeline's first batch."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import model_api
    from repro_torch.train.steps import tree_leaves
    full = dataclasses.replace(get_config(TRAIN_ARCH), param_dtype="float32",
                               compute_dtype="float32")
    params = model_api.init(full, torch.Generator("cuda").manual_seed(0))
    params["blocks"] = _map(params["blocks"],
                            lambda t: t[:ROUTE_LAYERS].clone())
    torch.cuda.empty_cache()
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    np_batch = TokenPipeline(DataConfig(
        vocab_size=full.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0)).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in np_batch.items()}
    return dataclasses.replace(full, num_layers=ROUTE_LAYERS), params, \
        leaves, batch


def route_distance(base, params, leaves, batch):
    """(|loss_k - loss_x| / |loss_x|, |grad_k - grad_x| / |grad_x|) of the
    kernel route ("pallas") against the plain route ("xla")."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    res = {}
    for impl in ("pallas", "xla"):
        cfg = dataclasses.replace(base, attention_impl=impl, ssd_impl=impl)
        ops.reset_launch_counts()
        loss, _ = lm.forward_train(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        counts = ops.launch_counts()
        res[impl] = (float(loss.detach()), grads)
        assert all(bool(torch.isfinite(g).all()) for g in grads), impl
        log(f"route {impl}: loss {float(loss.detach())!r}; launches {counts}")
        kernels = impl == "pallas"        # forward + remat recompute
        assert counts["ssd_scan"] == 2 * ROUTE_LAYERS * kernels, counts
        assert counts["flash_attention"] == 2 * kernels, counts
    (lk, gk), (lx, gx) = res["pallas"], res["xla"]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(gk, gx)) ** 0.5
    den = sum(float((b ** 2).sum()) for b in gx) ** 0.5
    return abs(lk - lx) / abs(lx), num / den


def route_phase():
    """The kernel route against the plain route where they must agree:
    float32, zamba2-2.7b's first ROUTE_LAYERS layers at full width, the
    same weights and batch; loss and the gradient of every parameter.
    Then the same check with a faulty K5 route, which must fail."""
    import torch
    from repro_torch.kernels import ops
    setup = route_setup()
    loss_rel, grad_rel = route_distance(*setup)
    log(f"route check ({ROUTE_LAYERS} layers, float32, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}): |loss diff| / |loss| {loss_rel:.4g} (limit "
        f"{ROUTE_LOSS_RTOL}); |grad diff| / |grad| {grad_rel:.4g} (limit "
        f"{ROUTE_GRAD_RTOL})")
    assert loss_rel <= ROUTE_LOSS_RTOL, loss_rel
    assert grad_rel <= ROUTE_GRAD_RTOL, grad_rel
    # the bounds are not vacuous: the same check with K5 given A = 0 (its
    # decay dropped) in the kernel route must fail them
    kernel_forward = ops._SSDScan.forward

    def no_decay(ctx, x, dt, A, Bm, Cm, chunk):
        return kernel_forward(ctx, x, dt, torch.zeros_like(A), Bm, Cm, chunk)

    ops._SSDScan.forward = staticmethod(no_decay)
    try:
        bad = route_distance(*setup)
    finally:
        ops._SSDScan.forward = staticmethod(kernel_forward)
    log(f"route check with K5's decay dropped: |loss diff| / |loss| "
        f"{bad[0]:.4g}; |grad diff| / |grad| {bad[1]:.4g} (must fail)")
    assert bad[0] > ROUTE_LOSS_RTOL or bad[1] > ROUTE_GRAD_RTOL, bad


def bisection_rounds(tokens, observed):
    """Rounds of ``min_tokens_within_slowdown_torch``'s loop on these jobs,
    replayed on the host from its answers: every interval [lo, hi] holds
    the answer, so a round's test passed exactly where mid >= the answer;
    the loop runs until no interval is open."""
    import numpy as np
    lo = np.ones(len(tokens), np.int64)
    hi = np.maximum(np.asarray(observed, np.int64), 1)
    rounds = 0
    while (lo < hi).any():
        open_ = lo < hi
        mid = (lo + hi) // 2
        ok = mid >= tokens
        lo = np.where(open_ & ~ok, mid + 1, lo)
        hi = np.where(open_ & ok, mid, hi)
        rounds += 1
    return rounds


def fig2_phase(skylines, observed, values, offsets):
    """Figure 2 on the main path's corpus: ``token_reduction_cdf`` on the
    card at both slowdowns (K1 one launch a bisection round, counted), its
    tokens held to the CPU twin on a seeded sample and to the numpy oracle
    on a smaller one, then K1 at the bisection's (J, 1) shape against its
    plain version, timed with its bound. Returns (K1's record fields, the
    Figure 2 launches)."""
    import numpy as np
    import torch
    from repro_torch.core.allocator import (min_tokens_within_slowdown,
                                            min_tokens_within_slowdown_torch,
                                            token_reduction_cdf)
    from repro_torch.core.arepas import simulate_runtime_ragged
    from repro_torch.core.dataset import ragged_skylines
    from repro_torch.kernels import ops
    J = len(skylines)
    obs_t = torch.from_numpy(observed).cuda()
    rng = np.random.RandomState(11)
    twin_rows = np.sort(rng.choice(J, FIG2_TWIN_SAMPLE, replace=False))
    oracle_rows = np.sort(rng.choice(J, FIG2_ORACLE_SAMPLE, replace=False))
    sub_v, sub_o = ragged_skylines([skylines[i] for i in twin_rows])
    launches = 0
    for slow in FIG2_SLOWDOWNS:
        ops.reset_launch_counts()
        (r, frac), wall = sync_time(lambda: token_reduction_cdf(
            skylines, observed, max_slowdown=slow, device="cuda"))
        n = ops.launch_counts()["arepas_runtimes"]
        launches += n
        tokens = min_tokens_within_slowdown_torch(values, offsets, obs_t,
                                                  slow).cpu().numpy()
        rounds = bisection_rounds(tokens, observed)
        assert n == rounds, (slow, n, rounds)
        red = 1.0 - tokens / np.maximum(observed, 1)
        assert np.array_equal(frac, (red[None, :] >= r[:, None]).mean(1))
        assert ((tokens >= 1) & (tokens <= np.maximum(observed, 1))).all()
        twin, twin_s = sync_time(lambda: min_tokens_within_slowdown_torch(
            torch.from_numpy(sub_v), torch.from_numpy(sub_o),
            torch.from_numpy(observed[twin_rows]), slow))
        bad = int((twin.numpy() != tokens[twin_rows]).sum())
        assert bad == 0, f"{bad} card tokens != CPU twin at slowdown {slow}"
        for i in oracle_rows:
            want = min_tokens_within_slowdown(skylines[i], int(observed[i]),
                                              slow)
            assert tokens[i] == want, (slow, int(i), int(tokens[i]), want)
        at = lambda x: float(frac[np.searchsorted(r, x)])
        log(f"fig2 slowdown {slow}: {J} jobs, token_reduction_cdf "
            f"{wall * 1e3:.3f} ms wall on the card (host packing included); "
            f"K1 launches {n} (one a bisection round, {rounds} rounds); "
            f"jobs_any_reduction {float(frac[1])!r}, jobs_ge25pct_reduction "
            f"{at(0.25)!r}, jobs_ge50pct_reduction {at(0.50)!r}; tokens == "
            f"CPU twin on a {FIG2_TWIN_SAMPLE}-job sample (0 mismatches, "
            f"{twin_s:.3f} s on the host) and == numpy oracle on "
            f"{FIG2_ORACLE_SAMPLE} jobs")
    # K1 on the first round's allocations, the midpoints of [1, observed]
    allocs = torch.from_numpy(((1 + np.maximum(observed, 1)) // 2).astype(
        np.int32)[:, None]).cuda()
    run_kernel = lambda: ops.arepas_runtimes_ragged(values, offsets, allocs)
    run_plain = lambda: simulate_runtime_ragged(values, offsets, allocs,
                                                PLAIN_ELEMS)
    got = run_kernel()
    plain = run_plain()
    max_abs_err = int((got.long() - plain.long()).abs().max())
    assert torch.equal(got, plain), "K1 != plain version at (J, 1)"
    ms = kernel_ms(run_kernel)
    _, plain_s = sync_time(run_plain)
    valid = int(offsets[-1])
    n_bytes = 4 * valid + 8 * (J + 1) + 4 * 2 * J
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * valid / CUDA_CORE_OPS_PER_S * 1e3
    log(f"K1 at Figure 2's shape ({J} x 1, the first round's allocations): "
        f"== plain version (bitwise); {ms:.4f} ms (median of 30, L2 "
        f"flushed); plain {plain_s * 1e3:.3f} ms; bound "
        f"{max(bytes_ms, ops_ms):.6f} ms ({n_bytes} bytes; ops "
        f"{ops_ms:.6f} ms); {launches} launches in both slowdowns ~ "
        f"{launches * ms:.3f} ms of K1")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}, \
        launches


def eval_phase(pipe, policy, skylines, observed, values, offsets):
    """The paper's evaluation on the main path's trained pipeline and
    corpus: Figure 2 (``fig2_phase``), §5.1 selection at fig10's settings,
    Table 8's ground truth and rows, and the host batch policies against
    the scalar oracles. Returns ``fig2_phase``'s pair and the policies'
    tie flips."""
    import dataclasses
    import numpy as np
    from repro_torch.core.allocator import (build_policy, choose_tokens_batch,
                                            choose_tokens_priced_batch)
    from repro_torch.core.dataset import build_dataset
    from repro_torch.core.evaluate import eval_pcc_model, eval_xgb_curves
    from repro_torch.core.featurize import batch_job_features
    from repro_torch.core.selection import select_jobs
    from repro_torch.workloads.generator import build_corpus
    t0 = time.perf_counter()
    k1, launches = fig2_phase(skylines, observed, values, offsets)
    log(f"eval: Figure 2 {time.perf_counter() - t0:.3f} s")

    # §5.1 selection, the runner's fig10 row at scale 1
    t0 = time.perf_counter()
    jobs = build_corpus(1200, seed=31)
    feats = batch_job_features(jobs)
    toks = np.array([j.default_tokens for j in jobs])
    rep = select_jobs(feats, feats, (toks >= 20) & (toks <= 150),
                      n_target=200, k=8, seed=0)
    gap = lambda f: float(np.abs(f - rep.pop_cluster_frac).max())
    log(f"fig10 selection: {rep.indices.size} of {len(jobs)} jobs; KS "
        f"before {rep.ks_before!r}, after {rep.ks_after!r}; max cluster gap "
        f"pool {gap(rep.pool_cluster_frac)!r}, selected "
        f"{gap(rep.sel_cluster_frac)!r} ({time.perf_counter() - t0:.3f} s)")
    assert 0 < rep.indices.size <= 200 and rep.ks_after < rep.ks_before

    # Table 8: the runner's table8 row at scale 1
    t0 = time.perf_counter()
    if "gbdt" not in pipe.models:
        pipe.train("gbdt")
    log(f"gbdt train ({len(pipe.train_set)} jobs): "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    jobs = build_corpus(600, seed=61)
    feats = batch_job_features(jobs)
    toks = np.array([j.default_tokens for j in jobs])
    sel = select_jobs(feats, feats, (toks >= 10) & (toks <= 500),
                      n_target=120, seed=1).indices
    selected = [jobs[i] for i in sel]
    recs = pipe.ground_truth_records(selected)
    gt = build_dataset(selected, seed=99, device="cuda",
                       n_max_nodes=pipe.train_set.graph_features.shape[1])
    gt = dataclasses.replace(
        gt,
        target_a=np.array([min(r["a"], -1e-4) for r in recs], np.float32),
        target_b=np.array([max(r["b"], 1e-3) for r in recs], np.float32),
        observed_alloc=np.array([r["allocs"][0] for r in recs], np.float32),
        observed_runtime=np.array([r["runtimes"][0] for r in recs],
                                  np.float32))
    rows = {"xgboost_ss": eval_xgb_curves(
        pipe.xgb_point_predictor(), gt.features, gt.observed_alloc,
        gt.observed_runtime, gt.target_a, gt.target_b, mode="ss"),
        "xgboost_pl": eval_pcc_model(pipe.models["gbdt"], gt)}
    for key in ("nn:lf2", "gnn:lf2"):
        if key in pipe.models:
            rows[key.split(":")[0]] = eval_pcc_model(pipe.models[key], gt)
    log(f"table8 (ground truth, {len(selected)} re-executed jobs, "
        f"{time.perf_counter() - t0:.3f} s):")
    for name, ev in rows.items():
        log(f"  {name:12s} {ev.row()}")
        assert np.isfinite(ev.median_ae_runtime), name
    assert rows["nn"].pattern_non_increase == 1.0

    # the host batch policies against the scalar oracles, batch 4,096
    ds = pipe.eval_set
    a = np.asarray(ds.target_a[:4096], np.float64)
    b = np.asarray(ds.target_b[:4096], np.float64)
    obs = np.asarray(ds.observed_alloc[:4096], np.int64)
    price = np.where(np.arange(len(a)) % 3 == 0, 1.5, 1.0)
    flips = 0
    for pol in (policy, build_policy("bounded_slowdown")):
        got = choose_tokens_batch(a, b, pol, obs, device="cuda")
        flips += check_tokens(got, a, b, obs, pol)
        got = choose_tokens_priced_batch(a, b, pol, price, obs,
                                         device="cuda")
        flips += check_tokens(got, a, b, obs, pol, price)
    log(f"choose_tokens_batch / choose_tokens_priced_batch at batch "
        f"{len(a)}, two policies: == scalar oracles except {flips} flip(s) "
        f"within 4 ulp of the limit")
    return k1, launches, flips


def lm_phase():
    """The LM serving path: ``Server.run`` on minitron-8b at full width and
    depth with K4 in every prefill layer; returns K4's launch count."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig
    from repro_torch.models import lm, model_api
    from repro_torch.train.steps import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(LM_ARCH), attention_impl="pallas")
    t0 = time.perf_counter()
    params = model_api.init(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    log(f"LM {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}"
        f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params} parameters "
        f"in {cfg.param_dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    sc = ServeConfig(batch_size=8, prompt_len=2048)
    reqs = lm_requests(cfg, sc, LM_REQUESTS, LM_NEW_TOKENS)
    out, _, _, _, counts = serve_timed(cfg, params, sc, reqs)
    log(f"LM launches: {counts}")
    n_batches = -(-LM_REQUESTS // sc.batch_size)
    assert counts["flash_attention"] == cfg.num_layers * n_batches, counts

    # the first batch's prefill again: the served first tokens
    batch = first_batch(reqs, sc)
    first = [out[i][0] for i in range(sc.batch_size)]
    routes = {}
    for impl in ("pallas", "xla"):
        routes[impl] = lm.prefill(params, batch, dataclasses.replace(
            cfg, attention_impl=impl))[0].float()
        assert bool(torch.isfinite(routes[impl]).all()), impl
    assert first == routes["pallas"].argmax(-1).tolist(), \
        "rerun != served first tokens"
    log("LM prefill at full depth, bf16, K4 route vs plain route: "
        + logit_distance(routes["pallas"], routes["xla"]) + " (not held)")

    # the two routes where they agree: float32, the first layers, same weights
    n = LM_CHECK_LAYERS
    f32 = first_layers_f32(params, n)
    del params
    routes = route_logits(f32, batch, dataclasses.replace(
        cfg, num_layers=n, param_dtype="float32", compute_dtype="float32"))
    assert routes["pallas_launches"] == n, routes["pallas_launches"]
    dist = (routes["pallas"] - routes["xla"]).abs().max() / routes["xla"].std()
    log(f"LM prefill at {n} layers, float32, K4 route vs plain route: "
        + logit_distance(routes["pallas"], routes["xla"])
        + f" (limit max {LM_LOGIT_TOL})")
    assert float(dist) <= LM_LOGIT_TOL, float(dist)
    return counts["flash_attention"]


def serve_timed(cfg, params, sc, reqs):
    """``Server.run`` on the card with CUDA events around every prefill and
    decode step, after a one-request warm-up; the launch counts set to 0
    just before the run and read just after. Checks that every request got
    its tokens, each in the vocabulary. Returns (tokens by request, wall
    seconds, prefill ms, decode ms, launch counts)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, Server
    server = Server(cfg, sc, params, device="cuda")
    spans = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    server._prefill = timed("prefill", server._prefill)
    server._decode = timed("decode", server._decode)
    server.run([Request(0, reqs[0].prompt, 2)])            # warm-up
    for v in spans.values():
        v.clear()
    ops.reset_launch_counts()
    out, wall = sync_time(lambda: server.run(reqs))
    counts = ops.launch_counts()
    assert sorted(out) == [r.request_id for r in reqs]
    for r in reqs:
        assert len(out[r.request_id]) == r.max_new_tokens, r.request_id
        assert all(0 <= t < cfg.vocab_size for t in out[r.request_id])
    n_batches = -(-len(reqs) // sc.batch_size)
    new = max(r.max_new_tokens for r in reqs)
    pre = [s.elapsed_time(e) for s, e in spans["prefill"]]
    dec = [s.elapsed_time(e) for s, e in spans["decode"]]
    assert len(pre) == n_batches and len(dec) == n_batches * (new - 1)
    gen = sum(r.max_new_tokens for r in reqs)
    log(f"{cfg.name} serve: {len(reqs)} requests, {n_batches} prefills of "
        f"{sc.batch_size} x {sc.prompt_len}, {len(dec)} decode steps in "
        f"{wall:.3f} s wall; prefill {np.mean(pre):.3f} ms a batch ({pre}); "
        f"decode {np.mean(dec):.3f} ms a step (median {np.median(dec):.3f}, "
        f"CUDA events); {gen / wall:.1f} generated tokens/s; "
        f"{n_batches * sc.batch_size * sc.prompt_len / wall:.1f} prompt + "
        f"{gen / wall:.1f} new tokens a wall second; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out, wall, pre, dec, counts


def lm_requests(cfg, sc, n, new_tokens):
    """``n`` seeded requests of 256 to ``prompt_len`` tokens (left-padded
    by the server), ``new_tokens`` each."""
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.RandomState(0)
    return [Request(i, rng.randint(0, cfg.vocab_size, rng.randint(
        256, sc.prompt_len + 1)).astype(np.int32), new_tokens)
        for i in range(n)]


def first_batch(reqs, sc):
    """The first batch's prompts as the server left-pads them."""
    import numpy as np
    import torch
    prompts = np.zeros((sc.batch_size, sc.prompt_len), np.int32)
    for i, r in enumerate(reqs[:sc.batch_size]):
        prompts[i, -len(r.prompt):] = r.prompt
    return {"tokens": torch.from_numpy(prompts).cuda()}


def first_layers_f32(params, n):
    """The weights of the first ``n`` layers (and the shared ones) as
    float32 copies."""
    return {k: _map(v, (lambda t: t[:n].float()) if k == "blocks"
                    else (lambda t: t.float())) for k, v in params.items()}


def route_logits(params, batch, cfg):
    """Last-token prefill logits of the K4 route and of the plain route,
    with K4's launches in the first."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    out = {}
    for impl in ("pallas", "xla"):
        ops.reset_launch_counts()
        out[impl] = lm.prefill(params, batch, dataclasses.replace(
            cfg, attention_impl=impl))[0].float()
        out[impl + "_launches"] = ops.launch_counts()["flash_attention"]
        assert bool(torch.isfinite(out[impl]).all()), impl
    return out


def hybrid_serve_phase():
    """SSM and hybrid serving: ``Server.run`` on zamba2-2.7b at full width
    and depth with K4 in every shared-attention application of a prefill,
    the K4 route held to the plain route on its first HYBRID_CHECK_LAYERS
    layers in float32, then one batch of mamba2-1.3b at full width and
    depth. Returns K4's launches in the zamba2 run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig
    from repro_torch.models import model_api
    from repro_torch.train.steps import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              attention_impl="pallas")
    params = model_api.init(cfg, torch.Generator("cuda").manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()
    sc = ServeConfig(batch_size=8, prompt_len=2048)
    reqs = lm_requests(cfg, sc, LM_REQUESTS, LM_NEW_TOKENS)
    out, _, _, _, counts = serve_timed(cfg, params, sc, reqs)
    napps = cfg.num_layers // cfg.attn_period
    n_batches = -(-LM_REQUESTS // sc.batch_size)
    log(f"{cfg.name} serve launches: {counts} ({cfg.num_layers} Mamba-2 "
        f"layers, {napps} shared-attention applications a prefill)")
    assert counts["flash_attention"] == napps * n_batches, counts
    assert counts["ssd_scan"] == 0, counts
    batch = first_batch(reqs, sc)
    n = HYBRID_CHECK_LAYERS
    f32 = first_layers_f32(params, n)
    del params
    torch.cuda.empty_cache()
    routes = route_logits(f32, batch, dataclasses.replace(
        cfg, num_layers=n, param_dtype="float32", compute_dtype="float32"))
    assert routes["pallas_launches"] == n // cfg.attn_period == 1, routes
    dist = (routes["pallas"] - routes["xla"]).abs().max() / routes["xla"].std()
    log(f"{cfg.name} prefill at {n} layers (one shared-attention "
        f"application), float32, left-padded prompts, K4 route vs plain "
        f"route: " + logit_distance(routes["pallas"], routes["xla"])
        + f" (limit max {LM_LOGIT_TOL})")
    assert float(dist) <= LM_LOGIT_TOL, float(dist)
    del f32, routes
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    ssm = get_config(SSM_ARCH)
    params = model_api.init(ssm, torch.Generator("cuda").manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(params)) == ssm.param_count()
    reqs = lm_requests(ssm, sc, sc.batch_size, SSM_NEW_TOKENS)
    _, _, _, _, ssm_counts = serve_timed(ssm, params, sc, reqs)
    assert not any(ssm_counts.values()), ssm_counts
    del params
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def moe_serve_phase():
    """The MoE family: ``Server.run`` on moonshot-v1-16b-a3b at full width
    and depth (K4 in all 48 layers of a prefill), its K4 route held to the
    plain route on the first LM_CHECK_LAYERS layers in float32; then one
    batch of qwen3-moe-235b-a22b at full width and QWEN3_MOE_LAYERS
    layers, held the same way. Returns K4's launches in the two runs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig
    sc = ServeConfig(batch_size=8, prompt_len=2048)
    cfg = dataclasses.replace(get_config(MOE_ARCH), attention_impl="pallas")
    params = init_on_card(cfg, "full depth")
    reqs = lm_requests(cfg, sc, LM_REQUESTS, LM_NEW_TOKENS)
    out, _, _, dec, counts = serve_timed(cfg, params, sc, reqs)
    n_batches = -(-LM_REQUESTS // sc.batch_size)
    log(f"{cfg.name} serve launches: {counts}")
    assert counts["flash_attention"] == cfg.num_layers * n_batches, counts
    # a decode step reads every weight but the embedding table (B rows of
    # it) and the whole prompt-long kv cache
    itemsize = torch.finfo(torch.bfloat16).bits // 8
    weights = (cfg.param_count() - cfg.vocab_size * cfg.d_model) * itemsize
    kv = 2 * cfg.num_layers * sc.batch_size * sc.prompt_len \
        * cfg.effective_kv_heads * cfg.resolved_head_dim * itemsize
    bound_ms = (weights + kv) / HBM_BYTES_PER_S * 1e3
    experts = 3 * cfg.num_layers * cfg.num_experts * cfg.d_model * cfg.d_ff
    log(f"{cfg.name} decode: median {float(np.median(dec)):.3f} ms a step "
        f"against a {bound_ms:.3f} ms bound ({weights} bytes of weights, "
        f"{experts * itemsize} of them the experts', read by the "
        f"reference's dense expert products at capacity 1, + {kv} bytes of "
        f"kv cache, at 3.35 TB/s)")
    route_check_moe(cfg, params, out, first_batch(reqs, sc), sc)
    launches = {"moonshot": counts["flash_attention"]}

    qwen = dataclasses.replace(get_config(QWEN3_MOE_ARCH),
                               num_layers=QWEN3_MOE_LAYERS,
                               attention_impl="pallas")
    params = init_on_card(qwen, f"depth cut to {QWEN3_MOE_LAYERS} of 94 "
                          f"layers (the law's std over {QWEN3_MOE_LAYERS})")
    reqs = lm_requests(qwen, sc, sc.batch_size, SSM_NEW_TOKENS)
    out, _, _, _, counts = serve_timed(qwen, params, sc, reqs)
    log(f"{qwen.name} serve launches: {counts}")
    assert counts["flash_attention"] == qwen.num_layers, counts
    route_check_moe(qwen, params, out, first_batch(reqs, sc), sc)
    launches["qwen3"] = counts["flash_attention"]
    return launches


def init_on_card(cfg, what):
    """Seeded bf16 weights of ``cfg`` drawn on the card (seed 0), their
    count checked against the config's; the draw's seconds printed."""
    import torch
    from repro_torch.models import model_api
    from repro_torch.train.steps import tree_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(lambda: model_api.init(
        cfg, torch.Generator("cuda").manual_seed(0)))
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    log(f"{cfg.name} ({what}): {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top-"
        f"{cfg.experts_per_token} of d_ff {cfg.d_ff}, capacity factor "
        f"{cfg.capacity_factor}, vocab {cfg.vocab_size}: {n_params} "
        f"parameters ({cfg.active_param_count()} active a token) in "
        f"{cfg.param_dtype}, drawn on the card in {init_s:.3f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    return params


def route_check_moe(cfg, params, out, batch, sc):
    """The first batch's prefill rerun gives the served first tokens; then
    its first LM_CHECK_LAYERS layers in float32 through the K4 route and
    the plain route, last-token logits within LM_LOGIT_TOL std. Frees
    ``params``' card memory."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    logits = lm.prefill(params, batch, cfg)[0]
    assert [out[i][0] for i in range(sc.batch_size)] == \
        logits.argmax(-1).tolist(), "rerun != served first tokens"
    n = LM_CHECK_LAYERS
    f32 = first_layers_f32(params, n)
    params.clear()
    torch.cuda.empty_cache()
    routes = route_logits(f32, batch, dataclasses.replace(
        cfg, num_layers=n, param_dtype="float32", compute_dtype="float32"))
    assert routes["pallas_launches"] == n, routes["pallas_launches"]
    dist = (routes["pallas"] - routes["xla"]).abs().max() / routes["xla"].std()
    log(f"{cfg.name}: prefill rerun == served first tokens; prefill at {n} "
        f"layers, float32, K4 route vs plain route: "
        + logit_distance(routes["pallas"], routes["xla"])
        + f" (limit max {LM_LOGIT_TOL})")
    assert float(dist) <= LM_LOGIT_TOL, float(dist)
    del f32, routes
    torch.cuda.empty_cache()


def moe_train_phase():
    """One ``train_step`` of moonshot-v1-16b-a3b at full width, depth
    MOE_TRAIN_LAYERS, on the token pipeline's first batch of TRAIN_BATCH x
    TRAIN_SEQ: loss and aux loss finite, K4 in every layer of the forward
    and of the remat recompute. Returns K4's launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS,
                              attention_impl="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    n_params = sum(t.numel() for t in state.opt.params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH, seed=0)).batch_at(0).items()}
    step = make_train_step(cfg)
    held = torch.cuda.memory_allocated() / 2**30
    ops.reset_launch_counts()
    (_, metrics), step_s = sync_time(lambda: step(state, batch))
    counts = ops.launch_counts()
    loss, aux = float(metrics["loss"]), float(metrics["aux_loss"])
    log(f"{cfg.name} train step ({cfg.num_layers} layers at full width, "
        f"{n_params} parameters in {cfg.param_dtype}, remat "
        f"{cfg.remat_policy}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens): loss "
        f"{loss!r}, aux loss {aux!r}, grad norm "
        f"{float(metrics['grad_norm'])!r}; {step_s * 1e3:.1f} ms wall (the "
        f"first step); state {held:.2f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{counts}")
    assert np.isfinite(loss) and np.isfinite(aux) and aux > 0, (loss, aux)
    passes = 2 if cfg.remat_policy == "full" else 1
    assert counts["flash_attention"] == passes * cfg.num_layers, counts
    del state, batch, metrics
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def ckpt_phase():
    """Checkpointed, resumable training: ``run_training`` on zamba2-2.7b at
    full width, depth CKPT_LAYERS, (a) CKPT_STEPS steps uninterrupted, (b)
    CKPT_EVERY steps with a checkpoint at the last, then a new run with
    ``resume=True`` to CKPT_STEPS. The restored state equals the saved
    host snapshot bitwise; (b)'s losses equal (a)'s. Returns the resumed
    run's (K5, K4) launches."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=CKPT_LAYERS,
                              attention_impl="pallas", ssd_impl="pallas")
    kw = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0,
              log_every=1, ckpt_every=CKPT_EVERY)
    seen = {"snapshots": [], "writes": []}

    class Recording(CheckpointManager):
        """Keeps each host snapshot, times the synchronous part of a save,
        the write and the restore, and holds the restored leaves to the
        first snapshot before training touches them."""

        def save(self, step, state, **kwargs):
            _, sync_s = sync_time(lambda: super(Recording, self).save(
                step, state, **kwargs))
            seen.setdefault("save_s", []).append(sync_s)

        def _snapshot(self, leaves):
            host = super()._snapshot(leaves)
            seen["snapshots"].append(host)
            return host

        def _write(self, step, host, manifest):
            t0 = time.perf_counter()
            super()._write(step, host, manifest)
            path = os.path.join(self._dir(step), "arrays.npz")
            seen["writes"].append((step, time.perf_counter() - t0,
                                   os.path.getsize(path)))

        def restore(self, like, **kwargs):
            (state, step), seen["restore_s"] = sync_time(
                lambda: super(Recording, self).restore(like, **kwargs))
            snap = seen["snapshots"][0]
            assert len(state) == len(snap)
            for i, (t, a) in enumerate(zip(state, snap)):
                got = t.detach().cpu()
                if got.dtype == torch.bfloat16:
                    got = got.view(torch.int16)
                assert np.array_equal(got.numpy().reshape(-1).view(np.uint8),
                                      a.reshape(-1).view(np.uint8)), i
            seen["restored"] = (step, len(state))
            return state, step

    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(HERE, "build"))
    real = train_mod.CheckpointManager
    train_mod.CheckpointManager = Recording
    try:
        loop = train_mod.TrainLoopConfig
        whole = train_mod.run_training(cfg, loop(steps=CKPT_STEPS, **kw),
                                       log_fn=log)
        first = train_mod.run_training(cfg, loop(
            steps=CKPT_EVERY, ckpt_dir=root, **kw), log_fn=log)
        ops.reset_launch_counts()
        second = train_mod.run_training(cfg, loop(
            steps=CKPT_STEPS, ckpt_dir=root, resume=True, **kw), log_fn=log)
        counts = ops.launch_counts()
    finally:
        train_mod.CheckpointManager = real
        shutil.rmtree(root, ignore_errors=True)
    log(f"ckpt resumed run launches: {counts}")
    assert second["resumed_from"] == CKPT_EVERY, second["resumed_from"]
    assert seen["restored"][0] == CKPT_EVERY
    steps = CKPT_STEPS - CKPT_EVERY
    passes = 2 if cfg.remat_policy == "full" else 1
    assert counts["ssd_scan"] == steps * passes * cfg.num_layers, counts
    assert counts["flash_attention"] == \
        steps * passes * (cfg.num_layers // cfg.attn_period), counts
    step, write_s, n_bytes = seen["writes"][0]
    assert step == CKPT_EVERY
    bitwise = (first["losses"] == whole["losses"][:CKPT_EVERY]
               and second["losses"] == whole["losses"][CKPT_EVERY:])
    log(f"ckpt {cfg.name} at {CKPT_LAYERS} layers: {seen['restored'][1]} "
        f"leaves, {n_bytes} bytes written at step {step}; save "
        f"{seen['save_s'][0]:.3f} s synchronous (snapshot to host), write "
        f"{write_s:.3f} s in its thread = {n_bytes / write_s / 1e6:.1f} "
        f"MB/s; restore {seen['restore_s']:.3f} s; restored state == "
        f"saved snapshot, bitwise, every leaf; losses uninterrupted "
        f"{whole['losses']}, checkpointed {first['losses']}, resumed "
        f"{second['losses']}: bitwise equal {bitwise}")
    # whether the card's steps repeat bit for bit is printed above; the
    # losses are held to 1e-5 relative either way
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               whole["losses"], rtol=1e-5)
    return counts["ssd_scan"], counts["flash_attention"]


def logit_distance(got, want) -> str:
    """|got - want| / std(want), max and mean, and the share of equal
    argmax tokens, of two (B, V) logit matrices."""
    d = (got - want).abs() / want.std()
    same = (got.argmax(-1) == want.argmax(-1)).float().mean()
    return (f"|diff| / std max {float(d.max()):.4g}, mean "
            f"{float(d.mean()):.4g}; equal first tokens {float(same):.3f}")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2

    from repro_torch.api import (AllocationRequest, Allocator,
                                 AllocatorConfig, DecisionContext)
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.core.arepas import (simulate_runtime,
                                         simulate_runtime_ragged)
    from repro_torch.core.dataset import (AREPAS_FRACTIONS, pad_skylines,
                                          ragged_skylines)
    from repro_torch.core.evaluate import eval_pcc_model
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.kernels import _build, cluster_step, ops
    from repro_torch.serve import AllocationService
    from repro_torch.workloads import TraceGenerator

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
        for fn, info in ptxas_summary(path.with_suffix(".log").read_text()):
            log(f"  {name}: {fn}: {info}")
    log(f"K2 launch: one cluster of {cluster_step.cluster_ctas()} CTAs a shard")

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
        f"{t['skylines_s']:.3f} s, host packing {t['pack_s']:.3f} s, copies "
        f"+ K1 + copy back {t['arepas_s']:.3f} s, fits/features "
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
    lat = {b: decide_latency_ms(lambda: alloc.decide(
        request.narrow(slice(0, b)))) for b in (256, 4096)}
    log(f"decide latency (median of 20, host clock): batch 256 "
        f"{lat[256]:.3f} ms, batch 4096 {lat[4096]:.3f} ms")

    # -------------------------------------------------------------------- K1
    recs = pipe.train_set.records + ds.records
    skylines = [r.skyline for r in recs]
    values_np, offsets_np = ragged_skylines(skylines)
    allocs_np = np.array([[max(1, int(round(f * r.observed_tokens)))
                           for f in AREPAS_FRACTIONS] for r in recs], np.int32)
    values = torch.from_numpy(values_np).cuda()
    offsets = torch.from_numpy(offsets_np).cuda()
    allocs = torch.from_numpy(allocs_np).cuda()
    J, K = allocs.shape
    valid = int(offsets_np[-1])
    longest = max(len(x) for x in skylines)
    on_card = values.numel() * 4 + offsets.numel() * 8
    log(f"K1 inputs (ragged, as build_dataset passes them): values "
        f"{values.numel()} int32 + offsets {offsets.numel()} int64 = "
        f"{on_card} bytes on the card (a padded (J, Smax) int32 array would "
        f"be {J * longest * 4} bytes); allocations {tuple(allocs.shape)}; "
        f"valid seconds {valid}, longest {longest} s")
    run_kernel = lambda: ops.arepas_runtimes_ragged(values, offsets, allocs)
    run_plain = lambda: simulate_runtime_ragged(values, offsets, allocs,
                                                PLAIN_ELEMS)
    got = run_kernel()
    plain, _ = sync_time(run_plain)
    max_abs_err = int((got.long() - plain.long()).abs().max())
    assert torch.equal(got, plain), f"K1 != plain version (max {max_abs_err})"
    log(f"K1 == plain version on {J} jobs x {K} allocations (bitwise; "
        f"plain padded a chunk of at most {PLAIN_ELEMS} elements at a time)")
    got_np = got.cpu().numpy()
    sample = np.random.RandomState(0).choice(J, ORACLE_SAMPLE, replace=False)
    for j in sample:
        for k in range(K):
            want = simulate_runtime(skylines[j], int(allocs_np[j, k]))
            assert got_np[j, k] == want, (int(j), k, int(got_np[j, k]), want)
    log(f"K1 == numpy oracle on a {ORACLE_SAMPLE}-job sample (bitwise)")
    k1_ms = kernel_ms(run_kernel)
    _, plain_s = sync_time(run_plain)
    n_bytes = 4 * valid + 8 * (J + 1) + 4 * 2 * J * K
    n_ops = 2 * K * valid
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
    k3_vecs = k3_inputs(np, rng, obs_all[rows_np], tgt_a, tgt_b)
    # the candidates' skylines as a pool, read in reverse through a row index
    sky_np, lens_np = pad_skylines([skylines[i] for i in rows_np[::-1]])
    pool_rows = np.arange(K3_CANDIDATES - 1, -1, -1)
    k3_a, k3_flips = k3_phase(
        "(a) corpus", torch.from_numpy(sky_np).cuda(),
        torch.from_numpy(lens_np).cuda(), torch.from_numpy(pool_rows).cuda(),
        k3_vecs, 50.0, 15.0, alloc.policy, 6_144, sky_np, lens_np, pool_rows)
    flips += k3_flips
    del sky_np
    torch.cuda.empty_cache()

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
    del gnn, gnn_service

    # ------------------------------------------------- paper's evaluation
    t0 = time.perf_counter()
    k1_fig2, fig2_launches, eval_flips = eval_phase(
        pipe, alloc.policy, skylines,
        np.array([r.observed_tokens for r in recs], np.int64), values,
        offsets)
    flips += eval_flips
    log(f"eval phase: {time.perf_counter() - t0:.3f} s")
    kernels.append({
        "name": "arepas_runtimes_fig2", "route": "cuda",
        "source": "src/repro_torch/csrc/skyline.cu",
        "replaces": "src/repro/kernels/skyline.py:117",
        "launches": fig2_launches, **k1_fig2, "library_ms": None})
    del values, offsets

    # ------------------------------------------------- cluster path (fused)
    t0 = time.perf_counter()
    cluster_trace = TraceGenerator(seed=71, n_unique=256).generate(
        CLUSTER_EVENTS)
    log(f"cluster trace: {len(cluster_trace)} events, "
        f"{len(cluster_trace.jobs)} templates, longest skyline "
        f"{max(len(s) for s in cluster_trace.skylines)} s "
        f"({time.perf_counter() - t0:.3f} s)")
    cluster_alloc = Allocator(AllocationService(alloc.model, alloc.policy,
                                                device="cuda"), n_shards=4)
    wrep = cluster_alloc.warmup(trace=cluster_trace)
    log(f"cluster warmup: {wrep.n_precompiled} executables (CUDA graphs, "
        f"K = 4 fabric and service, buckets 8..4096) in "
        f"{wrep.cold_start_s:.3f} s")
    cluster_counts, k1_c, k2_c, k3_c, k3_flips, fused_report = cluster_phase(
        cluster_alloc, cluster_trace)
    assert fused_report.service_stats["compiles"] == 0
    flips += k3_flips
    kernels.append({
        "name": "arepas_runtimes_cluster", "route": "cuda",
        "source": "src/repro_torch/csrc/skyline.cu",
        "replaces": "src/repro/kernels/skyline.py:117",
        "launches": cluster_counts["arepas_runtimes"], **k1_c,
        "library_ms": None})
    kernels.append({
        "name": "cluster_epoch_step", "route": "cuda",
        "source": "src/repro_torch/csrc/cluster_step.cu",
        "replaces": "src/repro/kernels/cluster_step.py:246",
        "launches": cluster_counts["cluster_epoch_step"], **k2_c,
        "library_ms": None})

    # --------------------------------------------------------- replay path
    replay_k2 = replay_phase()

    # -------------------------------------------------------------------- K2
    kernels.append({
        "name": "cluster_epoch_step_replay", "route": "cuda",
        "source": "src/repro_torch/csrc/cluster_step.cu",
        "replaces": "src/repro/kernels/cluster_step.py:246",
        "launches": replay_k2, **k2_phase(), "library_ms": None})

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

    # --------------------------------------------------- serving plane
    t0 = time.perf_counter()
    *plane_counts, plane_flips = plane_phase(
        alloc.model, alloc.policy, request, observed, cluster_alloc,
        ClusterConfig(**CLUSTER_CFG, fused=True), cluster_trace,
        fused_report)
    log(f"plane phase: {time.perf_counter() - t0:.3f} s; launches of its "
        f"streaming run and its drift signal arm: {json.dumps(plane_counts)}")
    flips += plane_flips
    del cluster_alloc
    torch.cuda.empty_cache()
    log(f"pow tie flips, all paths: {flips}")

    # -------------------------------------------------------------------- K4
    k4 = k4_phase()
    # --------------------------------------------------------- LM serving
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": lm_phase(), **k4[LM_ATTN_SHAPE]})
    torch.cuda.empty_cache()
    # ------------------------------------------------ SSM, hybrid serving
    t0 = time.perf_counter()
    kernels.append({
        "name": "flash_attention_serve_d80", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": hybrid_serve_phase(), **k4[ZAMBA2_ATTN_SHAPE]})
    log(f"hybrid serve phase: {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    # ----------------------------------------------------- MoE serving
    t0 = time.perf_counter()
    moe = moe_serve_phase()
    log(f"moe serve phase: {time.perf_counter() - t0:.3f} s")
    for name, arch in (("flash_attention_moe_h16", "moonshot"),
                       ("flash_attention_moe_gqa16", "qwen3")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:113",
            "launches": moe[arch], **k4[MOE_ATTN_SHAPES[name]]})
    # ---------------------------------------------------- MoE training
    t0 = time.perf_counter()
    kernels.append({
        "name": "flash_attention_moe_train", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": moe_train_phase(),
        **k4[MOE_ATTN_SHAPES["flash_attention_moe_h16"]]})
    log(f"moe train phase: {time.perf_counter() - t0:.3f} s")

    # ------------------------------------------------ K5, both gradients
    k5 = k5_phase()
    grad_phase()
    torch.cuda.empty_cache()
    # -------------------------------------------------------- LM training
    k5_launches, k4_launches = train_phase()
    kernels.append({
        "name": "flash_attention_train_d80", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": k4_launches, **k4[ZAMBA2_ATTN_SHAPE]})
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:93",
        "launches": k5_launches, **k5})
    torch.cuda.empty_cache()
    route_phase()
    # ------------------------------------- checkpointed, resumed training
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k5_resumed, k4_resumed = ckpt_phase()
    log(f"ckpt phase: {time.perf_counter() - t0:.3f} s")
    kernels.append({
        "name": "ssd_scan_resumed", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:93",
        "launches": k5_resumed, **k5})
    kernels.append({
        "name": "flash_attention_resumed_d80", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": k4_resumed, **k4[ZAMBA2_ATTN_SHAPE]})

    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
