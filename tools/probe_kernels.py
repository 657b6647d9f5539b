#!/usr/bin/env python3
"""Kernels K1 to K5 alone on one NVIDIA card: a quick check between full
``chip_smoke.py`` runs, and the place to compare a kernel's variants
inside one call.

    python3 tools/probe_kernels.py             # all five
    python3 tools/probe_kernels.py k1 k3       # some of them

Builds the kernels (printing ptxas's registers, shared memory and spills
of every entry function), then:
  K1  on a seeded ragged corpus of the main path's size (25,000 jobs, a
      log-normal length around a 265-s median, one 193,305-s job, the
      dataset's 8-column grid) and on a cluster-like batch (28 queries x 1
      through a row index into a pool): bitwise against the plain version,
      then timed at segment lengths 1,024 to 8,192 (``-DK1_SEGMENT=n``
      builds of ``csrc/skyline.cu``, loaded beside the default one);
  K2  at the replay's (4, 8,192, 4,096) and the cluster path's largest
      (4, 8,192, 6,144) shape: bitwise against the plain version and timed
      at cluster sizes 1, 2, 4, 8 and 16 (``-DK2_CLUSTER_CTAS=C`` builds
      of ``csrc/cluster_step.cu``);
  K3  one ``pow``'s double-precision SASS instructions counted (a kernel
      that does nothing else, read with ``cuobjdump -sass``); then at its
      three record shapes (``k3_cases``) bitwise against the plain version
      as built and in -D builds of other block sizes and step lengths,
      each timed beside three builds that split the kernel's time
      (``K3_BUILDS``: decision only, fold only, neither);
  K4, K5  the bf16 instantiations against their plain versions at the card
      tests' shapes (K4 within 2e-2, causal and full; K5 within 5e-2, every
      (P, N), a 512-row chunk), two runs bitwise equal, an input that is
      not 16-byte aligned, and times at the LM shapes as ``chip_smoke.py``
      takes them (L2 flushed; K4 beside ``scaled_dot_product_attention``).
Exits non-zero if a build, a launch or a check fails.
"""
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

K4_SHAPES = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 256, 128),
             (2, 4, 4, 512, 32), (1, 32, 8, 512, 128), (2, 4, 2, 100, 16),
             (1, 2, 1, 1, 64), (1, 32, 32, 512, 80), (2, 4, 4, 100, 80),
             (1, 4, 2, 256, 80), (2, 4, 1, 1000, 128), (1, 4, 4, 2047, 80)]
K5_SHAPES = [(1, 128, 2, 32, 64, 64), (2, 256, 4, 64, 128, 128),
             (2, 512, 1, 16, 32, 128), (1, 256, 3, 64, 64, 256),
             (2, 64, 8, 16, 16, 32), (1, 48, 2, 16, 16, 128),
             (1, 512, 2, 64, 128, 256), (1, 1024, 2, 64, 64, 512)] + [
    (2, 256, 3, P, N, 128) for P in (16, 32, 64) for N in (16, 32, 64, 128)]


K1_SEGMENTS = (1024, 2048, 4096, 8192)
# K3's -D builds beside the default one: the split (-DK3_PROBE: 1 decides
# and skips the fold, 2 folds at the candidate's observed tokens and skips
# the decision, 3 skips both; none is shipped), other block sizes and step
# lengths
K3_BUILDS = {"decision only": ("K3_PROBE=1",),
             "fold only": ("K3_PROBE=2",),
             "neither": ("K3_PROBE=3",),
             "blocks of 2 warps": ("K3_BLOCK_WARPS=2",),
             "blocks of 8 warps": ("K3_BLOCK_WARPS=8",),
             "steps of 8 seconds": ("K3_CHUNK=8",),
             "steps of 16 seconds": ("K3_CHUNK=16",)}
K3_SPLITS = ("decision only", "fold only", "neither")
K2_SHAPES = [(4, 8192, 4096), (4, 8192, 6144)]
K2_CLUSTERS = (1, 2, 4, 8, 16)


def variants(name, macro, values):
    """{value: the ``name`` library built with -D``macro``=value}, the
    builds started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    defs = [(f"{macro}={v}",) for v in values]
    with ThreadPoolExecutor(len(defs)) as pool:
        list(pool.map(lambda d: _build.build([name], d), defs))
    return {v: _build.load(name, d) for v, d in zip(values, defs)}


def k1_corpus(np, seed=0, J=25_000, K=8, longest=193_305):
    """Seeded skylines of the main path's size: lengths log-normal around
    a 265-s median (mean ~540 s), one job ``longest`` s; usage in steps of
    20 to 200 s at 1 to 600 tokens (the corpus's skylines are step
    functions); allocations at the dataset's fractions of the observed
    tokens (its 8 columns repeat 1.0, 0.8 and 0.6)."""
    rng = np.random.RandomState(seed)
    lens = np.minimum(rng.lognormal(np.log(265.0), 1.19, J).astype(np.int64)
                      + 1, longest)
    lens[rng.randint(J)] = longest
    skylines = []
    for n in lens:
        blk = rng.choice([20, 60, 200])
        skylines.append(np.repeat(rng.randint(1, 600, n // blk + 1),
                                  blk)[:n].astype(np.int32))
    obs = np.array([int(s.max()) for s in skylines]) * rng.uniform(0.7, 1.3, J)
    fr = np.array([1.0, 0.8, 0.6, 0.4, 0.2, 1.0, 0.8, 0.6])[:K]
    allocs = np.maximum(1, np.round(obs[:, None] * fr)).astype(np.int32)
    return skylines, allocs


def probe_k1(np, torch, cs):
    from repro_torch.core.arepas import (simulate_runtime,
                                         simulate_runtime_batch,
                                         simulate_runtime_ragged)
    from repro_torch.core.dataset import pad_skylines, ragged_skylines
    from repro_torch.kernels import ops
    from repro_torch.kernels import skyline as k1
    bad = 0
    skylines, allocs_np = k1_corpus(np)
    values, offsets = (torch.from_numpy(x).cuda()
                       for x in ragged_skylines(skylines))
    allocs = torch.from_numpy(allocs_np).cuda()
    want = simulate_runtime_ragged(values, offsets, allocs, cs.PLAIN_ELEMS)
    # the cluster path: 28 queries x 1 allocation through a row index
    rng = np.random.RandomState(1)
    pool_sky = [s[:1833] for s in skylines[:256]]
    sky_np, lens_np = pad_skylines(pool_sky)
    sky, lens = torch.from_numpy(sky_np).cuda(), torch.from_numpy(lens_np).cuda()
    rows = torch.from_numpy(rng.randint(0, 256, 28)).cuda()
    a1 = torch.from_numpy(rng.randint(1, 600, (28, 1)).astype(np.int32)).cuda()
    want1 = simulate_runtime_batch(sky[rows], lens[rows], a1)
    valid = int(offsets[-1])
    print(f"K1 corpus: {len(skylines)} jobs, {valid} valid seconds, longest "
          f"{max(len(s) for s in skylines)}; cluster batch 28 x 1 of at most "
          f"1,833 s", flush=True)
    libs = variants("skyline", "K1_SEGMENT", K1_SEGMENTS)
    for seg in K1_SEGMENTS:
        k1._kernel = k1._bind(libs[seg])
        got = ops.arepas_runtimes_ragged(values, offsets, allocs)
        ok = torch.equal(got, want)
        got1 = ops.arepas_runtimes(sky, lens, a1, rows=rows)
        ok1 = torch.equal(got1, want1)
        det = all(torch.equal(ops.arepas_runtimes_ragged(values, offsets,
                                                         allocs), got)
                  for _ in range(3))
        bad += not (ok and ok1 and det)
        ms = cs.kernel_ms(lambda: ops.arepas_runtimes_ragged(values, offsets,
                                                             allocs))
        ms1 = cs.kernel_ms(lambda: ops.arepas_runtimes(sky, lens, a1,
                                                       rows=rows))
        print(f"K1 segment {seg}: == plain {ok} (cluster batch {ok1}), "
              f"deterministic {det}; {ms:.4f} ms at 25,000 x 8, {ms1:.4f} ms "
              f"at 28 x 1 (median of 30, L2 flushed)", flush=True)
    k1._kernel = None                             # the default build again
    got = ops.arepas_runtimes_ragged(values, offsets, allocs).cpu().numpy()
    for j in np.random.RandomState(2).choice(len(skylines), 200, replace=False):
        for k in range(allocs_np.shape[1]):
            bad += int(got[j, k] != simulate_runtime(skylines[j],
                                                     int(allocs_np[j, k])))
    print(f"K1 == numpy oracle on 200 jobs: {bad == 0}", flush=True)
    return bad


def probe_k2(np, torch, cs):
    from repro_torch.kernels import cluster_step as k2
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_step import epoch_step_ref
    bad = 0
    libs = variants("cluster_step", "K2_CLUSTER_CTAS", K2_CLUSTERS)
    for K, L, Q in K2_SHAPES:
        rng = np.random.RandomState(L + Q)
        now = 1000.0
        live = rng.rand(K, L) < 0.7
        tokens = np.where(live, rng.randint(1, 64, (K, L)), 0).astype(np.int64)
        end = np.where(live, now + rng.randint(-200, 400, (K, L)) * 0.5,
                       np.inf)
        free = rng.randint(0, 30 * Q, K).astype(np.int64)
        q_tok = rng.randint(1, 64, (K, Q)).astype(np.int64)
        q_end = now + rng.randint(1, 5000, (K, Q)).astype(np.float64)
        args = [torch.from_numpy(x).cuda()
                for x in (end, tokens, free, q_tok, q_end)]
        want = epoch_step_ref(*args, now)
        for C in K2_CLUSTERS:
            k2._loaded = k2._bind(libs[C])
            got = ops.cluster_epoch_step(*args, now)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            bad += not ok
            ms = cs.kernel_ms(lambda: ops.cluster_epoch_step(*args, now))
            print(f"K2 (K={K}, L={L}, Q={Q}) cluster {C}: == plain {ok}; "
                  f"{ms:.4f} ms (median of 30, L2 flushed); admitted "
                  f"{got[3].tolist()}", flush=True)
    k2._loaded = None                             # the default build again
    return bad


def k3_cases(np, corpus=None, pad=True):
    """Kernel K3's three record shapes, seeded: {name: dict(vecs (C,)
    arrays, sky (U, Smax) int32, lens (U,), rows (C,), now, epoch_s, cap,
    max_slowdown)}.
      (c) the cluster path's largest batch: 222 candidates through a row
          index into the cluster path's (256, 15,325) pool (the skylines
          of ``chip_smoke.py``'s seed-71 trace), rows drawn uniformly,
          observed tokens the templates' defaults (``chip_smoke.py``
          records the run's own batch of this size);
      (a) 4,096 candidates of ``k1_corpus``'s 25,000 jobs (or of
          ``corpus``, (skylines, observed tokens)), their padded skylines a
          pool read in reverse (``chip_smoke.py``'s (a) draws them from the
          main path's corpus); ``pick`` holds the pool's jobs, and
          ``pad=False`` leaves the padding to the caller;
      (b) ``chip_smoke.py``'s fused_cluster benchmark batch: C = 512,
          Smax = 512, skylines of 8 to 255 s.
    The PCCs are drawn, the observed tokens near each skyline's peak."""
    from repro_torch.core.dataset import pad_skylines

    def vecs(rng, obs):
        C = len(obs)
        return dict(a=-rng.uniform(0.2, 1.2, C),
                    b=np.exp(rng.uniform(4.0, 9.0, C)),
                    price=rng.choice([1.0, 1.5, 4.0], C),
                    obs=np.asarray(obs, np.int64),
                    floor=np.where(rng.rand(C) < 0.25,
                                   rng.randint(1, 2000, C), 1).astype(np.int64),
                    done=rng.choice([0.0, 0.25, 0.5, 0.999], C),
                    cand_tok=np.asarray(obs, np.int64),
                    cand_end=rng.uniform(100.0, 5000.0, C))

    from repro_torch.workloads import TraceGenerator
    cases = {}
    trace = TraceGenerator(seed=71, n_unique=256).generate(10_000)
    pool, plens = pad_skylines(trace.skylines)
    defaults = np.array([j.default_tokens for j in trace.jobs], np.int64)
    rng = np.random.RandomState(1)
    rows = rng.randint(0, len(plens), 222)
    cases["(c) C=222"] = dict(vecs=vecs(rng, defaults[rows]), sky=pool,
                              lens=plens, rows=rows, now=50.0, epoch_s=15.0,
                              cap=6_144, max_slowdown=0.05)
    skylines = k1_corpus(np)[0] if corpus is None else corpus[0]
    rng = np.random.RandomState(3)
    pick = np.sort(rng.choice(len(skylines), 4_096, replace=False))
    peak = np.array([int(skylines[i].max(initial=1)) for i in pick])
    obs = np.maximum(1, np.round(peak * rng.uniform(0.7, 1.3, len(pick))))
    if corpus is not None:
        obs = corpus[1][pick]
    case = dict(vecs=vecs(rng, obs.astype(np.int64)), pick=pick[::-1].copy(),
                rows=np.arange(len(pick))[::-1].copy(), now=50.0,
                epoch_s=15.0, cap=6_144, max_slowdown=0.05)
    if pad:
        case["sky"], case["lens"] = pad_skylines([skylines[i]
                                                  for i in case["pick"]])
    cases["(a) C=4096"] = case
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
    cases["(b) C=512"] = dict(vecs=vecs_b, sky=sky_b, lens=lens_b,
                              rows=np.arange(n_cand), now=50.0, epoch_s=8.0,
                              cap=65_536, max_slowdown=0.05)
    return cases


def pow_sass():
    """Double-precision instructions of one libdevice ``pow`` on sm_90a:
    a kernel that does nothing else, built with the kernels' nvcc flags and
    read with ``cuobjdump -sass``. Returns ({opcode: count} of the D*
    opcodes and MUFU, the SASS path). The count is static: every
    instruction of the routine once, its special-case branches
    (negative, zero, infinite, NaN or subnormal operands) included."""
    import collections
    import re
    from repro_torch.kernels import _build
    work = os.path.join(HERE, "..", "build", "probe_pow")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "pow.cu")
    with open(src, "w") as f:
        f.write("extern \"C\" __global__ void pow_only(const double* x, "
                "const double* a, double* y) {\n  const int i = threadIdx.x;"
                "\n  y[i] = pow(x[i], a[i]);\n}\n")
    cubin = os.path.join(work, "pow.cubin")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-cubin", "-o", cubin, src], check=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    path = os.path.join(work, "pow.sass")
    with open(path, "w") as f:
        f.write(sass)
    counts = collections.Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         sass):
        op = m.group(1)
        if op.startswith("D") or op.startswith("MUFU"):
            counts[op] += 1
    return dict(sorted(counts.items())), path


def probe_k3(np, torch, cs):
    """K3 against its plain version at the three record shapes, as built
    and in each of ``K3_BUILDS`` but the split ones (bitwise), then all of
    them timed."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.kernels import _build
    from repro_torch.kernels import cluster_step as k3
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_step import (pack_resize,
                                                  resize_step_ref,
                                                  unpack_resize)
    bad = 0
    counts, path = pow_sass()
    fl = 2 * counts.get("DFMA", 0) + counts.get("DMUL", 0) + counts.get("DADD", 0)
    print(f"K3 pow: SASS double-precision opcodes {counts}; flops "
          f"(DFMA 2, DMUL and DADD 1) {fl}; listing {path}", flush=True)
    with ThreadPoolExecutor(len(K3_BUILDS)) as pool:
        list(pool.map(lambda d: _build.build(["cluster_step"], d),
                      K3_BUILDS.values()))
    libs = {"as built": None}
    libs.update({k: k3._bind(_build.load("cluster_step", d))
                 for k, d in K3_BUILDS.items()})
    for label, d in K3_BUILDS.items():
        log = _build.library_path("cluster_step", d).with_suffix(".log")
        for fn, info in cs.ptxas_summary(log.read_text()):
            if "resize" in fn:
                print(f"K3 {label}: {fn}: {info}", flush=True)
    keys = ("a", "b", "price", "obs", "floor", "done", "cand_tok", "cand_end")
    for name, case in k3_cases(np).items():
        policy = AllocationPolicy(max_slowdown=case["max_slowdown"])
        v = [torch.from_numpy(np.ascontiguousarray(case["vecs"][k])).cuda()
             for k in keys]
        rows_np = np.asarray(case["rows"], np.int64)
        packed = torch.from_numpy(pack_resize(*(case["vecs"][k] for k in keys),
                                              rows_np)).cuda()
        sky = torch.from_numpy(case["sky"]).cuda()
        lens = torch.from_numpy(case["lens"]).cuda()
        rows = torch.from_numpy(rows_np).cuda()
        args = (case["now"], case["epoch_s"])
        run = lambda: ops.cluster_resize_step(packed, sky, lens, *args,
                                              policy=policy, cap=case["cap"])
        chunk = max(1, cs.PLAIN_ELEMS // sky.shape[1])
        C = len(rows_np)
        parts = [resize_step_ref(*[t[i:i + chunk] for t in v],
                                 sky[rows[i:i + chunk]], lens[rows[i:i + chunk]],
                                 *args, policy=policy, cap=case["cap"])
                 for i in range(0, C, chunk)]
        want = [torch.cat(p) for p in zip(*parts)]
        levels = cs.bisection_levels(v[0], v[1], v[2], v[3], policy).cpu()
        rounds = torch.bincount((levels + 4) // 5).tolist()
        vl = np.clip(case["lens"][rows_np], 0, sky.shape[1])
        print(f"K3 {name}: {C} candidates, pool {tuple(sky.shape)}, valid "
              f"seconds {int(vl.sum())} (longest {int(vl.max())}); bisection "
              f"levels mean {float(levels.double().mean()):.2f}, max "
              f"{int(levels.max())}; candidates by rounds of 5 levels "
              f"{rounds}", flush=True)
        times = {}
        for label, lib in libs.items():
            k3._loaded = lib
            if label not in K3_SPLITS:
                got = unpack_resize(run())
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
                bad += not ok
                if not ok:
                    print(f"K3 {name} {label}: != plain version", flush=True)
            times[label] = cs.kernel_ms(run)
        k3._loaded = None
        print(f"K3 {name}: == plain {bad == 0}; ms "
              + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
              + " (median of 30, L2 flushed)", flush=True)
    return bad


def probe_k4_k5(torch, cs):
    from repro_torch.kernels import ops
    bad = 0
    for shape in K4_SHAPES:
        for causal in (True, False):
            q, k, v = cs.attn_inputs(shape, torch.bfloat16, sum(shape))
            got = ops.flash_attention(q, k, v, causal=causal)
            want = cs.attn_plain(q, k, v, causal)
            ok = torch.allclose(got.float(), want.float(), atol=2e-2,
                                rtol=2e-2)
            det = torch.equal(got, ops.flash_attention(q, k, v,
                                                       causal=causal))
            bad += not (ok and det)
            print(f"K4 {shape} {'causal' if causal else 'full'}: max |diff| "
                  f"{float((got.float() - want.float()).abs().max()):.4g} "
                  f"within 2e-2 {ok}, deterministic {det}", flush=True)
    for shape in K5_SHAPES:
        args = cs.ssd_inputs(shape, torch.bfloat16, sum(shape))
        got = ops.ssd_scan(*args, chunk=shape[5])
        want = cs.ssd_plain(args, shape[5])
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=5e-2, rtol=5e-2)
        det = torch.equal(got, ops.ssd_scan(*args, chunk=shape[5]))
        bad += not (ok and det)
        print(f"K5 {shape}: max |diff| "
              f"{float((got.float() - want.float()).abs().max()):.4g} "
              f"within 5e-2 {ok}, deterministic {det}", flush=True)
    q, k, v = cs.attn_inputs((2, 4, 2, 256, 128), torch.bfloat16, 3)
    got = ops.flash_attention(*(cs.offset_view(t) for t in (q, k, v)))
    ok = torch.allclose(got.float(), cs.attn_plain(q, k, v, True).float(),
                        atol=2e-2, rtol=2e-2)
    bad += not ok
    print(f"K4 offset view (not 16-byte aligned): within 2e-2 {ok}",
          flush=True)
    if bad:
        return bad
    for shape in (cs.LM_ATTN_SHAPE, cs.ZAMBA2_ATTN_SHAPE):
        cs.k4_times(shape)
    for shape in (cs.ZAMBA2_SSD_SHAPE, cs.MAMBA2_SSD_SHAPE):
        args = cs.ssd_inputs(shape, torch.bfloat16, 7)
        ms = cs.kernel_ms(lambda: ops.ssd_scan(*args, chunk=shape[5]),
                          reps=10)
        bound, by = cs.ssd_bound_ms(shape, 2)
        print(f"K5 at {shape} bf16: {ms:.4f} ms (median of 10, L2 "
              f"flushed); bound {bound:.4f} ms ({by})", flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA card visible", file=sys.stderr)
        return 2
    which = set(sys.argv[1:]) or {"k1", "k2", "k3", "k4", "k5"}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = sorted({n for k, n in (("k1", "skyline"), ("k2", "cluster_step"),
                                   ("k3", "cluster_step"),
                                   ("k4", "flash_attention"), ("k5", "ssd"))
                    if k in which})
    t0 = time.perf_counter()
    libs = _build.build(names)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        for fn, info in cs.ptxas_summary(path.with_suffix(".log").read_text()):
            print(f"{name}: {fn}: {info}", flush=True)
    bad = 0
    if "k1" in which:
        bad += probe_k1(np, torch, cs)
    if "k2" in which:
        bad += probe_k2(np, torch, cs)
    if "k3" in which:
        bad += probe_k3(np, torch, cs)
    if which & {"k4", "k5"}:
        bad += probe_k4_k5(torch, cs)
    if bad:
        print(f"probe_kernels: {bad} case(s) failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
