"""Window kind ``cluster_passes``: whole passes of one trace through the
port's cluster control, ``Allocator.run_cluster`` (fused: kernels K1, K2
and K3), on a fresh simulator each pass.

Set-up makes the cell's trace (the frozen generator), hands it to the
port in the port's own types, draws the model, builds the allocator's
K-shard fabric, warms its executable grid on the trace's jobs and runs a
short pass over the trace's first events, so that every kernel is built
and loaded before the window.

The window runs passes back to back while its time lasts, finishing the
pass under way, and counts them all: ``events_per_s`` is every event the
passes completed over the time they took; a rejected event is failed.
The trace and the model are the cell's own (its ``trace_seed``), so every
run does the same work; the run's seed draws the checked sample.

After the window the reference works out again what the window produced:

* ``pass_misses``: the window's first pass against the reference's own
  pass over the same trace (``reference/simulate.py``): every completion
  as the program's metrics record it (arrival, start, finish, tokens,
  cost, price, slack, shard, cache hit, allocation error, ...), the
  number of epochs and of rejected events. The reference takes from the
  program only the model's decoded (a, b) for the queries the cache
  misses, judged by the next two numbers;
* ``feature_misses``: model inputs of those queries that differ from the
  reference's featurization of their jobs;
* ``ab_gap``: the widest relative gap of their decoded (a, b) against the
  reference's float64 forward of its own features;
* ``policy_misses``: the tokens of sampled decides, every path (model,
  exact history, priced), against the float64 policy on their own (a, b),
  hint and price;
* ``k1_misses``: AREPAS runtimes of sampled K1 launches (completions,
  cache refits) against the reference's, on the reference's own skylines;
* ``k2_misses``: sampled epoch steps (expiries, admissions, the updated
  lease tables) that differ from the reference's on the same tables;
* ``k3_misses``: candidates of sampled elastic resizes whose target,
  shrink flag, runtime or end time differ from the reference's;
* ``refit_gap``: the widest relative gap of sampled cache refits' (a, b)
  against the reference's fit from its own skylines;
* ``report_mismatch``: passes whose report differs from the first pass's
  (one trace, one model: every pass must decide alike), plus events no
  pass completed;
* ``hot_path_builds``: executables built inside the window.

The sampled kernel checks follow the program step by step from the state
it recorded for each call (lease tables, queues, resize candidates); the
whole-pass check starts from the benchmark's own trace and model.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from tasq_bench import judge, tracing, weights
from tasq_bench.bounds import kernels as bounds
from tasq_bench.harness import PROFILE_S, Check, Context, Result
from tasq_bench.reference import arepas, featurize
from tasq_bench.reference import cluster as ref_cluster
from tasq_bench.reference import model as ref_model
from tasq_bench.reference import policy as ref_policy
from tasq_bench.reference import simulate as ref_sim
from tasq_bench.traffic.build import make_trace, sub_seed, to_program

# chance that a call is kept for the check, and how many of each kind
SAMPLE_P = {"K1": 0.05, "K2": 0.05, "K3": 0.2, "decide": 0.1, "refit": 0.1}
SAMPLE_CAP = {"K1": 200, "K2": 120, "K3": 120, "decide": 200, "refit": 120}
K1_ELEMS = 20_000          # K1 runtimes the reference works out, at most
# faults planted in the host loop by its settings (tests only): arrivals
# rejected past a short queue; admission in arrival order, not EDF
FAULT_SETTINGS = {"queue": {"max_queue": 8}, "order": {"admission": "fifo"}}
# a pass still running this long after the window's time is abandoned and
# its events count as failed (a run must end within its time limit)
GRACE_S = 150.0


class PassAbandoned(Exception):
    """Raised inside a pass that ran past the window's grace."""


def run(ctx: Context) -> Result:
    from repro_torch.api import Allocator
    from repro_torch.cluster import ClusterConfig, pcc_cache
    from repro_torch.cluster.metrics import ClusterMetrics
    from repro_torch.core.allocator import build_policy
    from repro_torch.kernels import ops
    from repro_torch.obs import Obs
    from repro_torch.serve import AllocationService

    cfg, cell = ctx.config, ctx.cell
    family = cfg["family"]
    traffic = dict(cell["params"], **(ctx.size or {}))
    dev = torch.device(ctx.device)
    policy = judge.policy_of(cfg)
    limits = cell["limits"]

    # ---- traffic and model ------------------------------------------------
    trace = make_trace(traffic, ctx.seed, traffic["n_events"])
    prog_trace = to_program(trace)
    warm_trace = to_program(trace, traffic["warm_events"])
    hints = np.array([j.default_tokens for j in trace.jobs], np.int64)
    # one model for every seed, as one trace: every run does the same work
    tensors, w = weights.draw(
        cfg, sub_seed(traffic.get("trace_seed", ctx.seed), 2), dev)
    scaler = weights.make_scaler(trace.skylines, hints)
    mu, sd = weights.make_standardizer(
        featurize.batch_job_features(trace.jobs[:weights.STANDARDIZER_JOBS]))
    weights.calibrate(tensors, w, trace.jobs, mu, sd)
    model = weights.program_model(cfg, tensors, scaler, mu, sd, dev)
    obs = Obs.enabled(capacity=1 << 22) if ctx.trace else None
    p = cfg["policy"]
    service = AllocationService(
        model, build_policy(p["name"], max_slowdown=p["max_slowdown"],
                            min_gain=p["min_gain"],
                            min_tokens=p["min_tokens"],
                            max_tokens=p["max_tokens"]),
        device=dev, obs=obs)
    cc = cfg["cluster"]
    alloc = Allocator(service, n_shards=cc["n_shards"], obs=obs)
    ccfg = ClusterConfig(**dict(cc, **FAULT_SETTINGS.get(ctx.fault, {})))
    alloc.warmup(trace=prog_trace)
    alloc.run_cluster(warm_trace, ccfg)

    # ---- recorders around the program's calls -------------------------------
    samplers = {k: tracing.Sampler(sub_seed(ctx.seed, 10 + i), SAMPLE_P[k],
                                   SAMPLE_CAP[k])
                for i, k in enumerate(sorted(SAMPLE_P))}
    rec: Dict[str, List] = {k: [] for k in SAMPLE_P}
    log: Dict[str, List] = {"K1": [], "K2": [], "K3": [], "decide": []}
    # the window's first pass, whole: its model-path decides and its
    # completions as the program's metrics record them
    first: Dict[str, List] = {"model": [], "done": []}
    prof = tracing.DeviceProfile(PROFILE_S) if ctx.trace else None
    on = {"window": False, "deadline": float("inf"), "pass": 0}

    def profiling():
        return prof is not None and prof.active

    k1_orig = ops.arepas_runtimes

    def k1(skylines, valid_lens, allocs, rows=None):
        out = k1_orig(skylines, valid_lens, allocs, rows=rows)
        if on["window"] and rows is not None:
            if samplers["K1"].take():
                rec["K1"].append((rows, allocs, out))
            if ctx.trace:
                log["K1"].append((rows, allocs.shape[1], profiling()))
        return out

    k2_orig = ops.cluster_epoch_step

    def k2(end_s, tokens, free, q_tok, q_end, now):
        if on["window"] and time.perf_counter() > on["deadline"]:
            raise PassAbandoned()
        keep = on["window"] and samplers["K2"].take()
        if keep or ctx.fault == "state":
            before = (end_s.clone(), tokens.clone())
        out = k2_orig(end_s, tokens, free, q_tok, q_end, now)
        if ctx.fault == "state":
            out = before + tuple(out[2:])
        if keep:
            rec["K2"].append((before, free, q_tok, q_end, float(now),
                              tuple(t.clone() for t in out)))
        if on["window"] and ctx.trace:
            log["K2"].append((tuple(end_s.shape), q_tok.shape[1],
                              profiling()))
            prof.poll()
        return out

    k3_orig = ops.cluster_resize_step

    def k3(vecs, sky, lens, now, epoch_s, *, policy, cap):
        out = k3_orig(vecs, sky, lens, now, epoch_s, policy=policy, cap=cap)
        if on["window"]:
            if samplers["K3"].take():
                rec["K3"].append((vecs.clone(), out, float(now),
                                  float(epoch_s), int(cap)))
            if ctx.trace:
                log["K3"].append((vecs.clone(), profiling()))
        return out

    fabric = alloc.frontend.fabric
    decide_orig = fabric.decide

    def decide(request, context=None):
        d = decide_orig(request, context)
        if ctx.fault == "token" and request.model_in is not None:
            d.tokens[0] += 1
        if on["window"]:
            if on["pass"] == 0 and request.model_in is not None:
                first["model"].append((request.model_in, d.a, d.b))
            if samplers["decide"].take():
                rec["decide"].append((request, context, d))
            if ctx.trace:
                log["decide"].append((request, context, d))
        return d

    refit_orig = pcc_cache.PCCCache.refine_batch

    def refit(self, keys, skylines, valid_lens, observed_tokens, peaks, *,
              rows=None, areas=None):
        a, b = refit_orig(self, keys, skylines, valid_lens, observed_tokens,
                          peaks, rows=rows, areas=areas)
        if on["window"] and rows is not None and samplers["refit"].take():
            rec["refit"].append((np.array(rows), np.array(observed_tokens),
                                 np.array(peaks), a.copy(), b.copy()))
        return a, b

    record_orig = ClusterMetrics.record_completions

    def record(self, **kw):
        if on["window"] and on["pass"] == 0:
            first["done"].append(np.stack(
                [np.asarray(kw[f], np.float64)
                 for f in ref_sim.COMPLETION_FIELDS], axis=1))
        return record_orig(self, **kw)

    patched = (tracing.patch(k1_orig, k1) + tracing.patch(k2_orig, k2)
               + tracing.patch(k3_orig, k3))
    fabric.decide = decide
    pcc_cache.PCCCache.refine_batch = refit
    ClusterMetrics.record_completions = record
    builds0 = service.stats["compiles"]
    if obs is not None:
        obs.tracer.clear()
        obs.metrics = type(obs.metrics)()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window ----------------------------------------------------------
    reports = []
    try:
        on["window"] = True
        t_start = time.perf_counter()
        on["deadline"] = t_start + ctx.seconds + GRACE_S
        setup_s = t_start - ctx.t0
        if prof is not None:
            prof.start()
        abandoned = 0
        pass_s = []
        while True:
            t_pass = time.perf_counter()
            try:
                reports.append(alloc.run_cluster(prog_trace, ccfg))
            except PassAbandoned:
                abandoned = 1
                break
            pass_s.append(time.perf_counter() - t_pass)
            on["pass"] += 1
            if time.perf_counter() - t_start >= ctx.seconds:
                break
        window_s = time.perf_counter() - t_start
        on["window"] = False
        if prof is not None:
            # the profiler's own stop inside the window is left out of it
            if not prof.active:
                window_s -= prof.stall_s
            prof.stop()
    finally:
        tracing.undo(patched)
        pcc_cache.PCCCache.refine_batch = refit_orig
        ClusterMetrics.record_completions = record_orig
        fabric.decide = decide_orig
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    builds = service.stats["compiles"] - builds0
    # a rejected event is failed, not processed
    processed = [int(r.metrics.get("n_completed", 0)) for r in reports]
    n_events = len(trace.events)
    attempted = n_events * (len(reports) + abandoned)
    unprocessed = attempted - sum(processed)
    if ctx.trace:
        ctx.traced.update(prof.summary())
        ctx.traced.update(spans=obs.tracer.spans(),
                          counters=obs.metrics.snapshot(),
                          run_window_s=window_s,
                          bound_s=_bounds(log, trace, policy, cfg))

    # ---- the check ----------------------------------------------------------
    rec = {k: [tuple(_host(x) for x in r) for r in v] for k, v in rec.items()}
    del alloc, service, model, tensors, log
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    report0 = reports[0] if reports else None
    mismatch = sum(int(r.metrics != report0.metrics
                       or not np.array_equal(r.alloc_errors,
                                             report0.alloc_errors)
                       or not np.array_equal(r.cache_hits,
                                             report0.cache_hits))
                   for r in reports[1:]) + unprocessed
    t_check = time.perf_counter()
    checks = _check_pass(ctx, family, trace, report0, first, mu, sd, w,
                         scaler, policy, cfg, limits)
    checks += _check(ctx, trace, rec, policy, limits)
    checks += [Check("report_mismatch", float(mismatch),
                     float(limits["report_mismatch"])),
               Check("hot_path_builds", float(builds),
                     float(limits["hot_path_builds"]))]
    return Result(attempted=attempted, failed=unprocessed,
                  metrics={"events_per_s": sum(processed) / window_s,
                           "setup_s": setup_s},
                  checks=checks, memory_peak_bytes=peak,
                  extra={"window": {"passes": len(reports), "pass_s": pass_s,
                                    "window_s": window_s,
                                    "epochs_per_pass": report0.n_epochs
                                    if report0 else None,
                                    "check_s": time.perf_counter()
                                    - t_check}})


def _host(x):
    """A recorded value with every tensor copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return x


def _k3_rows(vecs: torch.Tensor):
    """The nine (C,) input rows of a packed K3 buffer: a, b, price (float64),
    obs, floor (int64), done (float64), cand_tok (int64), cand_end
    (float64), pool rows (int64)."""
    f = vecs.numpy()
    i = vecs.view(torch.int64).numpy()
    return (f[0], f[1], f[2], i[3], i[4], f[5], i[6], f[7], i[8])


def _k3_out(out: torch.Tensor):
    """(tgt, sel, rt, new_end) from K3's packed 25 C-byte output."""
    C = out.shape[0] // 25
    o = out.numpy()
    return (o[:8 * C].view(np.int64), o[24 * C:].view(np.bool_),
            o[8 * C:16 * C].view(np.int64), o[16 * C:24 * C].view(np.float64))


def _pool_inputs(family, jobs):
    """The reference's model inputs of every template of the pool, as the
    program gathers its own by job index."""
    if family == "nn":
        return {"features": featurize.batch_job_features(jobs)}
    f, adj, mask = featurize.batch_graphs(jobs)
    return {"features": f, "adj": adj, "mask": mask}


def _forward(family, model_in, mu, sd, w, scaler, control):
    if family == "nn":
        z = ref_model.nn_z(model_in["features"], mu, sd, w, control)
    else:
        z = ref_model.gnn_z(model_in["features"], model_in["adj"],
                            model_in["mask"], w, control)
    return ref_model.decode(z, scaler)


def _check_pass(ctx, family, trace, report, first, mu, sd, w, scaler,
                policy, cfg, limits) -> List[Check]:
    """The window's first pass against the reference's own pass over the
    same trace: the model's inputs and decoded (a, b) for every query the
    cache missed, then every completion the pass recorded, its epochs and
    its rejections."""
    pool = _pool_inputs(family, trace.jobs)
    calls = iter(first["model"])
    gaps, feature_misses = [0.0], 0

    def model_ab(jb):
        nonlocal feature_misses
        model_in, a_p, b_p = next(calls, (None, None, None))
        if model_in is None or len(a_p) != len(jb):
            raise ref_sim.Diverged("model-path rows")
        mine = {k: v[jb] for k, v in pool.items()}
        feature_misses += sum(
            int(np.sum(np.asarray(model_in[k]) != v)) for k, v in mine.items())
        a_r, b_r = _forward(family, mine, mu, sd, w, scaler, False)
        a_j, b_j = a_p, b_p
        if ctx.control:
            a_j, b_j = _forward(family, mine, mu, sd, w, scaler, True)
        gaps.append(judge.ab_gap(a_j, b_j, a_r, b_r))
        return np.asarray(a_p, np.float64), np.asarray(b_p, np.float64)

    misses = len(trace.events)
    if report is not None:
        try:
            ref = ref_sim.simulate(
                trace.arrays(), trace.repeat_mask(), trace.skylines,
                np.array([j.default_tokens for j in trace.jobs], np.int64),
                len(trace.sla_classes), cfg["cluster"], policy, model_ab)
        except ref_sim.Diverged:
            ref = None
        if ref is not None and next(calls, None) is None:
            got = (np.concatenate(first["done"]) if first["done"]
                   else np.zeros((0, len(ref_sim.COMPLETION_FIELDS))))
            want = ref.completions
            m = min(len(got), len(want))
            same = (got[:m] == want[:m]) | (np.isnan(got[:m])
                                            & np.isnan(want[:m]))
            misses = (int(np.sum(~same.all(axis=1))) + abs(len(got)
                                                           - len(want))
                      + int(report.n_epochs != ref.n_epochs)
                      + abs(int(report.metrics.get("n_rejected", 0))
                            - ref.n_rejected))
    return [Check("ab_gap", max(gaps), float(limits["ab_gap"])),
            Check("feature_misses", float(feature_misses),
                  float(limits["feature_misses"])),
            Check("pass_misses", float(misses),
                  float(limits["pass_misses"]))]


def _check(ctx, trace, rec, policy, limits) -> List[Check]:
    """Sampled calls of the whole window, each worked out again from the
    state the program recorded for it."""
    sky = trace.skylines
    control = ctx.control
    f32 = np.float32

    # decides: the policy on each decide's own (a, b), hint and price
    p_miss, rows = 0, 0
    for req, context, d in rec["decide"]:
        price = None if context is None else context.price
        t_p = d.tokens
        if control:
            t_p = ref_policy.choose_tokens(d.a, d.b, req.observed_tokens,
                                           policy, price, dtype=f32)
        p_miss += judge.policy_misses(t_p, d.a, d.b, req.observed_tokens,
                                      policy, price)
        rows += len(d)

    # K1: AREPAS runtimes on the reference's own skylines
    k1_miss, k1_n = 0, 0
    for r, allocs, out in rec["K1"]:
        r, allocs, out = r.numpy(), allocs.numpy(), out.numpy()
        for j in range(len(r)):
            if k1_n >= K1_ELEMS:
                break
            want = arepas.runtimes(sky[int(r[j])], allocs[j])
            k1_miss += int(np.sum(want != out[j]))
            k1_n += len(want)

    # K2: the epoch step on the recorded tables
    k2_miss = 0
    for (end_s, tokens), free, q_tok, q_end, now, out in rec["K2"]:
        want = ref_cluster.epoch_step(end_s, tokens, free, q_tok, q_end, now)
        k2_miss += int(not all(torch.equal(g, x) for g, x in zip(out, want)))

    # K3: the elastic resize of each recorded candidate
    k3_miss, k3_n = 0, 0
    for vecs, out, now, epoch_s, cap in rec["K3"]:
        a, b, price, obs, floor, done, cand_tok, cand_end, r = _k3_rows(vecs)
        got = _k3_out(out)
        skl = [sky[int(x)] for x in r]
        want = ref_cluster.resize(a, b, price, obs, floor, done, cand_tok,
                                  cand_end, skl, now, epoch_s, policy, cap)
        if control:
            got = ref_cluster.resize(a, b, price, obs, floor, done, cand_tok,
                                     cand_end, skl, now, epoch_s, policy,
                                     cap, dtype=f32)
        tie = ref_policy.tie_rows(got[0], want[0], a, b, obs, policy, price)
        bad = np.zeros(len(a), bool)
        for g, x in zip(got, want):
            bad |= np.asarray(g) != np.asarray(x)
        k3_miss += int(np.sum(bad & ~tie))
        k3_n += len(a)

    # cache refits from the reference's own skylines
    r_gap = [0.0]
    for r, observed, peaks, a_p, b_p in rec["refit"]:
        a_r, b_r = ref_cluster.refit([sky[int(x)] for x in r], observed,
                                     peaks)
        r_gap.append(judge.ab_gap(a_p, b_p, a_r, b_r))

    n_checked = rows + k1_n + len(rec["K2"]) + k3_n
    return [Check("policy_misses", float(p_miss),
                  float(limits["policy_misses"])),
            Check("k1_misses", float(k1_miss), float(limits["k1_misses"])),
            Check("k2_misses", float(k2_miss), float(limits["k2_misses"])),
            Check("k3_misses", float(k3_miss), float(limits["k3_misses"])),
            Check("refit_gap", max(r_gap), float(limits["refit_gap"])),
            Check("rows_checked", float(n_checked),
                  float(limits["min_rows"]), at_least=True)]


def _bounds(log, trace, policy, cfg) -> Dict[str, float]:
    """Least device seconds of the window's launches: each kernel's over
    the launches made while the device was profiled, and all launches'
    (K1, K2, K3 and the decides) over the whole window."""
    lens = np.array([len(s) for s in trace.skylines], np.int64)
    out = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "all": 0.0}
    for rows, K, profiled in log["K1"]:
        r = rows.cpu().numpy()
        t = bounds.k1_seconds(int(lens[r].sum()), len(r), K)
        out["all"] += t
        out["K1"] += t if profiled else 0.0
    for (Ks, L), Q, profiled in log["K2"]:
        t = bounds.k2_seconds(Ks, L, Q)
        out["all"] += t
        out["K2"] += t if profiled else 0.0
    for vecs, profiled in log["K3"]:
        a, b, price, obs, *_, r = _k3_rows(vecs.cpu())
        levels = ref_policy.bisection_levels(a, b, obs, policy, price)
        t = bounds.k3_seconds(int(lens[r].sum()), levels,
                              policy.max_slowdown)
        out["all"] += t
        out["K3"] += t if profiled else 0.0
    m = cfg["model"]
    for req, context, d in log["decide"]:
        price = None if context is None else context.price
        levels = ref_policy.bisection_levels(d.a, d.b, req.observed_tokens,
                                             policy, price)
        f32 = 0
        if req.model_in is not None:
            if cfg["family"] == "nn":
                f32 = len(d) * bounds.nn_row_flops(featurize.JOB_FEATURE_DIM,
                                                   m["hidden"])
            else:
                f32 = sum(bounds.gnn_row_flops(
                    n, featurize.OPERATOR_FEATURE_DIM, m["gcn_dims"],
                    m["head_hidden"])
                    for n in np.asarray(req.model_in["mask"]).sum(-1))
        out["all"] += bounds.decide_seconds(f32, levels, policy.max_slowdown)
    return out
