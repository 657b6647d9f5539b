"""Window kind ``submit_open_loop``: single-query requests through the
port's ``ServingPlane.submit`` on an open-loop schedule.

Set-up makes the template pool and the schedule from the seed (the
frozen generator's Markov-modulated Poisson arrivals, read as wall-clock
seconds, and Zipf query identities), draws the model, starts the plane
with the configuration's workers, batch and backlog, warms every batch
and node bucket the pool can reach, and sends each template once.

The window sends each request when its schedule says, whether or not
earlier ones have come back, and times it from that moment to the moment
its future resolved (a done-callback reads the clock). ``submit_p99_ms``
is the 99th percentile over all requests of the window; a request that
fails, or has not resolved a minute after the window closed, counts as
failed. After the window the reference works out each template's
decision and a seeded sample of the batches the service decided:

* ``ab_gap``: the sampled rows' decoded (a, b) against the reference's
  float64 forward and decode of the same rows;
* ``policy_misses``: the sampled rows' tokens against the float64 policy
  on their own (a, b) and hints;
* ``token_misses``: each request's tokens (its future's result) against
  the reference's decisions for its template's (a, b) within the
  ``ab_gap`` limit;
* ``missing``: requests that failed or never resolved;
* ``hot_path_builds``: executables the service built in the window.
"""
from __future__ import annotations

import functools
import gc
import math
import threading
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from tasq_bench import judge, tracing, weights
from tasq_bench.bounds import kernels as bounds
from tasq_bench.harness import PROFILE_S, Check, Context, Result
from tasq_bench.reference import featurize
from tasq_bench.reference import model as ref_model
from tasq_bench.reference import policy as ref_policy
from tasq_bench.traffic.build import make_trace, sub_seed

SAMPLE_ROWS = 4096            # batch rows the reference checks, at most
SAMPLE_P = 0.05               # chance that a decide is sampled
DRAIN_S = 60.0                # how long answers may come after the close
WARM_S = 2.0                  # seconds of the cell's load sent before the window
# the sender sleeps at least this long when it waits, then sends every
# request that has come due: fewer wake-ups of the sending thread, so it
# takes the interpreter lock from the plane's workers less often (a request
# sent late is timed from when it was due)
TICK_S = 0.001


def _node_bucket(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _inputs(family: str, jobs) -> List[Dict[str, np.ndarray]]:
    if family == "nn":
        feats = featurize.batch_job_features(jobs)
        return [{"features": f} for f in feats]
    out = []
    for j in jobs:
        n = j.num_operators()
        out.append({"features": featurize.operator_features(j),
                    "adj": featurize.normalized_adjacency(j, n),
                    "mask": np.ones(n, np.float32)})
    return out


def _reference(family, model_in, mu, sd, w, scaler, control):
    if family == "nn":
        z = ref_model.nn_z(model_in["features"], mu, sd, w, control)
    else:
        z = ref_model.gnn_z(model_in["features"], model_in["adj"],
                            model_in["mask"], w, control)
    return ref_model.decode(z, scaler)


def schedule(params: Dict, seed: int, seconds: float):
    """Arrival seconds (from the window's start) and template picks of the
    requests due inside ``seconds``, and the trace they come from."""
    n_gen = int(math.ceil(params["rate_qps"] * seconds * 1.6)) + 64
    trace = make_trace(params, seed, n_gen)
    arrival = np.array([e.arrival_s for e in trace.events])
    picks = np.array([e.job_index for e in trace.events], np.int64)
    keep = arrival < seconds
    return arrival[keep], picks[keep], trace


def setup(ctx: Context, trace) -> SimpleNamespace:
    """The program's serving plane over a model drawn from the seed,
    warmed for every batch and node bucket of ``trace``'s pool; its
    ``service.decide`` wrapped to record what the window decides."""
    from repro_torch.core.allocator import build_policy
    from repro_torch.obs import Obs
    from repro_torch.serve import AllocationService, ServingPlane
    from repro_torch.serve.aot import WarmupConfig, warm_service

    cfg = ctx.config
    family = cfg["family"]
    dev = torch.device(ctx.device)
    jobs = trace.jobs
    st = SimpleNamespace(family=family, dev=dev, policy=judge.policy_of(cfg))
    st.hints = np.array([j.default_tokens for j in jobs], np.int64)
    st.inputs = _inputs(family, jobs)
    tensors, st.w = weights.draw(cfg, sub_seed(ctx.seed, 2), dev)
    st.scaler = weights.make_scaler(trace.skylines, st.hints)
    st.mu, st.sd = weights.make_standardizer(
        featurize.batch_job_features(jobs))
    weights.calibrate(tensors, st.w, jobs, st.mu, st.sd)
    model = weights.program_model(cfg, tensors, st.scaler, st.mu, st.sd,
                                  dev)
    st.obs = Obs.enabled(capacity=1 << 21) if ctx.trace else None
    p = cfg["policy"]
    st.service = AllocationService(
        model, build_policy(p["name"], max_slowdown=p["max_slowdown"],
                            min_gain=p["min_gain"],
                            min_tokens=p["min_tokens"],
                            max_tokens=p["max_tokens"]),
        device=dev, obs=st.obs)
    pl = cfg["plane"]
    st.plane = ServingPlane(st.service, n_workers=pl["n_workers"],
                            max_batch=pl["max_batch"], backlog=pl["backlog"],
                            pin_workers=pl.get("pin_workers", False),
                            obs=st.obs)
    st.plane.start(warmup=WarmupConfig(max_bucket=pl["max_batch"],
                                       observed=(True,), priced=False,
                                       fused=False))
    fused = WarmupConfig(max_bucket=pl["max_batch"], observed=(True,),
                         priced=False)
    if family == "nn":
        templates = [{"features": ((featurize.JOB_FEATURE_DIM,),
                                   np.float32)}]
    else:
        P = featurize.OPERATOR_FEATURE_DIM
        templates = [{"features": ((nb, P), np.float32),
                      "adj": ((nb, nb), np.float32),
                      "mask": ((nb,), np.float32)}
                     for nb in sorted({_node_bucket(j.num_operators())
                                       for j in jobs})]
    for t in templates:
        warm_service(st.service, template=t, cfg=fused, obs=st.obs)

    sampler = tracing.Sampler(sub_seed(ctx.seed, 3), SAMPLE_P, 1 << 30)
    lock = threading.Lock()
    st.recorded = []             # sampled (model_in, observed, decision)
    st.calls = []                # traced: (a, b, hints, rows or mask)
    real_decide = st.service.decide

    def decide(request, context=None):
        d = real_decide(request, context)
        if ctx.fault == "token":
            d.tokens[0] += 1
        elif ctx.fault == "half" and len(d) > 1:
            h = (len(d) + 1) // 2
            for name in ("tokens", "a", "b"):
                col = getattr(d, name)
                col[h:] = col[:len(d) - h]
        if sampler.take():
            with lock:
                st.recorded.append((request.model_in,
                                    request.observed_tokens, d))
        if ctx.trace:
            st.calls.append((d.a, d.b, request.observed_tokens,
                             request.model_in.get("mask", len(d))))
        return d

    st.service.decide = decide
    st.release = lambda: setattr(st.service, "decide", real_decide)
    send_all(st)
    st.recorded.clear()
    st.calls.clear()
    return st


def send_all(st) -> None:
    """Each template once, all at once, waiting for every answer."""
    futs = [st.plane.submit(x, observed_tokens=int(h))
            for x, h in zip(st.inputs, st.hints)]
    for f in futs:
        f.result(timeout=DRAIN_S)


def window(st, arrival, picks, seconds, prof=None) -> SimpleNamespace:
    """Send request i at ``arrival[i]`` seconds after the start, whether
    or not earlier ones have come back; wait for every answer up to
    ``DRAIN_S`` past the close. Each answer's time and tokens are written
    by its future's done-callback; the loop keeps no future, so the
    window adds nothing to what the interpreter's collector scans."""
    n = len(arrival)
    w = SimpleNamespace(done=np.full(n, np.nan), lag=np.zeros(n),
                        tokens=np.full(n, -1, np.int64))
    left = [n]
    lock = threading.Lock()
    all_done = threading.Event()
    if n == 0:
        all_done.set()

    def resolved(i, fut):
        w.done[i] = time.perf_counter()
        if fut.exception() is None:
            w.tokens[i] = fut.result()
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    gc_log = _GcLog()
    w.t_start = time.perf_counter()
    # a traced run profiles the window's last seconds, and stops the
    # profiler (which processes its events then) after the window
    prof_at = n if prof is None else int(np.searchsorted(
        arrival, max(seconds - prof.seconds, 0.0)))
    for i in range(n):
        if i == prof_at:
            prof.start()
        due = w.t_start + arrival[i]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(max(wait, TICK_S))
        u = int(picks[i])
        w.lag[i] = time.perf_counter() - due
        st.plane.submit(st.inputs[u], observed_tokens=int(st.hints[u])
                        ).add_done_callback(functools.partial(resolved, i))
    wait = w.t_start + seconds - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    w.window_s = time.perf_counter() - w.t_start
    if prof is not None and not prof.active:
        prof.start()                 # no request came in its seconds
    w.gc = gc_log.close()
    w.depth_at_close = len(st.plane.backlog)
    all_done.wait(timeout=DRAIN_S)
    if prof is not None:         # stopped (and processed) after the window
        prof.stop()
    w.lat_ms = (w.done - (w.t_start + arrival)) * 1e3
    w.ok = (w.tokens >= 0) & np.isfinite(w.lat_ms)
    lat = np.sort(w.lat_ms[w.ok])
    w.p99 = (float(lat[max(int(math.ceil(0.99 * lat.size)) - 1, 0)])
             if lat.size else float("inf"))
    w.p50 = float(np.median(lat)) if lat.size else None
    half = arrival < seconds / 2
    w.p99_halves = [float(np.percentile(w.lat_ms[w.ok & h], 99))
                    if (w.ok & h).any() else None for h in (half, ~half)]
    w.worst_lag_at_s = float(arrival[int(np.argmax(w.lag))]) if n else None
    return w


class _GcLog:
    """The interpreter's garbage-collector pauses while it is open: how
    many, and the longest and total seconds, by generation."""

    def __init__(self):
        self.pauses = {0: [], 1: [], 2: []}
        self._t = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter()
                                                   - self._t)

    def close(self):
        gc.callbacks.remove(self._cb)
        return {f"gen{g}": {"count": len(p),
                            "max_ms": 1e3 * max(p, default=0.0),
                            "total_ms": 1e3 * sum(p)}
                for g, p in self.pauses.items()}


def run(ctx: Context) -> Result:
    limits = ctx.cell["limits"]
    params = dict(ctx.cell["params"], **(ctx.size or {}))
    arrival, picks, trace = schedule(params, ctx.seed, ctx.seconds)
    st = setup(ctx, trace)
    # the window's first seconds of load, sent once untimed: the first
    # traffic after set-up stalls on first uses the warm-up grid does not
    # reach
    first = arrival < WARM_S
    window(st, arrival[first], picks[first], WARM_S)
    st.recorded.clear()
    st.calls.clear()
    builds0 = st.service.stats["compiles"]
    if st.obs is not None:
        st.obs.tracer.clear()
        st.obs.metrics = type(st.obs.metrics)()
    if st.dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(st.dev)
    prof = tracing.DeviceProfile(PROFILE_S) if ctx.trace else None
    setup_s = time.perf_counter() - ctx.t0
    w = window(st, arrival, picks, ctx.seconds, prof)
    peak = (torch.cuda.max_memory_allocated(st.dev)
            if st.dev.type == "cuda" else 0)
    builds = st.service.stats["compiles"] - builds0
    st.plane.stop()
    st.release()
    n = len(arrival)
    missing = int(n - w.ok.sum())
    if ctx.trace:
        ctx.traced.update(prof.summary())
        ctx.traced.update(spans=st.obs.tracer.spans(),
                          counters=st.obs.metrics.snapshot(),
                          run_window_s=w.window_s,
                          bound_s={"decide": _decide_bound(
                              ctx.config, st.policy, st.calls)})
    st.plane = st.service = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(ctx, st, picks, w.tokens, w.ok, limits)
    checks.append(Check("missing", float(missing), float(limits["missing"])))
    checks.append(Check("hot_path_builds", float(builds),
                        float(limits["hot_path_builds"])))
    return Result(attempted=n, failed=missing,
                  metrics={"submit_p99_ms": w.p99, "setup_s": setup_s},
                  checks=checks, memory_peak_bytes=peak,
                  extra={"window": {
                      "requests": n, "offered_per_s": n / w.window_s,
                      "p50_ms": w.p50,
                      "generator_lag_p99_ms": float(
                          np.percentile(w.lag, 99) * 1e3) if n else None,
                      "generator_lag_max_ms": float(w.lag.max() * 1e3)
                      if n else None,
                      "p99_ms_by_half": w.p99_halves,
                      "worst_lag_at_s": w.worst_lag_at_s,
                      "gc_pauses": w.gc}})


def _decide_bound(cfg, policy, calls) -> float:
    """Least device seconds of the window's decides: their model products
    over the real rows (and nodes) in float32, their policy in float64."""
    total = 0.0
    for a, b, observed, rows in calls:
        if cfg["family"] == "nn":
            f32 = len(a) * bounds.nn_row_flops(featurize.JOB_FEATURE_DIM,
                                               cfg["model"]["hidden"])
        else:
            nodes = np.asarray(rows)[:len(a)].sum(axis=-1)
            f32 = sum(bounds.gnn_row_flops(
                n, featurize.OPERATOR_FEATURE_DIM, cfg["model"]["gcn_dims"],
                cfg["model"]["head_hidden"]) for n in nodes)
        levels = ref_policy.bisection_levels(a, b, observed, policy)
        total += bounds.decide_seconds(f32, levels, policy.max_slowdown)
    return total


def _check(ctx, st, picks, tokens, ok, limits) -> List[Check]:
    family, inputs, hints, recorded = st.family, st.inputs, st.hints, \
        st.recorded
    mu, sd, w, scaler, policy = st.mu, st.sd, st.w, st.scaler, st.policy
    control = ctx.control
    delta = float(limits["ab_gap"])
    # each template's decision, as the reference (or the control) makes it
    U = len(inputs)
    if family == "nn":
        feats = np.stack([x["features"] for x in inputs])
        a_r, b_r = _reference(family, {"features": feats}, mu, sd, w, scaler,
                              False)
    else:
        a_r, b_r = np.zeros(U), np.zeros(U)
        for u, x in enumerate(inputs):
            one = {k: v[None] for k, v in x.items()}
            a_r[u], b_r[u] = (v[0] for v in _reference(
                family, one, mu, sd, w, scaler, False))
    lo, hi = judge.token_band(a_r, b_r, hints, policy, delta)
    got = tokens
    if control:
        a_c, b_c = _control_templates(family, inputs, mu, sd, w, scaler)
        ctl = ref_policy.choose_tokens(a_c, b_c, hints, policy,
                                       dtype=np.float32)
        got = np.where(ok, ctl[picks], -1)
    token_misses = judge.band_misses(got[ok], lo[picks[ok]], hi[picks[ok]])

    # the sampled batches, row by row
    gaps, misses, rows = [0.0], 0, 0
    for model_in, observed, d in recorded:
        if rows >= SAMPLE_ROWS:
            break
        rows += len(d)
        a_ref, b_ref = _reference(family, model_in, mu, sd, w, scaler, False)
        a_p, b_p, t_p = d.a, d.b, d.tokens
        if control:
            a_p, b_p = _reference(family, model_in, mu, sd, w, scaler, True)
            t_p = ref_policy.choose_tokens(a_p, b_p, observed, policy,
                                           dtype=np.float32)
        gaps.append(judge.ab_gap(a_p, b_p, a_ref, b_ref))
        misses += judge.policy_misses(t_p, a_p, b_p, observed, policy)
    return [Check("ab_gap", max(gaps), delta),
            Check("policy_misses", float(misses),
                  float(limits["policy_misses"])),
            Check("token_misses", float(token_misses),
                  float(limits["token_misses"])),
            Check("rows_checked", float(rows), float(limits["min_rows"]),
                  at_least=True)]


def _control_templates(family, inputs, mu, sd, w, scaler):
    if family == "nn":
        feats = np.stack([x["features"] for x in inputs])
        return _reference(family, {"features": feats}, mu, sd, w, scaler,
                          True)
    out = [_reference(family, {k: v[None] for k, v in x.items()}, mu, sd, w,
                      scaler, True) for x in inputs]
    return (np.array([o[0][0] for o in out]),
            np.array([o[1][0] for o in out]))
