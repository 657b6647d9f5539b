"""Window kind ``lm_batches``: whole static batches of chat requests
through the port's LM server, ``Server.run`` (prefill, then greedy
decode through the cache), closed loop.

Set-up resolves the configuration's architecture in the port (a
checkout without it exits here, before anything is drawn), cuts it to
the file's ``num_hidden_layers`` and ``layer_types``, draws the weights on
the card from the run's seed (``model_api.init``, the family's law),
makes the cell's requests from its ``trace_seed`` (prompt lengths
lognormal, clipped; token ids uniform over the vocabulary) and serves one
warm-up batch at the full shape, so that every kernel is built and every
shape met before the window.

The window serves batches of ``batch_size`` requests back to back while
its time lasts, finishing the batch under way. An event is one generated
token a request keeps: ``events_per_s`` is those of the completed batches
over the time they took.

After the window the plain reference (``reference/granite_hybrid.py``,
float32, TF32 off, one layer at a time on the card) works out again 4
requests of the window's first batch: the shortest, the longest and two
drawn from the rest by the run's seed. It runs each unpadded prompt and
the program's own generated tokens (teacher-forced) and compares the
logits of every generated position with the program's (captured on the
card during that batch):

* at each checked position, the root mean square of program - reference
  over the vocabulary, over the spread (standard deviation over the
  vocabulary) of the reference's logits there (``ref.position_gaps``);
* ``logit_gap_mean``: their mean over the checked positions, the check of
  the precision: bf16's rounding reads about a quarter of the fp8
  control's;
* ``logit_gap``: the largest of them, the check of a fault confined to
  some positions (K4 ignoring a row's start moves the padded rows' first
  positions alone);
* ``rows_checked`` (at least ``min_rows``): the positions compared;
* ``hot_path_builds``: kernel libraries built inside the window.

With ``--control 1`` the reference in fp8 e4m3 products (the precision
below the configuration's bf16) stands in the program's place and must
fail ``logit_gap_mean``.

A traced run records the port's spans and counters (``lm.batch``,
``lm.prefill``, ``lm.decode``, ``lm.mamba``, ``lm.attention``,
``lm.moe``; ``lm_*`` and ``moe_*``), profiles the device for
``PROFILE_S`` from the first batch's last attention layer in its prefill
(layer 15 of 20: at the cell's shape the prefill takes ~2.5 s, so a
profile from its start would hold one decode step), so that the profile
holds the prefill's last K4 launch, its last Mamba-2 layers' K5 launches
and some 20 decode steps, and works out each K4 and K5 launch's least
time (``bounds/lm.py``) and the window's model FLOPs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from tasq_bench import tracing
from tasq_bench.bounds import lm as bounds
from tasq_bench.harness import PROFILE_S, Check, Context, Result
from tasq_bench.reference import granite_hybrid as ref
from tasq_bench.traffic.build import sub_seed

# requests made for the window: batches of the cell's size, cycled
POOL_BATCHES = 64
CHECKED = 4          # requests of the first batch held to the reference
# a batch still running this long after the window's time is abandoned
GRACE_S = 150.0


def _model_config(cfg_json: Dict, traffic: Dict):
    """The port's config of the file's architecture, cut to its layers
    (the smoke config's own, where the traffic names one), with the
    kernels' route. Every width and scalar the reference reads from it
    (``ref.dims``) is checked against the file's own value first, so a
    wrong number in the port's config stops the run here instead of
    reaching the reference."""
    from repro_torch.configs import get_config
    arch = traffic.get("arch", cfg_json["arch"])
    mcfg = get_config(arch)
    if arch == cfg_json["arch"]:
        layers = tuple(cfg_json["layer_types"])
        mcfg = dataclasses.replace(mcfg, num_layers=len(layers),
                                   layer_types=layers)
        want = {"d_model": "hidden_size", "d_ff": "intermediate_size",
                "num_heads": "num_attention_heads",
                "num_kv_heads": "num_key_value_heads",
                "vocab_size": "vocab_size", "num_experts":
                "num_local_experts", "experts_per_token":
                "num_experts_per_tok", "shared_expert_ff":
                "shared_intermediate_size", "ssm_state": "mamba_d_state",
                "ssm_head_dim": "mamba_d_head", "ssm_conv": "mamba_d_conv",
                "ssm_chunk": "mamba_chunk_size", "num_layers":
                "num_hidden_layers", "ssm_expand": "mamba_expand",
                "ssm_heads": "mamba_n_heads",
                "resolved_attention_scale": "attention_multiplier",
                "embedding_multiplier": "embedding_multiplier",
                "residual_multiplier": "residual_multiplier",
                "logits_scaling": "logits_scaling",
                "norm_eps": "rms_norm_eps",
                "tie_embeddings": "tie_word_embeddings"}
        got = {field: getattr(mcfg, field) for field in want}
        got["resolved_head_dim"] = mcfg.resolved_head_dim
        file = {field: cfg_json[key] for field, key in want.items()}
        file["resolved_head_dim"] = (cfg_json["hidden_size"]
                                     // cfg_json["num_attention_heads"])
        for field, value in got.items():
            if value != file[field]:
                raise SystemExit(f"{arch}: {field} {value} != the file's "
                                 f"{file[field]}")
    return dataclasses.replace(mcfg, attention_impl="pallas",
                               ssd_impl="pallas")


def _requests(traffic: Dict, vocab: int, n: int):
    """(prompt lengths, prompts) of ``n`` requests from the traffic's
    ``trace_seed``: lengths lognormal (median, sigma) clipped to [min,
    prompt_len], ids uniform over the vocabulary."""
    rng = np.random.default_rng(sub_seed(traffic["trace_seed"], 1))
    lens = np.clip(np.round(rng.lognormal(np.log(traffic["median_len"]),
                                          traffic["sigma"], n)),
                   traffic["min_len"], traffic["prompt_len"]).astype(int)
    prompts = [rng.integers(0, vocab, k, dtype=np.int32) for k in lens]
    return lens, prompts


def run(ctx: Context) -> Result:
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import model_api
    from repro_torch.obs import Obs

    traffic = dict(ctx.cell["params"], **(ctx.size or {}))
    mcfg = _model_config(ctx.config, traffic)
    dev = torch.device(ctx.device)
    limits = ctx.cell["limits"]
    B, S = traffic["batch_size"], traffic["prompt_len"]
    n_new = traffic["max_new_tokens"]

    params = model_api.init(mcfg, torch.Generator(dev).manual_seed(
        sub_seed(ctx.seed, 2)), device=dev)
    lens, prompts = _requests(traffic, mcfg.vocab_size, B * POOL_BATCHES)
    batches = [[Request(b * B + i, prompts[b * B + i], n_new)
                for i in range(B)] for b in range(POOL_BATCHES)]
    obs = Obs.enabled(capacity=1 << 21) if ctx.trace else None
    server = Server(mcfg, ServeConfig(batch_size=B, prompt_len=S,
                                      max_len=S + n_new), params,
                    device=dev, obs=obs)
    server.run(batches[-1])                       # warm-up, full shape

    # ---- recorders around the program's calls ------------------------------
    first = batches[0]
    order = np.argsort([len(r.prompt) for r in first], kind="stable")
    rest = order[1:-1]
    drawn = np.random.default_rng(sub_seed(ctx.seed, 3)).choice(
        rest, size=min(CHECKED - 2, len(rest)), replace=False)
    rows = sorted({int(order[0]), int(order[-1]), *map(int, drawn)})
    rows_t = torch.tensor(rows, device=dev)
    captured: List[torch.Tensor] = []
    # the device profile needs the card (a CPU run traces the spans alone)
    prof = (tracing.DeviceProfile(PROFILE_S)
            if ctx.trace and dev.type == "cuda" else None)
    on = {"window": False, "capture": False, "deadline": float("inf"),
          "pads": None, "k4": 0}
    n_attn = sum(t == "attention" for t in mcfg.layer_types)
    log: Dict[str, List] = {"K4": [], "K5": []}

    def profiling():
        return prof is not None and prof.active

    pre_orig, dec_orig = server._prefill, server._decode

    def prefill(params_, batch, **kw):
        logits, cache = pre_orig(params_, batch, **kw)
        if on["capture"]:
            captured.append(logits.index_select(0, rows_t))
        return logits, cache

    def decode(params_, batch, **kw):
        if on["window"] and time.perf_counter() > on["deadline"]:
            raise _Abandoned()
        logits, cache = dec_orig(params_, batch, **kw)
        if on["capture"]:
            captured.append(logits.index_select(0, rows_t))
        if prof is not None:
            prof.poll()
        return logits, cache

    k4_orig, k5_orig = ops.flash_attention, ops.ssd_scan

    def k4(q, k, v, **kw):
        if on["window"]:
            on["k4"] += 1
            if prof is not None and on["k4"] == n_attn:
                prof.start()
        if on["window"] and ctx.trace:
            log["K4"].append((tuple(q.shape), k.shape[2], on["pads"],
                              profiling()))
        return k4_orig(q, k, v, **kw)

    def k5(x, dt, A, Bm, Cm, **kw):
        if on["window"] and ctx.trace and kw.get("final_state"):
            log["K5"].append((tuple(x.shape), Bm.shape[-1], kw["chunk"],
                              profiling()))
        return k5_orig(x, dt, A, Bm, Cm, **kw)

    patched = tracing.patch(k4_orig, k4) + tracing.patch(k5_orig, k5)
    server._prefill, server._decode = prefill, decode
    builds0 = len(_build._loaded)
    if obs is not None:
        obs.tracer.clear()
        obs.metrics = type(obs.metrics)()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window --------------------------------------------------------
    done, batch_s, abandoned = [], [], 0
    n_window = len(batches)
    try:
        on["window"] = True
        t_start = time.perf_counter()
        on["deadline"] = t_start + ctx.seconds + GRACE_S
        setup_s = t_start - ctx.t0
        while True:
            i = len(done)
            reqs = batches[i % n_window]
            on["capture"] = i == 0
            on["pads"] = np.array([S - min(len(r.prompt), S) for r in reqs])
            t_b = time.perf_counter()
            try:
                out = server.run(reqs)
            except _Abandoned:
                abandoned = 1
                break
            batch_s.append(time.perf_counter() - t_b)
            done.append((reqs, out))
            if time.perf_counter() - t_start >= ctx.seconds:
                break
        window_s = time.perf_counter() - t_start
        on["window"] = on["capture"] = False
        if prof is not None:
            if prof.t0 and not prof.active:
                window_s -= prof.stall_s
            prof.stop()
    finally:
        tracing.undo(patched)
        server._prefill, server._decode = pre_orig, dec_orig
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    builds = len(_build._loaded) - builds0
    kept = sum(len(o[r.request_id]) for reqs, o in done for r in reqs)
    attempted = sum(len(reqs) for reqs, _ in done) + abandoned * B
    failed = abandoned * B
    if ctx.trace:
        if prof is not None and prof.t0:
            ctx.traced.update(prof.summary())
        ctx.traced.update(
            spans=obs.tracer.spans(), counters=obs.metrics.snapshot(),
            run_window_s=window_s,
            bound_s=_bounds(log, mcfg),
            model_flops=sum(bounds.request_flops(
                mcfg, len(r.prompt), len(o[r.request_id]))
                for reqs, o in done for r in reqs),
            num_experts=mcfg.num_experts)

    # ---- the check ----------------------------------------------------------
    t_check = time.perf_counter()
    got = (torch.stack(captured, dim=1).float() if captured
           else torch.zeros(len(rows), 0, mcfg.vocab_size, device=dev))
    del captured
    gaps, n_rows = [], 0
    if done:
        reqs, out = done[0]
        seqs = [torch.from_numpy(np.concatenate(
            [reqs[r].prompt, np.asarray(out[reqs[r].request_id][:-1],
                                        np.int32)])).to(dev) for r in rows]
        keep = [len(out[reqs[r].request_id]) for r in rows]
        weights = ref.tree_weights(params, mcfg.layer_types, dev)
        dims = ref.dims(dataclasses.asdict(mcfg))
        want = ref.forward_many(seqs, weights, dims, keep)
        judged = (ref.forward_many(seqs, weights, dims, keep, control=True)
                  if ctx.control else [got[j, :keep[j]]
                                       for j in range(len(rows))])
        gaps = [ref.position_gaps(judged[j], w).cpu()
                for j, w in enumerate(want)]
        n_rows = sum(len(w) for w in want)
    if attempted == 0:
        failed = attempted = 1
    gaps = torch.cat(gaps) if n_rows else torch.zeros(1)
    checks = [Check("logit_gap_mean", float(gaps.mean()),
                    float(limits["logit_gap_mean"])),
              Check("logit_gap", float(gaps.max()), float(limits["logit_gap"])),
              Check("rows_checked", float(n_rows), float(limits["min_rows"]),
                    at_least=True),
              Check("hot_path_builds", float(builds),
                    float(limits["hot_path_builds"]))]
    return Result(attempted=attempted, failed=failed,
                  metrics={"events_per_s": kept / window_s,
                           "setup_s": setup_s},
                  checks=checks, memory_peak_bytes=peak,
                  extra={"window": {"batches": len(done),
                                    "batch_s": batch_s,
                                    "window_s": window_s,
                                    "tokens_kept": kept,
                                    "checked_rows": rows,
                                    "check_s": time.perf_counter()
                                    - t_check}})


class _Abandoned(Exception):
    """Raised inside a batch that ran past the window's grace."""


def _bounds(log, mcfg) -> Dict[str, float]:
    """Least device seconds of the K4 and K5 launches made while the
    device was profiled."""
    out = {"K4": 0.0, "K5": 0.0}
    for (B, S, Hq, D), Hkv, pads, profiled in log["K4"]:
        if profiled:
            out["K4"] += bounds.k4_seconds(B, S, Hq, Hkv, D, pads)
    for (B, S, H, P), N, Q, profiled in log["K5"]:
        if profiled:
            out["K5"] += bounds.k5_seconds(B, S, H, P, N, Q)
    return out
