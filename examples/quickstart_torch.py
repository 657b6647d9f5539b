"""Quickstart on the PyTorch port: the paper's pipeline on one job, end to
end (``repro_torch``; the same steps as ``examples/quickstart.py``).

  1. synthesize a SCOPE-like job and observe its production run,
  2. AREPAS-simulate the skyline at lower token allocations (Algorithm 1),
  3. fit the power-law PCC (runtime = b * A^a),
  4. pick the optimal allocation under the §2.1 marginal-gain policy,
  5. show what the user saves.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The steps are host numpy, as in the reference; ``--device`` (default
``cuda``) places the AREPAS bisection's plain check of the chosen
allocation (``arepas_runtimes``: kernel K1 on the card).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.allocator import AllocationPolicy, choose_tokens
from repro_torch.core.arepas import (simulate_runtime, simulate_skyline,
                                     skyline_area)
from repro_torch.core.pcc import fit_pcc
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.workloads import build_corpus, observed_skyline


def ascii_skyline(sky: np.ndarray, width: int = 60, height: int = 8) -> str:
    if len(sky) == 0:
        return "(empty)"
    xs = np.linspace(0, len(sky) - 1, width).astype(int)
    vals = sky[xs]
    peak = max(vals.max(), 1)
    rows = []
    for h in range(height, 0, -1):
        cut = peak * h / height
        rows.append("".join("#" if v >= cut else " " for v in vals))
    rows.append("-" * width)
    return "\n".join(rows)


def pick_demo_job(jobs):
    """Prefer an over-allocated job with a peaky skyline — the paper's
    headline case (Figure 1/2): the user asked for far more tokens than the
    job's valleys use, so aggressive allocation saves tokens for free."""
    best, best_score = jobs[0], -1.0
    for j in jobs:
        sky = observed_skyline(j)
        if len(sky) < 100:
            continue
        peak, mean = float(sky.max()), float(sky.mean())
        over = j.default_tokens / max(peak, 1)      # over-allocation factor
        peaky = peak / max(mean, 1)                 # valley depth
        score = min(over, 4.0) * min(peaky, 4.0)
        if score > best_score:
            best, best_score = j, score
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    job = pick_demo_job(build_corpus(80, seed=4))
    print(f"job {job.job_id}: {job.num_operators()} operators, "
          f"{job.num_stages()} stages, user asked for "
          f"{job.default_tokens} tokens")

    sky = observed_skyline(job)
    print(f"\nobserved skyline ({len(sky)}s at {job.default_tokens} tokens, "
          f"area {skyline_area(sky):.0f} token-s):")
    print(ascii_skyline(sky))

    # AREPAS: one observed run -> the whole performance curve. The grid
    # spans fractions of both the request AND the observed peak, so
    # over-allocated jobs still get curvature below the peak.
    peak = int(sky.max())
    fracs = (1.0, 0.8, 0.6, 0.4, 0.2)
    allocs = sorted({max(1, int(f * base)) for f in fracs
                     for base in (job.default_tokens, peak)}, reverse=True)
    allocs = np.array(allocs)
    runtimes = np.array([len(sky) if a >= peak
                         else simulate_runtime(sky, a) for a in allocs])
    print("\nAREPAS-simulated runtimes:")
    for a, r in zip(allocs, runtimes):
        print(f"  {a:5d} tokens -> {r:6d} s")

    sim = simulate_skyline(sky, max(1, int(0.4 * job.default_tokens)))
    print(f"\nsimulated skyline at 40% allocation ({len(sim)}s, "
          f"area {skyline_area(sim):.0f} token-s):")
    print(ascii_skyline(np.asarray(sim)))

    a, b = fit_pcc(allocs, runtimes)
    print(f"\nPCC fit: runtime = {b:.1f} * A^{a:.3f}   "
          f"(Amdahl's law would be a = -1)")

    # two allocators: the PCC marginal-gain policy (what the deployed model
    # uses at compile time) and the exact AREPAS bisection (when the skyline
    # is at hand) — production clamps the former by the latter.
    from repro_torch.core.allocator import min_tokens_within_slowdown
    policy = AllocationPolicy(min_gain=0.01)
    star_pcc = choose_tokens(a, b, policy, observed_tokens=job.default_tokens)
    star_sim = min_tokens_within_slowdown(sky, job.default_tokens,
                                          max_slowdown=0.0)
    star = max(star_pcc, star_sim) if a > -1e-3 else star_pcc
    rt_star = len(sky) if star >= peak else simulate_runtime(sky, star)
    print(f"\noptimal allocation: PCC policy -> {star_pcc}, "
          f"AREPAS bisection (0% slowdown) -> {star_sim}")
    print(f"  user request: {job.default_tokens:5d} tokens, "
          f"runtime {len(sky):8d} s")
    print(f"  TASQ choice:  {star:5d} tokens, runtime {rt_star:8.0f} s")
    # the same runtimes through the bulk AREPAS wrapper on the device
    on_dev = ops.arepas_runtimes(
        torch.from_numpy(np.asarray(sky, np.int32))[None].to(device),
        torch.tensor([len(sky)], dtype=torch.int32, device=device),
        torch.tensor([[int(a) for a in allocs] + [star]], dtype=torch.int32,
                     device=device))[0].cpu().numpy()
    assert list(on_dev[:-1]) == [simulate_runtime(sky, int(a))
                                 for a in allocs]
    print(f"  bulk AREPAS on {device}: {len(allocs) + 1} runtimes agree")
    saved = 1 - star / job.default_tokens
    slow = rt_star / len(sky) - 1
    print(f"  -> {saved:.0%} fewer tokens for {max(slow, 0):.1%} slowdown")


if __name__ == "__main__":
    main()
