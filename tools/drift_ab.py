#!/usr/bin/env python3
"""The drift loop's two arms in both packages, on the same trace and seed.

    PYTHONPATH=src python tools/drift_ab.py [--n-train 20000] [--n-eval 5000]
        [--events 10000] [--unique 128] [--device cpu] [--out FILE.json]

``chip_smoke.py`` runs the drift_cluster benchmark's loop on the port
with the main path's base model (nn / lf2 on ``--n-train`` +
``--n-eval`` jobs): an "off" arm and a "signal" arm whose
``RetrainController`` refits a 400-job nn model (30 epochs, seed 7) on
drift signals and hot-swaps it in. This script runs the same ``ARMS``
text in both packages: the reference's in a child process on the CPU
(``tools/reference/drift_arms.py``, which sets the alias
``jax.experimental.enable_x64 = jax.enable_x64`` that the reference's
cluster package needs under the installed jax; this process imports
neither jax nor the reference), the port's in this process on
``--device``. Each side trains its own base
model from the same seeded corpus (``torch`` and ``jax`` draw other
initial weights, so the two base models differ as two trainings do) and
replays the same seeded drifted trace. Printed for each package and arm:
the rolling model error at the end, the swaps, the drift signals, the SLA
violation rate and the model path's allocation error. Which package's
signal arm raises the error over its off arm is what the script shows.
Unwarmed on both sides: warming changes no decision.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run by both processes; ``api`` names each package's classes.
ARMS = textwrap.dedent("""
    import time

    def arms(api, spec):
        t0 = time.perf_counter()
        base = api.Allocator.from_config(api.AllocatorConfig(
            family="nn", loss="lf2", pipeline=api.TasqConfig(
                n_train=spec["n_train"], n_eval=spec["n_eval"])),
            **api.where)
        out = {"base_s": time.perf_counter() - t0}
        trace = api.TraceGenerator(
            seed=71, n_unique=spec["unique"], rate_qps=0.2,
            drift=api.DriftSpec(n_new=spec["unique"], onset=0.15,
                                rotation=0.7, volume_growth=6.0)
        ).generate(spec["events"])
        span_s = float(trace.arrays()["arrival_s"][-1])
        policy = api.AllocationPolicy(max_slowdown=0.05)
        refit = api.TasqConfig(n_train=400, n_eval=100,
                               nn=api.NNConfig(epochs=30))
        for arm, overrides in (("off", {}),
                               ("signal", {"min_signals": 3,
                                           "cooldown_s": span_s / 5})):
            t0 = time.perf_counter()
            alloc = api.Allocator(api.AllocationService(
                base.model, policy, **api.where), n_shards=2)
            ctrl = api.RetrainController(
                family="nn", policy=arm, policy_overrides=overrides,
                pipeline_cfg=refit, max_train=400, seed=7, **api.where)
            loop = api.MLOpsLoop(alloc, ctrl)
            rep = alloc.run_cluster(
                trace, api.ClusterConfig(capacity=32768, n_shards=2),
                mlops=loop)
            m = rep.metrics
            out[arm] = dict(
                rolling_model_error=float(loop.rolling_model_error()),
                swaps=[[float(s["t_s"]), int(s["n_train"])]
                       for s in loop.swaps],
                signals=len(loop.monitor.signals),
                sla_violation_rate=float(m.get("sla_violation_rate", 0)),
                alloc_error_model=float(m.get("alloc_error_model", 0)),
                error_points=[[float(p["t_s"]),
                               float(p["rolling_model_error"])]
                              for p in loop.error_points][::50],
                n_done=int(m["n_completed"] + m["n_rejected"]),
                wall_s=time.perf_counter() - t0)
        return out
""")

CHILD = os.path.join(ROOT, "tools", "reference", "drift_arms.py")


def port_arms(spec, device):
    from repro_torch.api import Allocator, AllocatorConfig
    from repro_torch.cluster import ClusterConfig
    from repro_torch.core.allocator import AllocationPolicy
    from repro_torch.core.models import NNConfig
    from repro_torch.core.pipeline import TasqConfig
    from repro_torch.mlops import MLOpsLoop, RetrainController
    from repro_torch.serve import AllocationService
    from repro_torch.workloads import DriftSpec, TraceGenerator
    scope = {}
    exec(ARMS, scope)
    api = types.SimpleNamespace(
        Allocator=Allocator, AllocatorConfig=AllocatorConfig,
        ClusterConfig=ClusterConfig, AllocationPolicy=AllocationPolicy,
        NNConfig=NNConfig, TasqConfig=TasqConfig, MLOpsLoop=MLOpsLoop,
        RetrainController=RetrainController,
        AllocationService=AllocationService, DriftSpec=DriftSpec,
        TraceGenerator=TraceGenerator, where={"device": device})
    return scope["arms"](api, spec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--n-train", type=int, default=20_000)
    ap.add_argument("--n-eval", type=int, default=5_000)
    ap.add_argument("--events", type=int, default=10_000)
    ap.add_argument("--unique", type=int, default=128)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    spec = dict(n_train=args.n_train, n_eval=args.n_eval, events=args.events,
                unique=args.unique)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.json")
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, CHILD, ARMS, json.dumps(spec), path],
            env=env, cwd=ROOT)
        try:
            port = port_arms(spec, args.device)
        finally:
            rc = child.wait()
        if rc:
            raise SystemExit(f"the reference's child process failed ({rc})")
        with open(path) as f:
            ref = json.load(f)
    result = {"spec": spec, "device": args.device, "port": port,
              "reference": ref, "wall_s": time.perf_counter() - t0}
    for side in ("reference", "port"):
        r = result[side]
        print(f"{side}: base model {r['base_s']:.1f} s; " + "; ".join(
            f"{arm}: rolling model error {r[arm]['rolling_model_error']:.4f}"
            f", {len(r[arm]['swaps'])} swap(s), {r[arm]['signals']} "
            f"signals, SLA violations {r[arm]['sla_violation_rate']:.4f}, "
            f"model-path allocation error {r[arm]['alloc_error_model']:.4f}"
            for arm in ("off", "signal")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({side: {arm: result[side][arm]["rolling_model_error"]
                             for arm in ("off", "signal")}
                      for side in ("reference", "port")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
