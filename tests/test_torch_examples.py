"""The example twins (``examples/*_torch.py``) stay runnable on the CPU and
tell the reference examples' stories at their test sizes
(``tests/test_examples.py``): the quickstart prints the same numbers; the
cluster simulation replays the same trace with the cache path exact on
both sides (the reference's runs in a child process that sets the
``jax.experimental.enable_x64`` alias its cluster package needs, which
this process never sets); the LM twins serve and train.
"""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
EX = os.path.join(ROOT, "examples")
CLUSTER_ARGS = ("--events", "400", "--n-train", "120", "--n-unique", "32")
# the reference example, run as a script after the alias
REFERENCE = ("import jax, jax.experimental, runpy, sys; "
             "jax.experimental.enable_x64 = jax.enable_x64; "
             "sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")


def _run(*argv, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_quickstart_twin_prints_the_references_numbers():
    got = _run(os.path.join(EX, "quickstart_torch.py"), "--device", "cpu")
    want = _run(os.path.join(EX, "quickstart.py"))
    assert "bulk AREPAS on cpu: 11 runtimes agree" in got
    assert [ln for ln in got.splitlines() if "bulk AREPAS" not in ln] == \
        want.splitlines()


def test_cluster_sim_twin_replays_the_references_trace():
    got = _run(os.path.join(EX, "cluster_sim_torch.py"), *CLUSTER_ARGS,
               "--device", "cpu")
    want = _run("-c", REFERENCE, os.path.join(EX, "cluster_sim.py"),
                *CLUSTER_ARGS)
    for out in (got, want):
        assert "queries in" in out and "cache path 0.00" in out, out
    trace = [ln for ln in want.splitlines() if ln.startswith("trace:")]
    assert len(trace) == 1 and trace[0] in got.splitlines()


def test_serve_lm_twin():
    out = _run(os.path.join(EX, "serve_lm_torch.py"), "--requests", "2",
               "--new-tokens", "4", "--device", "cpu")
    assert "req 0" in out and "on cpu" in out
    out = _run(os.path.join(EX, "serve_lm_torch.py"), "--requests", "2",
               "--new-tokens", "4", "--device", "cpu", "--attention", "tri")
    assert "req 1" in out


def test_train_lm_twin(tmp_path):
    out = _run(os.path.join(EX, "train_lm_torch.py"), "--steps", "6",
               "--seq-len", "32", "--global-batch", "2", "--ckpt-dir",
               str(tmp_path), "--device", "cpu")
    assert "done: 6 steps" in out


def test_elastic_restart_twin_resumes_on_a_mesh():
    """Train on a 1x1 gloo mesh, lose a host, restore onto the mesh and
    resume, recover: the reference example's story, on DTensors."""
    out = _run(os.path.join(EX, "elastic_restart_torch.py"), "--device",
               "cpu")
    assert "replan (2, 1)" in out and "resumed from step 12" in out
    assert "full failure/resize/recovery cycle OK" in out


def test_allocate_chips_twin_prints_the_references_table(tmp_path):
    """Both examples over the same fabricated dry-run records (the
    reference's in a child with the ``enable_x64`` alias its batched
    policy needs): the same chips, PCC and bound for every job."""
    import json
    rng = __import__("numpy").random.RandomState(0)
    for i in range(6):
        rec = {"arch": f"arch{i}", "shape": "train_4k", "chips": 256,
               "roofline": {"compute_ms": float(rng.uniform(1, 300)),
                            "memory_ms": float(rng.uniform(1, 100)),
                            "collective_ms": float(rng.uniform(0, 200))}}
        with open(tmp_path / f"arch{i}_train_4k_16x16.json", "w") as f:
            json.dump(rec, f)
    got = _run(os.path.join(EX, "allocate_chips_torch.py"), "--records",
               str(tmp_path), "--device", "cpu")
    want = _run("-c", REFERENCE, os.path.join(EX, "allocate_chips.py"),
                "--records", str(tmp_path))
    assert got.splitlines() == want.splitlines()
    assert "6 records decided in one policy call" in got
