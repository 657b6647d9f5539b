"""``Server.run``, port against reference, token for token, on
minitron-8b-smoke (dense), zamba2-2.7b-smoke (hybrid),
mamba2-1.3b-smoke (ssm) and moonshot-v1-16b-a3b-smoke (MoE) under both
attention routes: 8 requests (prompts
shorter and longer than the prefill length, 1 to 7 new tokens) at batch
3, so three prefills, the last one with an empty slot.

The reference's ``launch/serve.py`` imports ``repro.serve``, which needs
``jax.experimental.enable_x64``, gone from the installed jax. A child
process sets the alias ``jax.experimental.enable_x64 = jax.enable_x64``,
runs the reference server on weights this process drew with the
reference's initialiser, and writes its tokens as JSON; the alias never
touches this process, so the reference's own test files keep failing as
they do without the port. The port serves the same requests meanwhile.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model_api as rapi
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, ServeConfig, Server
from repro_torch.models.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "minitron-8b-smoke"
SSM_ARCHS = ("zamba2-2.7b-smoke", "mamba2-1.3b-smoke")
MOE_ARCH = "moonshot-v1-16b-a3b-smoke"
SERVE = dict(batch_size=3, prompt_len=16)
IMPLS = ("xla", "pallas")

CHILD = textwrap.dedent("""
    import dataclasses, json, pickle, sys
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.serve import Request, ServeConfig, Server

    spec = json.loads(sys.argv[1])
    with open(sys.argv[2], "rb") as f:
        trees = pickle.load(f)
    out = {}
    for arch, (tree, requests) in trees.items():
        params = jax.tree.map(jnp.asarray, tree)
        reqs = [Request(i, np.asarray(p, np.int32), n)
                for i, (p, n) in enumerate(requests)]
        for impl in spec["impls"]:
            cfg = dataclasses.replace(get_config(arch), attention_impl=impl)
            got = Server(cfg, ServeConfig(**spec["serve"]), params).run(reqs)
            out[f"{arch}/{impl}"] = {str(k): v for k, v in got.items()}
    with open(sys.argv[3], "w") as f:
        json.dump(out, f)
""")


def _requests(arch):
    rng = np.random.RandomState(21)
    vocab = get_config(arch).vocab_size
    lens = [5, 16, 30, 1, 12, 16, 40, 9]
    return [(rng.randint(0, vocab, n).astype(np.int32).tolist(),
             int(rng.randint(1, 8))) for n in lens]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both servers' tokens for every config and attention route, keyed
    "arch/impl": the reference's from the child process, the port's from
    this one, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("lm_serve")
    trees = {arch: (jax.tree.map(np.asarray, rapi.init(
        ref_get_config(arch), jax.random.PRNGKey(0))), _requests(arch))
        for arch in (ARCH,) + SSM_ARCHS + (MOE_ARCH,)}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(trees, f)
    spec = {"serve": SERVE, "impls": list(IMPLS)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src")] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p])}
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(spec),
         str(tmp / "params.pkl"), str(tmp / "tokens.json")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = {}
        for arch, (tree, reqs) in trees.items():
            for impl in IMPLS:
                cfg = dataclasses.replace(get_config(arch),
                                          attention_impl=impl)
                server = Server(cfg, ServeConfig(**SERVE),
                                params_from_jax(tree, cfg, "cpu"),
                                device="cpu")
                port[f"{arch}/{impl}"] = server.run(
                    [Request(i, np.asarray(p, np.int32), n)
                     for i, (p, n) in enumerate(reqs)])
        log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, log[-4000:]
    ref = json.loads((tmp / "tokens.json").read_text())
    return port, {key: {int(k): v for k, v in got.items()}
                  for key, got in ref.items()}, _requests(ARCH)


@pytest.mark.parametrize("impl", IMPLS)
def test_server_tokens_equal_reference(served, impl):
    port, ref, reqs = served
    key = f"{ARCH}/{impl}"
    assert port[key] == ref[key]
    assert [len(port[key][i]) for i in range(len(reqs))] == [
        n for _, n in reqs]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_server_tokens_equal_reference(served, arch, impl):
    """The Mamba-2 stack (its SSM state carried in the cache) and the
    hybrid (also one shared-attention kv cache an application) through the
    same ``Server.run``, no family branch in it."""
    port, ref, reqs = served
    key = f"{arch}/{impl}"
    assert port[key] == ref[key]
    assert [len(port[key][i]) for i in range(len(reqs))] == [
        n for _, n in reqs]


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_server_tokens_equal_reference(served, impl):
    """The MoE family through the same ``Server.run``: its prefill routes
    every prompt token top-2 of 8 experts at capacity 5 a sequence (16
    tokens), each decode step one token at capacity 1."""
    port, ref, _ = served
    key = f"{MOE_ARCH}/{impl}"
    assert port[key] == ref[key]
    assert [len(port[key][i]) for i in range(8)] == [
        n for _, n in _requests(MOE_ARCH)]


def test_server_decodes_longest_request_minus_one_steps():
    """Each batch: one prefill and max(max_new_tokens) - 1 decode steps
    for every slot; each request keeps its first max_new_tokens tokens."""
    cfg = get_config(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, rapi.init(
        ref_get_config(ARCH), jax.random.PRNGKey(1))), cfg, "cpu")
    server = Server(cfg, ServeConfig(**SERVE), params, device="cpu")
    calls = {"prefill": 0, "decode": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    server._prefill = counted("prefill", server._prefill)
    server._decode = counted("decode", server._decode)
    reqs = [Request(i, np.arange(1, 4 + i, dtype=np.int32), n)
            for i, n in enumerate([2, 5, 1, 3])]
    out = server.run(reqs)
    assert calls == {"prefill": 2, "decode": (5 - 1) + (3 - 1)}
    assert {k: len(v) for k, v in out.items()} == {0: 2, 1: 5, 2: 1, 3: 3}
    assert all(0 <= t < cfg.vocab_size for v in out.values() for t in v)


def test_server_runs_on_the_card_unless_asked():
    """The default device is the card; without one the server raises
    instead of moving to the host."""
    cfg = get_config(ARCH)
    if torch.cuda.is_available():
        assert Server(cfg, ServeConfig(**SERVE), {}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Server(cfg, ServeConfig(**SERVE), {})
