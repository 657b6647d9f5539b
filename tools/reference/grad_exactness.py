#!/usr/bin/env python3
"""How exact each package's float32 LM gradients are, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/grad_exactness.py \
        [--arch moonshot-v1-16b-a3b-smoke] [--seeds 1 2 3] [--noise 1e-7]

For each batch seed (tokens and labels of 2 x 64 drawn with numpy, as
``tests/test_torch_lm_train.py`` draws them) on the reference's seeded
weights, the gradients of ``forward_train`` are taken four ways: the
reference's in float32, the port's in float32, the port's in float64
throughout (its float32 casts in norms, RoPE and softmax made float64
for the run: the exact value to float64's precision), and the port's
float32 run with a relative ``--noise`` of seeded Gaussian noise on the
rotated q and k of every layer (one ulp of float32 is 6e-8). Printed for
each: the largest over the leaves of max |g - exact| / max |exact|, and
the leaf it is on.

Needs jax and ``src/repro`` (``tools/reference/`` holds the scripts that
run the reference; those in ``tools/`` run on the card's machine, which
has neither). What it shows: whether one package's float32 backward is
less exact than
the other's, seed after seed, and how far a rounding-sized change of q
and k alone moves the gradients (the conditioning of the smoke
configurations' nearly one-hot attention).
"""
import argparse
import contextlib
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import model_api as rapi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train.steps import tree_leaves  # noqa: E402


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in sorted(tree)
                for p, v in _flat(tree[k]).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().double().numpy()
    return {"": np.asarray(tree, np.float64)}


@contextlib.contextmanager
def float64_throughout():
    """``Tensor.float()`` keeps float64 tensors float64, and the RoPE
    frequencies are float64, for the ``with`` block."""
    real_float, real_freqs = torch.Tensor.float, L.rope_freqs
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
        else real_float(t)
    L.rope_freqs = lambda hd, theta, device=None: 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float64, device=device),
        torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    try:
        yield
    finally:
        torch.Tensor.float, L.rope_freqs = real_float, real_freqs


@contextlib.contextmanager
def noisy_rope(rel, seed):
    real = L.apply_rope
    gen = torch.Generator().manual_seed(seed)

    def apply_rope(x, positions, theta):
        y = real(x, positions, theta)
        return y * (1 + rel * torch.randn(y.shape, generator=gen,
                                          dtype=y.dtype))

    L.apply_rope = apply_rope
    try:
        yield
    finally:
        L.apply_rope = real


def port_grads(arch, tree, batch, dtype):
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype,
                              compute_dtype=dtype)
    if dtype == "float64":
        p = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float64)),
                         tree)
    else:
        p = params_from_jax(tree, cfg, "cpu")
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    total, _ = lm.forward_train(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    names = sorted(_flat(tree))
    return dict(zip(names, (g.double().numpy() for g in
                            torch.autograd.grad(total, leaves))))


def ref_grads(arch, tree, batch):
    jcfg = ref_get_config(arch)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    g = jax.grad(lambda q: rlm.forward_train(q, jb, jcfg)[0])(
        jax.tree.map(jax.numpy.asarray, tree))
    return _flat(jax.tree.map(np.asarray, g))


def worst(got, exact):
    err = {k: float(np.abs(got[k] - exact[k]).max() / np.abs(exact[k]).max())
           for k in exact}
    k = max(err, key=err.get)
    return f"{err[k]:.3g} ({k})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b-smoke")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--noise", type=float, default=1e-7)
    args = ap.parse_args()
    tree = jax.tree.map(np.asarray, rapi.init(ref_get_config(args.arch),
                                              jax.random.PRNGKey(0)))
    vocab = get_config(args.arch).vocab_size
    for seed in args.seeds:
        rng = np.random.RandomState(seed)
        batch = {k: rng.randint(0, vocab, (2, 64)).astype(np.int32)
                 for k in ("tokens", "labels")}
        batch["labels"][0, :5] = -1
        with float64_throughout():
            exact = port_grads(args.arch, tree, batch, "float64")
        port = port_grads(args.arch, tree, batch, "float32")
        with noisy_rope(args.noise, seed):
            noisy = port_grads(args.arch, tree, batch, "float32")
        print(f"{args.arch} seed {seed}: largest |g - exact| / max|exact| "
              f"over the leaves: port float32 {worst(port, exact)}; "
              f"reference float32 {worst(ref_grads(args.arch, tree, batch), exact)}; "
              f"port float32 with {args.noise:g} noise on q, k "
              f"{worst(noisy, port)} (against the port's float32)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
