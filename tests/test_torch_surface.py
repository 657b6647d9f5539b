"""The port's public surface against the reference's, read mechanically.

Every module under ``src/repro/`` is parsed (its AST: nothing of jax is
imported). Each public top-level name (defined there, or listed in its
``__all__``), each public method of a public class (and ``__init__``), and
each parameter name of those functions and methods must exist in the
mirrored module under ``src/repro_torch/``, which is imported: a method
may come from a base class there, and a parameter must be a named
parameter of the port's signature. What the port does not carry by name
stands in ``JAX_ONLY`` with its counterpart, or with one line saying why
there is none. The map holds only jax idioms: a stale entry (its name gone
from the reference, or present in the port after all) fails as an
unmatched name does.

Keys: ``"path:Name"``, ``"path:Class.method"``, ``"path:func(param)"`` and
``"path:Class.method(param)"``, with ``path`` relative to ``src/repro/``.
"""
import ast
import importlib
import inspect
import pathlib
from typing import Dict, List, Set, Tuple

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF = SRC / "repro"

_JNP = "the float64 torch function (`*_torch`) on the device"
_KERNEL = "kernels/ops.py's wrapper of the Hopper kernel"
_PYTREE = "pytree registration for jax transforms; no counterpart in torch"

JAX_ONLY: Dict[str, str] = {
    # jnp / jit twins of the numpy math: float64 torch functions
    "core/__init__.py:choose_tokens_jnp": "choose_tokens_torch",
    "core/__init__.py:min_tokens_within_slowdown_jnp":
        "min_tokens_within_slowdown_torch",
    "core/allocator.py:choose_tokens_jnp": "choose_tokens_torch",
    "core/allocator.py:choose_tokens_priced_jnp":
        "choose_tokens_priced_torch",
    "core/allocator.py:min_tokens_within_slowdown_jnp":
        "min_tokens_within_slowdown_torch",
    "core/arepas.py:simulate_runtime_batch_jit":
        "simulate_runtime_batch (torch, K1 on the card)",
    "core/arepas.py:simulate_runtime_jax": _JNP + ": simulate_runtime_batch",
    "core/pcc.py:pcc_runtime_jax": "pcc_runtime_torch",
    # the model zoo's functional jax surface: torch modules
    "core/models/__init__.py:JaxPCCModel": "TorchPCCModel",
    "core/models/base.py:JaxPCCModel": "TorchPCCModel",
    "core/models/base.py:PCCModel.supports_jit": "PCCModel.supports_fused",
    "core/models/base.py:PCCModel.params":
        "the module's parameters (TorchPCCModel.module)",
    "core/models/base.py:PCCModel.serve_apply(params)":
        "the model's own module holds the parameters",
    "core/models/base.py:NNModel.serve_apply(params)":
        "the model's own module holds the parameters",
    "core/models/base.py:GNNModel.serve_apply(params)":
        "the model's own module holds the parameters",
    "core/models/nn.py:fit_model(params)":
        "fit_model(module): the module holds its parameters",
    "core/models/__init__.py:make_nn": "MLP",
    "core/models/nn.py:make_nn": "MLP",
    "core/models/nn.py:init_mlp": "MLP",
    "core/models/nn.py:mlp_apply": "MLP.forward",
    "core/models/__init__.py:make_gnn": "GNN",
    "core/models/gnn.py:make_gnn": "GNN",
    "core/models/gnn.py:init_gnn": "GNN",
    "core/models/gnn.py:gnn_apply": "GNN.forward",
    # the functional optimizer: a torch optimizer object
    "optim/__init__.py:adamw_init": "AdamW",
    "optim/__init__.py:adamw_update": "AdamW.update",
    "optim/adamw.py:adamw_init": "AdamW",
    "optim/adamw.py:adamw_update": "AdamW.update",
    # the Pallas calls and their constants: the Hopper kernels
    "kernels/cluster_step.py:epoch_step_pallas":
        "kernels/cluster_step.py:epoch_step (K2)",
    "kernels/cluster_step.py:resize_step_pallas":
        "kernels/cluster_step.py:resize_step (K3)",
    "kernels/flash_attention.py:flash_attention_bhsd":
        "kernels/flash_attention.py:flash_attention_bshd (K4)",
    "kernels/ref.py:skyline_runtime_ref":
        "the plain K1: core/arepas.py:simulate_runtime_batch",
    "kernels/cluster_step.py:DEFAULT_LEASE_BLOCK":
        "a Pallas block size; the CUDA kernels fix theirs at build time",
    "kernels/flash_attention.py:DEFAULT_BLOCK_Q":
        "a Pallas block size; K4's tiles are compile-time constants",
    "kernels/flash_attention.py:DEFAULT_BLOCK_K":
        "a Pallas block size; K4's tiles are compile-time constants",
    "kernels/skyline.py:DEFAULT_TIME_BLOCK":
        "a Pallas block size; K1 segments by K1_SEGMENT at build time",
    "kernels/flash_attention.py:NEG_INF":
        "the Pallas kernel's mask constant; K4 masks inside its CUDA source",
    # parameters of jax idiom
    "kernels/ops.py:arepas_runtimes(time_block)": "a Pallas block size",
    "kernels/ops.py:arepas_runtimes(interpret)":
        "Pallas interpret mode; a CPU tensor takes the plain version",
    "kernels/skyline.py:skyline_runtimes(time_block)": "a Pallas block size",
    "kernels/skyline.py:skyline_runtimes(interpret)":
        "Pallas interpret mode; a CPU tensor takes the plain version",
    "kernels/ops.py:cluster_epoch_step(impl)": "dispatch by the device",
    "kernels/ops.py:cluster_epoch_step(lease_block)": "a Pallas block size",
    "cluster/pool.py:PoolShards.admit_epoch(impl)": "dispatch by the device",
    "kernels/ops.py:cluster_resize_step(impl)": "dispatch by the device",
    "kernels/ops.py:cluster_resize_step(time_block)": "a Pallas block size",
    "kernels/ops.py:flash_attention(block_q)": "a Pallas block size",
    "kernels/ops.py:flash_attention(block_k)": "a Pallas block size",
    "kernels/ops.py:flash_attention(interpret)":
        "Pallas interpret mode; a CPU tensor takes the plain version",
    "kernels/ops.py:ssd_scan(interpret)":
        "Pallas interpret mode; a CPU tensor takes the plain version",
    "kernels/ssd.py:ssd_chunk_scan(interpret)":
        "Pallas interpret mode; a CPU tensor takes the plain version",
    **{f"kernels/ops.py:cluster_resize_step({p})":
       "cluster_resize_step's packed vecs (cluster_step.pack_resize)"
       for p in ("a", "b", "price", "obs", "floor", "done", "cand_tok",
                 "cand_end")},
    "models/model_api.py:init(rng)": "generator, a torch.Generator",
    "models/model_api.py:smoke_batch(rng)": "seed, for a torch.Generator",
    "models/params.py:init_params(rng)": "generator, a torch.Generator",
    "train/steps.py:init_train_state(rng)": "generator, a torch.Generator",
    "train/steps.py:make_train_step(opt_cfg)":
        "taken at init_train_state: the state's AdamW holds its config",
    "optim/compression.py:compressed_psum(axis_name)": "group, a process group",
    "optim/compression.py:compress_tree(axis_name)": "group, a process group",
    "launch/dryrun.py:lower_cell(dump_hlo)":
        "no HLO: the dry run traces on a fake process group",
    # pytree registration
    "models/lm.py:Cache.tree_flatten": _PYTREE,
    "models/lm.py:Cache.tree_unflatten": _PYTREE,
    "train/steps.py:TrainState.tree_flatten": _PYTREE,
    "train/steps.py:TrainState.tree_unflatten": _PYTREE,
}

# What the map must never hold: each is real behaviour, ported.
NOT_IDIOMS = ("mesh", "allocate_", "AllocationResult", "train_xgb",
              "train_nn", "train_gnn", "predict_params", "param_count",
              "warn_deprecated", "reset_deprecation_warnings", "_compat",
              "host_fraction", "measured_bw")


def _top_stmts(body):
    for s in body:
        if isinstance(s, ast.If):
            yield from _top_stmts(s.body)
            yield from _top_stmts(s.orelse)
        elif isinstance(s, ast.Try):
            yield from _top_stmts(s.body)
        else:
            yield s


def _params(fn) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _module_name(rel: pathlib.Path) -> str:
    parts = ("repro_torch",) + rel.with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def reference_surface(rel: pathlib.Path) -> Tuple[Set[str], Dict, Dict]:
    """(public names, {class: [methods]}, {"f" | "C.m": [params]}) of one
    reference module."""
    tree = ast.parse((REF / rel).read_text())
    names: Set[str] = set()
    methods: Dict[str, List[str]] = {}
    params: Dict[str, List[str]] = {}
    for s in _top_stmts(tree.body):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(s.name)
            params[s.name] = _params(s)
        elif isinstance(s, ast.ClassDef):
            names.add(s.name)
            methods[s.name] = []
            for b in s.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not b.name.startswith("_")
                             or b.name == "__init__"):
                    methods[s.name].append(b.name)
                    params[f"{s.name}.{b.name}"] = _params(b)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    names.update(e.value for e in s.value.elts)
                names.add(t.id)
    names = {n for n in names if not n.startswith("_")}
    return names, methods, params


def surface_keys(rel: pathlib.Path) -> Set[str]:
    """Every key of one reference module, matched or not."""
    names, methods, params = reference_surface(rel)
    keys = set()
    for n in names:
        keys.add(f"{rel}:{n}")
        keys.update(f"{rel}:{n}({p})" for p in params.get(n, ()))
        for m in methods.get(n, ()):
            if m != "__init__":
                keys.add(f"{rel}:{n}.{m}")
            keys.update(f"{rel}:{n}.{m}({p})"
                        for p in params[f"{n}.{m}"])
    return keys


def _signature(obj):
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None


def unmatched(rel: pathlib.Path) -> List[str]:
    """The keys of one reference module that the port does not carry."""
    try:
        mod = importlib.import_module(_module_name(rel))
    except ImportError:
        return [f"{rel}"]
    names, methods, params = reference_surface(rel)
    out = []
    for n in sorted(names):
        if not hasattr(mod, n):
            out.append(f"{rel}:{n}")
            continue
        obj = getattr(mod, n)
        if n in params:
            sig = _signature(obj)
            out += [f"{rel}:{n}({p})" for p in params[n]
                    if sig is not None and p not in sig]
        for m in methods.get(n, ()):
            if not hasattr(obj, m):
                out.append(f"{rel}:{n}.{m}")
                continue
            if isinstance(inspect.getattr_static(obj, m), property):
                continue
            sig = _signature(getattr(obj, m))
            out += [f"{rel}:{n}.{m}({p})" for p in params[f"{n}.{m}"]
                    if sig is not None and p not in sig]
    return out


MODULES = sorted(p.relative_to(REF) for p in REF.rglob("*.py"))
PACKAGES = sorted({m.parts[0] if len(m.parts) > 1 else "." for m in MODULES})


def _in_package(pkg: str) -> List[pathlib.Path]:
    return [m for m in MODULES
            if (m.parts[0] if len(m.parts) > 1 else ".") == pkg]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_reference_name_has_a_port_counterpart(pkg):
    missing = [k for rel in _in_package(pkg) for k in unmatched(rel)
               if k not in JAX_ONLY]
    assert not missing, ("reference names the port neither carries nor "
                         f"maps in JAX_ONLY: {missing}")


def test_every_map_entry_is_a_live_jax_idiom():
    every = set().union(*(surface_keys(rel) for rel in MODULES))
    gone = sorted(k for k in JAX_ONLY if k not in every)
    assert not gone, f"JAX_ONLY names what the reference no longer has: {gone}"
    still = set().union(*(unmatched(rel) for rel in MODULES))
    ported = sorted(k for k in JAX_ONLY if k not in still)
    assert not ported, f"JAX_ONLY maps names the port now carries: {ported}"
    for k, why in JAX_ONLY.items():
        assert why.strip() and "\n" not in why, k
        assert not any(w in k for w in NOT_IDIOMS), (
            f"{k} is behaviour to port, not a jax idiom")


def test_the_scan_sees_the_surface_it_claims_to():
    """A scan that found nothing would pass every case above: hold it to
    names it must see, matched and unmatched."""
    keys = surface_keys(pathlib.Path("serve/service.py"))
    assert {"serve/service.py:ShardedAllocationService.__init__(mesh)",
            "serve/service.py:AllocationService.allocate_params_priced",
            "serve/service.py:AllocationResult"} <= keys
    assert "core/allocator.py:choose_tokens_jnp" in \
        unmatched(pathlib.Path("core/allocator.py"))
    assert unmatched(pathlib.Path("api/_compat.py")) == []
    assert len(MODULES) >= 80 and sum(len(surface_keys(r))
                                      for r in MODULES) > 1500
