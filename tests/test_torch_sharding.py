"""The port's sharding rules against the reference's, with no process
group: a mesh here is its axis names and shape (what the rule functions
read), the reference's an ``AbstractMesh`` of the same shape (no devices;
nothing is lowered).

* ``logical_to_spec`` and ``filter_rules_for_mesh`` equal the reference's
  on random logical axes and rule tables (hypothesis);
* every architecture's parameter specs at 16x16 and 2x16x16, baseline and
  ``optimized=True`` (with the multi-pod overlay), equal the reference's
  ``param_shardings(...).spec``, and their placements say the same;
* ``batch_shardings`` equal the reference's for every cell;
* the ``Sharder`` replicates an indivisible dim and never shards one
  unevenly.
"""
import types

import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Replicate, Shard

import jax
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs.base import DEFAULT_RULES as REF_RULES
from repro.models import model_api as rapi
from repro.models import params as rparams
from repro.train import steps as rsteps
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import DEFAULT_RULES, LOGICAL_AXES
from repro_torch.models import model_api
from repro_torch.models import params as pparams
from repro_torch.models.lm import Cache
from repro_torch.train import steps as psteps

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return (types.SimpleNamespace(mesh_dim_names=axes,
                                  mesh=torch.empty(shape, device="meta")),
            AbstractMesh(shape, axes))


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


axis_names = st.sampled_from(list(LOGICAL_AXES) + [None, "embed_param"])
mesh_axes = st.lists(st.sampled_from(["pod", "data", "model"]), max_size=3,
                     unique=True)
rule_value = st.one_of(st.none(), st.sampled_from(["pod", "data", "model"]),
                       mesh_axes.map(tuple))


@given(st.lists(axis_names, min_size=1, max_size=6),
       st.dictionaries(st.sampled_from(list(LOGICAL_AXES)), rule_value))
@settings(max_examples=200, deadline=None)
def test_logical_to_spec_is_the_references(axes, overrides):
    rules = dict(DEFAULT_RULES, **overrides)
    got = pparams.logical_to_spec(tuple(axes), rules)
    assert got == tuple(rparams.logical_to_spec(tuple(axes), rules))


@given(st.dictionaries(st.sampled_from(list(LOGICAL_AXES)), rule_value),
       st.sampled_from(sorted(MESHES)))
@settings(max_examples=100, deadline=None)
def test_filter_rules_for_mesh_is_the_references(overrides, mesh_name):
    rules = dict(DEFAULT_RULES, pad_kv_cache=True, **overrides)
    port, ref = _meshes(mesh_name)
    assert (pparams.filter_rules_for_mesh(rules, port)
            == rparams.filter_rules_for_mesh(rules, ref))


def _placements_of(spec, axes):
    out = [Replicate()] * len(axes)
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            out[axes.index(name)] = Shard(d)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_are_the_references(arch, optimized, mesh_name):
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)
    multi_pod = mesh_name == "2x16x16"
    port, ref = _meshes(mesh_name)
    cfg = get_config(arch, optimized=optimized, multi_pod=multi_pod)
    rcfg = ref_get_config(arch, optimized=optimized, multi_pod=multi_pod)
    want = [tuple(s.spec) for s in jax.tree.leaves(
        rapi.shardings(rcfg, ref),
        is_leaf=lambda x: isinstance(x, NamedSharding))]
    want = [w + (None,) * (n - len(w)) for w, n in zip(
        want, [len(s.shape) for s in jax.tree.leaves(rapi.specs(rcfg))])]
    specs = _tree_leaves(pparams.param_specs(model_api.schema(cfg), port,
                                             cfg.rules()))
    assert specs == want
    placements = _tree_leaves(model_api.shardings(cfg, port))
    assert placements == [_placements_of(s, MESHES[mesh_name][1])
                          for s in want]
    assert any(any(isinstance(q, Shard) for q in p) for p in placements)


def _batch_leaves(tree):
    if isinstance(tree, Cache):
        return [x for f in ("k", "v", "ssm", "shared_k", "shared_v", "length")
                if (x := getattr(tree, f)) is not None]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _batch_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_are_the_references(arch, mesh_name):
    multi_pod = mesh_name == "2x16x16"
    port, ref = _meshes(mesh_name)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in SHAPES.values():
        rshape = REF_SHAPES[shape.name]
        got = _batch_leaves(psteps.batch_shardings(cfg, shape, port))
        sh = rsteps.batch_shardings(rcfg, rshape, ref)
        want = [tuple(s.spec) for s in jax.tree.leaves(
            sh, is_leaf=lambda x: isinstance(x, NamedSharding))]
        specs = _batch_leaves(model_api.input_specs(cfg, shape))
        want = [_placements_of(w + (None,) * (t.ndim - len(w)),
                               MESHES[mesh_name][1])
                for w, t in zip(want, specs)]
        # the reference's Cache flattens k, v, ssm, shared_k, shared_v,
        # length: the port's dataclass lists the same fields in that order
        assert got == want, (arch, shape.name)
        assert multi_pod or all(len(p) == 2 for p in got)


@given(st.lists(st.integers(1, 48), min_size=1, max_size=4),
       st.lists(axis_names, min_size=4, max_size=4),
       st.sampled_from(sorted(MESHES)))
@settings(max_examples=200, deadline=None)
def test_sharder_never_shards_a_dim_unevenly(shape, axes, mesh_name):
    """Every dim a placement shards divides by the product of its mesh
    dims; an indivisible one is replicated, as the reference's Sharder
    does, and never raises."""
    port, _ = _meshes(mesh_name)
    sizes = dict(zip(*reversed(MESHES[mesh_name])))
    sharder = pparams.Sharder(port, DEFAULT_RULES)
    axes = axes[:len(shape)]
    pl = sharder.placements(shape, *axes)
    per_dim = {}
    for name, q in zip(MESHES[mesh_name][1], pl):
        if isinstance(q, Shard):
            per_dim[q.dim] = per_dim.get(q.dim, 1) * sizes[name]
    for d, n in per_dim.items():
        assert shape[d] % n == 0, (shape, axes, pl)
    spec = pparams.fit_spec(shape, pparams.logical_to_spec(
        axes, sharder.rules), port)
    assert pl == pparams.spec_to_placements(spec, port)


def test_sharder_falls_back_on_indivisible_dims():
    """whisper's 12 heads stay off a 16-way model axis; 64 heads shard."""
    port, _ = _meshes("16x16")
    sharder = pparams.Sharder(port, DEFAULT_RULES)
    assert sharder.placements((32, 8, 12, 64), "batch", None, "heads",
                              None) == (Shard(0), Replicate())
    assert sharder.placements((32, 8, 64, 64), "batch", None, "heads",
                              None) == (Shard(0), Shard(2))
    assert sharder.placements((1, 8, 64, 64), "batch", None, "heads",
                              None) == (Replicate(), Shard(2))
    x = torch.ones(3, 5)
    assert pparams.NULL_SHARDER(x, "batch", "heads") is x


def test_pod_and_data_shard_one_dim_pod_major():
    """("pod", "data") on one dim: Shard of that dim on both mesh dims,
    which DTensor splits in mesh-dim order, pod outermost, as the
    partition spec means."""
    port, _ = _meshes("2x16x16")
    rules = pparams.filter_rules_for_mesh(DEFAULT_RULES, port)
    spec = pparams.logical_to_spec(("batch", None), rules)
    assert spec == (("pod", "data"), None)
    assert pparams.spec_to_placements(spec, port) == (Shard(0), Shard(0),
                                                      Replicate())
    assert REF_RULES == DEFAULT_RULES
