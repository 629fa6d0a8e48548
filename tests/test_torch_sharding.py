"""The port's sharding half against the reference's, without a process
group (a torch ``DeviceMesh`` built without its backend stands for the
reference's ``jax.sharding.AbstractMesh``):

* ``plan_for``'s table and notes equal the reference's for the ten
  architectures x four shape kinds on the (2, 2), (2, 4), (16, 16) and
  (2, 16, 16) meshes, and with ``MOE_GROUPS`` set for the MoE archs;
* ``Model.param_specs()`` and ``cache_logical_specs()`` equal the
  reference's for every full and reduced config, and build no
  parameter (the model lives on the ``meta`` device);
* ``ShardingRules`` turns a spec into DTensor placements: a tuple of
  mesh axes shards one dimension over both, a mesh axis may shard one
  dimension only, ``tree_shardings`` keeps the tree.
"""
import dataclasses

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import all_arch_names, get_config, get_reduced
from repro_torch.models import flags
from repro_torch.models.model import make_model
from repro_torch.sharding.rules import make_rules
from repro_torch.sharding.strategy import plan_for

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
KINDS = ("train", "prefill", "decode", "long_decode")
MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")


def torch_mesh(name):
    """A device-free DeviceMesh: names and sizes, no process group."""
    shape, axes = MESHES[name]
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes, _init_backend=False, _rank=0)


def jax_mesh(name):
    from jax.sharding import AbstractMesh
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _plans(arch, kind, mesh, groups=None):
    from repro.configs import get_config as j_get_config
    from repro.models import flags as j_flags
    from repro.sharding.strategy import plan_for as j_plan_for
    saved = flags.MOE_GROUPS, j_flags.MOE_GROUPS
    flags.MOE_GROUPS = j_flags.MOE_GROUPS = groups
    try:
        return (plan_for(get_config(arch), kind, torch_mesh(mesh)),
                j_plan_for(j_get_config(arch), kind, jax_mesh(mesh)))
    finally:
        flags.MOE_GROUPS, j_flags.MOE_GROUPS = saved


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", all_arch_names())
def test_plan_for_equals_the_reference(arch, kind, mesh):
    plan, ref = _plans(arch, kind, mesh)
    assert plan.rules.table == ref.rules.table
    assert plan.notes == ref.notes
    assert plan.rules.mesh.mesh_dim_names == MESHES[mesh][1]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_plan_for_with_moe_groups_equals_the_reference(arch, mesh):
    plan, ref = _plans(arch, "train", mesh, groups=2)
    assert plan.rules.table == ref.rules.table
    assert plan.notes == ref.notes
    assert any("per-group capacity" in n for n in plan.notes)


def test_plan_without_a_mesh_is_unsharded():
    plan = plan_for(get_reduced("yi-6b"), "train", None)
    assert plan.rules.mesh is None and plan.notes == ("unsharded (no mesh)",)


def _configs():
    return [(a, r) for a in all_arch_names() for r in (False, True)]


def _specs_pair(arch, reduced):
    from repro.configs import get_config as j_get_config
    from repro.configs import get_reduced as j_get_reduced
    from repro.models.model import make_model as j_make_model
    cfg = get_reduced(arch) if reduced else get_config(arch)
    jcfg = j_get_reduced(arch) if reduced else j_get_config(arch)
    return make_model(cfg, device="meta"), j_make_model(jcfg)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not all(
            a is None or isinstance(a, str) for a in tree):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,reduced", _configs())
def test_param_specs_equal_the_reference(arch, reduced):
    model, jmodel = _specs_pair(arch, reduced)
    specs = model.param_specs()
    assert specs == jmodel.param_specs()
    assert all(isinstance(s, tuple) and all(a is None or isinstance(a, str)
                                            for a in s)
               for s in _leaves(specs))


@pytest.mark.parametrize("arch,reduced", _configs())
def test_cache_logical_specs_equal_the_reference(arch, reduced):
    model, jmodel = _specs_pair(arch, reduced)
    assert model.cache_logical_specs() == jmodel.cache_logical_specs()


def test_rules_place_tensor_dims_on_mesh_axes():
    rules = make_rules(torch_mesh("2x16x16"))
    assert rules.spec("batch", "d_model", "heads") == (
        ("pod", "data"), ("pod", "data"), "model")
    # batch over pod then data (one dimension, both axes), heads on model
    assert rules.placements("batch", None, "heads") == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements("seq", None) == (Replicate(),) * 3
    assert rules.axis_size(("pod", "data")) == 32
    assert rules.logical_size("heads") == 16
    with pytest.raises(ValueError, match="shards two dimensions"):
        rules.placements("heads", "d_ff")
    mesh, placements = rules.sharding("vocab", "d_model")
    assert mesh is rules.mesh and placements == (Shard(1), Shard(1),
                                                 Shard(0))
    tree = rules.tree_shardings({"a": ("vocab", None), "b": [("batch",)]})
    assert tree["a"][1] == (Replicate(), Replicate(), Shard(0))
    assert tree["b"][0][1] == (Shard(0), Shard(0), Replicate())
    # without a mesh: the one-card rules, specs for shardings
    none = make_rules(None, batch="data")
    assert none.sharding("batch") is None
    assert none.tree_shardings({"a": ("batch",)}) == {"a": ("data",)}
    x = torch.ones(2)
    assert none.shard(x, "batch") is x and none.local(len, (), ()) is len


def test_plan_overrides_reach_the_placements():
    """The (2, 2) train plan of the hybrid model shards its SSM heads over
    'model' and the batch over 'data'."""
    cfg = dataclasses.replace(get_reduced("zamba2-1.2b"))
    rules = plan_for(cfg, "train", torch_mesh("2x2")).rules
    assert rules.placements("batch", "state_heads", "seq", None) == (
        Shard(0), Shard(1))
    assert rules.placements("layers", "d_model", "inner") == (
        Shard(1), Replicate())
