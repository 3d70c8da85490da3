"""The port's sharding rules against JAX's (``repro.sharding.rules``), leaf
by leaf, for all ten configs at full size on abstract (2, 4), (16, 16)
and (2, 16, 16) meshes: ``param_pspecs`` (with JAX's default rules, with
FSDP off, and with ``expert_fsdp`` off), ``batch_pspec`` and
``cache_pspecs`` (with and without a sequence-sharded KV cache).  The
counterpart of ``test_sharding_data.py``'s spec tests; no process group.
The port's shapes come from its own ``init_params``/``init_cache`` under
``FakeTensorMode`` (nothing is allocated), JAX's from ``eval_shape``.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import compat
from repro import configs as JCFG
from repro.launch.mesh import rules_for_mesh as j_rules_for_mesh
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch import configs as TCFG
from repro_torch.launch.mesh import (abstract_mesh, make_production_mesh,
                                     rules_for_mesh)
from repro_torch.models import model as TM
from repro_torch.sharding import rules as TR
from repro_torch.tree import tree_flatten

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BATCH, CACHE_SEQ = 32, 4096


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(JAX params, JAX caches, port params, port caches) as shapes."""
    jcfg, cfg = JCFG.get_config(arch), TCFG.get_config(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, CACHE_BATCH, CACHE_SEQ))
    with FakeTensorMode():
        tp = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        tc = TM.init_cache(cfg, CACHE_BATCH, CACHE_SEQ, device="cpu")
    return jp, jc, tp, tc


def _jax_specs(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_specs(specs):
    paths, leaves, _ = tree_flatten(specs)
    return {p: tuple(s) for p, s in zip(paths, leaves)}


def _meshes(name):
    shape, axes = MESHES[name]
    return compat.abstract_mesh(shape, axes), abstract_mesh(shape, axes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_param_and_cache_specs_equal_jax(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jp, jc, tp, tc = _shapes(arch)
    for kw in ({}, {"fsdp": False}):
        jrules, rules = j_rules_for_mesh(jmesh, **kw), rules_for_mesh(
            mesh, **kw)
        for expert_fsdp in (True, False):
            jr = JR.ShardingRules(**{**jrules.__dict__,
                                     "expert_fsdp": expert_fsdp})
            tr = TR.ShardingRules(**{**rules.__dict__,
                                     "expert_fsdp": expert_fsdp})
            want = _jax_specs(JR.param_pspecs(jp, jmesh, jr))
            assert _port_specs(TR.param_pspecs(tp, mesh, tr)) == want
    cfg = JCFG.get_config(arch)
    for kv_seq in ((), ("data",)):
        jr = j_rules_for_mesh(jmesh, kv_seq=kv_seq)
        tr = rules_for_mesh(mesh, kv_seq=kv_seq)
        for batch in (CACHE_BATCH, 1):
            want = _jax_specs(JR.cache_pspecs(cfg, jmesh, jr, batch, jc))
            got = _port_specs(TR.cache_pspecs(TCFG.get_config(arch), mesh,
                                              tr, batch, tc))
            assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspec_equals_jax(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jr, tr = j_rules_for_mesh(jmesh), rules_for_mesh(mesh)
    for ndim in (2, 3):
        for batch in (1, 2, 3, 8, 16, 32, 48, 512, 1024):
            assert tuple(TR.batch_pspec(mesh, tr, ndim, batch)) == tuple(
                JR.batch_pspec(jmesh, jr, ndim, batch))


def test_production_meshes_and_rules_are_jax_defaults():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    rules = rules_for_mesh(pod)
    assert (rules.batch, rules.model, rules.fsdp, rules.expert_fsdp) == (
        ("pod", "data"), "model", ("data",), True)
    assert rules_for_mesh(make_production_mesh(), fsdp=False).fsdp == ()


@pytest.mark.parametrize("rank", [0, 5, 17, 511])
def test_rank_coordinates_are_row_major(rank):
    """Rank r sits where ``jax.make_mesh`` puts device r: row-major over
    the axes; a tuple of axes indexes its blocks row-major too."""
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"), rank)
    c = mesh.coords
    assert c == {"pod": rank // 256, "data": rank // 16 % 16,
                 "model": rank % 16}
    assert mesh.axis_index(("pod", "data")) == rank // 16
    assert mesh.axis_size(("pod", "data")) == 32
    with pytest.raises(ValueError):
        mesh.axis_index(("data", "pod"))


def test_shard_leaf_cuts_the_spec_blocks():
    x = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    spec = TR.P("data", "model")
    blocks = [[TR.shard_leaf(x, spec, abstract_mesh(
        (2, 3), ("data", "model"), 3 * d + m)) for m in range(3)]
        for d in range(2)]
    assert blocks[0][0].shape == (2, 2, 2)
    assert torch.equal(torch.cat([torch.cat(row, 1) for row in blocks], 0),
                       x)
    whole = TR.shard_leaf(x, TR.P(), abstract_mesh((2, 3),
                                                   ("data", "model")))
    assert torch.equal(whole, x)
    assert tuple(TR.P(("data",), None)) == ("data", None)
