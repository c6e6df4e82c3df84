"""The port's ``ShardingPolicy`` against the reference's, on abstract meshes.

For every arch of the registry on the (16, 16), (2, 16, 16) and (4, 2)
meshes (no devices; the reference's ``AbstractMesh``):

* ``param_specs`` and ``opt_state_specs`` (ZeRO-1), restacked into the
  reference's group-stacked layout (``convert.restack``), equal the
  reference's ``PartitionSpec``s entry for entry; so do ``cache_specs`` at
  (batch 128, 1,024) and (1, 1,024), and ``batch_specs`` for each shape.
  (jax writes a one-axis tuple entry ``("data",)`` as ``"data"``; both
  sides are compared in that form.)
* The bytes every mesh coordinate holds of the params and of the AdamW
  moments equal the reference's: its shard shapes from its specs (each dim
  divided by the product of its axes' sizes), summed over its leaves.
  That includes the moments the reference splits on the group axis
  (Llama-3-8B on (16, 16)), which the port keeps as whole layers on the
  data coordinate that owns their group.
* The seven cases of ``tests/test_sharding_policy.py``, by name, on the
  port's per-layer tree.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import base as ref_base
from repro.launch import inputs as ref_inp
from repro.models.transformer import Model as RefModel
from repro.sharding.policy import ShardingPolicy as RefPolicy
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models.transformer import Model
from repro_torch.sharding.placement import NamedSharding
from repro_torch.sharding.policy import ShardingPolicy, is_spec
from repro_torch.tree import leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
ARCHS = base.arch_ids()


def _jax_mesh(sizes, names):
    try:
        return JaxAbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return JaxAbstractMesh(sizes, names)


def _norm(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    rcfg, cfg = ref_base.get_config(arch), base.get_config(arch)
    rparams = jax.eval_shape(lambda: RefModel(rcfg).init_params(jax.random.PRNGKey(0)))
    return rcfg, cfg, rparams, inp.abstract_params(Model(cfg))


def _policies(arch, mesh):
    sizes, names = MESHES[mesh]
    rcfg, cfg, rparams, params = _abstract(arch)
    return (RefPolicy(_jax_mesh(sizes, names), rcfg), ShardingPolicy(AbstractMesh(sizes, names),
                                                                       cfg))


def _stack_specs(specs):
    """One stacked spec from a layer leaf's specs over the groups: the
    group entry, then the per-layer entries (equal in every group)."""
    first = specs[0]
    assert all(tuple(s) == tuple(first) and s.group[0] == first.group[0] for s in specs)
    assert [s.group[1] for s in specs] == list(range(len(specs)))
    return (first.group[0],) + tuple(first)


def _restacked(specs, cfg):
    return convert.restack(specs, cfg, stack=_stack_specs)


def _flat_ref(tree):
    return {jax.tree_util.keystr(k): _norm(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _flat_port(tree):
    return {jax.tree_util.keystr(k): _norm(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


def _assert_specs_equal(port_restacked, ref):
    got, want = _flat_port(port_restacked), _flat_ref(ref)
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_the_reference(arch, mesh):
    rpol, pol = _policies(arch, mesh)
    rcfg, cfg, rparams, params = _abstract(arch)
    rspecs, specs = rpol.param_specs(rparams), pol.param_specs(params)
    _assert_specs_equal(_restacked(specs, cfg), rspecs)
    _assert_specs_equal(_restacked(pol.opt_state_specs(specs, params), cfg),
                        rpol.opt_state_specs(rspecs, rparams))


def _ref_bytes(tree, specs, mesh_shape, itemsize=None):
    total = 0
    flat = jax.tree_util.tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree), flat):
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        shard = 1
        for dim, e in zip(leaf.shape, parts):
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            div = int(np.prod([mesh_shape[a] for a in axes])) if axes else 1
            assert dim % div == 0
            shard *= dim // div
        total += shard * (itemsize or np.dtype(leaf.dtype).itemsize)
    return total


def _port_bytes(tree, specs, mesh, itemsize=None):
    total = 0
    for leaf, spec in zip(leaves(tree), leaves(specs, is_leaf=is_spec)):
        total = total + NamedSharding(mesh, spec).bytes_per_coordinate(
            tuple(leaf.shape), itemsize or leaf.element_size())
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_per_card_match_the_reference(arch, mesh):
    """Every coordinate holds the reference's bytes of the params and of
    the f32 moments (each moment's: m and v alike)."""
    rpol, pol = _policies(arch, mesh)
    rcfg, cfg, rparams, params = _abstract(arch)
    rspecs, specs = rpol.param_specs(rparams), pol.param_specs(params)
    shape = dict(zip(*reversed(MESHES[mesh])))
    for itemsize, rs, ps in ((None, rspecs, specs),
                             (4, rpol.opt_state_specs(rspecs, rparams),
                              pol.opt_state_specs(specs, params))):
        want = _ref_bytes(rparams, rs, shape, itemsize)
        got = _port_bytes(params, ps, pol.mesh, itemsize)
        assert got.shape == MESHES[mesh][0]
        assert (got == want).all(), (arch, mesh, got.min(), got.max(), want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh):
    rpol, pol = _policies(arch, mesh)
    rcfg, cfg, _, _ = _abstract(arch)
    for batch in (128, 1):
        rcache = ref_inp.abstract_cache(RefModel(rcfg), batch, 1024)
        cache = inp.abstract_cache(Model(cfg), batch, 1024)
        _assert_specs_equal(_restacked(pol.cache_specs(cache, batch), cfg),
                            rpol.cache_specs(rcache, batch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_the_reference(arch, mesh):
    rpol, pol = _policies(arch, mesh)
    for name in base.SHAPES:
        got = pol.batch_specs(base.SHAPES[name])
        want = rpol.batch_specs(ref_base.SHAPES[name])
        assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}
    assert _norm(pol.activation_spec()) == _norm(rpol.activation_spec())


def test_production_mesh_is_the_references_shape_without_devices():
    for multi_pod, sizes in ((False, (16, 16)), (True, (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.sizes == sizes and getattr(mesh, "devices", None) is None
        assert mesh.size == int(np.prod(sizes))
    assert make_production_mesh(multi_pod=True).axis_names == ("pod", "data", "model")


# -- the reference's seven policy cases, on the port's per-layer tree --------------


def specs_for(arch, mesh_shape=(16, 16)):
    cfg = base.get_config(arch)
    aparams = inp.abstract_params(Model(cfg))
    pol = ShardingPolicy(AbstractMesh(mesh_shape, ("data", "model")), cfg)
    return cfg, pol, aparams, pol.param_specs(aparams)


def test_llama_attention_heads_sharded():
    cfg, pol, ap, specs = specs_for("llama3-8b")
    g = specs["layers"][0]
    assert g["attn"]["wq"] == (None, "model", None)  # 32 q heads / 16
    assert g["attn"]["wk"] == (None, None, None)  # 8 kv heads: replicated
    assert g["attn"]["wo"] == ("model", None, None)
    assert g["ffn"]["wi"] == (None, "model")
    assert g["ffn"]["wo"] == ("model", None)
    assert specs["embed"] == ("model", None)  # 128256 % 16 == 0


def test_gemma3_heads_replicated_gracefully():
    cfg, pol, ap, specs = specs_for("gemma3-1b")
    g = specs["layers"][0]
    assert g["attn"]["wq"] == (None, None, None)  # 4 q heads < 16-way TP
    assert g["ffn"]["wi"] == (None, "model")  # 6912 % 16 == 0


def test_moe_expert_ff_sharded():
    cfg, pol, ap, specs = specs_for("mixtral-8x7b")
    g = specs["layers"][0]
    assert g["ffn"]["wi"] == (None, None, "model")  # (E, d, f)
    assert g["ffn"]["wo"] == (None, "model", None)
    assert g["ffn"]["router"] == (None, None)


def test_rwkv_projections_sharded():
    cfg, pol, ap, specs = specs_for("rwkv6-7b")
    g = specs["layers"][0]
    assert g["tm"]["wr"] == (None, "model")
    assert g["tm"]["wo"] == ("model", None)
    assert g["tm"]["cm_wk"] == (None, "model")


def test_zero1_adds_data_axis():
    cfg, pol, ap, specs = specs_for("llama3-8b")
    ospecs = pol.opt_state_specs(specs, ap)
    assert ospecs["embed"] == ("model", ("data",))  # V on model; ZeRO adds data on D
    # the replicated kv proj gains the data axis on its first divisible dim:
    # the reference's group axis (32 groups), so a layer sits whole on the
    # data coordinate of its group
    wk = ospecs["layers"][5]["attn"]["wk"]
    assert wk == (None, None, None) and wk.group == (("data",), 5, 32)
    # Llama-3.2-1B has 16 groups (< 2 x 16): data falls on a weight dim
    cfg, pol, ap, specs = specs_for("llama3.2-1b")
    wk = pol.opt_state_specs(specs, ap)["layers"][0]["attn"]["wk"]
    assert wk == (("data",), None, None) and wk.group == (None, 0, 16)


def test_cache_specs_kv_heads_vs_seq():
    # seamless kv=16 → heads sharded on model
    cfg, pol, ap, _ = specs_for("seamless-m4t-large-v2")
    cspecs = pol.cache_specs(inp.abstract_cache(Model(cfg), 128, 1024), 128)
    assert cspecs[0]["k"] == (("data",), None, "model", None)
    # llama kv=8 → cache length sharded on model (flash-decoding style)
    cfg2, pol2, ap2, _ = specs_for("llama3-8b")
    cspecs2 = pol2.cache_specs(inp.abstract_cache(Model(cfg2), 128, 1024), 128)
    assert cspecs2[0]["k"] == (("data",), "model", None, None)


def test_batch_specs_seq_parallel_for_batch1():
    cfg = base.get_config("rwkv6-7b")
    pol = ShardingPolicy(AbstractMesh((16, 16), ("data", "model")), cfg)
    bs = pol.batch_specs(base.SHAPES["long_500k"])  # global_batch=1
    assert bs["tokens"] == (None, ("data",))  # sequence parallelism
    bs2 = pol.batch_specs(base.SHAPES["train_4k"])  # batch=256
    assert bs2["tokens"] == (("data",), None)
