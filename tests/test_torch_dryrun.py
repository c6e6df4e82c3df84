"""The ``launch/`` drivers of the port against the reference's, on the CPU.

* ``inputs.abstract_params`` / ``abstract_cache`` (``meta`` tensors, no
  draw), restacked, have the shapes and dtypes of the reference's
  ``jax.eval_shape`` trees, leaf for leaf, for every arch.
* ``roofline.model_flops``, ``dryrun._planner_estimate`` and the skip rule
  equal the reference's for every arch x shape; ``derive`` equals the
  reference's at the reference's constants (TPU v5e peaks, passed as
  arguments); ``tests/test_roofline_parser.py``'s
  ``test_derive_terms_and_bottleneck``, ``test_model_flops_modes`` and
  ``test_moe_active_params_smaller``, ported.  Its three HLO-parser tests
  have no counterpart: the port has no HLO.
* ``dryrun.lower_cell`` records on the (16, 16) and (2, 16, 16) meshes,
  ``dryrun.main --all --both-meshes`` (a record for every runnable cell,
  the reference's skipped cells skipped), and ``report.main`` rendering a
  directory of records.
"""
import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import base as ref_base
from repro.launch import inputs as ref_inp
from repro.launch import roofline as ref_rl
from repro.models.transformer import Model as RefModel
from repro.sharding.policy import ShardingPolicy as RefPolicy
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.launch import dryrun, report
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Model
from repro_torch.sharding.policy import ShardingPolicy

ARCHS = base.arch_ids()


def _ref_dryrun():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` (512 host
    devices) when imported; the backend is up already, so that touches
    nothing here, and the variable is put back for later subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


def _shapes(tree):
    return {jax.tree_util.keystr(k): (tuple(v[0]), v[1]) for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                and isinstance(x[1], str))[0]}


def _port_shapes(tree, cfg):
    return _shapes(convert.restack(
        tree, cfg, leaf=lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        stack=lambda xs: ((len(xs),) + xs[0][0], xs[0][1])))


def _ref_shapes(tree):
    return _shapes(jax.tree.map(lambda s: (tuple(s.shape), str(np.dtype(s.dtype))), tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_the_references_eval_shape(arch):
    rcfg, cfg = ref_base.get_config(arch), base.get_config(arch)
    rmodel, model = RefModel(rcfg), Model(cfg)
    params = inp.abstract_params(model)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(params))
    assert _port_shapes(params, cfg) == _ref_shapes(ref_inp.abstract_params(rmodel))
    for batch, seq in ((128, 1024), (1, 1024)):
        assert (_port_shapes(inp.abstract_cache(model, batch, seq), cfg)
                == _ref_shapes(ref_inp.abstract_cache(rmodel, batch, seq)))
    for name, shape in base.SHAPES.items():
        rshape = ref_base.SHAPES[name]
        for fn, rfn in ((inp.train_batch_specs, ref_inp.train_batch_specs),
                        (inp.prefill_batch_specs, ref_inp.prefill_batch_specs)):
            got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in fn(cfg, shape).items()}
            want = {k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in
                    rfn(rcfg, rshape).items()}
            assert got == want
        got = [tuple(v.shape) for v in inp.decode_inputs(cfg, shape)]
        assert got == [tuple(v.shape) for v in ref_inp.decode_inputs(rcfg, rshape)]


def _jax_mesh(multi_pod):
    sizes, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                    else ((16, 16), ("data", "model")))
    try:
        return JaxAbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return JaxAbstractMesh(sizes, names)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_planner_and_skips_match_the_reference(arch):
    ref_dryrun = _ref_dryrun()
    rcfg, cfg = ref_base.get_config(arch), base.get_config(arch)
    for multi_pod in (False, True):
        rpol = RefPolicy(_jax_mesh(multi_pod), rcfg)
        pol = ShardingPolicy(make_production_mesh(multi_pod=multi_pod), cfg)
        for name, shape in base.SHAPES.items():
            rshape = ref_base.SHAPES[name]
            assert base.cell_is_runnable(cfg, shape) == ref_base.cell_is_runnable(rcfg, rshape)
            assert rl.model_flops(cfg, shape) == ref_rl.model_flops(rcfg, rshape)
            assert (dryrun._planner_estimate(cfg, shape, pol)
                    == ref_dryrun._planner_estimate(rcfg, rshape, rpol))


def test_derive_matches_the_reference_at_its_constants():
    rng = np.random.default_rng(0)
    peaks = dict(peak_flops=ref_rl.PEAK_FLOPS, hbm_bw=ref_rl.HBM_BW, link_bw=ref_rl.ICI_BW)
    for _ in range(20):
        cost = {"flops": float(rng.uniform(1e12, 1e15)),
                "transcendentals": float(rng.uniform(0, 1e12)),
                "bytes accessed": float(rng.uniform(1e9, 1e12))}
        coll = {"all-reduce": float(rng.uniform(0, 1e11)),
                "all-gather": float(rng.uniform(0, 1e11))}
        mf = float(rng.uniform(1e14, 1e17))
        got = rl.derive(cost, rl.CollectiveStats(coll, {k: 1 for k in coll}),
                        num_devices=256, model_flops_total=mf, **peaks)
        want = ref_rl.derive(cost, ref_rl.CollectiveStats(coll, {k: 1 for k in coll}),
                             num_devices=256, model_flops_total=mf)
        assert got.to_dict() == want.to_dict()


def test_h100_constants_are_the_datasheets():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW, rl.HBM_BYTES) == (989e12, 3.35e12, 450e9,
                                                                  80e9)


# -- tests/test_roofline_parser.py's arithmetic cases, on the port ---------------


def test_derive_terms_and_bottleneck():
    cost = {"flops": 197e12, "transcendentals": 0.0, "bytes accessed": 819e9 * 2}
    st = rl.CollectiveStats({"all-reduce": 50e9 * 0.5}, {"all-reduce": 1})
    roof = rl.derive(cost, st, num_devices=256, model_flops_total=197e12 * 256 * 0.5,
                     peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.memory_s == pytest.approx(2.0)
    assert roof.collective_s == pytest.approx(0.5)
    assert roof.bottleneck == "memory"
    assert roof.useful_flops_ratio == pytest.approx(0.5)


def test_model_flops_modes():
    cfg = base.get_config("llama3-8b")
    tr = rl.model_flops(cfg, base.SHAPES["train_4k"])
    pf = rl.model_flops(cfg, base.SHAPES["prefill_32k"])
    dc = rl.model_flops(cfg, base.SHAPES["decode_32k"])
    n = cfg.active_param_count()
    assert tr == pytest.approx(6 * n * 256 * 4096)
    assert pf == pytest.approx(2 * n * 32 * 32768)
    assert dc == pytest.approx(2 * n * 128)


def test_moe_active_params_smaller():
    cfg = base.get_config("mixtral-8x7b")
    assert cfg.active_param_count() < cfg.param_count()
    ratio = cfg.active_param_count() / cfg.param_count()
    assert 0.2 < ratio < 0.45


def _ref_bytes(tree, specs, sizes, itemsize=None):
    """A card's bytes of a reference tree: each dim over its axes' sizes."""
    from jax.sharding import PartitionSpec as P

    total = 0
    flat = jax.tree_util.tree_flatten(specs, is_leaf=lambda x: isinstance(x, P))[0]
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree), flat):
        n = 1
        for dim, e in zip(leaf.shape, list(spec) + [None] * len(leaf.shape)):
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        total += n * (itemsize or np.dtype(leaf.dtype).itemsize)
    return total


# -- the records --------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_lower_cell_record(multi_pod):
    rec = dryrun.lower_cell("llama3-8b", "train_4k", multi_pod=multi_pod)
    n = 512 if multi_pod else 256
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16") and rec["cards"] == n
    assert not rec["skipped"] and rec["fits_hbm"]
    b = rec["bytes_per_card"]
    cfg, rcfg = base.get_config("llama3-8b"), ref_base.get_config("llama3-8b")
    rparams = ref_inp.abstract_params(RefModel(rcfg))
    rpol = RefPolicy(_jax_mesh(multi_pod), rcfg)
    rspecs = rpol.param_specs(rparams)
    sizes = dict(zip(rpol.mesh.axis_names, (2, 16, 16) if multi_pod else (16, 16)))
    assert b["params"] == _ref_bytes(rparams, rspecs, sizes)
    # m and v (f32, ZeRO-1: a layer's wk / wv whole on its group's data
    # coordinate) and the step
    assert b["opt_state"] == 2 * _ref_bytes(rparams, rpol.opt_state_specs(rspecs, rparams),
                                            sizes, 4) + 4
    assert b["grads"] == b["params"] and b["cache"] == 0
    assert b["opt_state"] < b["params"] / 4
    assert b["total"] == sum(b[k] for k in ("params", "grads", "opt_state", "cache"))
    r = rec["roofline"]
    assert r["compute_s"] == pytest.approx(rl.model_flops(cfg, base.SHAPES["train_4k"])
                                           / n / 989e12)
    assert r["useful_flops_ratio"] == pytest.approx(1.0)
    assert set(rec["analysis"]["collectives"]["bytes_by_kind"]) == {"all-gather",
                                                                    "reduce-scatter"}
    decode = dryrun.lower_cell("rwkv6-7b", "long_500k", multi_pod=multi_pod)
    assert decode["bytes_per_card"]["cache"] > 0 and decode["bytes_per_card"]["grads"] == 0
    assert dryrun.lower_cell("llama3-8b", "long_500k", multi_pod=multi_pod)["skipped"]


def test_dryrun_all_and_report(tmp_path, capsys):
    out = tmp_path / "dry"
    assert dryrun.main(["--all", "--both-meshes", "--out", str(out)]) == 0
    recs = report.load(out)
    assert len(recs) == len(ARCHS) * len(base.SHAPES) * 2
    for (arch, shape, mesh), rec in recs.items():
        runnable, _ = ref_base.cell_is_runnable(ref_base.get_config(arch),
                                                ref_base.SHAPES[shape])
        assert rec["skipped"] is (not runnable), (arch, shape, mesh)
        assert not rec.get("failed")
    rec = json.loads((out / "llama3.2-1b__train_4k__16x16.json").read_text())
    assert rec["model_flops"] == rl.model_flops(base.get_config("llama3.2-1b"),
                                                base.SHAPES["train_4k"])
    capsys.readouterr()
    assert report.main(["--dir", str(out)]) == 0
    text = capsys.readouterr().out
    assert "## Dry-run matrix" in text and "## Roofline" in text and "## Planner" in text
    assert "| llama3-8b | train_4k | fits" in text
    assert "| llama3-8b | long_500k | SKIP | SKIP |" in text
    n_roof = sum(1 for line in report.roofline_table(recs).splitlines()[2:])
    assert n_roof == sum(1 for (a, s, m), r in recs.items() if m == "16x16"
                         and not r["skipped"])
