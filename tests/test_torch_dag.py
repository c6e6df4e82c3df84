"""The port's DAG planner, segment partition and DAG quantization against the
reference, on the CPU.

The port keeps framework-free copies of ``repro.core.schedule`` and of the
DAG half of ``repro.core.segments``.  On the four DAG workloads, in f32 and
int8, these tests hold:

* ``plan_dag``: the arena bytes of the reference (the table below) **and**
  every buffer assignment (name, kind, size, offset, bank, live range), so
  the schedule order is equal too;
* the fused graph the plan was made from, its materialized steps, and the
  ``segments_for_plan`` partition with its ``segment_stats``;
* ``quantize_dag``: the port's own calibration on the same weights and
  batch gives the reference's scales (rtol 1e-5), joins included.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as ref_graph
from repro.core import nn as ref_nn
from repro.core import quantize as ref_quantize
from repro.core import schedule as ref_schedule
from repro.core import segments as ref_segments
from repro_torch import convert
from repro_torch.core import graph, nn, quantize, schedule, segments

NETS = ["ds_cnn_kws", "ds_cnn", "mobilenet_v1", "residual_cifar"]
# Arena bytes of the reference's plan_dag (f32, int8).
ARENA_BYTES = {
    "ds_cnn_kws": (64000, 16000),
    "ds_cnn": (64000, 16000),
    "mobilenet_v1": (98304, 24576),
    "residual_cifar": (32768, 8192),
}


def _plan_fields(plan):
    return (
        plan.strategy,
        tuple(dataclasses.astuple(b) for b in plan.buffers),
        plan.arena_elems,
        plan.scratch_elems,
        plan.param_elems,
        plan.io_dtype_bytes,
        plan.activation_bytes(),
        plan.arena_bytes,
    )


@pytest.mark.parametrize("io", [4, 1])
@pytest.mark.parametrize("net", NETS)
def test_plan_dag_equals_reference_bytes_and_offsets(net, io):
    ours = schedule.plan_dag(getattr(graph, net)(), io_dtype_bytes=io)
    ref = ref_schedule.plan_dag(getattr(ref_graph, net)(), io_dtype_bytes=io)
    assert _plan_fields(ours) == _plan_fields(ref)
    assert ours.arena_bytes == ARENA_BYTES[net][io == 1]
    # every step writes a buffer disjoint from each of its inputs, so the
    # executor can write in place
    mat, order = schedule.check_dag_plan(schedule.fuse_dag_priced(getattr(graph, net)()),
                                         ours)
    bufs = {b.name: b for b in ours.buffers}
    for s in mat.steps:
        o = bufs[s.name]
        for src in s.inputs:
            i = bufs[src]
            assert (o.offset_elems >= i.offset_elems + i.size_elems
                    or i.offset_elems >= o.offset_elems + o.size_elems)


def _steps(mat):
    return [(s.name, s.layer.kind, tuple(v.kind for v in s.views), s.inputs,
             s.in_shapes, s.out_shape, s.size_elems, s.scratch_elems)
            for s in mat.steps]


@pytest.mark.parametrize("net", NETS)
def test_materialized_steps_and_segments_equal_reference(net):
    g, g_ref = getattr(graph, net)(), getattr(ref_graph, net)()
    fused = schedule.fuse_dag_priced(g)
    fused_ref = ref_schedule.fuse_dag_priced(g_ref)
    assert [(n.name, n.inputs, n.layer.kind) for n in fused.nodes] == \
        [(n.name, n.inputs, n.layer.kind) for n in fused_ref.nodes]
    mat, mat_ref = schedule.materialize_dag(fused), ref_schedule.materialize_dag(fused_ref)
    assert _steps(mat) == _steps(mat_ref)
    assert schedule.search_order(mat) == ref_schedule.search_order(mat_ref)
    assert schedule.naive_order(mat) == ref_schedule.naive_order(mat_ref)
    for io in (4, 1):
        plan = schedule.plan_dag(g, io_dtype_bytes=io)
        plan_ref = ref_schedule.plan_dag(g_ref, io_dtype_bytes=io)
        _, order, segs = segments.segments_for_plan(fused, plan)
        _, order_ref, segs_ref = ref_segments.segments_for_plan(fused_ref, plan_ref)
        assert order == order_ref
        assert [dataclasses.astuple(s) for s in segs] == \
            [dataclasses.astuple(s) for s in segs_ref]
        assert segments.segment_stats(segs) == ref_segments.segment_stats(segs_ref)
        for batch in (True, False):
            ours = segments.compile_segments(mat, order, batch_branches=batch)
            ref = ref_segments.compile_segments(mat_ref, order_ref, batch_branches=batch)
            assert [dataclasses.astuple(s) for s in ours] == \
                [dataclasses.astuple(s) for s in ref]


def test_residual_segments_batch_the_isomorphic_towers():
    g = graph.residual_cifar()
    _, _, segs = segments.segments_for_plan(schedule.fuse_dag_priced(g),
                                            schedule.plan_dag(g))
    stats = segments.segment_stats(segs)
    assert stats["batched_branches"] == 2 and stats["stacked_layers"] == 4


def test_check_dag_plan_rejects_a_graph_fused_otherwise():
    g = graph.ds_cnn_kws()
    plan = schedule.plan_dag(g)
    with pytest.raises(ValueError, match="materialized steps"):
        schedule.check_dag_plan(g, plan)  # unfused graph
    with pytest.raises(TypeError):
        schedule.check_dag_plan(graph.lenet5(), plan)


@pytest.mark.parametrize("net,seed", [("ds_cnn_kws", 0), ("mobilenet_v1", 1),
                                      ("residual_cifar", 2)])
def test_quantize_dag_matches_reference_scales(net, seed):
    fused_ref = ref_schedule.fuse_dag_priced(getattr(ref_graph, net)())
    p_ref = ref_nn.init_params(fused_ref, jax.random.PRNGKey(seed))
    fused = schedule.fuse_dag_priced(getattr(graph, net)())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, p_ref), device="cpu")
    in_shape = fused.nodes[0].layer.shape
    calib = np.random.default_rng(seed).standard_normal((4, *in_shape)).astype(np.float32)
    qm = quantize.quantize_dag(fused, params, torch.from_numpy(calib))
    qm_ref = ref_quantize.quantize_dag(fused_ref, p_ref, jnp.asarray(calib))
    np.testing.assert_allclose(qm.input_scale, qm_ref.input_scale, rtol=1e-5)
    assert qm.layers.keys() == qm_ref.layers.keys()
    assert qm.joins.keys() == qm_ref.joins.keys()
    for name, q in qm.layers.items():
        r = qm_ref.layers[name]
        assert q.per_channel == r.per_channel
        for field in ("w_scale", "in_scale", "out_scale"):
            np.testing.assert_allclose(getattr(q, field), getattr(r, field), rtol=1e-5)
        np.testing.assert_array_equal(q.w_q, r.w_q)
    for name, j in qm.joins.items():
        np.testing.assert_allclose(j.multipliers, qm_ref.joins[name].multipliers,
                                   rtol=1e-5)
    # and the reference's model carried across keeps every field exactly
    qm2 = convert.quantized_from_numpy(fused, qm_ref.input_scale, qm_ref.layers,
                                       qm_ref.joins)
    for name, q in qm2.layers.items():
        r = qm_ref.layers[name]
        np.testing.assert_array_equal(np.asarray(q.multiplier, np.float32),
                                      np.asarray(r.multiplier, np.float32))
    for name, j in qm2.joins.items():
        assert j.multipliers == qm_ref.joins[name].multipliers


def test_init_params_takes_a_dag():
    fused = schedule.fuse_dag_priced(graph.mobilenet_v1())
    p = nn.init_params(fused, torch.Generator().manual_seed(0), device="cpu")
    assert tuple(p["dw2"]["w"].shape) == (16, 1, 3, 3)
    assert tuple(p["pw13+pool"]["w"].shape) == (256, 256, 1, 1)
    assert sum(v.numel() for q in p.values() for v in q.values()) == fused.param_count()
