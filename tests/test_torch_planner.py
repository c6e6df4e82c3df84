"""The port's IR, fusion, planner and segment partition against the reference.

The port keeps framework-free copies of ``repro.core.graph``/``fusion``/
``planner``/``segments``; these tests hold the copies to the reference on
the paper's two networks: plan bytes **and** every buffer assignment
(name, kind, size, offset, bank, live range) equal exactly.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import pytest

from repro.core import fusion as ref_fusion
from repro.core import graph as ref_graph
from repro.core import planner as ref_planner
from repro.core import segments as ref_segments
from repro_torch.core import fusion, graph, planner, segments


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


PLANS = [
    # (net, plan builder, kwargs, activation bytes the paper prints)
    ("lenet5", "plan_naive", {}, 36472),
    ("lenet5", "plan_fused", {}, 11256),
    ("lenet5", "plan_pingpong", {}, 8800),
    ("lenet5", "plan_optimal_arena", {}, None),
    ("lenet5", "plan_pingpong", {"io_dtype_bytes": 1}, 2200),
    ("cifar_testnet", "plan_pingpong", {"io_dtype_bytes": 1}, 11264),
    ("cifar_testnet", "plan_cmsis_baseline", {"io_dtype_bytes": 1}, 44160),
    ("cifar_testnet", "plan_naive", {"io_dtype_bytes": 1}, None),
    ("cifar_testnet", "plan_fused", {"io_dtype_bytes": 1}, None),
    ("cifar_testnet", "plan_optimal_arena", {"io_dtype_bytes": 1}, None),
]


@pytest.mark.parametrize("net,builder,kw,paper_bytes", PLANS)
def test_plans_equal_reference_bytes_and_offsets(net, builder, kw, paper_bytes):
    ours = getattr(planner, builder)(getattr(graph, net)(), **kw)
    ref = getattr(ref_planner, builder)(getattr(ref_graph, net)(), **kw)
    assert _plan_fields(ours) == _plan_fields(ref)
    if builder != "plan_cmsis_baseline":
        # The baseline prices max1 + max2 but lists every buffer at its own
        # offset, as the reference does: it is not a packing to verify.
        planner.verify_plan(ours)
    if paper_bytes is not None:
        assert ours.activation_bytes() == paper_bytes


def test_pingpong_banks_lenet5():
    """Bank A at offset 0, bank B at size(A) = 1024 elements."""
    plan = planner.plan_pingpong(graph.lenet5())
    assert [(b.bank, b.offset_elems) for b in plan.buffers] == [
        ("A", 0), ("B", 1024), ("A", 0), ("B", 1024), ("A", 0), ("B", 1024)]
    assert plan.arena_elems == 2200 and planner.paper_pingpong_bound(graph.lenet5()) == 2200


@pytest.mark.parametrize("net", ["lenet5", "cifar_testnet"])
def test_fusion_and_graph_match_reference(net):
    ours = fusion.fuse(getattr(graph, net)())
    ref = ref_fusion.fuse(getattr(ref_graph, net)())
    assert [(l.kind, l.name) for l in ours.layers] == [(l.kind, l.name) for l in ref.layers]
    assert ours.shapes() == ref.shapes()
    assert ours.buffer_sizes() == ref.buffer_sizes()
    assert ours.param_count() == ref.param_count()
    assert ours.weight_count() == ref.weight_count()
    for a, b in zip(ours.layers, ref.layers):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("net", ["lenet5", "cifar_testnet"])
def test_segments_and_steps_match_reference(net):
    ours = fusion.fuse(getattr(graph, net)())
    ref = ref_fusion.fuse(getattr(ref_graph, net)())
    assert segments.sequential_segments(ours) == tuple(
        segments.Segment(s.start, s.kind, s.branches, s.period)
        for s in ref_segments.sequential_segments(ref))
    assert segments.segment_stats(segments.sequential_segments(ours)) == \
        ref_segments.segment_stats(ref_segments.sequential_segments(ref))
    pre, steps = planner.materialized_steps(ours)
    rpre, rsteps = ref_planner.materialized_steps(ref)
    assert [(s[0].name, [v.kind for v in s[1]], s[2], s[3]) for s in steps] == \
        [(s[0].name, [v.kind for v in s[1]], s[2], s[3]) for s in rsteps]
    assert len(pre) == len(rpre)


def test_stacked_run_segments_match_reference():
    """A homogeneous run of identical blocks stacks the same way in both."""
    def net(g):
        layers = [g.Input(shape=(16,), name="input")]
        for i in range(4):
            layers += [g.Linear(16, 16, name=f"fc{i}"), g.ReLU(name=f"r{i}")]
        layers += [g.Linear(16, 4, name="head")]
        return g.SequentialGraph(layers)

    ours = segments.sequential_segments(net(graph))
    ref = ref_segments.sequential_segments(net(ref_graph))
    assert [(s.start, s.kind, s.branches, s.length) for s in ours] == \
        [(s.start, s.kind, s.branches, s.length) for s in ref]
    assert segments.segment_stats(ours)["stacked_layers"] == 4


def test_cache_fifo_bounded_eviction():
    store, built = {}, []

    def build(k):
        return lambda: built.append(k) or k

    assert segments.cache_fifo(store, "a", 2, build("a")) == "a"
    assert segments.cache_fifo(store, "b", 2, build("b")) == "b"
    assert segments.cache_fifo(store, "a", 2, build("a2")) == "a"
    assert segments.cache_fifo(store, "c", 2, build("c")) == "c"
    assert set(store) == {"b", "c"}
    assert built == ["a", "b", "c"]
