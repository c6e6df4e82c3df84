"""The port's compile reports (`repro_torch.obs.report`) against the
reference's, on the CPU.

The static reports read only graphs and plans, so the port's bundles (its
own seeded weights) and the reference's give the same dicts:

* ``segment_report``, ``arena_timeline``, ``streaming_report`` equal dict
  for dict and ``ascii_memory_map`` byte for byte, for the five workloads in
  f32 and int8; the timeline's peak equals the plan's arena bytes;
* the hand-derived 2,539,840 MACs of ``ds_cnn`` and the known arena bytes
  (``tests/test_obs.py``); ``ds_cnn`` int8 compiles a period-2 scan;
* ``build_workload`` handed the reference's weights quantizes them as the
  reference does;
* ``timed_segments`` on LeNet (perf_counter here): one row a segment,
  model shares summing to 1, discrepancies to 0;
* ``DagArenaExecutor`` runs its segments through ``apply_dag_segment``,
  with the same output as the step-by-step walk.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import jax
import numpy as np
import pytest
import torch

from repro.obs import report as ref_report
from repro_torch.core import pingpong, streaming
from repro_torch.obs import report

_BUNDLES = {}


def _bundles(name, int8):
    key = (name, int8)
    if key not in _BUNDLES:
        _BUNDLES[key] = (report.build_workload(name, int8=int8, device="cpu"),
                         ref_report.build_workload(name, int8=int8))
    return _BUNDLES[key]


def _streaming_reports(graph, ref_graph, db):
    from repro.core import streaming as ref_streaming

    try:
        ref = ref_report.streaming_report(
            ref_graph, ref_streaming.plan_streaming(ref_graph, io_dtype_bytes=db))
    except TypeError:  # a branching graph does not stream
        with pytest.raises(TypeError):
            streaming.plan_streaming(graph, io_dtype_bytes=db)
        return None, None
    return report.streaming_report(
        graph, streaming.plan_streaming(graph, io_dtype_bytes=db)), ref


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", report.WORKLOADS)
def test_static_reports_equal_the_reference(name, int8):
    b, rb = _bundles(name, int8)
    assert b["dtype"] == rb["dtype"] and b["in_shape"] == rb["in_shape"]
    seg = report.segment_report(b["graph"], b["plan"])
    assert seg == ref_report.segment_report(rb["graph"], rb["plan"])
    assert sum(s["macs"] for s in seg["segments"]) == seg["total_macs"]
    tl = report.arena_timeline(b["plan"])
    assert tl == ref_report.arena_timeline(rb["plan"])
    assert tl["peak_bytes"] == tl["arena_bytes"] == b["plan"].arena_bytes
    assert len(tl["positions"]) == len(b["plan"].buffers)
    assert tl["positions"][tl["peak_pos"]]["top_bytes"] == tl["peak_bytes"]
    for width in (40, 64):
        assert (report.ascii_memory_map(b["plan"], width=width)
                == ref_report.ascii_memory_map(rb["plan"], width=width))
    got, want = _streaming_reports(b["graph"], rb["graph"], b["plan"].io_dtype_bytes)
    assert got == want


def test_ds_cnn_macs_match_hand_computation():
    conv1 = 64 * 25 * 5 * 1 * 5 * 5
    dw = 64 * 25 * 5 * 3 * 3
    pw = 64 * 25 * 5 * 64 * 1 * 1
    fc = 320 * 12
    hand_total = conv1 + 4 * (dw + pw) + fc
    assert hand_total == 2_539_840
    for int8 in (False, True):
        b, _ = _bundles("ds_cnn", int8)
        seg = report.segment_report(b["graph"], b["plan"])
        assert seg["total_macs"] == hand_total
        assert sum(s["macs"] for s in seg["segments"]) == hand_total


def test_known_planner_arena_bytes():
    expect = {
        ("lenet", False): 8800, ("lenet", True): 2200,
        ("residual_cifar", False): 32768, ("residual_cifar", True): 8192,
        ("ds_cnn", False): 64000, ("ds_cnn", True): 16000,
    }
    for (name, int8), bytes_ in expect.items():
        b, _ = _bundles(name, int8)
        assert b["plan"].arena_bytes == bytes_, (name, int8)


def test_segment_report_kinds_ds_cnn():
    b, _ = _bundles("ds_cnn", True)
    seg = report.segment_report(b["graph"], b["plan"])
    assert seg["segments_by_kind"].get("periodic-scan", 0) >= 1
    periodic = next(s for s in seg["segments"] if s["kind"] == "periodic-scan")
    assert periodic["period"] == 2


def test_build_workload_quantizes_handed_weights_as_the_reference():
    """The reference's fused weights handed across give the reference's
    int8 weights, and its multipliers at ``tests/test_torch_dag.py``'s
    calibration tolerance (rtol 1e-5); inputs quantize the same way."""
    _, rb = _bundles("ds_cnn_kws", False)
    _, rq = _bundles("ds_cnn_kws", True)
    params = jax.tree.map(np.array, rb["params"])
    b = report.build_workload("ds_cnn_kws", int8=True, device="cpu", params=params)
    assert set(b["params"]) == set(rq["params"])
    for name, p in b["params"].items():
        want = rq["params"][name]
        if "w" in want:
            np.testing.assert_array_equal(p["w"].numpy(), np.asarray(want["w"]))
            np.testing.assert_allclose(np.asarray(p.get("m_host", p["m"]), np.float32),
                                       np.asarray(want["m"]), rtol=1e-5)
        if "b" in want:
            np.testing.assert_allclose(p["b"].numpy(), np.asarray(want["b"]), atol=1)
        if "ms" in want:
            np.testing.assert_allclose(p["ms"].numpy(), np.asarray(want["ms"]), rtol=1e-5)
    x = b["make_input"](np.random.default_rng(3))
    x_ref = rq["make_input"](np.random.default_rng(3))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))


def test_timed_segments_smoke_lenet():
    b, _ = _bundles("lenet", False)
    t = report.timed_segments(b, iters=1)
    rows = t["by_time"]
    assert t["clock"] == "perf_counter"
    assert len(rows) == report.segment_report(b["graph"], b["plan"])["n_segments"]
    assert sorted(r["index"] for r in rows) == list(range(len(rows)))
    assert all(r["measured_s"] > 0 for r in rows)
    assert sum(r["model_frac"] for r in rows) == pytest.approx(1.0, abs=0.01)
    assert sum(r["discrepancy"] for r in rows) == pytest.approx(0.0, abs=0.02)
    assert t["total_macs"] == report.segment_report(b["graph"], b["plan"])["total_macs"]


def test_workload_report_assembles_the_sections():
    r = report.workload_report("ds_cnn_kws", int8=True, timed=True, iters=1, device="cpu")
    assert r["workload"] == "ds_cnn_kws" and r["dtype"] == "int8"
    assert r["arena"]["peak_bytes"] == r["arena"]["arena_bytes"]
    assert len(r["timing"]["by_time"]) == r["segments"]["n_segments"]


def test_workload_report_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        report.workload_report("lenet")


@pytest.mark.parametrize("name", ["residual_cifar", "ds_cnn_kws"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_dag_executor_runs_through_the_segment_runner(name, int8):
    """The executor's output equals a plain step-by-step walk of the plan's
    schedule, and the segments it runs tile that schedule."""
    from repro_torch.core import segments as segments_mod

    b, _ = _bundles(name, int8)
    ex = pingpong.make_dag_executor(b["graph"], b["plan"], apply_node_fn=b["apply_node_fn"])
    mat, order, segs = segments_mod.segments_for_plan(b["graph"], b["plan"])
    assert [n for s in segs for n in s.names] == list(order[1:])
    rng = np.random.default_rng(11)
    x = torch.stack([b["make_input"](rng) for _ in range(3)])
    y = ex(b["params"], x)
    steps = {s.name: s for s in mat.steps}
    first = steps[order[0]]
    vals = {order[0]: pingpong.run_step(b["apply_node_fn"], first, {}, [x.clone()])
            if first.views else x}
    for name_ in order[1:]:
        s = steps[name_]
        vals[name_] = pingpong.run_step(b["apply_node_fn"], s, b["params"].get(name_, {}),
                                        [vals[src] for src in s.inputs])
    assert torch.equal(y, vals[mat.output])
