"""The trace reduction and the per-layer readers on a hand-made trace."""
import json
import types
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from perfbench import counts, harness, trace

ROOT = Path(__file__).resolve().parents[2]


def ev(name, start_us, end_us, device=DeviceType.CUDA, card=0):
    return types.SimpleNamespace(name=name, device_type=device, device_index=card,
                                 time_range=types.SimpleNamespace(start=start_us, end=end_us),
                                 is_user_annotation=False)


def host(name, start_us, end_us):
    return ev(name, start_us, end_us, device=DeviceType.CPU)


def events():
    k4 = "void (anonymous namespace)::conv_pool_dw_q8_kernel<3>(signed char const*)"
    k2 = "(anonymous namespace)::conv_pool_q8_kernel(signed char const*)"
    return [
        host(trace.SLICE, 0, 100),
        host("perfbench.executor", 0, 10),
        host("perfbench.wait", 10, 100),
        ev("ProfilerStep#1", 0, 100),
        ev(k4, 5, 25), ev("void at::native::round_kernel", 20, 40),  # overlapping: union 5..40
        ev("Memcpy HtoD (Pinned -> Device)", 50, 60),
        ev(k2, 70, 80),
        ev(k4, 10, 30, card=1), ev("void gemm", 30, 90, card=1),
    ]


def test_reduce_events_unions_and_names_the_gaps():
    t = trace.reduce_events(events(), [0, 1])
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s[0] == pytest.approx((35 + 10 + 10) * 1e-6)
    assert t.busy_s[1] == pytest.approx(80e-6)
    # card 0's gaps: 0..5 (executor open), 40..50, 60..70, 80..100 (wait); card 1's 0..10, 90..100
    assert t.idle_by_span["executor"] == pytest.approx((5 + 10) / 2 * 1e-6)
    assert t.idle_by_span["wait"] == pytest.approx((10 + 10 + 20 + 10) / 2 * 1e-6)
    assert all("ProfilerStep" not in op.name for op in t.ops)
    assert t.op_seconds(counts.KERNEL_NAMES["K4"]) == pytest.approx(40e-6)


def record(ops_trace, chips=2):
    net = json.loads((ROOT / "perfbench/configs/ds_cnn_kws_int8.json").read_text())
    ops_trace.images, ops_trace.batches = 64, 2
    return harness.Record(platform="gpu", chips=chips, net=net, batch=32, setup_s=1.0,
                          window_s=1.0, images=6400, batches=200, host_call_s=[1e-3, 3e-3],
                          busy_span_s={0: 0.5, 1: 0.7}, readings={"arena_bytes": 16000},
                          trace=ops_trace,
                          system=harness.load_module(ROOT, "systems", "int8_cnn"))


def reader(name):
    return harness.load_reader(ROOT, name)


def test_readers_on_a_hand_made_trace():
    rec = record(trace.reduce_events(events(), [0, 1]))
    assert reader("executor_host_ms")(rec) == pytest.approx(2.0)
    assert reader("images_per_s")(rec) == pytest.approx(6400)
    assert reader("mesh_busy_share")(rec) == pytest.approx(60.0)
    plain = (20 + 60) * 1e-6  # the round kernel and the gemm; not the copy, not K2 or K4
    assert reader("plain_ops_us_per_image")(rec) == pytest.approx(1e6 * plain / 64)
    assert reader("idle_share")(rec) == pytest.approx(100 * (1 - (55 + 80) / 2 / 100))
    bound = counts.kernel_bound_s(rec.net, "K4", 16) * 2 * 2
    assert reader("k4_roofline")(rec) == pytest.approx(100 * bound / 40e-6)
    mfu = 2 * counts.macs_per_image(rec.net) * 6400 / (2 * counts.PEAK_INT8_OPS_PER_S)
    assert reader("mfu")(rec) == pytest.approx(100 * mfu)


def test_a_kernel_without_a_device_record_fails_the_traced_run():
    no_k2 = [e for e in events() if "conv_pool_q8_kernel" not in e.name]
    rec = record(trace.reduce_events(no_k2, [0, 1]))
    with pytest.raises(harness.MetricError):
        reader("k2_roofline")(rec)


def test_device_metrics_are_not_read_from_a_cpu_run():
    rec = record(trace.reduce_events(events(), [0, 1]))
    rec.platform = "cpu"
    for name in ("plain_ops_us_per_image", "k4_roofline", "k2_roofline", "idle_share", "mfu",
                 "mesh_busy_share"):
        assert reader(name)(rec) is None
