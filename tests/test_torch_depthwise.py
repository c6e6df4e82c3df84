"""Kernels K3 and K4 (depthwise conv + act + pool, f32/bf16 and int8) on the
CPU: their plain versions against the reference, and the host-side pieces
of their launch.

* K3's plain version against the reference's ``fused_depthwise_conv_pool``
  (``impl="xla"``) at rtol 1e-5 / atol 1e-6 (``tests/test_depthwise.py``'s
  tolerance), K4's against ``fused_depthwise_conv_pool_q8``
  (``impl="xla"``) bit for bit, on every depthwise shape of DS-CNN-KWS and
  MobileNet-V1 0.25 (stride 1 and 2) plus pools 2×2 max and avg, no bias
  and no ReLU;
* the ReLU fold of the DAG executors: ``requant(max(acc, 0))`` equals
  ``max(requant(acc), 0)`` for non-negative multipliers, ties and
  saturation included, and K4 refuses a negative one;
* K4's launch at every depthwise step of the int8 engines: one kernel call,
  handed K3's tiling (one output a thread) and the device multipliers.

The reference's Pallas path is never used (``pl.Unblocked`` is gone on this
jax); the CUDA kernels themselves are checked on the card by
``chip_smoke.py``.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as ref_quantize
from repro.kernels.conv_pool.depthwise import fused_depthwise_conv_pool as ref_dw
from repro.quant.kernel_q8 import fused_depthwise_conv_pool_q8 as ref_dw_q8
from repro_torch.core import graph, quantize, schedule
from repro_torch.kernels.conv_pool import kernel as launch
from repro_torch.kernels.conv_pool.depthwise import fused_depthwise_conv_pool
from repro_torch.quant import kernel_q8


def _net_depthwise_shapes():
    """(name, C, H, W, stride) of every depthwise step of the two nets."""
    out = []
    for net in ("ds_cnn_kws", "mobilenet_v1"):
        mat = schedule.materialize_dag(schedule.fuse_dag_priced(getattr(graph, net)()))
        for s in mat.steps:
            if s.layer.kind == "DepthwiseConv2d":
                assert s.layer.kernel_size == (3, 3) and s.layer.padding == (1, 1)
                assert [v.kind for v in s.views] == ["ReLU"]
                out.append((f"{net}/{s.name}", *s.in_shapes[0], s.layer.stride))
    return out


NET_SHAPES = _net_depthwise_shapes()
# (C, H, W, stride, pool_k, pool_stride, pool, activation, bias)
EXTRA = [
    (16, 16, 16, 1, 2, 2, "max", "relu", True),
    (16, 16, 16, 1, 2, 2, "avg", "relu", True),
    (16, 15, 9, 2, 2, 1, "max", "relu", True),  # odd map, overlapping pool
    (8, 10, 12, 2, 3, 2, "avg", "none", False),
    (32, 8, 8, 1, 1, 1, "max", "none", False),
]
CASES = ([(name, c, h, w, s, 1, 1, "max", "relu", True)
          for name, c, h, w, s in NET_SHAPES]
         + [(f"extra{i}", *e) for i, e in enumerate(EXTRA)])


def test_the_nets_have_every_depthwise_shape():
    names = [n for n, *_ in NET_SHAPES]
    assert names == [f"ds_cnn_kws/dw{i}" for i in range(1, 5)] + \
        [f"mobilenet_v1/dw{i}" for i in range(1, 14)]
    strided = {n.split("/")[1] for n, _, _, _, s in NET_SHAPES if s == (2, 2)}
    assert strided == {"dw2", "dw4", "dw6", "dw12"}


def _inputs(case, n=2):
    name, c, h, w, s, pk, ps, pool, act, bias = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((c, 1, 3, 3)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32) if bias else None
    geom = dict(conv_stride=s, padding=1, pool_k=pk, pool_stride=ps,
                activation=act, pool=pool)
    return rng, x, wt, b, geom


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k3_plain_matches_reference_xla(case):
    _, x, w, b, geom = _inputs(case)
    y = fused_depthwise_conv_pool(torch.from_numpy(x), torch.from_numpy(w),
                                  None if b is None else torch.from_numpy(b), **geom)
    y_ref = ref_dw(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                   impl="xla", **geom)
    assert y.dtype == torch.float32 and tuple(y.shape) == y_ref.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-6)
    # unbatched, and through out=
    out = torch.empty_like(y[0])
    y1 = fused_depthwise_conv_pool(torch.from_numpy(x[0]), torch.from_numpy(w),
                                   None if b is None else torch.from_numpy(b),
                                   out=out, **geom)
    assert y1.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(out.numpy(), np.asarray(y_ref)[0], rtol=1e-5, atol=1e-6)


def test_k3_plain_bf16_widens_and_casts_back():
    _, x, w, b, geom = _inputs(CASES[0])
    xb, wb, bb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    y = fused_depthwise_conv_pool(xb, wb, bb, **geom)
    y32 = fused_depthwise_conv_pool(xb.float(), wb.float(), bb.float(), **geom)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y32.to(torch.bfloat16))


def _multipliers(rng, c):
    """Per-channel multipliers that make ties and saturation: powers of two
    (every odd multiple of half a step is a tie) and large ones."""
    m = rng.choice(np.float32([2.0**-6, 2.0**-7, 2.0**-8, 0.05, 1e-3]), c)
    return m.astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k4_plain_bit_exact_vs_reference_xla(case):
    name, c, h, w, *_ = case
    rng, _, _, _, geom = _inputs(case)
    x = rng.integers(-128, 128, (2, c, h, w)).astype(np.int8)
    wq = rng.integers(-127, 128, (c, 1, 3, 3)).astype(np.int8)
    b = rng.integers(-3000, 3000, c).astype(np.int32) if case[-1] else None
    m = _multipliers(rng, c)
    y = kernel_q8.fused_depthwise_conv_pool_q8(
        torch.from_numpy(x), torch.from_numpy(wq),
        None if b is None else torch.from_numpy(b), multiplier=m, **geom)
    y_ref = np.asarray(ref_dw_q8(
        jnp.asarray(x), jnp.asarray(wq), None if b is None else jnp.asarray(b),
        multiplier=tuple(float(v) for v in m), impl="xla", **geom))
    assert y.dtype == torch.int8
    np.testing.assert_array_equal(y.numpy(), y_ref)
    assert (y_ref == 127).any() or (y_ref == -128).any() or c < 16


def _fold_accumulators():
    """int32 accumulators with exact ±0.5 ties at m = 2^-k and both
    saturation edges, and random ones."""
    rng = np.random.default_rng(0)
    ties = np.arange(-(1 << 12), (1 << 12) + 1, 1 << 3)
    edges = np.array([253, 254, 255, 256, 257, -253, -255, -256, -257, 2**31 - 1,
                      -2**31, 0])
    return np.concatenate([ties, edges, rng.integers(-2**20, 2**20, 4000)]).astype(np.int32)


def test_relu_fold_is_bit_exact_for_non_negative_multipliers():
    acc = _fold_accumulators()
    c = 8
    acc = acc[: acc.size // c * c].reshape(1, c, -1, 1)
    m = np.float32([2.0**-4, 2.0**-5, 0.5, 0.25, 0.0, 1e-6, 3.0, 0.0123])
    a = torch.from_numpy(acc)
    folded = quantize.requantize_per_channel(torch.clamp(a, min=0), m)
    reference_order = torch.clamp(quantize.requantize_per_channel(a, m), min=0)
    assert torch.equal(folded, reference_order)
    ref = np.maximum(np.asarray(ref_quantize.requantize_per_channel(
        jnp.asarray(acc), jnp.asarray(m))), 0)
    np.testing.assert_array_equal(folded.numpy(), ref)
    v = acc.astype(np.float64) * m.reshape(1, c, 1, 1).astype(np.float64)
    assert np.any(v == 0.5) and np.any(v == 2.5)  # ties
    assert (folded.numpy() == 127).any()  # saturation
    # a negative multiplier breaks the equality, and K4 refuses it
    neg = np.float32([-0.5] * c)
    assert not torch.equal(quantize.requantize_per_channel(torch.clamp(a, min=0), neg),
                           torch.clamp(quantize.requantize_per_channel(a, neg), min=0))
    x = torch.zeros(1, c, 4, 4, dtype=torch.int8)
    wq = torch.ones(c, 1, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="non-negative"):
        kernel_q8.fused_depthwise_conv_pool_q8(x, wq, multiplier=neg, padding=1)
    # without a ReLU and without a pool window, order does not matter
    kernel_q8.fused_depthwise_conv_pool_q8(x, wq, multiplier=neg, padding=1,
                                           activation="none")


def test_k4_avg_multiplier_is_formed_in_f32_on_the_host():
    m = np.float32([0.1, 0.3, 1e-3])
    got = kernel_q8.channel_multipliers(m, 3, activation="relu", pool="avg",
                                        pool_k=(25, 5))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, m / np.float32(125))
    np.testing.assert_array_equal(
        kernel_q8.channel_multipliers(np.float32(0.5), 3, activation="none",
                                      pool="max", pool_k=1), np.float32([0.5] * 3))


@pytest.mark.parametrize("n", (1, 16))
@pytest.mark.parametrize("case", NET_SHAPES, ids=[c[0] for c in NET_SHAPES])
def test_k4_launches_once_with_k3_tiling(monkeypatch, case, n):
    """K4's wrapper at a depthwise step of the int8 engines makes one kernel
    call, handed the step's geometry, K3's tiling and then the device copy
    of the per-channel multipliers."""
    import ctypes
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.conv_pool.depthwise import k3_tiling

    _, c, h, w, stride = case
    calls = []

    class Kernel:
        def __call__(self, *args):
            calls.append(args)
            return 0

    lib = type("Lib", (), {"conv_pool_dw_q8": Kernel()})()
    monkeypatch.setattr(launch.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = kernel_q8.K4_LAUNCHES.count
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        x = torch.empty(n, c, h, w, dtype=torch.int8, device="cuda")
        wq = torch.empty(c, 1, 3, 3, dtype=torch.int8, device="cuda")
        b = torch.empty(c, dtype=torch.int32, device="cuda")
        ms = torch.empty(c, dtype=torch.float32, device="cuda")
        y = kernel_q8.depthwise_conv_pool_q8(x, wq, b, multiplier=np.float32([0.5] * c),
                                             ms=ms, conv_stride=stride, padding=1)
    assert kernel_q8.K4_LAUNCHES.count - before == 1 and len(calls) == 1
    args = [getattr(a, "value", a) for a in calls[0]]
    geom = dict(conv_stride=stride, padding=(1, 1), pool_k=(1, 1), pool_stride=(1, 1))
    ph, pw = launch.output_hw(h, w, 3, 3, **geom)[2:]
    assert tuple(y.shape) == (n, c, ph, pw)
    assert args[4:21] == [n, c, h, w, c, 3, 3, *stride, 1, 1, 1, 1, 1, 1, 1, 0]
    assert tuple(args[21:23]) == k3_tiling(n, 1, h, w, c, 3, 3, **geom)
    assert args[23:25] == [c * h * w, c * ph * pw]
    assert isinstance(calls[0][25], ctypes.c_void_p) and len(calls[0]) == 27
