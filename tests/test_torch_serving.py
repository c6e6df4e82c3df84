"""The port's CNN serving engine, on the CPU (``device="cpu"``).

Mirrors ``tests/test_serving.py`` and the ``ServeStats`` tests of
``tests/test_obs.py``:

* the bucket ladder and the bucketed executor cache (selection, prewarm
  counts, no rebuilds);
* padding lanes are row-independent: zero and garbage padding give equal
  real rows, bit for bit;
* engine outputs equal the executor's (float within tolerance across the
  batch shapes the coalescer happens to form, bit-exact with one bucket;
  int8 bit-exact against the reference's simulator);
* the ``ServeStats`` percentile window contract.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as ref_fusion
from repro.core import graph as ref_graph
from repro.core import nn as ref_nn
from repro.core import quantize as ref_quantize
from repro_torch import convert
from repro_torch.core import fusion, graph, pingpong, planner
from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy, ServeStats
from repro_torch.serve.step import BucketedExecutorCache, bucket_for


@pytest.fixture(scope="module")
def lenet_setup():
    g_ref = ref_graph.lenet5()
    fused_ref = ref_fusion.fuse(g_ref)
    p_ref = ref_fusion.rename_params(
        fused_ref, ref_nn.init_params(g_ref, jax.random.PRNGKey(0)))
    fused = fusion.fuse(graph.lenet5())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, p_ref), device="cpu")
    plan = planner.plan_pingpong(graph.lenet5())
    return fused, plan, params, fused_ref, p_ref


@pytest.fixture(scope="module")
def cifar_q8_setup():
    g_ref = ref_graph.cifar_testnet()
    fused_ref = ref_fusion.fuse(g_ref)
    p_ref = ref_fusion.rename_params(
        fused_ref, ref_nn.init_params(g_ref, jax.random.PRNGKey(6)))
    calib = np.random.default_rng(7).standard_normal((8, 3, 32, 32)).astype(np.float32)
    qm_ref = ref_quantize.quantize(fused_ref, p_ref, jnp.asarray(calib))
    qm = convert.quantized_from_numpy(fusion.fuse(graph.cifar_testnet()),
                                      qm_ref.input_scale, qm_ref.layers)
    plan_q = planner.plan_pingpong(graph.cifar_testnet(), io_dtype_bytes=1)
    return qm, plan_q, qm_ref


# ---------------------------------------------------------------------------
# Bucket ladder + executor cache
# ---------------------------------------------------------------------------


def test_bucket_for_ladder():
    buckets = (1, 2, 4, 8, 16)
    assert [bucket_for(n, buckets) for n in (1, 2, 3, 4, 5, 8, 9, 16)] == \
        [1, 2, 4, 4, 8, 8, 16, 16]
    with pytest.raises(ValueError):
        bucket_for(0, buckets)
    with pytest.raises(ValueError):
        bucket_for(17, buckets)


def test_bucketed_cache_prewarm_counts_lowerings():
    lowered = []
    cache = BucketedExecutorCache(lambda b: lowered.append(b) or (lambda x: x * b),
                                  (4, 1, 2), prewarm=True)
    assert cache.buckets == (1, 2, 4)
    assert sorted(lowered) == [1, 2, 4] and cache.misses == 3
    b, fn = cache.for_batch(3)
    assert b == 4 and fn(1) == 4 and cache.misses == 3
    with pytest.raises(KeyError):
        cache.get(3)
    lazy = BucketedExecutorCache(lambda b: b, (1, 2), prewarm=False)
    assert lazy.misses == 0 and lazy.get(2) == 2 and lazy.misses == 1


def test_engine_prepares_every_bucket_once(lenet_setup):
    fused, plan, params, _, _ = lenet_setup
    eng = CNNEngine.from_graph(fused, plan, params, device="cpu",
                               buckets=(1, 2, 4, 8, 16))
    assert eng._cache.misses == 5
    assert sorted(eng.executor.arenas) == [1, 2, 4, 8, 16]
    for b, arena in eng.executor.arenas.items():
        assert tuple(arena.shape) == (b, plan.arena_elems)
    assert eng.metrics.value("executor_cache.lowerings") == 5


# ---------------------------------------------------------------------------
# Padded partial batches: bucket exactness without thread scheduling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 5, 7, 8])
def test_padded_partial_batches_row_independent(lenet_setup, n):
    fused, plan, params, fused_ref, p_ref = lenet_setup
    ex = pingpong.make_scan_executor(fused, plan)
    bucket = bucket_for(n, (1, 2, 4, 8))
    rng = np.random.default_rng(n)
    xs = rng.standard_normal((n, 1, 32, 32)).astype(np.float32)
    zero = np.zeros((bucket, 1, 32, 32), np.float32)
    zero[:n] = xs
    garbage = np.full((bucket, 1, 32, 32), 1e6, np.float32)
    garbage[:n] = xs
    y_zero = ex(params, torch.from_numpy(zero))[:n].numpy()
    y_garb = ex(params, torch.from_numpy(garbage))[:n].numpy()
    np.testing.assert_array_equal(y_zero, y_garb)
    oracle = np.asarray(ref_nn.forward(fused_ref, p_ref, jnp.asarray(xs)))
    np.testing.assert_allclose(y_zero, oracle, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 3])
def test_padded_partial_batches_int8_row_independent(cifar_q8_setup, n):
    qm, plan_q, qm_ref = cifar_q8_setup
    from repro_torch.quant.exec import make_int8_executor

    ex, params = make_int8_executor(qm, plan_q, device="cpu")
    rng = np.random.default_rng(10 + n)
    xq = rng.integers(-128, 128, (n, 3, 32, 32)).astype(np.int8)
    zero = np.zeros((4, 3, 32, 32), np.int8)
    zero[:n] = xq
    garbage = np.full((4, 3, 32, 32), 127, np.int8)
    garbage[:n] = xq
    y_zero = ex(params, torch.from_numpy(zero))[:n].numpy()
    y_garb = ex(params, torch.from_numpy(garbage))[:n].numpy()
    np.testing.assert_array_equal(y_zero, y_garb)
    oracle = np.asarray(ref_quantize.simulate_int8_forward(qm_ref, jnp.asarray(xq)))
    np.testing.assert_array_equal(y_zero, oracle)


# ---------------------------------------------------------------------------
# The threaded engine end-to-end
# ---------------------------------------------------------------------------


def test_engine_float_end_to_end(lenet_setup):
    fused, plan, params, fused_ref, p_ref = lenet_setup
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((13, 1, 32, 32)).astype(np.float32)
    eng = CNNEngine.from_graph(
        fused, plan, params, device="cpu", buckets=(1, 2, 4),
        policy=CoalescePolicy(max_batch=4, max_wait_s=0.001))
    assert eng._cache.misses == 3
    with eng:
        reqs, run = eng.serve(imgs)
    assert run.requests == 13 and all(r.y is not None for r in reqs)
    assert eng._cache.misses == 3  # serving never prepared anything new
    assert run.batches >= 4        # max_batch=4 forces at least ceil(13/4)
    got = np.stack([r.y for r in reqs])
    ex_out = pingpong.make_scan_executor(fused, plan)(params, torch.from_numpy(imgs))
    np.testing.assert_allclose(got, ex_out.numpy(), rtol=1e-5, atol=1e-6)
    oracle = np.asarray(ref_nn.forward(fused_ref, p_ref, jnp.asarray(imgs)))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_engine_single_bucket_bit_exact(lenet_setup):
    """One bucket: the batch shape is fixed, so the engine's output is bit
    for bit the executor called directly."""
    fused, plan, params, _, _ = lenet_setup
    eng = CNNEngine.from_graph(fused, plan, params, device="cpu", buckets=(1,),
                               policy=CoalescePolicy(max_batch=1))
    img = np.random.default_rng(8).standard_normal((1, 32, 32)).astype(np.float32)
    with eng:
        y = eng.submit(img).result(timeout=30.0)
    direct = eng._cache.get(1)(params, torch.from_numpy(img[None]))[0].numpy()
    np.testing.assert_array_equal(y, direct)


def test_engine_int8_bit_exact_vs_reference_simulator(cifar_q8_setup):
    qm, plan_q, qm_ref = cifar_q8_setup
    rng = np.random.default_rng(13)
    xs = jnp.asarray(rng.standard_normal((6, 3, 32, 32)), jnp.float32)
    xq = np.array(ref_quantize.quantize_input(qm_ref, xs))
    eng = CNNEngine.from_quantized(qm, plan_q, device="cpu", buckets=(1, 2, 4),
                                   policy=CoalescePolicy(max_batch=4,
                                                         max_wait_s=0.001))
    assert eng.dtype == torch.int8
    assert eng.executor.arenas[4].dtype == torch.int8
    with eng:
        reqs, run = eng.serve(xq, arrivals_s=[0.0, 0.0, 0.0, 0.002, 0.002, 0.004])
    oracle = np.asarray(ref_quantize.simulate_int8_forward(qm_ref, jnp.asarray(xq)))
    np.testing.assert_array_equal(np.stack([r.y for r in reqs]), oracle)
    assert run.requests == 6 and sum(run.bucket_hist.values()) == run.batches


def test_engine_submit_validation_and_restart(lenet_setup):
    fused, plan, params, _, _ = lenet_setup
    eng = CNNEngine.from_graph(fused, plan, params, device="cpu", buckets=(1,),
                               policy=CoalescePolicy(max_batch=1))
    with pytest.raises(RuntimeError):
        eng.submit(np.zeros((1, 32, 32), np.float32))  # not started
    with eng:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((3, 32, 32), np.float32))  # wrong shape
        r = eng.submit(np.zeros((1, 32, 32), np.float32))
        r.result(timeout=30.0)
    with eng:  # restartable after stop
        r2 = eng.submit(np.zeros((1, 32, 32), np.float32))
        np.testing.assert_array_equal(r2.result(timeout=30.0), r.y)
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith("cnn-engine"))


def test_engine_fails_a_batch_instead_of_hanging(lenet_setup):
    """An executor that raises fails its batch's requests with the cause;
    the engine keeps serving the next batch."""
    fused, plan, params, _, _ = lenet_setup
    eng = CNNEngine.from_graph(fused, plan, params, device="cpu", buckets=(1,),
                               policy=CoalescePolicy(max_batch=1))
    good = eng.executor
    calls = []

    def flaky(p, x):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("boom")
        return good(p, x)

    eng._cache._compiled[1] = flaky
    with eng:
        bad = eng.submit(np.zeros((1, 32, 32), np.float32))
        with pytest.raises(RuntimeError):
            bad.result(timeout=30.0)
        assert isinstance(bad.error, ValueError)
        ok = eng.submit(np.zeros((1, 32, 32), np.float32)).result(timeout=30.0)
    assert ok.shape == (10,)
    assert eng.metrics.value("engine.failed_batches") == 1


def test_engine_concurrent_submitters(lenet_setup):
    fused, plan, params, fused_ref, p_ref = lenet_setup
    imgs = np.random.default_rng(21).standard_normal((12, 1, 32, 32)).astype(np.float32)
    oracle = np.asarray(ref_nn.forward(fused_ref, p_ref, jnp.asarray(imgs)))
    eng = CNNEngine.from_graph(fused, plan, params, device="cpu",
                               buckets=(1, 2, 4),
                               policy=CoalescePolicy(max_batch=4, max_wait_s=0.001))
    results = {}

    def worker(lo, hi):
        for i in range(lo, hi):
            results[i] = eng.submit(imgs[i])

    with eng:
        ts = [threading.Thread(target=worker, args=(lo, lo + 4)) for lo in (0, 4, 8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
            assert not t.is_alive()
        for i, r in results.items():
            np.testing.assert_allclose(r.result(timeout=30.0), oracle[i],
                                       rtol=1e-5, atol=1e-6)
    assert sorted(r.rid for r in results.values()) == list(range(12))


# ---------------------------------------------------------------------------
# ServeStats: the percentile window contract
# ---------------------------------------------------------------------------


def test_servestats_latency_ms_empty_window():
    s = ServeStats()
    for pct in (50, 95, 99):
        assert s.latency_ms(pct) == 0.0


def test_servestats_latency_ms_single_sample():
    s = ServeStats(latencies_s=[0.004])
    for pct in (50, 95, 99):
        assert s.latency_ms(pct) == pytest.approx(4.0)


def test_servestats_snapshot_is_isolated_copy():
    s = ServeStats()
    assert s.record_batch(bucket=4, n=3) == 0
    s.record_latencies([0.001, 0.002, 0.003])
    snap = s.snapshot()
    s.record_batch(bucket=4, n=4)
    s.record_latencies([0.009])
    assert snap.batches == 1 and snap.requests == 3 and snap.padded_lanes == 1
    assert snap.latencies_s == [0.001, 0.002, 0.003]
    assert s.batches == 2 and s.latency_count() == 4
    assert snap._lock is not s._lock
    assert snap.summary()["p50_ms"] == pytest.approx(2.0)
