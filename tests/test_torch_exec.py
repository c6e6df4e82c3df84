"""The port's arena executors against the reference package, on the CPU.

* Float LeNet-5: the walker equals the arena executor, which equals the
  reference ``nn.forward``, at 1e-5, with the reference's weights passed
  across through numpy.
* Int8 §5 CIFAR (and LeNet-5): the walker, the arena executor and the
  port's simulator are bit-exact against the reference's
  ``simulate_int8_forward``, on the *reference's* ``QuantizedModel``
  passed across through numpy (calibration maxima differ in their low bits
  across frameworks, so a model quantized twice is not the same model).
* The executors allocate exactly the plan's arena, and reuse it.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as ref_fusion
from repro.core import graph as ref_graph
from repro.core import nn as ref_nn
from repro.core import pingpong as ref_pingpong
from repro.core import planner as ref_planner
from repro.core import quantize as ref_quantize
from repro_torch import convert
from repro_torch.core import fusion, graph, pingpong, planner, quantize
from repro_torch.quant import exec as qexec


def _reference_float(net, seed):
    """(port fused graph, port params on CPU, reference fused graph,
    reference params) from the reference's init."""
    g_ref = getattr(ref_graph, net)()
    fused_ref = ref_fusion.fuse(g_ref)
    p_ref = ref_fusion.rename_params(
        fused_ref, ref_nn.init_params(g_ref, jax.random.PRNGKey(seed)))
    fused = fusion.fuse(getattr(graph, net)())
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, p_ref), device="cpu")
    return fused, params, fused_ref, p_ref


def _reference_int8(net, seed, calib_n=8):
    """(port QuantizedModel built from the reference's, reference model, rng)."""
    fused, params, fused_ref, p_ref = _reference_float(net, seed)
    rng = np.random.default_rng(seed)
    in_shape = fused.shapes()[0]
    calib = rng.standard_normal((calib_n, *in_shape)).astype(np.float32)
    qm_ref = ref_quantize.quantize(fused_ref, p_ref, jnp.asarray(calib))
    qm = convert.quantized_from_numpy(fused, qm_ref.input_scale, qm_ref.layers)
    return qm, qm_ref, rng


@pytest.fixture(scope="module")
def lenet():
    return _reference_float("lenet5", 0)


def test_float_walker_executor_and_reference_agree(lenet):
    fused, params, fused_ref, p_ref = lenet
    plan = planner.plan_pingpong(graph.lenet5())
    xs = np.random.default_rng(1).standard_normal((3, 1, 32, 32)).astype(np.float32)
    y_ref = np.asarray(ref_nn.forward(fused_ref, p_ref, jnp.asarray(xs)))

    ex = pingpong.make_scan_executor(fused, plan)
    y_ex = ex(params, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(y_ex, y_ref, rtol=1e-5, atol=1e-6)
    for i in range(3):
        y_w, stats = pingpong.run_with_arena(fused, plan, params,
                                             torch.from_numpy(xs[i]))
        np.testing.assert_allclose(y_w.numpy(), y_ex[i], rtol=1e-5, atol=1e-6)
        assert stats == {"arena_elems": 2200, "buffers": 6}
    # one image, unbatched, through the executor
    np.testing.assert_allclose(ex(params, torch.from_numpy(xs[0])).numpy(),
                               y_ex[0], rtol=1e-5, atol=1e-6)


def test_float_run_batch_stats_equal_reference(lenet):
    fused, params, fused_ref, p_ref = lenet
    plan = planner.plan_pingpong(graph.lenet5())
    xs = np.random.default_rng(2).standard_normal((4, 1, 32, 32)).astype(np.float32)
    y, stats = pingpong.run_batch_with_arena(fused, plan, params, torch.from_numpy(xs))
    y_ref, stats_ref = ref_pingpong.run_batch_with_arena(
        fused_ref, ref_planner.plan_pingpong(ref_graph.lenet5()), p_ref,
        jnp.asarray(xs))
    assert stats == stats_ref
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        pingpong.run_batch_with_arena(fused, plan, params, torch.from_numpy(xs[0]))


def test_executor_arena_is_the_plan_and_is_reused(lenet):
    fused, params, _, _ = lenet
    plan = planner.plan_pingpong(graph.lenet5())
    ex = pingpong.make_scan_executor(fused, plan)
    x = torch.zeros(5, 1, 32, 32)
    y1 = ex(params, x)
    arena = ex.arenas[5]
    assert tuple(arena.shape) == (5, plan.arena_elems)
    assert plan.arena_elems * arena.element_size() == 8800  # paper §3: 8,800 B
    y2 = ex(params, torch.ones(5, 1, 32, 32))
    assert ex.arenas[5] is arena  # reused, not reallocated
    assert not torch.equal(y1, y2)  # the first output was a copy
    ex(params, torch.zeros(2, 1, 32, 32))
    assert sorted(ex.arenas) == [2, 5]


def test_executor_rejects_wrong_shapes_and_overlapping_plans(lenet):
    fused, params, _, _ = lenet
    plan = planner.plan_pingpong(graph.lenet5())
    ex = pingpong.make_scan_executor(fused, plan)
    with pytest.raises(ValueError):
        ex(params, torch.zeros(2, 3, 32, 32))
    # A plan whose step output lands on its own input cannot run in place.
    bufs = list(plan.buffers)
    bufs[1] = dataclasses.replace(bufs[1], offset_elems=0)
    with pytest.raises(ValueError):
        pingpong.make_scan_executor(fused, dataclasses.replace(plan, buffers=tuple(bufs)))
    with pytest.raises(ValueError):
        pingpong.make_scan_executor(graph.lenet5(), plan)  # unfused graph


@pytest.mark.parametrize("plan_fn", ["plan_pingpong", "plan_optimal_arena"])
@pytest.mark.parametrize("net", ["lenet5", "cifar_testnet"])
def test_int8_walker_executor_bit_exact_vs_reference(plan_fn, net):
    qm, qm_ref, rng = _reference_int8(net, seed=0)
    plan = getattr(planner, plan_fn)(getattr(graph, net)(), io_dtype_bytes=1)
    xs = rng.standard_normal((4, *qm.graph.shapes()[0])).astype(np.float32)
    xq = np.array(ref_quantize.quantize_input(qm_ref, jnp.asarray(xs)))
    y_ref = np.asarray(ref_quantize.simulate_int8_forward(qm_ref, jnp.asarray(xq)))

    # the port's own input quantization and simulator agree bit for bit
    np.testing.assert_array_equal(
        quantize.quantize_input(qm, torch.from_numpy(xs)).numpy(), xq)
    np.testing.assert_array_equal(
        quantize.simulate_int8_forward(qm, torch.from_numpy(xq)).numpy(), y_ref)

    y_ex, stats = qexec.run_batch_int8_with_arena(qm, plan, torch.from_numpy(xq))
    assert y_ex.dtype == torch.int8 and stats["batch"] == 4
    assert stats["arena_bytes"] == plan.arena_elems
    np.testing.assert_array_equal(y_ex.numpy(), y_ref)
    for i in range(2):
        y_w, st = qexec.run_int8_with_arena(qm, plan, torch.from_numpy(xq[i]))
        np.testing.assert_array_equal(y_w.numpy(), y_ref[i])
        assert st["arena_bytes"] == plan.arena_elems


def test_int8_executor_arena_is_int8_plan():
    qm, qm_ref, rng = _reference_int8("cifar_testnet", seed=3)
    plan = planner.plan_pingpong(graph.cifar_testnet(), io_dtype_bytes=1)
    ex, params = qexec.make_int8_executor(qm, plan, device="cpu")
    xq = torch.zeros(2, 3, 32, 32, dtype=torch.int8)
    ex(params, xq)
    arena = ex.arenas[2]
    assert arena.dtype == torch.int8
    assert tuple(arena.shape) == (2, 11264)  # paper Table 1: 11,264 B per image
    with pytest.raises(TypeError):
        qexec.run_batch_int8_with_arena(qm, plan, torch.zeros(2, 3, 32, 32))
    with pytest.raises(TypeError):
        qexec.run_int8_with_arena(qm, plan, torch.zeros(3, 32, 32))


def test_port_quantize_matches_reference_scales():
    """The port's own calibration, on the same weights and batch: scales at
    rtol 1e-5, weights identical, biases within one step."""
    fused, params, fused_ref, p_ref = _reference_float("cifar_testnet", 5)
    calib = np.random.default_rng(5).standard_normal((8, 3, 32, 32)).astype(np.float32)
    qm = quantize.quantize(fused, params, torch.from_numpy(calib))
    qm_ref = ref_quantize.quantize(fused_ref, p_ref, jnp.asarray(calib))
    np.testing.assert_allclose(qm.input_scale, qm_ref.input_scale, rtol=1e-5)
    assert qm.layers.keys() == qm_ref.layers.keys()
    for name, q in qm.layers.items():
        r = qm_ref.layers[name]
        for field in ("w_scale", "in_scale", "out_scale"):
            np.testing.assert_allclose(getattr(q, field), getattr(r, field), rtol=1e-5)
        np.testing.assert_allclose(q.multiplier, r.multiplier, rtol=1e-5)
        np.testing.assert_array_equal(q.w_q, r.w_q)
        assert np.abs(q.b_q.astype(np.int64) - r.b_q).max() <= 1
    assert qm.param_bytes() == qm_ref.param_bytes()


def test_requantize_matches_reference_on_ties_and_saturation():
    acc = np.concatenate([
        np.arange(-600, 601, dtype=np.int32),
        np.array([2**31 - 1, -2**31, 255, 257, -255, -257], np.int32),
    ])
    for m in (0.5, 0.25, 1.0, 0.0123, 3.0):
        ours = quantize.requantize(torch.from_numpy(acc), m).numpy()
        ref = np.asarray(ref_quantize.requantize(jnp.asarray(acc), m))
        np.testing.assert_array_equal(ours, ref)
    # torch.round is half to even, as jnp.round is
    assert quantize.requantize(torch.tensor([1, 3, 5, -1, -3]), 0.5).tolist() == [0, 2, 2, 0, -2]
