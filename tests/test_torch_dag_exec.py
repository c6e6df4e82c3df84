"""The port's DAG arena executors and the DAG engine against the reference,
on the CPU.

Weights come from the reference's init and its ``quantize_dag`` model,
carried across through numpy (``repro_torch.convert``).  Held:

* float: the walker and the executor against the reference
  ``nn.forward_dag`` — ``ds_cnn_kws``, ``ds_cnn`` and ``residual_cifar`` at
  1e-5, ``mobilenet_v1`` at 1e-4 (``tests/test_rect_avgpool.py``'s
  tolerance for it);
* int8: the walker, the executor and the port's simulator bit-exact against
  the reference's ``simulate_int8_dag_forward``;
* the executor's arena is the plan's, per batch size, and is reused; a plan
  that puts a step's output on one of its inputs is refused;
* ``CNNEngine`` over a DAG, float and int8, equals the executor.
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
from repro_torch.core import graph, pingpong, quantize, schedule
from repro_torch.quant import exec as qexec
from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy

TOL = {"ds_cnn_kws": 1e-5, "ds_cnn": 1e-5, "residual_cifar": 1e-5,
       "mobilenet_v1": 1e-4}
ARENA_BYTES = {"ds_cnn_kws": (64000, 16000), "ds_cnn": (64000, 16000),
               "mobilenet_v1": (98304, 24576), "residual_cifar": (32768, 8192)}
SEEDS = {"ds_cnn_kws": 0, "ds_cnn": 1, "mobilenet_v1": 2, "residual_cifar": 3}
_CACHE = {}


def _setup(net):
    """Port and reference (fused graph, float params, int8 model, plans)."""
    if net in _CACHE:
        return _CACHE[net]
    seed = SEEDS[net]
    g_ref = getattr(ref_graph, net)()
    fused_ref = ref_schedule.fuse_dag_priced(g_ref)
    p_ref = ref_nn.init_params(fused_ref, jax.random.PRNGKey(seed))
    g = getattr(graph, net)()
    fused = schedule.fuse_dag_priced(g)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, p_ref), device="cpu")
    rng = np.random.default_rng(seed)
    in_shape = tuple(fused.nodes[0].layer.shape)
    calib = rng.standard_normal((4, *in_shape)).astype(np.float32)
    qm_ref = ref_quantize.quantize_dag(fused_ref, p_ref, jnp.asarray(calib))
    qm = convert.quantized_from_numpy(fused, qm_ref.input_scale, qm_ref.layers,
                                      qm_ref.joins)
    out = dict(fused=fused, params=params, fused_ref=fused_ref, p_ref=p_ref,
               qm=qm, qm_ref=qm_ref, in_shape=in_shape,
               plan=schedule.plan_dag(g), plan_q=schedule.plan_dag(g, io_dtype_bytes=1),
               plan_ref=ref_schedule.plan_dag(g_ref))
    _CACHE[net] = out
    return out


NETS = list(TOL)


@pytest.mark.parametrize("net", NETS)
def test_float_walker_and_executor_match_reference(net):
    s = _setup(net)
    xs = np.random.default_rng(10).standard_normal((3, *s["in_shape"])).astype(np.float32)
    y_ref = np.asarray(ref_nn.forward_dag(s["fused_ref"], s["p_ref"], jnp.asarray(xs)))
    tol = TOL[net]
    y, stats = pingpong.run_batch_dag_with_arena(s["fused"], s["plan"], s["params"],
                                                 torch.from_numpy(xs))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=tol, atol=tol)
    _, _, segs_ref = ref_segments.segments_for_plan(s["fused_ref"], s["plan_ref"])
    assert stats == {"arena_elems": s["plan"].arena_elems,
                     "buffers": len(s["plan"].buffers),
                     **ref_segments.segment_stats(segs_ref), "batch": 3}
    y_w, st = pingpong.run_dag_with_arena(s["fused"], s["plan"], s["params"],
                                          torch.from_numpy(xs[1]))
    np.testing.assert_allclose(y_w.numpy(), y_ref[1], rtol=tol, atol=tol)
    assert st == {"arena_elems": s["plan"].arena_elems, "buffers": len(s["plan"].buffers)}
    assert s["plan"].arena_elems * 4 == ARENA_BYTES[net][0]


@pytest.mark.parametrize("net", NETS)
def test_int8_walker_executor_and_simulator_bit_exact_vs_reference(net):
    s = _setup(net)
    qm, qm_ref, plan_q = s["qm"], s["qm_ref"], s["plan_q"]
    xs = np.random.default_rng(11).standard_normal((3, *s["in_shape"])).astype(np.float32)
    xq = np.array(ref_quantize.quantize_input(qm_ref, jnp.asarray(xs)))
    y_ref = np.asarray(ref_quantize.simulate_int8_dag_forward(qm_ref, jnp.asarray(xq)))
    np.testing.assert_array_equal(
        quantize.quantize_input(qm, torch.from_numpy(xs)).numpy(), xq)
    np.testing.assert_array_equal(
        quantize.simulate_int8_dag_forward(qm, torch.from_numpy(xq)).numpy(), y_ref)
    y, stats = qexec.run_batch_int8_dag_with_arena(qm, plan_q, torch.from_numpy(xq))
    assert y.dtype == torch.int8 and stats["batch"] == 3
    assert stats["arena_bytes"] == ARENA_BYTES[net][1]
    np.testing.assert_array_equal(y.numpy(), y_ref)
    y_w, st = qexec.run_int8_dag_with_arena(qm, plan_q, torch.from_numpy(xq[2]))
    np.testing.assert_array_equal(y_w.numpy(), y_ref[2])
    assert st["arena_bytes"] == plan_q.arena_elems


def test_dag_executor_arena_is_the_plan_and_is_reused():
    s = _setup("mobilenet_v1")
    ex = pingpong.make_dag_executor(s["fused"], s["plan"])
    y1 = ex(s["params"], torch.zeros(5, 3, 64, 64))
    arena = ex.arenas[5]
    assert tuple(arena.shape) == (5, s["plan"].arena_elems)
    assert s["plan"].arena_elems * arena.element_size() == 98304
    y2 = ex(s["params"], torch.ones(5, 3, 64, 64))
    assert ex.arenas[5] is arena and not torch.equal(y1, y2)
    # one image, unbatched: the arena of batch 1
    np.testing.assert_array_equal(ex(s["params"], torch.ones(3, 64, 64)).numpy(),
                                  ex(s["params"], torch.ones(1, 3, 64, 64))[0].numpy())
    assert sorted(ex.arenas) == [1, 5]
    ex8, p8 = qexec.make_int8_executor(s["qm"], s["plan_q"], device="cpu")
    ex8(p8, torch.zeros(2, 3, 64, 64, dtype=torch.int8))
    assert ex8.arenas[2].dtype == torch.int8
    assert tuple(ex8.arenas[2].shape) == (2, 24576)


def test_dag_executor_rejects_bad_plans_and_inputs():
    s = _setup("ds_cnn_kws")
    fused, plan = s["fused"], s["plan"]
    ex = pingpong.make_dag_executor(fused, plan)
    with pytest.raises(ValueError, match="does not match"):
        ex(s["params"], torch.zeros(2, 1, 49, 11))
    bufs = {b.name: b for b in plan.buffers}
    moved = tuple(dataclasses.replace(b, offset_elems=bufs["conv1"].offset_elems)
                  if b.name == "dw1" else b for b in plan.buffers)
    with pytest.raises(ValueError, match="overlaps"):
        pingpong.make_dag_executor(fused, dataclasses.replace(plan, buffers=moved))
    with pytest.raises(ValueError, match="materialized steps"):
        pingpong.make_dag_executor(graph.ds_cnn_kws(), plan)  # not the fused graph
    with pytest.raises(ValueError):
        pingpong.run_batch_dag_with_arena(fused, plan, s["params"], torch.zeros(1, 49, 10))
    with pytest.raises(TypeError):
        qexec.run_batch_int8_dag_with_arena(s["qm"], s["plan_q"],
                                            torch.zeros(2, 1, 49, 10))


def test_relu_views_fold_into_the_depthwise_steps():
    s = _setup("mobilenet_v1")
    mat, order = schedule.check_dag_plan(s["fused"], s["plan"])
    folded = [st.name for st in mat.steps if pingpong.folds_relu(st)]
    assert folded == [f"dw{i}" for i in range(1, 14)]
    calls = []

    def spy(layer, p, xs, out=None, relu=False):
        calls.append((layer.name, relu))
        return pingpong.apply_node(layer, p, xs, out=out, relu=relu)

    ex = pingpong.make_dag_executor(s["fused"], s["plan"], apply_node_fn=spy)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 64, 64))
                         .astype(np.float32))
    y = ex(s["params"], x)
    assert [n for n, r in calls if r] == folded
    y_plain, _ = pingpong.run_batch_dag_with_arena(s["fused"], s["plan"],
                                                   s["params"], x)
    np.testing.assert_array_equal(y.numpy(), y_plain.numpy())


@pytest.mark.parametrize("net", ["ds_cnn_kws", "residual_cifar"])
def test_engine_float_dag_equals_executor(net):
    """One bucket of one: every request runs alone, so the engine's output
    is bit for bit the executor's on that image."""
    s = _setup(net)
    imgs = np.random.default_rng(12).standard_normal((5, *s["in_shape"])).astype(np.float32)
    eng = CNNEngine.from_graph(s["fused"], s["plan"], s["params"], device="cpu",
                               buckets=(1,), policy=CoalescePolicy(max_batch=1))
    assert isinstance(eng.executor, pingpong.DagArenaExecutor)
    with eng:
        reqs, run = eng.serve(imgs)
    assert run.batches == 5
    got = np.stack([r.y for r in reqs])
    direct = pingpong.make_dag_executor(s["fused"], s["plan"])
    for i in range(5):
        np.testing.assert_array_equal(
            got[i], direct(s["params"], torch.from_numpy(imgs[i:i + 1]))[0].numpy())
    y_ref = np.asarray(ref_nn.forward_dag(s["fused_ref"], s["p_ref"], jnp.asarray(imgs)))
    np.testing.assert_allclose(got, y_ref, rtol=TOL[net], atol=TOL[net])


@pytest.mark.parametrize("net", ["mobilenet_v1", "residual_cifar"])
def test_engine_int8_dag_bit_exact_vs_reference(net):
    s = _setup(net)
    xs = np.random.default_rng(13).standard_normal((6, *s["in_shape"])).astype(np.float32)
    xq = np.array(ref_quantize.quantize_input(s["qm_ref"], jnp.asarray(xs)))
    eng = CNNEngine.from_quantized(s["qm"], s["plan_q"], device="cpu", buckets=(1, 2, 4),
                                   policy=CoalescePolicy(max_batch=4, max_wait_s=0.001))
    assert eng.dtype == torch.int8 and eng.executor.arenas[4].dtype == torch.int8
    with eng:
        reqs, _ = eng.serve(xq)
    oracle = np.asarray(ref_quantize.simulate_int8_dag_forward(s["qm_ref"],
                                                               jnp.asarray(xq)))
    np.testing.assert_array_equal(np.stack([r.y for r in reqs]), oracle)
