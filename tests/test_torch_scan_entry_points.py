"""The compiled single-image entry points of the main path under the
reference's names, on the CPU: ``pingpong.run_with_arena_scan``,
``run_dag_with_arena_scan`` and ``aot_compile``, and ``quant.exec``'s
``make_int8_scan_executor``, ``run_int8_with_arena_scan`` and
``run_int8_dag_with_arena_scan``.

Each is held against the reference's function of the same name on the
same inputs (the reference's weights and quantized models carried across
through numpy, ``repro_torch.convert``): LeNet-5 f32 and the §5 CIFAR net
in int8 (sequential), DS-CNN-KWS in f32 and int8 (DAG).  Int8 outputs are
bit-exact, f32 within 1e-5; each also equals the port's walker (int8 bit
for bit, f32 within 1e-5), and ``stats`` equals the reference's dict.  The
contracts of ``tests/test_hotpaths.py``, ``tests/test_quant_exec.py`` and
``tests/test_dag_schedule.py``: a second call reuses the cached executor's
arena; ``make_int8_scan_executor`` raises ``TypeError`` on an f32 input;
``aot_compile``'s callable equals the executor and raises on another
shape.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dag_exec import _setup as dag_setup
from test_torch_exec import _reference_float, _reference_int8

from repro.core import pingpong as ref_pingpong
from repro.core import planner as ref_planner
from repro.core import graph as ref_graph
from repro.quant import exec as ref_qexec
from repro_torch.core import graph, pingpong, planner
from repro_torch.quant import exec as qexec

TOL = 1e-5


def test_run_with_arena_scan_lenet_f32():
    fused, params, fused_ref, p_ref = _reference_float("lenet5", 0)
    plan = planner.plan_pingpong(graph.lenet5())
    plan_ref = ref_planner.plan_pingpong(ref_graph.lenet5())
    x = np.random.default_rng(2).standard_normal((1, 32, 32)).astype(np.float32)
    y_ref, stats_ref = ref_pingpong.run_with_arena_scan(fused_ref, plan_ref, p_ref,
                                                        jnp.asarray(x))
    y, stats = pingpong.run_with_arena_scan(fused, plan, params, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=TOL, atol=TOL)
    assert stats == stats_ref
    y_w, _ = pingpong.run_with_arena(fused, plan, params, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_w.numpy(), rtol=TOL, atol=TOL)
    # a second call goes through the cached executor and its arena
    ex = pingpong._cached_executor(fused, plan)
    arena = ex.arenas[1]
    y2, _ = pingpong.run_with_arena_scan(fused, plan, params, torch.from_numpy(x))
    assert ex.arenas[1] is arena and torch.equal(y2, y)


def test_run_int8_with_arena_scan_cifar_bit_exact():
    qm, qm_ref, rng = _reference_int8("cifar_testnet", seed=0)
    plan = planner.plan_pingpong(graph.cifar_testnet(), io_dtype_bytes=1)
    plan_ref = ref_planner.plan_pingpong(ref_graph.cifar_testnet(), io_dtype_bytes=1)
    x = rng.standard_normal(qm.graph.shapes()[0]).astype(np.float32)
    from repro.core import quantize as ref_quantize
    xq = np.array(ref_quantize.quantize_input(qm_ref, jnp.asarray(x)))
    y_ref, stats_ref = ref_qexec.run_int8_with_arena_scan(qm_ref, plan_ref, jnp.asarray(xq))
    y, stats = qexec.run_int8_with_arena_scan(qm, plan, torch.from_numpy(xq))
    assert y.dtype == torch.int8
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    assert stats == stats_ref
    y_w, _ = qexec.run_int8_with_arena(qm, plan, torch.from_numpy(xq))
    assert torch.equal(y, y_w)

    run = qexec.make_int8_scan_executor(qm, plan, donate_input=True, device="cpu")
    assert torch.equal(run(torch.from_numpy(xq)), y)
    with pytest.raises(TypeError):
        run(torch.from_numpy(x))
    with pytest.raises(TypeError):
        qexec.run_int8_with_arena_scan(qm, plan, torch.from_numpy(x))


def test_dag_scan_entry_points_ds_cnn_kws_f32_and_int8():
    s = dag_setup("ds_cnn_kws")
    x = np.random.default_rng(12).standard_normal(s["in_shape"]).astype(np.float32)
    y_ref, stats_ref = ref_pingpong.run_dag_with_arena_scan(s["fused_ref"], s["plan_ref"],
                                                            s["p_ref"], jnp.asarray(x))
    y, stats = pingpong.run_dag_with_arena_scan(s["fused"], s["plan"], s["params"],
                                                torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=TOL, atol=TOL)
    assert stats == stats_ref
    y_w, _ = pingpong.run_dag_with_arena(s["fused"], s["plan"], s["params"],
                                         torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_w.numpy(), rtol=TOL, atol=TOL)

    from repro.core import quantize as ref_quantize
    from repro.core import schedule as ref_schedule
    qm, qm_ref = s["qm"], s["qm_ref"]
    plan_q_ref = ref_schedule.plan_dag(ref_graph.ds_cnn_kws(), io_dtype_bytes=1)
    xq = np.array(ref_quantize.quantize_input(qm_ref, jnp.asarray(x)))
    yq_ref, qstats_ref = ref_qexec.run_int8_dag_with_arena_scan(qm_ref, plan_q_ref,
                                                                jnp.asarray(xq))
    yq, qstats = qexec.run_int8_dag_with_arena_scan(qm, s["plan_q"], torch.from_numpy(xq))
    np.testing.assert_array_equal(yq.numpy(), np.asarray(yq_ref))
    assert qstats == qstats_ref
    yq_w, _ = qexec.run_int8_dag_with_arena(qm, s["plan_q"], torch.from_numpy(xq))
    assert torch.equal(yq, yq_w)
    with pytest.raises(TypeError):
        qexec.run_int8_dag_with_arena_scan(qm, s["plan_q"], torch.from_numpy(x))


def test_aot_compile_prepares_the_arena_and_raises_on_another_shape():
    fused, params, fused_ref, p_ref = _reference_float("lenet5", 0)
    plan = planner.plan_pingpong(graph.lenet5())
    fn = pingpong.make_scan_executor(fused, plan)
    compiled = pingpong.aot_compile(fn, params, (4, 1, 32, 32), torch.float32)
    assert set(fn.arenas) == {4}  # allocated before the first request
    arena = fn.arenas[4]
    x = np.random.default_rng(3).standard_normal((4, 1, 32, 32)).astype(np.float32)
    y = compiled(params, torch.from_numpy(x))
    assert fn.arenas[4] is arena
    assert torch.equal(y, fn(params, torch.from_numpy(x)))
    ref_fn = ref_pingpong.make_scan_executor(
        fused_ref, ref_planner.plan_pingpong(ref_graph.lenet5()))
    ref_compiled = ref_pingpong.aot_compile(ref_fn, p_ref, (4, 1, 32, 32), jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_compiled(p_ref, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    with pytest.raises(TypeError):
        compiled(params, torch.from_numpy(x[:2]))
    with pytest.raises(TypeError):
        compiled(params, torch.from_numpy(x).double())

    # an int8 executor (the DAG one, K4's path on a card) likewise
    s = dag_setup("ds_cnn_kws")
    ex, qparams = qexec.make_int8_executor(s["qm"], s["plan_q"], device="cpu")
    qcompiled = pingpong.aot_compile(ex, qparams, (2, *s["in_shape"]), torch.int8)
    xq = torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, (2, *s["in_shape"])).astype(np.int8))
    assert torch.equal(qcompiled(qparams, xq), ex(qparams, xq))
    with pytest.raises(TypeError):
        qcompiled(qparams, xq[:1])
