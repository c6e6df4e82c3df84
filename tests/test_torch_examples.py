"""The repo's user entry points on the port (``examples/torch_*.py``,
``scripts/torch_emit_c_artifacts.py``, ``scripts/torch_obs_report.py``),
run on the CPU with ``--device cpu`` and held to the reference package.

Each file is loaded by path and its ``main`` called at reduced arguments:
it must end with ``ok`` and print one ``kernels:`` line of zeros (the
kernels launch only on a card).  The numbers that do not depend on the
weights — byte tables, plans, segment and MAC counts, the ring plan — are
held to the reference package's own functions on the same graphs (not to
the JAX example scripts).  With the reference's weights and quantized
models carried across (`repro_torch.convert`), the C emitter script writes
the reference emitter's ten files byte for byte, and the serving engine and
the LeNet-5 trainer agree with the reference's forward pass and AdamW.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import contextlib
import importlib.util
import io
import json
import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import export_c as ref_export_c
from repro.core import fusion as ref_fusion
from repro.core import graph as ref_graph
from repro.core import nn as ref_nn
from repro.core import planner as ref_planner
from repro.core import quantize as ref_quantize
from repro.core import schedule as ref_schedule
from repro.core import segments as ref_segments
from repro.core import streaming as ref_streaming
from repro.configs import base as ref_cfgbase
from repro.models.transformer import Model as RefModel
from repro.obs import report as ref_report
from repro.obs.trace import validate_chrome_trace as ref_validate_chrome_trace
from repro.serve.engine import cache_bytes as ref_cache_bytes
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.core import fusion, graph, nn
from repro_torch.data.mnist_synth import make_dataset
from repro_torch.kernels import build, launch_counters

ROOT = Path(__file__).resolve().parents[1]
ZEROS = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0, "nvcc_runs": 0}


def _load(rel: str):
    """The entry point at ``rel`` (from the repo root) as a module."""
    spec = importlib.util.spec_from_file_location(f"entry_{Path(rel).stem}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(rel: str, *args, **kw) -> str:
    """``main([*args, "--device", "cpu"])``'s standard output; it must end
    with ``ok`` after a ``kernels:`` line of zeros.  The counters are the
    process's, so they start this run at 0 (another test file in this
    worker may have ticked them on fake CUDA tensors)."""
    for counter in (*launch_counters().values(), build.NVCC_RUNS):
        counter.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load(rel).main([*args, "--device", "cpu"], **kw)
    lines = out.getvalue().strip().splitlines()
    assert lines[-1] == "ok"
    assert lines[-2].startswith("kernels: ")
    assert json.loads(lines[-2][len("kernels: "):]) == ZEROS
    return out.getvalue()


def _ints(pattern: str, text: str):
    m = re.search(pattern, text)
    assert m, pattern
    return tuple(int(v.replace(",", "")) for v in m.groups())


def test_quickstart_memory_table_is_the_references():
    out = _run("examples/torch_quickstart.py")
    g = ref_graph.lenet5()
    want = (g.param_bytes(4), ref_planner.plan_naive(g).activation_bytes(4),
            ref_planner.plan_fused(g).activation_bytes(4),
            ref_planner.plan_pingpong(g).activation_bytes(4))
    assert want == (246_824, 36_472, 11_256, 8_800)
    got = tuple(_ints(rf"{label}\s+:\s+(\d+) B", out)[0]
                for label in ("params", "naive inter-layer", "fused in-place pool",
                              "ping-pong arena"))
    assert got == want
    assert out.count("matches functional oracle") == 4
    assert "batch 4 through" in out


def test_deploy_microcontroller_tables_are_the_references():
    out = _run("examples/torch_deploy_microcontroller.py", "--steps", "3")
    g = ref_graph.lenet5()
    for name, fn in (("pingpong", ref_planner.plan_pingpong),
                     ("optimal-arena", ref_planner.plan_optimal_arena),
                     ("fused", ref_planner.plan_fused)):
        assert _ints(rf"  {name}\s+(\d+)\s+(\d+)", out) == (
            fn(g, io_dtype_bytes=4).activation_bytes(), fn(g, io_dtype_bytes=1).activation_bytes())
    assert _ints(r"  pingpong\s+(\d+)\s+(\d+)", out) == (8_800, 2_200)
    fused = ref_fusion.fuse(g)
    segs = ref_segments.segment_stats(ref_segments.sequential_segments(fused))["segments"]
    arena = ref_planner.plan_pingpong(g, io_dtype_bytes=1).arena_elems
    assert _ints(r"bit-exact vs simulator \((\d+) segments, arena (\d+) B\)", out) == (segs, arena)
    assert "C engine matches the cpu arena executor on 8/8 inputs" in out


def test_lenet_trainer_takes_the_reference_weights_and_matches_its_adamw():
    """Two AdamW steps of the port's trainer against the reference's
    optimizer from the same weights on the same batches (the reference
    example's recipe; the digits are the reference's, array for array,
    ``tests/test_torch_export_c.py``)."""
    mod = _load("examples/torch_deploy_microcontroller.py")
    g_ref = ref_graph.lenet5()
    p_np = {k: {kk: v.numpy() for kk, v in p.items()} for k, p in nn.init_params(
        graph.lenet5(), torch.Generator().manual_seed(3), device="cpu").items()}
    steps = 2
    with contextlib.redirect_stdout(io.StringIO()):
        _, params = mod.train_lenet(steps, torch.device("cpu"),
                                    params=convert.params_from_numpy(p_np, device="cpu"))
    p_ref = jax.tree.map(jnp.asarray, p_np)
    imgs, labels = make_dataset(4096, seed=0)
    acfg = ref_opt.AdamWConfig(lr_peak=2e-3, warmup_steps=20, total_steps=steps,
                               weight_decay=0.0)
    state = ref_opt.init_state(p_ref)

    def loss_fn(p, x, y):
        logits = jax.vmap(lambda im: ref_nn.forward(g_ref, p, im))(x)
        return jnp.mean(jax.nn.logsumexp(logits, -1)
                        - jnp.take_along_axis(logits, y[:, None], 1)[:, 0])

    grad = jax.jit(jax.grad(loss_fn))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        idx = rng.integers(0, len(imgs), 32)
        grads = grad(p_ref, jnp.asarray(imgs[idx]), jnp.asarray(labels[idx]))
        p_ref, state, _ = ref_opt.apply_adamw(acfg, p_ref, grads, state)
    for name, p in params.items():
        for k, v in p.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(p_ref[name][k]),
                                       rtol=1e-5, atol=1e-6)


def test_deploy_ds_cnn_plans_are_the_references():
    out = _run("examples/torch_deploy_ds_cnn.py")
    g = ref_graph.ds_cnn()
    want = {"naive": ref_planner.plan_naive(g.to_sequential(), io_dtype_bytes=1),
            "ping-pong": ref_planner.plan_pingpong(g, io_dtype_bytes=1),
            "reordered": ref_schedule.plan_dag(g, io_dtype_bytes=1),
            "CMSIS-NN baseline": ref_planner.plan_cmsis_baseline(g)}
    for name, plan in want.items():
        assert _ints(rf"  {name}\s+(\d+) B", out) == (plan.activation_bytes(),)
    assert _ints(r"  reordered\s+(\d+) B", out) == (16_000,)
    assert _ints(r"  CMSIS-NN baseline\s+(\d+) B", out) == (18_304,)
    plan_q = want["reordered"]
    _, _, segs = ref_segments.segments_for_plan(ref_fusion.fuse_dag(g), plan_q)
    assert _ints(r"bit-exact vs simulator \((\d+) segments, arena (\d+) B\)", out) == (
        len(segs), plan_q.arena_bytes)
    assert "ds_cnn_q8:  C bit-exact vs int8 simulator" in out


def test_plan_residual_dag_orders_and_arenas_are_the_references():
    out = _run("examples/torch_plan_residual_dag.py")
    g = ref_graph.residual_cifar()
    mat = ref_schedule.materialize_dag(ref_fusion.fuse_dag(g))
    naive = ref_schedule.naive_order(mat)
    best, _ = ref_schedule.search_order(mat)
    assert f"naive order     : {' -> '.join(naive[1:6])} ..." in out
    assert f"reordered       : {' -> '.join(best[1:6])} ..." in out
    want = (ref_schedule.plan_dag(g, order=naive, io_dtype_bytes=1).arena_bytes,
            ref_schedule.plan_dag(g, io_dtype_bytes=1).arena_bytes)
    assert want == (9_216, 8_192)
    assert _ints(r"naive (\d+) B, reordered (\d+) B", out) == want
    assert "q8: bit-exact vs the cpu simulator" in out


def test_serve_cnn_runs_and_its_engine_takes_the_reference_weights():
    out = _run("examples/torch_serve_cnn.py", "--requests", "8")
    assert out.count("ladder (1, 2, 4, 8)") == 2
    mod = _load("examples/torch_serve_cnn.py")
    g = ref_graph.lenet5()
    p_ref = ref_nn.init_params(g, jax.random.PRNGKey(0))
    fused = ref_fusion.fuse(g)
    xs = np.random.default_rng(0).standard_normal((8, 1, 32, 32)).astype(np.float32)
    want = np.stack([np.asarray(ref_nn.forward(fused, ref_fusion.rename_params(fused, p_ref),
                                               jnp.asarray(x))) for x in xs])
    engine = mod.build_lenet_engine(torch.device("cpu"), buckets=(1, 8), params=convert
                                    .params_from_numpy(jax.tree.map(np.asarray, p_ref),
                                                       device="cpu"))
    with engine:
        reqs, _ = engine.serve(xs)
    np.testing.assert_allclose(np.stack([r.y for r in reqs]), want, rtol=1e-5, atol=1e-6)


def test_stream_kws_ring_plan_is_the_references():
    out = _run("examples/torch_stream_kws.py")
    mod = _load("examples/torch_stream_kws.py")
    g = ref_graph.ds_cnn()
    splan = ref_streaming.plan_streaming(g, io_dtype_bytes=1)
    rings = mod.ring_lines(splan)
    assert len(rings) == 9
    assert "\n".join(rings) in out
    assert f"head (full recompute)  : {' -> '.join(splan.head)}" in out
    assert _ints(r"ring arena\s+: (\d+) B int8 \(emit every (\d+) frames\)", out) == (
        splan.plan.arena_bytes, splan.emit_stride)
    cost = ref_report.streaming_report(g, splan)
    assert _ints(r"full window : ([\d,]+) MACs", out) == (cost["full_window_macs"],)
    assert _ints(r"streaming   : ([\d,]+) MACs/emission = ([\d,]+) MACs/frame", out) == (
        cost["per_emission_macs"], cost["per_frame_macs"])
    assert "final emissions bit-exact vs full-window int8 simulator" in out


def test_trace_serving_writes_a_trace_the_reference_accepts(tmp_path):
    out = _run("examples/torch_trace_serving.py", "--requests", "16", "--out", str(tmp_path))
    assert "served 16 requests" in out
    trace = json.loads((tmp_path / "serving_trace.json").read_text())
    ref_validate_chrome_trace(trace)
    assert any(e.get("name") == "device" for e in trace["traceEvents"])
    assert json.loads((tmp_path / "serving_metrics.json").read_text())


def test_serve_llm_serves_every_request_over_the_references_kv_arena():
    out = _run("examples/torch_serve_llm.py", "--requests", "3", "--max-new", "4")
    assert "served 3/3 requests" in out
    mod = _load("examples/torch_serve_llm.py")
    cfg = mod.small_lm()
    ref_cfg = ref_cfgbase.ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "block_pattern", "mlp_act", "norm", "tie_embeddings")})
    kv = ref_cache_bytes(RefModel(ref_cfg).init_cache(4, 128))
    assert f"planned KV/state arena: {kv / 1e6:.2f} MB" in out


def test_train_llm_checkpoints_resumes_and_cleans_up(tmp_path, monkeypatch):
    args = ("--seq", "32", "--batch", "4", "--ckpt-dir", str(tmp_path / "ckpt"))
    out = _run("examples/torch_train_llm.py", "--steps", "3", *args)
    assert "finished at step 3" in out
    out = _run("examples/torch_train_llm.py", "--steps", "5", *args)
    assert "[loop] resumed from step 3" in out and "finished at step 5" in out
    # without --ckpt-dir the checkpoints go to a temporary directory, removed at exit
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    _run("examples/torch_train_llm.py", "--steps", "2", "--seq", "32", "--batch", "4")
    assert list((tmp_path / "tmp").iterdir()) == []


def test_emit_c_artifacts_is_byte_equal_to_the_reference_emitter(tmp_path):
    """Weights and calibration batches drawn once, as numpy; the reference
    quantizes them, and its models are carried across (the port's own
    calibration agrees with the reference's to 1e-5, not to the bit)."""
    mod = _load("scripts/torch_emit_c_artifacts.py")
    weights, want = {}, {}
    for net, (ctor, dag, seed, calib_seed, in_shape, f32, q8) in mod.NETS.items():
        g_ref = (ref_graph.mobilenet_v1(width=0.25) if ctor == "mobilenet_v1"
                 else getattr(ref_graph, ctor)())
        g = mod._graph(ctor)
        fused_ref = ref_fusion.fuse_dag(g_ref) if dag else ref_fusion.fuse(g_ref)
        fused = fusion.fuse_dag(g) if dag else fusion.fuse(g)
        p_np = {k: {kk: v.numpy() for kk, v in p.items()} for k, p in
                nn.init_params(fused, torch.Generator().manual_seed(100 + seed),
                               device="cpu").items()}
        calib = None
        if f32:
            plan = ref_schedule.plan_dag(g_ref) if dag else ref_planner.plan_pingpong(g_ref)
            emit = ref_export_c.generate_c_dag if dag else ref_export_c.generate_c
            want[f"{f32}.c"] = emit(fused_ref, plan, p_np, with_main=True)
        if q8:
            x = np.random.default_rng(100 + calib_seed).standard_normal(
                (4, *in_shape)).astype(np.float32)
            quantizer = ref_quantize.quantize_dag if dag else ref_quantize.quantize
            qm_ref = quantizer(fused_ref, p_np, jnp.asarray(x))
            calib = convert.quantized_from_numpy(fused, qm_ref.input_scale, qm_ref.layers,
                                                 qm_ref.joins)
            if dag:
                want[f"{q8}.c"] = ref_export_c.generate_c_int8_dag(
                    qm_ref, ref_schedule.plan_dag(g_ref, io_dtype_bytes=1), with_main=True)
            else:
                want[f"{q8}.c"] = ref_export_c.generate_c_int8(
                    qm_ref, ref_planner.plan_pingpong(g_ref, io_dtype_bytes=1), with_main=True)
        weights[net] = (p_np, calib)
    assert len(want) == 10
    out = _run("scripts/torch_emit_c_artifacts.py", "--out", str(tmp_path), weights=weights)
    assert out.count("emitted + compiled") == 10
    for name, src in want.items():
        assert (tmp_path / name).read_text() == src, name
        assert (tmp_path / name).with_suffix("").exists()


def test_obs_report_ds_cnn_int8_is_the_references(tmp_path):
    out = _run("scripts/torch_obs_report.py", "ds_cnn", "--int8", "--out", str(tmp_path))
    g = ref_graph.ds_cnn()
    plan = ref_schedule.plan_dag(g, io_dtype_bytes=1)
    seg = ref_report.segment_report(ref_fusion.fuse_dag(g), plan)
    arena = ref_report.arena_timeline(plan)
    assert (seg["total_macs"], arena["peak_bytes"]) == (2_539_840, 16_000)
    assert _ints(r"ds_cnn\.int8: (\d+) segments, (\d+) MACs, arena (\d+) B \(peak ok\)",
                 out) == (seg["n_segments"], seg["total_macs"], arena["arena_bytes"])
    summary = json.loads((tmp_path / "obs_report.json").read_text())["ds_cnn.int8"]
    assert (summary["total_macs"], summary["arena_bytes"]) == (2_539_840, 16_000)
    ref_validate_chrome_trace(json.loads((tmp_path / "ds_cnn.int8.trace.json").read_text()))
    assert (tmp_path / "ds_cnn.int8.arena.txt").read_text().strip()


@pytest.mark.parametrize("rel", sorted(
    [p.relative_to(ROOT).as_posix() for p in (ROOT / "examples").glob("torch_*.py")]
    + [p.relative_to(ROOT).as_posix() for p in (ROOT / "scripts").glob("torch_*.py")
       if p.stem in ("torch_emit_c_artifacts", "torch_obs_report")]))
def test_entry_point_finds_src_from_its_own_path(rel):
    """Each entry point puts ``src/`` on ``sys.path`` from its own file, not
    from the working directory, and offers ``--device``."""
    text = (ROOT / rel).read_text()
    assert 'Path(__file__).resolve()' in text and '"--device", default="cuda"' in text
    assert 'sys.path.insert(0, "src")' not in text
