"""The port's streaming keyword spotting against the reference, on the CPU.

Weights go across with ``repro_torch.convert``; calibration batches and
frames come from seeded numpy generators.  Held:

* ``plan_streaming`` on ``ds_cnn`` and ``ds_cnn_kws`` at 1 and 4 bytes:
  every ``RingSpec`` field, the emit stride, the head and the plan's
  buffers (names, banks, bytes, offsets) equal the reference's;
  ``verify_plan`` passes and the timeline's peak is the arena;
* the f32 step against the JAX ``StreamingExecutor`` and the port's own
  sliding oracle at every frame, warm-up included (``ds_cnn`` and seeded
  random chains), at ``tests/test_streaming.py``'s 1e-4;
* the int8 step bit-exact against the JAX int8 streaming executor and the
  sliding oracle on ``simulate_int8_dag_forward``;
* ``run`` equal to repeated ``step``, ``aot_step`` equal to ``step``;
* ``StreamServer``: interleaved streams isolated, implicit ``open``,
  ``peek``, ``close``, a second ``open`` raising, the default device
  raising here;
* ``PosteriorSmoother`` against the reference's, both modes, and its
  argument errors; ``streaming_report`` equal to the reference's;
* on fake CUDA tensors, an int8 emission's first depthwise row block goes
  to K4's launch and raises here, never to the plain version.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import graph as ref_graph
from repro.core import nn as ref_nn
from repro.core import quantize as ref_quantize
from repro.core import streaming as ref_streaming
from repro.obs import report as ref_report
from repro.quant import exec as ref_qexec
from repro_torch import convert
from repro_torch.core import graph, nn, quantize, streaming
from repro_torch.core.planner import verify_plan
from repro_torch.kernels import build
from repro_torch.kernels.conv_pool import depthwise
from repro_torch.obs import report
from repro_torch.quant import exec as qexec
from repro_torch.quant import kernel_q8
from repro_torch.serve.cnn_engine import StreamServer

TOL = 1e-4  # tests/test_streaming.py:157
NETS = ("ds_cnn", "ds_cnn_kws")
_CACHE = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _net(name, seed=0):
    """Port and reference (graph, f32 params, int8 model) for a KWS net; the
    reference's weights and quantized model carried across."""
    key = (name, seed)
    if key not in _CACHE:
        g_ref = getattr(ref_graph, name)()
        p_ref = ref_nn.init_params(g_ref.to_sequential(), jax.random.PRNGKey(seed))
        calib = np.random.default_rng(seed).standard_normal((4, 1, 49, 10)).astype(np.float32)
        qm_ref = ref_quantize.quantize_dag(g_ref, p_ref, jnp.asarray(calib))
        g = getattr(graph, name)()
        params = convert.params_from_numpy(_np(p_ref), device="cpu")
        qm = convert.quantized_from_numpy(g, qm_ref.input_scale, qm_ref.layers, qm_ref.joins)
        _CACHE[key] = dict(g=g, params=params, qm=qm, g_ref=g_ref, p_ref=p_ref,
                           qm_ref=qm_ref)
    return _CACHE[key]


def random_stream_chain(seed: int, G):
    """``tests/test_streaming.py::random_stream_chain`` over the layer
    classes of module ``G`` (the port's graph module or the reference's):
    the same draws give the same chain and frames in both."""
    rng = np.random.default_rng(seed)
    c, h, w = int(rng.integers(1, 4)), int(rng.integers(10, 17)), 6
    layers = [G.Input(shape=(c, h, w), name="input")]
    ch, hh, ww = c, h, w
    for i in range(int(rng.integers(1, 4))):
        kind = rng.choice(["conv", "dw", "pool"])
        if kind == "conv":
            k = int(rng.choice([1, 3]))
            s = int(rng.choice([1, 2]))
            p = int(rng.integers(0, k))
            oc = int(rng.integers(2, 6))
            layer = G.Conv2d(ch, oc, kernel_size=k, stride=s, padding=p, name=f"conv{i}")
        elif kind == "dw":
            k, s = 3, 1
            p = int(rng.integers(0, 2))
            oc = ch
            layer = G.DepthwiseConv2d(ch, kernel_size=k, stride=s, padding=p, name=f"dw{i}")
        else:
            k = int(rng.choice([2, 3]))
            s = int(rng.choice([1, 2]))
            p = 0
            oc = ch
            layer = G.MaxPool2d(kernel_size=k, stride=s, name=f"pool{i}")
        oh = (hh + 2 * p - k) // s + 1
        ow = (ww + 2 * p - k) // s + 1
        if oh < 2 or ow < 1:
            break
        layers.append(layer)
        if kind != "pool" and rng.random() < 0.7:
            layers.append(G.ReLU(name=f"relu{i}"))
        ch, hh, ww = oc, oh, ow
    layers += [G.Flatten(name="flatten"), G.Linear(ch * hh * ww, 4, name="fc")]
    g = G.SequentialGraph(layers)
    g.validate()
    n_frames = int(rng.integers(5, 11))
    frames = np.asarray(rng.standard_normal((n_frames, c, w)), np.float32)
    return g, frames


def _int8_oracle(qm):
    return lambda _, w: quantize.simulate_int8_dag_forward(qm, w)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

PINS = {  # (rows, top, bottom, int8 arena B, int8 state B, f32 arena B, f32 state B)
    "ds_cnn": ([23, 21, 21, 19, 19, 17, 17, 15, 15], [1, 2, 2, 3, 3, 4, 4, 5, 5],
               [1, 2, 2, 3, 3, 4, 4, 5, 5], 65450, 53930, 261800, 215720),
    "ds_cnn_kws": ([20, 18, 18, 16, 16, 14, 14, 12, 12], [3, 4, 4, 5, 5, 6, 6, 7, 7],
                   [2, 3, 3, 4, 4, 5, 5, 6, 6], 57770, 45290, 231080, 181160),
}


@pytest.mark.parametrize("db", [1, 4])
@pytest.mark.parametrize("name", NETS)
def test_plan_streaming_equals_the_reference(name, db):
    s = _net(name)
    splan = streaming.plan_streaming(s["g"], io_dtype_bytes=db)
    ref = ref_streaming.plan_streaming(s["g_ref"], io_dtype_bytes=db)
    assert splan.in_shape == ref.in_shape
    assert splan.emit_stride == ref.emit_stride == 2
    assert splan.head == ref.head == ("pool", "fc")
    assert ([vars(r) for r in splan.rings] == [vars(r) for r in ref.rings])
    assert splan.ring_elems == ref.ring_elems
    p, rp = splan.plan, ref.plan
    assert (p.strategy, p.arena_elems, p.scratch_elems, p.param_elems, p.io_dtype_bytes) == \
        (rp.strategy, rp.arena_elems, rp.scratch_elems, rp.param_elems, rp.io_dtype_bytes)
    assert [vars(b) for b in p.buffers] == [vars(b) for b in rp.buffers]
    assert {b.bank for b in p.buffers} == {"ring", "stream"}
    verify_plan(p)
    tl = report.arena_timeline(p)
    assert tl["peak_bytes"] == tl["arena_bytes"] == p.arena_bytes
    rows, top, bottom, a8, s8, a32, s32 = PINS[name]
    assert [r.rows for r in splan.rings] == rows
    assert [r.top for r in splan.rings] == top
    assert [r.bottom for r in splan.rings] == bottom
    assert all(r.new_rows == 1 for r in splan.rings)
    assert (p.arena_bytes, splan.ring_elems * db) == ((a8, s8) if db == 1 else (a32, s32))


@pytest.mark.parametrize("seed", range(6))
def test_plan_streaming_random_chains_equal_the_reference(seed):
    g, _ = random_stream_chain(seed, graph)
    g_ref, _ = random_stream_chain(seed, ref_graph)
    splan = streaming.plan_streaming(g)
    ref = ref_streaming.plan_streaming(g_ref)
    verify_plan(splan.plan)
    assert [vars(r) for r in splan.rings] == [vars(r) for r in ref.rings]
    assert [vars(b) for b in splan.plan.buffers] == [vars(b) for b in ref.plan.buffers]
    assert (splan.emit_stride, splan.head) == (ref.emit_stride, ref.head)


@pytest.mark.parametrize("name", NETS)
def test_streaming_report_equals_the_reference(name):
    s = _net(name)
    for db in (1, 4):
        got = report.streaming_report(s["g"], streaming.plan_streaming(s["g"], io_dtype_bytes=db))
        want = ref_report.streaming_report(
            s["g_ref"], ref_streaming.plan_streaming(s["g_ref"], io_dtype_bytes=db))
        assert got == want
    got = report.streaming_report(s["g"])
    if name == "ds_cnn":
        assert (got["full_window_macs"], got["per_emission_macs"], got["per_frame_macs"]) == \
            (2539840, 775360, 387680)
        assert got["per_frame_frac"] == 0.1526
    else:
        assert (got["full_window_macs"], got["per_emission_macs"], got["per_frame_macs"]) == \
            (2656768, 1105408, 552704)
        assert got["per_frame_frac"] == 0.208


# ---------------------------------------------------------------------------
# f32: the JAX executor and the sliding oracle, every frame
# ---------------------------------------------------------------------------


def _check_f32(g, params, g_ref, p_ref, frames):
    ex = streaming.make_streaming_executor(g, device="cpu")
    ex_ref = ref_streaming.make_streaming_executor(g_ref)
    state, state_ref = ex.init_state(params), ex_ref.init_state(p_ref)
    oracle, oracle_em = streaming.sliding_window_reference(g, params, frames, device="cpu")
    for t in range(frames.shape[0]):
        state, out, em = ex.step(params, state, torch.from_numpy(frames[t]))
        state_ref, out_ref, em_ref = ex_ref.step(p_ref, state_ref, jnp.asarray(frames[t]))
        assert isinstance(em, bool) and em == bool(em_ref) == bool(oracle_em[t])
        np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out.numpy(), oracle[t], rtol=TOL, atol=TOL)


def test_streaming_f32_matches_jax_and_oracle_ds_cnn():
    s = _net("ds_cnn")
    frames = np.random.default_rng(2).standard_normal((9, 1, 10)).astype(np.float32)
    _check_f32(s["g"], s["params"], s["g_ref"], s["p_ref"], frames)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_f32_random_chains_match_jax_and_oracle(seed):
    g, frames = random_stream_chain(seed, graph)
    g_ref, _ = random_stream_chain(seed, ref_graph)
    p_ref = ref_nn.init_params(g_ref, jax.random.PRNGKey(seed))
    params = convert.params_from_numpy(_np(p_ref), device="cpu")
    _check_f32(g, params, g_ref, p_ref, frames)


# ---------------------------------------------------------------------------
# int8: bit-exact
# ---------------------------------------------------------------------------


def _check_int8(qm, qm_ref, g, frames_f):
    ex, qp = qexec.make_int8_streaming_executor(qm, device="cpu")
    ex_ref, qp_ref = ref_qexec.make_int8_streaming_executor(qm_ref)
    assert ex.dtype == torch.int8
    frames_q = np.array(ref_quantize.quantize_input(qm_ref, jnp.asarray(frames_f)))
    np.testing.assert_array_equal(
        quantize.quantize_input(qm, torch.from_numpy(frames_f)).numpy(), frames_q)
    oracle, oracle_em = streaming.sliding_window_reference(
        g, None, frames_q, forward_fn=_int8_oracle(qm), device="cpu")
    state, state_ref = ex.init_state(qp), ex_ref.init_state(qp_ref)
    np.testing.assert_array_equal(state["out"].numpy(), np.asarray(state_ref["out"]))
    for t in range(frames_q.shape[0]):
        state, out, em = ex.step(qp, state, torch.from_numpy(frames_q[t]))
        state_ref, out_ref, em_ref = ex_ref.step(qp_ref, state_ref, jnp.asarray(frames_q[t]))
        assert em == bool(em_ref) == bool(oracle_em[t])
        assert out.dtype == torch.int8
        np.testing.assert_array_equal(out.numpy(), np.asarray(out_ref))
        np.testing.assert_array_equal(out.numpy(), oracle[t])
        for name, ring in state["rings"].items():
            np.testing.assert_array_equal(ring.numpy(), np.asarray(state_ref["rings"][name]))


@pytest.mark.parametrize("name", NETS)
def test_streaming_int8_bit_exact_vs_jax_and_oracle(name):
    s = _net(name)
    frames = np.random.default_rng(4).standard_normal((9, 1, 10)).astype(np.float32)
    _check_int8(s["qm"], s["qm_ref"], s["g"], frames)


@pytest.mark.parametrize("seed", [3, 5])
def test_streaming_int8_random_chains_bit_exact(seed):
    g, frames = random_stream_chain(seed, graph)
    g_ref, _ = random_stream_chain(seed, ref_graph)
    dag_ref = ref_graph.DAGGraph.from_sequential(g_ref)
    p_ref = ref_nn.init_params(g_ref, jax.random.PRNGKey(seed))
    calib = np.random.default_rng(seed + 1).standard_normal(
        tuple(g.layers[0].shape)).astype(np.float32)
    qm_ref = ref_quantize.quantize_dag(dag_ref, p_ref, jnp.asarray(calib))
    qm = convert.quantized_from_numpy(graph.DAGGraph.from_sequential(g),
                                      qm_ref.input_scale, qm_ref.layers, qm_ref.joins)
    _check_int8(qm, qm_ref, qm.graph, frames)


# ---------------------------------------------------------------------------
# run, aot_step
# ---------------------------------------------------------------------------


def test_run_equals_repeated_step():
    s = _net("ds_cnn")
    ex = streaming.make_streaming_executor(s["g"], device="cpu")
    frames = np.random.default_rng(3).standard_normal((8, 1, 10)).astype(np.float32)
    _, outs, em = ex.run(s["params"], ex.init_state(s["params"]), frames)
    assert em.dtype == bool and em.tolist() == [False, True] * 4
    state = ex.init_state(s["params"])
    for t in range(8):
        state, out, e = ex.step(s["params"], state, torch.from_numpy(frames[t]))
        assert e == em[t]
        assert torch.equal(outs[t], out)


def test_int8_aot_step_equals_step():
    s = _net("ds_cnn_kws")
    ex, qp = qexec.make_int8_streaming_executor(s["qm"], device="cpu")
    aot = ex.aot_step(qp)
    frames = quantize.quantize_input(
        s["qm"], torch.from_numpy(np.random.default_rng(5).standard_normal((4, 1, 10))
                                  .astype(np.float32)))
    s1, s2 = ex.init_state(qp), ex.init_state(qp)
    for t in range(4):
        s1, o1, e1 = ex.step(qp, s1, frames[t])
        s2, o2, e2 = aot(qp, s2, frames[t])
        assert e1 == e2
        assert torch.equal(o1, o2)


# ---------------------------------------------------------------------------
# StreamServer
# ---------------------------------------------------------------------------


def test_stream_server_multi_stream_isolation():
    s = _net("ds_cnn")
    qm = s["qm"]
    srv = StreamServer.from_quantized(qm, device="cpu")
    assert srv.prewarm_s > 0
    assert srv.metrics.value("stream.prewarm_s") == srv.prewarm_s
    rng = np.random.default_rng(6)
    frames = {sid: quantize.quantize_input(qm, torch.from_numpy(
        rng.standard_normal((6, 1, 10)).astype(np.float32))).numpy() for sid in "ab"}
    srv.open("a")
    srv.open("b")
    got = {"a": [], "b": []}
    for t in range(6):  # interleaved pushes must not cross-contaminate
        for sid in "ab":
            got[sid].append(srv.push(sid, frames[sid][t]))
    for sid in "ab":
        ref_outs, ref_em = streaming.sliding_window_reference(
            s["g"], None, frames[sid], forward_fn=_int8_oracle(qm), device="cpu")
        for t in range(6):
            if ref_em[t]:
                assert got[sid][t].dtype == np.int8
                np.testing.assert_array_equal(got[sid][t], ref_outs[t])
            else:
                assert got[sid][t] is None
        np.testing.assert_array_equal(srv.peek(sid), ref_outs[5])
    assert set(srv.streams) == {"a", "b"}
    np.testing.assert_array_equal(srv.close("a"), got["a"][5])
    assert srv.streams == ("b",)
    assert [srv.metrics.value(f"stream.{k}") for k in
            ("opened", "frames", "emissions", "closed")] == [2, 12, 6, 1]


def test_stream_server_implicit_open_and_peek():
    s = _net("ds_cnn")
    srv = StreamServer.from_graph(s["g"], s["params"], prewarm=False, device="cpu")
    assert srv.prewarm_s == 0.0
    frame = np.zeros((1, 10), np.float32)
    assert srv.push("s", frame) is None  # implicit open; frame 1 of E=2
    assert srv.streams == ("s",)
    held = srv.peek("s")  # the zero window's head output before an emission
    assert held.shape == (12,)
    out = srv.push("s", frame)
    assert out is not None
    np.testing.assert_allclose(out, held, rtol=TOL, atol=TOL)  # still all zeros
    with pytest.raises(ValueError):
        srv.open("s")


def test_stream_server_default_device_and_cache_dir(tmp_path, monkeypatch):
    s = _net("ds_cnn")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            StreamServer.from_quantized(s["qm"])
        with pytest.raises(RuntimeError, match="cuda"):
            StreamServer.from_graph(s["g"], s["params"])
        with pytest.raises(RuntimeError, match="cuda"):
            streaming.make_streaming_executor(s["g"])
    # persistent_cache_dir= keeps the kernels built in that directory
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_LOADED", {})
    StreamServer.from_quantized(s["qm"], device="cpu", persistent_cache_dir=str(tmp_path))
    assert build.library_path("conv_pool_dw_q8").parent == tmp_path.resolve()


# ---------------------------------------------------------------------------
# PosteriorSmoother
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["mean", "vote"])
@pytest.mark.parametrize("window", [1, 3, 5])
def test_posterior_smoother_matches_the_reference(mode, window):
    em = np.random.default_rng(window).standard_normal((20, 12)).astype(np.float32)
    em[7] = em[6]  # repeated labels, and ties in the vote
    mine = streaming.PosteriorSmoother(window=window, mode=mode)
    ref = ref_streaming.PosteriorSmoother(window=window, mode=mode)
    assert mine.posterior is None and ref.posterior is None
    for e in em:
        assert mine.update(e) == ref.update(e)
        np.testing.assert_array_equal(mine.posterior, ref.posterior)
    mine.reset()
    assert mine.posterior is None


def test_posterior_smoother_argument_errors():
    with pytest.raises(ValueError, match="window"):
        streaming.PosteriorSmoother(window=0)
    with pytest.raises(ValueError, match="mode"):
        streaming.PosteriorSmoother(mode="max")
    sm = streaming.PosteriorSmoother()
    sm.update(np.zeros(12))
    with pytest.raises(ValueError, match="shape"):
        sm.update(np.zeros(10))


# ---------------------------------------------------------------------------
# No fallback: a CUDA state launches K4 or raises
# ---------------------------------------------------------------------------


def _fake_cuda(t):
    return torch.empty(t.shape, dtype=t.dtype, device="cuda")


def test_int8_emission_reaches_k4_on_cuda_and_never_the_plain_version(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the kernel would launch")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(kernel_q8, "depthwise_conv_pool_q8_ref", forbidden)
    monkeypatch.setattr(depthwise, "depthwise_conv_pool_ref", forbidden)
    reached = []
    real_call = kernel_q8.depthwise_conv_pool_q8

    def spy(x, *a, **k):
        reached.append(tuple(x.shape))
        return real_call(x, *a, **k)

    monkeypatch.setattr(kernel_q8, "depthwise_conv_pool_q8", spy)
    s = _net("ds_cnn")
    ex, qp = qexec.make_int8_streaming_executor(s["qm"], device="cpu")
    splan = ex.splan
    before = kernel_q8.K4_LAUNCHES.count
    with FakeTensorMode(allow_non_fake_inputs=True):
        ex.device = torch.device("cuda")
        params = {n: {k: (_fake_cuda(v) if isinstance(v, torch.Tensor) else v)
                      for k, v in p.items()} for n, p in qp.items()}
        state = {"frames": torch.empty(splan.in_shape, dtype=torch.int8, device="cuda"),
                 "rings": {r.name: torch.empty((r.channels, r.rows, r.width),
                                               dtype=torch.int8, device="cuda")
                           for r in splan.rings},
                 "phase": splan.emit_stride - 1,
                 "out": torch.empty(12, dtype=torch.int8, device="cuda")}
        frame = torch.empty((1, 10), dtype=torch.int8, device="cuda")
        with pytest.raises(RuntimeError):
            ex.step(params, state, frame)
    # dw1's new row: one row of 64 channels, 3 input rows padded to width 7
    assert reached == [(1, 64, 3, 7)]
    assert kernel_q8.K4_LAUNCHES.count == before
