"""The port's data-parallel mesh, on the CPU: the port of the CPU-runnable
half of ``tests/test_sharding_dp.py``.  The LM's ("data", "model")
mesh, ``ShardingPolicy`` and the sharded train step, the counterparts of
``tests/test_sharding_multidevice.py``, are held in
``tests/test_torch_sharded_train.py`` and
``tests/test_torch_sharding_policy.py``.

* ``DataParallelPolicy``'s mesh validation, ``padded_batch`` / ``pad_lanes``
  and ``make_data_mesh``'s count check (stand-in meshes, as the reference's
  ``AbstractMesh``; CUDA counts from a patched ``torch.cuda``).
* Pad lanes are row-independent: zero and garbage padding give equal real
  rows, bit for bit.
* Sharded executors against unsharded ones on CPU meshes of 1, 2 and 4
  (one CPU repeated): sequential and DAG, f32 and int8.  int8 is bit-exact
  against the whole batch.  f32 is bit-exact against the executor run
  shard by shard (the split, the pad lanes and the gather add nothing) and
  on a mesh of 1; against the whole batch it is within 1e-6, because the
  CPU's f32 kernels are not batch-invariant (MKL's sgemm takes another
  path below 6 rows, oneDNN's convolutions block by batch: a row computed
  in a batch of 4 differs from the same row in a batch of 16 by up to
  ~4e-8).
* Distinct cards (fake CUDA tensors, stand-in streams): each shard, its
  weights and its executor replica's arenas on its own card, its launches
  on that card's stream, every input copy before any launch, the home
  card's shard last, the output gathered on card 0.
* ``CNNEngine(mesh=)``: buckets round up to mesh multiples, weights
  replicate once, and the outputs equal the JAX engine's on the same
  inputs (int8 bit-exact, f32 within 1e-5).
* ``persistent_cache_dir=`` repoints ``build.library_path``.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import fusion as ref_fusion
from repro.core import graph as ref_graph
from repro.core import nn as ref_nn
from repro.core import planner as ref_planner
from repro.core import quantize as ref_quantize
from repro.serve.cnn_engine import CNNEngine as RefCNNEngine
from repro_torch import convert
from repro_torch.core import fusion, graph, nn, pingpong, planner, quantize, schedule
from repro_torch.kernels import build
from repro_torch.kernels.conv_pool import ops
from repro_torch.kernels.conv_pool import ref as conv_ref
from repro_torch.kernels.conv_pool.kernel import K1_LAUNCHES
from repro_torch.launch.mesh import DataMesh, data_axes, make_data_mesh, make_host_mesh
from repro_torch.quant.exec import make_int8_executor
from repro_torch.serve import step
from repro_torch.serve.cnn_engine import CNNEngine, StreamServer
from repro_torch.sharding.policy import DataParallelPolicy, Replicas

MESHES = (1, 2, 4)
F32_TOL = 1e-6


def _mesh(shape, names):
    """A stand-in mesh of any shape, as the reference's AbstractMesh."""
    return types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=tuple(names),
                                 devices=(torch.device("cpu"),) * int(np.prod(shape)))


def _images(n, shape=(1, 32, 32), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, *shape))
                            .astype(np.float32))


@pytest.fixture(scope="module")
def lenet_exec():
    g = graph.lenet5()
    fused = fusion.fuse(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device="cpu"))
    return fused, planner.plan_pingpong(g), params


@pytest.fixture(scope="module")
def executors(lenet_exec):
    """name -> (fresh-executor factory, params, inputs): LeNet-5 f32 and
    int8 (sequential), DS-CNN-KWS f32 and int8 (DAG)."""
    fused, plan, params = lenet_exec
    xs = _images(13)
    qm = quantize.quantize(fused, params, _images(16, seed=3))
    plan_q = planner.plan_pingpong(graph.lenet5(), io_dtype_bytes=1)
    g = graph.ds_cnn_kws()
    dfused = schedule.fuse_dag_priced(g)
    dparams = nn.init_params(dfused, torch.Generator().manual_seed(1), device="cpu")
    dxs = _images(13, (1, 49, 10), seed=4)
    dqm = quantize.quantize_dag(dfused, dparams, dxs)
    dplan_q = schedule.plan_dag(g, io_dtype_bytes=1)
    return {
        "lenet_f32": (lambda: pingpong.make_scan_executor(fused, plan), params, xs),
        "lenet_int8": (lambda: make_int8_executor(qm, plan_q, device="cpu")[0],
                       make_int8_executor(qm, plan_q, device="cpu")[1],
                       quantize.quantize_input(qm, xs)),
        "ds_cnn_kws_f32": (lambda: pingpong.make_dag_executor(dfused, schedule.plan_dag(g)),
                           dparams, dxs),
        "ds_cnn_kws_int8": (lambda: make_int8_executor(dqm, dplan_q, device="cpu")[0],
                            make_int8_executor(dqm, dplan_q, device="cpu")[1],
                            quantize.quantize_input(dqm, dxs)),
    }


# ---------------------------------------------------------------------------
# Mesh-shape validation and remainder padding
# ---------------------------------------------------------------------------


def test_policy_rejects_mesh_without_data_axis():
    with pytest.raises(ValueError, match="no 'data' axis"):
        DataParallelPolicy(_mesh((4,), ("model",)))


def test_policy_rejects_non_unit_extra_axes():
    with pytest.raises(ValueError, match="non-unit extra axes"):
        DataParallelPolicy(_mesh((2, 2), ("data", "model")))


def test_policy_accepts_unit_extra_axes():
    assert DataParallelPolicy(_mesh((4, 1), ("data", "model"))).dp_size == 4


def test_make_data_mesh_validates_count(monkeypatch):
    mesh = make_data_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    assert data_axes(mesh) == ("data",)
    assert make_data_mesh(4, device="cpu").devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        make_data_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        DataMesh(())
    # CUDA: distinct cards, 1 <= n <= device_count, the reference's message
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_data_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_data_mesh(1).shape == {"data": 1}
    with pytest.raises(ValueError, match=r"need 1 <= n_devices <= 2, got 3"):
        make_data_mesh(3)
    with pytest.raises(ValueError, match=r"got 0"):
        make_data_mesh(0)


def test_make_host_mesh_lays_out_data_by_model(monkeypatch):
    """``(n // model, model)`` over the CPU repeated ``model`` times, or
    over every card; a count the model axis does not divide raises."""
    mesh = make_host_mesh(model=2, device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 2}
    assert list(mesh.devices.flat) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_host_mesh(model=2)
    assert mesh.shape == {"data": 2, "model": 2}
    assert [d.index for d in mesh.devices.flat] == [0, 1, 2, 3]
    assert make_host_mesh().shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="do not split into a model axis of 3"):
        make_host_mesh(model=3)


def test_make_data_mesh_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        make_data_mesh()


def test_padded_batch_rounds_up_to_mesh_multiples():
    pol = DataParallelPolicy(make_data_mesh(4, device="cpu"))
    assert [pol.padded_batch(n) for n in (1, 3, 4, 5, 8, 13)] == [4, 4, 4, 8, 8, 16]
    assert [pol.pad_lanes(n) for n in (1, 4, 13)] == [3, 0, 3]
    with pytest.raises(ValueError):
        pol.padded_batch(0)


def test_padded_batch_one_device_is_identity():
    pol = DataParallelPolicy(make_data_mesh(1, device="cpu"))
    for n in (1, 3, 7):
        assert pol.padded_batch(n) == n
        assert pol.pad_lanes(n) == 0


def test_shard_batch_pads_splits_and_reports_n():
    pol = DataParallelPolicy(make_data_mesh(4, device="cpu"))
    xs = _images(3)
    shards, n = pol.shard_batch(xs)
    assert n == 3 and len(shards) == 4
    assert [s.shape[0] for s in shards] == [1, 1, 1, 1]
    assert torch.equal(torch.cat(shards)[:3], xs)
    assert not shards[3].any()  # the pad lane is zeros
    shards, n = pol.shard_batch(_images(8).numpy())
    assert n == 8 and [s.shape[0] for s in shards] == [2, 2, 2, 2]


def test_replicate_keeps_one_copy_per_distinct_device(lenet_exec):
    _, _, params = lenet_exec
    pol = DataParallelPolicy(make_data_mesh(4, device="cpu"))
    reps = pol.replicate(params)
    assert isinstance(reps, Replicas) and list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")]["conv1"]["w"] is params["conv1"]["w"]


# ---------------------------------------------------------------------------
# Sharded execution on CPU meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 5])
def test_pad_lanes_are_row_independent(lenet_exec, n):
    """Zero-fill and garbage-fill padding give bitwise-identical real rows
    (both runs share one shape), and ``wrap_batched`` is exactly the
    zero-padded run, sliced."""
    fused, plan, params = lenet_exec
    pol = DataParallelPolicy(make_data_mesh(4, device="cpu"))
    run = pol.wrap_batched(pingpong.make_scan_executor(fused, plan))
    xs = _images(n, seed=n)
    m = pol.padded_batch(n)
    pad = (m - n, *xs.shape[1:])
    zeros = torch.cat([xs, torch.zeros(pad)])
    junk = torch.cat([xs, 1e3 * _images(m - n, seed=42 + n)])
    reps = pol.replicate(params)
    ya, yb = run(reps, zeros), run(reps, junk)
    assert torch.equal(ya[:n], yb[:n])
    assert torch.equal(run(reps, xs), ya[:n])


@pytest.mark.parametrize("dp", MESHES)
@pytest.mark.parametrize("name", ["lenet_f32", "lenet_int8", "ds_cnn_kws_f32",
                                  "ds_cnn_kws_int8"])
def test_sharded_executor_matches_unsharded(executors, name, dp):
    make, params, xs = executors[name]
    pol = DataParallelPolicy(make_data_mesh(dp, device="cpu"))
    want = make()(params, xs)
    got = pol.wrap_batched(make())(pol.replicate(params), xs)
    assert got.shape == want.shape and got.dtype == want.dtype
    if name.endswith("int8") or dp == 1:
        assert torch.equal(got, want)
    else:
        shards, n = pol.shard_batch(xs)
        fn = make()
        by_shard = torch.cat([fn(params, s) for s in shards])[:n]
        assert torch.equal(got, by_shard)
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_each_device_gets_its_own_arenas(lenet_exec):
    """An arena executor runs on another device through a replica with
    arenas of its own; on a repeated device the one executor serves every
    shard at the shard's batch size."""
    fused, plan, params = lenet_exec
    ex = pingpong.make_scan_executor(fused, plan)
    rep = ex.replica()
    assert rep.arenas == {} and rep.arenas is not ex.arenas and rep.plan is ex.plan
    pol = DataParallelPolicy(make_data_mesh(4, device="cpu"))
    pol.wrap_batched(ex)(pol.replicate(params), _images(16))
    assert sorted(ex.arenas) == [4]


def test_a_shard_on_a_card_launches_or_raises(monkeypatch):
    """No fallback: each shard of a mesh on a (fake) card goes to K1's
    wrapper, which reaches the kernel's build (no nvcc here: a stand-in
    raises there), and never to its plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA shard reached the plain version")

    def reached(name):
        raise RuntimeError(f"reached the build of {name}")

    monkeypatch.setattr(conv_ref, "conv_pool_ref", forbidden)
    monkeypatch.setattr(build, "load", reached)
    pol = DataParallelPolicy(DataMesh((torch.device("cuda", 0),) * 2))
    run = pol.wrap_batched(lambda p, xs: ops.fused_conv_pool(xs, p["w"], p["b"]))
    before = K1_LAUNCHES.count
    with FakeTensorMode():
        p = {"w": torch.empty(6, 1, 5, 5, device="cuda"), "b": torch.empty(6, device="cuda")}
        with pytest.raises(RuntimeError, match="reached the build of conv_pool"):
            run(pol.replicate(p), torch.empty(3, 1, 32, 32, device="cuda"))
    assert K1_LAUNCHES.count == before


def test_distinct_cards_run_their_shards_on_their_own_streams(monkeypatch):
    """A mesh of two (fake) cards: each shard and its weights land on their
    own card, the second card gets a replica of the executor with arenas of
    its own, its K1 launches go to its own stream, every input copy is made
    before any shard is launched, the second card's shard is launched before
    the home card's, and the output is gathered on card 0 in shard order.
    (The arena executor itself cannot run on fake CUDA tensors in a build
    without CUDA; the stand-in has its interface: ``replica()`` and
    ``arenas``.)"""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    import contextlib
    import warnings

    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    events = []
    current = {}

    class Stream:  # stands in for torch.cuda.Stream
        def __init__(self, device):
            self.device = torch.device(device)
            self.cuda_stream = 100 + self.device.index

    defaults = {d: types.SimpleNamespace(device=d, cuda_stream=10 + d.index)
                for d in cards}

    @contextlib.contextmanager
    def stream(s):
        before = current.get(s.device)
        current[s.device] = s
        try:
            yield
        finally:
            current[s.device] = before

    def current_stream(device=None):
        device = torch.device(device)
        return current.get(device) or defaults[device]

    class Kernel:  # stands in for the library's function
        def __call__(self, *args):
            events.append(("K1", args[4].value, args[-1].value))
            return 0

    class Executor:  # an arena executor's interface
        made = []

        def __init__(self):
            self.arenas = {}
            Executor.made.append(self)

        def replica(self):
            return Executor()

        def __call__(self, params, x):
            self.arenas[x.shape[0]] = torch.empty((x.shape[0], 8), device=x.device)
            return ops.fused_conv_pool(x, params["w"], params["b"])

    lib = type("Lib", (), {"conv_pool_f32": Kernel()})()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    real_to = torch.Tensor.to

    def to(t, *a, **k):
        y = real_to(t, *a, **k)
        if y.device != t.device:
            events.append(("copy", str(t.device), str(y.device), tuple(t.shape)))
        return y

    monkeypatch.setattr(torch.Tensor, "to", to)
    pol = DataParallelPolicy(DataMesh(cards))
    ex = Executor()
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        p = {"w": torch.empty(6, 1, 5, 5, device=cards[0]),
             "b": torch.empty(6, device=cards[0])}
        reps = pol.replicate(p)
        run = pol.wrap_batched(ex)
        events.clear()
        y = run(reps, torch.empty(3, 1, 32, 32, device=cards[0]))
    assert list(reps) == list(cards) and reps[cards[0]]["w"] is p["w"]
    assert {t.device for t in reps[cards[1]].values()} == {cards[1]}
    home, other = Executor.made
    assert home is ex and other.arenas is not ex.arenas
    assert [(n, a.device) for n, a in ex.arenas.items()] == [(2, cards[0])]
    assert [(n, a.device) for n, a in other.arenas.items()] == [(2, cards[1])]
    assert y.device == cards[0] and tuple(y.shape) == (3, 6, 14, 14)
    # the second shard's input to card 1, card 1's launch on its own
    # stream, card 0's on the caller's, then card 1's output home
    assert events == [("copy", "cuda:0", "cuda:1", (2, 1, 32, 32)),
                      ("K1", 2, 101), ("K1", 2, 10),
                      ("copy", "cuda:1", "cuda:0", (2, 6, 14, 14))]


# ---------------------------------------------------------------------------
# The engine under a mesh, against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_lenet():
    g = ref_graph.lenet5()
    fused = ref_fusion.fuse(g)
    p = ref_fusion.rename_params(fused, ref_nn.init_params(g, jax.random.PRNGKey(0)))
    calib = np.random.default_rng(3).standard_normal((16, 1, 32, 32)).astype(np.float32)
    qm = ref_quantize.quantize(fused, p, jnp.asarray(calib))
    return fused, p, qm


@pytest.mark.parametrize("dp", [1, 4])
def test_engine_with_mesh_matches_the_reference_engine(ref_lenet, dp):
    """LeNet-5 f32 and int8 through the JAX engine and the port's engine on
    a CPU mesh of ``dp``: buckets (1, 4, 8) round up to mesh multiples, the
    weights replicate once, int8 outputs are bit-exact and f32 within 1e-5."""
    fused_ref, p_ref, qm_ref = ref_lenet
    xs = _images(8, seed=9).numpy()
    buckets = (1, 4, 8)
    plan = planner.plan_pingpong(graph.lenet5())
    plan_q = planner.plan_pingpong(graph.lenet5(), io_dtype_bytes=1)
    with RefCNNEngine.from_graph(fused_ref, ref_planner.plan_pingpong(ref_graph.lenet5()),
                                 p_ref, buckets=buckets) as e0:
        r_f32, _ = e0.serve(xs)
    ref_plan_q = ref_planner.plan_pingpong(ref_graph.lenet5(), io_dtype_bytes=1)
    xq = np.asarray(ref_quantize.quantize_input(qm_ref, jnp.asarray(xs))).astype(np.int8)
    with RefCNNEngine.from_quantized(qm_ref, ref_plan_q, buckets=buckets) as e0:
        r_int8, _ = e0.serve(xq)

    mesh = make_data_mesh(dp, device="cpu")
    pol = DataParallelPolicy(mesh)
    fused = fusion.fuse(graph.lenet5())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, p_ref), device="cpu")
    qm = convert.quantized_from_numpy(fused, qm_ref.input_scale, qm_ref.layers)
    with CNNEngine.from_graph(fused, plan, params, device="cpu", mesh=mesh,
                              buckets=buckets) as e1:
        assert e1._cache.buckets == tuple(sorted({pol.padded_batch(b) for b in buckets}))
        assert isinstance(e1.params, Replicas)
        got, _ = e1.serve(xs)
    for a, b in zip(got, r_f32):
        np.testing.assert_allclose(a.y, np.asarray(b.y), rtol=1e-5, atol=1e-5)
    with CNNEngine.from_quantized(qm, plan_q, device="cpu", mesh=mesh,
                                  buckets=buckets) as e2:
        got, run = e2.serve(xq)
    assert all(b % dp == 0 for b in run.bucket_hist)
    for a, b in zip(got, r_int8):
        assert a.y.dtype == np.int8 and np.array_equal(a.y, np.asarray(b.y))


def test_engine_refuses_a_mesh_of_another_device_type(lenet_exec, monkeypatch):
    fused, plan, params = lenet_exec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mesh on cuda"):
        CNNEngine.from_graph(fused, plan, params, device="cpu",
                             mesh=DataMesh((torch.device("cuda", 0),)))


# ---------------------------------------------------------------------------
# The persistent kernel cache
# ---------------------------------------------------------------------------


def test_persistent_cache_dir_repoints_the_kernel_builds(lenet_exec, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_LOADED", {})
    fused, plan, params = lenet_exec
    first = tmp_path / "replica-cache"
    with CNNEngine.from_graph(fused, plan, params, device="cpu", buckets=(1,),
                              persistent_cache_dir=str(first)):
        pass
    assert build.library_path("conv_pool").parent == first.resolve()
    # the same directory again does nothing; another one repoints it
    assert step.enable_persistent_cache(first) == str(first)
    assert not build.use_build_dir(first)
    qm = quantize.quantize_dag(*_kws_float())
    StreamServer.from_quantized(qm, device="cpu", persistent_cache_dir=str(tmp_path / "b"))
    assert build.library_path("conv_pool_dw_q8").parent == (tmp_path / "b").resolve()
    assert build.NVCC_RUNS.count == 0


def _kws_float():
    g = graph.ds_cnn_kws()
    params = nn.init_params(g, torch.Generator().manual_seed(0), device="cpu")
    return g, params, _images(2, (1, 49, 10), seed=5)
