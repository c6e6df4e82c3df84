"""The port stands alone, and never moves work off the card on its own.

* An AST scan of ``src/repro_torch/**`` and ``chip_smoke.py`` finds no
  import of ``jax`` or of the reference package ``repro``.
* On a host without CUDA, an entry point called with its default device
  (``"cuda"``) raises instead of running on the CPU.
* A kernel wrapper handed a CUDA tensor launches its kernel or raises; it
  never runs its plain version in its place.  Here, with no card and no
  ``nvcc``, it must raise.  Fake CUDA tensors (shapes and strides, no
  storage) stand in for real ones.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import ast
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import convert
from repro_torch.core import fusion, graph, nn, pingpong, planner, quantize, schedule
from repro_torch.core.quantize import QuantizedLayer, QuantizedModel
from repro_torch.configs import base as cfgbase
from repro_torch.kernels import build
from repro_torch.kernels.conv_pool import depthwise, ops, ref
from repro_torch.kernels.conv_pool.kernel import K1_LAUNCHES
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv import ref as wkv_ref
from repro_torch.kernels.xent import kernel as xent_kernel
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.kernels.xent import ref as xent_ref
from repro_torch.data import tokens as tok
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch import inputs as launch_inputs
from repro_torch.launch.mesh import Mesh, make_data_mesh, make_host_mesh, make_mesh
from repro_torch.models import attention, rwkv6
from repro_torch.models.transformer import Model
from repro_torch.quant import exec as qexec
from repro_torch.quant import kernel_q8
from repro_torch.serve.cnn_engine import CNNEngine
from repro_torch.serve.engine import Engine
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.train.pipeline import pipeline_forward
from repro_torch.serve.step import jit_decode_step, jit_prefill_step
from repro_torch.train.step import jit_train_step

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + sorted((ROOT / "scripts").glob("torch_*.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    sources = _port_sources()
    assert len(sources) > 20
    names = {p.relative_to(ROOT).as_posix() for p in sources}
    assert {"src/repro_torch/core/schedule.py",
            "src/repro_torch/kernels/conv_pool/depthwise.py",
            "src/repro_torch/kernels/flash/kernel.py",
            "src/repro_torch/kernels/wkv/kernel.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/kernels/xent/kernel.py",
            "src/repro_torch/kernels/xent/ops.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/train/loop.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/data/mnist_synth.py",
            "src/repro_torch/core/export_c.py",
            "src/repro_torch/checkpoint/ckpt.py",
            "src/repro_torch/ft/resilience.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/inputs.py",
            "src/repro_torch/launch/roofline.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/report.py",
            "src/repro_torch/sharding/policy.py",
            "src/repro_torch/sharding/placement.py",
            "src/repro_torch/sharding/tensor_parallel.py",
            "src/repro_torch/serve/step.py",
            "src/repro_torch/train/pipeline.py",
            "src/repro_torch/models/griffin.py",
            "src/repro_torch/models/moe.py",
            "examples/torch_quickstart.py",
            "examples/torch_train_llm.py",
            "scripts/torch_emit_c_artifacts.py",
            "scripts/torch_obs_report.py"} <= names
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in sources for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")


def _llama():
    return cfgbase.get_reduced_config("llama3.2-1b")


def _lenet():
    g = graph.lenet5()
    fused = fusion.fuse(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device="cpu"))
    return g, fused, params


def _cifar_qm():
    fused = fusion.fuse(graph.cifar_testnet())
    rng = np.random.default_rng(0)
    layers = {}
    for layer in fused.layers:
        if layer.kind == "FusedConvPool":
            c = layer.conv
            shape = (c.out_channels, c.in_channels, *c.kernel_size)
            n_out = c.out_channels
        elif layer.kind in ("FusedLinear", "Linear"):
            lin = getattr(layer, "linear", layer)
            shape = (lin.out_features, lin.in_features)
            n_out = lin.out_features
        else:
            continue
        layers[layer.name] = QuantizedLayer(
            name=layer.name, w_q=rng.integers(-127, 128, shape).astype(np.int8),
            b_q=np.zeros(n_out, np.int32), w_scale=0.01, in_scale=0.02,
            out_scale=0.05)
    return QuantizedModel(graph=fused, input_scale=0.02, layers=layers)


def _dag_float():
    g = graph.ds_cnn_kws()
    fused = schedule.fuse_dag_priced(g)
    return fused, schedule.plan_dag(g), nn.init_params(
        fused, torch.Generator().manual_seed(0), device="cpu")


def _dag_qm():
    fused, _, params = _dag_float()
    calib = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 1, 49, 10)).astype(np.float32))
    return quantize.quantize_dag(fused, params, calib)


ENTRY_POINTS = {
    "init_params": lambda: nn.init_params(graph.lenet5(), torch.Generator()),
    "params_from_numpy": lambda: convert.params_from_numpy(
        {"fc": {"w": np.zeros((2, 2), np.float32)}}),
    "make_int8_executor": lambda: qexec.make_int8_executor(
        _cifar_qm(), planner.plan_pingpong(graph.cifar_testnet(), io_dtype_bytes=1)),
    "CNNEngine.from_graph": lambda: CNNEngine.from_graph(
        _lenet()[1], planner.plan_pingpong(graph.lenet5()), _lenet()[2]),
    "CNNEngine.from_quantized": lambda: CNNEngine.from_quantized(
        _cifar_qm(), planner.plan_pingpong(graph.cifar_testnet(), io_dtype_bytes=1)),
    "init_params[dag]": lambda: nn.init_params(
        schedule.fuse_dag_priced(graph.mobilenet_v1()), torch.Generator()),
    "int8_params[dag]": lambda: qexec.int8_params(_dag_qm()),
    "make_int8_executor[dag]": lambda: qexec.make_int8_executor(
        _dag_qm(), schedule.plan_dag(graph.ds_cnn_kws(), io_dtype_bytes=1)),
    "CNNEngine.from_graph[dag]": lambda: CNNEngine.from_graph(*_dag_float()),
    "CNNEngine.from_quantized[dag]": lambda: CNNEngine.from_quantized(
        _dag_qm(), schedule.plan_dag(graph.ds_cnn_kws(), io_dtype_bytes=1)),
    "Model.init_params": lambda: Model(_llama()).init_params(torch.Generator()),
    "Model.init_cache": lambda: Model(_llama()).init_cache(2, 16),
    "Engine": lambda: Engine(Model(_llama()), {}, lanes=2, max_seq=16),
    "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
        {"embed": np.zeros((4, 2), np.float32)}, _llama()),
    "launch.serve.main": lambda: launch_serve.main(["--arch", "llama3.2-1b"]),
    "launch.serve.main[griffin]": lambda: launch_serve.main(["--arch", "recurrentgemma-9b"]),
    "launch.serve.main[moe]": lambda: launch_serve.main(["--arch", "qwen2-moe-a2.7b"]),
    "launch.serve.main[vision]": lambda: launch_serve.main(["--arch", "qwen2-vl-7b"]),
    "make_data_mesh": lambda: make_data_mesh(),
    "make_host_mesh": lambda: make_host_mesh(),
    "make_mesh": lambda: make_mesh((2, 2), ("data", "model")),
    "Mesh[cuda:0 x 4]": lambda: Mesh([["cuda:0"] * 2] * 2, ("data", "model")),
    "jit_train_step": lambda: jit_train_step(
        Model(_llama()), ShardingPolicy(make_host_mesh(model=2), _llama()),
        launch_inputs.abstract_params(Model(_llama()))),
    "jit_prefill_step": lambda: jit_prefill_step(
        Model(_llama()), ShardingPolicy(make_host_mesh(model=2), _llama()),
        launch_inputs.abstract_params(Model(_llama())),
        launch_inputs.abstract_cache(Model(_llama()), 2, 16), {}, 2, 16),
    "jit_decode_step": lambda: jit_decode_step(
        Model(_llama()), ShardingPolicy(make_host_mesh(model=2), _llama()),
        launch_inputs.abstract_params(Model(_llama())),
        launch_inputs.abstract_cache(Model(_llama()), 2, 16), 2, 16),
    "pipeline_forward": lambda: pipeline_forward(lambda p, x: x, make_mesh((2,), ("pod",))),
    "launch.train.main": lambda: launch_train.main(["--arch", "llama3.2-1b"]),
    "launch.train.main[griffin]": lambda: launch_train.main(["--arch", "recurrentgemma-9b"]),
    "launch.train.main[moe]": lambda: launch_train.main(["--arch", "qwen2-moe-a2.7b"]),
    "launch.train.main[vision]": lambda: launch_train.main(["--arch", "qwen2-vl-7b"]),
    "data.device_batch": lambda: tok.device_batch(
        tok.TokenPipelineConfig(vocab_size=16, seq_len=4, global_batch=2), 0),
    "adamw_state_from_numpy": lambda: convert.adamw_state_from_numpy(
        type("S", (), {"step": np.zeros((), np.int32),
                       "m": {"embed": np.zeros((4, 2), np.float32)},
                       "v": {"embed": np.zeros((4, 2), np.float32)}})(), _llama()),
}


def _script_main(rel: str):
    """The ``main`` of the entry-point script at ``rel`` (from the repo root)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"entry_{Path(rel).stem}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


# The repo's user entry points on the port, each called as ``main([])``.
ENTRY_POINTS.update({
    f"{rel}:main": (lambda rel=rel: _script_main(rel)([]))
    for rel in ("examples/torch_quickstart.py", "examples/torch_deploy_microcontroller.py",
                "examples/torch_deploy_ds_cnn.py", "examples/torch_plan_residual_dag.py",
                "examples/torch_serve_cnn.py", "examples/torch_serve_llm.py",
                "examples/torch_stream_kws.py", "examples/torch_trace_serving.py",
                "examples/torch_train_llm.py", "scripts/torch_emit_c_artifacts.py",
                "scripts/torch_obs_report.py")})


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_default_device_raises_without_cuda(entry):
    _no_cuda()
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry]()


@pytest.fixture
def no_plain(monkeypatch):
    """Make the plain versions fail loudly if a CUDA call reaches them."""
    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "conv_pool_ref", forbidden)
    monkeypatch.setattr(kernel_q8, "conv_pool_q8_ref", forbidden)
    monkeypatch.setattr(depthwise, "depthwise_conv_pool_ref", forbidden)
    monkeypatch.setattr(kernel_q8, "depthwise_conv_pool_q8_ref", forbidden)
    monkeypatch.setattr(flash_ref, "attention_ref", forbidden)
    monkeypatch.setattr(wkv_ref, "wkv_chunked", forbidden)
    for name in ("naive_xent", "chunked_xent", "seq_chunked_xent"):
        monkeypatch.setattr(xent_ref, name, forbidden)


def test_k1_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    _no_cuda()
    before = K1_LAUNCHES.count
    with FakeTensorMode():
        x = torch.empty(2, 1, 32, 32, device="cuda")
        w = torch.empty(6, 1, 5, 5, device="cuda")
        b = torch.empty(6, device="cuda")
        with pytest.raises(RuntimeError):
            ops.fused_conv_pool(x, w, b)
        # the executor's step takes the same route
        _, fused, _ = _lenet()
        step = fused.layers[1]
        assert step.kind == "FusedConvPool"
        with pytest.raises(RuntimeError):
            pingpong.apply_layer(step, {"w": w, "b": b}, x)
    assert K1_LAUNCHES.count == before


def test_k2_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    _no_cuda()
    before = kernel_q8.K2_LAUNCHES.count
    with FakeTensorMode():
        x = torch.empty(2, 3, 32, 32, dtype=torch.int8, device="cuda")
        w = torch.empty(32, 3, 5, 5, dtype=torch.int8, device="cuda")
        b = torch.empty(32, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            kernel_q8.fused_conv_pool_q8(x, w, b, multiplier=0.01, padding=2)
    assert kernel_q8.K2_LAUNCHES.count == before


def test_k3_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    _no_cuda()
    before = depthwise.K3_LAUNCHES.count
    with FakeTensorMode():
        x = torch.empty(2, 64, 25, 5, device="cuda")
        w = torch.empty(64, 1, 3, 3, device="cuda")
        b = torch.empty(64, device="cuda")
        with pytest.raises(RuntimeError):
            depthwise.fused_depthwise_conv_pool(x, w, b, padding=1)
        # the DAG executors' step takes the same route, ReLU folded or not
        dw = graph.DepthwiseConv2d(64, 3, padding=1, name="dw1")
        for relu in (False, True):
            with pytest.raises(RuntimeError):
                pingpong.apply_node(dw, {"w": w, "b": b}, [x], relu=relu)
    assert depthwise.K3_LAUNCHES.count == before


def test_k4_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    _no_cuda()
    before = kernel_q8.K4_LAUNCHES.count
    m = np.full(64, 0.01, np.float32)
    with FakeTensorMode():
        x = torch.empty(2, 64, 25, 5, dtype=torch.int8, device="cuda")
        w = torch.empty(64, 1, 3, 3, dtype=torch.int8, device="cuda")
        b = torch.empty(64, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            kernel_q8.fused_depthwise_conv_pool_q8(x, w, b, multiplier=m, padding=1)
        dw = graph.DepthwiseConv2d(64, 3, padding=1, name="dw1")
        ms = torch.empty(64, device="cuda")
        with pytest.raises(RuntimeError):
            qexec.apply_int8_node(dw, {"w": w, "b": b, "m": ms, "m_host": m}, [x],
                                  relu=True)
    assert kernel_q8.K4_LAUNCHES.count == before


def test_depthwise_wrappers_check_before_launching():
    with FakeTensorMode():
        x = torch.empty(2, 16, 8, 8, device="cuda")
        with pytest.raises(ValueError, match="depthwise w"):
            depthwise.fused_depthwise_conv_pool(x, torch.empty(16, 2, 3, 3, device="cuda"))
        with pytest.raises(ValueError, match="depthwise w"):
            depthwise.fused_depthwise_conv_pool(x, torch.empty(8, 1, 3, 3, device="cuda"))
        xq = torch.empty(2, 16, 8, 8, dtype=torch.int8, device="cuda")
        wq = torch.empty(16, 1, 3, 3, dtype=torch.int8, device="cuda")
        m = np.full(16, 0.01, np.float32)
        with pytest.raises(ValueError, match="non-negative"):
            kernel_q8.fused_depthwise_conv_pool_q8(xq, wq, multiplier=-m)
        with pytest.raises(ValueError, match="ms must be"):
            kernel_q8.fused_depthwise_conv_pool_q8(
                xq, wq, multiplier=m, ms=torch.empty(8, device="cuda"))
        with pytest.raises(TypeError, match="host values"):
            kernel_q8.fused_depthwise_conv_pool_q8(
                xq, wq, multiplier=torch.empty(16, device="cuda"))


def test_wrappers_check_before_launching():
    """Type, shape and layout faults raise before any build or launch."""
    with FakeTensorMode():
        x = torch.empty(2, 1, 32, 32, device="cuda")
        w = torch.empty(6, 1, 5, 5, device="cuda")
        with pytest.raises(ValueError, match="input channels"):
            ops.fused_conv_pool(x, torch.empty(6, 2, 5, 5, device="cuda"))
        with pytest.raises(TypeError, match="one dtype"):
            ops.fused_conv_pool(x, w.to(torch.bfloat16))
        with pytest.raises(ValueError, match="contiguous"):
            ops.fused_conv_pool(x.transpose(2, 3), w)
        with pytest.raises(ValueError, match="out must be"):
            ops.fused_conv_pool(x, w, out=torch.empty(2, 6, 13, 14, device="cuda"))
        xq = torch.empty(1, 3, 32, 32, dtype=torch.int8, device="cuda")
        wq = torch.empty(32, 3, 5, 5, dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError, match="non-negative"):
            kernel_q8.fused_conv_pool_q8(xq, wq, multiplier=-0.5, padding=2)
        with pytest.raises(TypeError, match="int32"):
            kernel_q8.fused_conv_pool_q8(xq, wq, torch.empty(32, device="cuda"),
                                         multiplier=0.5, padding=2)


def test_other_devices_raise():
    x = torch.empty(1, 1, 32, 32, device="meta")
    w = torch.empty(6, 1, 5, 5, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.fused_conv_pool(x, w)
    with pytest.raises(ValueError, match="no implementation"):
        kernel_q8.fused_conv_pool_q8(x.to(torch.int8), w.to(torch.int8))
    xd = torch.empty(1, 4, 8, 8, device="meta")
    wd = torch.empty(4, 1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        depthwise.fused_depthwise_conv_pool(xd, wd)
    with pytest.raises(ValueError, match="no implementation"):
        kernel_q8.fused_depthwise_conv_pool_q8(xd.to(torch.int8), wd.to(torch.int8),
                                               multiplier=0.5)


def test_k5_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    _no_cuda()
    before = flash_kernel.K5_LAUNCHES.count
    cfg = _llama()
    with FakeTensorMode():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.empty(1, 17, 32, 64, dtype=dtype, device="cuda")
            kv = torch.empty(1, 17, 8, 64, dtype=dtype, device="cuda")
            with pytest.raises(RuntimeError):
                flash_ops.flash_attention(q, kv, kv)
        # the model's prefill attention takes the same route
        p = {k: torch.empty(s, device="cuda") for k, s in (
            ("wq", (cfg.d_model, cfg.num_heads, 64)), ("wk", (cfg.d_model, 2, 64)),
            ("wv", (cfg.d_model, 2, 64)), ("wo", (cfg.num_heads, 64, cfg.d_model)))}
        x = torch.empty(1, 9, cfg.d_model, device="cuda")
        pos = torch.zeros(1, 9, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            attention.attend_train(dataclasses.replace(cfg, head_dim=64), p, x, "attn", pos)
    assert flash_kernel.K5_LAUNCHES.count == before


# (B, S, H, K, h, window) of each new family's prefill attention at full size
NEW_FAMILY_ATTENTION = {"recurrentgemma-9b": (1, 37, 16, 1, 256, 2048),
                        "qwen2-moe-a2.7b": (1, 37, 16, 16, 128, 0),
                        "mixtral-8x7b": (1, 37, 32, 8, 128, 4096)}


@pytest.mark.parametrize("arch", sorted(NEW_FAMILY_ATTENTION))
def test_new_families_attention_goes_through_k5(arch, monkeypatch):
    """Every attention layer of a Griffin or MoE prefill calls
    ``flash_attention`` (reduced config, CPU, counted), and a CUDA call at
    the family's full attention shape goes to K5's wrapper, which reaches
    the kernel's build (no nvcc here: a stand-in raises there), never the
    plain version."""
    _no_cuda()
    cfg = cfgbase.get_reduced_config(arch)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    calls = []
    attend = flash_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    tokens = torch.zeros((1, 20), dtype=torch.int32)
    cache, _ = model.prefill(params, {"tokens": tokens}, 32)
    n_attn = sum(kind in ("attn", "swa", "local") for kind in cfg.blocks())
    assert n_attn >= 1 and len(calls) == n_attn
    model.decode_step(params, cache, tokens[:, :1], 20, 32)
    assert len(calls) == n_attn  # decode attention is plain in the reference too

    def reached(name):
        raise RuntimeError(f"reached the build of {name}")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(build, "load", reached)
    monkeypatch.setattr(flash_ref, "attention_ref", forbidden)
    B, S, H, K, h, window = NEW_FAMILY_ATTENTION[arch]
    with FakeTensorMode():
        q = torch.empty(B, S, H, h, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(B, S, K, h, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="reached the build of flash_fwd"):
            attend(q, kv, kv, window=window)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mixtral_k5_shapes_are_held_by_k5_checks():
    """Every K5 shape Mixtral-8x7B's phases launch is one ``k5_checks``
    holds, in f32 and bf16: served through ``Engine`` at 509, 4,097 and
    8,192 tokens (the shapes ``lm_timing_phase`` times), its train shape,
    and ``mixtral_sharded``'s on (1, 2) and (1, 4), a model coordinate's
    heads: each batch's prompt (4 x 509, 1 x 8,192) and the prefills its
    decode steps are held against (4 x 525 up to the last step; 1 x 8,193
    at the first step past the window, 1 x 8,208 at the last)."""
    cs = _chip_smoke()
    cfg = cfgbase.get_config("mixtral-8x7b")
    assert cs.MIXTRAL_ATTENTION == (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window)
    held = {(B, S, H, K, h, window, softcap)
            for B, S, T, H, K, h, window, softcap, causal, off in cs.k5_cases()
            if causal and off == 0 and T == S}
    timed = {(B, S, H, K, h, window, 0.0) for _, _, B, S, T, H, K, h, causal, _, window, off
             in cs.mixtral_timing_cases({"mixtral-8x7b": {"K5": (0, {})}},
                                        {"mixtral-8x7b": {"K5": 0}})}
    assert timed == {(1, S, 32, 8, 128, 4096, 0.0) for S in (509, 4097, 8192)} | {
        (4, 512, 32, 8, 128, 4096, 0.0)}
    # each served launch counted once, beside the timed prompt nearest it
    served = {("flash_fwd_bf16", 1, S, S, 32, 8, 128, True, 4096, 0.0, 0): 8
              for S in (1, 509, 4096, 4097, 6969, 8191, 8192)}
    launches = [c[9] for c in cs.mixtral_timing_cases({"mixtral-8x7b": {"K5": (56, served)}},
                                                      {"mixtral-8x7b": {"K5": 6}})]
    assert launches == [24, 24, 8, 6]
    sharded = {(B, S, 32 // n, 8 // n, 128, 4096, 0.0) for n in (2, 4)
               for B, S in ((4, 509), (4, 525), (1, 8192), (1, 8193), (1, 8208))}
    assert {c for n in cs.MIXTRAL_MODEL_AXES for c in cs.mixtral_sharded_k5_shapes(n)} == sharded
    assert timed | sharded <= held
    assert cs.TRAIN_RUNS["mixtral-8x7b"][2:4] == (4, 512)
    assert [cs.mixtral_check_positions(S) for _, S in cs.MIXTRAL_BATCHES] == [[524],
                                                                             [8192, 8207]]


def test_mixtral_smoke_tables():
    """``LM_KV_BYTES["mixtral-8x7b"]`` is ``lm_state_bytes`` at lm_engine's 8
    layers, 4 lanes and ``max_seq`` 8,448 (8 rings of 4,096 slots), and K6's
    launch at Mixtral's train shape, (2,048, 4,096, 32,000) whole at the
    automatic split count of an H100 SXM's 132 SMs, is one ``k6_checks``
    holds."""
    from repro_torch.kernels.xent.kernel import split_count

    cs = _chip_smoke()
    seed, lanes, max_seq, *_ = cs.LM_ENGINES["mixtral-8x7b"]
    cfg = dataclasses.replace(cfgbase.get_config("mixtral-8x7b"),
                              num_layers=cs.LM_ENGINE_LAYERS["mixtral-8x7b"])
    assert (cfg.num_layers, lanes, max_seq) == (8, 4, 8448)
    assert cs.lm_state_bytes(cfg, lanes, max_seq) == cs.LM_KV_BYTES["mixtral-8x7b"] == (
        8 * 4 * (2 * 4096 * 8 * 128 * 2 + 4096 * 4))
    assert cs._ring_layers(cfg, max_seq) == 8
    N, D, V = cs.K6_TRAIN_SHAPES["mixtral-8x7b"]
    assert (N, D, V) == (4 * 512, cfg.d_model, cfg.vocab_size)
    assert ("xent_fwd_f32", N, D, V, split_count(N, V, 132), 0.0) in cs.k6_held(132)


def test_sharded_prefill_attention_goes_through_k5_on_every_coordinate(monkeypatch):
    """The sharded prefill (``jit_prefill_step``) calls ``flash_attention``
    once a layer on every model coordinate of every data row, on that
    coordinate's heads: RecurrentGemma reduced on (2, 2) at batch 2, its
    local layer's 2 q heads over 1 KV head split 1 + 1, K5's route for 1 : 1
    here (the full config's 16 : 1 gives 8 : 1 a coordinate); a decode step
    calls it never.  A CUDA call at the full config's per-coordinate shape
    reaches K5's build, never the plain version."""
    _no_cuda()
    cfg = cfgbase.get_reduced_config("recurrentgemma-9b")
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    policy = ShardingPolicy(make_mesh((2, 2), ("data", "model"), device="cpu"), cfg)
    aparams, acache = launch_inputs.abstract_params(model), launch_inputs.abstract_cache(
        model, 2, 32)
    specs = policy.batch_specs(cfgbase.ShapeConfig("p", 20, 2, "prefill"))
    prefill = jit_prefill_step(model, policy, aparams, acache, specs, 2, 32)
    decode = jit_decode_step(model, policy, aparams, acache, 2, 32)
    calls = []
    attend = flash_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    cache, _ = prefill(params, {"tokens": torch.zeros((2, 20), dtype=torch.int32)})
    n_attn = sum(kind == "local" for kind in cfg.blocks())
    h = cfg.head_dim
    assert calls == [((1, 20, 1, h), (1, 20, 1, h))] * (n_attn * 4)
    decode(params, cache, torch.zeros((2, 1), dtype=torch.int32), 20)
    assert len(calls) == n_attn * 4

    def reached(name):
        raise RuntimeError(f"reached the build of {name}")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(build, "load", reached)
    monkeypatch.setattr(flash_ref, "attention_ref", forbidden)
    with FakeTensorMode():
        q = torch.empty(2, 509, 8, 256, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 509, 1, 256, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="reached the build of flash_fwd"):
            attend(q, kv, kv)


def test_k7_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    _no_cuda()
    before = wkv_kernel.K7_LAUNCHES.count
    cfg = cfgbase.get_reduced_config("rwkv6-7b")
    shapes = {k: (v.shape, v.dtype) for k, v in
              rwkv6.init_rwkv_params(cfg, torch.Generator(), "cpu").items()}
    with FakeTensorMode():
        for dtype in (torch.float32, torch.bfloat16):
            r = torch.empty(1, 63, 64, 64, dtype=dtype, device="cuda")
            logw = torch.empty(1, 63, 64, 64, device="cuda")
            u = torch.empty(64, 64, device="cuda")
            with pytest.raises(RuntimeError):
                wkv_ops.wkv(r, r, r, logw, u, chunk=64)
        # the model's multi-token time-mix takes the same route
        p = {k: torch.empty(s, dtype=dt, device="cuda") for k, (s, dt) in shapes.items()}
        x = torch.empty(1, 5, cfg.d_model, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError):
            rwkv6.time_mix(cfg, p, x)
    assert wkv_kernel.K7_LAUNCHES.count == before


def test_lm_wrappers_check_before_launching():
    """Shape, dtype, head-dim and layout faults raise before any build."""
    with FakeTensorMode():
        q = torch.empty(1, 8, 4, 64, device="cuda")
        kv = torch.empty(1, 8, 2, 64, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            flash_kernel.flash_attention_fwd(torch.empty(1, 8, 4, 96, device="cuda"),
                                             torch.empty(1, 8, 2, 96, device="cuda"),
                                             torch.empty(1, 8, 2, 96, device="cuda"))
        with pytest.raises(ValueError, match="KV heads"):
            flash_kernel.flash_attention_fwd(q, torch.empty(1, 8, 3, 64, device="cuda"),
                                             torch.empty(1, 8, 3, 64, device="cuda"))
        with pytest.raises(TypeError, match="one dtype"):
            flash_kernel.flash_attention_fwd(q, kv.to(torch.bfloat16), kv)
        with pytest.raises(ValueError, match="contiguous head dim"):
            flash_kernel.flash_attention_fwd(
                torch.empty(1, 8, 64, 4, device="cuda").transpose(2, 3), kv, kv)
        r = torch.empty(1, 8, 2, 16, device="cuda")
        logw = torch.empty(1, 8, 2, 16, device="cuda")
        u = torch.empty(2, 16, device="cuda")
        with pytest.raises(ValueError, match="does not divide"):
            wkv_kernel.wkv_fwd(r, r, r, logw, u, chunk=3)
        with pytest.raises(ValueError, match="must lie"):
            wkv_kernel.wkv_fwd(r, r, r, logw, u, chunk=65)
        with pytest.raises(TypeError, match="must be f32"):
            wkv_kernel.wkv_fwd(r, r, r, logw.to(torch.bfloat16), u, chunk=8)
        with pytest.raises(ValueError, match="contiguous"):
            wkv_kernel.wkv_fwd(torch.empty(1, 8, 16, 2, device="cuda").transpose(2, 3),
                               r, r, logw, u, chunk=8)


def test_lm_wrappers_on_other_devices_raise():
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        flash_ops.flash_attention(q, q, q)
    r = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        wkv_ops.wkv(r, r, r, r, torch.empty(2, 16, device="meta"))


def test_k6_wrapper_with_a_cuda_tensor_raises_and_never_falls_back(no_plain):
    """fused_xent, its Function and the model's chunked losses on fake CUDA
    tensors: no nvcc here, so each raises, and none reaches a plain form."""
    _no_cuda()
    before = xent_kernel.K6_LAUNCHES.count
    cfg = _llama()
    with FakeTensorMode():
        x = torch.empty(2, 9, 64, device="cuda")
        w = torch.empty(100, 64, device="cuda")
        t = torch.empty(2, 9, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):
            xent_ops.fused_xent(x, w, t)
        with pytest.raises(RuntimeError):
            xent_ops.FusedXent.apply(x, w, t, 0.0)
        params = {"embed": torch.empty(cfg.vocab_size, cfg.d_model, device="cuda")}
        xm = torch.empty(2, 9, cfg.d_model, device="cuda")
        tm = torch.empty(2, 9, dtype=torch.int32, device="cuda")
        for impl in ("chunked", "seq_chunked"):
            with pytest.raises(RuntimeError):
                Model(cfg, xent_impl=impl)._xent(params, xm, tm, torch.ones(2, 9, device="cuda"))
    assert xent_kernel.K6_LAUNCHES.count == before


def test_k5_k7_functions_on_cuda_tensors_raise(no_plain):
    """The Functions' forward launches or raises.  (Fake CUDA tensors that
    require grad would make autograd look for a CUDA device guard, which a
    CPU-only build aborts on, so these do not.)"""
    _no_cuda()
    k5, k7 = flash_kernel.K5_LAUNCHES.count, wkv_kernel.K7_LAUNCHES.count
    with FakeTensorMode():
        q = torch.empty(1, 17, 4, 64, device="cuda")
        kv = torch.empty(1, 17, 2, 64, device="cuda")
        with pytest.raises(RuntimeError):
            flash_ops.FlashAttention.apply(q, kv, kv, True, 0, 0.125, 0.0)
        r = torch.empty(1, 16, 2, 64, device="cuda")
        u = torch.empty(2, 64, device="cuda")
        with pytest.raises(RuntimeError):
            wkv_ops.WKV.apply(r, r, r, r, u, 8)
    assert (flash_kernel.K5_LAUNCHES.count, wkv_kernel.K7_LAUNCHES.count) == (k5, k7)


def test_k6_wrapper_checks_before_launching():
    with FakeTensorMode():
        x = torch.empty(8, 16, device="cuda")
        w = torch.empty(37, 16, device="cuda")
        t = torch.empty(8, dtype=torch.int32, device="cuda")
        with pytest.raises(TypeError, match="f32"):
            xent_kernel.fused_xent_fwd(x.to(torch.bfloat16), w, t)
        with pytest.raises(TypeError, match="int32"):
            xent_kernel.fused_xent_fwd(x, w, t.long())
        with pytest.raises(ValueError, match="contiguous"):
            xent_kernel.fused_xent_fwd(torch.empty(16, 8, device="cuda").T, w, t)
        with pytest.raises(ValueError, match="targets"):
            xent_kernel.fused_xent_fwd(x, w, torch.empty(7, dtype=torch.int32, device="cuda"))
        with pytest.raises(ValueError, match="w"):
            xent_kernel.fused_xent_fwd(x, torch.empty(37, 15, device="cuda"), t)


def test_k6_split_count_fills_one_wave():
    """One CTA an SM (the kernel's 255-register budget): 132 slots."""
    assert xent_kernel.split_count(4096, 128256, 132) == 4  # 32 token blocks x 4
    assert xent_kernel.split_count(2048, 65536, 132) == 8
    assert xent_kernel.split_count(129, 1000, 132) == 8  # capped at the vocab tiles
    assert xent_kernel.split_count(1 << 20, 1000, 132) == 1


def test_xent_on_other_devices_raises():
    x = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        xent_ops.fused_xent(x, torch.empty(5, 8, device="meta"),
                            torch.empty(1, 4, dtype=torch.int32, device="meta"))
