"""The port's C emitter (`repro_torch.core.export_c`) and synthetic digit set
(`repro_torch.data.mnist_synth`) against the reference, on the CPU.

Weights come from the reference's init (and its quantizers), carried across
through numpy (`repro_torch.convert`); the plans are each package's own.
Held:

* the emitted C text is byte for byte the reference emitter's, for LeNet-5
  f32, the §5 CIFAR net int8, DS-CNN-KWS and MobileNet-V1 0.25 f32 and
  int8, ``residual_cifar`` (joins) f32 and int8, and the other engines of
  the reference's C tests and ``scripts/emit_c_artifacts.py``: the
  overlapping-pool net (f32) and DS-CNN (f32, int8);
* ``make_dataset`` gives the reference's arrays;
* one gcc build per backend (f32 and int8, sequential and DAG) agrees with
  the port's plain CPU path: int8 bit for bit, f32 at the reference's C
  tests' tolerances (``tests/test_core_exec.py``: 1e-5 / 1e-6 for LeNet;
  ``tests/test_rect_avgpool.py``: 1e-4 / 1e-5 for DS-CNN-KWS);
* the paper's flow on the port, on the CPU: LeNet-5 trained 150 steps with
  the port's AdamW, fused, planned into the paper's 8,800 B arena, emitted
  as C and built with gcc, agrees with the port's forward pass at 1e-4 /
  1e-5 and classifies at least 7 of 16 held-out digits (the reference's
  ``test_paper_pipeline_end_to_end``).
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import subprocess
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
from repro.data import mnist_synth as ref_mnist
from repro_torch import convert
from repro_torch.core import export_c, fusion, graph, nn, planner, quantize, schedule
from repro_torch.data import mnist_synth
from repro_torch.train import optimizer
from repro_torch.tree import leaves, unflatten_like



def _overlap_pool(g):
    """The paper's §7 extension (``tests/test_export_c_overlap_pool.py``):
    a pool with stride < kernel fused through a line buffer."""
    return g.SequentialGraph([
        g.Input(shape=(2, 20, 20), name="input"),
        g.Conv2d(2, 4, kernel_size=3, stride=1, padding=1, name="conv1"),
        g.ReLU(name="relu1"),
        g.MaxPool2d(kernel_size=3, stride=2, name="pool1"),
        g.Flatten(name="flatten"),
        g.Linear(4 * 9 * 9, 5, name="fc"),
    ])


# net: (the graph, made from a graph module; DAG; seed)
NETS = {"lenet5": (lambda g: g.lenet5(), False, 0),
        "cifar": (lambda g: g.cifar_testnet(), False, 2),
        "overlap_pool": (_overlap_pool, False, 3),
        "ds_cnn": (lambda g: g.ds_cnn(), True, 7),
        "ds_cnn_kws": (lambda g: g.ds_cnn_kws(), True, 4),
        "mobilenet": (lambda g: g.mobilenet_v1(0.25), True, 5),
        "residual": (lambda g: g.residual_cifar(), True, 6)}
_CACHE = {}


def _setup(net):
    """Port and reference (fused graph, f32 params, int8 model, f32 and int8
    plans) of one net, weights from the reference carried across."""
    if net in _CACHE:
        return _CACHE[net]
    make_graph, dag, seed = NETS[net]
    g_ref, g = make_graph(ref_graph), make_graph(graph)
    if dag:
        fused_ref, fused = ref_schedule.fuse_dag_priced(g_ref), schedule.fuse_dag_priced(g)
        p_ref = ref_nn.init_params(fused_ref, jax.random.PRNGKey(seed))
        plans_ref = [ref_schedule.plan_dag(g_ref, io_dtype_bytes=b) for b in (4, 1)]
        plans = [schedule.plan_dag(g, io_dtype_bytes=b) for b in (4, 1)]
        in_shape = tuple(fused.nodes[0].layer.shape)
    else:
        fused_ref, fused = ref_fusion.fuse(g_ref), fusion.fuse(g)
        p_ref = ref_fusion.rename_params(
            fused_ref, ref_nn.init_params(g_ref, jax.random.PRNGKey(seed)))
        plans_ref = [ref_planner.plan_pingpong(g_ref, io_dtype_bytes=b) for b in (4, 1)]
        plans = [planner.plan_pingpong(g, io_dtype_bytes=b) for b in (4, 1)]
        in_shape = tuple(fused.layers[0].shape)
    p_np = jax.tree.map(np.asarray, p_ref)
    calib = np.random.default_rng(seed).standard_normal((4, *in_shape)).astype(np.float32)
    quantizer = ref_quantize.quantize_dag if dag else ref_quantize.quantize
    qm_ref = quantizer(fused_ref, p_ref, jnp.asarray(calib))
    out = dict(dag=dag, in_shape=in_shape, fused=fused, fused_ref=fused_ref,
               params=convert.params_from_numpy(p_np, device="cpu"), p_np=p_np,
               qm=convert.quantized_from_numpy(fused, qm_ref.input_scale,
                                               qm_ref.layers, qm_ref.joins),
               qm_ref=qm_ref, plans=plans, plans_ref=plans_ref)
    _CACHE[net] = out
    return out


def _sources(net, kind):
    """(port C text, reference C text) of one net's f32 or int8 engine."""
    s = _setup(net)
    if kind == "f32":
        port_fn = export_c.generate_c_dag if s["dag"] else export_c.generate_c
        ref_fn = ref_export_c.generate_c_dag if s["dag"] else ref_export_c.generate_c
        return (port_fn(s["fused"], s["plans"][0], s["params"], with_main=True),
                ref_fn(s["fused_ref"], s["plans_ref"][0], s["p_np"], with_main=True))
    port_fn = export_c.generate_c_int8_dag if s["dag"] else export_c.generate_c_int8
    ref_fn = ref_export_c.generate_c_int8_dag if s["dag"] else ref_export_c.generate_c_int8
    return (port_fn(s["qm"], s["plans"][1], with_main=True),
            ref_fn(s["qm_ref"], s["plans_ref"][1], with_main=True))


CONFIGS = [("lenet5", "f32"), ("cifar", "int8"), ("ds_cnn_kws", "f32"),
           ("ds_cnn_kws", "int8"), ("mobilenet", "f32"), ("mobilenet", "int8"),
           ("residual", "f32"), ("residual", "int8"), ("overlap_pool", "f32"),
           ("ds_cnn", "f32"), ("ds_cnn", "int8")]


@pytest.mark.parametrize("net,kind", CONFIGS, ids=[f"{n}-{k}" for n, k in CONFIGS])
def test_c_text_is_byte_identical_to_the_reference(net, kind):
    port, ref = _sources(net, kind)
    assert port == ref
    assert "int main(void)" in port and "nn_forward" in port


def test_c_weights_may_be_torch_tensors_or_numpy():
    """The params' type does not change the text: torch tensors (the port's
    params) and the same values as numpy emit the same engine."""
    s = _setup("lenet5")
    as_np = {k: {kk: v.numpy() for kk, v in p.items()} for k, p in s["params"].items()}
    assert (export_c.generate_c(s["fused"], s["plans"][0], as_np)
            == export_c.generate_c(s["fused"], s["plans"][0], s["params"]))


@pytest.mark.parametrize("n,seed", [(16, 42), (64, 0)])
def test_make_dataset_equals_the_reference(n, seed):
    imgs, labels = mnist_synth.make_dataset(n, seed=seed)
    ref_imgs, ref_labels = ref_mnist.make_dataset(n, seed=seed)
    assert imgs.dtype == np.float32 and labels.dtype == np.int32
    assert imgs.shape == (n, 1, 32, 32)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(labels, ref_labels)


def _gcc(src: str, tmp: Path) -> Path:
    c, binary = tmp / "net.c", tmp / "net"
    c.write_text(src)
    subprocess.run(["gcc", "-O2", "-std=c99", str(c), "-o", str(binary), "-lm"],
                   check=True, capture_output=True)
    return binary


def _run(binary: Path, x: np.ndarray, dtype) -> np.ndarray:
    out = subprocess.run([str(binary)], input=np.ascontiguousarray(x).tobytes(),
                         capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype)


# backend: (net, kind, rtol, atol); int8 is held bit for bit
ROUND_TRIPS = {"f32-sequential": ("lenet5", "f32", 1e-5, 1e-6),
               "int8-sequential": ("cifar", "int8", 0, 0),
               "f32-dag": ("ds_cnn_kws", "f32", 1e-4, 1e-5),
               "int8-dag": ("residual", "int8", 0, 0)}


@pytest.mark.parametrize("backend", list(ROUND_TRIPS))
def test_gcc_round_trip_agrees_with_the_port(backend, tmp_path):
    net, kind, rtol, atol = ROUND_TRIPS[backend]
    s = _setup(net)
    binary = _gcc(_sources(net, kind)[0], tmp_path)
    xs = np.random.default_rng(7).standard_normal((2, *s["in_shape"])).astype(np.float32)
    for x in xs:
        xt = torch.from_numpy(x)
        if kind == "f32":
            forward = nn.forward_dag if s["dag"] else nn.forward
            want = forward(s["fused"], s["params"], xt).numpy().reshape(-1)
            np.testing.assert_allclose(_run(binary, x, np.float32), want,
                                       rtol=rtol, atol=atol)
        else:
            xq = quantize.quantize_input(s["qm"], xt)
            simulate = (quantize.simulate_int8_dag_forward if s["dag"]
                        else quantize.simulate_int8_forward)
            want = simulate(s["qm"], xq).numpy().reshape(-1)
            np.testing.assert_array_equal(_run(binary, xq.numpy(), np.int8), want)


def _train_lenet(steps=150):
    """LeNet-5 trained on the synthetic digits with the port's AdamW, by
    plain autograd through ``nn.forward`` (the reference's
    ``tests/test_system.py::_short_train``, on the port)."""
    g = graph.lenet5()
    params = nn.init_params(g, torch.Generator().manual_seed(0), device="cpu")
    imgs, labels = mnist_synth.make_dataset(512, seed=0)
    cfg = optimizer.AdamWConfig(lr_peak=2e-3, warmup_steps=10, total_steps=steps,
                                weight_decay=0.0)
    state = optimizer.init_state(params)
    rng = np.random.default_rng(0)
    loss = None
    for _ in range(steps):
        idx = rng.integers(0, len(imgs), 32)
        x, y = torch.from_numpy(imgs[idx]), torch.from_numpy(labels[idx]).long()
        flat = [p.requires_grad_(True) for p in leaves(params)]
        logits = nn.forward(g, params, x)
        loss = (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).mean()
        grads = unflatten_like(params, torch.autograd.grad(loss, flat))
        params, state, _ = optimizer.apply_adamw(cfg, params, grads, state)
    return g, {k: {kk: v.detach() for kk, v in p.items()} for k, p in params.items()}, \
        float(loss.detach())


def test_paper_pipeline_end_to_end_on_the_port(tmp_path):
    """train → fuse → plan → emit C → gcc → the port's outputs and the
    paper's arena."""
    g, params, final_loss = _train_lenet()
    assert final_loss < 2.3  # learning happened (uniform = ln 10 ≈ 2.30)
    fused = fusion.fuse(g)
    fp = fusion.rename_params(fused, params)
    plan = planner.plan_pingpong(g)
    planner.verify_plan(plan)
    assert plan.activation_bytes(4) == 8800  # the paper's arena
    src = export_c.generate_c(fused, plan, fp, with_main=True)
    assert f"static float arena[{8800 // 4}];" in src
    binary = _gcc(src, tmp_path)
    imgs, labels = mnist_synth.make_dataset(16, seed=42)
    correct = 0
    for x, label in zip(imgs, labels):
        y_c = _run(binary, x, np.float32)
        y = nn.forward(fused, fp, torch.from_numpy(x)).numpy().reshape(-1)
        np.testing.assert_allclose(y_c, y, rtol=1e-4, atol=1e-5)
        correct += int(np.argmax(y_c) == label)
    assert correct >= 7, f"only {correct}/16 correct"
