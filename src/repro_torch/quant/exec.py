"""Int8 arena executors: the paper's §5 quantized nets inside the planned arena.

The port's counterpart of ``repro/quant/exec.py``.  The float executors
(`repro_torch.core.pingpong`) are parametric in the per-step numerics; this
module supplies the q7-style int8 steps (:func:`apply_int8_layer`,
:func:`apply_int8_node`: int8 storage, int32 accumulation, the shared
requantization of `repro_torch.core.quantize`) and the execution forms
over a genuine int8 arena (one byte per element, the plan's
``io_dtype_bytes=1`` made real):

* :func:`run_int8_with_arena` / :func:`run_int8_dag_with_arena` — the
  walkers, sequential and DAG;
* :func:`make_int8_executor` (either graph kind) /
  :func:`run_batch_int8_with_arena` / :func:`run_batch_int8_dag_with_arena`
  — the arena executors, and under the reference's names
  :func:`make_int8_scan_executor` (an ``x_q -> y_q`` closure),
  :func:`run_int8_with_arena_scan` and :func:`run_int8_dag_with_arena_scan`.
  On CUDA a dense ``FusedConvPool`` step runs kernel K2 and a depthwise
  step kernel K4, each writing straight into its planned int8 buffer.

All are bit-exact against ``simulate_int8_forward`` /
``simulate_int8_dag_forward``, the independent slow oracles.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import nn, pingpong
from repro_torch.core.graph import (
    Add,
    AvgPool2d,
    Concat,
    Conv2d,
    DAGGraph,
    DepthwiseConv2d,
    Flatten,
    FusedConvPool,
    FusedLinear,
    Input,
    Linear,
    MaxPool2d,
    ReLU,
)
from repro_torch.core.planner import MemoryPlan
from repro_torch.core.quantize import (
    QuantizedModel,
    int8_avgpool,
    int_conv2d,
    int_linear,
    requantize,
    requantize_concat,
    requantize_join,
)
from repro_torch.core.segments import cache_fifo
from repro_torch.device import resolve
from repro_torch.quant.kernel_q8 import fused_conv_pool_q8, fused_depthwise_conv_pool_q8

_EXEC_CACHE_MAX = 32


def int8_params(qm: QuantizedModel, device="cuda") -> Dict[str, dict]:
    """Per-step params for the int8 executors on ``device``.

    ``w`` int8, ``b`` int32 (accumulator scale, when present) and ``m``, the
    requant multiplier: a float32 value held in a Python float for a
    per-tensor layer; for a per-channel (depthwise) layer a ``(C,)`` f32
    tensor on ``device``, which K4 reads, with the same values in numpy as
    ``m_host`` for the wrapper's checks.  A join carries ``ms``, one f32
    multiplier per input, as a tensor on ``device``.
    """
    dev = resolve(device)
    out: Dict[str, dict] = {}
    for name, q in qm.layers.items():
        p = {"w": torch.as_tensor(q.w_q, device=dev)}
        if q.per_channel:
            p["m_host"] = np.asarray(q.multiplier, np.float32)
            p["m"] = torch.as_tensor(p["m_host"], device=dev)
        else:
            p["m"] = float(np.float32(q.multiplier))
        if q.b_q is not None:
            p["b"] = torch.as_tensor(q.b_q, device=dev)
        out[name] = p
    for name, j in qm.joins.items():
        out[name] = {"ms": torch.as_tensor(np.asarray(j.multipliers, np.float32),
                                           device=dev)}
    return out


def _depthwise_q8(conv, p, x, out, *, pool_k=1, pool_stride=1,
                  activation="none", pool="max"):
    return fused_depthwise_conv_pool_q8(
        x, p["w"], p.get("b"), multiplier=p["m_host"], ms=p["m"],
        conv_stride=conv.stride, padding=conv.padding, pool_k=pool_k,
        pool_stride=pool_stride, activation=activation, pool=pool, out=out)


def apply_int8_layer(layer, p, x: torch.Tensor,
                     out: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """One layer with the paper's §5 int8 semantics; ``out``, when given,
    receives the result.

    The same math as the int8 simulators but parameter-driven, so it slots
    into the arena executors.  A dense ``FusedConvPool`` goes through kernel
    K2's wrapper and a depthwise conv (bare or fused) through K4's: the
    kernel for a CUDA tensor (writing ``out`` in place), the plain version
    for a CPU one.  ``relu`` folds a bare depthwise conv's ReLU view into
    K4 (bit-exact for the non-negative multipliers K4 accepts).
    """
    if isinstance(layer, DepthwiseConv2d):
        return _depthwise_q8(layer, p, x, out,
                             activation="relu" if relu else "none")
    if relu:
        raise ValueError(f"{layer.name}: only a depthwise conv folds its ReLU")
    if isinstance(layer, FusedConvPool):
        if isinstance(layer.conv, DepthwiseConv2d):
            return _depthwise_q8(layer.conv, p, x, out, pool_k=layer.pool_kernel,
                                 pool_stride=layer.pool_stride,
                                 activation=layer.activation, pool=layer.pool)
        return fused_conv_pool_q8(
            x, p["w"], p.get("b"), multiplier=p["m"],
            conv_stride=layer.conv.stride, padding=layer.conv.padding,
            pool_k=layer.pool_kernel, pool_stride=layer.pool_stride,
            activation=layer.activation, pool=layer.pool, out=out,
        )
    if isinstance(layer, Input):
        y = x
    elif isinstance(layer, ReLU):
        y = torch.clamp(x, min=0)
    elif isinstance(layer, Flatten):
        y = x.reshape(x.shape[:-3] + (-1,)) if x.ndim > 3 else x.reshape(-1)
    elif isinstance(layer, MaxPool2d):
        y = nn.maxpool2d(x, layer.kernel_size, layer.stride, layer.padding)
    elif isinstance(layer, AvgPool2d):
        y = int8_avgpool(x, layer.kernel_size, layer.stride, layer.padding)
    elif isinstance(layer, Conv2d):
        acc = int_conv2d(x, p["w"], layer.stride, layer.padding)
        if "b" in p:
            bias = p["b"]
            acc = acc + bias.view(-1, 1, 1)  # broadcasts over a batch too
        y = requantize(acc, p["m"])
    elif isinstance(layer, (Linear, FusedLinear)):
        acc = int_linear(x, p["w"])
        if "b" in p:
            acc = acc + p["b"]
        if isinstance(layer, FusedLinear) and layer.activation == "relu":
            acc = torch.clamp(acc, min=0)
        y = requantize(acc, p["m"])
    else:
        raise TypeError(f"unsupported layer for int8 execution: {layer!r}")
    return y if out is None else out.copy_(y)


def apply_int8_node(layer, p, xs, out: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """DAG step with the §5 int8 semantics: a join requantizes each input
    onto its output scale (``p['ms']``); single-input layers defer to
    :func:`apply_int8_layer`."""
    if isinstance(layer, (Add, Concat)):
        ms = [p["ms"][i] for i in range(len(xs))]
        y = (requantize_join(xs, ms) if isinstance(layer, Add)
             else requantize_concat(xs, ms, axis=layer.axis))
        return y if out is None else out.copy_(y)
    if len(xs) != 1:
        raise ValueError(f"{layer.name or layer.kind}: expected one input, got {len(xs)}")
    return apply_int8_layer(layer, p, xs[0], out, relu)


def make_int8_executor(qm: QuantizedModel, plan: MemoryPlan, *,
                       device="cuda") -> Tuple[pingpong.ArenaExecutor, Dict[str, dict]]:
    """``(executor, params)`` for the int8 path on ``device``: the arena
    executor with the int8 step — the DAG executor for a DAG-quantized model,
    the sequential one otherwise — and the int8 params it takes."""
    params = int8_params(qm, device)
    if isinstance(qm.graph, DAGGraph):
        ex = pingpong.make_dag_executor(qm.graph, plan,
                                        apply_node_fn=apply_int8_node)
    else:
        ex = pingpong.make_scan_executor(qm.graph, plan,
                                         apply_layer_fn=apply_int8_layer)
    return ex, params


def make_int8_streaming_executor(qm: QuantizedModel, splan=None, *, device="cuda"):
    """``(StreamingExecutor, params)``: the int8 per-frame streaming step on
    ``device``, the third execution regime.

    `repro_torch.core.streaming` supplies the ring-buffer machinery; this
    wires in :func:`apply_int8_node` (every depthwise row block on K4 for a
    CUDA state) and the int8 params.  Int8 sums are exact, so the streamed
    rows are bit-exact against the sliding full-window oracle
    ``quantize.simulate_int8_dag_forward``, warm-up included.  ``splan``
    defaults to ``plan_streaming(qm.graph, io_dtype_bytes=1)``.
    """
    from repro_torch.core import streaming

    if splan is None:
        splan = streaming.plan_streaming(qm.graph, io_dtype_bytes=1)
    ex = streaming.StreamingExecutor(qm.graph, splan, apply_node_fn=apply_int8_node,
                                     dtype=torch.int8, device=device)
    return ex, int8_params(qm, device)


def _check_int8(x: torch.Tensor) -> None:
    if x.dtype != torch.int8:
        raise TypeError(f"expected int8 input, got {x.dtype}")


def run_int8_with_arena(qm: QuantizedModel, plan: MemoryPlan,
                        x_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Int8 walker: one image through a genuine int8 arena on ``x_q``'s
    device.  ``stats['arena_bytes']`` is the arena's byte size."""
    _check_int8(x_q)
    out, stats = pingpong.run_with_arena(
        qm.graph, plan, int8_params(qm, x_q.device), x_q,
        apply_layer_fn=apply_int8_layer,
    )
    stats["arena_bytes"] = int(plan.arena_elems)  # int8: one byte per element
    return out, stats


_EXEC_CACHE: Dict[tuple, tuple] = {}


def _cached_executor(qm: QuantizedModel, plan: MemoryPlan, device: torch.device):
    hit = cache_fifo(
        _EXEC_CACHE, (id(qm), id(plan), str(device)), _EXEC_CACHE_MAX,
        lambda: (qm, plan, *make_int8_executor(qm, plan, device=device)),
        name="int8_arena_exec",
    )
    return hit[2], hit[3]


def make_int8_scan_executor(qm: QuantizedModel, plan: MemoryPlan, *,
                            donate_input: bool = False, device="cuda"):
    """``x_q -> y_q``: the int8 arena executor for (qm, plan) with its int8
    params bound, on ``device`` (the reference's name for
    :func:`make_int8_executor`).  Raises ``TypeError`` on a non-int8 input.
    ``donate_input`` is accepted for the reference's signature and has no
    effect: the executor copies its input into its arena and never writes
    the caller's tensor."""
    ex, params = make_int8_executor(qm, plan, device=device)

    def _exec(x_q: torch.Tensor) -> torch.Tensor:
        _check_int8(x_q)
        return ex(params, x_q)

    return _exec


def _scan_stats(ex, plan: MemoryPlan) -> Dict[str, int]:
    stats = ex.stats()
    stats["arena_bytes"] = int(plan.arena_elems)  # int8: one byte per element
    return stats


def run_int8_with_arena_scan(qm: QuantizedModel, plan: MemoryPlan,
                             x_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The executor's counterpart of :func:`run_int8_with_arena` (same
    contract): bit-exact against the walker and the simulator, on ``x_q``'s
    device, cached per (qm, plan, device); stats as the reference's."""
    _check_int8(x_q)
    ex, params = _cached_executor(qm, plan, x_q.device)
    return ex(params, x_q), _scan_stats(ex, plan)


def run_batch_int8_with_arena(qm: QuantizedModel, plan: MemoryPlan,
                              xs_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """N quantized images through one int8 arena plan: the two int8 banks
    gain a leading batch dimension (``N · arena_elems`` bytes)."""
    _check_int8(xs_q)
    in_ndim = len(qm.graph.layers[0].shape)
    if xs_q.ndim != in_ndim + 1:
        raise ValueError(f"expected batched input (N, ...), got {tuple(xs_q.shape)}")
    ex, params = _cached_executor(qm, plan, xs_q.device)
    out = ex(params, xs_q)
    stats = _scan_stats(ex, plan)
    stats["batch"] = int(xs_q.shape[0])
    return out, stats


def run_int8_dag_with_arena(qm: QuantizedModel, plan: MemoryPlan,
                            x_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Int8 DAG walker: one image of a DAG-quantized model through a genuine
    int8 arena at the reordered plan's offsets."""
    _check_int8(x_q)
    if not isinstance(qm.graph, DAGGraph):
        raise TypeError("run_int8_dag_with_arena expects a DAG-quantized model")
    out, stats = pingpong.run_dag_with_arena(
        qm.graph, plan, int8_params(qm, x_q.device), x_q,
        apply_node_fn=apply_int8_node,
    )
    stats["arena_bytes"] = int(plan.arena_elems)  # int8: one byte per element
    return out, stats


def run_int8_dag_with_arena_scan(qm: QuantizedModel, plan: MemoryPlan,
                                 x_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The executor's counterpart of :func:`run_int8_dag_with_arena`:
    bit-exact against the walker and the DAG simulator."""
    if not isinstance(qm.graph, DAGGraph):
        raise TypeError("run_int8_dag_with_arena_scan expects a DAG-quantized model")
    return run_int8_with_arena_scan(qm, plan, x_q)


def run_batch_int8_dag_with_arena(qm: QuantizedModel, plan: MemoryPlan,
                                  xs_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """N quantized images through one reordered int8 DAG plan."""
    if not isinstance(qm.graph, DAGGraph):
        raise TypeError("run_batch_int8_dag_with_arena expects a DAG-quantized model")
    return run_batch_int8_with_arena(qm, plan, xs_q)
