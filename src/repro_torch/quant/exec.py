"""Int8 arena executors: the paper's §5 quantized net inside the planned arena.

The port's counterpart of the sequential half of ``repro/quant/exec.py``.
The float executors (`repro_torch.core.pingpong`) are parametric in the
per-layer numerics; this module supplies the q7-style int8 step
(:func:`apply_int8_layer`: int8 storage, int32 accumulation, the shared
requantization of `repro_torch.core.quantize`) and the two execution forms
over a genuine int8 arena (one byte per element, the plan's
``io_dtype_bytes=1`` made real):

* :func:`run_int8_with_arena` — the walker;
* :func:`make_int8_executor` / :func:`run_batch_int8_with_arena` — the
  arena executor, whose ``FusedConvPool`` steps run kernel K2 on CUDA and
  write straight into the other int8 bank.

Both are bit-exact against ``simulate_int8_forward``, the independent slow
oracle.  The DAG executors come with the DAG slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import nn, pingpong
from repro_torch.core.graph import (
    AvgPool2d,
    Conv2d,
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
)
from repro_torch.core.segments import cache_fifo
from repro_torch.device import resolve
from repro_torch.quant.kernel_q8 import fused_conv_pool_q8

_EXEC_CACHE_MAX = 32


def int8_params(qm: QuantizedModel, device="cuda") -> Dict[str, dict]:
    """Per-layer params for the int8 executors on ``device``: ``w`` int8,
    ``b`` int32 (accumulator scale, when present) and ``m``, the requant
    multiplier as a float32 value held in a Python float."""
    dev = resolve(device)
    out: Dict[str, dict] = {}
    for name, q in qm.layers.items():
        if q.per_channel:
            raise NotImplementedError(
                f"{name}: per-channel (depthwise) int8 layers come with the "
                f"DAG slice")
        p = {"w": torch.as_tensor(q.w_q, device=dev),
             "m": float(np.float32(q.multiplier))}
        if q.b_q is not None:
            p["b"] = torch.as_tensor(q.b_q, device=dev)
        out[name] = p
    return out


def apply_int8_layer(layer, p, x: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer with the paper's §5 int8 semantics; ``out``, when given,
    receives the result.

    The same math as ``simulate_int8_forward`` but parameter-driven, so it
    slots into the arena executors as their ``apply_layer_fn``.  A dense
    ``FusedConvPool`` goes through kernel K2's wrapper: the kernel for a CUDA
    tensor (writing ``out`` in place), its plain version for a CPU one.
    """
    if isinstance(layer, FusedConvPool) and isinstance(layer.conv, Conv2d):
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
            acc = acc + (bias[:, None, None] if acc.ndim == 3
                         else bias[None, :, None, None])
        y = requantize(acc, p["m"])
    elif isinstance(layer, (Linear, FusedLinear)):
        acc = int_linear(x, p["w"])
        if "b" in p:
            acc = acc + p["b"]
        if isinstance(layer, FusedLinear) and layer.activation == "relu":
            acc = torch.clamp(acc, min=0)
        y = requantize(acc, p["m"])
    elif isinstance(layer, (DepthwiseConv2d, FusedConvPool)):
        raise NotImplementedError(
            f"{layer.name}: depthwise int8 layers come with the DAG slice")
    else:
        raise TypeError(f"unsupported layer for int8 execution: {layer!r}")
    return y if out is None else out.copy_(y)


def make_int8_executor(qm: QuantizedModel, plan: MemoryPlan, *,
                       device="cuda") -> Tuple[pingpong.ArenaExecutor, Dict[str, dict]]:
    """``(executor, params)`` for the int8 path on ``device``: the arena
    executor with the int8 step, and the int8 params it takes."""
    ex = pingpong.make_scan_executor(qm.graph, plan,
                                     apply_layer_fn=apply_int8_layer)
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


def run_batch_int8_with_arena(qm: QuantizedModel, plan: MemoryPlan,
                              xs_q: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, int]]:
    """N quantized images through one int8 arena plan: the two int8 banks
    gain a leading batch dimension (``N · arena_elems`` bytes)."""
    _check_int8(xs_q)
    in_ndim = len(qm.graph.shapes()[0])
    if xs_q.ndim != in_ndim + 1:
        raise ValueError(f"expected batched input (N, ...), got {tuple(xs_q.shape)}")
    ex, params = _cached_executor(qm, plan, xs_q.device)
    out = ex(params, xs_q)
    stats = ex.stats()
    stats["arena_bytes"] = int(plan.arena_elems)
    stats["batch"] = int(xs_q.shape[0])
    return out, stats
