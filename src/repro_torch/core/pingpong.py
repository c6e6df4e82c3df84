"""Arena executors: run a sequential graph *inside the planned arena*.

The port's counterpart of the sequential half of ``repro/core/pingpong.py``:

* :func:`run_with_arena` — the walker.  Every inter-layer tensor is written
  at its planned offset in one flat arena tensor and read back from there,
  one eager call per layer: the slow proof that the plan is clobber-free (an
  overlap of two live buffers would make the output diverge from
  :func:`repro_torch.core.nn.forward`).
* :class:`ArenaExecutor` (:func:`make_scan_executor`) — the fast executor.
  It keeps one preallocated ``(N, plan.arena_elems)`` device arena per batch
  size and runs every step straight into its planned slice: a
  ``FusedConvPool`` step reads one bank through a view and its kernel writes
  the other bank through an ``out=`` view, so the two banks of paper §3.2
  are two real regions of device memory, which the reference's ``lax.scan``
  carry only implies.  PyTorch has no scan, so the steps run as a loop; the
  segment partition is kept for the stats, where it equals the reference's.
* :func:`run_batch_with_arena` — N images through one plan.

Both executors are parametric in ``apply_layer_fn(layer, params, x, out)``,
the per-layer numerics: :func:`apply_layer` (float; ``FusedConvPool`` goes
to kernel K1 for a CUDA tensor) by default, the int8 step of
`repro_torch.quant.exec` for the §5 int8 path.  The arena takes the input's
dtype and device, so an int8 input gives a genuine int8 arena.

The DAG executors come with the DAG slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import nn
from repro_torch.core import segments as segments_mod
from repro_torch.core.graph import (
    Conv2d,
    FusedConvPool,
    Input,
    SequentialGraph,
    as_sequential,
)
from repro_torch.core.planner import MemoryPlan, materialized_steps
from repro_torch.core.segments import cache_fifo
from repro_torch.kernels.conv_pool.ops import fused_conv_pool

# Executors kept per (graph, plan) object pair, bounded FIFO.
_EXEC_CACHE_MAX = 32

_VIEW_KINDS = ("ReLU", "Flatten")


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _write(out: Optional[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    return y if out is None else out.copy_(y)


def apply_layer(layer, p, x: torch.Tensor, out: Optional[torch.Tensor] = None):
    """The float step: :func:`repro_torch.core.nn.apply_layer`, except that a
    dense ``FusedConvPool`` runs through kernel K1's wrapper (the kernel for
    a CUDA tensor, its plain version for a CPU one).  ``out``, when given,
    receives the result."""
    if isinstance(layer, FusedConvPool) and isinstance(layer.conv, Conv2d):
        return fused_conv_pool(
            x, p["w"], p.get("b"), conv_stride=layer.conv.stride,
            padding=layer.conv.padding, pool_k=layer.pool_kernel,
            pool_stride=layer.pool_stride, activation=layer.activation,
            pool=layer.pool, out=out,
        )
    return _write(out, nn.apply_layer(layer, p, x))


def check_plan(graph: SequentialGraph, plan: MemoryPlan):
    """Plan buffers must line up 1:1 with the graph's materialized layers.
    Returns the materialized layers."""
    graph = as_sequential(graph, caller="pingpong.check_plan")
    rows = [l for l in graph.layers if l.kind not in _VIEW_KINDS]
    if len(rows) != len(plan.buffers):
        raise ValueError(
            f"plan has {len(plan.buffers)} buffers but graph materializes "
            f"{len(rows)} — fuse the graph with the same options as the plan"
        )
    return rows


def run_with_arena(
    graph: SequentialGraph,
    plan: MemoryPlan,
    params,
    x: torch.Tensor,
    *,
    apply_layer_fn=apply_layer,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Execute ``graph`` on one image, every materialized buffer at its
    planned offset in one flat arena on ``x``'s device and dtype.

    Returns (output, stats); ``stats['arena_elems']`` equals the plan's
    arena size by construction.
    """
    graph = as_sequential(graph, caller="pingpong.run_with_arena")
    check_plan(graph, plan)
    arena = torch.zeros(plan.arena_elems, dtype=x.dtype, device=x.device)

    def slot(buf):
        return arena[buf.offset_elems: buf.offset_elems + buf.size_elems]

    in_buf = plan.buffers[0]
    if _prod(x.shape) != in_buf.size_elems:
        raise ValueError(f"input size {tuple(x.shape)} != planned {in_buf.size_elems}")
    slot(in_buf).copy_(x.reshape(-1))

    shapes = graph.shapes()
    cur_shape = tuple(x.shape)
    buf_idx = 0
    for layer, out_shape in zip(graph.layers, shapes):
        name = layer.name or layer.kind
        if isinstance(layer, Input):
            cur_shape = out_shape
            continue
        src = plan.buffers[buf_idx]
        # clone: the walker reads a buffer out of the arena, as the
        # reference's dynamic_slice does, so a clobbered slot shows up.
        cur = slot(src).clone().reshape(cur_shape)
        if layer.kind in _VIEW_KINDS:
            out = nn.apply_layer(layer, {}, cur)
            slot(src).copy_(out.reshape(-1))
            cur_shape = tuple(out.shape)
            continue
        out = apply_layer_fn(layer, params.get(name, {}), cur)
        buf_idx += 1
        dst = plan.buffers[buf_idx]
        if out.numel() != dst.size_elems:
            raise ValueError(
                f"layer {name}: produced {tuple(out.shape)} but plan expects "
                f"{dst.size_elems} elements"
            )
        slot(dst).copy_(out.reshape(-1))
        cur_shape = tuple(out.shape)

    final = plan.buffers[-1]
    out = slot(final).clone().reshape(shapes[-1])
    stats = {"arena_elems": int(plan.arena_elems), "buffers": len(plan.buffers)}
    return out, stats


class ArenaExecutor:
    """``(params, x) -> y`` over one preallocated arena per batch size.

    ``x`` is one image (``in_shape``) or a batch ``(N, *in_shape)`` on the
    device the params live on.  The arena for batch size N is a
    ``(N, plan.arena_elems)`` tensor of ``x``'s dtype, allocated at the
    first call with that N and reused after: the executor allocates nothing
    else per step.  Step *i* reads plan buffer *i* and writes plan buffer
    *i+1* in place; view layers (ReLU, Flatten) act on the buffer they
    follow.  The returned output is a copy, so the next call may overwrite
    the arena.

    Calls on one executor must be ordered (one thread, or one CUDA stream):
    two in flight at once would share an arena.
    """

    def __init__(self, graph: SequentialGraph, plan: MemoryPlan, *,
                 apply_layer_fn=apply_layer):
        graph = as_sequential(graph, caller="pingpong.make_scan_executor")
        check_plan(graph, plan)
        self.graph, self.plan = graph, plan
        self.apply_layer_fn = apply_layer_fn
        self.segments = segments_mod.sequential_segments(graph)
        self.pre_views, self.steps = materialized_steps(graph)
        self.in_shape = tuple(graph.shapes()[0])
        bufs = plan.buffers
        if _prod(self.in_shape) != bufs[0].size_elems:
            raise ValueError(f"input size {self.in_shape} != planned {bufs[0].size_elems}")
        for i, (layer, _views, _in, out_shape) in enumerate(self.steps):
            a, b = bufs[i], bufs[i + 1]
            if _prod(out_shape) != b.size_elems:
                raise ValueError(f"step {layer.name}: output {out_shape} but "
                                 f"plan expects {b.size_elems} elements")
            if (a.offset_elems < b.offset_elems + b.size_elems
                    and b.offset_elems < a.offset_elems + a.size_elems):
                raise ValueError(f"step {layer.name}: plan overlaps its input "
                                 f"and output buffers")
        # N -> (N, arena_elems) arena
        self.arenas: Dict[int, torch.Tensor] = {}

    def stats(self) -> Dict[str, int]:
        return {
            "arena_elems": int(self.plan.arena_elems),
            "buffers": len(self.plan.buffers),
            **segments_mod.segment_stats(self.segments),
        }

    def arena(self, n: int, dtype: torch.dtype, device) -> torch.Tensor:
        a = self.arenas.get(n)
        if a is None or a.dtype != dtype or a.device != torch.device(device):
            a = self.arenas[n] = torch.zeros((n, self.plan.arena_elems),
                                             dtype=dtype, device=device)
        return a

    def _bank(self, arena: torch.Tensor, i: int, shape) -> torch.Tensor:
        buf = self.plan.buffers[i]
        flat = arena[:, buf.offset_elems: buf.offset_elems + buf.size_elems]
        return flat.view((arena.shape[0], *shape))

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        nbatch = x.ndim - len(self.in_shape)
        if nbatch not in (0, 1) or tuple(x.shape[nbatch:]) != self.in_shape:
            raise ValueError(f"input shape {tuple(x.shape)} does not match "
                             f"{self.in_shape}")
        xb = x if nbatch else x[None]
        n = xb.shape[0]
        arena = self.arena(n, xb.dtype, xb.device)
        cur = self._bank(arena, 0, self.in_shape)
        cur.copy_(xb)
        for v in self.pre_views:
            cur = self._view(v, cur)
        for i, (layer, views, in_shape, _) in enumerate(self.steps):
            dst = self._bank(arena, i + 1, layer.out_shape(tuple(in_shape)))
            name = layer.name or layer.kind
            self.apply_layer_fn(layer, params.get(name, {}), cur, out=dst)
            cur = dst
            for v in views:
                cur = self._view(v, cur)
        y = cur.clone()
        return y if nbatch else y[0]

    @staticmethod
    def _view(layer, cur: torch.Tensor) -> torch.Tensor:
        """ReLU in place on the buffer (the paper folds it into its
        producer); Flatten as a view."""
        if layer.kind == "ReLU":
            return cur.clamp_(min=0)
        return cur.reshape(cur.shape[0], -1)


def make_scan_executor(graph: SequentialGraph, plan: MemoryPlan, *,
                       apply_layer_fn=apply_layer) -> ArenaExecutor:
    """The executor for (graph, plan); reuse it across calls to reuse its
    arenas.  Named after the reference's scan executor, whose role it
    takes."""
    return ArenaExecutor(graph, plan, apply_layer_fn=apply_layer_fn)


_EXEC_CACHE: Dict[Tuple[int, int], Tuple[SequentialGraph, MemoryPlan, ArenaExecutor]] = {}


def _cached_executor(graph: SequentialGraph, plan: MemoryPlan) -> ArenaExecutor:
    hit = cache_fifo(
        _EXEC_CACHE, (id(graph), id(plan)), _EXEC_CACHE_MAX,
        lambda: (graph, plan, make_scan_executor(graph, plan)),
        name="arena_exec",
    )
    return hit[2]


def run_batch_with_arena(
    graph: SequentialGraph,
    plan: MemoryPlan,
    params,
    xs: torch.Tensor,  # (N, *in_shape)
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """N images through one arena plan; the arena is ``(N, arena_elems)``
    and the bank alternation is identical per image."""
    in_ndim = len(graph.shapes()[0])
    if xs.ndim != in_ndim + 1:
        raise ValueError(f"expected batched input (N, ...), got {tuple(xs.shape)}")
    ex = _cached_executor(graph, plan)
    out = ex(params, xs)
    stats = ex.stats()
    stats["batch"] = int(xs.shape[0])
    return out, stats
