"""Arena executors: run a sequential or DAG graph *inside the planned arena*.

The port's counterpart of ``repro/core/pingpong.py``.  Sequential graphs:

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
* :func:`run_with_arena_scan` — the executor under the walker's signature,
  cached per (graph, plan), with the reference's stats;
* :func:`run_batch_with_arena` — N images through one plan.

DAG graphs, on the reordered plans of `repro_torch.core.schedule.plan_dag`
(``plan.buffers`` in schedule order):

* :func:`run_dag_with_arena` — the walker, one image, one flat arena;
* :class:`DagArenaExecutor` (:func:`make_dag_executor`) — the executor:
  one ``(N, arena_elems)`` arena per batch size; each step reads its inputs
  as views of their planned buffers and writes its own buffer in place.
  Steps run one after the other in plan order, segment by segment through
  :func:`apply_dag_segment`: the isomorphic branches the reference batches
  into one ``vmap`` run apart;
* :func:`run_dag_with_arena_scan` — the executor under the walker's
  signature, cached per (graph, plan);
* :func:`run_batch_dag_with_arena` — N images through one DAG plan.

:func:`aot_compile` prepares an executor at one input shape before the
first request (its kernels built, its arena allocated).

The sequential executors are parametric in ``apply_layer_fn(layer, params,
x, out)``, the DAG ones in ``apply_node_fn(layer, params, xs, out, relu)``:
the float steps :func:`apply_layer` / :func:`apply_node` by default (a
dense ``FusedConvPool`` runs kernel K1 for a CUDA tensor, a depthwise conv
kernel K3), the int8 steps of `repro_torch.quant.exec` for the int8 path.
The arena takes the input's dtype and device, so an int8 input gives a
genuine int8 arena.

**The ReLU fold.**  A ``DepthwiseConv2d`` step whose first folded view is a
ReLU passes ``relu=True`` to its step, which hands ``activation="relu"`` to
K3/K4, and the view is not applied again.  In f32 that is the same
computation.  In int8 the reference requantizes, then takes the ReLU; for a
multiplier m ≥ 0 requantization is non-decreasing and maps 0 to 0, so
``requant(max(acc, 0)) == max(requant(acc), 0)`` bit for bit, and the K4
wrapper refuses a negative multiplier.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import nn
from repro_torch.core import segments as segments_mod
from repro_torch.core.graph import (
    Conv2d,
    DAGGraph,
    DepthwiseConv2d,
    FusedConvPool,
    Input,
    SequentialGraph,
    as_sequential,
)
from repro_torch.core.planner import MemoryPlan, materialized_steps
from repro_torch.core.schedule import check_dag_plan
from repro_torch.core.segments import cache_fifo
from repro_torch.kernels.conv_pool.depthwise import fused_depthwise_conv_pool
from repro_torch.kernels.conv_pool.ops import fused_conv_pool
from repro_torch.tree import leaves

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

    def replica(self) -> "ArenaExecutor":
        """The same executor with arenas of its own, for another device
        (``DataParallelPolicy.wrap_batched``: calls on two devices are not
        ordered against each other, so they must not share an arena)."""
        other = copy.copy(self)
        other.arenas = {}
        return other

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


def run_with_arena_scan(
    graph: SequentialGraph,
    plan: MemoryPlan,
    params,
    x: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The executor's counterpart of :func:`run_with_arena` (same
    signature): (output, stats), ``stats`` also giving the segment
    grouping, as the reference's.  The executor is cached per (graph, plan),
    so a second call reuses its arenas."""
    ex = _cached_executor(graph, plan)
    return ex(params, x), ex.stats()


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


# ---------------------------------------------------------------------------
# DAG executors (reordered schedules from repro_torch.core.schedule)
# ---------------------------------------------------------------------------


def apply_node(layer, p, xs, out: Optional[torch.Tensor] = None,
               relu: bool = False) -> torch.Tensor:
    """The float DAG step: :func:`repro_torch.core.nn.apply_node`, except
    that a dense ``FusedConvPool`` runs through kernel K1's wrapper and a
    depthwise conv (bare, or inside a ``FusedConvPool``) through K3's — the
    kernel for a CUDA tensor, the plain version for a CPU one.  ``relu``
    folds a bare depthwise conv's ReLU view into K3.  ``out``, when given,
    receives the result."""
    if isinstance(layer, DepthwiseConv2d):
        return fused_depthwise_conv_pool(
            xs[0], p["w"], p.get("b"), conv_stride=layer.stride,
            padding=layer.padding, activation="relu" if relu else "none",
            out=out)
    if relu:
        raise ValueError(f"{layer.name}: only a depthwise conv folds its ReLU")
    if isinstance(layer, FusedConvPool) and isinstance(layer.conv, DepthwiseConv2d):
        return fused_depthwise_conv_pool(
            xs[0], p["w"], p.get("b"), conv_stride=layer.conv.stride,
            padding=layer.conv.padding, pool_k=layer.pool_kernel,
            pool_stride=layer.pool_stride, activation=layer.activation,
            pool=layer.pool, out=out)
    if len(xs) == 1:
        return apply_layer(layer, p, xs[0], out)
    return _write(out, nn.apply_node(layer, p, xs))


def folds_relu(step) -> bool:
    """True iff ``step`` (a schedule step) is a depthwise conv whose first
    folded view is a ReLU, which its kernel then applies."""
    return (isinstance(step.layer, DepthwiseConv2d) and bool(step.views)
            and step.views[0].kind == "ReLU")


def run_step(apply_node_fn, step, p, xs, out: Optional[torch.Tensor] = None):
    """One schedule step: its node, then its folded views (ReLU in place on
    the buffer, Flatten as a view), the ReLU fold applied."""
    relu = folds_relu(step)
    y = apply_node_fn(step.layer, p, xs, out=out, relu=relu)
    for v in step.views[int(relu):]:
        y = y.clamp_(min=0) if v.kind == "ReLU" else nn.apply_layer(v, {}, y)
    return y


def apply_dag_segment(steps, seg, params, vals, *, apply_node_fn=apply_node,
                      out: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Run one compiled segment's steps; returns the values they produced,
    by step name.

    ``steps`` maps step name → schedule step, ``vals`` holds the values the
    segment reads, and ``out(name)``, when given, is the view a step writes
    (its planned buffer).  Segments tile the schedule, and a segment's names
    are in schedule order, so running the segments in turn is running the
    plan: :class:`DagArenaExecutor` does, and `repro_torch.obs.report` times
    one segment at a time through the same function.
    """
    produced: Dict[str, torch.Tensor] = {}
    for name in seg.names:
        s = steps[name]
        xs = [produced[src] if src in produced else vals[src] for src in s.inputs]
        produced[name] = run_step(apply_node_fn, s, params.get(name, {}), xs,
                                  out=None if out is None else out(name))
    return produced


def _layer_shape(step, in_shape):
    """A step's output shape before its views (what its kernel writes)."""
    if isinstance(step.layer, Input):
        return tuple(in_shape)
    return tuple(step.layer.out_shape_multi(step.in_shapes))


def run_dag_with_arena(
    graph: DAGGraph,
    plan: MemoryPlan,
    params,
    x: torch.Tensor,
    *,
    apply_node_fn=apply_node,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Execute a DAG on one image inside the planned arena, in the plan's
    schedule order: the slow proof that the reordered plan's offsets are
    clobber-free (each input is read back as a copy out of its slot)."""
    mat, order = check_dag_plan(graph, plan)
    steps = {s.name: s for s in mat.steps}
    bufs = {b.name: b for b in plan.buffers}
    arena = torch.zeros(plan.arena_elems, dtype=x.dtype, device=x.device)

    def slot(name):
        b = bufs[name]
        return arena[b.offset_elems: b.offset_elems + b.size_elems]

    if _prod(x.shape) != bufs[order[0]].size_elems:
        raise ValueError(f"input size {tuple(x.shape)} != planned "
                         f"{bufs[order[0]].size_elems}")
    val = run_step(apply_node_fn, steps[order[0]], {}, [x.clone()]) \
        if steps[order[0]].views else x
    slot(order[0]).copy_(val.reshape(-1))
    for name in order[1:]:
        step = steps[name]
        xs = [slot(src).clone().reshape(steps[src].out_shape) for src in step.inputs]
        out = run_step(apply_node_fn, step, params.get(name, {}), xs)
        if out.numel() != bufs[name].size_elems:
            raise ValueError(f"step {name}: produced {tuple(out.shape)} but plan "
                             f"expects {bufs[name].size_elems} elements")
        slot(name).copy_(out.reshape(-1))
    out = slot(mat.output).clone().reshape(steps[mat.output].out_shape)
    return out, {"arena_elems": int(plan.arena_elems), "buffers": len(plan.buffers)}


def _overlap(a, b) -> bool:
    return (a.offset_elems < b.offset_elems + b.size_elems
            and b.offset_elems < a.offset_elems + a.size_elems)


class DagArenaExecutor(ArenaExecutor):
    """``(params, x) -> y`` for a DAG over one preallocated arena per batch
    size, as :class:`ArenaExecutor` is for a chain.

    Each step reads its inputs as views of their planned buffers and writes
    its own planned buffer through an ``out=`` view; the plan must never
    put a step's output on one of its inputs (checked here).  The output is
    a copy.  Calls on one executor must be ordered.
    """

    def __init__(self, graph: DAGGraph, plan: MemoryPlan, *,
                 apply_node_fn=apply_node):
        mat, order, self.segments = segments_mod.segments_for_plan(graph, plan)
        self.graph, self.plan = graph, plan
        self.apply_node_fn = apply_node_fn
        self.in_shape = tuple(graph.nodes[0].layer.shape)
        steps = {s.name: s for s in mat.steps}
        self.bufs = {b.name: b for b in plan.buffers}
        self.order = [steps[n] for n in order]
        self.steps = steps
        if [n for seg in self.segments for n in seg.names] != list(order[1:]):
            raise ValueError("the segments do not tile the plan's schedule")
        self.output = mat.output
        self.layer_shapes = {s.name: _layer_shape(s, self.in_shape)
                             for s in self.order}
        for s in self.order:
            if _prod(s.out_shape) != self.bufs[s.name].size_elems:
                raise ValueError(f"step {s.name}: output {s.out_shape} but plan "
                                 f"expects {self.bufs[s.name].size_elems} elements")
            for src in s.inputs:
                if _overlap(self.bufs[src], self.bufs[s.name]):
                    raise ValueError(f"step {s.name}: plan overlaps its output "
                                     f"with its input {src}")
        self.arenas: Dict[int, torch.Tensor] = {}

    def _buf(self, arena: torch.Tensor, name: str, shape) -> torch.Tensor:
        b = self.bufs[name]
        flat = arena[:, b.offset_elems: b.offset_elems + b.size_elems]
        return flat.view((arena.shape[0], *shape))

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        nbatch = x.ndim - len(self.in_shape)
        if nbatch not in (0, 1) or tuple(x.shape[nbatch:]) != self.in_shape:
            raise ValueError(f"input shape {tuple(x.shape)} does not match "
                             f"{self.in_shape}")
        xb = x if nbatch else x[None]
        arena = self.arena(xb.shape[0], xb.dtype, xb.device)
        first = self.order[0]
        cur = self._buf(arena, first.name, self.in_shape)
        cur.copy_(xb)
        vals = {first.name: run_step(self.apply_node_fn, first, {}, [cur], out=cur)
                if first.views else cur}

        def dst(name):
            return self._buf(arena, name, self.layer_shapes[name])

        for seg in self.segments:
            vals.update(apply_dag_segment(self.steps, seg, params, vals,
                                          apply_node_fn=self.apply_node_fn, out=dst))
        y = vals[self.output].clone()
        return y if nbatch else y[0]


def make_dag_executor(graph: DAGGraph, plan: MemoryPlan, *,
                      apply_node_fn=apply_node) -> DagArenaExecutor:
    """The executor for (graph, plan); reuse it to reuse its arenas.  The
    graph must be the one ``plan_dag`` planned (fused the same way)."""
    return DagArenaExecutor(graph, plan, apply_node_fn=apply_node_fn)


_DAG_EXEC_CACHE: Dict[Tuple[int, int], Tuple[DAGGraph, MemoryPlan, DagArenaExecutor]] = {}


def _cached_dag_executor(graph: DAGGraph, plan: MemoryPlan) -> DagArenaExecutor:
    return cache_fifo(
        _DAG_EXEC_CACHE, (id(graph), id(plan)), _EXEC_CACHE_MAX,
        lambda: (graph, plan, make_dag_executor(graph, plan)),
        name="dag_exec",
    )[2]


def run_batch_dag_with_arena(
    graph: DAGGraph,
    plan: MemoryPlan,
    params,
    xs: torch.Tensor,  # (N, *in_shape)
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """N images through one reordered DAG plan; the arena is
    ``(N, arena_elems)``."""
    in_ndim = len(graph.nodes[0].layer.shape)
    if xs.ndim != in_ndim + 1:
        raise ValueError(f"expected batched input (N, ...), got {tuple(xs.shape)}")
    ex = _cached_dag_executor(graph, plan)
    out = ex(params, xs)
    stats = ex.stats()
    stats["batch"] = int(xs.shape[0])
    return out, stats


def run_dag_with_arena_scan(
    graph: DAGGraph,
    plan: MemoryPlan,
    params,
    x: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The executor's counterpart of :func:`run_dag_with_arena` (same
    signature): (output, stats), as :func:`run_with_arena_scan`."""
    ex = _cached_dag_executor(graph, plan)
    return ex(params, x), ex.stats()


# ---------------------------------------------------------------------------
# Ahead-of-time preparation (serving entry point)
# ---------------------------------------------------------------------------


class Compiled:
    """An executor prepared at one input shape and dtype by
    :func:`aot_compile`: called with ``(params, x)``, ``x`` of exactly that
    shape, dtype and device, else it raises ``TypeError`` (the reference's
    ``jax.stages.Compiled`` contract)."""

    def __init__(self, fn: Callable, x_shape, dtype: torch.dtype, device: torch.device):
        self.fn, self.x_shape, self.dtype, self.device = fn, tuple(x_shape), dtype, device

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.x_shape or x.dtype != self.dtype or x.device != self.device:
            raise TypeError(f"prepared for {self.x_shape} {self.dtype} on {self.device}, "
                            f"got {tuple(x.shape)} {x.dtype} on {x.device}")
        return self.fn(params, x)


def aot_compile(fn: Callable, params, x_shape, dtype: torch.dtype) -> Compiled:
    """``fn`` (an executor from :func:`make_scan_executor` or
    :func:`make_dag_executor`, float or int8) prepared now at input shape
    ``x_shape`` and ``dtype``: one call on zeros builds its kernels and
    allocates its arena for that batch, so the first request pays neither.
    It runs on the device of ``params``' first tensor.  Returns a
    :class:`Compiled` that takes exactly ``(params, x)`` at that shape.  No
    CUDA graph is captured."""
    tensors = [t for t in leaves(params) if isinstance(t, torch.Tensor)]
    if not tensors:
        raise ValueError("aot_compile: params hold no tensor to take a device from")
    dev = tensors[0].device
    fn(params, torch.zeros(tuple(x_shape), dtype=dtype, device=dev))
    return Compiled(fn, x_shape, dtype, dev)
