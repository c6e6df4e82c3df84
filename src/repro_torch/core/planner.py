"""Static activation-memory planner — the paper's §3.2/§3.3 contribution.

Framework-free copy of ``repro/core/planner.py``: the port's plans must
equal the reference's in bytes and in every buffer offset.

Given a :class:`~repro_torch.core.graph.SequentialGraph` the planner produces
byte-exact memory plans:

* ``plan_naive``        — every inter-layer buffer cached (paper's starting
                          point: 36,472 B for LeNet-5).
* ``plan_fused``        — after the §3.1 fusion pass (11,256 B for LeNet-5).
* ``plan_pingpong``     — two alternating buffers A/B (paper §3.2).  The
                          paper's bound is ``max1(L) + max2(L)``; the actual
                          alternating plan is ``max(even L) + max(odd L)`` ≤
                          the bound.  For the paper's networks they coincide
                          (8,800 B for LeNet-5, 11,264 B for the CIFAR net).
* ``plan_optimal_arena``— beyond-paper: offset-based arena packing.  With
                          strictly sequential execution buffer *i* is live
                          only while layers *i* and *i+1* execute, so the
                          optimal arena is ``max_i (L[i] + L[i+1] + scratch)``
                          — provably ≤ ping-pong, sometimes strictly smaller.
* ``plan_cmsis_baseline``— the CMSIS-NN-style allocator the paper compares
                          against in Table 1 (no conv/pool fusion, two
                          max-sized scratch line buffers, int16 im2col
                          partial-buffer per conv).

All plans carry explicit buffer offsets and are checked by
:func:`verify_plan` (no two simultaneously-live buffers overlap).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core import fusion as fusion_pass
from repro_torch.core.graph import (
    Conv2d,
    DepthwiseConv2d,
    FusedConvPool,
    Input,
    SequentialGraph,
    as_sequential,
)


@dataclasses.dataclass(frozen=True)
class BufferAssignment:
    name: str
    kind: str
    size_elems: int
    offset_elems: int
    # "A" | "B" | "unique" | "scratch" — the sequential two-bank plans;
    # "dag" — interval-packed reordered schedules (repro.core.schedule);
    # "ring" | "stream" — the streaming ring arena (repro.core.streaming):
    # rings persist across the whole emission schedule, "stream" buffers
    # are per-emission temporaries.  verify_plan / arena_timeline are
    # bank-agnostic; bank is provenance for reports and tests.
    bank: str
    live_from: int  # index of producing layer (in materialized-layer order)
    live_until: int  # index of consuming layer (inclusive)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    strategy: str
    buffers: Tuple[BufferAssignment, ...]
    arena_elems: int
    scratch_elems: int
    param_elems: int
    # Width of one activation element in bytes (4 = float32, 1 = int8).  Every
    # plan builder threads this through so byte accounting is dtype-accurate:
    # the paper's §5 int8 plans report arena *bytes* equal to arena elems.
    io_dtype_bytes: int = 4

    @property
    def total_activation_elems(self) -> int:
        return self.arena_elems + self.scratch_elems

    def activation_bytes(self, dtype_bytes: Optional[int] = None) -> int:
        db = self.io_dtype_bytes if dtype_bytes is None else dtype_bytes
        return self.total_activation_elems * db

    @property
    def arena_bytes(self) -> int:
        """Byte-accurate *arena* size (excluding scratch) in the plan's own
        activation dtype — the same quantity the executors report as
        ``stats['arena_bytes']``.  Use :meth:`activation_bytes` for the full
        activation RAM including scratch."""
        return self.arena_elems * self.io_dtype_bytes

    def param_bytes(self, dtype_bytes: int = 4) -> int:
        return self.param_elems * dtype_bytes

    def total_bytes(self, dtype_bytes: Optional[int] = None) -> int:
        """RAM + ROM total if parameters were *not* made read-only (§3.3)."""
        db = self.io_dtype_bytes if dtype_bytes is None else dtype_bytes
        return self.activation_bytes(db) + self.param_bytes(db)


def _materialized(graph: SequentialGraph, caller: str = "planner"):
    """(name, kind, size, scratch) for each buffer-owning layer, in order.

    All sequential plan builders funnel through here, so this is the shared
    validation/normalization point: chain-shaped DAGs are converted, branching
    DAGs raise a clear TypeError pointing at `repro.core.schedule.plan_dag`.
    """
    graph = as_sequential(graph, caller=caller)
    rows = []
    shapes = graph.shapes()
    cur_shape = ()
    for layer, shape in zip(graph.layers, shapes):
        scratch = 0
        if isinstance(layer, FusedConvPool):
            scratch = layer.scratch_elements(cur_shape)
        if layer.kind not in ("ReLU", "Flatten"):
            size = 1
            for d in shape:
                size *= int(d)
            rows.append((layer.name or layer.kind, layer.kind, size, scratch))
        cur_shape = shape
    return rows


def _buffers_unique(rows) -> Tuple[Tuple[BufferAssignment, ...], int]:
    """Every buffer gets its own slot (naive/fused caching plans)."""
    out: List[BufferAssignment] = []
    offset = 0
    for i, (name, kind, size, _scratch) in enumerate(rows):
        out.append(
            BufferAssignment(
                name=name,
                kind=kind,
                size_elems=size,
                offset_elems=offset,
                bank="unique",
                live_from=i,
                live_until=min(i + 1, len(rows) - 1),
            )
        )
        offset += size
    return tuple(out), offset


def plan_naive(graph: SequentialGraph, io_dtype_bytes: int = 4) -> MemoryPlan:
    rows = _materialized(graph, "plan_naive")
    buffers, arena = _buffers_unique(rows)
    return MemoryPlan(
        strategy="naive",
        buffers=buffers,
        arena_elems=arena,
        scratch_elems=sum(r[3] for r in rows),
        param_elems=graph.param_count(),
        io_dtype_bytes=io_dtype_bytes,
    )


def plan_fused(
    graph: SequentialGraph,
    allow_line_buffer: bool = True,
    io_dtype_bytes: int = 4,
) -> MemoryPlan:
    fused = fusion_pass.fuse(graph, allow_line_buffer=allow_line_buffer)
    rows = _materialized(fused)
    buffers, arena = _buffers_unique(rows)
    return MemoryPlan(
        strategy="fused",
        buffers=buffers,
        arena_elems=arena,
        scratch_elems=sum(r[3] for r in rows),
        param_elems=fused.param_count(),
        io_dtype_bytes=io_dtype_bytes,
    )


def plan_pingpong(
    graph: SequentialGraph,
    fused: bool = True,
    allow_line_buffer: bool = True,
    io_dtype_bytes: int = 4,
) -> MemoryPlan:
    """Paper §3.2: two alternating buffers.

    Buffers alternate banks A, B, A, B, ... starting with the input in A.
    ``size(A) = max(L[even])``, ``size(B) = max(L[odd])``; the paper's
    ``max1 + max2`` is an upper bound on ``size(A) + size(B)``.
    """
    g = fusion_pass.fuse(graph, allow_line_buffer=allow_line_buffer) if fused else graph
    rows = _materialized(g, "plan_pingpong")
    sizes = [r[2] for r in rows]
    size_a = max(sizes[0::2]) if sizes[0::2] else 0
    size_b = max(sizes[1::2]) if sizes[1::2] else 0
    buffers = []
    for i, (name, kind, size, _s) in enumerate(rows):
        bank = "A" if i % 2 == 0 else "B"
        buffers.append(
            BufferAssignment(
                name=name,
                kind=kind,
                size_elems=size,
                offset_elems=0 if bank == "A" else size_a,
                bank=bank,
                live_from=i,
                live_until=min(i + 1, len(rows) - 1),
            )
        )
    return MemoryPlan(
        strategy="pingpong" + ("" if fused else "-unfused"),
        buffers=tuple(buffers),
        arena_elems=size_a + size_b,
        scratch_elems=max((r[3] for r in rows), default=0),
        param_elems=g.param_count(),
        io_dtype_bytes=io_dtype_bytes,
    )


def paper_pingpong_bound(graph: SequentialGraph, fused: bool = True) -> int:
    """The paper's ``max_1st(L) + max_2nd(L)`` bound, in elements."""
    g = fusion_pass.fuse(graph) if fused else graph
    sizes = sorted((r[2] for r in _materialized(g, "paper_pingpong_bound")), reverse=True)
    if len(sizes) == 1:
        return sizes[0]
    return sizes[0] + sizes[1]


def plan_optimal_arena(
    graph: SequentialGraph,
    fused: bool = True,
    allow_line_buffer: bool = True,
    io_dtype_bytes: int = 4,
) -> MemoryPlan:
    """Beyond-paper: optimal offset-packed arena for a sequential chain.

    Liveness: buffer *i* is written by layer *i* and read by layer *i+1*, so
    it conflicts only with buffers *i−1* and *i+1*.  The optimal arena is
    ``M = max_i (L[i] + L[i+1])`` and is achieved by placing even buffers at
    offset 0 (growing up) and odd buffers at ``M − L[i]`` (growing down).
    Always ≤ the ping-pong plan; strictly smaller when the two largest
    buffers are non-adjacent (e.g. sizes [100, 1, 1, 100]: ping-pong 200,
    optimal 101).
    """
    g = fusion_pass.fuse(graph, allow_line_buffer=allow_line_buffer) if fused else graph
    rows = _materialized(g, "plan_optimal_arena")
    sizes = [r[2] for r in rows]
    scratches = [r[3] for r in rows]
    if len(sizes) == 1:
        pair_max = sizes[0]
    else:
        # While layer i+1 executes, live set = buf i + buf i+1 + scratch i+1.
        pair_max = max(
            sizes[i] + sizes[i + 1] + scratches[i + 1] for i in range(len(sizes) - 1)
        )
    buffers = []
    for i, (name, kind, size, _s) in enumerate(rows):
        if i % 2 == 0:
            offset = 0
        else:
            offset = pair_max - size
        buffers.append(
            BufferAssignment(
                name=name,
                kind=kind,
                size_elems=size,
                offset_elems=offset,
                bank="A" if i % 2 == 0 else "B",
                live_from=i,
                live_until=min(i + 1, len(rows) - 1),
            )
        )
    return MemoryPlan(
        strategy="optimal-arena",
        buffers=tuple(buffers),
        arena_elems=pair_max,
        scratch_elems=0,  # folded into pair_max above
        param_elems=g.param_count(),
        io_dtype_bytes=io_dtype_bytes,
    )


def plan_cmsis_baseline(graph: SequentialGraph, io_dtype_bytes: int = 1) -> MemoryPlan:
    """The related-work allocator (CMSIS-NN, Lai et al. 2018) as the paper
    describes it: *"CMSIS-NN uses maximum of the output size of the layers as
    scratch line buffers"* — i.e. two reusable max-sized buffers but **no**
    conv/pool fusion, plus the int16 ``bufferA`` im2col scratch each conv
    needs (``2 · in_ch · k²`` int16 elements in the CMSIS-NN kernels).

    Returned sizes are in *elements* of the activation dtype; the im2col
    scratch is reported in elements too (already scaled by 2/io_dtype_bytes
    so that ``activation_bytes(io_dtype_bytes)`` is correct for int8 nets).
    """
    rows = _materialized(graph, "plan_cmsis_baseline")  # unfused
    sizes = sorted((r[2] for r in rows), reverse=True)
    arena = sizes[0] + (sizes[1] if len(sizes) > 1 else 0)
    im2col_int16 = 0
    for layer in graph.layers:
        # arm_convolve / arm_depthwise_separable_conv alike need bufferA of
        # 2·ch·kh·kw int16 elements (ch = input channels; = channels depthwise).
        if isinstance(layer, (Conv2d, DepthwiseConv2d)):
            ch = layer.in_channels if isinstance(layer, Conv2d) else layer.channels
            kh, kw = layer.kernel_size
            im2col_int16 = max(im2col_int16, 2 * ch * kh * kw)
    scratch_elems = im2col_int16 * 2 // io_dtype_bytes  # int16 → io dtype units
    buffers, _ = _buffers_unique(rows)
    return MemoryPlan(
        strategy="cmsis-baseline",
        buffers=buffers,
        arena_elems=arena,
        scratch_elems=scratch_elems,
        param_elems=graph.param_count(),
        io_dtype_bytes=io_dtype_bytes,
    )


@dataclasses.dataclass(frozen=True)
class StackedRun:
    """A maximal run of homogeneous materialized layers (stacked-weight
    metadata for the scan executor, :mod:`repro_torch.core.pingpong`).

    Layers in one run have identical specs (same kind and hyper-parameters,
    hence identical parameter shapes) and identical in/out buffer shapes, so
    their weights stack along a new leading axis and the run executes as one
    ``lax.scan`` with a donated two-bank carry — the plan's A/B banks.
    ``start`` indexes the materialized-layer order (the same order as
    ``MemoryPlan.buffers[1:]``); a run of ``length`` 1 is executed unrolled.
    """

    start: int
    length: int
    kind: str
    layer_names: Tuple[str, ...]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    @property
    def stacked(self) -> bool:
        return self.length > 1


# Layer identity modulo names — now the public spec-isomorphism key in
# `repro_torch.core.graph` (the segment compiler uses it across branches too).
from repro_torch.core.graph import spec_key as _spec_key  # noqa: E402


def materialized_steps(graph: SequentialGraph):
    """``(pre_views, steps)``: the executor/segmenter step structure.

    ``pre_views`` are view layers (ReLU/Flatten) acting directly on the
    input; ``steps`` holds one ``[layer, views, in_shape, out_shape]`` entry
    per materialized layer, where ``views`` are the view layers applied to
    its output before the next materialized layer.  Steps line up 1:1 with
    ``MemoryPlan.buffers[1:]``.
    """
    graph = as_sequential(graph, caller="materialized_steps")
    pre_views, steps = [], []
    cur_shape: Tuple[int, ...] = ()
    for layer, shape in zip(graph.layers, graph.shapes()):
        if isinstance(layer, Input):
            cur_shape = shape
            continue
        if layer.kind in ("ReLU", "Flatten"):
            if steps:
                steps[-1][1].append(layer)
                steps[-1][3] = shape
            else:
                pre_views.append(layer)
            cur_shape = shape
            continue
        steps.append([layer, [], cur_shape, shape])
        cur_shape = shape
    return pre_views, steps


def scan_segments(graph: SequentialGraph) -> Tuple[StackedRun, ...]:
    """Partition the graph's materialized layers into maximal stackable runs.

    Each *step* is one materialized layer plus the view layers (ReLU/Flatten)
    that follow it before the next materialized layer; two steps belong to the
    same run iff their layer specs (ignoring names), trailing view kinds, and
    in/out shapes all coincide.  View layers change no buffer, so a run's
    scan carry keeps a constant shape by construction.

    Thin compatibility shim: the partition itself now lives in the segment
    compiler (`repro_torch.core.segments.sequential_segments`), shared with the
    DAG executors.
    """
    from repro_torch.core import segments as segments_mod

    _, steps = materialized_steps(graph)
    runs: List[StackedRun] = []
    for seg in segments_mod.sequential_segments(graph):
        runs.append(
            StackedRun(
                start=seg.start,
                length=seg.length,
                kind=seg.kind,
                layer_names=seg.branches[0],
                in_shape=tuple(steps[seg.start][2]),
                out_shape=tuple(steps[seg.start][3]),
            )
        )
    return tuple(runs)


def verify_plan(plan: MemoryPlan) -> None:
    """Check that simultaneously-live buffers never overlap in the arena.

    Buffers i and j are simultaneously live iff their [live_from, live_until]
    windows intersect.  Offsets are arbitrary — the check covers the banked
    sequential plans (ping-pong, optimal-arena) and the reordered DAG plans
    from `repro.core.schedule` (interval-packed offsets, multi-consumer live
    ranges) alike.  Also checks live ranges are well-formed and every buffer
    fits inside the declared arena.
    """
    bufs = plan.buffers
    for a in bufs:
        if a.live_from > a.live_until or a.live_from < 0:
            raise AssertionError(
                f"plan {plan.strategy!r}: buffer {a.name!r} has malformed "
                f"live range [{a.live_from}, {a.live_until}]"
            )
        if a.offset_elems < 0 or a.offset_elems + a.size_elems > plan.arena_elems:
            raise AssertionError(
                f"plan {plan.strategy!r}: buffer {a.name!r} "
                f"[{a.offset_elems},{a.offset_elems + a.size_elems}) exceeds "
                f"arena [0,{plan.arena_elems})"
            )
    for i in range(len(bufs)):
        for j in range(i + 1, len(bufs)):
            a, b = bufs[i], bufs[j]
            if a.live_until < b.live_from or b.live_until < a.live_from:
                continue  # never live together
            a_end = a.offset_elems + a.size_elems
            b_end = b.offset_elems + b.size_elems
            if a.offset_elems < b_end and b.offset_elems < a_end:
                raise AssertionError(
                    f"plan {plan.strategy!r}: buffers {a.name!r} "
                    f"[{a.offset_elems},{a_end}) and {b.name!r} "
                    f"[{b.offset_elems},{b_end}) overlap while both live"
                )


@dataclasses.dataclass(frozen=True)
class DeploymentReport:
    """§3.3/§4-style accounting: RAM (arena) vs ROM (read-only params)."""

    ram_bytes: int
    rom_bytes: int
    strategy: str

    @staticmethod
    def from_plan(plan: MemoryPlan, dtype_bytes: Optional[int] = None, param_dtype_bytes: Optional[int] = None) -> "DeploymentReport":
        db = plan.io_dtype_bytes if dtype_bytes is None else dtype_bytes
        pdb = db if param_dtype_bytes is None else param_dtype_bytes
        return DeploymentReport(
            ram_bytes=plan.activation_bytes(db),
            rom_bytes=plan.param_bytes(pdb),
            strategy=plan.strategy,
        )
