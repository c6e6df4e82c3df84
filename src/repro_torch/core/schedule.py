"""Operator-reordering arena planner for DAG graphs.

Framework-free copy of ``repro/core/schedule.py`` (the JAX package is the
reference and is not imported).  The search and the packing iterate dicts
and sets in the reference's order, so both packages give the same schedule
and the same offsets.

The paper names "layer manipulation i.e. operator reordering" as a memory
lever but only implements the sequential ping-pong case; on *branching*
graphs the execution order of independent branches changes which buffers
coexist, and choosing the order is where the real peak-memory wins live
(Liberis & Lane, arXiv:1910.05110).  This module supplies that planner:

1. **Materialize** (:func:`materialize_dag`) — fold single-consumer view
   chains (ReLU/Flatten) into their producer's buffer, exactly the paper's
   "ReLU can be part of the convolution layer" discipline, generalized to
   DAGs (a view whose producer has other consumers stays a real copy step).
2. **Reorder** (:func:`search_order`) — branch-and-bound over topological
   orders of the materialized steps, minimizing peak live memory.  Exact for
   the graph sizes this repo plans (the search space is pruned against the
   incumbent peak); an expansion budget caps pathological graphs, falling
   back to the best order found.
3. **Allocate** (:func:`plan_dag`) — assign every buffer a byte offset in
   one static arena with a general lifetime-interval allocator
   (first-fit/best-fit heuristics, then branch-and-bound placement when the
   heuristics miss the liveness lower bound).  On chain graphs the planner
   additionally computes the paper's two-bank ping-pong packing and keeps
   whichever is smaller, so it *provably subsumes* `planner.plan_pingpong`
   (same bytes or better on every sequential graph).

Plans come back as ordinary :class:`repro_torch.core.planner.MemoryPlan`
objects — ``buffers[i]`` is the buffer written by schedule step *i*, with
live ranges in step indices — so `planner.verify_plan` and the arena
executors (`repro_torch.core.pingpong`, `repro_torch.quant.exec`) consume
them unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core import fusion as fusion_pass
from repro_torch.core.graph import DAGGraph, FusedConvPool, SequentialGraph, Shape
from repro_torch.core.planner import BufferAssignment, MemoryPlan

_VIEW_KINDS = ("ReLU", "Flatten")


def _prod(shape: Sequence[int]) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


@dataclasses.dataclass(frozen=True)
class Step:
    """One buffer-owning schedule step: a materialized node plus the view
    layers folded into its buffer."""

    name: str
    layer: object
    views: Tuple[object, ...]
    inputs: Tuple[str, ...]  # names of the producing *steps*
    in_shapes: Tuple[Shape, ...]
    out_shape: Shape
    size_elems: int
    scratch_elems: int


@dataclasses.dataclass(frozen=True)
class MaterializedDAG:
    """The buffer-level view of a DAG: steps, plus the node→step alias map."""

    graph: DAGGraph
    steps: Tuple[Step, ...]
    alias: Dict[str, str]  # every node name -> owning step name
    output: str  # step owning the graph output

    def step(self, name: str) -> Step:
        for s in self.steps:
            if s.name == name:
                return s
        raise KeyError(name)

    def consumers(self) -> Dict[str, Tuple[str, ...]]:
        out: Dict[str, List[str]] = {s.name: [] for s in self.steps}
        for s in self.steps:
            for src in s.inputs:
                if s.name not in out[src]:
                    out[src].append(s.name)
        return {k: tuple(v) for k, v in out.items()}


def materialize_dag(graph: DAGGraph) -> MaterializedDAG:
    """Fold view chains into producer buffers; return buffer-owning steps.

    A ReLU/Flatten node folds into its input's step iff it is that value's
    *only* consumer (in-place is then safe); otherwise it materializes as a
    copy step of its own.  Step order is the graph's listing order — the
    naive schedule.
    """
    cons = graph.consumers()
    shapes = graph.shapes()
    alias: Dict[str, str] = {}
    # name -> mutable [layer, views, inputs, out_shape, scratch]
    acc: Dict[str, list] = {}
    order: List[str] = []

    for node in graph.nodes:
        kind = node.layer.kind
        if kind in _VIEW_KINDS and node.inputs:
            src = node.inputs[0]
            if cons[src] == (node.name,) and src != graph.output:
                owner = alias[src]
                alias[node.name] = owner
                acc[owner][1].append(node.layer)
                acc[owner][3] = shapes[node.name]
                continue
        owner = node.name
        alias[node.name] = owner
        in_steps = tuple(alias[s] for s in node.inputs)
        in_shapes = tuple(tuple(acc[s][3]) for s in in_steps)
        scratch = 0
        if isinstance(node.layer, FusedConvPool) and in_shapes:
            scratch = node.layer.scratch_elements(in_shapes[0])
        acc[owner] = [node.layer, [], in_steps, shapes[node.name], scratch]
        order.append(owner)

    steps = tuple(
        Step(
            name=name,
            layer=acc[name][0],
            views=tuple(acc[name][1]),
            inputs=acc[name][2],
            in_shapes=tuple(tuple(acc[s][3]) for s in acc[name][2]),
            out_shape=tuple(acc[name][3]),
            size_elems=_prod(acc[name][3]),
            scratch_elems=acc[name][4],
        )
        for name in order
    )
    # in_shapes above must be the *final* shape of each producer step (after
    # its folded views), which acc holds once the whole walk is done — hence
    # the second pass recomputing in_shapes from the finished acc.
    return MaterializedDAG(
        graph=graph, steps=steps, alias=dict(alias), output=alias[graph.output]
    )


# ---------------------------------------------------------------------------
# Schedules: topological orders over materialized steps
# ---------------------------------------------------------------------------


def naive_order(mat: MaterializedDAG) -> Tuple[str, ...]:
    """The graph's listing order — the baseline the search must beat."""
    return tuple(s.name for s in mat.steps)


def is_topological(mat: MaterializedDAG, order: Sequence[str]) -> bool:
    """True iff ``order`` schedules every step exactly once, inputs first."""
    if sorted(order) != sorted(s.name for s in mat.steps):
        return False
    pos = {name: i for i, name in enumerate(order)}
    return all(pos[src] < pos[s.name] for s in mat.steps for src in s.inputs)


def death_positions(mat: MaterializedDAG, order: Sequence[str]) -> Dict[str, int]:
    """Step name -> last position at which its buffer is read (the output
    buffer lives to the end)."""
    pos = {name: i for i, name in enumerate(order)}
    death = {name: pos[name] for name in pos}
    for s in mat.steps:
        for src in s.inputs:
            death[src] = max(death[src], pos[s.name])
    death[mat.output] = len(order) - 1
    return death


def schedule_peak(mat: MaterializedDAG, order: Sequence[str]) -> int:
    """Peak live memory (elements, incl. per-step scratch) of a schedule.

    At the position executing step *v*, the live set is every buffer born at
    or before that position whose last consumer has not yet run, plus *v*'s
    own output buffer and scratch.
    """
    pos = {name: i for i, name in enumerate(order)}
    death = death_positions(mat, order)
    steps = {s.name: s for s in mat.steps}
    peak = 0
    for t, name in enumerate(order):
        live = sum(
            steps[n].size_elems
            for n in order[: t + 1]
            if death[n] >= t
        )
        peak = max(peak, live + steps[name].scratch_elems)
    return peak


def topological_orders(
    mat: MaterializedDAG, limit: Optional[int] = None
) -> Iterator[Tuple[str, ...]]:
    """Yield topological orders (deterministic, listing-order tie-break).

    ``limit`` caps the number of orders yielded.
    """
    steps = mat.steps
    indeg = {s.name: len(set(s.inputs)) for s in steps}
    out_edges = mat.consumers()
    count = 0

    def rec(sched: List[str], indeg: Dict[str, int]) -> Iterator[Tuple[str, ...]]:
        nonlocal count
        if limit is not None and count >= limit:
            return
        if len(sched) == len(steps):
            count += 1
            yield tuple(sched)
            return
        for s in steps:
            if s.name in indeg and indeg[s.name] == 0:
                nxt = dict(indeg)
                del nxt[s.name]
                for c in out_edges[s.name]:
                    nxt[c] -= 1
                sched.append(s.name)
                yield from rec(sched, nxt)
                sched.pop()
                if limit is not None and count >= limit:
                    return

    yield from rec([], indeg)


def search_order(
    mat: MaterializedDAG, *, budget: int = 20000
) -> Tuple[Tuple[str, ...], int]:
    """Find a topological order minimizing peak live memory.

    Branch-and-bound: partial schedules whose running peak already matches
    or exceeds the incumbent are pruned; a state cap of ``budget`` node
    expansions bounds pathological graphs (the incumbent — seeded with the
    naive order and a greedy min-live-after order — is returned then).
    Returns ``(order, peak_elems)``.
    """
    steps = {s.name: s for s in mat.steps}
    out_edges = mat.consumers()
    n_cons = {name: len(c) for name, c in out_edges.items()}
    listing = [s.name for s in mat.steps]

    def greedy() -> Tuple[str, ...]:
        indeg = {s.name: len(set(s.inputs)) for s in mat.steps}
        pending = dict(n_cons)
        live: Dict[str, int] = {}
        sched: List[str] = []
        while indeg:
            best_name, best_after = None, None
            for name in listing:
                if name not in indeg or indeg[name] != 0:
                    continue
                freed = sum(
                    steps[src].size_elems
                    for src in set(steps[name].inputs)
                    if pending[src] == 1
                )
                after = sum(live.values()) + steps[name].size_elems - freed
                if best_after is None or after < best_after:
                    best_name, best_after = name, after
            assert best_name is not None
            sched.append(best_name)
            del indeg[best_name]
            for c in out_edges[best_name]:
                indeg[c] -= 1
            live[best_name] = steps[best_name].size_elems
            if n_cons[best_name] == 0 and best_name != mat.output:
                live.pop(best_name, None)
            for src in set(steps[best_name].inputs):
                pending[src] -= 1
                if pending[src] == 0 and src != mat.output:
                    live.pop(src, None)
        return tuple(sched)

    candidates = [naive_order(mat), greedy()]
    best_order = min(candidates, key=lambda o: schedule_peak(mat, o))
    best_peak = schedule_peak(mat, best_order)

    expansions = 0

    def rec(sched: List[str], indeg: Dict[str, int], pending: Dict[str, int],
            live: Dict[str, int], peak: int) -> None:
        nonlocal best_order, best_peak, expansions
        if len(sched) == len(steps):
            if peak < best_peak:
                best_peak, best_order = peak, tuple(sched)
            return
        for name in listing:
            if expansions >= budget:
                return
            if name not in indeg or indeg[name] != 0:
                continue
            expansions += 1
            step = steps[name]
            new_live = sum(live.values()) + step.size_elems
            new_peak = max(peak, new_live + step.scratch_elems)
            if new_peak >= best_peak:
                continue  # prune: cannot improve on the incumbent
            nxt_indeg = dict(indeg)
            del nxt_indeg[name]
            for c in out_edges[name]:
                nxt_indeg[c] -= 1
            nxt_pending = dict(pending)
            nxt_live = dict(live)
            nxt_live[name] = step.size_elems
            if n_cons[name] == 0 and name != mat.output:
                nxt_live.pop(name, None)
            for src in set(step.inputs):
                nxt_pending[src] -= 1
                if nxt_pending[src] == 0 and src != mat.output:
                    nxt_live.pop(src, None)
            sched.append(name)
            rec(sched, nxt_indeg, nxt_pending, nxt_live, new_peak)
            sched.pop()

    rec([], {s.name: len(set(s.inputs)) for s in mat.steps}, dict(n_cons), {}, 0)
    return best_order, best_peak


# ---------------------------------------------------------------------------
# Lifetime-interval offset allocation
# ---------------------------------------------------------------------------


def _liveness_lower_bound(sizes, intervals) -> int:
    """max over time of the summed live sizes — the packing lower bound."""
    t_max = max(b for _, b in intervals)
    return max(
        sum(s for s, (a, b) in zip(sizes, intervals) if a <= t <= b)
        for t in range(t_max + 1)
    )


def pack_intervals(
    sizes: Sequence[int],
    intervals: Sequence[Tuple[int, int]],
    *,
    budget: int = 200000,
) -> Tuple[List[int], int]:
    """Assign offsets to lifetime intervals, minimizing the arena size.

    Runs first-fit heuristics (by birth, by decreasing size, by decreasing
    size×lifetime area — the strip-packing ordering that wins when small
    long-lived buffers must thread between large short-lived ones); if none
    reaches the liveness lower bound, a branch-and-bound placement search
    (candidate offsets: 0 and the ends of conflicting placed buffers) runs
    under an expansion ``budget``.  Returns ``(offsets, arena_elems)``.
    """
    n = len(sizes)
    if n == 0:
        return [], 0
    conflicts: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            (a0, a1), (b0, b1) = intervals[i], intervals[j]
            if not (a1 < b0 or b1 < a0):
                conflicts[i].append(j)
                conflicts[j].append(i)
    lb = _liveness_lower_bound(sizes, intervals)

    def first_fit(order: Sequence[int]) -> Tuple[List[int], int]:
        offsets = [0] * n
        placed: List[int] = []
        for i in order:
            cands = {0}
            for j in placed:
                if j in conflicts[i]:
                    cands.add(offsets[j] + sizes[j])
            best = None
            for off in sorted(cands):
                if all(
                    j not in conflicts[i]
                    or off + sizes[i] <= offsets[j]
                    or offsets[j] + sizes[j] <= off
                    for j in placed
                ):
                    best = off
                    break
            offsets[i] = best
            placed.append(i)
        return offsets, max(offsets[i] + sizes[i] for i in range(n))

    by_birth = list(range(n))
    by_size = sorted(range(n), key=lambda i: (-sizes[i], i))
    by_area = sorted(
        range(n),
        key=lambda i: (-sizes[i] * (intervals[i][1] - intervals[i][0] + 1), i),
    )
    best_off, best_arena = first_fit(by_birth)
    for order in (by_size, by_area):
        off2, arena2 = first_fit(order)
        if arena2 < best_arena:
            best_off, best_arena = off2, arena2
    if best_arena == lb:
        return best_off, best_arena

    # Branch-and-bound placement.  Any gap-free ("pushed-down") packing can
    # be built by placing buffers in non-decreasing final-offset order, each
    # at offset 0 or on top of an already-placed time-conflicting buffer —
    # so branching over (next buffer, supported offset ≥ current frontier)
    # pairs explores a complete space, pruned against the incumbent arena.
    expansions = 0
    offsets = [0] * n

    def rec(placed: List[int], remaining: List[int], frontier: int,
            arena_so_far: int) -> None:
        nonlocal best_off, best_arena, expansions
        if arena_so_far >= best_arena:
            return
        if not remaining:
            best_off, best_arena = list(offsets), arena_so_far
            return
        for i in remaining:
            cands = {0}
            for j in placed:
                if j in conflicts[i]:
                    cands.add(offsets[j] + sizes[j])
            for off in sorted(c for c in cands if c >= frontier):
                if expansions >= budget or best_arena == lb:
                    return
                if off + sizes[i] >= best_arena:
                    break  # sorted: the rest only grow the arena
                if any(
                    j in conflicts[i]
                    and off < offsets[j] + sizes[j]
                    and offsets[j] < off + sizes[i]
                    for j in placed
                ):
                    continue
                expansions += 1
                offsets[i] = off
                rec(placed + [i], [r for r in remaining if r != i], off,
                    max(arena_so_far, off + sizes[i]))

    rec([], by_size, 0, 0)
    return best_off, best_arena


# ---------------------------------------------------------------------------
# Plan building
# ---------------------------------------------------------------------------


def check_dag_plan(graph: DAGGraph, plan: MemoryPlan):
    """Validate a reordered DAG plan against its graph.

    The plan's buffer order *is* the schedule: ``plan.buffers[i]`` names the
    materialized step executed at position *i*.  Checks the names cover the
    materialized steps exactly and the order is topological.  Returns
    ``(materialized, order)``.  Shared by the executors
    (`repro_torch.core.pingpong`, `repro_torch.quant.exec`).
    """
    if not isinstance(graph, DAGGraph):
        raise TypeError(
            f"check_dag_plan expects DAGGraph, got {type(graph).__name__} — "
            f"use the sequential executors for SequentialGraph"
        )
    mat = materialize_dag(graph)
    order = tuple(b.name for b in plan.buffers)
    names = sorted(s.name for s in mat.steps)
    if sorted(order) != names:
        raise ValueError(
            f"plan buffers {sorted(order)} do not match the graph's "
            f"materialized steps {names} — fuse the graph with the same "
            f"options as the plan"
        )
    if not is_topological(mat, order):
        raise ValueError(f"plan buffer order {order} is not topological")
    return mat, order


def _is_chain(mat: MaterializedDAG, order: Sequence[str]) -> bool:
    steps = {s.name: s for s in mat.steps}
    return all(
        steps[name].inputs == (order[i - 1],)
        for i, name in enumerate(order)
        if i > 0
    ) and mat.output == order[-1]


def _pingpong_pack(mat: MaterializedDAG, order: Sequence[str]):
    """The paper's §3.2 two-bank packing — chain schedules only."""
    steps = {s.name: s for s in mat.steps}
    sizes = [steps[name].size_elems for name in order]
    size_a = max(sizes[0::2]) if sizes[0::2] else 0
    offsets = [0 if i % 2 == 0 else size_a for i in range(len(order))]
    return offsets, size_a + (max(sizes[1::2]) if sizes[1::2] else 0)


def _priced_arena(
    mat: MaterializedDAG, *, search_budget: int, pack_budget: int
) -> Tuple[int, int]:
    """``(arena_elems, scratch_elems)`` the planner would assign to ``mat``.

    The pricing primitive for schedule-aware fusion: reorder-search +
    interval-pack, no offsets kept.  ``arena + scratch`` is exactly the
    ``total_activation_elems`` a :func:`plan_dag` plan of the same graph
    reports.
    """
    order, _ = search_order(mat, budget=search_budget)
    steps = {s.name: s for s in mat.steps}
    death = death_positions(mat, order)
    pos = {name: i for i, name in enumerate(order)}
    sizes = [steps[name].size_elems for name in order]
    intervals = [(pos[name], death[name]) for name in order]
    _, arena = pack_intervals(sizes, intervals, budget=pack_budget)
    if _is_chain(mat, order):
        # plan_dag prices the two-bank ping-pong packing on chains and keeps
        # the smaller arena — the pricer must apply the same candidate or its
        # cost model diverges from the plan it predicts.
        _, pp_arena = _pingpong_pack(mat, order)
        arena = min(arena, pp_arena)
    return arena, max((s.scratch_elems for s in mat.steps), default=0)


def fuse_dag_priced(
    graph: DAGGraph,
    *,
    allow_line_buffer: bool = True,
    search_budget: int = 20000,
    pack_budget: int = 200000,
) -> DAGGraph:
    """Schedule-aware fusion: keep only the windows the memory plan says pay.

    `repro_torch.core.fusion.fuse_dag` fuses *every* sole-consumer window; here
    each candidate window that could cost memory is priced through the
    planner — reorder-search and interval-pack the graph with and without
    the window — and declined when dropping it yields strictly fewer
    activation elements (arena + scratch).  Only ``stride < kernel``
    windows need pricing: a zero-scratch §3.1 window removes a buffer and
    charges nothing, so it can never raise the plan and always stays fused
    (and the paper nets — LeNet-5, the §5 CIFAR net, `residual_cifar` —
    therefore plan identically to plain :func:`fuse_dag`, at no extra
    search cost).  A line-buffer window whose conv-output elimination does
    not lower the peak still charges its scratch — the §7 trade-off — so
    the plan says it does not pay; windows that price equal stay fused
    (fewer dispatches, same bytes).

    Greedy single pass: windows are reconsidered against the current
    selection in discovery order.
    """
    if isinstance(graph, SequentialGraph):
        graph = DAGGraph.from_sequential(graph)
    cands = fusion_pass.fusion_candidates(graph, allow_line_buffer=allow_line_buffer)
    priceable = [head for head, line_rows in cands if line_rows > 0]
    if not priceable:
        return fusion_pass.fuse_dag(graph, allow_line_buffer=allow_line_buffer)

    def price(selected) -> int:
        g2 = fusion_pass.fuse_dag(
            graph,
            allow_line_buffer=allow_line_buffer,
            window_filter=lambda head: head in selected,
        )
        arena, scratch = _priced_arena(
            materialize_dag(g2),
            search_budget=search_budget,
            pack_budget=pack_budget,
        )
        return arena + scratch

    selected = {head for head, _ in cands}
    cost = price(selected)
    for head in priceable:
        trial_cost = price(selected - {head})
        if trial_cost < cost:
            selected.discard(head)
            cost = trial_cost
    return fusion_pass.fuse_dag(
        graph,
        allow_line_buffer=allow_line_buffer,
        window_filter=lambda head: head in selected,
    )


def assemble_plan(
    entries: Sequence[Tuple[str, str, int, str, int, int]],
    *,
    strategy: str,
    param_elems: int,
    io_dtype_bytes: int = 4,
    scratch_elems: int = 0,
    pack_budget: int = 200000,
    offsets: Optional[Sequence[int]] = None,
    arena_elems: Optional[int] = None,
) -> MemoryPlan:
    """Pack lifetime entries into one arena and build the :class:`MemoryPlan`.

    ``entries`` is ``(name, kind, size_elems, bank, live_from, live_until)``
    per buffer: the shared tail of the interval-priced planners
    (:func:`plan_dag` funnels its reordered schedule through here).
    Callers that already chose offsets (e.g. the two-bank ping-pong
    fallback) pass ``offsets``/``arena_elems`` and skip the packing.
    """
    sizes = [e[2] for e in entries]
    if offsets is None:
        intervals = [(e[4], e[5]) for e in entries]
        offsets, arena_elems = pack_intervals(sizes, intervals, budget=pack_budget)
    elif arena_elems is None:
        arena_elems = max(
            (off + sz for off, sz in zip(offsets, sizes)), default=0
        )
    buffers = tuple(
        BufferAssignment(
            name=name,
            kind=kind,
            size_elems=size,
            offset_elems=offsets[i],
            bank=bank,
            live_from=live_from,
            live_until=live_until,
        )
        for i, (name, kind, size, bank, live_from, live_until) in enumerate(entries)
    )
    return MemoryPlan(
        strategy=strategy,
        buffers=buffers,
        arena_elems=arena_elems,
        scratch_elems=scratch_elems,
        param_elems=param_elems,
        io_dtype_bytes=io_dtype_bytes,
    )


def plan_dag(
    graph,
    order: Optional[Sequence[str]] = None,
    *,
    fused: bool = True,
    schedule_priced: bool = True,
    allow_line_buffer: bool = True,
    io_dtype_bytes: int = 4,
    search_budget: int = 20000,
    pack_budget: int = 200000,
) -> MemoryPlan:
    """Operator-reordering arena plan for a DAG (or sequential) graph.

    Fuses (§3.1, schedule-priced by default: :func:`fuse_dag_priced` asks
    the planner whether each window pays), searches topological orders for
    minimum peak live memory, then packs buffer lifetimes into one arena.
    On chain graphs the result is provably ≤ the paper's ping-pong plan: the
    two-bank packing is computed as a fallback candidate and the smaller
    arena wins.

    ``order`` forces a specific schedule (must be topological over the
    materialized steps) — used to price the naive listing order and by tests.
    ``schedule_priced=False`` reverts to fusing every sole-consumer window.
    Returns a :class:`MemoryPlan` whose ``buffers[i]`` is step *i*'s output
    buffer; executors recover the schedule from the buffer name order.
    """
    if isinstance(graph, SequentialGraph):
        graph = DAGGraph.from_sequential(graph)
    if not isinstance(graph, DAGGraph):
        raise TypeError(
            f"plan_dag expects DAGGraph or SequentialGraph, got {type(graph).__name__}"
        )
    if fused and schedule_priced:
        g = fuse_dag_priced(
            graph,
            allow_line_buffer=allow_line_buffer,
            search_budget=search_budget,
            pack_budget=pack_budget,
        )
    elif fused:
        g = fusion_pass.fuse_dag(graph, allow_line_buffer=allow_line_buffer)
    else:
        g = graph
    mat = materialize_dag(g)

    if order is None:
        order, _ = search_order(mat, budget=search_budget)
    else:
        order = tuple(order)
        if not is_topological(mat, order):
            raise ValueError(
                f"order {order} is not a topological order of the materialized "
                f"steps {[s.name for s in mat.steps]}"
            )

    steps = {s.name: s for s in mat.steps}
    death = death_positions(mat, order)
    pos = {name: i for i, name in enumerate(order)}
    sizes = [steps[name].size_elems for name in order]
    intervals = [(pos[name], death[name]) for name in order]

    offsets, arena = pack_intervals(sizes, intervals, budget=pack_budget)
    strategy = "dag-reorder"
    if _is_chain(mat, order):
        pp_offsets, pp_arena = _pingpong_pack(mat, order)
        if pp_arena < arena:
            offsets, arena = pp_offsets, pp_arena
            strategy = "dag-pingpong"

    return assemble_plan(
        [
            (name, steps[name].layer.kind, sizes[i], "dag", i, death[name])
            for i, name in enumerate(order)
        ],
        strategy=strategy,
        param_elems=g.param_count(),
        io_dtype_bytes=io_dtype_bytes,
        scratch_elems=max((s.scratch_elems for s in mat.steps), default=0),
        offsets=offsets,
        arena_elems=arena,
    )
