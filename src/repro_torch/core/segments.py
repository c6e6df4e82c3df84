"""Segment partition of a schedule, plus the shared FIFO memo.

Framework-free copy of ``repro/core/segments.py``.  The reference stacks
each segment into one ``lax.scan`` (or one ``vmap`` of isomorphic
branches); PyTorch has no scan, so the port's executors run every step in
plan order and keep the partition for their stats, where it must equal the
reference's.  Batching isomorphic branches into one launch is later work.

Three segment shapes exist, all one :class:`Segment` record:

* **single step** — one branch of length 1 (joins, heterogeneous layers).
* **stacked chain run** — one branch of length L>1: a sole-consumer run of
  spec-identical steps (same kind, hyper-parameters, views and shapes), or
  on DAG schedules a spec-periodic run (DS-CNN's alternating dw/pw
  backbone, period 2).
* **batched isomorphic branches** — B>1 branches, pairwise identical specs
  and mutually independent (DAG schedules only).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.graph import spec_key


@dataclasses.dataclass(frozen=True)
class Segment:
    """One executable unit of a schedule.

    ``branches`` holds ≥1 name tuples, all the same length; ``start`` is the
    index of the first covered step in the materialized-step list.
    ``period`` is the spec period of a stacked run (1: every step
    isomorphic to the first).
    """

    start: int
    kind: str
    branches: Tuple[Tuple[str, ...], ...]
    period: int = 1

    @property
    def steps_per_branch(self) -> int:
        """Schedule steps covered per branch (= length · period)."""
        return len(self.branches[0])

    @property
    def length(self) -> int:
        """Iterations of the (period-long) body per branch."""
        return len(self.branches[0]) // self.period

    @property
    def n_branches(self) -> int:
        return len(self.branches)

    @property
    def names(self) -> Tuple[str, ...]:
        """All covered step names, in schedule order."""
        return tuple(n for br in self.branches for n in br)

    @property
    def stacked(self) -> bool:
        """True iff the segment covers a run of isomorphic steps (L>1)."""
        return self.length > 1

    @property
    def batched(self) -> bool:
        """True iff the segment batches isomorphic branches (B>1)."""
        return self.n_branches > 1

    @property
    def periodic(self) -> bool:
        """True iff the run body covers more than one phase layer."""
        return self.period > 1


def cache_fifo(cache: Dict, key, max_entries: int, build: Callable,
               name: str = ""):
    """Bounded-FIFO memo shared by the executor caches (here,
    `repro_torch.core.pingpong` and `repro_torch.quant.exec`).  The cached
    value must hold strong references to every object whose ``id`` appears
    in ``key`` — that is what keeps the id-based keys valid for the entry's
    lifetime.

    A non-empty ``name`` reports ``cache.<name>.hits`` / ``.builds`` /
    ``.evictions`` counters into the process-global
    :data:`repro_torch.obs.metrics.REGISTRY`.
    """
    metrics = _registry() if name else None
    hit = cache.get(key)
    if hit is None:
        while len(cache) >= max_entries:
            cache.pop(next(iter(cache)))
            if metrics is not None:
                metrics.inc(f"cache.{name}.evictions")
        hit = cache[key] = build()
        if metrics is not None:
            metrics.inc(f"cache.{name}.builds")
    elif metrics is not None:
        metrics.inc(f"cache.{name}.hits")
    return hit


def _registry():
    from repro_torch.obs.metrics import REGISTRY
    return REGISTRY


@dataclasses.dataclass(frozen=True)
class _StepView:
    """What the partition needs to know about one buffer-owning step."""

    name: str
    layer: object
    view_kinds: Tuple[str, ...]
    inputs: Tuple[str, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_shape: Tuple[int, ...]


def _dag_step_views(mat) -> Dict[str, _StepView]:
    return {
        s.name: _StepView(
            name=s.name,
            layer=s.layer,
            view_kinds=tuple(v.kind for v in s.views),
            inputs=s.inputs,
            in_shapes=s.in_shapes,
            out_shape=s.out_shape,
        )
        for s in mat.steps
    }


def _steps_isomorphic(a: _StepView, b: _StepView) -> bool:
    """True iff two steps are identical up to weights (and input sources)."""
    return (
        spec_key(a.layer) == spec_key(b.layer)
        and a.view_kinds == b.view_kinds
        and a.in_shapes == b.in_shapes
        and a.out_shape == b.out_shape
    )


def _sole_consumer_chains(
    steps: Dict[str, _StepView],
    consumers: Dict[str, Tuple[str, ...]],
    order: Sequence[str],
    first: int,
) -> List[Tuple[int, List[str]]]:
    """Maximal sole-consumer chains over ``order[first:]``, as
    ``(start, names)`` pairs tiling the schedule contiguously."""
    chains: List[Tuple[int, List[str]]] = []
    i = first
    while i < len(order):
        names = [order[i]]
        head = steps[order[i]]
        while len(head.inputs) == 1:
            j = i + len(names)
            if j >= len(order):
                break
            prev, cur = steps[order[j - 1]], steps[order[j]]
            if len(cur.inputs) != 1 or cur.inputs != (prev.name,):
                break
            if consumers[prev.name] != (cur.name,):
                break
            names.append(cur.name)
        chains.append((i, names))
        i += len(names)
    return chains


def _periodic_factor(
    steps: Dict[str, _StepView], chain: Sequence[str], *, max_period: int
) -> List[Tuple[int, Tuple[str, ...], int]]:
    """Factor one sole-consumer chain into spec-periodic runs (greedy from
    the left, at least two full periods, ties to the smallest period).
    Returns ``(offset_in_chain, names, period)`` triples tiling the chain."""
    runs: List[Tuple[int, Tuple[str, ...], int]] = []
    n = len(chain)
    i = 0
    while i < n:
        best_p, best_cover = 1, 1
        for p in range(1, min(max_period, (n - i) // 2) + 1):
            reps = 1
            while i + (reps + 1) * p <= n and all(
                _steps_isomorphic(
                    steps[chain[i + j]], steps[chain[i + reps * p + j]]
                )
                for j in range(p)
            ):
                reps += 1
            if reps >= 2 and reps * p > best_cover:
                best_p, best_cover = p, reps * p
        runs.append((i, tuple(chain[i : i + best_cover]), best_p))
        i += best_cover
    return runs


def _chain_runs(
    steps: Dict[str, _StepView],
    consumers: Dict[str, Tuple[str, ...]],
    order: Sequence[str],
    first: int,
    *,
    max_period: int = 1,
) -> List[Tuple[int, Tuple[str, ...], int]]:
    """Maximal stackable runs over ``order[first:]`` as
    ``(start, names, period)`` triples; ``start`` indexes ``order``."""
    runs: List[Tuple[int, Tuple[str, ...], int]] = []
    for start, chain in _sole_consumer_chains(steps, consumers, order, first):
        for off, names, period in _periodic_factor(
            steps, chain, max_period=max_period
        ):
            runs.append((start + off, names, period))
    return runs


def _run_isomorphic(
    steps: Dict[str, _StepView], a: Tuple[str, ...], b: Tuple[str, ...]
) -> bool:
    """True iff two chain runs match position-wise up to weights."""
    if len(a) != len(b):
        return False
    return all(_steps_isomorphic(steps[x], steps[y]) for x, y in zip(a, b))


def _batchable(steps: Dict[str, _StepView], names: Tuple[str, ...]) -> bool:
    """Only single-input steps batch (a join's input list cannot stack)."""
    return all(len(steps[n].inputs) == 1 for n in names)


def _group_segments(
    steps: Dict[str, _StepView],
    runs: List[Tuple[int, Tuple[str, ...], int]],
    *,
    batch_branches: bool,
) -> Tuple[Segment, ...]:
    """Fold adjacent isomorphic, mutually independent runs into one Segment.

    Runs tile the schedule contiguously, so adjacency in the run list is
    adjacency in the schedule; a candidate branch joins the group iff it has
    the same period, matches position-wise, and its (single) input step lies
    outside the group — i.e. it was produced before the group's start.
    """
    segs: List[Segment] = []
    i = 0
    while i < len(runs):
        start, names, period = runs[i]
        group = [names]
        j = i + 1
        if batch_branches and _batchable(steps, names):
            covered = set(names)
            while j < len(runs):
                _, cand, cand_period = runs[j]
                if cand_period != period:
                    break
                if not _batchable(steps, cand):
                    break
                if not _run_isomorphic(steps, names, cand):
                    break
                if steps[cand[0]].inputs[0] in covered:
                    break  # reads a value produced inside the group
                group.append(cand)
                covered.update(cand)
                j += 1
        segs.append(
            Segment(
                start=start,
                kind=steps[names[0]].layer.kind,
                branches=tuple(group),
                period=period,
            )
        )
        i = j if len(group) > 1 else i + 1
    return tuple(segs)


# Largest spec period the run factorization searches for (the reference's
# bound: 2 covers the depthwise/pointwise alternation).
_MAX_PERIOD = 4

# Bounded-FIFO size for the per-(graph, plan) segment cache below.
_SEGMENT_CACHE_MAX = 64


def compile_segments(mat, order: Sequence[str], *, batch_branches: bool = True):
    """Partition a scheduled DAG into segments.

    ``mat`` is a `repro_torch.core.schedule.MaterializedDAG`; ``order`` the
    plan's schedule (``order[0]`` is the input step, which owns no
    segment).  Chain runs are spec-periodic up to period ``_MAX_PERIOD``;
    ``batch_branches=False`` keeps isomorphic branches apart.
    """
    steps = _dag_step_views(mat)
    runs = _chain_runs(
        steps, mat.consumers(), tuple(order), 1, max_period=_MAX_PERIOD
    )
    return _group_segments(steps, runs, batch_branches=batch_branches)


def sequential_segments(graph) -> Tuple[Segment, ...]:
    """Partition a sequential graph's materialized steps into segments.

    Step *i* is the *i*-th materialized layer (``MemoryPlan.buffers[i+1]``),
    names are layer names, and segments are single steps and stacked chain
    runs only.
    """
    from repro_torch.core.planner import materialized_steps

    _, steps = materialized_steps(graph)
    views: Dict[str, _StepView] = {}
    order: List[str] = []
    for i, (layer, view_layers, in_shape, out_shape) in enumerate(steps):
        # Positional names keep duplicate layer names distinct here.
        name = f"#{i}:{layer.name or layer.kind}"
        prev = order[-1] if order else "#input"
        views[name] = _StepView(
            name=name,
            layer=layer,
            view_kinds=tuple(v.kind for v in view_layers),
            inputs=(prev,),
            in_shapes=(tuple(in_shape),),
            out_shape=tuple(out_shape),
        )
        order.append(name)
    consumers = {
        name: (order[i + 1],) if i + 1 < len(order) else ()
        for i, name in enumerate(order)
    }
    runs = _chain_runs(views, consumers, order, 0, max_period=1)
    # Strip the positional prefix: report plain layer names, like the plans.
    return tuple(
        Segment(
            start=start,
            kind=views[names[0]].layer.kind,
            branches=(tuple(n.split(":", 1)[1] for n in names),),
            period=period,
        )
        for start, names, period in runs
    )


# Keyed by object identity (+ the batching flag); values keep the graph and
# plan alive so the ids stay valid.
_SEGMENT_CACHE: Dict[Tuple[int, int, bool], tuple] = {}


def segments_for_plan(graph, plan, *, batch_branches: bool = True):
    """``(materialized, order, segments)`` for a (DAG graph, plan) pair.

    Validates the plan against the graph (`schedule.check_dag_plan`) and
    partitions its schedule once per (graph, plan, batch_branches) triple.
    """
    from repro_torch.core.schedule import check_dag_plan

    def build():
        mat, order = check_dag_plan(graph, plan)
        segs = compile_segments(mat, order, batch_branches=batch_branches)
        return (graph, plan, mat, order, segs)

    hit = cache_fifo(
        _SEGMENT_CACHE,
        (id(graph), id(plan), batch_branches),
        _SEGMENT_CACHE_MAX,
        build,
        name="segments",
    )
    return hit[2], hit[3], hit[4]


def segment_stats(segments: Sequence[Segment]) -> Dict[str, int]:
    """Executor-stats summary of a segment partition."""
    return {
        "segments": len(segments),
        "stacked_layers": sum(
            s.steps_per_branch * s.n_branches
            for s in segments
            if s.stacked or s.batched
        ),
        "batched_branches": sum(s.n_branches for s in segments if s.batched),
        "periodic_segments": sum(1 for s in segments if s.periodic),
        "periodic_steps": sum(
            s.steps_per_branch * s.n_branches for s in segments if s.periodic
        ),
    }
