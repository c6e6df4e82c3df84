"""Pipeline parallelism over a mesh axis: the GPipe (fill-drain) schedule.

The port's counterpart of ``repro/train/pipeline.py``.  The mesh's
``axis`` (``"pod"`` by default) acts as a P-stage pipeline: stage ``i``
owns a contiguous slice of layers, its params on the device of coordinate
``i`` along ``axis`` (every other axis at index 0), and microbatches stream
through.  With M microbatches the schedule runs M + P - 1 ticks; at tick
``t`` stage ``s`` runs microbatch ``t - s`` when there is one (the
reference runs every stage every tick and masks the idle edges out, which
SPMD needs and eager PyTorch does not).  A stage boundary is a copy of the
(microB, ...) activation to the next stage's device, the reference's
``ppermute``; the last stage's outputs come back on the first stage's
device, where the reference replicates them.  The bubble is (P - 1) /
(M + P - 1).

``pipeline_forward`` is differentiable through autograd (the copies
between devices and the stage slices included), as the reference's is
through ``ppermute``'s transpose: ``backward`` of a loss on its output
gives each stage's params their gradients.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.device import current
from repro_torch.tree import tree_map


def _stage_devices(mesh, axis: str, num_stages: int):
    names = tuple(mesh.axis_names)
    if num_stages > mesh.shape[axis]:
        raise ValueError(f"{num_stages} stages over an axis of {mesh.shape[axis]}")
    k = names.index(axis)
    return [mesh.device(tuple(i if j == k else 0 for j in range(len(names))))
            for i in range(num_stages)]


def pipeline_forward(stage_fn: Callable, mesh, *, axis: str = "pod",
                     num_stages: Optional[int] = None):
    """A pipelined forward ``run(stacked_stage_params, micro_x) -> micro_y``.

    ``stage_fn(stage_params, x) -> y`` is one stage's slice of layers (the
    same shape in and out); ``stacked_stage_params`` a tree whose leaves
    have a leading stage axis (:func:`stack_stage_params`); ``micro_x``
    (M, microB, ...) the microbatched input.  Returns the last stage's
    (M, microB, ...) outputs on the first stage's device."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {tuple(mesh.axis_names)} have no {axis!r} axis")
    num_stages = num_stages or mesh.shape[axis]
    devices = _stage_devices(mesh, axis, num_stages)

    def run(stacked_stage_params, micro_x):
        stage_params = [tree_map(lambda a, i=i, d=d: a[i].to(d), stacked_stage_params)
                        for i, d in enumerate(devices)]
        M = micro_x.shape[0]
        inbox = [None] * num_stages  # the activation arriving at each stage
        outs = [None] * M
        for t in range(M + num_stages - 1):
            arriving = [None] * num_stages
            for s in range(num_stages):
                mb = t - s
                if not 0 <= mb < M:
                    continue
                x = micro_x[mb].to(devices[0]) if s == 0 else inbox[s]
                with current(devices[s]):
                    y = stage_fn(stage_params[s], x)
                if s + 1 < num_stages:
                    arriving[s + 1] = y.to(devices[s + 1])
                else:
                    outs[mb] = y.to(devices[0])
            inbox = arriving
        return torch.stack(outs)

    return run


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage axis."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)
