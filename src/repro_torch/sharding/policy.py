"""Data parallelism for the CNN arena executors.

The port's counterpart of ``repro/sharding/policy.py::DataParallelPolicy``
(``policy.py:270-373``).  The reference places one global array with a
``NamedSharding`` and lets GSPMD run each device's shard; PyTorch has no
such array, so the policy does it by hand: pad the batch to a multiple of
the mesh size, split it into contiguous shards, run each shard on its
device, and gather the outputs onto the mesh's first device in shard
order.

* **Weights replicate**: :meth:`DataParallelPolicy.replicate` keeps one
  copy per distinct device (the models are microcontroller-sized).
* **The batch shards**: each shard runs the whole executor, arena and
  all, on its device; rows never interact, so the sharded output is
  bit-exact against the unsharded one, and pad lanes never change a real
  row.
* **Devices overlap**: the mesh's first device runs on the caller's
  current stream, every other distinct CUDA device on a stream of its own.
  A call copies every shard to its device first, launches the other
  devices' shards, then the first device's, and gathers last, so no card
  waits for another's shard.  A shard on a card runs that card's kernels;
  nothing moves to the CPU.

``ShardingPolicy``, the LM rule set, goes with the sharded train step
(ROADMAP.md queue 1, item 6c).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

import torch

from repro_torch.tree import tree_map


class Replicas(dict):
    """``{device: tree}``: one copy of a tree of tensors per distinct device
    of a mesh (what :meth:`DataParallelPolicy.replicate` returns)."""


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def _to(tree, device: torch.device):
    return tree_map(lambda t: _move(t, device) if isinstance(t, torch.Tensor) else t, tree)


def _replica(fn):
    """``fn`` for another device: an arena executor gets a copy with arenas
    of its own (``ArenaExecutor.replica``); any other callable is shared."""
    replica = getattr(fn, "replica", None)
    return replica() if replica is not None else fn


@dataclasses.dataclass(frozen=True)
class DataParallelPolicy:
    """Batch-axis data parallelism over a 1-D ``("data",)`` mesh.

    ``mesh`` is a :class:`repro_torch.launch.mesh.DataMesh` (or any object
    with ``shape``, ``axis_names`` and ``devices``).  It must have a
    ``"data"`` axis; any other axis must have size 1.
    """

    mesh: object
    axis: str = "data"

    def __post_init__(self):
        shape = dict(self.mesh.shape)
        if self.axis not in shape:
            raise ValueError(
                f"mesh axes {tuple(self.mesh.axis_names)} have no "
                f"{self.axis!r} axis — build one with "
                "repro_torch.launch.mesh.make_data_mesh()")
        extra = {n: s for n, s in shape.items() if n != self.axis and s != 1}
        if extra:
            raise ValueError(
                f"data-parallel mesh must be 1-D over {self.axis!r}; "
                f"non-unit extra axes {extra} have no data-parallel meaning")

    @property
    def dp_size(self) -> int:
        return int(dict(self.mesh.shape)[self.axis])

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.mesh.devices)

    # -- remainder padding -----------------------------------------------------
    def padded_batch(self, n: int) -> int:
        """Smallest multiple of the mesh size >= n (the shardable batch)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        d = self.dp_size
        return ((int(n) + d - 1) // d) * d

    def pad_lanes(self, n: int) -> int:
        """How many padding lanes a batch of ``n`` needs."""
        return self.padded_batch(n) - int(n)

    def _padded_shards(self, xs) -> Tuple[List[torch.Tensor], int]:
        xs = torch.as_tensor(xs)
        n = int(xs.shape[0])
        pad = self.pad_lanes(n)
        if pad:
            xs = torch.cat([xs, xs.new_zeros((pad, *xs.shape[1:]))])
        return list(xs.split(xs.shape[0] // self.dp_size)), n

    def shard_batch(self, xs) -> Tuple[List[torch.Tensor], int]:
        """Pad ``xs`` (N, ...) with zero lanes up to a shardable batch and
        split it into ``dp_size`` contiguous shards, shard i on the mesh's
        device i.  Returns ``(shards, N)``; the caller slices ``[:N]`` off
        the gathered output."""
        shards, n = self._padded_shards(xs)
        return [_move(x, d) for x, d in zip(shards, self.devices)], n

    def replicate(self, tree) -> Replicas:
        """One copy of a tree of tensors (weights) per distinct device."""
        return Replicas({d: _to(tree, d) for d in dict.fromkeys(self.devices)})

    def wrap_batched(self, fn):
        """Lift a ``(params, xs) -> ys`` executor over the mesh and any batch.

        The returned ``run(replicas, xs)`` takes the weights as
        :meth:`replicate` gave them; it pads ``xs`` to a mesh multiple, runs
        each shard on its device, gathers the outputs onto the mesh's first
        device in shard order and returns the first N rows.  On a mesh of
        one device it is the plain ``fn(params, xs)``."""
        home = self.devices[0]
        if self.dp_size == 1:
            return lambda reps, xs: fn(reps[home], xs)
        runners = {d: fn if d == home else _replica(fn)
                   for d in dict.fromkeys(self.devices)}
        streams = {d: torch.cuda.Stream(d) for d in runners
                   if d.type == "cuda" and d != home}
        # the home device's shards last: its stream is the one the other
        # devices' input copies queue on
        order = sorted(range(self.dp_size), key=lambda i: self.devices[i] == home)

        def on(device):
            """``device`` and its stream current (the home device: as the
            caller left them)."""
            if device not in streams:
                return contextlib.nullcontext()
            stack = contextlib.ExitStack()
            stack.enter_context(torch.cuda.device(device))
            stack.enter_context(torch.cuda.stream(streams[device]))
            return stack

        def run(reps: Replicas, xs):
            shards, n = self._padded_shards(xs)
            devices = self.devices
            # A copy between cards queues on its source's current stream and
            # makes the destination's current stream wait for it.  So every
            # shard goes to its device before any shard's kernels are queued,
            # and each output comes home on its own device's stream.
            placed = []
            for x, d in zip(shards, devices):
                with on(d):
                    placed.append(_move(x, d))
            ys = [None] * len(shards)
            for i in order:
                with on(devices[i]):
                    ys[i] = runners[devices[i]](reps[devices[i]], placed[i])
            for i in order:
                with on(devices[i]):
                    ys[i] = _move(ys[i], home)
            return torch.cat(ys).narrow(0, 0, n)

        return run
