"""Placed tensors: a whole tensor split over a mesh by a PartitionSpec.

The port's counterpart of ``jax.sharding.NamedSharding`` and of a global
``jax.Array`` laid out by one.  PyTorch has neither, so a placement is
kept by hand:

* a :class:`Spec` is a plain tuple with the reference's entries, one a
  dimension: ``None`` (whole), an axis name, or a tuple of names (the
  dimension splits over the product of their sizes, the first name
  outermost).  Missing trailing entries are ``None``.  A layer of a pattern
  group also carries ``group = (entry, index, count)``: the reference
  stacks such layers on a leading group axis of ``count`` and may split
  that axis too (ZeRO-1, ``ShardingPolicy.opt_state_specs``); the port
  keeps one tensor a layer, so a split group axis means that only the
  coordinates whose index along ``entry`` owns layer ``index`` hold it;
* a :class:`NamedSharding` is a mesh and a spec;
* :func:`place` splits a tensor by a sharding into a :class:`Placed`: one
  block a mesh coordinate, on that coordinate's device.  Coordinates that
  share a device and a block share one tensor.  :func:`gather`
  reassembles the whole tensor on a device, differentiably, so autograd
  hands each block its own gradient on its own device.  Neither changes a
  bit;
* :meth:`Placed.shard` and :meth:`Placed.region_at` read one coordinate's
  block and where it lies, without a copy; :func:`write` and
  :func:`write_slots` write a region in place into every tensor that holds
  part of it (every device that holds it), each from the one value given,
  so the copies of a block stay bit-equal.  A :class:`Reader` over a tree
  of placed leaves hands out each leaf whole where it is read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Region = Tuple[Tuple[int, int], ...]  # (start, stop) a dimension


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Spec(tuple):
    """A PartitionSpec (see the module docstring); ``group`` is ``None`` or
    ``(entry, index, count)``.  Equal to a plain tuple of the same entries;
    two specs are equal when their groups are too."""

    def __new__(cls, entries=(), group=None):
        self = super().__new__(cls, entries)
        self.group = group
        return self

    def __eq__(self, other):
        if isinstance(other, Spec) and self.group != other.group:
            return False
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        return not self == other

    __hash__ = tuple.__hash__

    def __repr__(self):
        g = f", group={self.group!r}" if self.group else ""
        return f"Spec({tuple(self)!r}{g})"


def _linear(coord: Dict[str, int], sizes: Dict[str, int], axes: Sequence[str]) -> int:
    b = 0
    for a in axes:
        b = b * sizes[a] + coord[a]
    return b


def _size(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    return int(np.prod([sizes[a] for a in axes])) if axes else 1


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh (devices, or an abstract mesh to plan with) and a spec."""

    mesh: object
    spec: tuple

    def entries(self, ndim: int) -> tuple:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than {ndim} dims")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def counts(self, ndim: int) -> Tuple[int, ...]:
        """Blocks along each dimension."""
        sizes = self.mesh.shape
        return tuple(_size(sizes, axes_of(e)) for e in self.entries(ndim))

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one block; raises if a dimension does not divide."""
        counts = self.counts(len(shape))
        if any(d % c for d, c in zip(shape, counts)):
            raise ValueError(f"shape {tuple(shape)} does not split by {self.spec} "
                             f"over {self.mesh.shape}")
        return tuple(d // c for d, c in zip(shape, counts))

    def _owner(self) -> Optional[Tuple[Tuple[str, ...], int]]:
        """(axes, index along them) of the coordinates that hold a layer
        whose group axis is split, else None."""
        group = getattr(self.spec, "group", None)
        if not group or group[0] is None:
            return None
        entry, index, count = group
        axes = axes_of(entry)
        n = _size(self.mesh.shape, axes)
        if count % n:
            raise ValueError(f"a group axis of {count} does not split over {axes}")
        return axes, index // (count // n)

    def block(self, coord: Sequence[int], ndim: int) -> Optional[Tuple[int, ...]]:
        """The block index that mesh coordinate ``coord`` holds, or None."""
        sizes = self.mesh.shape
        at = dict(zip(self.mesh.axis_names, coord))
        owner = self._owner()
        if owner is not None and _linear(at, sizes, owner[0]) != owner[1]:
            return None
        return tuple(_linear(at, sizes, axes_of(e)) for e in self.entries(ndim))

    def region(self, block: Sequence[int], shape) -> Region:
        sub = self.shard_shape(shape)
        return tuple((b * s, (b + 1) * s) for b, s in zip(block, sub))

    def bytes_per_coordinate(self, shape, itemsize: int) -> np.ndarray:
        """Bytes each mesh coordinate holds of a leaf of ``shape``: an
        array of the mesh's shape (works on an abstract mesh)."""
        one = int(np.prod(self.shard_shape(shape), dtype=np.int64)) * int(itemsize)
        sizes = self.mesh.shape
        out = np.full(tuple(sizes.values()), one, dtype=np.int64)
        owner = self._owner()
        if owner is not None:
            idx = np.indices(out.shape)
            at = dict(zip(self.mesh.axis_names, idx))
            out = np.where(_linear(at, sizes, owner[0]) == owner[1], out, 0)
        return out


def slices_within(inner: Region, outer: Region) -> tuple:
    """Index of region ``inner`` in a tensor that holds region ``outer``."""
    return tuple(slice(a - o, b - o) for (a, b), (o, _) in zip(inner, outer))


def contains(outer: Region, inner: Region) -> bool:
    """Whether region ``inner`` lies inside region ``outer``."""
    return all(o0 <= i0 and i1 <= o1 for (o0, o1), (i0, i1) in zip(outer, inner))


class Placed:
    """A tensor of ``shape`` and ``dtype`` laid out by ``sharding``:
    ``store[(block, device)]`` is the block a coordinate on ``device``
    holds (one tensor for every coordinate of that device and block)."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 store: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.store = store

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard(self, coord) -> Optional[torch.Tensor]:
        """The block that mesh coordinate ``coord`` holds (the stored
        tensor itself, no copy), or None."""
        b = self.sharding.block(coord, self.ndim)
        return None if b is None else self.store[(b, self.sharding.mesh.device(coord))]

    def region_at(self, coord) -> Optional[Region]:
        """The region of the whole tensor that coordinate ``coord``'s block
        holds, or None."""
        b = self.sharding.block(coord, self.ndim)
        return None if b is None else self.sharding.region(b, self.shape)

    def copies(self) -> Dict[Tuple[int, ...], List[Tuple[tuple, torch.Tensor]]]:
        """block -> [(coordinate, tensor)] over the coordinates that hold it,
        in row-major order (a shared tensor once, at its first coordinate)."""
        out: Dict[Tuple[int, ...], List] = {}
        seen = set()
        for coord in self.sharding.mesh.coords():
            b = self.sharding.block(coord, self.ndim)
            if b is None:
                continue
            key = (b, self.sharding.mesh.device(coord))
            if key not in seen:
                seen.add(key)
                out.setdefault(b, []).append((coord, self.store[key]))
        return out

    def device_bytes(self) -> Dict[torch.device, int]:
        """Bytes held on each device (a shared tensor counted once)."""
        out: Dict[torch.device, int] = {}
        for (_, dev), t in self.store.items():
            out[dev] = out.get(dev, 0) + t.numel() * t.element_size()
        return out

    def __repr__(self):
        return (f"Placed({tuple(self.shape)}, {self.dtype}, {self.sharding.spec!r} over "
                f"{self.sharding.mesh.shape}, {len(self.store)} tensors)")


def _check_placeable(sharding: NamedSharding) -> None:
    if getattr(sharding.mesh, "devices", None) is None:
        raise ValueError(f"{sharding.mesh} has no devices to place on")


def _build(sharding: NamedSharding, shape, dtype, fill) -> Placed:
    _check_placeable(sharding)
    store = {}
    for coord in sharding.mesh.coords():
        b = sharding.block(coord, len(shape))
        if b is None:
            continue
        key = (b, sharding.mesh.device(coord))
        if key not in store:
            store[key] = fill(sharding.region(b, shape), key[1])
    return Placed(sharding, shape, dtype, store)


def full(sharding: NamedSharding, shape, dtype, value) -> Placed:
    """A placed tensor filled with ``value``, each block made on its
    device."""
    return _build(sharding, tuple(shape), dtype,
                  lambda region, dev: torch.full(tuple(b - a for a, b in region), value,
                                                 dtype=dtype, device=dev))


def zeros(sharding: NamedSharding, shape, dtype) -> Placed:
    """A placed tensor of zeros, each block made on its device."""
    return full(sharding, shape, dtype, 0)


def intersect(a: Region, b: Region) -> Optional[Region]:
    """The region two regions share, or None."""
    out = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def write(x: Placed, region: Region, value: torch.Tensor) -> None:
    """``x[region] = value`` in place: every stored tensor whose block
    crosses ``region`` takes its part of ``value`` (copied to its device),
    so every device that holds a part of the region gets it, and the copies
    of a block stay bit-equal.  ``region`` may leave out trailing
    dimensions (whole)."""
    region = tuple(region) + tuple((0, d) for d in x.shape[len(region):])
    for (b, _), t in x.store.items():
        outer = x.sharding.region(b, x.shape)
        inter = intersect(outer, region)
        if inter is not None:
            t[slices_within(inter, outer)].copy_(value[slices_within(inter, region)])


def write_slots(x: Placed, rows: Tuple[int, int], slots: torch.Tensor,
                value: torch.Tensor, rest: Region = ()) -> None:
    """One slot a row, in place, in every tensor that holds it: ``x[r,
    slots[r - rows[0]], rest] = value[r - rows[0]]`` for each row ``r`` in
    ``rows``, ``x`` laid out (rows, slots, ...).  ``slots`` is a tensor, so
    nothing waits for the device: a block whose slot range does not hold a
    row's slot keeps that row as it was (the slot is clamped into the
    block's range and the old value written back)."""
    rest = tuple(rest) + tuple((0, d) for d in x.shape[2 + len(rest):])
    for (b, dev), t in x.store.items():
        outer = x.sharding.region(b, x.shape)
        inter = intersect(outer, ((rows[0], rows[1]), outer[1]) + rest)
        if inter is None:
            continue
        (r0, r1), (l0, l1) = inter[0], outer[1]
        sl = slots[r0 - rows[0]:r1 - rows[0]].to(dev).long()
        val = value[(slice(r0 - rows[0], r1 - rows[0]),)
                    + slices_within(inter[2:], rest)].to(dev)
        local_rows = torch.arange(r0 - outer[0][0], r1 - outer[0][0], device=dev)
        tail = slices_within(inter[2:], outer[2:])
        if (l0, l1) == (0, x.shape[1]):  # the block holds every slot
            t[(local_rows, sl) + tail] = val
            continue
        inside = (sl >= l0) & (sl < l1)
        local = torch.clamp(sl - l0, 0, l1 - l0 - 1)
        old = t[(local_rows, local) + tail]
        t[(local_rows, local) + tail] = torch.where(
            inside.view((-1,) + (1,) * (val.ndim - 1)), val, old)


def read_region(x, region: Region, device) -> torch.Tensor:
    """A contiguous copy of ``x[region]`` on ``device``, ``x`` a tensor or
    a :class:`Placed` (assembled from the blocks it crosses; not
    differentiable)."""
    device = torch.device(device)
    shape = tuple(b - a for a, b in region)
    if isinstance(x, torch.Tensor):
        out = torch.empty(shape, dtype=x.dtype, device=device)
        return out.copy_(x.detach()[tuple(slice(a, b) for a, b in region)])
    out = torch.empty(shape, dtype=x.dtype, device=device)
    for b, held in x.copies().items():
        src = x.sharding.region(b, x.shape)
        inter = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(region, src))
        if any(a >= b for a, b in inter):
            continue
        t = next((t for _, t in held if t.device == device), held[0][1])
        out[slices_within(inter, region)].copy_(t.detach()[slices_within(inter, src)])
    return out


def place(x, sharding: NamedSharding) -> Placed:
    """``x`` (a whole tensor, or a :class:`Placed` by another sharding)
    laid out by ``sharding``: each block a copy on its coordinate's device.
    A :class:`Placed` by ``sharding`` already is returned as it is."""
    if isinstance(x, Placed) and x.sharding == sharding:
        return x
    sharding.shard_shape(tuple(x.shape))
    return _build(sharding, tuple(x.shape), x.dtype,
                  lambda region, dev: read_region(x, region, dev))


def as_placed(x, sharding: NamedSharding, donate: bool = True) -> Placed:
    """A sharded step's input leaf laid out by ``sharding``: a whole tensor
    is placed; a :class:`Placed` by ``sharding`` comes as it is
    (``donate``: the step updates it in place) or as a copy; one placed by
    another sharding raises."""
    if not isinstance(x, Placed):
        return place(x, sharding)
    if x.sharding != sharding:
        raise ValueError(f"a leaf placed by {x.sharding.spec} where the step expects "
                         f"{sharding.spec}; reshard it first "
                         f"(repro_torch.ft.resilience.reshard_tree)")
    if donate:
        return x
    return Placed(x.sharding, x.shape, x.dtype, {k: t.clone() for k, t in x.store.items()})


def sources(x: Placed, device, among: Iterable[tuple] = ()) -> Dict[Tuple[int, ...],
                                                                      torch.Tensor]:
    """block -> the tensor that a read on ``device`` takes it from: a copy on
    ``device`` if one exists, else the one of the first coordinate of
    ``among`` that holds it, else the first holder's."""
    device = torch.device(device)
    rank = {tuple(c): i for i, c in enumerate(among)}
    out = {}
    for b, held in x.copies().items():
        out[b] = min(held, key=lambda ct: (ct[1].device != device,
                                           rank.get(tuple(ct[0]), len(rank))))[1]
    return out


def assemble(blocks: Dict[Tuple[int, ...], torch.Tensor], counts: Sequence[int],
             device) -> torch.Tensor:
    """The whole tensor from one tensor a block (a grid of ``counts``), on
    ``device``, by ``torch.cat``: differentiable, and the block itself when
    there is one block already on ``device``."""
    device = torch.device(device)

    def build(prefix):
        if len(prefix) == len(counts):
            t = blocks[prefix]
            return t if t.device == device else t.to(device)
        parts = [build(prefix + (i,)) for i in range(counts[len(prefix)])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=len(prefix))

    return build(())


class Reader(dict):
    """A dict node of a tree of placed leaves whose leaves come whole where
    they are read (``read(leaf)``; dict nodes under it are Readers too,
    lists lists of them): a layer's weights are whole only while it runs."""

    def __init__(self, node: dict, read):
        super().__init__(node)
        self._read = read

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if isinstance(v, dict):
            return Reader(v, self._read)
        if isinstance(v, list):
            return [Reader(x, self._read) if isinstance(x, dict) else self._read(x) for x in v]
        return self._read(v)

    def get(self, key, default=None):
        return self[key] if key in self else default


def gather(x, device, among: Iterable[tuple] = ()) -> torch.Tensor:
    """The whole tensor of a :class:`Placed` on ``device`` (see
    :func:`sources` for which copy of a block it reads); a plain tensor is
    moved there.  Differentiable."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return assemble(sources(x, device, among), x.sharding.counts(x.ndim), device)

