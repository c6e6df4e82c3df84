"""Meshes: named axes over an array of devices, and their shapes alone.

The port's counterpart of ``repro/launch/mesh.py``.

* :class:`Mesh` lays devices out on named axes: ``("data", "model")``,
  ``("pod", "data", "model")`` or ``("pod",)``.  A device may repeat: a
  (2, 2) mesh over ``cuda:0`` four times runs the splitting, the gathers,
  the reductions and the ZeRO slicing of a sharded step on one card (it
  measures nothing about links between cards).  With ``device="cpu"`` the
  one CPU device repeats, the counterpart of the reference's
  ``forced_host_devices_env``, which splits one CPU into n XLA devices.
* :class:`AbstractMesh` has the axis names and sizes and no devices: the
  planning mesh of ``ShardingPolicy`` and the dry run.
  :func:`make_production_mesh` is one: the reference's (16, 16) and
  (2, 16, 16) TPU pod meshes (256 / 512 chips) are planned for by shape and
  run on nothing here.
* :class:`DataMesh` is the 1-D ``("data",)`` mesh of the CNN executors
  (``make_data_mesh``); hand it to
  :class:`repro_torch.sharding.policy.DataParallelPolicy`.  On one card it
  is the one-device identity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """An ordered tuple of devices along one ``"data"`` axis."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


class AbstractMesh:
    """Axis names and sizes, no devices (a mesh to plan for)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh sizes {sizes} and axis names {axis_names} do not pair")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
        self.sizes = sizes
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def coords(self) -> Iterator[Tuple[int, ...]]:
        """Every coordinate, in row-major order."""
        return np.ndindex(*self.sizes)

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


def _indexed(dev: torch.device) -> torch.device:
    """The device as a tensor on it reports it: a card with its index, the
    CPU without one."""
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device() if dev.index is None
                            else dev.index)
    return torch.device(dev.type)


class Mesh(AbstractMesh):
    """Named axes over an array of devices (``devices[coord]`` is the device
    of mesh coordinate ``coord``); a CUDA device without a usable card
    raises (:func:`repro_torch.device.resolve`)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = _indexed(resolve(src[idx]))
        super().__init__(arr.shape, axis_names)
        self.devices = arr

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]


def data_axes(mesh) -> tuple:
    """Axes that shard the batch (a ``"pod"`` axis folds into data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str], device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``sizes`` over ``devices`` (row-major; one device repeats
    over every coordinate), by default distinct cards ``cuda:0 .. n-1``
    (raises unless there are that many) or, with ``device="cpu"``, the CPU
    repeated."""
    n = int(np.prod(sizes))
    if devices is None:
        dev = resolve(device)
        if dev.type == "cpu":
            devices = [dev]
        else:
            count = torch.cuda.device_count()
            if n > count:
                raise ValueError(f"a mesh of {n} distinct cards needs {n}, found {count}; "
                                 f"pass devices=[...] to repeat a card")
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) == 1:
        devices = devices * n
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of {n} coordinates")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes)), axis_names)


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """A ``(n // model, model)`` ``("data", "model")`` mesh: on CUDA over
    the ``n = torch.cuda.device_count()`` distinct cards, on the CPU over
    the CPU repeated ``n = model`` times."""
    dev = resolve(device)
    n = model if dev.type == "cpu" else torch.cuda.device_count()
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into a model axis of {model}")
    return make_mesh((n // model, model), ("data", "model"), device=dev)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production LM mesh by shape: ("data", "model") =
    (16, 16), or with ``multi_pod`` ("pod", "data", "model") = (2, 16, 16).
    Abstract: it plans (``ShardingPolicy``, ``launch.dryrun``) and runs on
    nothing."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_data_mesh(n_devices: Optional[int] = None, device="cuda") -> DataMesh:
    """A 1-D ``("data",)`` mesh over ``n_devices`` devices.

    On CUDA: distinct cards ``cuda:0 .. cuda:n-1``, by default all of them;
    raises unless 1 <= n <= ``torch.cuda.device_count()``.  On the CPU: the
    one CPU device repeated n times (default 1)."""
    dev = resolve(device)
    if dev.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"need n_devices >= 1, got {n}")
        return DataMesh((dev,) * n)
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"need 1 <= n_devices <= {count}, got {n}")
    return DataMesh(tuple(torch.device("cuda", i) for i in range(n)))
