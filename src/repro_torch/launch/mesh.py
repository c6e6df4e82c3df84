"""The CNN executors' data-parallel mesh: an ordered tuple of devices.

The port's counterpart of ``repro/launch/mesh.py``'s ``data_axes`` and
``make_data_mesh``.  A :class:`DataMesh` is 1-D over ``("data",)``; hand it
to :class:`repro_torch.sharding.policy.DataParallelPolicy`.  On one card it
is the one-device identity.  With ``device="cpu"`` the one CPU device
repeats n times, the counterpart of the reference's
``forced_host_devices_env``, which splits one CPU into n XLA devices.  A
device may also repeat on purpose on a card, ``DataMesh((cuda:0,) * 4)``,
to run the splitting, the pad lanes and the gather on one card.

``make_production_mesh`` and ``make_host_mesh`` build the reference's TPU
pod meshes (``("data", "model")``, 256 or 512 chips) and have no
counterpart here (ROADMAP.md queue 1, item 6d).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


def data_axes(mesh) -> tuple:
    """Axes that shard the batch (a ``"pod"`` axis folds into data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


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
