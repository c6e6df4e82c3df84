"""Checkpointing: npz shard + JSON manifest, async save, atomic publish.

The port's counterpart of ``repro/checkpoint/ckpt.py``, same on-disk
layout:

* a manifest records step, tree paths, shapes and dtypes;
* writes go to ``<dir>/tmp-<step>-<host>`` and are then renamed to
  ``<dir>/step-<step>``: a torn checkpoint is never visible;
* async mode copies every leaf to host memory synchronously and writes on a
  background thread, so the train loop is not blocked and may update the
  params in place right away;
* restore places each leaf on its target's device and dtype, and raises on
  a shape mismatch.

Tree paths join the keys of the port's dict / list / NamedTuple tree with
``/``.  bf16 leaves are stored as f32 (numpy has no bf16) and cast back on
restore.  A placed leaf (:class:`repro_torch.sharding.placement.Placed`)
is written whole, so a checkpoint stays mesh-agnostic, as the reference's
host npz is; ``restore(shardings=)`` places each restored leaf by a tree of
placements, so a run may resume on another mesh (elastic restart).
"""
from __future__ import annotations

import json
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.placement import Placed, gather, place
from repro_torch.tree import flatten_with_paths, unflatten_like


def _flat(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf for path, leaf in flatten_with_paths(tree)}


def _to_host(leaf) -> np.ndarray:
    """A host copy (never a view: the train step updates params in place
    while an async write is pending); a placed leaf is gathered whole."""
    if isinstance(leaf, Placed):
        leaf = gather(leaf, "cpu")
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(ckpt_dir: str | Path, step: int, tree: Any, *, host_rank: int = 0,
         blocking: bool = True) -> threading.Thread | None:
    """Write one checkpoint.  Returns the writer thread if non-blocking."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"tmp-{step}-{host_rank}"
    final = ckpt_dir / f"step-{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)

    flat = _flat(tree)
    host_arrays = {k: _to_host(v) for k, v in flat.items()}  # device→host now
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(host_arrays[k].shape),
                       "dtype": str(getattr(v, "dtype", host_arrays[k].dtype))}
                   for k, v in flat.items()},
    }

    def _write():
        np.savez(tmp / f"shard-{host_rank}.npz", **host_arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _steps(ckpt_dir: Path):
    return [int(m.group(1)) for p in ckpt_dir.iterdir()
            if (m := re.fullmatch(r"step-(\d+)", p.name))]


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, target_tree: Any, *, step: Optional[int] = None,
            shardings: Any = None, host_rank: int = 0) -> Tuple[int, Any]:
    """Restore into the structure of ``target_tree``: each leaf a tensor on
    the target leaf's device (the CPU for a ``meta`` target) and dtype,
    placed again by the target's placement when it is placed.
    ``shardings``: a matching tree of placements (``NamedSharding``) to
    place the leaves by instead, onto any mesh.  Raises ``ValueError`` on a
    shape mismatch and ``FileNotFoundError`` when there is no checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    data = np.load(ckpt_dir / f"step-{step:08d}" / f"shard-{host_rank}.npz")
    flat_shard = _flat(shardings) if shardings is not None else {}
    restored = []
    for key, ref in _flat(target_tree).items():
        arr = data[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint {arr.shape} != target {tuple(ref.shape)}")
        t = torch.as_tensor(arr).to(dtype=ref.dtype)
        sharding = flat_shard.get(key, ref.sharding if isinstance(ref, Placed) else None)
        if sharding is not None:
            restored.append(place(t, sharding))
        else:
            restored.append(t.to("cpu" if ref.device.type == "meta" else ref.device))
    return step, unflatten_like(target_tree, restored)


class CheckpointManager:
    """keep-last-k manager with async writes and preemption flush."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        self._pending = save(self.dir, step, tree, blocking=not self.async_save)
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        for s in sorted(_steps(self.dir))[: -self.keep]:
            shutil.rmtree(self.dir / f"step-{s:08d}", ignore_errors=True)

    def restore_latest(self, target_tree: Any, shardings: Any = None):
        return restore(self.dir, target_tree, shardings=shardings)
