"""Build and load the port's CUDA kernels (plain C ABI, loaded with ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the repository root, where the hash
covers the source, the headers it includes and the flags: a changed source rebuilds, an unchanged
one loads what an earlier process built.  :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them together.

Nothing is built or loaded at import time; the first launch of a kernel
builds it.  A build that fails raises with the compiler's output: there is
no fallback to a plain version.  :func:`use_build_dir` points the process
at another directory (``serve.step.enable_persistent_cache``: a replica
that finds its kernels there runs no ``nvcc``; :data:`NVCC_RUNS` counts the
builds a process makes).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# Kernel library name -> its source.
SOURCES = {
    "conv_pool": "conv_pool.cu",  # K1
    "conv_pool_q8": "conv_pool_q8.cu",  # K2
    "conv_pool_dw": "conv_pool_dw.cu",  # K3
    "conv_pool_dw_q8": "conv_pool_dw_q8.cu",  # K4
    "flash_fwd": "flash_fwd.cu",  # K5
    "xent_fwd": "xent_fwd.cu",  # K6
    "wkv_fwd": "wkv_fwd.cu",  # K7
}
# Library name -> the csrc headers its source includes (hashed into its key).
_HEADERS = {name: ("conv_pool_math.cuh",) for name in
            ("conv_pool", "conv_pool_q8", "conv_pool_dw", "conv_pool_dw_q8")}
_HEADERS["flash_fwd"] = ("flash_mask.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A plain integer count of kernel launches, plus the same count broken
    down by a key (the launch geometry), so a run can show which kernel the
    main path went through and at which shapes.  :data:`NVCC_RUNS` counts
    builds the same way."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.by_key: dict = {}

    def add(self, key) -> None:
        with self._lock:
            self.count += 1
            self.by_key[key] = self.by_key.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_key = {}


# Every nvcc this process runs, keyed by library name: a process that loads
# what another built (``use_build_dir``) counts none.
NVCC_RUNS = LaunchCounter()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under PyTorch's
    ``CUDA_HOME``.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def use_build_dir(path) -> bool:
    """Build into and load from ``path`` from now on (process-global).
    Libraries loaded before stay loaded, but the next launch of each loads
    it again from ``path``, building it there if it is missing, so an
    earlier process's builds in ``path`` are reused and this process's land
    there.  Returns False, doing nothing, when ``path`` is already the
    build directory."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _LOCK:
        if path == BUILD_DIR:
            return False
        BUILD_DIR = path
        _LOADED.clear()
    return True


def library_path(name: str) -> Path:
    """Where the library for ``name`` lives, keyed by a hash of its inputs."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *_HEADERS.get(name, ())):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every library in ``names`` that is not built yet, in parallel.

    Returns name -> library path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``.log``.  Raises ``RuntimeError`` with the output of any failed build.
    """
    names = tuple(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        NVCC_RUNS.add(n)
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc {SOURCES[n]} exited {proc.returncode}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
