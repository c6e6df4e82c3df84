"""K5's key range and mask, compiled for the host, against the plain version.

``src/repro_torch/csrc/flash_mask.cuh`` holds what both of K5's kernels
(``flash_fwd.cu``) run to place a query row at ``q_offset + i``: the first
and last key blocks a block of 64 query rows reads, whether a key block
needs the per-element mask, and the per-element predicate.  The kernels
cannot run here, so g++ builds the header's host side
(``flash_mask_host.cpp``) into a small ctypes library under
``build/host/``, and the tests walk the (S, T) mask as the kernels' CTAs
do (key blocks of 64, as at head dims 64 and 128, and of 32, as at 256)
and hold it against ``repro_torch.kernels.flash.ref.visible``, the mask of
K5's plain version: every key a row may see is in a block the kernel reads
and unmasked, every other key masked or never read.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.flash.ref import visible

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
BQ = 64  # query rows a CTA (kBQ)

# (S, T, q_offset, causal, window): whole sequences, the sharded spans of
# chip_smoke.py's k5_checks (a second row at 1,024 / 2,048; RecurrentGemma's
# local layer at 256 under its window of 2,048), a ragged span at an offset
# that is not a multiple of a key block, a window that starts past key 0,
# no causal mask, and tails of S and T
CASES = [(129, 129, 0, True, 0), (200, 200, 0, True, 50), (64, 128, 64, True, 0),
         (1024, 2048, 1024, True, 0), (256, 512, 256, True, 2048), (129, 512, 383, True, 0),
         (100, 300, 200, True, 64), (70, 200, 130, True, 17), (37, 90, 0, False, 0),
         (50, 300, 250, False, 33), (1, 400, 399, True, 0), (65, 65, 0, True, 1)]


@pytest.fixture(scope="module")
def lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of flash_mask.cuh needs it")
    srcs = [CSRC / "flash_mask_host.cpp", CSRC / "flash_mask.cuh"]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = ROOT / "build" / "host" / f"libflash_mask-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([gxx, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(srcs[0])],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    so = ctypes.CDLL(str(out))
    so.fm_visible.argtypes = [ctypes.c_int] * 6
    so.fm_visible.restype = ctypes.c_int
    so.fm_kernel_mask.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    so.fm_key_range.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return so


def _kernel_mask(lib, S, T, q_offset, causal, window, bk):
    out = np.empty((S, T), np.uint8)
    lib.fm_kernel_mask(S, T, q_offset, int(causal), window, BQ, bk, out.ctypes.data)
    return out.astype(bool)


@pytest.mark.parametrize("bk", [64, 32])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_the_kernels_mask_is_the_plain_versions(lib, case, bk):
    S, T, q_offset, causal, window = case
    want = visible(S, T, causal=causal, window=window, q_offset=q_offset).numpy()
    got = _kernel_mask(lib, S, T, q_offset, causal, window, bk)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    assert want.any(axis=1).all()  # every row sees a key


def test_the_predicate_element_by_element(lib):
    """``fm::visible`` against the plain mask at every (row, key) of random
    geometries, offsets 0 to 300."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        S, T = int(rng.integers(1, 40)), int(rng.integers(1, 400))
        causal = bool(rng.integers(0, 2))
        q_offset = int(rng.integers(0, max(1, T - S + 1) if causal else 300))
        window = int(rng.choice([0, 1, 7, 64]))
        want = visible(S, T, causal=causal, window=window, q_offset=q_offset).numpy()
        got = np.array([[lib.fm_visible(j, i, T, q_offset, int(causal), window)
                         for j in range(T)] for i in range(S)], bool)
        assert np.array_equal(got, want), (S, T, q_offset, causal, window)


def _key_range(lib, T, q_offset, q0, bk, causal, window):
    out = np.empty(2, np.int32)
    lib.fm_key_range(T, q_offset, q0, BQ, bk, int(causal), window, out.ctypes.data)
    return tuple(int(v) for v in out)


def test_the_key_range_takes_the_offset(lib):
    """A CTA reads from the window's first key, rounded down to a key block,
    to one past its last row's position: the keys before a window are never
    read, nor the keys after the diagonal."""
    # offset 1,024, window 64, the second block of rows: positions 1,088..1,151
    assert _key_range(lib, 2048, 1024, 64, 64, True, 64) == (1024, 1152)
    assert _key_range(lib, 2048, 1024, 64, 32, True, 64) == (1024, 1152)
    # offset 383 (not a block multiple): rows 0..63 at 383..446
    assert _key_range(lib, 512, 383, 0, 64, True, 0) == (0, 447)
    assert _key_range(lib, 512, 383, 0, 64, True, 100) == (256, 447)
    # rows 64..127 at 447..510; the end is T without the causal mask
    assert _key_range(lib, 512, 383, 64, 64, True, 0) == (0, 511)
    assert _key_range(lib, 500, 383, 64, 64, True, 0) == (0, 500)
    assert _key_range(lib, 300, 250, 0, 64, False, 33) == (192, 300)
