"""The arithmetic that kernels K1-K4 run, compiled for the host.

``src/repro_torch/csrc/conv_pool_math.cuh`` holds the requantization (per
tensor and per channel) and the window/halo index math of the CUDA kernels
as ``__host__ __device__`` functions.  Here g++ builds its host side
(``conv_pool_math_host.cpp``) into a small ctypes library under
``build/host/``, and the tests hold those exact lines against the reference
package: the requantization bit for bit on more than 100k values, ties and
saturation included, per channel as K4 applies it, and the geometry against
the reference's layer shapes and halo windows.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import graph as ref_graph
from repro.core import quantize as ref_quantize
from repro.kernels.conv_pool.kernel import halo_window_rows
from repro_torch.kernels.conv_pool.kernel import (k1_smem_bytes, k2_pos_words,
                                                  k2_smem_bytes, output_hw)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")


@pytest.fixture(scope="module")
def lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of conv_pool_math.cuh needs it")
    srcs = [CSRC / "conv_pool_math_host.cpp", CSRC / "conv_pool_math.cuh"]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = ROOT / "build" / "host" / f"libconv_pool_math-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([gxx, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(srcs[0])],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    so = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    so.cp_requant.argtypes = [p, p, p, ctypes.c_longlong]
    so.cp_requant_per_channel.argtypes = [p, p, p, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int]
    so.cp_geom.argtypes = [ctypes.c_int] * 12 + [p]
    so.cp_pooled_row_span.argtypes = [ctypes.c_int] * 6 + [p]
    so.cp_in_bounds.argtypes = [ctypes.c_int, ctypes.c_int]
    so.cp_in_bounds.restype = ctypes.c_int
    so.cp_k1_tile.argtypes = [ctypes.c_int] * 14 + [p]
    so.cp_k1_smem_bytes.argtypes = [ctypes.c_int] * 17
    so.cp_k1_smem_bytes.restype = ctypes.c_longlong
    so.cp_k2_smem_bytes.argtypes = [ctypes.c_int] * 17
    so.cp_k2_smem_bytes.restype = ctypes.c_longlong
    return so


def _requant(lib, acc, m):
    acc = np.ascontiguousarray(acc, np.int32)
    m = np.ascontiguousarray(np.broadcast_to(np.float32(m), acc.shape), np.float32)
    out = np.empty(acc.shape, np.int8)
    lib.cp_requant(acc.ctypes.data, m.ctypes.data, out.ctypes.data, acc.size)
    return out


def _requant_cases():
    """(acc, m) pairs, one multiplier per element: exact ±0.5 ties, the
    int8 saturation edges, the int32 extremes and random values."""
    rng = np.random.default_rng(0)
    accs, ms = [], []
    # m = 2^-k: every odd multiple of 2^(k-1) lands on a ±x.5 tie.
    for k in range(1, 9):
        a = np.arange(-(256 << k), (256 << k) + 1, 1 << (k - 1), dtype=np.int64)
        accs.append(a)
        ms.append(np.full(a.shape, 2.0 ** -k))
    # the saturation edges: values around ±127.5 and ±128.5 at m = 1/2, 1/4
    edge = np.array([253, 254, 255, 256, 257, 258, -253, -255, -256, -257, -258])
    for m in (0.5, 0.25):
        a = np.concatenate([edge, edge * 2])
        accs.append(a)
        ms.append(np.full(a.shape, m))
    # int32 extremes, where the float conversion itself rounds
    big = np.array([2**31 - 1, -2**31, 2**24 + 1, -(2**24 + 1), 2**30 + 65, 0])
    for m in (1.0, 1e-7, 3.0e-9, -1e-7, 0.0):
        accs.append(big)
        ms.append(np.full(big.shape, m))
    # random accumulators at random f32 multipliers (both signs)
    a = rng.integers(-2**31, 2**31, 50000)
    accs.append(a)
    ms.append(rng.uniform(-1e-6, 1e-6, a.shape))
    a = rng.integers(-2**20, 2**20, 50000)
    accs.append(a)
    ms.append(10.0 ** rng.uniform(-6, 0, a.shape))
    acc = np.concatenate(accs).astype(np.int32)
    m = np.concatenate(ms).astype(np.float32)
    return acc, m


def test_host_requant_bit_exact_vs_reference(lib):
    acc, m = _requant_cases()
    assert acc.size >= 100_000
    ours = _requant(lib, acc, m)
    ref = np.asarray(ref_quantize.requantize(jnp.asarray(acc), jnp.asarray(m)))
    np.testing.assert_array_equal(ours, ref)
    # the cases hit both rounding ties and both saturation edges
    v = acc.astype(np.float64) * m.astype(np.float64)
    assert np.any(v == 0.5) and np.any(v == -0.5) and np.any(v == 2.5)
    assert (ours == 127).any() and (ours == -128).any()


def test_host_requant_rounds_half_to_even(lib):
    got = _requant(lib, np.array([1, 3, 5, 7, -1, -3, -5, 255, -255, 257, -257]), 0.5)
    assert got.tolist() == [0, 2, 2, 4, 0, -2, -2, 127, -128, 127, -128]


def test_host_requant_per_channel_bit_exact_vs_reference(lib):
    """K4's requant: channel c of an (N, C, H, W) int32 block with m[c]."""
    acc, m_all = _requant_cases()
    n, c, hw = 4, 64, 25
    block = acc[: n * c * hw].reshape(n, c, 5, 5)
    m = np.ascontiguousarray(m_all[::997][:c], np.float32)
    m[::7] = np.float32(2.0**-5)  # channels whose values tie
    out = np.empty(block.shape, np.int8)
    lib.cp_requant_per_channel(np.ascontiguousarray(block).ctypes.data, m.ctypes.data,
                               out.ctypes.data, block.size, c, hw)
    ref = np.asarray(ref_quantize.requantize_per_channel(jnp.asarray(block),
                                                         jnp.asarray(m)))
    np.testing.assert_array_equal(out, ref)
    assert (ref == 127).any() and (ref == -128).any()


GEOMS = [
    # (H, W, (kh,kw), conv stride, padding, pool_k, pool_stride)
    (32, 32, (5, 5), (1, 1), (0, 0), (2, 2), (2, 2)),  # LeNet conv1
    (14, 14, (5, 5), (1, 1), (0, 0), (2, 2), (2, 2)),  # LeNet conv2
    (32, 32, (5, 5), (1, 1), (2, 2), (2, 2), (2, 2)),  # CIFAR conv1
    (8, 8, (5, 5), (1, 1), (2, 2), (2, 2), (2, 2)),    # CIFAR conv3
    (16, 16, (3, 3), (1, 1), (0, 0), (3, 3), (2, 2)),  # overlapping pool
    (20, 20, (3, 3), (2, 2), (1, 1), (2, 2), (2, 2)),  # conv stride 2
    (49, 10, (10, 4), (2, 2), (5, 1), (5, 1), (5, 1)),  # DS-CNN stem
]


@pytest.mark.parametrize("geom", GEOMS)
def test_host_geometry_matches_reference(lib, geom):
    H, W, k, cs, pad, pk, ps = geom
    layer = ref_graph.FusedConvPool(
        conv=ref_graph.Conv2d(1, 1, k, stride=cs, padding=pad),
        pool_kernel=pk, pool_stride=ps)
    out4 = (ctypes.c_int * 4)()
    lib.cp_geom(H, W, *k, *cs, *pad, *pk, *ps, out4)
    _, ph, pw = layer.out_shape((1, H, W))
    assert tuple(out4)[2:] == (ph, pw)
    assert tuple(out4) == output_hw(H, W, *k, conv_stride=cs, padding=pad,
                                    pool_k=pk, pool_stride=ps)
    # The input rows a tile of r pooled rows reads: the reference's halo
    # window, starting at p·psh·csh − pad.
    span = (ctypes.c_int * 2)()
    for r in (1, 2, ph):
        for p in range(0, ph - r + 1):
            lib.cp_pooled_row_span(p, k[0], cs[0], pad[0], pk[0], ps[0], span)
            lo = span[0]
            lib.cp_pooled_row_span(p + r - 1, k[0], cs[0], pad[0], pk[0], ps[0], span)
            assert lo == p * ps[0] * cs[0] - pad[0]
            assert span[1] - lo + 1 == halo_window_rows(
                r, conv_stride=cs[0], pool_k=pk[0], pool_stride=ps[0], k=k[0])


def test_host_bounds_check_is_the_zero_padding(lib):
    assert [lib.cp_in_bounds(i, 5) for i in (-2**31, -1, 0, 4, 5, 2**31 - 1)] == \
        [0, 0, 1, 1, 0, 0]


# K1's geometries: chip_smoke.py's K1_CASES (square, padded, overlapping and
# gapped pools, conv stride 2, the rectangular DS-CNN stem) and the two heads,
# (H, W, cin, (kh, kw), conv stride, padding, pool_k, pool_stride).
K1_GEOMS = [
    (32, 32, 1, (5, 5), (1, 1), (0, 0), (2, 2), (2, 2)),
    (14, 14, 6, (5, 5), (1, 1), (0, 0), (2, 2), (2, 2)),
    (32, 32, 3, (5, 5), (1, 1), (2, 2), (2, 2), (2, 2)),
    (16, 16, 32, (5, 5), (1, 1), (2, 2), (2, 2), (2, 2)),
    (16, 16, 4, (3, 3), (1, 1), (0, 0), (3, 3), (3, 3)),
    (16, 16, 4, (3, 3), (1, 1), (0, 0), (3, 3), (2, 2)),  # overlapping pool
    (20, 20, 2, (3, 3), (2, 2), (1, 1), (2, 2), (2, 2)),
    (128, 128, 4, (3, 3), (1, 1), (0, 0), (2, 2), (2, 2)),
    (49, 10, 1, (10, 4), (2, 2), (5, 1), (5, 1), (5, 1)),  # DS-CNN stem
    (17, 13, 2, (3, 2), (1, 2), (1, 0), (2, 3), (3, 2)),  # pool stride > k
    (25, 5, 64, (1, 1), (1, 1), (0, 0), (25, 5), (25, 5)),  # DS-CNN-KWS head
    (2, 2, 256, (1, 1), (1, 1), (0, 0), (2, 2), (2, 2)),  # MobileNet head
]
# Wide layers whose staged input K1 cuts into chunks of input channels.
K1_WIDE_GEOMS = [
    (112, 112, 128, (3, 3), (1, 1), (1, 1), (2, 2), (2, 2)),
    (56, 56, 256, (3, 3), (1, 1), (1, 1), (2, 2), (2, 2)),
]


def _tile_enumerated(geom, p0, rows):
    """(conv rows, conv cols, input rows, input cols) a tile of pooled rows
    [p0, p0 + rows) reads, each as a sorted numpy array, from the windows."""
    H, W, _, (kh, kw), (csh, csw), (padh, padw), (pkh, pkw), (psh, psw) = geom
    _, _, ph, pw = output_hw(H, W, kh, kw, conv_stride=(csh, csw),
                             padding=(padh, padw), pool_k=(pkh, pkw),
                             pool_stride=(psh, psw))
    pr = np.arange(p0, min(p0 + rows, ph))
    crow = np.unique((pr[:, None] * psh + np.arange(pkh)).ravel())
    ccol = np.unique((np.arange(pw)[:, None] * psw + np.arange(pkw)).ravel())
    irow = np.unique((crow[:, None] * csh - padh + np.arange(kh)).ravel())
    icol = np.unique((ccol[:, None] * csw - padw + np.arange(kw)).ravel())
    return crow, ccol, irow, icol


@pytest.mark.parametrize("geom", K1_GEOMS)
def test_host_k1_tile_covers_what_its_windows_read(lib, geom):
    """Every tile (rows 1, 2, 3 and all) computes the conv rows and columns
    its pool windows reduce, and stages the input rows and columns those
    conv values read: the kernel's ranges are the numpy enumeration's
    bounding boxes, and no wider."""
    H, W, _, k, cs, pad, pk, ps = geom
    _, _, ph, _ = output_hw(H, W, *k, conv_stride=cs, padding=pad, pool_k=pk,
                            pool_stride=ps)
    out6 = (ctypes.c_int * 6)()
    for rows in sorted({1, 2, 3, ph}):
        for p0 in range(0, ph, rows):
            lib.cp_k1_tile(H, W, *k, *cs, *pad, *pk, *ps, p0, rows, out6)
            crow0, crows, ccols, irow0, hrows, wcols = tuple(out6)
            crow, ccol, irow, icol = _tile_enumerated(geom, p0, rows)
            assert (crow0, crows) == (crow[0], crow[-1] - crow[0] + 1)
            assert (0, ccols) == (ccol[0], ccol[-1] + 1)
            assert (irow0, hrows) == (irow[0], irow[-1] - irow[0] + 1)
            assert (-pad[1], wcols) == (icol[0], icol[-1] - icol[0] + 1)
            # the conv positions lie inside the conv map
            oh, ow, _, _ = output_hw(H, W, *k, conv_stride=cs, padding=pad,
                                     pool_k=pk, pool_stride=ps)
            assert crow[-1] < oh and ccol[-1] < ow


@pytest.mark.parametrize("geom", K1_GEOMS + K1_WIDE_GEOMS)
def test_host_k1_smem_matches_the_wrappers_sum(lib, geom):
    """The launcher sizes shared memory with conv_pool_math.cuh's
    k1_smem_bytes; the wrapper tiles with kernel.k1_smem_bytes: one sum,
    at every chunk of staged input channels."""
    H, W, cin, k, cs, pad, pk, ps = geom
    _, _, ph, _ = output_hw(H, W, *k, conv_stride=cs, padding=pad, pool_k=pk,
                            pool_stride=ps)
    for rows in sorted({1, 2, ph}):
        for ct in (1, 3, 8, 29, 64):
            for cc in sorted({1, -(-cin // 2), cin}):
                want = lib.cp_k1_smem_bytes(cin, H, W, 64, *k, *cs, *pad, *pk, *ps,
                                            rows, ct, cc)
                assert want % 16 == 0
                assert k1_smem_bytes(cin, H, W, *k, conv_stride=cs, padding=pad,
                                     pool_k=pk, pool_stride=ps, rows=rows,
                                     ct=ct, cc=cc) == want


@pytest.mark.parametrize("geom", K1_GEOMS + K1_WIDE_GEOMS)
def test_host_k2_smem_matches_the_wrappers_sum(lib, geom):
    """K2's launcher sizes shared memory with conv_pool_math.cuh's
    k2_smem_bytes; its tiling uses kernel.k2_smem_bytes: one sum, at every
    chunk of staged input channels (all of them, or whole words of 4)."""
    H, W, cin, k, cs, pad, pk, ps = geom
    _, _, ph, _ = output_hw(H, W, *k, conv_stride=cs, padding=pad, pool_k=pk,
                            pool_stride=ps)
    for rows in sorted({1, 2, ph}):
        for ct in (1, 3, 8, 29, 64):
            for cc in sorted({min(4, cin), -(-cin // 8) * 4, cin}):
                want = lib.cp_k2_smem_bytes(cin, H, W, 64, *k, *cs, *pad, *pk, *ps,
                                            rows, ct, cc)
                assert want % 16 == 0
                assert k2_smem_bytes(cin, H, W, *k, conv_stride=cs, padding=pad,
                                     pool_k=pk, pool_stride=ps, rows=rows,
                                     ct=ct, cc=cc) == want


def test_k2_position_words_are_odd_and_hold_every_channel():
    for cc in range(1, 300):
        words = k2_pos_words(cc)
        assert words % 2 == 1 and 4 * words >= cc and 4 * (words - 2) < cc
