"""The plain versions of kernels K1 and K2 against the reference package.

On a CPU tensor the port's wrappers run their kernels' plain versions; these
tests hold them to the reference on the same numpy inputs:

* K1 (``fused_conv_pool``) against ``ops.fused_conv_pool(impl="ref")`` on
  the cases of ``tests/test_kernel_conv_pool.py``, f32 at 1e-5 and bf16 at
  5e-2, plus the rectangular DS-CNN stem of ``tests/test_rect_avgpool.py``;
* K2 (``fused_conv_pool_q8``) bit-exact against
  ``kernel_q8.fused_conv_pool_q8(impl="xla")`` on the §5 CIFAR conv1 at
  batch 1 and 4, max and average pool, and on the geometries of
  ``tests/test_quant_exec.py``.

The reference's Pallas path (``impl="pallas"``) does not run on this jax,
so it is never the reference here.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_pool import ops as ref_ops
from repro.quant import kernel_q8 as ref_q8
from repro_torch.kernels.conv_pool.ops import fused_conv_pool
from repro_torch.quant.kernel_q8 import effective_multiplier, fused_conv_pool_q8

CASES = [
    # (H, W, cin, cout, k, conv_stride, padding, pool_k, pool_stride)
    (32, 32, 1, 6, 5, 1, 0, 2, 2),     # LeNet conv1+pool1
    (14, 14, 6, 16, 5, 1, 0, 2, 2),    # LeNet conv2+pool2
    (32, 32, 3, 32, 5, 1, 2, 2, 2),    # CIFAR testnet conv1 (padded)
    (16, 16, 32, 16, 5, 1, 2, 2, 2),   # CIFAR testnet conv2
    (16, 16, 4, 8, 3, 1, 0, 3, 3),     # pool 3/3
    (16, 16, 4, 8, 3, 1, 0, 3, 2),     # overlapping pool (stride < k, §7)
    (20, 20, 2, 4, 3, 2, 1, 2, 2),     # conv stride 2
]

_DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
           "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _both(a, tdtype, jdtype):
    return torch.as_tensor(np.asarray(a), dtype=tdtype), jnp.asarray(a, jdtype)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_plain_k1_matches_reference(case, dtype):
    H, W, cin, cout, k, cs, pad, pk, ps = case
    tdtype, jdtype, tol = _DTYPES[dtype]
    rng = np.random.default_rng(CASES.index(case))
    x_t, x_j = _both(rng.standard_normal((2, cin, H, W)), tdtype, jdtype)
    w_t, w_j = _both(rng.standard_normal((cout, cin, k, k)) * 0.2, tdtype, jdtype)
    b_t, b_j = _both(rng.standard_normal((cout,)) * 0.1, tdtype, jdtype)
    geom = dict(conv_stride=cs, padding=pad, pool_k=pk, pool_stride=ps)
    y = fused_conv_pool(x_t, w_t, b_t, **geom)
    y_ref = ref_ops.fused_conv_pool(x_j, w_j, b_j, impl="ref", **geom)
    assert y.dtype == tdtype and tuple(y.shape) == tuple(y_ref.shape)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_plain_k1_rectangular_matches_reference(pool):
    """The true DS-CNN stem: (10,4) kernel, (2,2) stride, (5,1) padding and a
    (5,1) pool window, both reductions."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 49, 10)).astype(np.float32)
    w = (rng.standard_normal((8, 1, 10, 4)) * 0.1).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    geom = dict(conv_stride=(2, 2), padding=(5, 1), pool_k=(5, 1),
                pool_stride=(5, 1), activation="relu", pool=pool)
    y = fused_conv_pool(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), **geom)
    y_ref = ref_ops.fused_conv_pool(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), impl="ref", **geom)
    assert tuple(y.shape) == (8, 5, 5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)


def test_plain_k1_no_bias_no_relu_and_out_view():
    """No bias, identity activation, and the ``out=`` form the executors use:
    a view into one bank of an (N, arena) tensor."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, 16, 16)).astype(np.float32)
    w = rng.standard_normal((4, 1, 3, 3)).astype(np.float32)
    y_ref = ref_ops.fused_conv_pool(jnp.asarray(x), jnp.asarray(w), None,
                                    activation="none", impl="ref")
    arena = torch.full((3, 500), 7.0)
    out = arena[:, 100:296].view(3, 4, 7, 7)
    y = fused_conv_pool(torch.from_numpy(x), torch.from_numpy(w), None,
                        activation="none", out=out)
    assert y.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(out.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    assert (arena[:, :100] == 7).all() and (arena[:, 296:] == 7).all()


def _q8_inputs(n, cin, H, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, cin, H, H)).astype(np.int8)
    w = rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8)
    b = rng.integers(-4000, 4000, (cout,)).astype(np.int32)
    return x, w, b


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_plain_k2_bit_exact_cifar_conv1(n, pool):
    x, w, b = _q8_inputs(n, 3, 32, 32, 5, seed=n)
    kw = dict(multiplier=float(np.float32(2e-3)), padding=2, pool=pool)
    y = fused_conv_pool_q8(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), **kw)
    y_ref = ref_q8.fused_conv_pool_q8(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), impl="xla", **kw)
    assert y.dtype == torch.int8 and tuple(y.shape) == (n, 32, 16, 16)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    # the outputs span the int8 range, saturation included
    assert y.min() < -100 or y.max() > 100


# (3, 2) is the §7 overlapping window, which fuses for max pools only.
@pytest.mark.parametrize("pool_k,pool_stride,pool", [
    (2, 2, "max"), (2, 3, "max"), (3, 2, "max"), (2, 2, "avg"), (2, 3, "avg")])
def test_plain_k2_bit_exact_pool_geometries(pool_k, pool_stride, pool):
    x, w, b = _q8_inputs(2, 3, 15, 8, 3, seed=pool_k * 10 + pool_stride)
    kw = dict(multiplier=0.003173828125, padding=0, pool_k=pool_k,
              pool_stride=pool_stride, pool=pool)
    y = fused_conv_pool_q8(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), **kw)
    y_ref = ref_q8.fused_conv_pool_q8(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), impl="xla", **kw)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


def test_plain_k2_rectangular_bit_exact():
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, (2, 20, 8)).astype(np.int8)
    w = rng.integers(-127, 128, (4, 2, 5, 3)).astype(np.int8)
    b = rng.integers(-1000, 1000, (4,)).astype(np.int32)
    for pool in ("max", "avg"):
        kw = dict(conv_stride=(2, 1), padding=(2, 1), pool_k=(2, 2),
                  pool_stride=(2, 2), activation="relu", pool=pool,
                  multiplier=0.003173828125)
        y = fused_conv_pool_q8(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), **kw)
        y_ref = ref_q8.fused_conv_pool_q8(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), impl="xla", **kw)
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


def test_effective_multiplier_is_the_reference_f32_division():
    m = 0.0123456789
    assert effective_multiplier(m, "max", 2) == np.float32(m)
    assert effective_multiplier(m, "avg", (2, 3)) == np.float32(m) / np.float32(6)
