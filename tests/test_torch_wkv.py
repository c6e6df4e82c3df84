"""K7's plain version (the port's chunked wkv6 on the CPU) against the
reference: ``repro.kernels.wkv.ops.wkv`` with ``impl="pallas"`` (interpret
mode) and ``impl="ref"`` (the chunked jnp oracle), and against the port's
own stepwise recurrence.

Inputs come from a numpy seed.  Tolerances are those of
``tests/test_kernel_wkv.py``: 2e-5 against the chunked forms, rtol 1e-4 /
atol 1e-5 against the stepwise one, 5e-2 for bf16 inputs.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import ops as ref_ops
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.kernels.wkv import ops
from repro_torch.models import rwkv6

# (B, S, H, hk, hv, chunk)
CASES = [
    (1, 32, 2, 8, 8, 8),
    (2, 64, 2, 16, 16, 16),
    (1, 48, 4, 8, 8, 16),
    (1, 40, 1, 8, 8, 16),   # chunk shrinks to a divisor (8)
    (2, 64, 2, 8, 8, 64),   # single chunk
    (1, 13, 2, 8, 8, 8),    # prime S: chunks of 1
    (1, 24, 2, 16, 16, 8),  # the reference launcher's chunk of 8
]


def _inputs(case):
    B, S, H, hk, hv, chunk = case
    rng = np.random.default_rng(1000 + CASES.index(case) if case in CASES else 7)
    r = rng.standard_normal((B, S, H, hk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, hk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, hv)).astype(np.float32)
    logw = -rng.uniform(0.02, 2.0, (B, S, H, hk)).astype(np.float32)
    u = rng.standard_normal((H, hk)).astype(np.float32)
    return (r, k, v, logw, u), chunk


def _torch(arrays, dtype=torch.float32):
    r, k, v, logw, u = (torch.as_tensor(a) for a in arrays)
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference(case, impl):
    arrays, chunk = _inputs(case)
    o_r, s_r = ref_ops.wkv(*(jnp.asarray(a) for a in arrays), chunk=chunk, impl=impl)
    o, s = ops.wkv(*_torch(arrays), chunk=chunk)
    assert o.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [(1, 24, 2, 8, 8, 8), (1, 23, 2, 8, 8, 64)])
def test_plain_matches_stepwise(case):
    arrays, chunk = _inputs(case)
    r, k, v, logw, u = _torch(arrays)
    o_c, s_c = ops.wkv(r, k, v, logw, u, chunk=chunk)
    B, S, H, hk = r.shape
    s = torch.zeros((B, H, hk, v.shape[-1]))
    outs = []
    for t in range(S):
        o, s = rwkv6.wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, s)
        outs.append(o)
    torch.testing.assert_close(o_c, torch.stack(outs, 1), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s_c, s, rtol=1e-4, atol=1e-5)


def test_plain_bf16_inputs():
    arrays, chunk = _inputs(CASES[0])
    rb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in arrays[:3])
    o_r, _ = ref_ops.wkv(rb, kb, vb, jnp.asarray(arrays[3]), jnp.asarray(arrays[4]),
                         chunk=chunk, impl="pallas")
    o, _ = ops.wkv(*_torch(arrays, torch.bfloat16), chunk=chunk)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=5e-2, atol=5e-2)


def test_chunk_rule_is_the_references():
    """The largest divisor of S not above the chunk asked for
    (``repro/kernels/wkv/ops.py:27-29``)."""
    def reference_rule(S, chunk):
        c = min(chunk, S)
        while S % c:
            c -= 1
        return c

    for S in (1, 2, 13, 50, 63, 64, 200, 256, 509, 1000):
        for chunk in (8, 64):
            assert ops.chunk_for(S, chunk) == reference_rule(S, chunk)
    assert ops.chunk_for(509, 64) == 1 and ops.chunk_for(200, 64) == 50


def _state(case, seed):
    B, S, H, hk, hv, _ = case
    return np.random.default_rng(seed).standard_normal((B, H, hk, hv)).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_plain_from_a_carried_state_matches_reference(case):
    """``s0`` means what it means in the reference's ``wkv_chunked``."""
    from repro.models import rwkv6 as ref_rwkv6

    arrays, chunk = _inputs(case)
    s0 = _state(case, 2000 + CASES.index(case))
    c = ops.chunk_for(case[1], chunk)
    o_r, s_r = ref_rwkv6.wkv_chunked(*(jnp.asarray(a) for a in arrays), jnp.asarray(s0),
                                     chunk=c)
    o, s = ops.wkv(*_torch(arrays), chunk=chunk, s0=torch.as_tensor(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=2e-5, atol=2e-5)


def test_plain_from_a_carried_state_matches_stepwise():
    case = (1, 24, 2, 8, 8, 8)
    arrays, chunk = _inputs(case)
    r, k, v, logw, u = _torch(arrays)
    s = torch.as_tensor(_state(case, 3000))
    o_c, s_c = ops.wkv(r, k, v, logw, u, chunk=chunk, s0=s)
    outs = []
    for t in range(r.shape[1]):
        o, s = rwkv6.wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, s)
        outs.append(o)
    torch.testing.assert_close(o_c, torch.stack(outs, 1), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s_c, s, rtol=1e-4, atol=1e-5)


def test_plain_zero_state_is_no_state():
    arrays, chunk = _inputs(CASES[1])
    t = _torch(arrays)
    o, s = ops.wkv(*t, chunk=chunk)
    o0, s0 = ops.wkv(*t, chunk=chunk, s0=torch.zeros_like(s))
    assert torch.equal(o, o0) and torch.equal(s, s0)


@pytest.mark.parametrize("needs_ds0", [True, False])
def test_function_gradient_reaches_the_carried_state(needs_ds0):
    """The Function's plain-VJP backward (run here on the CPU) returns ds0
    when ``s0`` requires grad, None otherwise, and the other gradients as
    autograd through the plain version does."""
    case = (1, 16, 2, 8, 8, 8)
    arrays, chunk = _inputs(case)
    rng = np.random.default_rng(4000)
    go = torch.as_tensor(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    gs = torch.as_tensor(rng.standard_normal((1, 2, 8, 8)).astype(np.float32))
    s0 = torch.as_tensor(_state(case, 4001))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    s_leaf = s0.clone().requires_grad_(needs_ds0)
    o, s = ops.WKV.apply(*leaves, chunk, s_leaf)
    got = torch.autograd.grad((o * go).sum() + (s * gs).sum(),
                              leaves + ([s_leaf] if needs_ds0 else []))
    leaves2 = [t.detach().clone().requires_grad_(True) for t in leaves]
    s_leaf2 = s0.clone().requires_grad_(needs_ds0)
    o2, s2 = ops.wkv(*leaves2, chunk=chunk, s0=s_leaf2)  # the CPU path: plain autograd
    want = torch.autograd.grad((o2 * go).sum() + (s2 * gs).sum(),
                               leaves2 + ([s_leaf2] if needs_ds0 else []))
    assert len(got) == len(want) == 5 + needs_ds0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if needs_ds0:
        assert float(got[-1].abs().max()) > 0
    else:
        # the backward hands autograd None for s0
        o3, _ = ops.WKV.apply(*leaves, chunk, s0)
        ctx_grads = o3.grad_fn.apply(go, None)
        assert ctx_grads[-1] is None and ctx_grads[-2] is None


# K7's order (kernels/wkv/ref.py::wkv_two_pass) against the reference: the
# RWKV6 head (hk = hv = 64, four 16-column state slices), S up to 509
# (prime: the reference runs chunks of 1, K7 its own tiles, the last ragged).
TWO_PASS_SEQS = (2, 63, 64, 200, 509)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("tile", [wkv_kernel.TILE, 64, 8])
@pytest.mark.parametrize("S", TWO_PASS_SEQS)
def test_two_pass_order_matches_reference(S, tile, carried, dtype):
    from repro.models import rwkv6 as ref_rwkv6

    from repro_torch.kernels.wkv.ref import wkv_two_pass

    rng = np.random.default_rng(5000 + S + tile + carried)
    H, h = 2, 64
    r, k, v = (rng.standard_normal((1, S, H, h)).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":  # both sides see the same bf16 values
        r, k, v = (torch.as_tensor(a).to(torch.bfloat16).float().numpy() for a in (r, k, v))
    logw = -rng.uniform(0.02, 2.0, (1, S, H, h)).astype(np.float32)
    u = rng.standard_normal((H, h)).astype(np.float32)
    s0 = rng.standard_normal((1, H, h, h)).astype(np.float32) if carried else None
    c = ops.chunk_for(S, 64)
    o_r, s_r = ref_rwkv6.wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)),
        jnp.asarray(s0 if carried else np.zeros((1, H, h, h), np.float32)), chunk=c)
    tdt = getattr(torch, dtype)
    o, s = wkv_two_pass(*(torch.as_tensor(a).to(tdt) for a in (r, k, v)),
                        torch.as_tensor(logw), torch.as_tensor(u),
                        None if s0 is None else torch.as_tensor(s0), tile=tile)
    assert o.dtype == s.dtype == torch.float32
    # rtol 1e-4, atol 1e-5 plus chip_smoke.k7_round_units(hk, chunk) f32
    # epsilons of M, each element's terms' magnitudes summed (the same scan on
    # |r|, |k|, |v|, |u|, |s0|): two f32 orders of one sum of 64 terms of
    # size ~10 differ by more than 1e-5 near a zero of the sum.
    mags = ref_rwkv6.wkv_chunked(
        *(jnp.asarray(np.abs(a)) for a in (r, k, v)), jnp.asarray(logw),
        jnp.asarray(np.abs(u)),
        jnp.asarray(np.abs(s0) if carried else np.zeros((1, H, h, h), np.float32)), chunk=c)
    eps = np.finfo(np.float32).eps
    units = 4 * (h + c)
    for name, got, want, m in zip(("o", "s_final"), (o, s), (o_r, s_r), mags):
        want, m = np.asarray(want), np.asarray(m)
        diff = np.abs(got.numpy() - want)
        allowed = 1e-4 * np.abs(want) + 1e-5 + units * eps * m
        # the worst reading in f32 epsilons of M, and the worst share of the
        # whole allowance (shown with pytest -s)
        used, share = float((diff / (eps * m)).max()), float((diff / allowed).max())
        print(f"two-pass S={S} tile={tile} s0={carried} {dtype} {name}: "
              f"{used:.2f} eps of M of {units} allowed, {share:.4f} of the allowance")
        assert share <= 1.0, (used, units)


def test_tile_matches_the_kernel_source():
    # the wrapper sizes K7's per-tile scratch by TILE, the kernel tiles by kTile
    src = (Path(wkv_kernel.__file__).parents[2] / "csrc" / "wkv_fwd.cu").read_text()
    assert f"constexpr int kTile = {wkv_kernel.TILE};" in src
