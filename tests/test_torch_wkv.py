"""K7's plain version (the port's chunked wkv6 on the CPU) against the
reference: ``repro.kernels.wkv.ops.wkv`` with ``impl="pallas"`` (interpret
mode) and ``impl="ref"`` (the chunked jnp oracle), and against the port's
own stepwise recurrence.

Inputs come from a numpy seed.  Tolerances are those of
``tests/test_kernel_wkv.py``: 2e-5 against the chunked forms, rtol 1e-4 /
atol 1e-5 against the stepwise one, 5e-2 for bf16 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import ops as ref_ops
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
