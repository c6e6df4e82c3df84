"""K5's plain version (the port's flash attention on the CPU) against the
reference: the Pallas kernel in interpret mode where S divides its block,
the reference's oracle ``attention_ref`` for ragged S.

Inputs come from a numpy seed and go to both frameworks as arrays.
Tolerances are those of ``tests/test_kernel_flash.py``: f32 at
rtol = atol = 2e-5, bf16 at 5e-2.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import ops as ref_ops
from repro_torch.kernels.flash import ops, ref

F32_TOL, BF16_TOL = 2e-5, 5e-2

# (B, S, H, K, h, causal, window): the reference's kernel-test cases
PALLAS_CASES = [
    (1, 128, 4, 4, 32, True, 0),
    (2, 256, 4, 2, 64, True, 0),     # GQA 2:1
    (1, 256, 8, 1, 32, True, 0),     # MQA
    (2, 128, 4, 4, 32, False, 0),    # bidirectional
    (1, 256, 4, 2, 32, True, 64),    # sliding window
    (1, 384, 2, 2, 128, True, 128),  # window == block
]
# ragged S, as prompts come to the serving path
RAGGED_CASES = [
    (1, 1, 4, 2, 16, True, 0),
    (2, 17, 4, 2, 16, True, 0),
    (1, 129, 8, 2, 64, True, 0),
    (1, 45, 4, 1, 32, True, 8),
]


def _qkv(case, seed, dtype=np.float32):
    B, S, H, K, h = case[:5]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((B, S, H, h), (B, S, K, h), (B, S, K, h)))


def _torch(*arrays, dtype=torch.float32):
    return tuple(torch.as_tensor(np.array(a), dtype=dtype) for a in arrays)


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_matches_pallas_interpret(case):
    *_, causal, window = case
    q, k, v = _qkv(case, 100 + PALLAS_CASES.index(case))
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, impl="pallas")
    got = ops.flash_attention(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_plain_matches_reference_oracle_on_ragged_s(case):
    *_, causal, window = case
    q, k, v = _qkv(case, 200 + RAGGED_CASES.index(case))
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, impl="ref")
    got = ref.attention_ref(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S", [128, 33])
def test_plain_softcap(S):
    case = (1, S, 2, 2, 32)
    q, k, v = _qkv(case, 8)
    impl = "pallas" if S % 128 == 0 else "ref"
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   softcap=20.0, impl=impl)
    got = ops.flash_attention(*_torch(q, k, v), softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_plain_bf16():
    q, k, v = _qkv((1, 128, 4, 2, 32), 7)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = ref_ops.flash_attention(qb, kb, vb, impl="pallas")
    got = ops.flash_attention(*_torch(np.asarray(qb.astype(jnp.float32)),
                                      np.asarray(kb.astype(jnp.float32)),
                                      np.asarray(vb.astype(jnp.float32)),
                                      dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_rows_with_no_visible_key_write_zeros_like_the_tpu_kernel():
    """T < S with a window: rows past T - 1 + window see no key.  The TPU
    kernel (and K5) writes zeros there; so does the plain version."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 128, 2, 32)).astype(np.float32)
    k = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    want = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   window=8, impl="pallas")
    got = ref.attention_ref(*_torch(q, k, v), window=8)
    assert float(got[0, 100:].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_strided_views_give_the_same_result():
    """q/k/v as views of one fused projection, as K5 reads them."""
    rng = np.random.default_rng(4)
    qkv = torch.as_tensor(rng.standard_normal((2, 19, 8, 16)), dtype=torch.float32)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- K5's bf16 tensor-core numerics, emulated on the CPU -----------------
# chip_smoke.py's bf16 gate: rtol = atol = 5e-2, and each output row (one
# query, one head) within 2e-2 of its largest |value|.
K5_BF16_ROW_REL = 2e-2


def _tc_emulation(q, k, v, *, causal=True, window=0, softcap=0.0, block=64):
    """K5's bf16 path in plain torch: f32 scores of bf16 q, k (each product
    exact in f32); per key block of ``block`` the scale, the softcap and the
    mask, a running max per row, f32 probabilities summed into l and
    rounded to bf16 as PV's operand, f32 accumulation and rescale; the
    result divided by l (zeros where no key is visible) and rounded to
    bf16.  A test helper: nothing on the main path calls it."""
    B, S, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, h)
    kf, vf = k.float(), v.float()
    m = torch.full((B, K, H // K, S), float("-inf"))
    l = torch.zeros((B, K, H // K, S))
    acc = torch.zeros((B, K, H // K, S, h))
    qi = torch.arange(S)[:, None]
    for k0 in range(0, T, block):
        kj = torch.arange(k0, min(k0 + block, T))[None, :]
        s = torch.einsum("bskgh,btkh->bkgst", qf, kf[:, k0:k0 + block]) * (h ** -0.5)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = torch.ones_like(kj == qi)
        if causal:
            ok &= kj <= qi
        if window:
            ok &= kj > qi - window
        s = torch.where(ok, s, float("-inf"))
        mnew = torch.maximum(m, s.amax(-1))
        alpha = torch.where(m == float("-inf"), 0.0, torch.exp(m - mnew))
        p = torch.where(s == float("-inf"), 0.0, torch.exp(s - mnew[..., None]))
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgst,btkh->bkgsh", p.bfloat16().float(), vf[:, k0:k0 + block])
        acc = acc * alpha[..., None] + pv
        m = mnew
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, h).bfloat16()


@pytest.mark.parametrize("S,window,softcap", [
    (128, 0, 0.0), (77, 0, 0.0), (128, 48, 0.0), (77, 0, 30.0)])
def test_tensor_core_numerics_pass_the_bf16_gate(S, window, softcap):
    """On the Llama-3.2-1B head shape (H 32, K 8, h 64): the bf16 path's one
    new rounding (P to bf16) and its block-wise max stay inside chip_smoke's
    bf16 gate against the plain version, which the gate holds the kernel
    to.  Each score is exact in f32; only the sums' order changes."""
    q, k, v = _torch(*_qkv((1, S, 32, 8, 64), 500 + S + window), dtype=torch.bfloat16)
    got = _tc_emulation(q, k, v, window=window, softcap=softcap)
    want = ref.attention_ref(q, k, v, window=window, softcap=softcap)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL, atol=BF16_TOL)
    err = (got.float() - want.float()).abs().amax(-1)
    top = want.float().abs().amax(-1)
    assert bool((err <= K5_BF16_ROW_REL * top).all())
    # the rounding of P shows: the emulation is not the plain version itself
    assert float(err.max()) > 0.0

