"""K6's plain versions and the three training Functions against the reference.

* The port's ``naive_xent``, ``chunked_xent`` and ``seq_chunked_xent`` (and
  ``fused_xent`` on CPU tensors) against ``fused_xent(impl="pallas")`` (the
  Pallas kernel in interpret mode) and the reference's refs, on
  ``tests/test_kernel_xent.py``'s four cases, at rtol = atol = 1e-5.
* ``FusedXent``, ``FlashAttention`` and ``WKV``, run with their plain
  forward on CPU tensors, give the gradients of ``jax.grad`` through
  ``fused_xent(impl="pallas")``, ``flash_attention(impl="pallas")`` and
  ``wkv_chunked``, at rtol 1e-4, atol 1e-5, for a random linear functional
  of their outputs.

Inputs come from a numpy seed and go to both frameworks as arrays.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import ops as ref_flash_ops
from repro.kernels.xent import ops as ref_xent_ops
from repro.kernels.xent import ref as ref_xent
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.kernels.xent import ref as xent_ref

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

# (B, S, D, V, softcap): tests/test_kernel_xent.py's cases
CASES = [
    (2, 64, 32, 512, 0.0),
    (1, 128, 64, 1000, 0.0),   # V not divisible by a block
    (2, 64, 32, 512, 30.0),    # softcapped
    (1, 32, 16, 37, 0.0),      # tiny odd vocab
]
PLAIN_FORMS = {
    "naive": lambda x, w, t, cap: xent_ref.naive_xent(x, w, t, softcap=cap),
    "chunked": lambda x, w, t, cap: xent_ref.chunked_xent(x, w, t, chunk=128, softcap=cap),
    "seq_chunked": lambda x, w, t, cap: xent_ref.seq_chunked_xent(x, w, t, chunk=16,
                                                                  softcap=cap),
    "fused_xent[cpu]": lambda x, w, t, cap: xent_ops.fused_xent(x, w, t, softcap=cap),
}


def _xent_inputs(case, seed):
    B, S, D, V, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    if case[4]:  # logits large enough for the softcap to bite
        w *= 10
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    t.reshape(-1)[:2] = [0, V - 1]
    return x, w, t


@functools.lru_cache(maxsize=None)
def _reference_ce(ci):
    """(Pallas interpret CE, the reference's naive CE) of case ``ci``."""
    x, w, t = _xent_inputs(CASES[ci], 500 + ci)
    cap = CASES[ci][4]
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(t))
    return (np.asarray(ref_xent_ops.fused_xent(*args, softcap=cap, impl="pallas")),
            np.asarray(ref_xent.naive_xent(*args, softcap=cap)))


@pytest.mark.parametrize("form", sorted(PLAIN_FORMS))
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plain_forms_match_pallas_and_reference(ci, form):
    x, w, t = _xent_inputs(CASES[ci], 500 + ci)
    got = PLAIN_FORMS[form](torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(t),
                            CASES[ci][4]).numpy()
    pallas, naive = _reference_ce(ci)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, naive, rtol=TOL, atol=TOL)


def test_seq_chunk_rule_matches_reference():
    for S, chunk, want in ((64, 16, 16), (65, 16, 13), (13, 256, 13), (300, 256, 150)):
        assert xent_ref.seq_chunk_for(S, chunk) == want


def _functional(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", [(1, 32, 16, 128, 0.0), (2, 40, 32, 300, 30.0),
                                  (1, 300, 16, 37, 0.0)])
def test_fused_xent_function_gradients_match_jax(case):
    """S=300 runs the backward's sequence chunks (150 + 150)."""
    x, w, t = _xent_inputs(case, 600)
    (g,) = _functional(np.random.default_rng(601), t.shape)
    cap = case[4]

    def loss(x, w):
        return jnp.sum(ref_xent_ops.fused_xent(x, w, jnp.asarray(t), softcap=cap,
                                               impl="pallas") * g)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.as_tensor(a).requires_grad_(True) for a in (x, w))
    ce = xent_ops.FusedXent.apply(xt, wt, torch.as_tensor(t), cap)
    assert type(ce.grad_fn).__name__.startswith("FusedXent")
    got = torch.autograd.grad((ce * torch.as_tensor(g)).sum(), (xt, wt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# (B, S, H, K, h, window, softcap); S divides the Pallas kernel's block.
FLASH_CASES = [(1, 128, 4, 2, 32, 0, 0.0), (1, 256, 4, 2, 32, 64, 0.0),
               (2, 128, 2, 1, 64, 0, 20.0)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_function_gradients_match_jax(case):
    B, S, H, K, h, window, cap = case
    rng = np.random.default_rng(700 + FLASH_CASES.index(case))
    q, k, v, g = _functional(rng, (B, S, H, h), (B, S, K, h), (B, S, K, h), (B, S, H, h))
    geom = dict(causal=True, window=window, scale=h ** -0.5, softcap=cap)

    def loss(q, k, v):
        return jnp.sum(ref_flash_ops.flash_attention(q, k, v, impl="pallas", **geom) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.as_tensor(a).requires_grad_(True) for a in (q, k, v))
    out = flash_ops.FlashAttention.apply(qt, kt, vt, True, window, h ** -0.5, cap)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad((out * torch.as_tensor(g)).sum(), (qt, kt, vt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# (B, S, H, hk, chunk): chunk a divisor of S, as wkv_ops.wkv passes it
WKV_CASES = [(1, 32, 2, 8, 8), (2, 24, 2, 16, 8), (1, 13, 2, 8, 1)]


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_function_gradients_match_jax(case):
    """Gradients to r, k, v, logw and u through o and s_final."""
    B, S, H, hk, chunk = case
    rng = np.random.default_rng(800 + WKV_CASES.index(case))
    r, k, v, go = _functional(rng, *[(B, S, H, hk)] * 4)
    logw = -rng.uniform(0.02, 2.0, (B, S, H, hk)).astype(np.float32)
    u, gs = _functional(rng, (H, hk), (B, H, hk, hk))

    def loss(*a):
        s0 = jnp.zeros((B, H, hk, hk), jnp.float32)
        o, s = ref_rwkv6.wkv_chunked(*a, s0, chunk=chunk)
        return jnp.sum(o * go) + jnp.sum(s * gs)

    arrays = (r, k, v, logw, u)
    want = jax.grad(loss, argnums=range(5))(*(jnp.asarray(a) for a in arrays))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    o, s = wkv_ops.WKV.apply(*leaves, chunk)
    assert type(o.grad_fn).__name__.startswith("WKV")
    got = torch.autograd.grad((o * torch.as_tensor(go)).sum() + (s * torch.as_tensor(gs)).sum(),
                              leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_wkv_function_gradient_through_o_alone():
    """s_final unused (as in training): its gradient is None, and u still
    gets its gradient through o."""
    rng = np.random.default_rng(900)
    r, k, v, go = _functional(rng, *[(1, 16, 2, 8)] * 4)
    logw = -rng.uniform(0.02, 2.0, (1, 16, 2, 8)).astype(np.float32)
    (u,) = _functional(rng, (2, 8))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (r, k, v, logw, u)]
    o, _ = wkv_ops.WKV.apply(*leaves, 8)
    got = torch.autograd.grad((o * torch.as_tensor(go)).sum(), leaves)
    o2, _ = wkv_ops.wkv(*leaves, chunk=8)  # the CPU path: plain autograd
    want = torch.autograd.grad((o2 * torch.as_tensor(go)).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# K6's gate on the card (chip_smoke.py: K6_RTOL, K6_ATOL, K6_EPS_UNITS):
# per token |K6 - plain| <= 1e-5 |plain| + 1e-5 + 8 eps M, M = |x_n| max|w_v|.
K6_RTOL, K6_ATOL, K6_EPS_UNITS = 1e-5, 1e-5, 8


def test_tf32_rounding_is_cvt_rna():
    """To the nearest TF32 value (10 mantissa bits), ties away from zero."""
    u = 2.0 ** -10  # one TF32 unit at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 2 - 2.0 ** -20, 1 + 1.5 * u,
                      2 - u / 4, 3.0e-3, -7.0])
    # 3e-3 = 1.536 x 2^-9, and 1.536 x 2^10 = 1572.86 rounds to 1573
    want = torch.tensor([1 + u, -(1 + u), 1.0, 1 + 2 * u, 2.0, 1573 * 2.0 ** -19, -7.0])
    torch.testing.assert_close(xent_ref.tf32_rna(x), want, rtol=0, atol=0)
    hi, lo = xent_ref.split_tf32(x)
    assert torch.equal(xent_ref.tf32_rna(hi), hi) and torch.equal(xent_ref.tf32_rna(lo), lo)
    assert float(((hi + lo) - x).abs().div(x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("N,D,V,softcap,w_std", [
    (64, 256, 4096, 0.0, None),   # logits ~ N(0, 1), as at the models' init
    (64, 256, 4096, 30.0, 1.0),   # logits ~ N(0, 256): the softcap bites
    (32, 37, 1000, 0.0, 0.1),     # D not a multiple of the k8 step: zero-padded
])
def test_k6_3xtf32_emulation_holds_the_k6_gate(N, D, V, softcap, w_std):
    """K6's tensor-core arithmetic (TF32 hi/lo split, three products a k8
    slice summed in f32) against the plain f32 version, within the gate
    K6 is held to on the card, with half of its rounding allowance (4 eps M)
    left for the card's own accumulation order."""
    rng = np.random.default_rng(N + D + V + int(softcap))
    x = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((V, D)) * (w_std or D ** -0.5),
                        dtype=torch.float32)
    t = torch.as_tensor(rng.integers(0, V, N).astype(np.int32))
    plain = xent_ref.seq_chunked_xent(x[None], w, t[None], softcap=softcap)[0]
    emu = xent_ref.xent_3xtf32(x, w, t, softcap=softcap, vocab_chunk=1024)
    eps = torch.finfo(torch.float32).eps
    M = x.norm(dim=1) * w.norm(dim=1).max()
    diff = (emu - plain).abs()
    assert bool((diff <= K6_RTOL * plain.abs() + K6_ATOL + K6_EPS_UNITS * eps * M).all())
    assert float((diff / (eps * M)).max()) <= K6_EPS_UNITS / 2
    # a single TF32 product (no low parts) is far outside the same share
    one = xent_ref.tf32_rna(x) @ xent_ref.tf32_rna(w).T
    one = torch.logsumexp(xent_ref._cap(one, softcap), -1) - xent_ref._cap(
        one, softcap).gather(1, t.long()[:, None])[:, 0]
    assert float(((one - plain).abs() / (eps * M)).max()) > K6_EPS_UNITS


def test_k6_truncating_accumulation_needs_the_stage_partials():
    """The card's tensor-core sums cut toward zero.  Modelled so, one chain
    over all of D = 2,048 drifts several eps M from the f32 plain version;
    K6's fresh partial a 64-deep stage, added in f32, stays within the
    share the route was chosen for (4 eps M)."""
    rng = np.random.default_rng(16)
    N, D, V = 16, 2048, 512
    x = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((V, D)) * D ** -0.5, dtype=torch.float32)
    t = torch.as_tensor(rng.integers(0, V, N).astype(np.int32))
    plain = xent_ref.seq_chunked_xent(x[None], w, t[None])[0]
    eps = torch.finfo(torch.float32).eps
    M = x.norm(dim=1) * w.norm(dim=1).max()

    def share(**model):
        got = xent_ref.xent_3xtf32(x, w, t, truncate=True, **model)
        return float(((got - plain).abs() / (eps * M)).max())

    staged, one_chain = share(stage=64), share(stage=D)
    assert staged <= K6_EPS_UNITS / 2 < one_chain
