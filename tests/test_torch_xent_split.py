"""The vocab-split cross-entropy of the sharded train step, against the reference.

``tensor_parallel.xent`` runs the loss on each model coordinate's vocab
block of the unembedding (``xent_ops.xent_part``: :class:`XentPart` on
K6's partial form, its plain block form on the CPU) and combines the
blocks' ``(lse, t)`` by log-sum-exp on the row's device.  On CPU meshes
(1, tp) of one repeated CPU, inputs from a numpy seed:

* ``xent_block_ref``'s ``(lse, t)`` against ``jax.nn.logsumexp`` and the
  target logit over the block of the reference's logits (0 outside it);
* the split loss for tp 2 and 4, with and without a softcap, targets in
  every block and at both edges of each, in every ``xent_impl`` form:
  the per-token CE, dx and each block's dw against the reference's
  ``naive_xent`` / ``seq_chunked_xent`` and ``jax.grad``, at 1e-5, and no
  leaf gathered;
* ``XentPart``'s gradients against autograd through the plain block form
  (its backward's sequence chunks included);
* a table whole at the row's first coordinate (a model axis of 1) or not
  split on ``"model"`` takes the whole-table loss, bit for bit;
* ``form="naive"`` on a CUDA block materializes it in the compute dtype,
  as ``LocalOps.xent`` does for the whole table, and never runs K6;
* K6's partial form's wrapper checks its arguments as ``fused_xent_fwd``
  does, launches once on fake CUDA tensors, and never takes a CPU tensor
  to the C entry.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import ctypes
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xent import ref as ref_xent
from repro_torch.configs import base
from repro_torch.kernels.xent import kernel as xent_kernel
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.kernels.xent import ref as xent_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import LocalOps
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.policy import Spec

TOL = 1e-5
B, S, D, V = 2, 24, 32, 512
SEQ_CHUNK = 8  # the sharded train tests' xent_seq_chunk
CAP = 30.0  # a softcap that bites at these logits (w scaled up below)


def _cfg():
    return dataclasses.replace(base.get_reduced_config("llama3.2-1b"), compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _inputs(n_blocks, softcap):
    """x (B, S, D), w (V, D), targets (B, S) int32 with every block's first
    and last id among them, and a cotangent g (B, S), numpy from a seed."""
    rng = np.random.default_rng(2700 + n_blocks + int(softcap))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * (1.0 if softcap else 0.1)).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    per = V // n_blocks
    edges = [v for c in range(n_blocks) for v in (c * per, (c + 1) * per - 1)]
    t.reshape(-1)[:len(edges)] = edges
    g = rng.standard_normal((B, S)).astype(np.float32)
    return x, w, t, g


def _ref_logits(x, w, softcap):
    logits = jnp.einsum("bsd,vd->bsv", jnp.asarray(x), jnp.asarray(w)).astype(jnp.float32)
    return jnp.tanh(logits / softcap) * softcap if softcap else logits


@pytest.mark.parametrize("softcap", [0.0, CAP], ids=["nocap", "cap"])
@pytest.mark.parametrize("n_blocks", [2, 4])
def test_block_ref_matches_reference_logsumexp_and_target_logit(n_blocks, softcap):
    x, w, t, _ = _inputs(n_blocks, softcap)
    logits = _ref_logits(x, w, softcap)
    per = V // n_blocks
    total_t = np.zeros(t.shape, np.float32)
    for c in range(n_blocks):
        v0, v1 = c * per, (c + 1) * per
        lse, tt = xent_ref.xent_block_ref(torch.as_tensor(x), torch.as_tensor(w[v0:v1]),
                                          torch.as_tensor(t), v0, softcap=softcap,
                                          chunk=SEQ_CHUNK)
        want_lse = jax.nn.logsumexp(logits[..., v0:v1], axis=-1)
        inside = (t >= v0) & (t < v1)
        hit = np.take_along_axis(np.asarray(logits), t[..., None], axis=-1)[..., 0]
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tt.numpy(), np.where(inside, hit, 0.0), rtol=TOL, atol=TOL)
        assert np.all(tt.numpy()[~inside] == 0.0)  # the block holds no other target
        total_t += tt.numpy()
    np.testing.assert_allclose(total_t, np.take_along_axis(np.asarray(logits), t[..., None],
                                                           axis=-1)[..., 0], rtol=TOL, atol=TOL)


def _placed_table(w, n_blocks, spec=("model", None)):
    """``w`` placed on a (1, n_blocks) CPU mesh by ``spec``, and its one data row."""
    mesh = make_mesh((1, n_blocks), ("data", "model"), device="cpu")
    table = pl.place(torch.as_tensor(w), pl.NamedSharding(mesh, Spec(spec)))
    row = tp.rows_at_work(mesh, tp.data_rows(mesh, ("data",)), B, True)[0]
    return table, row


@functools.lru_cache(maxsize=None)
def _reference(n_blocks, softcap):
    """(naive CE, seq-chunked CE, dx, dw) of the reference on the inputs, the
    gradients of sum(g * seq_chunked_xent) by ``jax.grad``."""
    x, w, t, g = _inputs(n_blocks, softcap)
    tj = jnp.asarray(t)

    def loss(x, w):
        return jnp.sum(ref_xent.seq_chunked_xent(x, w, tj, chunk=SEQ_CHUNK, softcap=softcap)
                       * jnp.asarray(g))

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    naive = ref_xent.naive_xent(jnp.asarray(x), jnp.asarray(w), tj, softcap=softcap)
    chunked = ref_xent.seq_chunked_xent(jnp.asarray(x), jnp.asarray(w), tj, chunk=SEQ_CHUNK,
                                        softcap=softcap)
    return tuple(np.asarray(a) for a in (naive, chunked, dx, dw))


@pytest.mark.parametrize("form", ["naive", "chunked", "seq_chunked"])
@pytest.mark.parametrize("softcap", [0.0, CAP], ids=["nocap", "cap"])
@pytest.mark.parametrize("n_blocks", [2, 4])
def test_split_loss_and_block_gradients_match_reference(n_blocks, softcap, form, monkeypatch):
    x, w, t, g = _inputs(n_blocks, softcap)
    table, row = _placed_table(w, n_blocks)
    monkeypatch.setattr(pl, "gather", lambda *a, **k: pytest.fail("a leaf was gathered"))
    blocks = [table.shard(c).requires_grad_(True) for c in row.coords]
    xt = torch.as_tensor(x).requires_grad_(True)
    ce = tp.xent(_cfg(), table, xt, torch.as_tensor(t), row, softcap=softcap, form=form,
                 chunk=128, seq_chunk=SEQ_CHUNK)
    naive, chunked, dx, dw = _reference(n_blocks, softcap)
    np.testing.assert_allclose(ce.detach().numpy(), naive, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ce.detach().numpy(), chunked, rtol=TOL, atol=TOL)
    got = torch.autograd.grad((ce * torch.as_tensor(g)).sum(), [xt] + blocks)
    np.testing.assert_allclose(got[0].numpy(), dx, rtol=TOL, atol=TOL)
    per = V // n_blocks
    for c, gb in enumerate(got[1:]):
        assert gb.shape == (per, D)
        np.testing.assert_allclose(gb.numpy(), dw[c * per:(c + 1) * per], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bwd_chunk", [256, 8])
@pytest.mark.parametrize("softcap", [0.0, CAP], ids=["nocap", "cap"])
def test_xent_part_gradients_match_autograd_through_the_plain_block_form(softcap, bwd_chunk,
                                                                         monkeypatch):
    """Targets in the block, before it and past it; the Function's forward
    and backward in sequence chunks of 256 (one) and of 8."""
    monkeypatch.setattr(xent_ops, "BWD_SEQ_CHUNK", bwd_chunk)
    x, w, t, _ = _inputs(2, softcap)
    rng = np.random.default_rng(2710)
    g_lse, g_t = (torch.as_tensor(rng.standard_normal((B, S)).astype(np.float32))
                  for _ in range(2))
    v0, v1 = 100, 356  # the block's ids: [100, 356)
    local = torch.as_tensor(t) - v0
    assert bool((local < 0).any()) and bool((local >= v1 - v0).any())
    xt, wt = (torch.as_tensor(a).requires_grad_(True) for a in (x, w[v0:v1]))
    lse, tt = xent_ops.XentPart.apply(xt, wt, local, softcap)
    assert type(lse.grad_fn).__name__.startswith("XentPart")
    got = torch.autograd.grad((lse * g_lse).sum() + (tt * g_t).sum(), (xt, wt))
    xp, wp = (a.detach().clone().requires_grad_(True) for a in (xt, wt))
    want_lse, want_t = xent_ref.xent_block_ref(xp, wp, torch.as_tensor(t), v0, softcap=softcap,
                                               chunk=SEQ_CHUNK)
    want = torch.autograd.grad((want_lse * g_lse).sum() + (want_t * g_t).sum(), (xp, wp))
    np.testing.assert_allclose(lse.detach().numpy(), want_lse.detach().numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(tt.detach().numpy(), want_t.detach().numpy())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("spec", [("model", None), (None, None)], ids=["axis1", "replicated"])
@pytest.mark.parametrize("form", ["naive", "seq_chunked"])
def test_whole_table_takes_the_unsharded_loss_bit_for_bit(spec, form, monkeypatch):
    """A model axis of 1 (the block is the table) or a table the policy
    replicates (``shard_embed_vocab=False``, or V not divisible): the
    whole-table loss from the row's first coordinate's copy, no
    ``XentPart``."""
    x, w, t, _ = _inputs(2, 0.0)
    n = 1 if spec[0] else 2
    table, row = _placed_table(w, n, spec)
    monkeypatch.setattr(xent_ops, "xent_part", lambda *a, **k: pytest.fail("split loss"))
    kw = dict(softcap=0.0, form=form, chunk=128, seq_chunk=SEQ_CHUNK)
    got = tp.xent(_cfg(), table, torch.as_tensor(x), torch.as_tensor(t), row, **kw)
    want = LocalOps(_cfg()).xent(torch.as_tensor(w), torch.as_tensor(x), torch.as_tensor(t),
                                 **kw)
    assert torch.equal(got, want)


def test_naive_form_materializes_the_block_in_the_compute_dtype_on_cuda(monkeypatch):
    """``form="naive"`` means on a CUDA block what it means on the CPU and
    for the whole table (``LocalOps.xent``): the block's logits in the
    compute dtype, never K6's partial form."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(xent_ops, "XentPart",
                        type("NoK6", (), {"apply": lambda *a: pytest.fail("K6 on naive")}))
    seen = []

    def block(x, w, t, softcap=0.0):
        seen.append((x.dtype, w.dtype, x.device.type, softcap))
        return (torch.zeros(x.shape[:2], device=x.device),) * 2

    monkeypatch.setattr(xent_ref, "naive_xent_block", block)
    with FakeTensorMode():
        x = torch.empty(B, S, D, device="cuda")
        w = torch.empty(V // 2, D, device="cuda")
        t = torch.empty(B, S, dtype=torch.int32, device="cuda")
        lse, tt = xent_ops.xent_part(x, w, t, softcap=CAP, form="naive",
                                     compute_dtype=torch.bfloat16)
        assert lse.shape == tt.shape == (B, S)
    assert seen == [(torch.bfloat16, torch.bfloat16, "cuda", CAP)]


def test_xent_part_wrapper_checks_before_launching():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(8, 16, device="cuda")
        w = torch.empty(37, 16, device="cuda")
        t = torch.empty(8, dtype=torch.int32, device="cuda")
        with pytest.raises(TypeError, match="f32"):
            xent_kernel.fused_xent_part(x.to(torch.bfloat16), w, t)
        with pytest.raises(TypeError, match="f32"):
            xent_kernel.fused_xent_part(x, w.to(torch.float16), t)
        with pytest.raises(TypeError, match="int32"):
            xent_kernel.fused_xent_part(x, w, t.long())
        with pytest.raises(ValueError, match="contiguous"):
            xent_kernel.fused_xent_part(torch.empty(16, 8, device="cuda").T, w, t)
        with pytest.raises(ValueError, match="contiguous"):
            xent_kernel.fused_xent_part(x, torch.empty(16, 37, device="cuda").T, t)
        with pytest.raises(ValueError, match="targets"):
            xent_kernel.fused_xent_part(x, w, torch.empty(7, dtype=torch.int32, device="cuda"))
        with pytest.raises(ValueError, match="w"):
            xent_kernel.fused_xent_part(x, torch.empty(37, 15, device="cuda"), t)


def test_xent_part_launches_once_on_cuda_and_never_takes_a_cpu_tensor(monkeypatch):
    """On fake CUDA tensors the wrapper makes one call of the C entry
    ``xent_part_f32`` (x, w, targets, lse, t, scratch, tickets, N, D, V,
    splits, softcap, stream), counted once on ``K6_LAUNCHES`` under its
    own key; a CPU tensor raises before any build or call, and
    ``XentPart`` on CPU tensors runs the plain block form, never the
    kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []

    class Entry:
        def __call__(self, *args):
            calls.append(args)
            return 0

    lib = type("Lib", (), {"xent_part_f32": Entry()})()
    monkeypatch.setattr(xent_kernel.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = xent_kernel.K6_LAUNCHES.count
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        xent_kernel.fused_xent_part(torch.zeros(8, 16), torch.zeros(37, 16),
                                    torch.zeros(8, dtype=torch.int32))
    assert calls == [] and xent_kernel.K6_LAUNCHES.count == before
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        x = torch.empty(300, 16, device="cuda")
        w = torch.empty(37, 16, device="cuda")
        t = torch.empty(300, dtype=torch.int32, device="cuda")
        lse, tt = xent_kernel.fused_xent_part(x, w, t, softcap=30.0, splits=1)
        assert lse.shape == tt.shape == (300,) and lse.device.type == "cuda"
    assert xent_kernel.K6_LAUNCHES.count - before == 1 and len(calls) == 1
    assert xent_kernel.K6_LAUNCHES.by_key[("xent_part_f32", 300, 16, 37, 1, 30.0)] >= 1
    args = calls[0]
    assert len(args) == 13 and all(isinstance(a, ctypes.c_void_p) for a in args[:7])
    assert [a.value for a in args[7:12]] == [300, 16, 37, 1, pytest.approx(30.0)]

    monkeypatch.setattr(xent_kernel, "fused_xent_part",
                        lambda *a, **k: pytest.fail("a CPU tensor reached K6"))
    x, w, t, _ = _inputs(2, 0.0)
    lse, tt = xent_ops.XentPart.apply(torch.as_tensor(x), torch.as_tensor(w[:256]),
                                      torch.as_tensor(t), 0.0)
    want = xent_ref.xent_block_ref(torch.as_tensor(x), torch.as_tensor(w[:256]),
                                   torch.as_tensor(t), 0)
    assert torch.equal(lse, want[0]) and torch.equal(tt, want[1])
    with pytest.raises(ValueError, match="no implementation"):
        xent_ops.XentPart.apply(*(torch.empty(a.shape, device="meta") for a in (x, w)),
                                torch.empty(t.shape, dtype=torch.int32, device="meta"), 0.0)
