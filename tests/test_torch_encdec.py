"""The port's encoder-decoder (Seamless-M4T-large-v2) against the reference,
on the CPU.

The reference ``Model`` draws the reduced config's weights (2 encoder and 2
decoder layers, d 64, f32 compute); ``lm_params_from_numpy`` carries them
across, ``enc_g0`` into ``enc_layers``.  With ``attn_impl="ref"`` and
``"flash"`` (Pallas in interpret mode) the port's encoder memory, prefill
logits, every cache leaf and 4 greedy decode steps with ``memory=`` match
at rtol = atol = 1e-5, and ``train_loss`` and its gradients at 1e-5 / 1e-4.
The gradient test pins the reference's quirk of a loss read without the
final norm.  The port runs the encoder and the cross-attention through K5's
plain version with ``causal=False``, the reference through ``_sdpa_ref``
with no mask: the same function, held here at S != T.  ``Engine`` serves
the decoder alone, as the reference's does.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import attention as ref_attention
from repro.models.transformer import Model as RefModel
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, Request, cache_bytes
from repro_torch.serve.step import make_decode_step
from repro_torch.train import optimizer as opt
from repro_torch.train.step import value_and_grad

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
GRAD_TOL = 1e-4
MAX_SEQ = 32
B, T, S = 2, 24, 12  # lanes, source frames, prompt tokens


def _pair(**changes):
    changes = {"compute_dtype": "float32", **changes}
    return (dataclasses.replace(ref_base.get_reduced_config(ARCH), **changes),
            dataclasses.replace(base.get_reduced_config(ARCH), **changes))


@pytest.fixture(scope="module", params=["ref", "flash"])
def models(request):
    """(reference model, its params, port model, port params, inputs)."""
    rcfg, cfg = _pair()
    rmodel = RefModel(rcfg, attn_impl=request.param)
    rparams = rmodel.init_params(jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg,
                                          device="cpu")
    rng = np.random.default_rng(1)
    inputs = {"src_embeds": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
              "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
              "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    return rmodel, rparams, Model(cfg), params, inputs


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_caches(cache, rcache, cfg):
    assert len(cache) == cfg.num_layers
    for li, layer in enumerate(cache):
        want = jax.tree.map(lambda a: np.asarray(a)[li], rcache["g0"])
        assert sorted(layer) == sorted(want)
        for key, leaf in layer.items():
            assert leaf.dtype == getattr(torch, str(want[key].dtype)), (li, key)
            _close(leaf, want[key])


def test_encode_matches_the_reference(models):
    rmodel, rparams, model, params, inputs = models
    rmem = rmodel.encode(rparams, jnp.asarray(inputs["src_embeds"]))
    mem = model.encode(params, torch.as_tensor(inputs["src_embeds"]))
    assert tuple(mem.shape) == (B, T, model.cfg.d_model)
    _close(mem, rmem)


@pytest.mark.parametrize("source", ["memory", "src_embeds"])
def test_prefill_matches_the_reference(models, source):
    """Logits and every cache leaf, the memory passed in or encoded from
    ``batch["src_embeds"]``."""
    rmodel, rparams, model, params, inputs = models
    tokens = inputs["tokens"]
    if source == "memory":
        rmem = rmodel.encode(rparams, jnp.asarray(inputs["src_embeds"]))
        rcache, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, MAX_SEQ,
                                         memory=rmem)
        mem = model.encode(params, torch.as_tensor(inputs["src_embeds"]))
        cache, logits = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, MAX_SEQ,
                                      memory=mem)
    else:
        batch = {k: inputs[k] for k in ("src_embeds", "tokens")}
        rcache, rlogits = rmodel.prefill(rparams, jax.tree.map(jnp.asarray, batch), MAX_SEQ)
        cache, logits = model.prefill(params, {k: torch.as_tensor(v) for k, v in batch.items()},
                                      MAX_SEQ)
    _close(logits, rlogits)
    _check_caches(cache, rcache, model.cfg)


def test_decode_steps_with_memory_match_the_reference(models):
    """4 greedy steps of ``make_decode_step`` with ``memory``: logits,
    tokens and the caches after them."""
    rmodel, rparams, model, params, inputs = models
    rmem = rmodel.encode(rparams, jnp.asarray(inputs["src_embeds"]))
    mem = model.encode(params, torch.as_tensor(inputs["src_embeds"]))
    tokens = inputs["tokens"]
    rcache, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, MAX_SEQ,
                                     memory=rmem)
    cache, _ = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, MAX_SEQ, memory=mem)
    decode = make_decode_step(model, MAX_SEQ)
    rdecode = jax.jit(rmodel.decode_step, static_argnums=4)
    tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    for step in range(4):
        pos = np.full(B, S + step, np.int32)
        rlogits, rcache = rdecode(rparams, rcache, jnp.asarray(tok), jnp.asarray(pos),
                                  MAX_SEQ, memory=rmem)
        nxt, logits, cache = decode(params, cache, torch.as_tensor(tok), torch.as_tensor(pos),
                                    mem)
        _close(logits, rlogits)
        tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
        assert np.array_equal(nxt.numpy(), tok)
    _check_caches(cache, rcache, model.cfg)


def test_train_loss_and_gradients_match_the_reference(models):
    """The enc-dec loss (decoder output without the final norm, remat on
    both stacks) and every gradient leaf, encoder and cross-attention
    included."""
    rmodel, rparams, model, params, inputs = models
    assert model.remat
    rbatch = jax.tree.map(jnp.asarray, inputs)
    rloss, rgrads = jax.jit(jax.value_and_grad(lambda p: rmodel.train_loss(p, rbatch)[0]))(
        rparams)
    loss, _, grads = value_and_grad(model, params,
                                    {k: torch.as_tensor(v) for k, v in inputs.items()})
    np.testing.assert_allclose(float(loss), float(rloss), rtol=TOL, atol=TOL)
    back = convert.lm_params_to_numpy(grads, model.cfg)
    flat = jax.tree_util.tree_leaves_with_path(rgrads)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(back["enc_g0"]["attn"]["wq"]).max() > 0
    assert np.abs(back["g0"]["cross"]["wk"]).max() > 0


def test_params_round_trip_and_checkpoint(tmp_path):
    """``enc_g0`` into ``enc_layers`` and back, and the decoder's
    ``norm_x`` / ``cross`` leaves, bit for bit; cross-attention has no
    q/k/v bias even under ``attn_bias``; a checkpoint saves and restores
    the enc-dec params exactly."""
    rcfg, cfg = _pair(attn_bias=True)
    rparams = jax.tree.map(np.asarray, RefModel(rcfg).init_params(jax.random.PRNGKey(2)))
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    assert len(params["enc_layers"]) == cfg.encoder_layers
    assert {"norm_x", "cross"} <= set(params["layers"][0])
    assert set(params["layers"][0]["cross"]) == {"wq", "wk", "wv", "wo"}
    assert "bq" in params["layers"][0]["attn"] and "cross" not in params["enc_layers"][0]
    back = convert.lm_params_to_numpy(params, cfg)
    flat = jax.tree_util.tree_leaves_with_path(rparams)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    own = Model(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(convert.lm_params_to_numpy(own, cfg)) == jax.tree.structure(back)
    ckpt.save(tmp_path, 3, params)
    step, restored = ckpt.restore(tmp_path, own)
    assert step == 3
    for a, b in zip(jax.tree.leaves(convert.lm_params_to_numpy(restored, cfg)),
                    jax.tree.leaves(back)):
        assert np.array_equal(a, b)


def test_adamw_decays_the_encoder_like_the_reference():
    """The reference stacks the encoder in ``enc_g0``, so its default mask
    decays every encoder leaf, norms included; one AdamW step on equal
    params and grads matches."""
    rcfg, cfg = _pair()
    rparams = jax.tree.map(np.asarray, RefModel(rcfg).init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    grads_np = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), rparams)
    acfg = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10)
    want, _, _ = jax.jit(ref_opt.apply_adamw, static_argnums=0)(
        ref_opt.AdamWConfig(**acfg), rparams, grads_np, ref_opt.init_state(rparams))
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    mask = opt.decay_mask_like_reference(cfg, params)
    assert mask["enc_layers"][0]["norm1"]["scale"] is True
    params, _, _ = opt.apply_adamw(opt.AdamWConfig(**acfg), params,
                                   convert.lm_params_from_numpy(grads_np, cfg, device="cpu"),
                                   opt.init_state(params), decay_mask=mask)
    got = convert.lm_params_to_numpy(params, cfg)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("shape", [(2, 8, 4, 4, 16, 24), (1, 5, 6, 2, 16, 37),
                                   (2, 1, 4, 1, 32, 19)])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_k5_plain_version_non_causal_matches_sdpa_ref(shape, softcap):
    """K5's plain version with ``causal=False`` at S != T (GQA, a softcap)
    against the reference's ``_sdpa_ref`` with ``mask=None``, the function
    the reference's encoder and cross-attention compute."""
    Bq, Sq, H, K, h, Tk = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((Bq, Sq, H, h)).astype(np.float32)
    k = rng.standard_normal((Bq, Tk, K, h)).astype(np.float32)
    v = rng.standard_normal((Bq, Tk, K, h)).astype(np.float32)
    want = ref_attention._sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                   h ** -0.5, softcap)
    got = attention_ref(*map(torch.as_tensor, (q, k, v)), causal=False, scale=h ** -0.5,
                        softcap=softcap)
    _close(got, want)


def test_engine_serves_the_decoder_like_the_reference():
    """``Engine`` has no memory argument: both serve the text decoder alone
    (the cross sub-blocks skipped) with the same tokens, stats and plan."""
    rcfg, cfg = _pair()
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3)]
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    rstats = RefEngine(rmodel, rparams, lanes=2, max_seq=MAX_SEQ).run(rreqs)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    eng = Engine(Model(cfg), convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams),
                                                          cfg, device="cpu"),
                 lanes=2, max_seq=MAX_SEQ, device="cpu")
    stats = eng.run(reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    assert (stats.prefills, stats.decode_steps, stats.tokens_out) == \
        (rstats.prefills, rstats.decode_steps, rstats.tokens_out)
    assert cache_bytes(eng.cache) == eng.plan_report()["kv_state_bytes"]


def test_encoder_and_cross_attention_go_through_k5(monkeypatch):
    """An enc-dec encode + prefill calls ``flash_attention`` once a layer
    and stack (reduced config, CPU, counted): the encoder's and the
    cross-attention's without the causal mask, the decoder's with it; a
    decode step never.  A CUDA call at Seamless-M4T's full cross-attention
    shape (S 16 over T 1,000 frames) goes to K5's wrapper, which reaches
    the kernel's build (no nvcc here: a stand-in raises there), never the
    plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    _, cfg = _pair()
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    calls = []
    attend = flash_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    memory = model.encode(params, torch.zeros(1, 20, cfg.d_model))
    cache, _ = model.prefill(params, {"tokens": torch.zeros((1, 6), dtype=torch.int32)}, 16,
                             memory=memory)
    assert sorted(calls) == sorted([(20, 20, False)] * cfg.encoder_layers
                                   + [(6, 6, True), (6, 20, False)] * cfg.num_layers)
    model.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.int32), 6, 16,
                      memory=memory)
    assert len(calls) == cfg.encoder_layers + 2 * cfg.num_layers

    def reached(name):
        raise RuntimeError(f"reached the build of {name}")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(build, "load", reached)
    monkeypatch.setattr(flash_ref, "attention_ref", forbidden)
    with FakeTensorMode():
        q = torch.empty(4, 16, 16, 64, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(4, 1000, 16, 64, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="reached the build of flash_fwd"):
            attend(q, kv, kv, causal=False)
