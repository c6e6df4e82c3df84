"""Qwen2-VL-7B on the port — M-RoPE and the vision-embeds path — against the
reference, on the CPU.

* ``apply_mrope`` equals the reference's with three distinct seeded
  position streams (the (t, h, w) sections each rotated by its own) at
  1e-6, and in text mode (three equal streams) it equals ``apply_rope`` bit
  for bit: the port's counterpart of
  ``test_models_units.py::test_mrope_text_mode_equals_rope``.
* The reduced config (2 layers, d 64, GQA 2:1, q/k/v bias, M-RoPE sections
  (2, 3, 3)) at f32 compute: prefill from tokens and from ``embeds``, then
  4 greedy decode steps on tokens, with ``attn_impl="ref"`` and
  ``"flash"`` (Pallas, interpret mode) on the reference side: logits and
  every cache leaf at rtol = atol = 1e-4.
* The port's ``Engine`` emits the reference ``Engine``'s tokens (the text
  decoder, as both serve it).  ``convert`` carries the params across and
  back bit for bit.
* The vision batch ``{"embeds", "targets"}`` (no tokens) trains: two
  ``make_train_step`` steps with 1 and 2 microbatches equal the
  reference's; after one AdamW step ``params["embed"]``, whose gradient is
  zero, is the reference's, decayed and nothing else.
* ``launch.serve`` and ``launch.train`` run Qwen2-VL with ``--device cpu``;
  at full size one lane's KV state is the config's.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import common as ref_common
from repro.models.transformer import Model as RefModel
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.train import optimizer as ref_opt
from repro.train.step import TrainStepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, Request, cache_bytes
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, make_train_step, value_and_grad

ARCH = "qwen2-vl-7b"
TOL = 1e-4
MAX_SEQ = 32
ADAMW = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


def _pair(**changes):
    changes = {"compute_dtype": "float32", **changes}
    return (dataclasses.replace(ref_base.get_reduced_config(ARCH), **changes),
            dataclasses.replace(base.get_reduced_config(ARCH), **changes))


def _port_params(rparams, cfg):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------- M-RoPE
MROPE_CASES = [((2, 7, 3, 16), (2, 3, 3), 1e6),  # the reduced config's sections
               ((1, 5, 2, 128), (16, 24, 24), 1e6),  # Qwen2-VL-7B's head and sections
               ((2, 4, 4, 32), (8, 4, 4), 1e4)]


@pytest.mark.parametrize("shape,sections,theta", MROPE_CASES)
def test_apply_mrope_matches_the_reference_with_distinct_streams(shape, sections, theta):
    B, S = shape[:2]
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, B, S)).astype(np.int32)
    assert not (np.array_equal(pos3[0], pos3[1]) or np.array_equal(pos3[1], pos3[2]))
    want = jax.jit(ref_common.apply_mrope, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(pos3), theta, sections)
    got = apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # each section follows its own stream: moving one stream moves only its bands
    pos3[1] += 1
    moved = apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), theta, sections)
    h = shape[-1] // 2
    bands = [i for i in range(h) if sections[0] <= i < sections[0] + sections[1]]
    changed = (moved != got).reshape(-1, 2 * h).any(dim=0).numpy()
    assert set(np.flatnonzero(changed[:h])) <= set(bands)


@pytest.mark.parametrize("theta,sections", [(10_000.0, (3, 3, 2)), (1e6, (16, 24, 24))])
def test_mrope_text_mode_equals_rope(theta, sections):
    h = 2 * sum(sections)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((1, 6, 2, h)),
                        dtype=torch.float32)
    pos = torch.arange(6, dtype=torch.int32)[None]
    y1 = apply_rope(x, pos, theta)
    y2 = apply_mrope(x, pos[None].expand(3, 1, 6), theta, sections)
    assert torch.equal(y1, y2)


# ------------------------------------------------------------------- serving
def _check_caches(cache, rcache, cfg):
    assert len(cache) == cfg.num_layers
    for li, layer in enumerate(cache):
        want = jax.tree.map(lambda a: np.asarray(a)[li], rcache["g0"])
        assert sorted(layer) == sorted(want)
        for key, leaf in layer.items():
            assert leaf.dtype == getattr(torch, str(want[key].dtype)), (li, key)
            _close(leaf, want[key])


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("source", ["tokens", "embeds"])
def test_prefill_and_decode_match_the_reference(source, impl):
    """A 20-token (or 20-row) prompt, then 4 greedy steps that embed their
    tokens through ``params["embed"]`` (reference ``transformer.py:457``)."""
    rcfg, cfg = _pair()
    rmodel = RefModel(rcfg, attn_impl=impl)
    rparams = rmodel.init_params(jax.random.PRNGKey(0))
    model = Model(cfg)
    params = _port_params(rparams, cfg)
    B, S = 2, 20
    rng = np.random.default_rng(1)
    if source == "tokens":
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    else:
        batch = {"embeds": (rng.standard_normal((B, S, cfg.d_model))
                            / np.sqrt(cfg.d_model)).astype(np.float32)}
    rcache, rlogits = jax.jit(lambda p, b: rmodel.prefill(p, b, MAX_SEQ))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cache, logits = make_prefill_step(model, MAX_SEQ)(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(logits, rlogits)
    _check_caches(cache, rcache, cfg)

    rdecode = jax.jit(lambda p, c, t, pos: rmodel.decode_step(p, c, t, pos, MAX_SEQ))
    decode = make_decode_step(model, MAX_SEQ)
    tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    for step in range(4):
        pos = np.full(B, S + step, np.int32)
        rlogits, rcache = rdecode(rparams, rcache, jnp.asarray(tok), jnp.asarray(pos))
        nxt, logits, cache = decode(params, cache, torch.as_tensor(tok), torch.as_tensor(pos))
        _close(logits, rlogits)
        tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
        assert np.array_equal(nxt.numpy(), tok)
    _check_caches(cache, rcache, cfg)


def test_engine_matches_the_reference_engine():
    """4 prompts of 6-22 tokens, 5 new each, 2 lanes: the same tokens, stats
    and plan."""
    rcfg, cfg = _pair()
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.PRNGKey(6))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (6, 22, 11, 17)]
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    reng = RefEngine(rmodel, rparams, lanes=2, max_seq=40)
    rstats = reng.run(rreqs)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    eng = Engine(Model(cfg), _port_params(rparams, cfg), lanes=2, max_seq=40, device="cpu")
    stats = eng.run(reqs)
    assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    assert (stats.prefills, stats.decode_steps, stats.tokens_out) == \
        (rstats.prefills, rstats.decode_steps, rstats.tokens_out)
    assert eng.plan_report() == reng.plan_report()
    assert cache_bytes(eng.cache) == eng.plan_report()["kv_state_bytes"]


def test_params_round_trip():
    """The reference's params (``attn/b{q,k,v}`` among them) into the port
    and back, bit for bit."""
    rcfg, cfg = _pair(compute_dtype="bfloat16")
    rparams = jax.tree.map(np.asarray, RefModel(rcfg).init_params(jax.random.PRNGKey(5)))
    back = convert.lm_params_to_numpy(_port_params(rparams, cfg), cfg)
    flat = jax.tree_util.tree_leaves_with_path(rparams)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    assert {"bq", "bk", "bv"} <= set(back["g0"]["attn"])


def test_full_size_constructs_and_its_kv_state_is_the_configs():
    """``Model(get_config("qwen2-vl-7b"))`` constructs; 4 lanes at
    ``max_seq`` 1,024 hold 28 layers x (K/V 2 x 4 x 1,024 x 4 x 128 bf16 +
    int32 positions) = 235,339,776 B (laid out on the meta device)."""
    model = Model(base.get_config(ARCH))
    meta = torch.device("meta")
    state = [model._block_state(kind, 4, 1024, meta) for kind in model.cfg.blocks()]
    assert cache_bytes(state) == 235_339_776
    assert state[0]["k"].shape == (4, 1024, 4, 128) and state[0]["k"].dtype == torch.bfloat16


# ------------------------------------------------------------------- training
def _vision_batch(cfg, step):
    """The launchers' stand-in for the frontend: the one-hot of each token id
    modulo d_model, and no tokens."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    embeds = np.eye(cfg.d_model, dtype=np.float32)[toks[:, :-1] % cfg.d_model]
    return {"embeds": embeds, "targets": toks[:, 1:]}


@pytest.mark.parametrize("micro", [1, 2])
def test_vision_train_steps_match_the_reference(micro):
    """Two steps on ``{"embeds", "targets"}`` batches of 4: the metrics and
    then every param equal the reference's (the microbatch split reads
    ``targets``, there being no ``tokens``)."""
    rcfg, cfg = _pair()
    rmodel = RefModel(rcfg, xent_impl="seq_chunked", xent_seq_chunk=8)
    model = Model(cfg, xent_impl="seq_chunked", xent_seq_chunk=8)
    rparams = rmodel.init_params(jax.random.PRNGKey(7))
    params = _port_params(rparams, cfg)
    rstep = jax.jit(ref_make_train_step(rmodel, RefStepConfig(
        microbatches=micro, adamw=ref_opt.AdamWConfig(**ADAMW))))
    step = make_train_step(model, TrainStepConfig(microbatches=micro,
                                                  adamw=opt.AdamWConfig(**ADAMW)))
    rstate, state = ref_opt.init_state(rparams), opt.init_state(params)
    for s in range(2):
        batch = _vision_batch(cfg, s)
        assert "tokens" not in batch
        rparams, rstate, rm = rstep(rparams, rstate, {k: jnp.asarray(v)
                                                      for k, v in batch.items()})
        params, state, m = step(params, state, {k: torch.as_tensor(v)
                                                for k, v in batch.items()})
        assert sorted(m) == sorted(rm)
        for key in rm:
            np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {s + 1} {key}")
    got = convert.lm_params_to_numpy(params, cfg)
    for path, want in jax.tree_util.tree_leaves_with_path(rparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_adamw_decays_the_unused_embedding_like_the_reference():
    """An embeds batch never reads ``params["embed"]``: its gradient is zero
    (``materialize_grads``), and one AdamW step only decays it (ndim 2,
    reference ``optimizer.py:82``), to the reference's values."""
    rcfg, cfg = _pair()
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.PRNGKey(8))
    params = _port_params(rparams, cfg)
    batch = _vision_batch(cfg, 0)
    model = Model(cfg)
    _, _, grads = value_and_grad(model, params, {k: torch.as_tensor(v)
                                                 for k, v in batch.items()})
    assert grads["embed"].shape == params["embed"].shape
    assert not bool(grads["embed"].any()) and bool(grads["unembed"].any())
    acfg = opt.AdamWConfig(**ADAMW)
    embed0 = params["embed"].clone()
    params, _, m = opt.apply_adamw(acfg, params, grads, opt.init_state(params),
                                   decay_mask=opt.decay_mask_like_reference(cfg, params))
    rgrads = jax.jit(jax.grad(lambda p, b: rmodel.train_loss(p, b)[0]))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert not np.asarray(rgrads["embed"]).any()
    rparams, _, _ = jax.jit(ref_opt.apply_adamw, static_argnums=0)(
        ref_opt.AdamWConfig(**ADAMW), rparams, rgrads, ref_opt.init_state(rparams))
    _close(params["embed"], rparams["embed"], 1e-6)
    decayed = embed0 * (1 - float(m["lr"]) * acfg.weight_decay)
    torch.testing.assert_close(params["embed"], decayed, rtol=1e-6, atol=1e-7)
    assert not torch.equal(params["embed"], embed0)


# ------------------------------------------------------------------- launchers
def test_launch_serve_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--requests", "3", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serves its text decoder" in out and "served 3 requests" in out


def test_launch_train_on_cpu_trains_on_embeds(tmp_path, capsys):
    state = launch_train.main(["--arch", ARCH, "--steps", "2", "--batch", "4", "--seq", "16",
                               "--microbatches", "2", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)])
    assert state.step == 2
    out = capsys.readouterr().out
    assert "[loop] step 2:" in out and "loss=" in out
