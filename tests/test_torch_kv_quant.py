"""The port's int8 KV cache (``kv_dtype="int8"``) against the reference.

The port's counterpart of ``tests/test_kv_quant.py`` (its two tests, same
configs, weights, tokens and tolerances), plus: the int8 cache leaves after
a prefill and two decode steps equal to the reference's, and an ``Engine``
run with the int8 cache giving the reference ``Engine``'s tokens.  The
quantized values are ``round(x / scale)`` of K and V computed by two
programs whose f32 sums differ in the last bits, so a value that lies within
1e-4 of a half step may round the other way: those, and only those, may
differ by one step; the count is printed (``pytest -s``).
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import Model as RefModel
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.models import attention
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, Request, cache_bytes

HALF_STEP_BAND = 1e-4
SCALE_TOL = 1e-5
MAX_SEQ = 32


def _pair(arch, **changes):
    return (dataclasses.replace(ref_base.get_reduced_config(arch), **changes),
            dataclasses.replace(base.get_reduced_config(arch), **changes))


def _port_params(rparams, cfg):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")


def test_int8_kv_decode_close_to_fp():
    """tests/test_kv_quant.py's check on the port: the reduced Llama-3.2-1B
    (bf16 compute) with an int8 and a float cache, prefill logits within
    (0.2, 0.15), argmax agreeing on at least half the rows, the first decode
    step within (0.25, 0.2)."""
    rcfg, cfg = _pair("llama3.2-1b")
    params = _port_params(RefModel(rcfg).init_params(jax.random.PRNGKey(0)), cfg)
    m_fp, m_q = Model(cfg), Model(cfg, kv_dtype="int8")
    B, S = 2, 24
    tokens = torch.as_tensor(np.array(
        jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size)))
    max_seq = S + 4
    cache_fp, logits_fp = m_fp.prefill(params, {"tokens": tokens}, max_seq)
    cache_q, logits_q = m_q.prefill(params, {"tokens": tokens}, max_seq)
    assert cache_q[0]["k"].dtype == torch.int8
    np.testing.assert_allclose(logits_q.numpy(), logits_fp.numpy(), rtol=0.2, atol=0.15)
    assert np.mean(np.argmax(logits_q.numpy(), -1) == np.argmax(logits_fp.numpy(), -1)) >= 0.5
    nxt = torch.argmax(logits_fp, -1)[:, None].to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    ld_fp, _ = m_fp.decode_step(params, cache_fp, nxt, pos, max_seq)
    ld_q, _ = m_q.decode_step(params, cache_q, nxt, pos, max_seq)
    np.testing.assert_allclose(ld_q.numpy(), ld_fp.numpy(), rtol=0.25, atol=0.2)


def test_int8_cache_halves_bytes():
    """The reduced Llama-3-8B's int8 cache for 4 lanes x 256 slots is under
    0.75x the bf16 one, and both are the reference's bytes exactly."""
    rcfg, cfg = _pair("llama3-8b")
    sizes = {}
    for kv in ("compute", "int8"):
        rc = jax.eval_shape(lambda kv=kv: RefModel(rcfg, kv_dtype=kv).init_cache(4, 256))
        want = sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in jax.tree.leaves(rc))
        sizes[kv] = cache_bytes(Model(cfg, kv_dtype=kv).init_cache(4, 256, device="cpu"))
        assert sizes[kv] == want
    assert sizes["int8"] < 0.75 * sizes["compute"]


def _check_int8_leaves(cache, rcache, cfg, floats, counts):
    """Every leaf of every layer: scales at SCALE_TOL, positions equal, int8
    K/V equal but for entries whose unrounded value (the float K/V the
    port quantized, over its scale, from ``floats``) lies within
    HALF_STEP_BAND of a half step, which may be one step off.  Adds to
    ``counts``."""
    P = len(cfg.block_pattern)
    for li, layer in enumerate(cache):
        want = jax.tree.map(lambda a: np.asarray(a)[li // P], rcache[f"g{li % P}"])
        assert sorted(layer) == ["k", "k_scale", "pos", "v", "v_scale"]
        np.testing.assert_array_equal(layer["pos"].numpy(), want["pos"])
        for name, unquantized in zip(("k", "v"), floats[id(layer["k"])]):
            got, ref = layer[name].numpy(), want[name]
            assert got.dtype == ref.dtype == np.int8
            scale = layer[f"{name}_scale"].numpy()
            np.testing.assert_allclose(scale, want[f"{name}_scale"], rtol=SCALE_TOL, atol=0)
            unrounded = unquantized.numpy() / scale[..., None]
            near = np.abs(np.abs(unrounded) % 1 - 0.5) <= HALF_STEP_BAND
            diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
            assert ((diff == 0) | ((diff == 1) & near)).all(), (li, name)
            counts["values"] += diff.size
            counts["near_half_step"] += int(near.sum())
            counts["off_by_one"] += int((diff == 1).sum())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b"])
def test_int8_cache_leaves_match_the_reference(arch, monkeypatch):
    """f32 compute: the int8 K/V, their scales and positions after a prefill
    and after two decode steps (gemma3's local layers keep a ring of 16
    slots, so a 20-token prompt wraps it), and the logits at 1e-4."""
    floats = {}  # id of a cache's int8 k -> the float (k, v) written into it
    write = attention._write_slots

    def recording(cache, index, k, v):
        write(cache, index, k, v)
        kf, vf = floats.setdefault(id(cache["k"]), (torch.zeros(cache["k"].shape),
                                                    torch.zeros(cache["v"].shape)))
        kf[index], vf[index] = k.float(), v.float()

    monkeypatch.setattr(attention, "_write_slots", recording)
    rcfg, cfg = _pair(arch, compute_dtype="float32")
    rmodel = RefModel(rcfg, kv_dtype="int8")
    rparams = rmodel.init_params(jax.random.PRNGKey(0))
    model, params = Model(cfg, kv_dtype="int8"), _port_params(rparams, cfg)
    S = 20
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    rcache, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, MAX_SEQ)
    cache, logits = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=1e-4, atol=1e-4)
    counts = {"values": 0, "off_by_one": 0, "near_half_step": 0}
    _check_int8_leaves(cache, rcache, cfg, floats, counts)
    tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    rdecode = jax.jit(rmodel.decode_step, static_argnums=4)
    for step in range(2):
        pos = np.full(2, S + step, np.int32)
        rlogits, rcache = rdecode(rparams, rcache, jnp.asarray(tok), jnp.asarray(pos),
                                  MAX_SEQ)
        logits, cache = model.decode_step(params, cache, torch.as_tensor(tok),
                                          torch.as_tensor(pos), MAX_SEQ)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=1e-4, atol=1e-4)
        tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    _check_int8_leaves(cache, rcache, cfg, floats, counts)
    assert counts["values"] > 0
    print(f"{arch}: {counts['off_by_one']} of {counts['values']} int8 values one step from "
          f"the reference's; {counts['near_half_step']} within {HALF_STEP_BAND} of a half step")


def test_engine_with_the_int8_cache_matches_the_reference_engine():
    """The reduced Llama-3.2-1B at f32 with ``kv_dtype="int8"`` through both
    engines: the same tokens, stats and plan; the lanes' cache holds the
    scales (``cache_bytes`` counts them, ``_insert_lane`` copied them)."""
    rcfg, cfg = _pair("llama3.2-1b", compute_dtype="float32")
    rmodel = RefModel(rcfg, kv_dtype="int8")
    rparams = rmodel.init_params(jax.random.PRNGKey(6))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (6, 19, 11, 3)]
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    reng = RefEngine(rmodel, rparams, lanes=2, max_seq=MAX_SEQ)
    rstats = reng.run(rreqs)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    eng = Engine(Model(cfg, kv_dtype="int8"), _port_params(rparams, cfg), lanes=2,
                 max_seq=MAX_SEQ, device="cpu")
    stats = eng.run(reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    assert (stats.prefills, stats.decode_steps, stats.tokens_out) == \
        (rstats.prefills, rstats.decode_steps, rstats.tokens_out)
    assert eng.plan_report() == reng.plan_report()
    L, K, h = MAX_SEQ, cfg.num_kv_heads, cfg.head_dim
    per_layer = 2 * (2 * L * K * h + 2 * L * K * 4) + 2 * L * 4  # int8 K/V, scales, pos
    assert cache_bytes(eng.cache) == eng.plan_report()["kv_state_bytes"] == \
        cfg.num_layers * per_layer
    for layer in eng.cache:
        assert layer["k_scale"].dtype == torch.float32
        assert (layer["k_scale"][:, :3] > 1e-6).all() and (layer["v_scale"][:, :3] > 1e-6).all()
