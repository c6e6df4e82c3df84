"""The port's LM serving slice against the reference, on the CPU.

The reference ``Model`` draws its weights; ``lm_params_from_numpy`` carries
them across.  At f32 compute (``dataclasses.replace(compute_dtype=
"float32")``) the port's prefill logits and every cache leaf match the
reference's, with ``attn_impl="ref"`` and ``"flash"`` (Pallas, interpret
mode), and so do 4 decode steps, at rtol = atol = 1e-4.  The port's
``Engine`` emits the reference ``Engine``'s tokens and plan.  One case
runs the configs' own bf16 compute, on logits at 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models.transformer import Model as RefModel
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model, store_compute_dtype
from repro_torch.serve.engine import Engine, Request, cache_bytes
from repro_torch.serve.step import make_decode_step, make_prefill_step

TOL = 1e-4
MAX_SEQ = 32


def _pair(arch, **changes):
    """(reference cfg, port cfg): the reduced config with ``changes``."""
    return (dataclasses.replace(ref_base.get_reduced_config(arch), **changes),
            dataclasses.replace(base.get_reduced_config(arch), **changes))


def _port_params(ref_params, cfg, **kw):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", **kw)


def _layer_leaf(ref_tree, cfg, li):
    """The reference's group-stacked state or params of layer ``li``."""
    P = len(cfg.block_pattern)
    n_groups = cfg.num_layers // P
    if li < n_groups * P:
        return jax.tree.map(lambda a: np.asarray(a)[li // P], ref_tree[f"g{li % P}"])
    return jax.tree.map(np.asarray, ref_tree[f"r{li - n_groups * P}"])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_caches(cache, rcache, cfg):
    assert len(cache) == cfg.num_layers
    for li, layer in enumerate(cache):
        want = _layer_leaf(rcache, cfg, li)
        assert sorted(layer) == sorted(want)
        for key, leaf in layer.items():
            assert tuple(leaf.shape) == want[key].shape, (li, key)
            _close(leaf, want[key])


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b", "gemma3-1b"])
def test_prefill_and_decode_match_the_reference(arch, impl):
    """Logits and every cache leaf after prefill, then 4 greedy decode
    steps.  gemma3's local layers keep a ring of 16 slots, so a 20-token
    prompt wraps it."""
    rcfg, cfg = _pair(arch, compute_dtype="float32")
    rmodel = RefModel(rcfg, attn_impl=impl, rwkv_chunk=8)
    rparams = rmodel.init_params(jax.random.PRNGKey(0))
    model = Model(cfg, rwkv_chunk=8)
    params = _port_params(rparams, cfg)
    S = 20 if arch == "gemma3-1b" else 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)

    rcache, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, MAX_SEQ)
    cache, logits = make_prefill_step(model, MAX_SEQ)(params, {"tokens": torch.as_tensor(tokens)})
    _close(logits, rlogits)
    _check_caches(cache, rcache, cfg)

    decode = make_decode_step(model, MAX_SEQ)
    tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    for step in range(4):
        pos = np.array([S + step, S + step], np.int32)
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(tok),
                                             jnp.asarray(pos), MAX_SEQ)
        nxt, logits, cache = decode(params, cache, torch.as_tensor(tok), torch.as_tensor(pos))
        _close(logits, rlogits)
        tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
        assert np.array_equal(nxt.numpy(), tok)
    _check_caches(cache, rcache, cfg)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b"])
def test_bf16_compute_logits(arch):
    """The configs' own dtypes (f32 params, bf16 compute), weights stored
    once in bf16: logits at 5e-2."""
    rcfg, cfg = _pair(arch)
    assert cfg.compute_dtype == "bfloat16"
    rmodel = RefModel(rcfg, rwkv_chunk=8)
    rparams = rmodel.init_params(jax.random.PRNGKey(2))
    model = Model(cfg, rwkv_chunk=8)
    params = _port_params(rparams, cfg, compute_dtype="bfloat16")
    assert params["layers"][0]["norm1"]["scale"].dtype == torch.float32
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    _, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, MAX_SEQ)
    _, logits = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, MAX_SEQ)
    _close(logits, rlogits, 5e-2)


def test_store_compute_dtype_keeps_the_f32_leaves_and_the_function():
    rcfg, cfg = _pair("rwkv6-7b", compute_dtype="float32")
    rparams = RefModel(rcfg).init_params(jax.random.PRNGKey(4))
    model = Model(cfg, rwkv_chunk=8)
    params = _port_params(rparams, cfg)
    tokens = torch.as_tensor(np.arange(10, dtype=np.int32)[None])
    _, want = model.prefill(params, {"tokens": tokens}, MAX_SEQ)
    store_compute_dtype(params, torch.float64)
    tm = params["layers"][0]["tm"]
    assert tm["wr"].dtype == torch.float64 and params["embed"].dtype == torch.float64
    assert all(tm[k].dtype == torch.float32 for k in ("decay_base", "bonus_u", "gn_scale"))
    _, got = model.prefill(params, {"tokens": tokens}, MAX_SEQ)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _tiny_cfgs():
    """The reference engine tests' model (tests/test_substrate.py)."""
    kw = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128,
              block_pattern=("attn",), mlp_act="swiglu", norm="rmsnorm",
              tie_embeddings=True)
    return RefModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("seed,lanes", [(0, 2), (1, 1)])
def test_engine_matches_the_reference_engine(seed, lanes):
    """TestEngine's requests (5 prompts of 5 + 3i tokens, 4 new each):
    the same out-tokens, stats and plan as the reference's Engine."""
    rcfg, cfg = _tiny_cfgs()
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 5 + 3 * i).astype(np.int32) for i in range(5)]
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    reng = RefEngine(rmodel, rparams, lanes=lanes, max_seq=64)
    rstats = reng.run(rreqs)

    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    eng = Engine(Model(cfg), _port_params(rparams, cfg), lanes=lanes, max_seq=64,
                 device="cpu")
    stats = eng.run(reqs)
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    assert (stats.prefills, stats.decode_steps, stats.tokens_out) == \
        (rstats.prefills, rstats.decode_steps, rstats.tokens_out)
    assert eng.plan_report() == reng.plan_report()
    assert cache_bytes(eng.cache) == eng.plan_report()["kv_state_bytes"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b"])
def test_plan_report_matches_the_reference(arch):
    rcfg, cfg = _pair(arch)
    rmodel = RefModel(rcfg)
    reng = RefEngine(rmodel, rmodel.init_params(jax.random.PRNGKey(0)), lanes=3,
                     max_seq=40)
    model = Model(cfg)
    eng = Engine(model, model.init_params(torch.Generator().manual_seed(0), device="cpu"),
                 lanes=3, max_seq=40, device="cpu")
    assert eng.plan_report() == reng.plan_report()


def test_engine_refuses_a_request_longer_than_its_cache():
    _, cfg = _tiny_cfgs()
    model = Model(cfg)
    eng = Engine(model, model.init_params(torch.Generator().manual_seed(0), device="cpu"),
                 lanes=1, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq=8"):
        eng.run([Request(rid=0, prompt=np.zeros(6, np.int32), max_new_tokens=3)])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x7b",
                                  "seamless-m4t-large-v2", "qwen2-vl-7b"])
def test_families_not_ported_yet_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(base.get_reduced_config(arch))
    with pytest.raises(NotImplementedError, match="int8"):
        Model(base.get_reduced_config("llama3.2-1b"), kv_dtype="int8")
