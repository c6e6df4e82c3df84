"""The port's LM serving slice against the reference, on the CPU.

The reference ``Model`` draws its weights; ``lm_params_from_numpy`` carries
them across.  At f32 compute (``dataclasses.replace(compute_dtype=
"float32")``) the port's prefill logits and every cache leaf match the
reference's, with ``attn_impl="ref"`` and ``"flash"`` (Pallas, interpret
mode), and so do 4 decode steps, at rtol = atol = 1e-4 (1e-5 for the
Griffin and MoE families: RecurrentGemma, Qwen2-MoE, Mixtral); Llama-3-8B
and Nemotron-4-15B (the one ``relu2`` MLP in an attention block) among
them.  Those two, Seamless-M4T, the Griffin and MoE families and
Qwen2-VL (from ``embeds``) also pass the port's counterparts of
``tests/test_arch_smoke.py``: a finite loss and finite gradients, and
decode equal to the full forward.  The port's
``Engine`` emits the reference ``Engine``'s tokens and plan, also on the
reduced gemma3 widened to Gemma3-1B's attention geometry (4 query heads
over one KV head of 256), its rings of 16 slots overrun and wrapped.  One case
runs the configs' own bf16 compute, on logits at 5e-2.  The Griffin and
MoE families keep their f32-read leaves in f32 under
``store_compute_dtype`` and carry their params across and back bit for
bit; ``tests/test_torch_train_families.py`` trains them.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
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
from repro_torch.models import moe
from repro_torch.models.common import apply_norm
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.step import value_and_grad
from repro_torch.tree import flatten_with_paths, leaves

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


def _check_caches(cache, rcache, cfg, tol=TOL):
    assert len(cache) == cfg.num_layers
    for li, layer in enumerate(cache):
        want = _layer_leaf(rcache, cfg, li)
        assert sorted(layer) == sorted(want)
        for key, leaf in layer.items():
            assert tuple(leaf.shape) == want[key].shape, (li, key)
            assert leaf.dtype == getattr(torch, str(want[key].dtype)), (li, key)
            _close(leaf, want[key], tol)


# The families ported with the Griffin block and MoE, held at 1e-5 (f32);
# their windowed layers keep a ring of 16 slots (reduced configs).
NEW_FAMILIES = ("recurrentgemma-9b", "qwen2-moe-a2.7b", "mixtral-8x7b")


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b", "gemma3-1b", *NEW_FAMILIES,
                                  "llama3-8b", "nemotron-4-15b"])
def test_prefill_and_decode_match_the_reference(arch, impl):
    """Logits and every cache leaf after prefill, then 4 greedy decode
    steps.  gemma3's, RecurrentGemma's and Mixtral's local layers keep a
    ring of 16 slots, so a 20-token prompt wraps it."""
    tol = 1e-5 if arch in NEW_FAMILIES else TOL
    rcfg, cfg = _pair(arch, compute_dtype="float32")
    rmodel = RefModel(rcfg, attn_impl=impl, rwkv_chunk=8)
    rparams = rmodel.init_params(jax.random.PRNGKey(0))
    model = Model(cfg, rwkv_chunk=8)
    params = _port_params(rparams, cfg)
    S = 16 if arch in ("llama3.2-1b", "rwkv6-7b") else 20
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)

    rcache, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, MAX_SEQ)
    cache, logits = make_prefill_step(model, MAX_SEQ)(params, {"tokens": torch.as_tensor(tokens)})
    _close(logits, rlogits, tol)
    _check_caches(cache, rcache, cfg, tol)

    decode = make_decode_step(model, MAX_SEQ)
    tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    for step in range(4):
        pos = np.array([S + step, S + step], np.int32)
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(tok),
                                             jnp.asarray(pos), MAX_SEQ)
        nxt, logits, cache = decode(params, cache, torch.as_tensor(tok), torch.as_tensor(pos))
        _close(logits, rlogits, tol)
        tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
        assert np.array_equal(nxt.numpy(), tok)
    _check_caches(cache, rcache, cfg, tol)


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


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "seamless-m4t-large-v2",
                                  "recurrentgemma-9b", "rwkv6-7b"])
def test_init_params_store_dtype_equals_storing_afterwards(arch):
    """``init_params(store_dtype=)`` (each layer stored as it is drawn)
    gives bit for bit the tree of ``init_params`` followed by
    ``store_compute_dtype``: the same draws, the same f32 leaves kept, the
    same dtypes, the untied unembedding and enc-dec's encoder included."""
    model = Model(base.get_reduced_config(arch), rwkv_chunk=8)
    want = store_compute_dtype(
        model.init_params(torch.Generator().manual_seed(5), device="cpu"), torch.bfloat16)
    got = model.init_params(torch.Generator().manual_seed(5), device="cpu",
                            store_dtype=torch.bfloat16)
    flat_w, flat_g = flatten_with_paths(want), flatten_with_paths(got)
    assert [path for path, _ in flat_g] == [path for path, _ in flat_w]
    assert {a.dtype for _, a in flat_g} == {torch.bfloat16, torch.float32}
    for (path, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b), path


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


# The reduced Gemma3-1B widened to its full attention geometry: 4 query
# heads over one KV head of 256 (its reduced window of 16 kept), f32
GEMMA_WIDE = dict(num_heads=4, num_kv_heads=1, head_dim=256, compute_dtype="float32")


def test_gemma3_attention_geometry_rings_match_the_reference():
    """Gemma3-1B's attention geometry at the reduced width: a prompt of 40
    overruns the local layers' rings of 16 slots, then 8 greedy decode
    steps wrap them again; the prefill's and every step's logits and every
    cache leaf within 1e-4 of the reference's.  Then both engines, 2 lanes,
    ``max_seq`` 64, 8 new tokens to prompts of 40, 12 (its ring wraps in
    decode), 16 and 17 (the prefill fills it, overruns it): the same
    tokens, stats and plan."""
    rcfg, cfg = _pair("gemma3-1b", **GEMMA_WIDE)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.PRNGKey(8))
    params = _port_params(rparams, cfg)
    model = Model(cfg)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    rcache, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens)}, 64)
    cache, logits = make_prefill_step(model, 64)(params, {"tokens": torch.as_tensor(tokens)})
    _close(logits, rlogits)
    _check_caches(cache, rcache, cfg)
    decode = make_decode_step(model, 64)
    tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    for step in range(8):
        pos = np.array([40 + step], np.int32)
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(tok),
                                             jnp.asarray(pos), 64)
        _, logits, cache = decode(params, cache, torch.as_tensor(tok), torch.as_tensor(pos))
        _close(logits, rlogits)
        tok = np.argmax(np.asarray(rlogits), -1)[:, None].astype(np.int32)
    _check_caches(cache, rcache, cfg)
    assert sorted(cache[0]["pos"][0].tolist()) == list(range(32, 48))  # the ring wrapped

    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 12, 16, 17)]
    rreqs = [RefRequest(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    reng = RefEngine(rmodel, rparams, lanes=2, max_seq=64)
    rstats = reng.run(rreqs)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    eng = Engine(model, params, lanes=2, max_seq=64, device="cpu")
    stats = eng.run(reqs)
    assert all(r.done and len(r.out_tokens) == 8 for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in rreqs]
    assert (stats.prefills, stats.decode_steps, stats.tokens_out) == \
        (rstats.prefills, rstats.decode_steps, rstats.tokens_out)
    assert eng.plan_report() == reng.plan_report()
    assert cache_bytes(eng.cache) == eng.plan_report()["kv_state_bytes"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b", "recurrentgemma-9b",
                                  "qwen2-moe-a2.7b"])
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


def test_unknown_kv_dtype_raises():
    with pytest.raises(ValueError, match="kv_dtype"):
        Model(base.get_reduced_config("llama3.2-1b"), kv_dtype="int4")


SMOKE_B, SMOKE_S = 2, 32  # tests/test_arch_smoke.py's batch


def _smoke_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (SMOKE_B, SMOKE_S)),
                                dtype=torch.int32) for k in ("tokens", "targets")}
    embeds = torch.as_tensor(rng.standard_normal((SMOKE_B, SMOKE_S, cfg.d_model)),
                             dtype=torch.float32)
    if cfg.is_encdec:
        batch["src_embeds"] = embeds
    if cfg.frontend == "vision":  # the reference's vision batch has no tokens
        batch = {"embeds": embeds, "targets": batch["targets"]}
    return batch


@pytest.mark.parametrize("check", ["loss_and_grads", "decode_vs_full_forward"])
@pytest.mark.parametrize("arch", ["llama3-8b", "nemotron-4-15b", "seamless-m4t-large-v2",
                                  *NEW_FAMILIES, "qwen2-vl-7b"])
def test_arch_smoke_counterparts(arch, check, monkeypatch):
    """tests/test_arch_smoke.py's checks on the port, reduced config: at its
    own bf16 compute, a finite scalar loss and a finite gradient on every
    leaf; or, at f32 compute, the prefill's logits and one decode step's
    through the cache equal at 1e-4 to the full forward (the layer stack
    with no cache) over the prompt and over the prompt and the token.  The
    reference test compares at bf16 within 2e-2; the port's prefill keeps
    K5's softmax weights in f32 where decode attention rounds them to the
    compute dtype, so at bf16 the two differ by a bf16 rounding (one logit
    in 512 by 0.032 on Llama-3-8B), and at f32 they compute one function.
    Qwen2-VL prefills from ``embeds`` and decodes a token, so its full
    forward runs over the embeds and that token's embedding.  The MoE
    layers drop a (token, expert) choice past an expert's capacity, counted
    in the group's order (24 slots at 32 or 33 tokens: these prompts drop
    some), and a decode step's single token (8 slots) never, so decode is
    the full forward's function only where the full forward drops nothing:
    for the MoE families the prefill is held at the real capacity, then
    both again with the capacity lifted to a group's token count."""
    cfg = base.get_reduced_config(arch)
    if check == "decode_vs_full_forward":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = Model(cfg, xent_impl="chunked")
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = _smoke_batch(cfg, 1)
    if check == "loss_and_grads":
        loss, metrics, grads = value_and_grad(model, params, batch)
        assert loss.shape == () and np.isfinite(float(loss)) and np.isfinite(float(metrics["ce"]))
        flat = leaves(grads)
        assert flat and all(bool(torch.isfinite(g.float()).all()) for g in flat)
        return
    memory = model.encode(params, batch["src_embeds"]) if cfg.is_encdec else None

    def full_logits(x):
        x, _ = model._stack(params["layers"], cfg.blocks(), x, memory)
        return model._logits_last(params, apply_norm(cfg, params["final_norm"], x)[:, -1])

    prompt = {k: v for k, v in batch.items() if k in ("tokens", "embeds")}
    x, max_seq = model._input(params, prompt), SMOKE_S + 4
    cache, logits_pre = model.prefill(params, prompt, max_seq, memory=memory)
    _close(logits_pre, full_logits(x).numpy())
    if cfg.moe is not None:
        monkeypatch.setattr(moe, "capacity", lambda cfg, tokens, factor=1.25: tokens)
        cache, logits_pre = model.prefill(params, prompt, max_seq, memory=memory)
        _close(logits_pre, full_logits(x).numpy())
    nxt = torch.argmax(logits_pre, -1)[:, None].to(torch.int32)
    logits_dec, _ = model.decode_step(params, cache, nxt, SMOKE_S, max_seq, memory=memory)
    _close(logits_dec, full_logits(torch.cat([x, model._embed(params, nxt)], dim=1)).numpy())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen2-moe-a2.7b"])
def test_new_families_store_their_f32_leaves_in_f32(arch):
    """``store_compute_dtype`` (``--full``) leaves the RG-LRU gate products,
    Λ and the MoE router in f32 on every layer, which the reference reads
    in f32, and casts the rest.  Each of those leaves matters: stored in
    bf16 with the others, any one of them changes the prefill's logits."""
    rcfg, cfg = _pair(arch, compute_dtype="float32")
    rparams = RefModel(rcfg).init_params(jax.random.PRNGKey(4))
    model = Model(cfg)
    tokens = torch.as_tensor(np.arange(20, dtype=np.int32)[None])
    kept = {"rec": ("w_a", "b_a", "w_x", "b_x", "lam"), "ffn": ("router",)}

    def fresh():
        """The params, with the gate biases (zero at init) drawn from a seed,
        so that their rounding to bf16 shows."""
        params = _port_params(rparams, cfg)
        rng = np.random.default_rng(6)
        for layer in params["layers"]:
            for k in ("b_a", "b_x"):
                if k in layer.get("rec", {}):
                    b = layer["rec"][k]
                    layer["rec"][k] = torch.from_numpy(
                        rng.standard_normal(tuple(b.shape)).astype(np.float32))
        return store_compute_dtype(params, torch.bfloat16)

    params = fresh()
    seen = set()
    for layer in params["layers"]:
        for part, names in kept.items():
            if part in layer and (part != "ffn" or "router" in layer["ffn"]):
                assert {k: layer[part][k].dtype for k in names} == \
                    dict.fromkeys(names, torch.float32)
                seen.update(names)
        moved = layer["ffn"]["shared"]["wi"] if "shared" in layer["ffn"] else layer["ffn"]["wi"]
        assert moved.dtype == torch.bfloat16
    assert seen == set(kept["rec"] if arch == "recurrentgemma-9b" else kept["ffn"])
    _, want = model.prefill(params, {"tokens": tokens}, MAX_SEQ)
    for name in sorted(seen):
        cast = fresh()
        for layer in cast["layers"]:
            for part in kept:
                if name in layer.get(part, {}):
                    layer[part][name] = layer[part][name].to(torch.bfloat16)
        _, got = model.prefill(cast, {"tokens": tokens}, MAX_SEQ)
        assert not torch.equal(got, want), f"{name} in bf16 left the logits unchanged"


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen2-moe-a2.7b"])
def test_new_families_params_round_trip(arch):
    """The reference's params (group-stacked ``rec/*``, ``ffn/router``,
    ``ffn/w{i,g,o}``, ``ffn/shared/*``, ``ffn/shared_gate`` and the
    remainder layers) into the port and back, bit for bit."""
    rcfg, cfg = _pair(arch)
    rparams = jax.tree.map(np.asarray, RefModel(rcfg).init_params(jax.random.PRNGKey(5)))
    back = convert.lm_params_to_numpy(_port_params(rparams, cfg), cfg)
    flat = jax.tree_util.tree_leaves_with_path(rparams)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, want in flat:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    if "rglru" in cfg.blocks():  # one (rglru, rglru, local) group + 2 remainder layers
        assert {"w_a", "b_a", "w_x", "b_x", "lam"} <= set(back["g0"]["rec"])
        assert set(back["r1"]["rec"]) == set(back["g1"]["rec"])
    else:
        assert {"router", "wi", "wg", "wo", "shared", "shared_gate"} == set(back["g0"]["ffn"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen2-moe-a2.7b"])
def test_new_families_engine_matches_the_reference_engine(arch):
    """The reduced config at f32 through both engines: 4 prompts of 6-22
    tokens (past the window of 16), 5 new each, 2 lanes: the same tokens,
    stats and plan."""
    rcfg, cfg = _pair(arch, compute_dtype="float32")
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
