"""The sharded serving steps on CPU meshes, against the reference and the
port's unsharded path.

The port's ``jit_prefill_step`` / ``jit_decode_step``
(``repro_torch.serve.step``) on ("data", "model") meshes (1, 1), (2, 1),
(1, 2), (2, 2) and (1, 4) of one CPU repeated, reduced configs at f32
compute, the reference's weights carried across
(``convert.lm_params_from_numpy``): a prefill of 2 prompts of 20 tokens
(``max_seq`` 32, so the windowed layers' rings of 16 slots wrap), then 4
decode steps fed the reference's greedy tokens.  Every step's logits are
within 1e-4 of the reference's jitted ``make_prefill_step`` /
``make_decode_step`` on one device (the LM path's tolerance), within 1e-5
of the port's unsharded ``make_prefill_step`` / ``make_decode_step``, and
bit-equal to it on (1, 1); ``next_tok`` is the unsharded path's; every
cache leaf after the steps is within 1e-5 of the unsharded cache and
placed by ``policy.cache_specs``, each coordinate holding exactly its
spec's bytes; ``next_tok`` is placed by the reference's ``tok_spec``
(``pos`` comes in placed by its spec).

The archs: Llama-3.2-1B (heads split), Mixtral-8x7B (MoE, sliding
window; on (1, 4) its 4 q heads over 2 KV heads leave the KV heads and
the cache length split), Qwen2-MoE-A2.7B (a shared expert), Qwen2-VL-7B
(M-RoPE, prefilled from ``embeds``), Seamless-M4T-large-v2 (``src_embeds``
in the prefill batch, decoded ``with_memory``, the memory placed by the
reference's spec), gemma3-1b (2 q heads over 1
KV head: replicated on (1, 4)); RecurrentGemma-9B (its cache split on
length, its ``rglru`` blocks on each coordinate's channels) and RWKV6-7B
(on each coordinate's heads, K7's plain version) in
``tests/test_torch_sharded_serve_recurrent.py``.

Also held here, against the reference's steps and the unsharded path:
batch 1 on (2, 2) with the cache length split over ("data", "model"); the
reduced gemma3 widened to Gemma3-1B's attention geometry (4 q heads over
1 KV head of 256) on (2, 2) at batch 2 and 1, its rings of 16 slots
overrun by a prompt of 40 and wrapped by 8 decode steps; and
a misaligned GQA shape (12 q heads over 3 KV heads on a model axis of 2
and 4, with the cache split on length and whole).  And: the int8 KV cache
under the sharded decode at ``tests/test_kv_quant.py``'s tolerances; the
flash-decoding combine with an empty block and a wrapped ring; that no
weight of an attention, FFN, recurrent or embedding sub-block is assembled
whole, and that a heads-split cache is read only block by block while a
length-split one goes through the combine; ``donate``; and that another
placement raises.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models.transformer import Model as RefModel
from repro.serve.step import make_decode_step as ref_make_decode_step
from repro.serve.step import make_prefill_step as ref_make_prefill_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.ft.resilience import reshard_tree
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, griffin
from repro_torch.models.transformer import Model
from repro_torch.serve.step import (jit_decode_step, jit_prefill_step, make_decode_step,
                                    make_prefill_step)
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.tree import flatten_with_paths, leaves

MESHES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
B, S, T, MAX_SEQ, STEPS = 2, 20, 10, 32, 4
REF_TOL, PORT_TOL = 1e-4, 1e-5


def _cfgs(arch):
    return (dataclasses.replace(ref_base.get_reduced_config(arch), compute_dtype="float32"),
            dataclasses.replace(base.get_reduced_config(arch), compute_dtype="float32"))


def _inputs(cfg, batch=B, seed=1):
    """The prefill batch (numpy): tokens, or ``embeds`` for the vision
    stub, plus ``src_embeds`` for an enc-dec config."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        out = {"embeds": (rng.standard_normal((batch, S, cfg.d_model))
                          / np.sqrt(cfg.d_model)).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)}
    if cfg.is_encdec:
        out["src_embeds"] = rng.standard_normal((batch, T, cfg.d_model)).astype(np.float32)
    return out


_REFERENCE_STEPS = {}


def _reference_steps(rmodel, max_seq):
    """The reference's prefill step, encoder and decode step, jitted once a
    model and ``max_seq``."""
    key = (id(rmodel), max_seq)
    if key not in _REFERENCE_STEPS:
        _REFERENCE_STEPS[key] = (
            jax.jit(ref_make_prefill_step(rmodel, max_seq)), jax.jit(rmodel.encode),
            jax.jit(ref_make_decode_step(rmodel, max_seq, with_memory=rmodel.cfg.is_encdec)))
    return _REFERENCE_STEPS[key]


def reference_run(rmodel, rparams, inputs, fed=None, max_seq=MAX_SEQ, seq=S, steps=STEPS):
    """The reference's jitted ``make_prefill_step`` and
    ``make_decode_step`` on one device, after a prompt of ``seq`` tokens:
    (the logits of the prefill and of each decode step, the token fed to
    each step).  The steps are fed ``fed``, or with ``fed=None`` ``steps``
    greedy tokens."""
    prefill, encode, decode = _reference_steps(rmodel, max_seq)
    cache, logits = prefill(rparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    memory = (encode(rparams, jnp.asarray(inputs["src_embeds"]))
              if rmodel.cfg.is_encdec else None)
    out, feeds = [np.asarray(logits)], []
    for step in range(steps if fed is None else len(fed)):
        tok = np.argmax(out[-1], -1)[:, None].astype(np.int32) if fed is None else fed[step]
        pos = jnp.full((tok.shape[0],), seq + step, jnp.int32)
        args = (rparams, cache, jnp.asarray(tok), pos) + ((memory,) if memory is not None else ())
        _, logits, cache = decode(*args)
        out.append(np.asarray(logits))
        feeds.append(tok)
    return out, feeds


@functools.lru_cache(maxsize=None)
def _reference_model(arch):
    """(the reference model, its params)."""
    rmodel = RefModel(_cfgs(arch)[0], rwkv_chunk=8)
    return rmodel, jax.jit(rmodel.init_params)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference params as numpy, the prefill batch, the logits of the
    prefill and of each decode step, the token fed to each step)."""
    rmodel, rparams = _reference_model(arch)
    inputs = _inputs(rmodel.cfg)
    out, fed = reference_run(rmodel, rparams, inputs)
    return jax.tree.map(np.asarray, rparams), inputs, out, fed


def _model(arch, **kw):
    return Model(_cfgs(arch)[1], rwkv_chunk=8, **kw)


def _torch(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _memory(model, params, inputs):
    if not model.cfg.is_encdec:
        return None
    return model.encode(params, torch.as_tensor(inputs["src_embeds"]))


def run_unsharded(model, params, inputs, fed, max_seq=MAX_SEQ, seq=S):
    """The port's unsharded prefill and decode steps after a prompt of
    ``seq`` tokens: (logits a step, next tokens a step, the cache after
    them)."""
    cache, logits = make_prefill_step(model, max_seq)(params, _torch(inputs))
    memory = _memory(model, params, inputs)
    decode = make_decode_step(model, max_seq)
    out, nxt = [logits], []
    for step, tok in enumerate(fed):
        pos = torch.full((tok.shape[0],), seq + step, dtype=torch.int32)
        n, logits, cache = decode(params, cache, torch.as_tensor(tok), pos, memory)
        out.append(logits)
        nxt.append(n)
    return out, nxt, cache


def sharded_steps(model, sizes, batch=B, max_seq=MAX_SEQ, seq=S, **kw):
    mesh = make_mesh(sizes, ("data", "model"), device="cpu")
    policy = ShardingPolicy(mesh, model.cfg)
    aparams, acache = inp.abstract_params(model), inp.abstract_cache(model, batch, max_seq)
    specs = policy.batch_specs(base.ShapeConfig("p", seq, batch, "prefill"))
    return (policy, jit_prefill_step(model, policy, aparams, acache, specs, batch, max_seq),
            jit_decode_step(model, policy, aparams, acache, batch, max_seq,
                            with_memory=model.cfg.is_encdec, **kw))


def run_sharded(model, params, inputs, fed, sizes, batch=B, max_seq=MAX_SEQ, seq=S, **kw):
    """The sharded steps from whole params after a prompt of ``seq`` tokens:
    (logits a step, next_tok a step (placed), the placed cache, the prefill
    and decode steps)."""
    memory = _memory(model, params, inputs)
    _, prefill, decode = sharded_steps(model, sizes, batch, max_seq, seq, **kw)
    if memory is not None:  # split over the data axes, as the reference's spec
        memory = pl.place(memory, decode.memory_sharding)
    params = reshard_tree(params, prefill.param_shardings)
    cache, logits = prefill(params, _torch(inputs))
    out, nxt = [logits], []
    for step, tok in enumerate(fed):
        pos = pl.place(torch.full((tok.shape[0],), seq + step, dtype=torch.int32),
                       decode.pos_sharding)
        args = (params, cache, torch.as_tensor(tok), pos) + ((memory,) if memory is not None
                                                             else ())
        n, logits, cache = decode(*args)
        out.append(logits)
        nxt.append(n)
    return out, nxt, cache, prefill, decode


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def assert_placed_as(tree, shardings):
    """Every leaf placed by its sharding, each coordinate holding exactly
    its spec's bytes on its device."""
    for x, sh in zip(leaves(tree), leaves(shardings)):
        assert isinstance(x, pl.Placed) and x.sharding == sh, (x, sh)
        want = sh.bytes_per_coordinate(tuple(x.shape), x.dtype.itemsize)
        for coord in sh.mesh.coords():
            t = x.shard(coord)
            got = 0 if t is None else t.numel() * t.element_size()
            assert got == want[coord], (x, coord)
            assert t is None or t.device == sh.mesh.device(coord)


def check_sharded_serving(arch, sizes):
    """The sharded steps on a mesh of ``sizes`` against the reference and
    the port's unsharded steps (see the module docstring)."""
    rparams, inputs, ref_logits, fed = _reference(arch)
    model = _model(arch)
    params = convert.lm_params_from_numpy(rparams, model.cfg, device="cpu")
    u_logits, u_next, u_cache = run_unsharded(model, params, inputs, fed)
    s_logits, s_next, s_cache, prefill, decode = run_sharded(model, params, inputs, fed, sizes)
    for got, want, ref in zip(s_logits, u_logits, ref_logits):
        if sizes == (1, 1):
            assert torch.equal(got, want)
        _close(got, want, PORT_TOL)
        _close(got, ref, REF_TOL)
    for got, want in zip(s_next, u_next):
        assert got.sharding == decode.tok_sharding
        assert torch.equal(pl.gather(got, "cpu"), want)
    assert_placed_as(s_cache, decode.cache_shardings)
    for layer, want in zip(s_cache, u_cache):
        for name, x in layer.items():
            _close(pl.gather(x, "cpu"), want[name], PORT_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b", "seamless-m4t-large-v2", "gemma3-1b"])
def test_sharded_steps_match_the_reference_and_the_unsharded_path(arch, mesh):
    check_sharded_serving(arch, MESHES[mesh])


def test_the_specs_split_what_each_case_says():
    """The cases above cover each cache layout and each head split."""
    def layouts(arch, sizes, batch=B):
        model = _model(arch)
        _, _, decode = sharded_steps(model, sizes, batch)
        cache = [{k: pl.zeros(s, a.shape, a.dtype) for (k, a), s in zip(la.items(), ls.values())}
                 for la, ls in zip(decode.abstract_cache, decode.cache_shardings)]
        return [tp.cache_layout(c["k"]) for c in cache if "k" in c]

    assert set(layouts("llama3.2-1b", (2, 2))) == {"heads"}
    assert set(layouts("llama3.2-1b", (1, 4))) == {"length"}
    assert set(layouts("gemma3-1b", (1, 4))) == {"length"}
    assert set(layouts("recurrentgemma-9b", (2, 2), batch=1)) == {"length"}
    model = _model("gemma3-1b")
    pol = ShardingPolicy(make_mesh((1, 4), ("data", "model"), device="cpu"), model.cfg)
    assert pol.param_specs(inp.abstract_params(model))["layers"][0]["attn"]["wq"] == \
        (None, None, None)


def test_batch_one_splits_the_cache_length_over_data_and_model():
    """Batch 1 on (2, 2): the prompt runs whole on the first data row (the
    batch specs split the sequence), split on heads along "model", and the
    cache of Llama-3.2-1B is split on heads with its positions on length
    over ("data", "model"); RecurrentGemma's on length over ("data",
    "model"): every step within 1e-4 of the reference's jitted steps at
    batch 1 and 1e-5 of the port's unsharded path."""
    for arch in ("llama3.2-1b", "recurrentgemma-9b"):
        rmodel, rparams = _reference_model(arch)
        model = _model(arch)
        params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), model.cfg,
                                              device="cpu")
        inputs = _inputs(model.cfg, batch=1)
        fed = [np.full((1, 1), 5 + i, np.int32) for i in range(STEPS)]
        ref_logits, _ = reference_run(rmodel, rparams, inputs, fed)
        u_logits, _, u_cache = run_unsharded(model, params, inputs, fed)
        s_logits, _, s_cache, prefill, decode = run_sharded(model, params, inputs, fed, (2, 2),
                                                            batch=1)
        assert not prefill.split_rows and not decode.batch_split
        for got, want, ref in zip(s_logits, u_logits, ref_logits):
            _close(got, want, PORT_TOL)
            _close(got, ref, REF_TOL)
        attn = next(i for i, k in enumerate(model.cfg.blocks()) if k != "rglru")
        pos_spec = s_cache[attn]["pos"].sharding.spec
        assert tuple(pos_spec) == (None, ("data", "model"))
        want_k = (None, None, "model", None) if arch == "llama3.2-1b" else \
            (None, ("data", "model"), None, None)
        assert tuple(s_cache[attn]["k"].sharding.spec) == want_k
        for layer, want in zip(s_cache, u_cache):
            for name, x in layer.items():
                _close(pl.gather(x, "cpu"), want[name], PORT_TOL)


@pytest.mark.parametrize("sizes", [(1, 1), (2, 2), (1, 4)])
def test_int8_cache_under_the_sharded_decode(sizes):
    """``kv_dtype="int8"`` (the configs' bf16 compute): the sharded int8
    steps within tests/test_kv_quant.py's tolerances of the unsharded
    float cache's logits (prefill (0.2, 0.15) and argmax on half the rows,
    decode (0.25, 0.2)) and of the unsharded int8 path's; bit-equal to it
    on (1, 1); the scales placed as the values."""
    rcfg, cfg = (ref_base.get_reduced_config("llama3.2-1b"),
                 base.get_reduced_config("llama3.2-1b"))
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, RefModel(rcfg).init_params(jax.random.PRNGKey(0))), cfg,
        device="cpu")
    inputs = _inputs(cfg)
    fed = [np.full((B, 1), 7 + i, np.int32) for i in range(2)]
    fp, _, _ = run_unsharded(Model(cfg), params, inputs, fed)
    q, _, q_cache = run_unsharded(Model(cfg, kv_dtype="int8"), params, inputs, fed)
    s, _, s_cache, _, decode = run_sharded(Model(cfg, kv_dtype="int8"), params, inputs, fed,
                                           sizes)
    assert s_cache[0]["k"].dtype == torch.int8
    assert_placed_as(s_cache, decode.cache_shardings)
    for want in (fp, q):
        np.testing.assert_allclose(s[0].numpy(), want[0].numpy(), rtol=0.2, atol=0.15)
        assert np.mean(np.argmax(s[0].numpy(), -1) == np.argmax(want[0].numpy(), -1)) >= 0.5
        for got, w in zip(s[1:], want[1:]):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0.25, atol=0.2)
    if sizes == (1, 1):
        assert all(torch.equal(a, b) for a, b in zip(s, q))
        for layer, want in zip(s_cache, q_cache):
            assert all(torch.equal(pl.gather(x, "cpu"), want[k]) for k, x in layer.items())


def test_combine_with_an_empty_block_and_a_wrapped_ring():
    """The flash-decoding combine against ``_sdpa_ref`` over the whole
    cache: blocks of 8 slots of 32, one with no valid slot (weight 0, no
    NaN), the valid slots those of a ring of 16 that has wrapped
    (positions 12..27 at slots pos % 16)."""
    g = torch.Generator().manual_seed(0)
    Bq, L, H, K, h = 2, 32, 4, 2, 8
    q = torch.randn(Bq, 1, H, h, generator=g)
    k = torch.randn(Bq, L, K, h, generator=g)
    v = torch.randn(Bq, L, K, h, generator=g)
    cpos = torch.full((Bq, L), -1, dtype=torch.int32)
    ring = torch.arange(12, 28, dtype=torch.int32)
    cpos[:, ring % 16] = ring  # slots 0..15; slots 16..31 empty
    pos = torch.full((Bq,), 27, dtype=torch.int32)
    valid = (cpos >= 0) & (cpos <= pos[:, None]) & (cpos > pos[:, None] - 16)
    want = attention._sdpa_ref(q, k, v, valid[:, None, None, :], 0.35, 30.0)
    parts = [tp.partial_softmax(q, k[:, i:i + 8], v[:, i:i + 8], valid[:, i:i + 8], 0.35, 30.0)
             for i in range(0, L, 8)]
    assert torch.isneginf(parts[3][1]).all() and (parts[3][2] == 0).all()
    got = tp.combine_partials(parts)
    assert torch.isfinite(got).all()
    _close(got, want, 1e-6)


@functools.lru_cache(maxsize=None)
def _misaligned_reference(widen):
    """The reference model on reduced Llama-3.2-1B widened by ``widen``
    ((field, value) pairs), and its params."""
    rcfg = dataclasses.replace(ref_base.get_reduced_config("llama3.2-1b"), **dict(widen))
    rmodel = RefModel(rcfg)
    return rmodel, jax.jit(rmodel.init_params)(jax.random.PRNGKey(5))


@pytest.mark.parametrize("sizes,max_seq", [((1, 2), 32), ((1, 4), 32), ((1, 2), 33)])
def test_misaligned_gqa_groups(sizes, max_seq):
    """12 q heads over 3 KV heads: on a model axis of 2 each coordinate's 6
    q heads straddle two KV groups unevenly (4 + 2 and 2 + 4), on 4 its 3
    do (3, then 1 + 2, ...): each coordinate repeats its KV heads to a
    group of 1.  The cache (3 KV heads do not split) is split on length at
    ``max_seq`` 32 and whole at 33.  Against the reference's jitted steps
    on the same config (1e-4) and the port's unsharded path (1e-5)."""
    widen = dict(num_heads=12, num_kv_heads=3, compute_dtype="float32")
    rmodel, rparams = _misaligned_reference(tuple(widen.items()))
    cfg = dataclasses.replace(base.get_reduced_config("llama3.2-1b"), **widen)
    model = Model(cfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    inputs = _inputs(cfg)
    fed = [np.full((B, 1), 3 + i, np.int32) for i in range(STEPS)]
    ref_logits, _ = reference_run(rmodel, rparams, inputs, fed, max_seq)
    u_logits, _, u_cache = run_unsharded(model, params, inputs, fed, max_seq)
    s_logits, _, s_cache, _, _ = run_sharded(model, params, inputs, fed, sizes,
                                             max_seq=max_seq)
    assert tp.cache_layout(s_cache[0]["k"]) == ("length" if max_seq == 32 else "whole")
    assert tp.kv_pick((0, 6), 4) is not None and not isinstance(tp.kv_pick((0, 6), 4), slice)
    for got, want, ref in zip(s_logits, u_logits, ref_logits):
        _close(got, want, PORT_TOL)
        _close(got, ref, REF_TOL)
    for layer, want in zip(s_cache, u_cache):
        for name, x in layer.items():
            _close(pl.gather(x, "cpu"), want[name], PORT_TOL)


# The reduced Gemma3-1B widened to its full attention geometry: 4 query
# heads over 1 KV head of 256, the reduced window of 16, f32
GEMMA_WIDE = dict(num_heads=4, num_kv_heads=1, head_dim=256, compute_dtype="float32")
GEMMA_PROMPT, GEMMA_STEPS, GEMMA_MAX_SEQ = 40, 8, 64


@functools.lru_cache(maxsize=None)
def _gemma_wide_reference():
    rcfg = dataclasses.replace(ref_base.get_reduced_config("gemma3-1b"), **GEMMA_WIDE)
    rmodel = RefModel(rcfg)
    return rmodel, jax.jit(rmodel.init_params)(jax.random.PRNGKey(3))


@pytest.mark.parametrize("batch", [2, 1])
def test_gemma3_attention_geometry_rings_on_2x2(batch):
    """Gemma3-1B's attention geometry (4 query heads over one KV head of
    256; 5 local layers of a window of 16 to 1 global) on (2, 2): 2 query
    heads a model coordinate over the replicated KV head, every cache split
    on length (over "model", at batch 1 over ("data", "model"), the rings of
    16 slots in blocks of 8 / 4).  A prompt of 40 overruns the rings in the
    prefill (at batch 1 each data row fills them from its span's start) and
    8 greedy decode steps wrap them again: every step within 1e-4 of the
    reference's jitted steps and 1e-5 of the port's unsharded path, the
    cache leaves too."""
    rmodel, rparams = _gemma_wide_reference()
    cfg = dataclasses.replace(base.get_reduced_config("gemma3-1b"), **GEMMA_WIDE)
    model = Model(cfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rng = np.random.default_rng(4)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (batch, GEMMA_PROMPT)).astype(np.int32)}
    kw = dict(max_seq=GEMMA_MAX_SEQ, seq=GEMMA_PROMPT)
    ref_logits, fed = reference_run(rmodel, rparams, inputs, steps=GEMMA_STEPS, **kw)
    u_logits, _, u_cache = run_unsharded(model, params, inputs, fed, **kw)
    s_logits, _, s_cache, prefill, _ = run_sharded(model, params, inputs, fed, (2, 2),
                                                   batch=batch, **kw)
    assert prefill.split_seq == (batch == 1)
    for got, want, ref in zip(s_logits, u_logits, ref_logits):
        _close(got, want, PORT_TOL)
        _close(got, ref, REF_TOL)
    blocks = {2: ("model",), 1: (("data", "model"),)}[batch]
    for layer, kind in zip(s_cache, cfg.blocks()):
        assert tp.cache_layout(layer["k"]) == "length"
        assert tuple(layer["k"].sharding.spec)[1:2] == blocks
        assert layer["k"].shape[1] == (cfg.window if kind == "local" else GEMMA_MAX_SEQ)
    last = GEMMA_PROMPT + GEMMA_STEPS - 1  # the ring's slots hold the last 16 positions
    ring = pl.gather(s_cache[0]["pos"], "cpu")
    assert sorted(ring[0].tolist()) == list(range(last - cfg.window + 1, last + 1))
    for layer, want in zip(s_cache, u_cache):
        for name, x in layer.items():
            _close(pl.gather(x, "cpu"), want[name], PORT_TOL)


@pytest.mark.parametrize("sizes,layout", [((2, 2), "heads"), ((1, 4), "length")])
def test_compute_reads_blocks_and_never_whole_weights(sizes, layout, monkeypatch):
    """Llama-3.2-1B: no leaf of the params is gathered whole; a heads-split
    cache is read only block by block (no K/V leaf read across blocks, no
    combine), a length-split one through the combine, once a layer a
    decode step."""
    rparams, inputs, _, fed = _reference("llama3.2-1b")
    model = _model("llama3.2-1b")
    params = convert.lm_params_from_numpy(rparams, model.cfg, device="cpu")
    gathered, read, combines = [], [], []
    real_gather, real_read, real_combine = pl.gather, pl.read_region, tp.combine_partials
    monkeypatch.setattr(pl, "gather", lambda x, *a, **k: gathered.append(x) or
                        real_gather(x, *a, **k))
    monkeypatch.setattr(pl, "read_region", lambda x, *a, **k: read.append(x) or
                        real_read(x, *a, **k))
    monkeypatch.setattr(tp, "combine_partials", lambda parts: combines.append(len(parts)) or
                        real_combine(parts))
    _, _, cache, _, _ = run_sharded(model, params, inputs, fed, sizes)
    assert gathered == []
    kv = {id(layer[k]) for layer in cache for k in ("k", "v")}
    assert not any(id(x) in kv for x in read)
    if layout == "heads":
        assert combines == []
    else:
        assert combines == [4] * (model.cfg.num_layers * STEPS)


def test_recurrent_blocks_alone_are_gathered(monkeypatch):
    """RecurrentGemma on (1, 2): no weight is gathered whole, the ``rglru``
    blocks' included (their gates, scan and ``w_out`` run on each
    coordinate's channels: ``griffin.recurrence`` once an ``rglru`` layer a
    coordinate, on half the width, its gates reading all of ξ)."""
    rparams, inputs, _, fed = _reference("recurrentgemma-9b")
    model = _model("recurrentgemma-9b")
    cfg = model.cfg
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    _, prefill, _ = sharded_steps(model, (1, 2))
    placed = reshard_tree(params, prefill.param_shardings)
    paths = {id(x): "/".join(map(str, p)) for p, x in flatten_with_paths(placed)}
    gathered, widths = [], []
    real, real_rec = pl.gather, griffin.recurrence
    monkeypatch.setattr(pl, "gather", lambda x, *a, **k: gathered.append(paths.get(id(x)))
                        or real(x, *a, **k))
    monkeypatch.setattr(griffin, "recurrence", lambda cfg_, p, gate, xf_all, xf, *a, **k: (
        widths.append((xf_all.shape[-1], xf.shape[-1])) or real_rec(cfg_, p, gate, xf_all, xf,
                                                                    *a, **k)))
    prefill(placed, _torch(inputs))
    assert gathered == []
    n_rec = sum(kind == "rglru" for kind in cfg.blocks())
    assert widths == [(cfg.lru_width, cfg.lru_width // 2)] * (2 * n_rec)


def test_donate_updates_the_cache_in_place():
    """``donate=True`` returns the placed cache passed in, updated; with
    ``donate=False`` the cache passed in keeps its bits and the outputs are
    the same."""
    rparams, inputs, _, fed = _reference("llama3.2-1b")
    model = _model("llama3.2-1b")
    params = convert.lm_params_from_numpy(rparams, model.cfg, device="cpu")
    outs = []
    for donate in (False, True):
        _, prefill, decode = sharded_steps(model, (2, 2), donate=donate)
        cache, _ = prefill(params, _torch(inputs))
        before = [pl.gather(x, "cpu").clone() for x in leaves(cache)]
        pos = torch.full((B,), S, dtype=torch.int32)
        _, logits, out = decode(params, cache, torch.as_tensor(fed[0]), pos)
        same = all(a is b for a, b in zip(leaves(out), leaves(cache)))
        changed = any(not torch.equal(a, pl.gather(x, "cpu"))
                      for a, x in zip(before, leaves(cache)))
        assert same == donate and changed == donate
        outs.append((logits, [pl.gather(x, "cpu") for x in leaves(out)]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_another_placement_raises():
    """Params or a cache placed for another mesh raise with the reshard
    hint; a whole cache is placed on the way in."""
    rparams, inputs, _, fed = _reference("llama3.2-1b")
    model = _model("llama3.2-1b")
    params = convert.lm_params_from_numpy(rparams, model.cfg, device="cpu")
    _, prefill22, decode22 = sharded_steps(model, (2, 2))
    _, prefill14, decode14 = sharded_steps(model, (1, 4))
    placed14 = reshard_tree(params, prefill14.param_shardings)
    with pytest.raises(ValueError, match="reshard"):
        prefill22(placed14, _torch(inputs))
    cache14, _ = prefill14(placed14, _torch(inputs))
    pos = torch.full((B,), S, dtype=torch.int32)
    with pytest.raises(ValueError, match="reshard"):
        decode22(params, cache14, torch.as_tensor(fed[0]), pos)
    whole, _ = make_prefill_step(model, MAX_SEQ)(params, _torch(inputs))
    _, _, out = decode22(params, whole, torch.as_tensor(fed[0]), pos)
    assert_placed_as(out, decode22.cache_shardings)


@pytest.mark.parametrize("spec", [(("data",), None, "model", None), (("data",), "model"),
                                  (None, ("data", "model")), (None, "model", None, None)])
def test_write_and_write_slots_match_plain_indexing(spec):
    """``placement.write`` of a region and ``write_slots`` of one slot a
    row (slots inside and outside each block) on a (2, 2) mesh give the
    whole tensor that plain indexing gives, and every copy of a block is
    the same."""
    g = torch.Generator().manual_seed(0)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    shape = (4, 8, 2, 3)[:len(spec)]
    whole = torch.randn(shape, generator=g)
    x = pl.place(whole, pl.NamedSharding(mesh, pl.Spec(spec)))
    region = ((1, 3), (2, 7))
    value = torch.randn((2, 5) + shape[2:], generator=g)
    pl.write(x, region, value)
    whole[1:3, 2:7] = value
    slots = torch.tensor([0, 7, 3])
    rows = (1, 4)
    value = torch.randn((3,) + shape[2:], generator=g)
    pl.write_slots(x, rows, slots, value)
    whole[torch.arange(1, 4), slots] = value
    assert torch.equal(pl.gather(x, "cpu"), whole)
    for held in x.copies().values():
        assert all(torch.equal(t, held[0][1]) for _, t in held)
