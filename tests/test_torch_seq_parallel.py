"""Sequence parallelism at batch 1: the sharded prefill and train steps with
the sequence split over the data axes, on CPU meshes, against the
reference and the port's unsharded path.

At ``global_batch=1`` the batch specs (the port's ``policy.batch_specs``,
the reference's alike) split ``tokens`` / ``embeds`` / ``targets`` on the
sequence over the data axes, ``P(None, dp)``, and the port's
``jit_prefill_step`` / ``jit_train_step`` give data row j the positions
``[j S / dp, (j + 1) S / dp)``: each layer reads what the rows before left
it (attention's K/V through K5 with a query offset, RWKV's and the
RG-LRU's state, the MoE router's slot counts and sums).  Reduced configs
at f32 compute, the reference's weights carried across
(``convert.lm_params_from_numpy``), meshes (2, 1), (2, 2) and (4, 1) of one
CPU repeated, a sequence of 32:

* the prefill's logits within 1e-4 of the reference's jitted
  ``make_prefill_step`` and 1e-5 of the port's unsharded prefill, every
  cache leaf within 1e-5 of the unsharded cache and placed by
  ``cache_specs``, then 4 decode steps within the same limits; a spy on
  ``flash_attention`` shows each data row's queries over exactly its span
  (S / dp rows at offset j S / dp, over its keys and the rows' before);
* two steps of ``jit_train_step`` against the reference's
  ``make_train_step(microbatches=1)``, held as
  ``tests/test_torch_sharded_train.py`` holds the batch split: losses 1e-5
  relative, m and v after each step within ``LEAF_TOL`` of the reference's
  step from the same state, and after both of its two compounded steps
  (the few elements at the f32 noise floor excused by the reference's own
  move from the port's first-step params), the params within ``LEAF_TOL``;
  and against the port's unsharded step (losses 1e-5 relative, leaves
  within 1e-5);
* the archs: Llama-3.2-1B; Mixtral-8x7B (sliding window, ``max_seq`` 32, so
  its ring of 16 slots wraps); Qwen2-MoE-A2.7B at a capacity factor of 0.25
  in both packages, where the whole sequence's routing drops choices
  (asserted), so the carried slot counts decide the drops; Qwen2-VL-7B
  (prefilled and trained from ``embeds``, M-RoPE); RWKV6-7B;
  RecurrentGemma-9B; and Gemma3-1B (5 local layers of a window of 16 to 1
  global, tied embeddings: each span of 16, so the second row's local
  queries reach back into the first row's keys);
* a sequence of 30 over 4 data rows raises ``ValueError`` in the port's
  steps and in the reference's jit (in a subprocess of 4 CPU devices), as
  do 30 frames of an enc-dec's ``src_embeds`` in the reference's jit, and
  2 microbatches of a batch of 1 raise.  The enc-dec encoder's split:
  ``tests/test_torch_encoder_split.py``.

Units: ``attention_ref`` at a query offset equals the rows of the whole
attention (GQA, causal, window, softcap) and so does its VJP; ``route``
over two spans with the carried counts equals ``route`` over the whole
group bit for bit, and the aux loss from the carried sums equals the whole
sequence's; the split CE sum and count give the whole sequence's mean.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import contextlib
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as ref_base
from repro.models import moe as ref_moe
from repro.models.transformer import Model as RefModel
from repro.serve.step import make_decode_step as ref_make_decode_step
from repro.serve.step import make_prefill_step as ref_make_prefill_step
from repro.train import optimizer as ref_opt
from repro.train.step import TrainStepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.data import tokens as tok
from repro_torch.ft.resilience import reshard_tree
from repro_torch.kernels import build
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.transformer import Model, Span
from repro_torch.serve.step import (jit_decode_step, jit_prefill_step, make_decode_step,
                                    make_prefill_step)
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, jit_train_step, make_train_step
from repro_torch.tree import leaves
from test_torch_sharded_serve import assert_placed_as
from test_torch_sharded_train import ADAMW, LEAF_TOL, LOSS_RTOL, _assert_leaves_close, _whole

ARCHS = ["llama3.2-1b", "mixtral-8x7b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b",
         "recurrentgemma-9b", "gemma3-1b"]
MESHES = {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}
S, STEPS = 32, 4
MAX_SEQ = {"mixtral-8x7b": 32}  # 40 otherwise: the 4 decode steps past the prompt
REF_TOL, PORT_TOL = 1e-4, 1e-5
DROP_FACTOR = 0.25  # Qwen2-MoE's capacity factor here: 8 slots an expert, drops
ENCDEC_FRAMES = 2  # frames a token in the enc-dec's bf16 runs, as chip_smoke's 1,024 / 512
# RWKV6's m and v: step 2's gradient of ``bonus_u`` cancels to the f32 noise
# floor, where a sum in another order moves v by a share of LEAF_TOL (the
# wkv scan's chunks end at each span's end, and its VJP sums each span's
# share of du apart).  Against the reference's step from the same state the
# port's unsharded one-microbatch step reads 0.95 x LEAF_TOL on it, the (2,
# 2) split 1.00, (2, 1) 0.34, (4, 1) 0.26; against its two compounded steps
# the unsharded step 2.40 x, the (2, 2) split 2.40 x, (2, 1) 1.77 x.  Three
# times LEAF_TOL for RWKV's moments.
MOMENT_TOL = {"rwkv6-7b": 3 * LEAF_TOL}


def _max_seq(arch):
    return MAX_SEQ.get(arch, 40)


def _cfgs(arch):
    return (dataclasses.replace(ref_base.get_reduced_config(arch), compute_dtype="float32"),
            dataclasses.replace(base.get_reduced_config(arch), compute_dtype="float32"))


@contextlib.contextmanager
def _capacity(arch):
    """Qwen2-MoE at ``DROP_FACTOR`` in both packages (their ``capacity``
    at that factor); nothing for the other archs."""
    if arch != "qwen2-moe-a2.7b":
        yield
        return
    saved = ref_moe.capacity, moe.capacity
    ref_moe.capacity = lambda cfg, n, factor=1.25: saved[0](cfg, n, DROP_FACTOR)
    moe.capacity = lambda cfg, n, factor=1.25: saved[1](cfg, n, DROP_FACTOR)
    try:
        yield
    finally:
        ref_moe.capacity, moe.capacity = saved


def _model(arch):
    return Model(_cfgs(arch)[1], xent_impl="seq_chunked", xent_seq_chunk=8, rwkv_chunk=8)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference params as numpy, the prompt, the tokens fed to the decode
    steps, the train batches, the reference's logits of the prefill and
    each decode step, and its params, m and v after two train steps and
    their losses)."""
    rcfg, cfg = _cfgs(arch)
    rmodel = _ref_model(arch)
    rng = np.random.default_rng(3)
    if cfg.frontend == "vision":
        prompt = {"embeds": (rng.standard_normal((1, S, cfg.d_model))
                             / np.sqrt(cfg.d_model)).astype(np.float32)}
    else:
        prompt = {"tokens": rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)}
    fed = [np.full((1, 1), 5 + i, np.int32) for i in range(STEPS)]
    batches = [dict(prompt, targets=rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32))
               for _ in range(2)]
    batches[1] = {k: np.roll(v, 7, axis=1) for k, v in batches[1].items()}
    max_seq = _max_seq(arch)
    with _capacity(arch):
        rparams = jax.jit(rmodel.init_params)(jax.random.PRNGKey(0))
        cache, logits = jax.jit(ref_make_prefill_step(rmodel, max_seq))(
            rparams, {k: jnp.asarray(v) for k, v in prompt.items()})
        decode = jax.jit(ref_make_decode_step(rmodel, max_seq))
        out = [np.asarray(logits)]
        for step, tok in enumerate(fed):
            _, logits, cache = decode(rparams, cache, jnp.asarray(tok),
                                      jnp.full((1,), S + step, jnp.int32))
            out.append(np.asarray(logits))
        params, state, losses = rparams, ref_opt.init_state(rparams), []
        for b in batches:
            params, state, m = _ref_train(arch)(params, state, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    trained = jax.tree.map(np.asarray, (params, state.m, state.v))
    return jax.tree.map(np.asarray, rparams), prompt, fed, batches, out, trained, losses


@functools.lru_cache(maxsize=None)
def _ref_model(arch):
    return RefModel(_cfgs(arch)[0], xent_impl="seq_chunked", xent_seq_chunk=8, rwkv_chunk=8)


@functools.lru_cache(maxsize=None)
def _ref_train(arch):
    return jax.jit(ref_make_train_step(_ref_model(arch), RefStepConfig(
        microbatches=1, adamw=ref_opt.AdamWConfig(**ADAMW))))


def _ref_step_from(arch, state, done, batch):
    """The reference's step on ``batch`` from ``state`` (params, m, v as
    numpy in its layout; m None for a fresh AdamW state) after ``done``
    steps: (params, m, v), numpy."""
    params = jax.tree.map(jnp.asarray, state[0])
    opt_state = (ref_opt.init_state(params) if state[1] is None else
                 ref_opt.AdamWState(step=jnp.asarray(done, jnp.int32),
                                    m=jax.tree.map(jnp.asarray, state[1]),
                                    v=jax.tree.map(jnp.asarray, state[2])))
    with _capacity(arch):
        params, opt_state, _ = _ref_train(arch)(params, opt_state,
                                                jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (params, opt_state.m, opt_state.v))


def _params(arch, model):
    return convert.lm_params_from_numpy(_reference(arch)[0], model.cfg, device="cpu")


def _torch(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _unsharded_serving(arch):
    """The port's unsharded prefill and decode steps: (logits a step, the
    cache after the prefill (whole leaves), the routes' keep masks of the
    prefill's MoE layers)."""
    model = _model(arch)
    params = _params(arch, model)
    _, prompt, fed, *_ = _reference(arch)
    max_seq = _max_seq(arch)
    keeps, real = [], moe.route
    moe.route = lambda *a, **k: (lambda r: keeps.append(r["keep"]) or r)(real(*a, **k))
    try:
        with _capacity(arch):
            cache, logits = make_prefill_step(model, max_seq)(params, _torch(prompt))
            moe.route = real
            prefilled = [{k: v.clone() for k, v in layer.items()} for layer in cache]
            decode = make_decode_step(model, max_seq)
            out = [logits]
            for step, tok in enumerate(fed):
                _, logits, cache = decode(params, cache, torch.as_tensor(tok),
                                          torch.full((1,), S + step, dtype=torch.int32))
                out.append(logits)
    finally:
        moe.route = real
    return out, prefilled, keeps


def _steps(model, sizes, max_seq):
    mesh = make_mesh(sizes, ("data", "model"), device="cpu")
    policy = ShardingPolicy(mesh, model.cfg)
    aparams, acache = inp.abstract_params(model), inp.abstract_cache(model, 1, max_seq)
    specs = policy.batch_specs(base.ShapeConfig("p", S, 1, "prefill"))
    return (policy, jit_prefill_step(model, policy, aparams, acache, specs, 1, max_seq),
            jit_decode_step(model, policy, aparams, acache, 1, max_seq))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_prefill_and_decode(arch, mesh, monkeypatch):
    """The split prefill and 4 decode steps against the reference and the
    unsharded path; each data row's attention over its span."""
    sizes = MESHES[mesh]
    dp = sizes[0]
    model = _model(arch)
    _, prompt, fed, _, ref_logits, *_ = _reference(arch)
    u_logits, u_cache, keeps = _unsharded_serving(arch)
    if arch == "qwen2-moe-a2.7b":
        assert not all(bool(k.all()) for k in keeps)  # the whole sequence drops choices
    max_seq = _max_seq(arch)
    policy, prefill, decode = _steps(model, sizes, max_seq)
    assert prefill.split_seq and not prefill.split_rows
    params = reshard_tree(_params(arch, model), prefill.param_shardings)
    calls, real = [], flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention", lambda q, k, v, **kw: calls.append(
        (q.shape[1], k.shape[1], kw.get("q_offset", 0))) or real(q, k, v, **kw))
    with _capacity(arch):
        cache, logits = prefill(params, _torch(prompt))
        monkeypatch.setattr(flash_ops, "flash_attention", real)
        assert_placed_as(cache, decode.cache_shardings)
        for layer, want in zip(cache, u_cache):
            for name, x in layer.items():
                _close(pl.gather(x, "cpu"), want[name], PORT_TOL)
        out = [logits]
        for step, tok in enumerate(fed):
            _, logits, cache = decode(params, cache, torch.as_tensor(tok), S + step)
            out.append(logits)
    for got, want, ref in zip(out, u_logits, ref_logits):
        _close(got, want, PORT_TOL)
        _close(got, ref, REF_TOL)
    per = S // dp
    n_attn = sum(kind in ("attn", "swa", "local") for kind in model.cfg.blocks())
    workers = sizes[1] if model.cfg.num_heads % sizes[1] == 0 else 1
    want = [(per, (j + 1) * per, j * per) for j in range(dp) for _ in range(n_attn * workers)]
    assert calls == want


@functools.lru_cache(maxsize=None)
def _unsharded_training(arch):
    """The port's unsharded step, 2 steps from the reference's weights:
    (params, AdamW state, losses, v after each step in the reference's
    layout)."""
    model = _model(arch)
    cfg = model.cfg
    params = _params(arch, model)
    step = make_train_step(model, TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW)))
    state, losses, vs = opt.init_state(params), [], []
    with _capacity(arch):
        for b in _reference(arch)[3]:
            params, state, m = step(params, state, _torch(b))
            losses.append(float(m["loss"]))
            vs.append(jax.tree.map(np.copy, convert.lm_params_to_numpy(state.v, cfg)))
    return params, state, losses, vs


def _train_step(model, sizes, batch=1, seq=S, **kw):
    policy = ShardingPolicy(make_mesh(sizes, ("data", "model"), device="cpu"), model.cfg)
    return jit_train_step(model, policy, inp.abstract_params(model),
                          TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW), **kw),
                          batch_specs=policy.batch_specs(base.ShapeConfig("t", seq, batch,
                                                                          "train")))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_train_steps(arch, mesh):
    """Two split train steps against the reference's one-microbatch step
    and the port's unsharded step."""
    model = _model(arch)
    cfg = model.cfg
    rparams, *_, batches, _, (want_p, want_m, want_v), want_losses = _reference(arch)
    uparams, ustate, ulosses, uvs = _unsharded_training(arch)
    tol = MOMENT_TOL.get(arch, LEAF_TOL)
    step = _train_step(model, MESHES[mesh])
    assert step.split_seq
    params = reshard_tree(_params(arch, model), step.param_shardings)
    state, losses, ref_firsts, port_firsts = step.init_opt_state(), [], [], []
    ref_in = (rparams, None)  # the state each split step starts from, reference layout
    for i, b in enumerate(batches):
        ref_firsts.append(_ref_step_from(arch, ref_in, i, b))
        with _capacity(arch):
            params, state, m = step(params, state, _torch(b))
        losses.append(float(m["loss"]))
        ref_in = tuple(convert.lm_params_to_numpy(_whole(t), cfg)
                       for t in (params, state.m, state.v))
        port_firsts.append(ref_in)
        _assert_leaves_close(_whole(state.m), ref_firsts[-1][1], cfg, tol)
        _assert_leaves_close(_whole(state.v), ref_firsts[-1][2], cfg, tol)
    _, moved_m, moved_v = _ref_step_from(arch, (port_firsts[0][0], *ref_firsts[0][1:]), 1,
                                         batches[1])
    _assert_leaves_close(_whole(state.m), want_m, cfg, tol, moved=moved_m)
    _assert_leaves_close(_whole(state.v), want_v, cfg, tol, moved=moved_v)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, ulosses, rtol=PORT_TOL)
    _assert_leaves_close(_whole(params), want_p, cfg, floor=1.0, want_v=want_v, steps=2)
    for got, want in ((params, uparams), (state.m, ustate.m), (state.v, ustate.v)):
        _assert_leaves_close(_whole(got), convert.lm_params_to_numpy(want, cfg), cfg,
                             PORT_TOL, 1.0, step_vs=uvs if got is params else ())


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_spans_longer_than_a_ring(kv_dtype):
    """Mixtral-8x7B reduced, a prompt of 64 on (2, 2): each data row's span
    of 32 is longer than the ring of 16 slots, so a row keeps only its last
    16 positions (at most two runs of slots); the cache (int8 too) and the
    logits of the prefill and 3 decode steps within 1e-5 of the unsharded
    path."""
    model = Model(_cfgs("mixtral-8x7b")[1], kv_dtype=kv_dtype)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(1))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    policy = ShardingPolicy(mesh, model.cfg)
    aparams, acache = inp.abstract_params(model), inp.abstract_cache(model, 1, 80)
    prefill = jit_prefill_step(model, policy, aparams, acache,
                               policy.batch_specs(base.ShapeConfig("p", 64, 1, "prefill")),
                               1, 80)
    decode = jit_decode_step(model, policy, aparams, acache, 1, 80)
    placed = reshard_tree(params, prefill.param_shardings)
    cache, logits = prefill(placed, {"tokens": tokens})
    ucache, ulogits = make_prefill_step(model, 80)(params, {"tokens": tokens})
    assert prefill.split_seq and cache[0]["k"].dtype == ucache[0]["k"].dtype
    for layer, want in zip(cache, ucache):
        for name, x in layer.items():
            _close(pl.gather(x, "cpu"), want[name], PORT_TOL)
    got, want = [logits], [ulogits]
    udecode = make_decode_step(model, 80)
    for s in range(3):
        tok = torch.full((1, 1), 3 + s, dtype=torch.int32)
        got.append(decode(placed, cache, tok, 64 + s)[1])
        want.append(udecode(params, ucache, tok, torch.full((1,), 64 + s, dtype=torch.int32))[1])
    for a, b in zip(got, want):
        _close(a, b, PORT_TOL)


_REFERENCE_JIT = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import base
from repro.sharding.policy import ShardingPolicy

mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "model"))
policy = ShardingPolicy(mesh, base.get_reduced_config("llama3.2-1b"))
for name, seq, shape in (("tokens", 32, (1, 32)), ("tokens", 30, (1, 30)),
                         ("src_embeds", 32, (1, 32, 8)), ("src_embeds", 32, (1, 30, 8))):
    spec = policy.batch_specs(base.ShapeConfig("p", seq, 1, "prefill"))[name]
    f = jax.jit(lambda t: t + 1, in_shardings=NamedSharding(mesh, spec))
    try:
        f(jnp.zeros(shape, jnp.int32))
        print(name, shape[1], tuple(spec), "ok")
    except ValueError as e:
        print(name, shape[1], tuple(spec), "ValueError", "divisible" in str(e))
"""


def test_a_sequence_the_data_rows_do_not_divide_raises():
    """(1, 30) on 4 data rows: the reference's jit raises (4 CPU devices,
    a subprocess) and so do the port's prefill and train steps; (1, 32)
    runs in both.  So does an enc-dec's ``src_embeds`` of 30 frames beside
    a prompt of 32 tokens in the reference's jit (the port's steps:
    ``tests/test_torch_encoder_split.py``).  Two microbatches of a batch of
    1 raise."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE_JIT)], env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.split("\n")[:4] == ["tokens 32 (None, 'data') ok",
                                   "tokens 30 (None, 'data') ValueError True",
                                   "src_embeds 32 (None, 'data', None) ok",
                                   "src_embeds 30 (None, 'data', None) ValueError True"]
    model = _model("llama3.2-1b")
    params = _params("llama3.2-1b", model)
    _, prefill, _ = _steps(model, (4, 1), 40)
    tokens = torch.zeros((1, 30), dtype=torch.int32)
    with pytest.raises(ValueError, match="sequence of 30 does not split over 4"):
        prefill(params, {"tokens": tokens})
    step = _train_step(model, (4, 1), seq=30)
    with pytest.raises(ValueError, match="sequence of 30 does not split over 4"):
        step(params, step.init_opt_state(), {"tokens": tokens, "targets": tokens})
    step = _train_step(model, (2, 1), microbatches=2)
    tokens = torch.zeros((1, S), dtype=torch.int32)
    with pytest.raises(ValueError, match="batch 1 does not split into 2"):
        step(params, step.init_opt_state(), {"tokens": tokens, "targets": tokens})


def test_rows_over_the_sequence():
    """Data row j takes the positions [j S / dp, (j + 1) S / dp) of every
    batch row; the specs at batch 1 split the sequence, at batch 2 the
    rows."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    policy = ShardingPolicy(mesh, _cfgs("llama3.2-1b")[1])
    rows = tp.rows_over_sequence(mesh, tp.data_rows(mesh, policy.dp), 1, 64)
    assert [(r.rows, r.span) for r in rows] == [((0, 1), Span(0, 32, 64)),
                                                ((0, 1), Span(32, 64, 64))]
    assert [r.coords for r in rows] == [((0, 0), (0, 1)), ((1, 0), (1, 1))]
    one = policy.batch_specs(base.ShapeConfig("p", 64, 1, "prefill"))
    two = policy.batch_specs(base.ShapeConfig("p", 64, 2, "prefill"))
    assert tp.splits_sequence(one, policy.dp) and not tp.splits_rows(one, policy.dp)
    assert tp.splits_rows(two, policy.dp) and not tp.splits_sequence(two, policy.dp)


def _bf16_run(arch, seed, sizes, seq=128, steps=3):
    """The reduced config in bf16 from seed ``seed``, ``steps`` steps on the
    token pipeline's batch-1 sequences of ``seq`` (an enc-dec config's
    beside ``ENCDEC_FRAMES * seq`` frames): split over a mesh of ``sizes``,
    or unsharded (``sizes`` None).  Returns (each step's loss,
    each param / m / v leaf's f64 norm after the steps)."""
    cfg = dataclasses.replace(base.get_reduced_config(arch), compute_dtype="bfloat16")
    model = Model(cfg, xent_impl="chunked", remat=True)
    params = model.init_params(torch.Generator().manual_seed(seed), device="cpu")
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=1,
                                   seed=seed)
    adamw = opt.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    if sizes is None:
        step, state = make_train_step(model, TrainStepConfig(adamw=adamw)), opt.init_state(params)
    else:
        policy = ShardingPolicy(make_mesh(sizes, ("data", "model"), device="cpu"), cfg)
        step = jit_train_step(model, policy, inp.abstract_params(model),
                              TrainStepConfig(adamw=adamw),
                              batch_specs=policy.batch_specs(base.ShapeConfig("t", seq, 1,
                                                                              "train")))
        params, state = reshard_tree(params, step.param_shardings), step.init_opt_state()
    losses = []
    for s in range(steps):
        batch = tok.device_batch(pipe, s, "cpu")
        if cfg.is_encdec:  # ENCDEC_FRAMES frames a token, ~ N(0, 1), from the seed and step
            batch["src_embeds"] = torch.randn(
                1, ENCDEC_FRAMES * seq, cfg.d_model,
                generator=torch.Generator().manual_seed(1000 * seed + s))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, [float(torch.linalg.vector_norm(pl.gather(x, "cpu").double()))
                    for t in (params, state.m, state.v) for x in leaves(t)]


def bf16_gaps(arch, seed, sizes=(2, 2)):
    """The batch-1 split against the unsharded step in bf16, relative, as
    ``chip_smoke.py``'s ``sharded_train`` reads them: (each step's loss gap,
    each param / m / v leaf's f64-norm gap)."""
    (losses, norms), (ulosses, unorms) = _bf16_run(arch, seed, sizes), _bf16_run(arch, seed,
                                                                                 None)
    rel = lambda a, b: [abs(x - y) / abs(y) if y else abs(x) for x, y in zip(a, b)]
    return rel(losses, ulosses), rel(norms, unorms)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b", "seamless-m4t-large-v2",
                                  "gemma3-1b"])
def test_bf16_gaps_of_the_split_within_the_chip_limits(arch):
    """The readings ``chip_smoke.py``'s batch-1 ``sharded_train`` limits were
    set from (``SEQ_SPLIT_LIMITS``, 3x the largest over 3 seeds:
    ``tests/torch_precision_readings.py``): the reduced config in bf16 on a
    (2, 2) CPU mesh at 1 x 128, 3 steps, seed 0, held within them (printed
    under ``-s``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    loss_rtol, norm_rtol, read = cs.SEQ_SPLIT_LIMITS.get(arch, cs.SHARDED_TP_LIMITS.get(arch))
    losses, norms = bf16_gaps(arch, 0)
    norm = max(norms) if read == "max" else float(np.median(norms))
    print(f"{arch} batch 1 split: loss gap {max(losses):.3g}, leaf-norm gap ({read}) {norm:.3g}")
    assert max(losses) <= loss_rtol and norm <= norm_rtol


# -- units --------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0), (True, 5, 0.0),
                                                   (True, 0, 30.0), (False, 0, 0.0),
                                                   (False, 7, 20.0)])
def test_attention_ref_at_a_query_offset_is_the_whole_attentions_rows(causal, window,
                                                                     softcap):
    """``attention_ref(q[:, a:b], k[:, :b], v[:, :b], q_offset=a)`` equals
    rows a:b of the whole attention within 1e-6 (GQA 6:2), for spans at 0,
    inside and at the end; so does the VJP of each span, summed, against
    the whole one's."""
    g = torch.Generator().manual_seed(0)
    B, T, H, K, h = 2, 23, 6, 2, 8
    q = torch.randn(B, T, H, h, generator=g, dtype=torch.float64)
    k = torch.randn(B, T, K, h, generator=g, dtype=torch.float64)
    v = torch.randn(B, T, K, h, generator=g, dtype=torch.float64)
    go = torch.randn(B, T, H, h, generator=g, dtype=torch.float64)
    geom = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    whole = attention_ref(*leaves, **geom)
    want = torch.autograd.grad(whole, leaves, go)
    spans = [(0, 9), (9, 17), (17, T)]
    got = [torch.zeros_like(t) for t in (q, k, v)]
    for a, b in spans:
        part = [q[:, a:b].clone().requires_grad_(True), k[:, :b].clone().requires_grad_(True),
                v[:, :b].clone().requires_grad_(True)]
        end = T if not causal else b
        if not causal:
            part[1:] = [k.clone().requires_grad_(True), v.clone().requires_grad_(True)]
        y = attention_ref(*part, q_offset=a, **geom)
        torch.testing.assert_close(y, whole[:, a:b], rtol=1e-6, atol=1e-6)
        grads = torch.autograd.grad(y, part, go[:, a:b])
        got[0][:, a:b] += grads[0]
        got[1][:, :end] += grads[1]
        got[2][:, :end] += grads[2]
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1024, 16, 4, 128, 0, 1024), (1, 256, 8, 1, 256, 2048, 256),
                                   (1, 129, 32, 8, 64, 0, 383)])
def test_an_offset_call_on_cuda_tensors_reaches_k5(shape, monkeypatch):
    """At a batch-1 span's shape (Llama-3-8B's second row, RecurrentGemma's,
    a ragged one) a CUDA call with a query offset goes to K5's wrapper,
    which checks it and reaches the kernel's build (no nvcc here: a
    stand-in raises there), never the plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: fake CUDA tensors would reach a real card")
    B, S, H, K, h, window, off = shape

    def reached(name):
        raise RuntimeError(f"reached the build of {name}")

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(build, "load", reached)
    monkeypatch.setattr(flash_ref, "attention_ref", forbidden)
    with FakeTensorMode():
        q = torch.empty(B, S, H, h, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(B, off + S, K, h, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="reached the build of flash_fwd"):
            flash_ops.flash_attention(q, kv, kv, window=window, q_offset=off)
        with pytest.raises(ValueError, match="q_offset"):
            short = kv.narrow(1, 0, off + S - 1)  # one key short of the last row's
            flash_kernel.flash_attention_fwd(q, short, short, q_offset=off)


def test_a_causal_offset_past_the_keys_raises():
    q = torch.zeros(1, 4, 2, 8)
    kv = torch.zeros(1, 6, 2, 8)
    flash_ops.flash_attention(q, kv, kv, q_offset=2)
    with pytest.raises(ValueError, match="q_offset 3"):
        flash_ops.flash_attention(q, kv, kv, q_offset=3)
    with pytest.raises(ValueError, match="q_offset -1"):
        flash_ops.flash_attention(q, kv, kv, causal=False, q_offset=-1)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_route_over_spans_with_carried_counts_is_the_whole_groups(arch):
    """Routing a group of 40 tokens in spans of 16, 8 and 16 with the
    carried per-expert counts gives the whole group's slots, keep mask and
    gates bit for bit, drops included (capacity 8); the aux loss from the
    carried sums equals the whole group's within 1e-6; a group boundary
    (groups of 8 in a sequence of 24) resets the counts."""
    cfg = _cfgs(arch)[1]
    g = torch.Generator().manual_seed(4)
    p = {"router": torch.randn(cfg.d_model, cfg.moe.num_experts, generator=g)}
    x = torch.randn(2, 40, cfg.d_model, generator=g)
    C = 8
    whole = moe.route(cfg, p, x, C)
    assert not bool(whole["keep"].all())
    counts, got = None, []
    for a, b in ((0, 16), (16, 24), (24, 40)):
        r = moe.route(cfg, p, x[:, a:b], C, counts)
        got.append(r)
        n = r["onehot_e"].sum(dim=(1, 2))
        counts = n if counts is None else counts + n
    for key in ("pos", "keep", "gate"):
        assert torch.equal(torch.cat([r[key] for r in got], dim=1), whole[key]), key
    # the aux loss from the carried sums, through plan_span at the whole group's capacity
    carry, n = None, x.shape[0] * x.shape[1]
    for a, b in ((0, 16), (16, 24), (24, 40)):
        pieces, carry = moe.plan_span(cfg, p, x[:, a:b], Span(a, b, 40), carry)
        assert [(pa, pb) for pa, pb, *_ in pieces] == [(0, b - a)]
    want = moe.aux_loss(cfg, moe.route(cfg, p, x, moe.capacity(cfg, 40)))
    torch.testing.assert_close(moe.aux_from_sums(cfg, carry["frac"], carry["prob"], n), want,
                               rtol=1e-6, atol=1e-6)
    # groups of 8 over a sequence of 24: a span from 4 to 20 is cut at 8 and 16
    pieces, carry = moe.plan_span(cfg, p, x[:, 4:20], Span(4, 20, 24), {"counts": counts},
                                  group_size=8)
    assert [(a, b) for a, b, *_ in pieces] == [(0, 4), (4, 12), (12, 16)]
    grouped = moe.route(cfg, p, moe.token_groups(x[:, :24], 8), moe.capacity(cfg, 8))
    first = grouped["pos"].reshape(2, 24, -1)[:, 8:16]
    assert torch.equal(pieces[1][2]["pos"], first)  # counts reset at position 8


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-7b", "recurrentgemma-9b"])
def test_the_unsharded_ops_walk_a_split_sequence(arch):
    """``Model.prefill_span`` and ``train_span`` with the unsharded ops
    (``LocalOps``) over spans of 12 and 20: the prompt's logits and every
    cache leaf (a ring of 16 that wraps, RWKV's and the RG-LRU's state) and
    the training loss equal the whole sequence's within 1e-5 (RWKV's spans
    scan in chunks of 6 and 5 where the whole sequence takes 8: the f32
    sums round apart by ~2e-6)."""
    model = _model(arch)
    params = _params(arch, model)
    tokens = torch.as_tensor(_reference(arch)[1]["tokens"])
    cache, logits = model.prefill(params, {"tokens": tokens}, 40)
    states, carry = model.init_cache(1, 40, "cpu"), None
    for a, b in ((0, 12), (12, S)):
        states, got, carry = model.prefill_span(params, {"tokens": tokens[:, a:b]}, 40, states,
                                                Span(a, b, S), carry)
        assert (got is None) == (b < S)
    torch.testing.assert_close(got, logits, rtol=PORT_TOL, atol=PORT_TOL)
    for layer, want in zip(states, cache):
        for name, x in layer.items():
            torch.testing.assert_close(x, want[name], rtol=PORT_TOL, atol=PORT_TOL)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    loss, _ = model.train_loss(params, batch)
    carry, total, count, aux = None, 0.0, 0.0, 0.0
    for a, b in ((0, 12), (12, S)):
        ce, n, a_, carry = model.train_span(params, {k: v[:, a:b] for k, v in batch.items()},
                                            Span(a, b, S), carry)
        total, count, aux = total + ce, count + n, aux + a_
    torch.testing.assert_close(total / count + aux, loss, rtol=PORT_TOL, atol=PORT_TOL)


def test_the_split_loss_is_the_whole_sequences_mean():
    """``Model.train_span`` over two spans (the unsharded ops): Σ CE sums /
    Σ mask totals equals ``train_loss``'s mean within 1e-6, with a mask
    that drops a third of the positions."""
    model = _model("llama3.2-1b")
    params = model.init_params(torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (1, S), generator=g),
             "targets": torch.randint(0, model.cfg.vocab_size, (1, S), generator=g),
             "mask": (torch.arange(S) % 3 != 0).float()[None]}
    loss, metrics = model.train_loss(params, batch)
    carry, total, count = None, 0.0, 0.0
    for a, b in ((0, 12), (12, S)):
        part = {k: v[:, a:b] for k, v in batch.items()}
        ce, n, aux, carry = model.train_span(params, part, Span(a, b, S), carry)
        total, count = total + ce, count + n
        assert float(aux) == 0.0
    assert float(count) == float(batch["mask"].sum())
    torch.testing.assert_close(total / count, metrics["ce"], rtol=1e-6, atol=1e-6)
