"""The enc-dec encoder's sequence split at batch 1, on CPU meshes, against
the reference and the port's unsharded path.

At ``global_batch=1`` the batch specs split ``src_embeds`` on the frames over
the data axes (``P(None, dp, None)``), as they split the decoder's tokens.
The port's ``jit_prefill_step`` and ``jit_train_step`` give data row j the
frames ``[j T / dp, (j + 1) T / dp)`` and walk the encoder layer by layer
across the rows (``Model.encode_spans``): every row's K/V of a layer first,
then every row's queries over all rows' K/V (K5's plain version without the
mask), so no call encodes the whole ``(1, T, D)``; the decoder's cross
sub-blocks read the memory's spans joined on their device.  Reduced
Seamless-M4T-large-v2 at f32 compute, the reference's weights carried
across (``convert.lm_params_from_numpy``), meshes (2, 1), (2, 2) and (4, 1)
of one CPU repeated, ``T`` frames and ``S`` tokens:

* the prefill's logits and every cache leaf, then 2 decode steps with the
  memory, within 1e-5 of the reference's jitted steps and of the port's
  unsharded path; the flash wrapper called on each row's ``T / dp`` queries
  over all ``T`` frames, ``encoder_layers x model x data`` times, and
  ``Model.encode`` never;
* two ``jit_train_step`` steps: the losses within 1e-5 of the reference's
  one-microbatch step and of the port's unsharded step, and every param, m
  and v leaf within 1e-5 of the port's unsharded step's and of the
  reference's, the params with ``test_torch_sharded_train.py``'s allowance
  of a learning rate a step where that step's v says the gradient's RMS is
  under 1e-6 (AdamW turns the f32 noise of a gradient of ~1e-8 into a move
  of up to a learning rate);
* ``encode_spans`` on (2, 2): the spans joined equal ``Model.encode``, and
  the gradients of ``src_embeds`` and of every encoder weight through the
  rows (under remat and without) equal the whole encode's, at 1e-5; every
  row's K/V of a layer is computed before any row's attention of it;
* ``T = 30`` frames over 4 data rows raise in the port's steps (the
  reference's jit raises too: ``test_torch_seq_parallel.py``).
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
from repro.train import optimizer as ref_opt
from repro.train.step import TrainStepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.ft.resilience import reshard_tree
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import LocalOps, Model, Span
from repro_torch.serve.step import (jit_decode_step, jit_prefill_step, make_decode_step,
                                    make_prefill_step)
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, jit_train_step, make_train_step
from repro_torch.tree import leaves
from test_torch_sharded_serve import assert_placed_as
from test_torch_sharded_train import ADAMW, _assert_leaves_close, _whole

ARCH = "seamless-m4t-large-v2"
MESHES = {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}
T, S, MAX_SEQ, STEPS = 32, 16, 24, 2  # frames, prompt tokens, cache slots, decode steps
TOL = 1e-5


def _cfgs():
    return (dataclasses.replace(ref_base.get_reduced_config(ARCH), compute_dtype="float32"),
            dataclasses.replace(base.get_reduced_config(ARCH), compute_dtype="float32"))


def _model():
    return Model(_cfgs()[1], xent_impl="seq_chunked", xent_seq_chunk=8)


@functools.lru_cache(maxsize=None)
def _reference():
    """(reference params as numpy, the prompt {tokens, src_embeds}, the
    tokens fed to the decode steps, the train batches, the reference's
    logits of the prefill and each decode step, its params, m and v after
    two train steps, their losses, and its v after each step)."""
    rcfg, cfg = _cfgs()
    rmodel = RefModel(rcfg, xent_impl="seq_chunked", xent_seq_chunk=8)
    rng = np.random.default_rng(5)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32),
              "src_embeds": rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)}
    fed = [np.full((1, 1), 7 + i, np.int32) for i in range(STEPS)]
    batches = [dict(prompt, targets=rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32))
               for _ in range(2)]
    batches[1] = {k: np.roll(v, 5, axis=1) for k, v in batches[1].items()}
    rparams = jax.jit(rmodel.init_params)(jax.random.PRNGKey(0))
    jprompt = {k: jnp.asarray(v) for k, v in prompt.items()}
    cache, logits = jax.jit(ref_make_prefill_step(rmodel, MAX_SEQ))(rparams, jprompt)
    memory = jax.jit(rmodel.encode)(rparams, jprompt["src_embeds"])
    decode = jax.jit(ref_make_decode_step(rmodel, MAX_SEQ, with_memory=True))
    out = [np.asarray(logits)]
    for step, tok in enumerate(fed):
        _, logits, cache = decode(rparams, cache, jnp.asarray(tok),
                                  jnp.full((1,), S + step, jnp.int32), memory)
        out.append(np.asarray(logits))
    train = jax.jit(ref_make_train_step(rmodel, RefStepConfig(
        microbatches=1, adamw=ref_opt.AdamWConfig(**ADAMW))))
    params, state, losses, vs = rparams, ref_opt.init_state(rparams), [], []
    for b in batches:
        params, state, m = train(params, state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
        vs.append(jax.tree.map(np.asarray, state.v))
    trained = jax.tree.map(np.asarray, (params, state.m, state.v))
    return jax.tree.map(np.asarray, rparams), prompt, fed, batches, out, trained, losses, vs


def _params(model):
    return convert.lm_params_from_numpy(_reference()[0], model.cfg, device="cpu")


def _torch(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _unsharded():
    """The port's unsharded prefill (logits, cache) and decode steps' logits
    with the memory, and two train steps (params, state, losses, v after
    each step in the reference's layout)."""
    model = _model()
    params = _params(model)
    _, prompt, fed, batches, *_ = _reference()
    batch = _torch(prompt)
    cache, logits = make_prefill_step(model, MAX_SEQ)(params, batch)
    prefilled = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    memory, decode, out = model.encode(params, batch["src_embeds"]), make_decode_step(
        model, MAX_SEQ), [logits]
    for step, tok in enumerate(fed):
        _, logits, cache = decode(params, cache, torch.as_tensor(tok),
                                  torch.full((1,), S + step, dtype=torch.int32), memory)
        out.append(logits)
    step = make_train_step(model, TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW)))
    state, losses, vs = opt.init_state(params), [], []
    for b in batches:
        params, state, m = step(params, state, _torch(b))
        losses.append(float(m["loss"]))
        vs.append(jax.tree.map(np.copy, convert.lm_params_to_numpy(state.v, model.cfg)))
    return out, prefilled, params, state, losses, vs


def _policy(model, sizes):
    return ShardingPolicy(make_mesh(sizes, ("data", "model"), device="cpu"), model.cfg)


def _serving_steps(model, sizes, frames=T):
    policy = _policy(model, sizes)
    aparams, acache = inp.abstract_params(model), inp.abstract_cache(model, 1, MAX_SEQ)
    specs = policy.batch_specs(base.ShapeConfig("p", S, 1, "prefill"))
    return (jit_prefill_step(model, policy, aparams, acache, specs, 1, MAX_SEQ),
            jit_decode_step(model, policy, aparams, acache, 1, MAX_SEQ, with_memory=True))


def _train_step(model, sizes):
    policy = _policy(model, sizes)
    return jit_train_step(model, policy, inp.abstract_params(model),
                          TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW)),
                          batch_specs=policy.batch_specs(base.ShapeConfig("t", S, 1, "train")))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_encoder_split_prefill_and_decode(mesh, monkeypatch):
    """The split prefill (the frames' spans encoded over the rows) and 2
    decode steps with the memory against the reference and the unsharded
    path; the flash wrapper on each row's span of the frames over all of
    them, and no whole encode."""
    dp, n_model = MESHES[mesh]
    model = _model()
    cfg = model.cfg
    _, prompt, fed, _, ref_logits, *_ = _reference()
    u_logits, u_cache, *_ = _unsharded()
    prefill, decode = _serving_steps(model, MESHES[mesh])
    assert prefill.split_seq and not prefill.split_rows
    params = reshard_tree(_params(model), prefill.param_shardings)
    calls, real = [], flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention", lambda q, k, v, **kw: calls.append(
        (q.shape[1], k.shape[1], kw["causal"], kw.get("q_offset", 0))) or real(q, k, v, **kw))
    monkeypatch.setattr(Model, "encode", lambda *a, **k: pytest.fail("a whole encode"))
    cache, logits = prefill(params, _torch(prompt))
    monkeypatch.setattr(flash_ops, "flash_attention", real)
    assert_placed_as(cache, decode.cache_shardings)
    for layer, want in zip(cache, u_cache):
        for name, x in layer.items():
            _close(pl.gather(x, "cpu"), want[name])
    memory = torch.cat(tp.encode_over_rows(model, params, torch.as_tensor(prompt["src_embeds"]),
                                           prefill.mesh, prefill.coords_by_row), dim=1)
    out = [logits]
    for step, tok in enumerate(fed):
        _, logits, cache = decode(params, cache, torch.as_tensor(tok), S + step, memory)
        out.append(logits)
    for got, want, ref in zip(out, u_logits, ref_logits):
        _close(got, want)
        _close(got, ref)
    # the encoder: each row's T / dp queries over all T frames, a layer a
    # coordinate a row; the cross sub-blocks: each row's S / dp tokens over T
    per_t, per_s = T // dp, S // dp
    encoder = [c for c in calls if c == (per_t, T, False, 0)]
    assert len(encoder) == cfg.encoder_layers * n_model * dp
    assert not [c for c in calls if c[0] == T]
    cross = [c for c in calls if c == (per_s, T, False, 0)]
    assert len(cross) == cfg.num_layers * n_model * dp
    assert len(calls) == (cfg.encoder_layers + 2 * cfg.num_layers) * n_model * dp


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_encoder_split_train_steps(mesh, monkeypatch):
    """Two split train steps, the frames encoded over the rows inside the
    one backward, against the reference's one-microbatch step and the
    port's unsharded step."""
    model = _model()
    cfg = model.cfg
    _, _, _, batches, _, (want_p, want_m, want_v), want_losses, want_vs = _reference()
    _, _, uparams, ustate, ulosses, uvs = _unsharded()
    step = _train_step(model, MESHES[mesh])
    assert step.split_seq
    monkeypatch.setattr(Model, "encode", lambda *a, **k: pytest.fail("a whole encode"))
    params = reshard_tree(_params(model), step.param_shardings)
    state, losses = step.init_opt_state(), []
    for b in batches:
        params, state, m = step(params, state, _torch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=TOL)
    np.testing.assert_allclose(losses, ulosses, rtol=TOL)
    for got, want in ((params, uparams), (state.m, ustate.m), (state.v, ustate.v)):
        _assert_leaves_close(_whole(got), convert.lm_params_to_numpy(want, cfg), cfg, TOL, 1.0,
                             step_vs=uvs if got is params else ())
    _assert_leaves_close(_whole(params), want_p, cfg, TOL, 1.0, step_vs=want_vs)
    _assert_leaves_close(_whole(state.m), want_m, cfg, TOL, 1.0)
    _assert_leaves_close(_whole(state.v), want_v, cfg, TOL, 1.0)


def _rows(sizes=(2, 2)):
    mesh = make_mesh(sizes, ("data", "model"), device="cpu")
    return mesh, tp.data_rows(mesh, ("data",))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_encode_spans_equal_the_whole_encode_and_its_gradients(remat):
    """``encode_over_rows`` on (2, 2): the spans joined equal
    ``Model.encode`` within 1e-5, and so do the gradients of ``src_embeds``
    and of every encoder weight (each coordinate's blocks gathered) of a
    random projection of the memory."""
    model = _model()
    cfg = model.cfg
    whole = _params(model)
    mesh, coords = _rows()
    policy = ShardingPolicy(mesh, cfg)
    placed = reshard_tree(whole, policy.shardings(policy.param_specs(whole)))
    src = torch.as_tensor(_reference()[1]["src_embeds"])
    proj = torch.randn(1, T, cfg.d_model, generator=torch.Generator().manual_seed(9))

    def grads(params, tensors, run):
        x = src.clone().requires_grad_(True)
        for t in tensors:
            t.requires_grad_(True)
        try:
            memory = run(params, x)
            got = torch.autograd.grad((memory * proj).sum(), [x] + tensors)
        finally:
            for t in tensors:
                t.requires_grad_(False)
        return memory.detach(), got

    want_mem, want = grads(whole, leaves(whole["enc_layers"]),
                           lambda p, x: model.encode(p, x, remat=remat))
    rows = tp.rows_over_sequence(mesh, coords, 1, T)
    # every block a row reads, each once, as the train step asks for them
    reads = []
    for x in leaves(placed["enc_layers"]):
        mine = {}
        for row in rows:
            mine.update({id(t): (b, t) for b, t in tp.row_tensors(x, row)})
        reads.append(list(mine.values()))
    got_mem, got = grads(placed, [t for r in reads for _, t in r], lambda p, x: torch.cat(
        tp.encode_over_rows(model, p, x, mesh, coords, remat=remat), dim=1))
    torch.testing.assert_close(got_mem, want_mem, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got[0], want[0], rtol=TOL, atol=TOL)
    i = 1
    for x, read, w in zip(leaves(placed["enc_layers"]), reads, want[1:]):
        g = torch.zeros(x.shape)  # each block's gradient into its region, copies summed
        for (b, _), gb in zip(read, got[i:i + len(read)]):
            g[tuple(slice(a, e) for a, e in x.sharding.region(b, x.shape))] += gb
        i += len(read)
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_every_rows_kv_of_a_layer_precedes_any_rows_attention(monkeypatch):
    """The walk's order on (2, 2), forward: for each layer, row 0's and row
    1's K/V, then row 0's and row 1's attention; a walk that ran a row's
    attention before a later row's K/V of the same layer reads a K/V list
    short of that row and gives another order."""
    model = _model()
    cfg = model.cfg
    mesh, coords = _rows()
    params = reshard_tree(_params(model), ShardingPolicy(mesh, cfg).shardings(
        ShardingPolicy(mesh, cfg).param_specs(_params(model))))
    events, real_kv, real_attend = [], tp.encoder_kv, tp.attention_encode_rows

    def kv(cfg_, p, h, positions, row):
        events.append(("kv", id(p["wk"]), row.span.start))
        return real_kv(cfg_, p, h, positions, row)

    def attend(cfg_, p, h, positions, row, kvs):
        events.append(("attend", id(p["wk"]), row.span.start, len(kvs)))
        return real_attend(cfg_, p, h, positions, row, kvs)

    monkeypatch.setattr(tp, "encoder_kv", kv)
    monkeypatch.setattr(tp, "attention_encode_rows", attend)
    with torch.no_grad():
        tp.encode_over_rows(model, params, torch.as_tensor(_reference()[1]["src_embeds"]),
                            mesh, coords)
    half = T // 2
    want = []
    for layer in params["enc_layers"]:
        w = id(layer["attn"]["wk"])
        want += [("kv", w, 0), ("kv", w, half), ("attend", w, 0, 2), ("attend", w, half, 2)]
    assert events == want


def test_local_ops_walk_the_spans_of_the_whole_encode():
    """``Model.encode_spans`` with the unsharded ops (``LocalOps``) over
    spans of 12 and 20 frames: the spans joined equal ``Model.encode``
    within 1e-5, with and without remat."""
    model = _model()
    params = _params(model)
    src = torch.as_tensor(_reference()[1]["src_embeds"])
    want = model.encode(params, src)
    spans = [Span(0, 12, T), Span(12, T, T)]
    for remat in (False, True):
        got = model.encode_spans(params, [src[:, sp.start:sp.stop] for sp in spans], spans,
                                 [LocalOps(model.cfg)] * 2, remat=remat)
        torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=TOL, atol=TOL)


def test_frames_the_data_rows_do_not_divide_raise():
    """30 frames over 4 data rows raise in the port's prefill and train
    steps, where the prompt of 16 tokens divides (the reference's jit raises
    on them too: ``test_torch_seq_parallel.py``)."""
    model = _model()
    params = _params(model)
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (1, S), generator=g),
             "src_embeds": torch.randn(1, 30, model.cfg.d_model, generator=g)}
    prefill, _ = _serving_steps(model, (4, 1))
    with pytest.raises(ValueError, match="sequence of 30 does not split over 4"):
        prefill(params, batch)
    step = _train_step(model, (4, 1))
    with pytest.raises(ValueError, match="sequence of 30 does not split over 4"):
        step(params, step.init_opt_state(), dict(batch, targets=batch["tokens"]))
