"""The port's training slice against the reference, on the CPU.

* AdamW (``apply_adamw`` with :func:`decay_mask_like_reference`) on
  identical params and grads matches the reference's ``apply_adamw`` at
  1e-6 over 3 steps — a reduced config whose layers all sit in pattern
  groups and one with remainder layers (the reference decays every leaf of
  a grouped layer, norm scales included, because its mask reads the
  group-stacked ``ndim``).  The schedule, norm and clipping likewise.
* ``Model.train_loss`` and every gradient leaf match the reference
  ``Model`` at f32 compute, rtol = atol = 1e-4: reduced Llama, RWKV6 and
  gemma3, ``xent_impl`` naive / chunked / seq_chunked, remat on and off.
* The losses of 3 ``make_train_step`` steps match the reference's, with
  ``microbatches=2`` and ``grad_dtype="bfloat16"`` in one case each.

The reference draws the weights; ``convert`` carries them across as numpy
(``lm_params_from_numpy``) and back (``lm_params_to_numpy``).
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
from repro.data import tokens as ref_tok
from repro.models.transformer import Model as RefModel
from repro.train import optimizer as ref_opt
from repro.train.step import TrainStepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.data import tokens as tok
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, make_train_step, value_and_grad

OPT_TOL = 1e-6
LOSS_TOL = 1e-4
ADAMW = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
ref_apply_adamw = jax.jit(ref_opt.apply_adamw, static_argnums=0)


def _pair(arch, **changes):
    """(reference cfg, port cfg): the reduced config with ``changes``."""
    return (dataclasses.replace(ref_base.get_reduced_config(arch), **changes),
            dataclasses.replace(base.get_reduced_config(arch), **changes))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_params(rcfg, seed):
    """numpy params in the reference's (group-stacked) layout for ``rcfg``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(RefModel(rcfg).init_params, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_trees_close(got, want, tol):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------------- optimizer
OPT_CONFIGS = {
    "grouped": ("llama3.2-1b", {}),  # 2 layers, both in pattern groups
    "remainder": ("gemma3-1b", {"num_layers": 8}),  # 1 group of 6 + 2 remainder
}


@pytest.mark.parametrize("which", sorted(OPT_CONFIGS))
def test_adamw_matches_reference_with_its_decay_mask(which):
    arch, changes = OPT_CONFIGS[which]
    rcfg, cfg = _pair(arch, **changes)
    rparams = _random_params(rcfg, 1)
    rstate = ref_opt.init_state(rparams)
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    state = opt.init_state(params)
    acfg_ref, acfg = ref_opt.AdamWConfig(**ADAMW), opt.AdamWConfig(**ADAMW)
    rng = np.random.default_rng(2)
    for step in range(3):
        grads_np = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, rparams)
        rparams, rstate, rm = ref_apply_adamw(acfg_ref, rparams, grads_np, rstate)
        grads = convert.lm_params_from_numpy(grads_np, cfg, device="cpu")
        params, state, m = opt.apply_adamw(
            acfg, params, grads, state,
            decay_mask=opt.decay_mask_like_reference(cfg, params))
        assert int(state.step) == int(rstate.step) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=OPT_TOL)
    _assert_trees_close(convert.lm_params_to_numpy(params, cfg), rparams, OPT_TOL)
    _assert_trees_close(convert.lm_params_to_numpy(state.m, cfg), rstate.m, OPT_TOL)
    _assert_trees_close(convert.lm_params_to_numpy(state.v, cfg), rstate.v, OPT_TOL)


def test_decay_mask_follows_the_stacked_layout():
    _, cfg = _pair("gemma3-1b", num_layers=8)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    mask = opt.decay_mask_like_reference(cfg, params)
    assert mask["embed"] is True and mask["final_norm"]["scale"] is False
    assert all(mask["layers"][li]["norm1"]["scale"] is True for li in range(6))
    assert mask["layers"][6]["norm1"]["scale"] is False  # remainder layer
    assert mask["layers"][7]["attn"]["wq"] is True


def test_adamw_state_carries_across_and_continues():
    """A reference state after one step, carried across, steps on equally."""
    rcfg, cfg = _pair("gemma3-1b", num_layers=8)
    rparams = _random_params(rcfg, 3)
    acfg_ref, acfg = ref_opt.AdamWConfig(**ADAMW), opt.AdamWConfig(**ADAMW)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                          rparams) for _ in range(2)]
    rparams, rstate, _ = ref_apply_adamw(acfg_ref, rparams, grads[0],
                                         ref_opt.init_state(rparams))
    params = convert.lm_params_from_numpy(_np(rparams), cfg, device="cpu")
    state = convert.adamw_state_from_numpy(_np(rstate), cfg, device="cpu")
    rparams, rstate, _ = ref_apply_adamw(acfg_ref, rparams, grads[1], rstate)
    params, state, _ = opt.apply_adamw(
        acfg, params, convert.lm_params_from_numpy(grads[1], cfg, device="cpu"), state,
        decay_mask=opt.decay_mask_like_reference(cfg, params))
    _assert_trees_close(convert.lm_params_to_numpy(params, cfg), rparams, OPT_TOL)
    _assert_trees_close(convert.lm_params_to_numpy(state.v, cfg), rstate.v, OPT_TOL)


def test_schedule_norm_and_clip_match_reference():
    acfg_ref, acfg = ref_opt.AdamWConfig(**ADAMW), opt.AdamWConfig(**ADAMW)
    for s in (0, 1, 2, 3, 7, 10, 15):
        np.testing.assert_allclose(
            float(opt.lr_schedule(acfg, torch.tensor(s, dtype=torch.int32))),
            float(ref_opt.lr_schedule(acfg_ref, jnp.asarray(s, jnp.int32))), rtol=OPT_TOL)
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32) * 3]}
    clipped, norm = opt.clip_by_global_norm(jax.tree.map(torch.as_tensor, tree), 1.0)
    rclipped, rnorm = ref_opt.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=OPT_TOL)
    _assert_trees_close(jax.tree.map(lambda t: t.numpy(), clipped), rclipped, OPT_TOL)


# ----------------------------------------------------------------- train_loss
ARCHS = ["llama3.2-1b", "rwkv6-7b", "gemma3-1b"]
XENT = dict(xent_chunk=96, xent_seq_chunk=8, rwkv_chunk=8)


def _batch(vocab, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch, xent_impl):
    rcfg, _ = _pair(arch, compute_dtype="float32")
    rmodel = RefModel(rcfg, xent_impl=xent_impl, **XENT)
    rparams = rmodel.init_params(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg.vocab_size).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(rmodel.train_loss, has_aux=True))(
        rparams, batch)
    return _np(rparams), float(loss), float(metrics["ce"]), _np(grads)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("xent_impl", ["naive", "chunked", "seq_chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, xent_impl, remat):
    rparams, rloss, rce, rgrads = _reference_loss_and_grads(arch, xent_impl)
    _, cfg = _pair(arch, compute_dtype="float32")
    model = Model(cfg, xent_impl=xent_impl, remat=remat, **XENT)
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    loss, metrics, grads = value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(loss), rloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["ce"]), rce, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert float(metrics["aux"]) == 0.0
    _assert_trees_close(convert.lm_params_to_numpy(grads, cfg), rgrads, LOSS_TOL)


def test_train_loss_honours_the_mask():
    _, cfg = _pair("llama3.2-1b", compute_dtype="float32")
    model = Model(cfg, xent_impl="seq_chunked", xent_seq_chunk=8)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    mask = torch.zeros(batch["targets"].shape)
    mask[:, :5] = 1.0
    masked, _ = model.train_loss(params, {**batch, "mask": mask})
    cut = {k: v[:, :5] for k, v in batch.items()}  # causal: the first 5 see only themselves
    np.testing.assert_allclose(float(masked), float(model.train_loss(params, cut)[0]),
                               rtol=1e-6)


# ----------------------------------------------------------------- train step
STEP_CASES = {
    "llama-1mb-f32": ("llama3.2-1b", 1, "float32"),
    "rwkv-2mb-f32": ("rwkv6-7b", 2, "float32"),
    "llama-2mb-bf16": ("llama3.2-1b", 2, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_train_steps_match_reference(case):
    arch, micro, gdt = STEP_CASES[case]
    rcfg, cfg = _pair(arch, compute_dtype="float32")
    rmodel = RefModel(rcfg, xent_impl="seq_chunked", **XENT)
    model = Model(cfg, xent_impl="seq_chunked", **XENT)
    rparams = rmodel.init_params(jax.random.PRNGKey(7))
    params = convert.lm_params_from_numpy(_np(rparams), cfg, device="cpu")
    rstep = jax.jit(ref_make_train_step(rmodel, RefStepConfig(
        microbatches=micro, grad_dtype=gdt, adamw=ref_opt.AdamWConfig(**ADAMW))))
    step = make_train_step(model, TrainStepConfig(
        microbatches=micro, grad_dtype=gdt, adamw=opt.AdamWConfig(**ADAMW)))
    rstate, state = ref_opt.init_state(rparams), opt.init_state(params)
    pipe_ref = ref_tok.TokenPipelineConfig(vocab_size=rcfg.vocab_size, seq_len=16,
                                           global_batch=4)
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    for s in range(3):
        rparams, rstate, rm = rstep(rparams, rstate, {
            k: jnp.asarray(v) for k, v in ref_tok.batch_at_step(pipe_ref, s).items()})
        params, state, m = step(params, state, tok.device_batch(pipe, s, "cpu"))
        assert sorted(m) == sorted(rm)
        for key in rm:
            np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"step {s + 1} {key}")
