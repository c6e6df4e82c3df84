"""Training the Griffin, MoE and vision families on the port, against the
reference, on the CPU.

* ``Model.train_loss`` and every gradient leaf match the reference ``Model``
  at f32 compute for reduced RecurrentGemma-9B (5 layers: one (rglru,
  rglru, local) group and two remainder layers), Qwen2-MoE-A2.7B,
  Mixtral-8x7B (MoE on ``swa`` layers) and Qwen2-VL-7B (an ``embeds``
  batch), with remat off, ``"block"`` and ``"dots"``: the loss at 1e-5,
  ``metrics["aux"]`` (the MoE layers' Switch losses, summed) at 1e-6 and
  nonzero for the MoE families, and each gradient leaf within 1e-4 of its
  largest value (the RG-LRU's doubling scan sums in another order than
  ``associative_scan``).  The reference runs without remat: a remat policy
  chooses what is stored, not the function.
* Three ``make_train_step`` AdamW steps equal the reference's for
  Qwen2-MoE (2 microbatches) and RecurrentGemma (1).
* ``remat_policy="dots"`` gives ``"block"``'s gradients (1e-6), saves only
  ``aten.mm`` / ``aten.addmm`` outputs, as many a layer as the reference's
  layer has products without batch dimensions (``dot_general`` in its
  jaxpr: what ``dots_with_no_batch_dims_saveable`` saves), and runs the
  attention again in the recompute under both policies, as the reference
  runs its ``pallas_call`` again.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data import tokens as ref_tok
from repro.models import transformer as ref_transformer
from repro.models.transformer import Model as RefModel
from repro.train import optimizer as ref_opt
from repro.train.step import TrainStepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.data import tokens as tok
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import transformer
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainStepConfig, make_train_step, value_and_grad
from repro_torch.tree import flatten_with_paths

FAMILIES = ["recurrentgemma-9b", "qwen2-moe-a2.7b", "mixtral-8x7b", "qwen2-vl-7b"]
MOE = ("qwen2-moe-a2.7b", "mixtral-8x7b")
LOSS_TOL, AUX_TOL, GRAD_TOL, DOTS_TOL = 1e-5, 1e-6, 1e-4, 1e-6
XENT = dict(xent_impl="chunked", xent_chunk=96)
B, S = 2, 16
ADAMW = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


def _pair(arch, **changes):
    """(reference cfg, port cfg): the reduced config at f32 compute."""
    changes = {"compute_dtype": "float32", **changes}
    return (dataclasses.replace(ref_base.get_reduced_config(arch), **changes),
            dataclasses.replace(base.get_reduced_config(arch), **changes))


def _batch(cfg, seed=0):
    """numpy targets and tokens, or a vision config's embeds ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return batch


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's params for the reduced config, as numpy, drawn once
    a process by the jitted init (its eager init was this file's slowest
    part)."""
    rcfg, _ = _pair(arch)
    return jax.tree.map(np.asarray, jax.jit(RefModel(rcfg).init_params)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(params, loss, metrics, grads) of the reference, as numpy."""
    rcfg, _ = _pair(arch)
    rmodel = RefModel(rcfg, remat=False, **XENT)
    rparams = _ref_params(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(rmodel.train_loss, has_aux=True))(
        rparams, batch)
    return (rparams, float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def _port(arch, remat):
    """(loss, metrics, grads as the reference's numpy layout) of the port on
    the reference's params; ``remat`` None (off), "block" or "dots"."""
    rparams = _reference(arch)[0]
    _, cfg = _pair(arch)
    model = Model(cfg, remat=remat is not None, remat_policy=remat or "block", **XENT)
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    loss, metrics, grads = value_and_grad(model, params, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            convert.lm_params_to_numpy(grads, cfg))


def _leaves_close(got, want, rel):
    """Each leaf of ``got`` within ``rel`` (relative) and ``rel`` of the
    leaf's largest |value| of ``want``."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        w = np.asarray(w)
        np.testing.assert_allclose(flat_got[path], w, rtol=rel,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [None, "block", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference(arch, remat):
    _, rloss, rmetrics, rgrads = _reference(arch)
    loss, metrics, grads = _port(arch, remat)
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(metrics["ce"], rmetrics["ce"], rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(metrics["aux"], rmetrics["aux"], rtol=AUX_TOL, atol=AUX_TOL)
    assert (metrics["aux"] > 0) == (arch in MOE)
    np.testing.assert_allclose(loss, metrics["ce"] + metrics["aux"], rtol=1e-7)
    _leaves_close(grads, rgrads, GRAD_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_dots_gives_the_gradients_of_block(arch):
    lb, mb, gb = _port(arch, "block")
    ld, md, gd = _port(arch, "dots")
    assert (ld, md["aux"]) == (lb, mb["aux"])
    for path, g in jax.tree_util.tree_flatten_with_path(gb)[0]:
        got = dict(jax.tree_util.tree_flatten_with_path(gd)[0])[path]
        np.testing.assert_allclose(got, g, rtol=DOTS_TOL, atol=DOTS_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _dots_without_batch_dims(jaxpr) -> int:
    """``dot_general`` equations with no batch dimensions in a jaxpr and
    every jaxpr nested in it."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lhs_batch, _) = eqn.params["dimension_numbers"]
            n += not lhs_batch
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    n += _dots_without_batch_dims(sub)
    return n


def _reference_saved_per_layer(rcfg, rparams):
    """The products a reference layer of each kind has with no batch
    dimension: what its ``dots`` policy saves."""
    out = {}
    P = len(rcfg.block_pattern)
    x = jnp.zeros((B, S, rcfg.d_model), jnp.float32)
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    for pi, kind in enumerate(rcfg.block_pattern):
        layer = jax.tree.map(lambda a: a[0], rparams[f"g{pi}"]) if rcfg.num_layers >= P \
            else rparams[f"r{pi}"]
        jaxpr = jax.make_jaxpr(lambda p, x, kind=kind: ref_transformer._apply_block(
            rcfg, kind, p, x, positions=positions, attn_impl="ref", rwkv_chunk=8)[0])(
                layer, x)
        out[kind] = _dots_without_batch_dims(jaxpr.jaxpr)
    return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b", *FAMILIES])
def test_remat_dots_saves_the_products_without_batch_dims(arch, monkeypatch):
    """Which ops the policy saved in a training forward: ``mm`` / ``addmm``
    only, at least one, as many in each layer as the reference's layer of
    that kind has products with no batch dimension."""
    rcfg, cfg = _pair(arch)
    rparams = _ref_params(arch)
    want = _reference_saved_per_layer(rcfg, rparams)
    saved = collections.Counter()
    policy = transformer.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved[str(op)] += 1
        return decision

    monkeypatch.setattr(transformer, "dots_policy", recording)
    model = Model(cfg, remat_policy="dots", rwkv_chunk=8, **XENT)
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    value_and_grad(model, params, {k: torch.as_tensor(v) for k, v in _batch(cfg).items()})
    kinds = cfg.blocks()
    assert set(saved) <= {"aten.mm.default", "aten.addmm.default"} and saved
    assert sum(saved.values()) == sum(want[kind] for kind in kinds), (dict(saved), want)


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_attention_runs_again_in_the_recompute(policy, monkeypatch):
    """Each attention layer calls ``flash_attention`` (K5 on the card) twice
    a training step under either policy: once forward, once in the
    recompute.  Reduced Qwen2-MoE: 2 layers, so 4 calls."""
    calls = []
    real = flash_ops.flash_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    _, cfg = _pair("qwen2-moe-a2.7b")
    model = Model(cfg, remat_policy=policy, **XENT)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    value_and_grad(model, params, {k: torch.as_tensor(v) for k, v in _batch(cfg).items()})
    assert len(calls) == 2 * cfg.num_layers


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        Model(base.get_reduced_config("llama3.2-1b"), remat_policy="everything")


@pytest.mark.parametrize("arch,micro", [("qwen2-moe-a2.7b", 2), ("recurrentgemma-9b", 1)])
def test_three_adamw_steps_match_reference(arch, micro):
    """The losses (and, at one microbatch, ce, aux, grad norm and lr) of 3
    steps on the token pipeline's batches, then every param."""
    rcfg, cfg = _pair(arch)
    rmodel = RefModel(rcfg, remat=False, xent_impl="seq_chunked", xent_seq_chunk=8)
    model = Model(cfg, xent_impl="seq_chunked", xent_seq_chunk=8)
    rparams = _ref_params(arch)
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    rstep = jax.jit(ref_make_train_step(rmodel, RefStepConfig(
        microbatches=micro, adamw=ref_opt.AdamWConfig(**ADAMW))))
    step = make_train_step(model, TrainStepConfig(microbatches=micro,
                                                  adamw=opt.AdamWConfig(**ADAMW)))
    rstate, state = ref_opt.init_state(rparams), opt.init_state(params)
    pipe_ref = ref_tok.TokenPipelineConfig(vocab_size=rcfg.vocab_size, seq_len=S,
                                           global_batch=4)
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=4)
    for s in range(3):
        rparams, rstate, rm = rstep(rparams, rstate, {
            k: jnp.asarray(v) for k, v in ref_tok.batch_at_step(pipe_ref, s).items()})
        params, state, m = step(params, state, tok.device_batch(pipe, s, "cpu"))
        assert sorted(m) == sorted(rm)
        for key in rm:
            np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"step {s + 1} {key}")
    got = dict(flatten_with_paths(convert.lm_params_to_numpy(params, cfg)))
    for path, want in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        np.testing.assert_allclose(got[tuple(k.key for k in path)], np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
