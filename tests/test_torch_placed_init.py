"""A model drawn straight into its blocks: ``Model.init_params(shardings=)``.

* On CPU meshes (1, 2), (1, 4) and (2, 2) of one CPU repeated, for reduced
  Mixtral-8x7B (MoE, sliding window), Gemma3-1B (a tied table) and
  Seamless-M4T-large-v2 (``enc_layers``): the placed draw is
  ``reshard_tree(init_params(...), shardings)`` leaf for leaf and block for
  block, bit for bit, with and without ``store_dtype``; every block owns
  its storage, so no block keeps a drawn whole tensor alive.
* The draws come in one order whatever the depth: the embeddings, the
  final norm and the first L layers of a model from one seed equal those of
  a deeper one from the same seed (what ``chip_smoke.py``'s
  ``mixtral_sharded`` relies on to hold Mixtral's 8-layer prefix against
  its unsharded path).
* Reduced Mixtral's sharded prefill and decode logits on (1, 4)
  (``jit_prefill_step`` / ``jit_decode_step``) are bit-equal whether the
  params come from the placed draw or from ``reshard_tree``.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.ft.resilience import reshard_tree
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model
from repro_torch.serve.step import jit_decode_step, jit_prefill_step
from repro_torch.sharding import placement as pl
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.tree import flatten_with_paths

ARCHS = ("mixtral-8x7b", "gemma3-1b", "seamless-m4t-large-v2")
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SEED = 3


def _model(arch, **changes):
    return Model(dataclasses.replace(base.get_reduced_config(arch), **changes))


def _policy(model, shape):
    return ShardingPolicy(make_mesh(shape, ("data", "model"), device="cpu"), model.cfg)


def _param_shardings(policy, model):
    return policy.shardings(policy.param_specs(inp.abstract_params(model)))


def _draw(model, **kw):
    return model.init_params(torch.Generator().manual_seed(SEED), device="cpu", **kw)


def _assert_same_blocks(got, want):
    flat_got, flat_want = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, x), (_, y) in zip(flat_got, flat_want):
        assert isinstance(x, pl.Placed) and isinstance(y, pl.Placed), path
        assert (x.sharding, x.shape, x.dtype) == (y.sharding, y.shape, y.dtype), path
        assert x.store.keys() == y.store.keys(), path
        for key, t in x.store.items():
            assert t.dtype == y.store[key].dtype and torch.equal(t, y.store[key]), (path, key)
            # a block of its own: no view of a drawn whole tensor
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), (path, key)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_draw_is_the_whole_draw_resharded(arch, mesh):
    model = _model(arch)
    shardings = _param_shardings(_policy(model, MESHES[mesh]), model)
    _assert_same_blocks(_draw(model, shardings=shardings),
                        reshard_tree(_draw(model), shardings))


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_draw_stored_in_the_compute_dtype(arch):
    """With ``store_dtype``: each leaf stored, then placed, as storing the
    whole tree and then resharding it (the F32 leaves kept in f32)."""
    model = _model(arch)
    shardings = _param_shardings(_policy(model, MESHES["1x4"]), model)
    placed = _draw(model, store_dtype=torch.bfloat16, shardings=shardings)
    _assert_same_blocks(placed, reshard_tree(_draw(model, store_dtype=torch.bfloat16),
                                             shardings))
    dtypes = {x.dtype for _, x in flatten_with_paths(placed)}
    assert dtypes == {torch.bfloat16, torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_the_first_layers_do_not_depend_on_the_depth(arch):
    """Embeddings, final norm and the first L layers: the same draws at L
    layers and at L + 2 (the encoder's, drawn after the decoder's, are not
    part of the property)."""
    L = base.get_reduced_config(arch).num_layers
    short, deep = _draw(_model(arch)), _draw(_model(arch, num_layers=L + 2))
    assert len(deep["layers"]) == L + 2
    tops = [k for k in short if k not in ("layers", "enc_layers")]
    assert "embed" in tops and "final_norm" in tops
    assert ("unembed" in tops) != base.get_reduced_config(arch).tie_embeddings
    for key in tops + ["layers"]:
        a, b = flatten_with_paths(short[key]), flatten_with_paths(deep[key][:L]
                                                                  if key == "layers"
                                                                  else deep[key])
        assert [p for p, _ in a] == [p for p, _ in b], key
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b)), key


def test_mixtral_sharded_logits_from_the_placed_draw_are_bit_equal():
    """Reduced Mixtral on (1, 4): 2 prompts of 20 tokens (past the window of
    16), ``max_seq`` 32, a prefill and 4 greedy decode steps, from the placed
    draw and from ``reshard_tree`` of the whole draw: every logit equal."""
    B, S, max_seq = 2, 20, 32
    model = _model("mixtral-8x7b", compute_dtype="float32")
    policy = _policy(model, MESHES["1x4"])
    aparams, acache = inp.abstract_params(model), inp.abstract_cache(model, B, max_seq)
    specs = policy.batch_specs(base.ShapeConfig("prefill", S, B, "prefill"))
    prefill = jit_prefill_step(model, policy, aparams, acache, specs, B, max_seq)
    decode = jit_decode_step(model, policy, aparams, acache, B, max_seq)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32))

    def run(params):
        cache, logits = prefill(params, {"tokens": tokens})
        out, tok = [logits], torch.argmax(logits, -1)[:, None].to(torch.int32)
        for pos in range(S, S + 4):
            tok, logits, cache = decode(params, cache, tok, pos)
            out.append(logits)
        return out

    placed = run(_draw(model, shardings=prefill.param_shardings))
    resharded = run(reshard_tree(_draw(model), prefill.param_shardings))
    assert len(placed) == 5
    assert all(torch.equal(a, b) for a, b in zip(placed, resharded))
