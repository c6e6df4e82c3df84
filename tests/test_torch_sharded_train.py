"""The sharded train step, placements and elastic resume, on CPU meshes.

The port's counterpart of ``tests/test_sharding_multidevice.py`` (whose
8-device subprocess is a reference-side failure on this tree's jax): the
same four reduced families (Llama-3.2-1B and Mixtral-8x7B here,
RecurrentGemma-9B and RWKV6-7B in
``tests/test_torch_sharded_train_recurrent.py``), f32 compute, the
reference's weights carried across (``convert``), meshes of one CPU
repeated:

* two steps of ``jit_train_step`` on ("data", "model") meshes (2, 2),
  (4, 1) and (1, 4), batch 4 x 16 split over the data axis, against the
  reference's ``make_train_step(TrainStepConfig(microbatches=dp))``:
  losses within 1e-5 relative; after each step, every leaf of AdamW's m
  and v within rtol 1e-4 and atol 1e-4 of the leaf's largest |value| (the
  LM path's gradient tolerance, as ``chip_smoke.py``'s ``_grads_close``) of
  the reference's step from the same state (the sharded step's state
  before it, carried across): two steps compounded put m and v at the f32
  noise floor, since AdamW's first update of a weight whose gradient
  cancels to f32 rounding is itself rounding, and every later gradient
  reads that weight (the reduced RWKV6's unsharded port step sits at 0.99
  of the tolerance after two compounded steps, and at 1.05 with an
  equal wkv chunk of 16 in place of 8); every param
  within rtol 1e-4 and atol 1e-4 of the larger of 1 and its leaf's largest
  |value|, plus the summed learning rate for a weight whose gradients' RMS
  over the steps is under 1e-6 (100 x AdamW's eps): AdamW divides its
  near-zero m by a near-zero sqrt(v), so f32 rounding of a gradient that
  cancels decides its update (one of Mixtral's embedding weights at two
  microbatches: m 1.2e-9 against 2.4e-9, v 7e-18, update 1.2e-4 apart; the
  port's  unsharded step alike).  Against the port's own unsharded step
  with ``dp`` microbatches: at a model axis of 1, step 1's loss is
  bit-equal and every leaf after 2 steps is within 1e-6 of the larger of 1
  and its largest |value| (the same sums; only the global norm adds its
  parts in another order, which moves the clipping scale by an f32
  rounding); at a model axis of 2 or 4 (tensor parallel: the partial
  outputs of attention, the FFNs and the lookup summed in f32 in
  coordinate order) the losses within 1e-6 relative and every leaf within
  1e-5 of the same scale, plus for a param the learning rate of each step
  after which the unsharded step's v says the gradient's RMS so far is
  under 1e-6 (a step-1 gradient of 3e-9 that cancels: its update's sign
  and size are f32 rounding);
* after the steps every leaf keeps its placement, and each coordinate
  holds exactly the bytes its spec says (the ZeRO-1 moments included);
* ``place`` / ``gather`` / ``reshard_tree`` round-trip bit for bit, and
  ``gather``'s backward hands each block its own gradient;
* elastic resume: 2 steps on (2, 2), ``save``, ``restore(shardings=)``
  onto (4, 1) (leaves bit-equal to the saved ones), 2 more steps: equal to
  the reference's 2 + 2 steps at microbatches 2 then 4.
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
from repro.train import optimizer as ref_opt
from repro.train.step import TrainStepConfig as RefStepConfig
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base
from repro_torch.ft.resilience import reshard_tree
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model
from repro_torch.sharding import placement as pl
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.train import optimizer as opt
from repro_torch.train.step import (TrainStepConfig, jit_train_step, make_train_step,
                                    microbatches)
from repro_torch.tree import flatten_with_paths, leaves, tree_map

# the families of tests/test_sharding_multidevice.py; RecurrentGemma and
# RWKV6 run in tests/test_torch_sharded_train_recurrent.py (a file each
# keeps each file's time inside its share of the suite's)
ARCHS = ["llama3.2-1b", "mixtral-8x7b"]
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
B, S = 4, 16
ADAMW = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
# the tensor-parallel step (model axis > 1) against the port's unsharded
# step: its partial outputs are summed in f32 in coordinate order, so it
# rounds differently from the whole products by design
TP_LOSS_RTOL, TP_LEAF_TOL = 1e-6, 1e-5


def _cfgs(arch):
    return (dataclasses.replace(ref_base.get_reduced_config(arch), compute_dtype="float32"),
            dataclasses.replace(base.get_reduced_config(arch), compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference params as numpy, four numpy batches: tokens and targets,
    an enc-dec's ``src_embeds`` beside them, a vision config's ``embeds``
    in place of the tokens)."""
    rcfg, cfg = _cfgs(arch)
    rparams = jax.tree.map(np.asarray,
                           jax.jit(_ref_model(arch).init_params)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(4)]
    for b in batches:  # an enc-dec's frames, a vision config's patch embeddings
        if cfg.is_encdec:
            b["src_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        if cfg.frontend == "vision":
            b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            del b["tokens"]
    return rparams, batches


@functools.lru_cache(maxsize=None)
def _ref_model(arch):
    return RefModel(_cfgs(arch)[0], xent_impl="seq_chunked", xent_seq_chunk=8, rwkv_chunk=8)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, n):
    return jax.jit(ref_make_train_step(_ref_model(arch), RefStepConfig(
        microbatches=n, adamw=ref_opt.AdamWConfig(**ADAMW))))


@functools.lru_cache(maxsize=None)
def _ref_run(arch, schedule):
    """The reference's params, AdamW state and losses after one step at
    each microbatch count of ``schedule``."""
    rparams, batches = _setup(arch)
    params = jax.tree.map(jnp.asarray, rparams)
    state, losses = ref_opt.init_state(params), []
    for n, b in zip(schedule, batches):
        params, state, m = _ref_step(arch, n)(params, state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return jax.tree.map(np.asarray, (params, state.m, state.v)), losses


def _model(arch):
    return Model(_cfgs(arch)[1], xent_impl="seq_chunked", xent_seq_chunk=8, rwkv_chunk=8)


def _sharded(arch, sizes, axes=("data", "model")):
    model = _model(arch)
    policy = ShardingPolicy(make_mesh(sizes, axes, device="cpu"), model.cfg)
    step = jit_train_step(model, policy, inp.abstract_params(model),
                          TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW)),
                          batch_specs=policy.batch_specs(base.ShapeConfig("t", S, B, "train")))
    return model, step


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _whole(tree):
    return tree_map(lambda x: pl.gather(x, "cpu"), tree)


def _assert_leaves_close(got, want, cfg, tol=LEAF_TOL, floor=1e-30, want_v=None, steps=0,
                         step_vs=(), moved=None):
    """Each leaf of ``got`` (the port's tree) against ``want``'s (the
    reference's layout): within rtol ``tol`` and atol ``tol`` of the larger
    of ``floor`` and the leaf's largest |value|; with ``want_v``, plus
    ``steps`` learning rates where the reference's v says the gradient's
    RMS is under 1e-6; with ``step_vs`` (v after each step), plus one
    learning rate for each step after which v says so; with ``moved`` (the
    reference's own tree from another start), plus its distance from
    ``want``, for at most one element in a thousand of a leaf."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(convert.lm_params_to_numpy(got, cfg))[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_v = {} if want_v is None else dict(jax.tree_util.tree_flatten_with_path(want_v)[0])
    flat_vs = [dict(jax.tree_util.tree_flatten_with_path(v)[0]) for v in step_vs]
    flat_moved = {} if moved is None else dict(jax.tree_util.tree_flatten_with_path(moved)[0])
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        atol = tol * max(float(np.abs(w).max()), floor)
        if path in flat_v:
            atol = atol + steps * ADAMW["lr_peak"] * (np.sqrt(flat_v[path]) < 1e-6)
        for v in flat_vs:
            atol = atol + ADAMW["lr_peak"] * (np.sqrt(v[path]) < 1e-6)
        err = np.abs(flat_got[path] - w)
        within = err <= atol + tol * np.abs(w)
        if path in flat_moved:
            excused = ~within & (err <= atol + tol * np.abs(w) + np.abs(flat_moved[path] - w))
            assert excused.sum() <= w.size // 1000, (jax.tree_util.keystr(path),
                                                     int(excused.sum()))
            within |= excused
        assert within.all(), (jax.tree_util.keystr(path), float(err.max()))


def _assert_bytes_as_specs(tree, shardings):
    for x, sh in zip(leaves(tree), leaves(shardings)):
        assert isinstance(x, pl.Placed) and x.sharding == sh
        want = sh.bytes_per_coordinate(tuple(x.shape), torch.empty((), dtype=x.dtype)
                                       .element_size())
        for coord in sh.mesh.coords():
            t = x.shard(coord)
            got = 0 if t is None else t.numel() * t.element_size()
            assert got == want[coord], (x, coord, got, want[coord])
            if t is not None:
                assert tuple(t.shape) == sh.shard_shape(tuple(x.shape))
                assert t.device == sh.mesh.device(coord)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference_microbatched_step(arch, mesh):
    check_sharded_step(arch, MESHES[mesh])


def check_sharded_step(arch, sizes, axes=("data", "model")):
    """Two sharded steps on a mesh of ``sizes`` (the model axis last)
    against the reference's and the port's unsharded steps."""
    dp = int(np.prod(sizes[:-1]))
    rparams, batches = _setup(arch)
    (want_p, want_m, want_v), want_losses = _ref_run(arch, (dp, dp))
    model, step = _sharded(arch, sizes, axes)
    cfg = model.cfg

    uparams, ustate, ulosses, uvs = _unsharded_run(arch, dp)

    params = reshard_tree(convert.lm_params_from_numpy(rparams, cfg, device="cpu"),
                          step.param_shardings)
    state = step.init_opt_state()
    losses, ref_firsts, port_firsts = [], [], []
    ref_in = (rparams, None)  # the state each sharded step starts from, reference layout
    for i, b in enumerate(batches[:2]):
        ref_firsts.append(_ref_step_from(arch, dp, ref_in, i, b))
        params, state, m = step(params, state, _torch_batch(b))
        losses.append(float(m["loss"]))
        ref_in = tuple(convert.lm_params_to_numpy(_whole(t), cfg)
                       for t in (params, state.m, state.v))
        port_firsts.append(ref_in)
        _assert_leaves_close(_whole(state.m), ref_firsts[-1][1], cfg)
        _assert_leaves_close(_whole(state.v), ref_firsts[-1][2], cfg)
    # m and v after the two steps against the reference's two compounded
    # steps.  A weight whose first gradient cancels to f32 rounding moves
    # by +-lr either way in AdamW's first step, and the second gradient
    # reads it: the few elements beyond the tolerance are excused by as
    # much as the reference's own second step moves when it starts from
    # the port's first-step params (its own m and v kept)
    _, moved_m, moved_v = _ref_step_from(arch, dp, (port_firsts[0][0], *ref_firsts[0][1:]),
                                         1, batches[1])
    _assert_leaves_close(_whole(state.m), want_m, cfg, moved=moved_m)
    _assert_leaves_close(_whole(state.v), want_v, cfg, moved=moved_v)
    if sizes[-1] == 1:  # the unsharded step's sums: its bits
        assert losses[0] == ulosses[0]
        port_tol = 1e-6
    else:  # partial outputs summed in f32 in coordinate order
        np.testing.assert_allclose(losses, ulosses, rtol=TP_LOSS_RTOL)
        port_tol = TP_LEAF_TOL
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for got, want in ((params, uparams), (state.m, ustate.m), (state.v, ustate.v)):
        _assert_leaves_close(_whole(got), convert.lm_params_to_numpy(want, cfg), cfg,
                             port_tol, 1.0,
                             step_vs=uvs if got is params and sizes[-1] > 1 else ())
    _assert_bytes_as_specs(params, step.param_shardings)
    _assert_bytes_as_specs(state.m, step.opt_state_shardings.m)
    _assert_bytes_as_specs(state.v, step.opt_state_shardings.v)
    assert int(pl.gather(state.step, "cpu")) == 2
    _assert_leaves_close(_whole(params), want_p, cfg, floor=1.0, want_v=want_v, steps=2)


@functools.lru_cache(maxsize=None)
def _unsharded_run(arch, dp):
    """The port's unsharded step with ``dp`` microbatches, 2 steps from the
    reference's weights: (params, AdamW state, each step's loss, v after
    each step in the reference's layout); shared by the meshes of one data
    axis."""
    model = _model(arch)
    cfg = model.cfg
    params = convert.lm_params_from_numpy(_setup(arch)[0], cfg, device="cpu")
    unsharded = make_train_step(model, TrainStepConfig(microbatches=dp,
                                                       adamw=opt.AdamWConfig(**ADAMW)))
    ustate, ulosses, uvs = opt.init_state(params), [], []
    for b in _setup(arch)[1][:2]:
        params, ustate, um = unsharded(params, ustate, _torch_batch(b))
        ulosses.append(float(um["loss"]))
        uvs.append(convert.lm_params_to_numpy(ustate.v, cfg))
    return params, ustate, ulosses, uvs


def _ref_step_from(arch, n, state, done, batch):
    """The reference's step at ``n`` microbatches on ``batch`` from
    ``state`` (params, m, v as numpy in the reference's layout; m and v None
    for a fresh AdamW state) after ``done`` steps: (params, m, v), numpy."""
    params = jax.tree.map(jnp.asarray, state[0])
    if state[1] is None:
        opt_state = ref_opt.init_state(params)
    else:
        opt_state = ref_opt.AdamWState(step=jnp.asarray(done, jnp.int32),
                                       m=jax.tree.map(jnp.asarray, state[1]),
                                       v=jax.tree.map(jnp.asarray, state[2]))
    params, opt_state, _ = _ref_step(arch, n)(params, opt_state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (params, opt_state.m, opt_state.v))


def test_microbatches_are_contiguous_equal_slices():
    """The split both steps use: ``n`` contiguous slices of every leaf, in
    order; a batch that does not divide, or leaves of unequal rows, raise."""
    batch = {"tokens": torch.arange(24).reshape(6, 4), "targets": torch.arange(6)}
    parts = microbatches(batch, 3)
    assert [p["targets"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert torch.equal(torch.cat([p["tokens"] for p in parts]), batch["tokens"])
    with pytest.raises(ValueError, match="batch 6 does not split into 4"):
        microbatches(batch, 4)
    with pytest.raises(ValueError, match="does not split"):
        microbatches({"tokens": batch["tokens"][:4], "targets": batch["targets"]}, 2)


def test_pod_axis_folds_into_data():
    """On ("pod", "data", "model") = (2, 1, 2) the batch splits over pod x
    data, as the reference's ``batch_specs`` say: Llama's step equals the
    reference's at 2 microbatches."""
    check_sharded_step("llama3.2-1b", (2, 1, 2), ("pod", "data", "model"))


def test_place_gather_reshard_round_trip_bit_for_bit():
    """Every leaf of a Llama-3.2-1B tree and its ZeRO-1 moments, placed on
    (2, 2), resharded onto (4, 1), (1, 4) and (1, 1), gathers to the same
    bits; blocks of one device and slice are one tensor."""
    model = _model("llama3.2-1b")
    cfg = model.cfg
    params = model.init_params(torch.Generator().manual_seed(3), device="cpu")
    placements = {}
    for sizes in ((2, 2), (4, 1), (1, 4), (1, 1)):
        pol = ShardingPolicy(make_mesh(sizes, ("data", "model"), device="cpu"), cfg)
        ps = pol.param_specs(params)
        placements[sizes] = (pol.shardings(ps),
                             pol.shardings(pol.opt_state_specs(ps, params)))
    for kind in (0, 1):
        placed = reshard_tree(params, placements[(2, 2)][kind])
        for sizes in ((4, 1), (1, 4), (1, 1), (2, 2)):
            placed = reshard_tree(placed, placements[sizes][kind])
            for (path, a), b in zip(flatten_with_paths(params), leaves(placed)):
                assert torch.equal(pl.gather(b, "cpu"), a), path
    # one tensor a (block, device): a (2, 2) mesh on one CPU holds each
    # model block of a param once
    wq = reshard_tree(params, placements[(2, 2)][0])["layers"][0]["attn"]["wq"]
    assert len(wq.store) == 2 and wq.shard((0, 1)) is wq.shard((1, 1))


def test_gather_hands_each_block_its_own_gradient():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    x = torch.arange(24.0).reshape(4, 6)
    placed = pl.place(x, pl.NamedSharding(mesh, pl.Spec((("data",), "model"))))
    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    blocks = pl.sources(placed, "cpu")
    for t in blocks.values():
        t.requires_grad_(True)
    y = pl.assemble(blocks, placed.sharding.counts(2), "cpu")
    assert torch.equal(y, x)
    grads = torch.autograd.grad((y * w).sum(), list(blocks.values()))
    for (b, t), g in zip(blocks.items(), grads):
        region = placed.sharding.region(b, x.shape)
        assert torch.equal(g, w[tuple(slice(a, c) for a, c in region)])


def test_step_places_whole_params_and_refuses_another_placement():
    model, step = _sharded("llama3.2-1b", (2, 2))
    rparams, batches = _setup("llama3.2-1b")
    params = convert.lm_params_from_numpy(rparams, model.cfg, device="cpu")
    out, state, _ = step(params, step.init_opt_state(), _torch_batch(batches[0]))
    _assert_bytes_as_specs(out, step.param_shardings)
    _, other = _sharded("llama3.2-1b", (4, 1))
    with pytest.raises(ValueError, match="reshard"):
        other(out, other.init_opt_state(), _torch_batch(batches[1]))


def test_step_without_donate_leaves_its_inputs():
    """``donate=False`` updates copies: the placed params and moments passed
    in keep their bits, and the step's outputs equal a donating step's."""
    model = _model("llama3.2-1b")
    rparams, batches = _setup("llama3.2-1b")
    policy = ShardingPolicy(make_mesh((2, 2), ("data", "model"), device="cpu"), model.cfg)
    kw = dict(batch_specs=policy.batch_specs(base.ShapeConfig("t", S, B, "train")))
    outs = []
    for donate in (False, True):
        step = jit_train_step(model, policy, inp.abstract_params(model),
                              TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW)),
                              donate=donate, **kw)
        params = reshard_tree(convert.lm_params_from_numpy(rparams, model.cfg, device="cpu"),
                              step.param_shardings)
        state = step.init_opt_state()
        before = _whole(params)
        out, out_state, _ = step(params, state, _torch_batch(batches[0]))
        changed = any(not torch.equal(a, b) for a, b in zip(leaves(before),
                                                             leaves(_whole(params))))
        assert changed == donate
        assert all(a is b for a, b in zip(leaves(out), leaves(params))) == donate
        assert donate or not any(bool(t.any()) for t in leaves(_whole(state.m)))
        outs.append(_whole(out))
    assert all(torch.equal(a, b) for a, b in zip(leaves(outs[0]), leaves(outs[1])))


def test_elastic_resume_onto_another_mesh(tmp_path):
    arch = "llama3.2-1b"
    rparams, batches = _setup(arch)
    (want_p, want_m, want_v), want_losses = _ref_run(arch, (2, 2, 4, 4))
    model, step22 = _sharded(arch, (2, 2))
    params = reshard_tree(convert.lm_params_from_numpy(rparams, model.cfg, device="cpu"),
                          step22.param_shardings)
    state = step22.init_opt_state()
    losses = []
    for b in batches[:2]:
        params, state, m = step22(params, state, _torch_batch(b))
        losses.append(float(m["loss"]))
    tree = {"params": params, "opt": state}
    ckpt.save(tmp_path, 2, tree)

    _, step41 = _sharded(arch, (4, 1))
    shardings = {"params": step41.param_shardings, "opt": step41.opt_state_shardings}
    at, restored = ckpt.restore(tmp_path, tree, shardings=shardings)
    assert at == 2
    for (path, a), b in zip(flatten_with_paths(tree), leaves(restored)):
        assert b.sharding == leaves(shardings)[0].__class__(b.sharding.mesh, b.sharding.spec)
        assert torch.equal(pl.gather(a, "cpu"), pl.gather(b, "cpu")), path
    _assert_bytes_as_specs(restored["params"], step41.param_shardings)
    params, state = restored["params"], restored["opt"]
    for b in batches[2:]:
        params, state, m = step41(params, state, _torch_batch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_leaves_close(_whole(params), want_p, model.cfg, floor=1.0, want_v=want_v, steps=4)
    _assert_leaves_close(_whole(state.m), want_m, model.cfg)
    _assert_leaves_close(_whole(state.v), want_v, model.cfg)
