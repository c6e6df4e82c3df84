"""Tensor-parallel compute in the sharded train step, on CPU meshes.

``jit_train_step`` runs each data row's ``Model.train_loss`` through
``tensor_parallel.RowOps``: attention on each model coordinate's heads, the
FFNs (dense, MoE experts, the shared expert) on its ``d_ff`` slice, the
embedding looked up on its vocab block, each from the coordinate's own
blocks.  Reduced configs at f32 compute, the reference's weights carried
across (``convert``), as ``tests/test_torch_sharded_train.py`` holds
Llama-3.2-1B and Mixtral-8x7B (its ``check_sharded_step``: two steps
against the reference's ``make_train_step(microbatches=dp)`` at
``LOSS_RTOL`` 1e-5 / ``LEAF_TOL`` 1e-4, and against the port's unsharded
step, bit for bit at a model axis of 1, else at 1e-6 / 1e-5):

* (a) on ("data", "model") = (2, 1) the step's loss is bit-equal to the
  port's ``make_train_step(microbatches=2)``, for Seamless-M4T (the
  encoder and cross-attention), Qwen2-VL (an ``embeds`` batch),
  Qwen2-MoE (the aux loss) and Gemma3-1B (local and global layers, the
  tied table's lookup and loss on one vocab block);
* (b) the same four on (1, 2) and (2, 2) against the reference;
* (c) on (2, 2), ``flash_attention`` runs once an attention layer, a model
  coordinate and a data row, and once more in remat's recompute, on that
  coordinate's heads (its q and KV heads, the row's rows); for RWKV6-7B
  and RecurrentGemma-9B likewise K7 (``wkv``) on each coordinate's heads
  and ``griffin.recurrence`` on its channels, its gates reading all of ξ;
  the cross-entropy's ``XentPart`` runs once a model coordinate and a data
  row, on that coordinate's vocab block of the unembedding and the row's
  rows; and ``pl.gather`` takes no leaf at all, the unembedding included;
* (d) on a (2, 2) mesh of two distinct devices (``cpu:0`` / ``cpu:1``,
  laid out as ``chip_smoke.py``'s ``sharded_mixed``), where a replicated
  leaf has a copy on each of a row's coordinates and only the first is
  read, every replicated leaf's param and ZeRO-1 moments after 2 steps
  equal the unsharded step's within the tensor-parallel tolerance, and
  every copy of every block is bit-equal across the two devices; there each
  holder updates its own copy, and where the two stand-ins round apart
  (``_rounds_alike`` patched) a region is updated once and copied, so
  copies stay bit-equal even with one device's update nudged by an ulp;
* the bf16 gaps ``chip_smoke.py``'s ``sharded_train`` limits were set from
  (and RWKV's f32 gaps, which its f32 run is held to), and, against the
  same steps at f32 compute, that Qwen2-MoE's widest leaf-norm gaps are
  bf16's rounding, which the split does not widen.  The three-seed
  readings: ``tests/torch_precision_readings.py``.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_sharded_train import (ADAMW, B, S, TP_LEAF_TOL, TP_LOSS_RTOL, _model,
                                      _setup, _sharded, _torch_batch, check_sharded_step)

from repro_torch import convert
from repro_torch.configs import base
from repro_torch.data import tokens as tok
from repro_torch.ft.resilience import reshard_tree
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import griffin
from repro_torch.models.transformer import Model
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.train import optimizer as opt
from repro_torch.train import step as train_step
from repro_torch.train.step import (TrainStepConfig, jit_train_step, make_train_step,
                                    microbatches)
from repro_torch.tree import flatten_with_paths, leaves

ARCHS = ["seamless-m4t-large-v2", "qwen2-vl-7b", "qwen2-moe-a2.7b", "gemma3-1b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_one_is_the_unsharded_step(arch):
    check_sharded_step(arch, (2, 1))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_the_reference_microbatched_step(arch, mesh):
    check_sharded_step(arch, mesh)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2", "qwen2-moe-a2.7b",
                                  "rwkv6-7b", "recurrentgemma-9b", "gemma3-1b"])
def test_attention_on_each_coordinates_heads_and_no_split_leaf_gathered(arch, monkeypatch):
    model, step = _sharded(arch, (2, 2))
    cfg = model.cfg
    rparams, batches = _setup(arch)
    params = reshard_tree(convert.lm_params_from_numpy(rparams, cfg, device="cpu"),
                          step.param_shardings)
    paths = {id(x): "/".join(map(str, p)) for p, x in flatten_with_paths(params)}
    gathered, shapes, k7, widths, blocks = [], [], [], [], []
    real_gather, real_flash = pl.gather, flash_ops.flash_attention
    real_wkv, real_rec, real_part = wkv_ops.wkv, griffin.recurrence, xent_ops.XentPart.apply
    monkeypatch.setattr(pl, "gather", lambda x, *a, **k: (
        id(x) in paths and gathered.append(paths[id(x)])) or real_gather(x, *a, **k))
    monkeypatch.setattr(flash_ops, "flash_attention", lambda q, k, v, **kw: shapes.append(
        (tuple(q.shape), tuple(k.shape), kw["causal"])) or real_flash(q, k, v, **kw))
    monkeypatch.setattr(wkv_ops, "wkv", lambda r, *a, **k: k7.append(tuple(r.shape)) or
                        real_wkv(r, *a, **k))
    monkeypatch.setattr(griffin, "recurrence", lambda c, p, g, xf_all, xf, *a, **k: (
        widths.append((tuple(xf.shape), xf_all.shape[-1]))) or real_rec(c, p, g, xf_all, xf,
                                                                          *a, **k))
    monkeypatch.setattr(xent_ops.XentPart, "apply", lambda x, w, *a: blocks.append(
        (tuple(x.shape), tuple(w.shape))) or real_part(x, w, *a))
    _, _, m = step(params, step.init_opt_state(), _torch_batch(batches[0]))
    assert np.isfinite(float(m["loss"]))

    rows, coords, passes = 2, 2, 2  # data rows, model coordinates, forward + recompute
    H, h = cfg.num_heads // coords, cfg.head_dim
    K = (cfg.num_kv_heads // coords if cfg.num_kv_heads % coords == 0
         else max(1, H // (cfg.num_heads // cfg.num_kv_heads)))  # a uniform group a coordinate
    n_attn = sum(kind in ("attn", "swa", "local") for kind in cfg.blocks())
    want = [((B // rows, S, H, h), (B // rows, S, K, h), True)] * n_attn
    if cfg.is_encdec:  # the encoder's layers, each decoder layer's cross-attention
        want += [((B // rows, S, H, h), (B // rows, S, K, h), False)] * (
            cfg.encoder_layers + cfg.num_layers)
    assert sorted(shapes) == sorted(want * rows * coords * passes)
    # K7 on each coordinate's heads, the RG-LRU on its channels (ξ whole)
    n_rwkv = sum(kind == "rwkv" for kind in cfg.blocks())
    n_rec = sum(kind == "rglru" for kind in cfg.blocks())
    if n_rwkv:
        Hr = cfg.d_model // cfg.rwkv_head_dim
        assert k7 == [(B // rows, S, Hr // coords, cfg.rwkv_head_dim)] * (
            n_rwkv * coords * rows * passes)
    assert widths == [((B // rows, S, cfg.lru_width // coords), cfg.lru_width)] * (
        n_rec * coords * rows * passes)
    # the loss on each coordinate's vocab block, the row's rows: no gather
    assert blocks == [((B // rows, S, cfg.d_model), (cfg.vocab_size // coords, cfg.d_model))] * (
        rows * coords)
    assert gathered == []


def _two_device_mesh_step(arch):
    """``jit_train_step`` on (2, 2) over [[cpu:0, cpu:1], [cpu:1, cpu:0]]:
    every block held by two devices, each row's coordinates on both.  A
    mesh names the CPU without an index, so the two stand-ins are set on
    its device array: each block gets a tensor of its own for each, as on
    two cards, while every tensor stays on the CPU."""
    model = _model(arch)
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    mesh.devices = np.array([[a, b], [b, a]], dtype=object)
    policy = ShardingPolicy(mesh, model.cfg)
    step = jit_train_step(model, policy, inp.abstract_params(model),
                          TrainStepConfig(adamw=opt.AdamWConfig(**ADAMW)),
                          batch_specs=policy.batch_specs(base.ShapeConfig("t", S, B, "train")))
    return model, step


def _nudged_steps(arch, monkeypatch):
    """Two steps on ``_two_device_mesh_step``'s mesh with ``cpu:1``'s AdamW
    update of a param region nudged by one ulp after it (as a CPU's
    ``sqrt`` and a card's round apart): (params, state, the moment blocks'
    (block, device) copies, the updates' count, the nudged ones')."""
    model, step = _two_device_mesh_step(arch)
    rparams, batches = _setup(arch)
    placed = reshard_tree(convert.lm_params_from_numpy(rparams, model.cfg, device="cpu"),
                          step.param_shardings)
    on = {t.untyped_storage().data_ptr(): dev for x in leaves(placed)
          for (_, dev), t in x.store.items()}
    real, updates, nudged = opt.adamw_update, [], []

    def update(cfg, p, *args):
        real(cfg, p, *args)
        updates.append(p.numel())
        if on[p.untyped_storage().data_ptr()] == torch.device("cpu", 1):
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
            nudged.append(p.numel())

    monkeypatch.setattr(opt, "adamw_update", update)
    state = step.init_opt_state()
    for b in batches[:2]:
        placed, state, _ = step(placed, state, _torch_batch(b))
    copies = sum(len(held) for x in leaves(state.m) for held in x.copies().values())
    return placed, state, copies, len(updates), len(nudged)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_each_region_updated_once_keeps_the_copies_bit_equal(arch, monkeypatch):
    """Two stand-in devices whose AdamW rounds apart (``_rounds_alike``
    false for ``cpu:0`` and ``cpu:1``, and ``cpu:1``'s updates nudged by an
    ulp, as a CPU's ``sqrt`` and a card's round apart): each moment region
    is updated on one device and the other holders take its result, so
    every block's copies, params and moments, stay bit-equal, and ``cpu:1``
    updated some regions (so the nudge is in the values).  Seamless-M4T's
    LayerNorm biases, replicated and zero at first, are where a card and a
    CPU first drifted apart."""
    monkeypatch.setattr(train_step, "_rounds_alike", lambda a, b: a == b)
    placed, state, copies, updates, nudged = _nudged_steps(arch, monkeypatch)
    regions = sum(len(x.copies()) for x in leaves(state.m))
    assert nudged and updates == 2 * regions < 2 * copies
    for tree in (placed, state.m, state.v):
        for path, x in flatten_with_paths(tree):
            for held in x.copies().values():
                assert all(torch.equal(t, held[0][1]) for _, t in held[1:]), path


def test_devices_of_one_type_each_update_their_own_copy(monkeypatch):
    """On devices of one type (``cpu:0`` and ``cpu:1``, as four cards of one
    kind) every holder of a moment region updates its own copy, as they
    round alike, and none is copied across: with ``cpu:1``'s updates nudged,
    its param copies hold the nudge and ``cpu:0``'s do not."""
    placed, state, copies, updates, nudged = _nudged_steps("llama3.2-1b", monkeypatch)
    assert updates == 2 * copies and nudged
    unequal = sum(not all(torch.equal(t, held[0][1]) for _, t in held[1:])
                  for x in leaves(placed) for held in x.copies().values())
    assert unequal > 0


def test_replicated_leaf_update_on_two_devices():
    arch = "llama3.2-1b"
    model, step = _two_device_mesh_step(arch)
    cfg = model.cfg
    rparams, batches = _setup(arch)
    params = convert.lm_params_from_numpy(rparams, cfg, device="cpu")
    unsharded = make_train_step(model, TrainStepConfig(microbatches=2,
                                                       adamw=opt.AdamWConfig(**ADAMW)))
    ustate, ulosses = opt.init_state(params), []
    placed = reshard_tree(params, step.param_shardings)
    state, losses = step.init_opt_state(), []
    for b in batches[:2]:
        params, ustate, um = unsharded(params, ustate, _torch_batch(b))
        placed, state, m = step(placed, state, _torch_batch(b))
        ulosses.append(float(um["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ulosses, rtol=TP_LOSS_RTOL)

    specs = [sh.spec for sh in leaves(step.param_shardings)]
    replicated = 0
    for tree, want in ((placed, params), (state.m, ustate.m), (state.v, ustate.v)):
        for (path, x), w, spec in zip(flatten_with_paths(tree), leaves(want), specs):
            assert len({dev for _, dev in x.store}) == 2, path
            for held in x.copies().values():  # a copy on each device, equal bits
                assert all(torch.equal(t, held[0][1]) for _, t in held[1:]), path
            if any(e is not None for e in spec):
                continue
            replicated += 1
            got = pl.gather(x, "cpu")
            scale = max(1.0, float(w.abs().max()))
            assert float((got - w).abs().max()) <= TP_LEAF_TOL * scale, path
    assert replicated == 3 * (2 * cfg.num_layers + 1)  # norm1, norm2 a layer, final_norm


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _run(arch, seed, compute_dtype, sharded, steps=3, batch=8, seq=64):
    """The reduced config at ``compute_dtype`` from seed ``seed``, ``steps``
    steps on the token pipeline's batches: on (2, 2) when ``sharded``, else
    the unsharded step with 2 microbatches.  Returns (each step's loss, each
    param / m / v leaf's f64 norm after the steps, each data row's (unsharded,
    RowOps) aux loss on the first batch when sharded and the config has MoE).
    Cached: the bf16 tests below read some runs twice."""
    cfg = dataclasses.replace(base.get_reduced_config(arch), compute_dtype=compute_dtype)
    model = Model(cfg, xent_impl="chunked", remat=True)
    params = model.init_params(torch.Generator().manual_seed(seed), device="cpu")
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                   seed=seed)
    adamw = opt.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    aux = []
    if sharded:
        policy = ShardingPolicy(make_mesh((2, 2), ("data", "model"), device="cpu"), cfg)
        step = jit_train_step(model, policy, inp.abstract_params(model),
                              TrainStepConfig(adamw=adamw),
                              batch_specs=policy.batch_specs(base.ShapeConfig("t", seq, batch,
                                                                              "train")))
        placed, state = reshard_tree(params, step.param_shardings), step.init_opt_state()
        if cfg.moe is not None:
            rows = tp.rows_at_work(policy.mesh, step.rows, batch, True)
            with torch.no_grad():
                for row, mb in zip(rows, microbatches(tok.device_batch(pipe, 0, "cpu"), 2)):
                    aux.append((float(model.train_loss(params, mb)[1]["aux"]),
                                float(model.train_loss(placed, mb,
                                                       ops=tp.RowOps(cfg, row))[1]["aux"])))
        params = placed
    else:
        step = make_train_step(model, TrainStepConfig(microbatches=2, adamw=adamw))
        state = opt.init_state(params)
    losses = []
    for s in range(steps):
        params, state, m = step(params, state, tok.device_batch(pipe, s, "cpu"))
        losses.append(float(m["loss"]))
    norms = [float(torch.linalg.vector_norm(pl.gather(x, "cpu").double()))
             for t in (params, state.m, state.v) for x in leaves(t)]
    return losses, norms, aux


def _rel(got, want):
    return [abs(a - b) / abs(b) if b else abs(a) for a, b in zip(got, want)]


def _bf16_gaps(arch, seed):
    """In bf16, (2, 2) against the 2-microbatch step, relative, as
    ``chip_smoke.py``'s ``sharded_train`` reads them: (each step's loss gap,
    each param / m / v leaf's f64-norm gap, each data row's aux-loss gap on
    the first batch through RowOps)."""
    losses, norms, aux = _run(arch, seed, "bfloat16", True)
    ulosses, unorms, _ = _run(arch, seed, "bfloat16", False)
    return _rel(losses, ulosses), _rel(norms, unorms), [abs(s - u) / u for u, s in aux]


def test_bf16_gaps_within_the_chip_limits():
    """The readings ``chip_smoke.py``'s ``sharded_train`` limits were set
    from (about 3x the largest; PERF.md): the reduced Llama-3.2-1B and
    Qwen2-MoE-A2.7B in bf16 on a (2, 2) CPU mesh, 3 seeds, 3 steps (the
    card's 2 timed and 1 profiled), and RWKV6-7B, RecurrentGemma-9B and
    Gemma3-1B at seed 0 (their 3 seeds are a one-off run,
    ``tests/torch_precision_readings.py``), printed under ``-s``
    and held within the card's limits: each run's widest leaf-norm gap, or
    its median where ``SHARDED_TP_LIMITS`` gates the median (RWKV)."""
    cs = _chip_smoke()
    limits = {"llama3.2-1b": (cs.SHARDED_TP_LOSS_RTOL, cs.SHARDED_TP_NORM_RTOL, "max", 0.0, 3),
              "qwen2-moe-a2.7b": (cs.SHARDED_MOE_LOSS_RTOL, cs.SHARDED_MOE_NORM_RTOL, "max",
                                  cs.SHARDED_MOE_AUX_RTOL, 3),
              "rwkv6-7b": (*cs.SHARDED_TP_LIMITS["rwkv6-7b"], 0.0, 1),
              "recurrentgemma-9b": (*cs.SHARDED_TP_LIMITS["recurrentgemma-9b"], 0.0, 1),
              "gemma3-1b": (*cs.SHARDED_TP_LIMITS["gemma3-1b"], 0.0, 1)}
    for arch, (loss_rtol, norm_rtol, read, aux_rtol, seeds) in limits.items():
        of = {"max": max, "median": lambda g: float(np.median(g))}[read]
        loss, norm, aux = (max(v) for v in zip(*(
            [f(g) if g else 0.0 for f, g in zip((max, of, max), _bf16_gaps(arch, seed))]
            for seed in range(seeds))))
        print(f"{arch}: loss gap {loss:.3g}, leaf-norm gap ({read}) {norm:.3g}, "
              f"aux gap {aux:.3g}")
        assert loss <= loss_rtol and norm <= norm_rtol and aux <= aux_rtol


def test_f32_gaps_within_the_chip_limits():
    """``sharded_train``'s f32 run of the reduced RWKV6-7B: the (2, 2) step
    against the 2-microbatch step at f32 compute, 3 steps, seed 0, every
    param / m / v leaf's norm within ``SHARDED_F32_NORM_RTOL`` and every
    loss within ``SHARDED_F32_LOSS_RTOL`` (printed under ``-s``)."""
    cs = _chip_smoke()
    for arch in cs.SHARDED_F32_ARCHS:
        losses, norms, _ = _run(arch, 0, "float32", True)
        ulosses, unorms, _ = _run(arch, 0, "float32", False)
        loss, norm = max(_rel(losses, ulosses)), max(_rel(norms, unorms))
        print(f"{arch} f32: loss gap {loss:.3g}, leaf-norm gap {norm:.3g}")
        assert loss <= cs.SHARDED_F32_LOSS_RTOL and norm <= cs.SHARDED_F32_NORM_RTOL


def test_bf16_moe_leaf_gaps_are_bf16_rounding():
    """Qwen2-MoE's widest leaf-norm gaps in bf16 (the attention biases,
    which start at zero: their norm after 3 steps is AdamW's updates
    alone, about the learning rate where a gradient's sign holds) come from
    bf16, not from the split: against the same 3 steps at f32 compute, the
    (2, 2) step's leaf norms are no further than the unsharded bf16
    step's.  Seed 0; the worst leaf of each printed under ``-s``."""
    _, f32, _ = _run("qwen2-moe-a2.7b", 0, "float32", False)
    _, split, _ = _run("qwen2-moe-a2.7b", 0, "bfloat16", True)
    _, whole, _ = _run("qwen2-moe-a2.7b", 0, "bfloat16", False)
    split_gap, whole_gap = max(_rel(split, f32)), max(_rel(whole, f32))
    print(f"qwen2-moe-a2.7b leaf norms against f32: (2, 2) bf16 {split_gap:.3g}, "
          f"unsharded bf16 {whole_gap:.3g}")
    assert split_gap <= whole_gap
