"""Multi-pod dry run: every (architecture x input shape) cell planned on the
production meshes, with no compile and no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--out build/dryrun]

The port's counterpart of ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell's sharded step for 256 / 512 TPU chips
(``make_production_mesh``) against ``ShapeDtypeStruct`` stand-ins and reads
XLA's memory and cost analyses and its HLO.  PyTorch has no such compile,
so each record here is arithmetic on the same plan, on the abstract
(16, 16) or (2, 16, 16) mesh:

* the reference's skip rule (``cell_is_runnable``);
* the bytes each card holds of the params, the gradients (the params'
  placements, f32), the AdamW state (ZeRO-1) and, for prefill and decode
  cells, the KV cache, under ``ShardingPolicy``, from the ``meta`` tree of
  ``repro_torch.launch.inputs`` (the most any card holds), and whether
  they fit the card's 80 GB (the H100's datasheet figure);
* ``_planner_estimate``: the paper's ping-pong planner
  (``repro_torch.core.planner``) at LM scale, as the reference's;
* ``model_flops`` and the roofline terms (``repro_torch.launch.roofline``)
  by the reference's ``"lite"`` method: FLOPs a card = ``model_flops /
  cards``; HBM bytes a card = each input the step reads once and each
  output it writes once (train: params, AdamW state and batch in, params
  and state out; prefill: params and batch in, cache out; decode: params
  and cache in, the new cache slot out); collective bytes a card from the
  formulas of the port's sharded steps: the tensor-parallel and data-axis
  traffic of the train step (:func:`collectives`), and the tensor-parallel
  traffic of the serving steps ``jit_prefill_step`` / ``jit_decode_step``
  (:func:`serving_collectives`).

Records go to ``build/dryrun/`` (git-ignored), never under
``benchmarks/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path
from typing import List

import numpy as np

from repro_torch.configs import base as cfgbase
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import ATTN_KINDS, Model
from repro_torch.sharding.placement import NamedSharding, axes_of
from repro_torch.sharding.policy import ShardingPolicy, is_spec
from repro_torch.tree import flatten_with_paths, leaves

DEFAULT_OUT = Path("build/dryrun")


def build_model(cfg, *, xent_impl="chunked", remat=True, rwkv_chunk=256,
                remat_policy="block", kv_dtype="compute"):
    return Model(cfg, xent_impl=xent_impl, remat=remat, rwkv_chunk=rwkv_chunk,
                 remat_policy=remat_policy, kv_dtype=kv_dtype)


def _bytes(tree, specs, mesh, itemsize=None) -> np.ndarray:
    """Bytes each mesh coordinate holds of a tree laid out by ``specs``."""
    total = np.zeros(tuple(mesh.shape.values()), dtype=np.int64)
    for leaf, spec in zip(leaves(tree), leaves(specs, is_leaf=is_spec)):
        total = total + NamedSharding(mesh, spec).bytes_per_coordinate(
            tuple(leaf.shape), itemsize or leaf.element_size())
    return total


def _counts(mesh, spec, ndim, axes) -> int:
    """How many blocks ``spec`` splits a leaf into over ``axes``."""
    n = 1
    for e in NamedSharding(mesh, spec).entries(ndim):
        for a in axes_of(e):
            if a in axes:
                n *= mesh.shape[a]
    return n


def _split(mesh, spec, ndim, axes) -> bool:
    return _counts(mesh, spec, ndim, axes) > 1


def _summed_seqs(policy, cfg, aparams, pspecs, S: int, S_enc: int) -> List[int]:
    """The sequence length of each sub-block whose partial outputs a data
    row sums over ``"model"``: each attention (self; a decoder's cross; the
    encoder's at ``S_enc``, none when 0) and each FFN (dense, or the MoE's
    experts and shared expert, summed together) whose output projection is
    split on ``"model"``."""
    mesh, model_ax = policy.mesh, (policy.tp,)
    out = []

    def summed(spec, leaf, seq):
        if _split(mesh, spec, leaf.ndim, model_ax):
            out.append(seq)

    def ffn(p, ps, seq):
        if "shared" in p and not _split(mesh, ps["wi"], p["wi"].ndim, model_ax):
            p, ps = p["shared"], ps["shared"]
        summed(ps["wi"], p["wi"], seq)

    for kind, p, ps in zip(cfg.blocks(), aparams["layers"], pspecs["layers"]):
        if kind in ATTN_KINDS:
            summed(ps["attn"]["wo"], p["attn"]["wo"], S)
            if cfg.is_encdec:
                summed(ps["cross"]["wo"], p["cross"]["wo"], S)
            ffn(p["ffn"], ps["ffn"], S)
        elif kind == "rglru":
            ffn(p["ffn"], ps["ffn"], S)
    if S_enc:
        for p, ps in zip(aparams["enc_layers"], pspecs["enc_layers"]):
            summed(ps["attn"]["wo"], p["attn"]["wo"], S_enc)
            ffn(p["ffn"], ps["ffn"], S_enc)
    return out


def _whole_weights(policy, cfg, aparams, pspecs) -> List[int]:
    """The bytes of each weight of an ``rwkv`` / ``rglru`` block (computed
    whole on a data row's device) split on ``"model"``."""
    mesh, model_ax = policy.mesh, (policy.tp,)
    out = []
    for kind, p, ps in zip(cfg.blocks(), aparams["layers"], pspecs["layers"]):
        key = {"rglru": "rec", "rwkv": "tm"}.get(kind)
        if key is None:
            continue
        for (_, leaf), spec in zip(flatten_with_paths(p[key]), leaves(ps[key], is_leaf=is_spec)):
            if _split(mesh, spec, leaf.ndim, model_ax):
                out.append(leaf.numel() * leaf.element_size())
    return out


def _row_batch(policy, B: int) -> int:
    """A data row's rows: B / data size when the data axes divide B, else
    B (the first data row computes the whole batch)."""
    return B // policy.dp_size if B % policy.dp_size == 0 else B


def collectives(policy, cfg, shape, aparams, pspecs, ospecs, remat: bool,
                microbatches: int) -> rl.CollectiveStats:
    """Bytes a card sends in one step of the port's sharded train step,
    ring algorithms (R participants move (R - 1) / R of the data):

    * over the R = model-size coordinates of a data row (tensor parallel),
      whose rows are ``B_row`` = B / data size (B when the data axes do not
      divide the batch), S the cell's length (an enc-dec's encoder and
      decoder alike), each of ``microbatches`` slices of a row moving its
      share:

      - ``all-reduce``, 2 (R - 1) / R x ``B_row`` x S x D x the compute
        dtype's bytes, for each attention (self, cross, the encoder's) and
        FFN sub-block whose output projection is split on ``"model"``
        (:func:`_summed_seqs`): the partial outputs in the forward, the
        input's gradient in the backward, and the partials again in remat's
        recompute (3 a sub-block with remat, 2 without); and once for the
        embedding's vocab-split lookup (the table's dtype; a batch of
        ``embeds`` looks nothing up);
      - ``all-gather``, (R - 1) / R of the bytes of each ``rwkv`` /
        ``rglru`` weight split on ``"model"`` at each read (the forward,
        and remat's recompute), and of the unembedding split on vocab once,
        read whole for K6; ``reduce-scatter``: their gradients back to
        their blocks, (R - 1) / R of the same bytes, once;

    * over the data axes (R = data size), per leaf of a card's param
      block: the gradient ``reduce-scatter`` into the ZeRO-1 shards (an
      ``all-reduce``, twice the bytes, where the moments are not split on
      data), then the updated params' ``all-gather``."""
    mesh = policy.mesh
    dp, tp = policy.dp_size, policy.tp_size
    by = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    count = {k: 0 for k in by}

    def add(kind, nbytes, n):
        by[kind] += nbytes
        count[kind] += n

    rows, S, D, m = _row_batch(policy, shape.global_batch), shape.seq_len, cfg.d_model, microbatches
    ring = (tp - 1) / tp
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    passes = 3 if remat else 2
    for seq in _summed_seqs(policy, cfg, aparams, pspecs, S, S if cfg.is_encdec else 0):
        add("all-reduce", passes * 2 * ring * rows * seq * D * cbytes, passes * m)
    model_ax = (policy.tp,)
    if cfg.frontend != "vision" and _split(mesh, pspecs["embed"], 2, model_ax):
        add("all-reduce", 2 * ring * rows * S * D * aparams["embed"].element_size(), m)
    table = "embed" if cfg.tie_embeddings else "unembed"
    gathered = [(w, (2 if remat else 1) * m) for w in _whole_weights(policy, cfg, aparams, pspecs)]
    if _split(mesh, pspecs[table], 2, model_ax):
        gathered.append((aparams[table].numel() * aparams[table].element_size(), m))
    for nbytes, reads in gathered:
        add("all-gather", reads * ring * nbytes, reads)
        add("reduce-scatter", m * ring * nbytes, m)
    for (path, leaf), ps, os_ in zip(flatten_with_paths(aparams), leaves(pspecs, is_leaf=is_spec),
                                     leaves(ospecs, is_leaf=is_spec)):
        if dp == 1:
            break
        nbytes = leaf.numel() * leaf.element_size()
        block = nbytes / _counts(mesh, ps, leaf.ndim, tuple(mesh.axis_names))
        split = (_counts(mesh, os_, leaf.ndim, policy.dp) > 1
                 or (getattr(os_, "group", None) or (None,))[0] is not None)
        if split:
            add("reduce-scatter", (dp - 1) / dp * block, 1)
            add("all-gather", (dp - 1) / dp * block, 1)
        else:
            add("all-reduce", 2 * (dp - 1) / dp * block, 1)
    return rl.CollectiveStats({k: v for k, v in by.items() if count[k]},
                              {k: v for k, v in count.items() if v})


def serving_collectives(policy, cfg, shape, aparams, pspecs, acache, cspecs
                        ) -> rl.CollectiveStats:
    """Bytes a card sends in one step of the port's sharded prefill or
    decode step, ring algorithms (R participants move (R - 1) / R of the
    data), over the R = model-size coordinates of a data row, whose rows
    are ``B_row`` = B / data size when the data axes divide the batch,
    else B:

    * ``all-reduce``, 2 (R - 1) / R x ``B_row`` x S x D x the compute
      dtype's bytes, for each attention sub-block (self, cross, encoder)
      and each FFN whose output projection is split on ``"model"``: the
      partial outputs summed on the row's device and the sum's next input
      sent back out; and for the embedding split on vocab (the table's
      dtype; a prefill from ``embeds`` looks nothing up).  S is the
      prompt's length in a prefill (an enc-dec's decoder takes
      ``ENCDEC_DECODER_PREFILL`` tokens, its encoder the cell's length), 1
      in a decode step;
    * ``all-gather``: the logits' vocab slices, (R - 1) / R x ``B_row`` x V
      x 4; in a decode step, per attention layer whose cache is split on
      length over R' blocks, the combine's partials, (R' - 1) / R' x
      ``B_row`` x H x (h + 2) x 4; and the blocks computed whole (``rwkv``,
      ``rglru``): each weight split on ``"model"`` gathered once, (R - 1) /
      R of its bytes, and each state leaf split on ``"model"`` gathered
      before the block and written back after it, twice (R - 1) / R of the
      row's bytes."""
    mesh = policy.mesh
    model_ax = (policy.tp,)
    B = shape.global_batch
    rows = _row_batch(policy, B)
    decode = shape.mode == "decode"
    S = 1 if decode else (inp.ENCDEC_DECODER_PREFILL if cfg.is_encdec else shape.seq_len)
    S_enc = shape.seq_len if cfg.is_encdec and not decode else 0
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    D = cfg.d_model
    by = {"all-reduce": 0.0, "all-gather": 0.0}
    count = {k: 0 for k in by}
    ring = (policy.tp_size - 1) / policy.tp_size

    def add(kind, nbytes):
        by[kind] += nbytes
        count[kind] += 1

    for seq in _summed_seqs(policy, cfg, aparams, pspecs, S, S_enc):
        add("all-reduce", 2 * ring * rows * seq * D * cbytes)
    for nbytes in _whole_weights(policy, cfg, aparams, pspecs):
        add("all-gather", ring * nbytes)
    for kind, c, cs in zip(cfg.blocks(), acache, cspecs):
        if kind in ATTN_KINDS:
            length = NamedSharding(mesh, cs["k"]).entries(4)[1]
            if decode and length is not None:
                r = int(np.prod([mesh.shape[a] for a in axes_of(length)]))
                add("all-gather", (r - 1) / r * rows * cfg.num_heads * (cfg.head_dim + 2) * 4)
            continue
        for name, leaf in c.items():
            if _split(mesh, cs[name], leaf.ndim, model_ax):
                add("all-gather", 2 * ring * leaf.numel() * leaf.element_size() * rows / B)
    if (decode or cfg.frontend != "vision") and _split(mesh, pspecs["embed"], 2, model_ax):
        add("all-reduce", 2 * ring * rows * S * D * aparams["embed"].element_size())
    table = "embed" if cfg.tie_embeddings else "unembed"
    if _split(mesh, pspecs[table], 2, model_ax):
        add("all-gather", ring * rows * cfg.vocab_size * 4)
    return rl.CollectiveStats({k: v for k, v in by.items() if count[k]},
                              {k: v for k, v in count.items() if v})


def _planner_estimate(cfg, shape, policy) -> dict:
    """``repro_torch.core.planner`` at LM scale: the per-card activation
    arena.  The layer stack is a sequential chain of equal (B_loc, S, d)
    hidden states, so the paper's ping-pong bound is 2·B_loc·S·d·bytes;
    block remat saves one more carry a group (n_groups·B_loc·S·d)."""
    from repro_torch.core import planner as pl_mod
    from repro_torch.core.graph import Input, OpaqueLayer, SequentialGraph

    B_loc = max(shape.global_batch // policy.dp_size, 1)
    S = shape.seq_len if shape.mode != "decode" else 1
    d = cfg.d_model
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    elems = B_loc * S * d

    def const(n):
        return lambda _s, n=n: (int(n),)

    layers = [Input(shape=(elems,), name="embed")]
    for i in range(cfg.num_layers):
        layers.append(OpaqueLayer(out_fn=const(elems), name=f"block{i}"))
    pp = pl_mod.plan_pingpong(SequentialGraph(layers), fused=False)
    n_groups = cfg.num_layers // max(len(cfg.block_pattern), 1)
    est = {
        "pingpong_activation_bytes": int(pp.arena_elems) * cbytes,
        "remat_carry_bytes": int(n_groups * elems * cbytes) if shape.mode == "train" else 0,
    }
    est["total_bytes"] = est["pingpong_activation_bytes"] + est["remat_carry_bytes"]
    return est


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               model_overrides: dict | None = None, policy_overrides: dict | None = None,
               config_overrides: dict | None = None, microbatches: int = 1) -> dict:
    """One cell's record (see the module docstring); a skipped cell's
    record says why."""
    cfg = cfgbase.get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    shape = cfgbase.SHAPES[shape_name]
    runnable, reason = cfgbase.cell_is_runnable(cfg, shape)
    if not runnable:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True, "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    policy = ShardingPolicy(mesh, cfg, **(policy_overrides or {}))
    model = build_model(cfg, **(model_overrides or {}))
    aparams = inp.abstract_params(model)
    pspecs = policy.param_specs(aparams)
    ospecs = policy.opt_state_specs(pspecs, aparams)
    zero = np.zeros(tuple(mesh.shape.values()), dtype=np.int64)
    held = {"params": _bytes(aparams, pspecs, mesh), "grads": zero, "opt_state": zero,
            "cache": zero}
    bspecs = policy.batch_specs(shape)
    acache = cspecs = None
    if shape.mode == "train":
        held["grads"] = _bytes(aparams, pspecs, mesh, itemsize=4)
        held["opt_state"] = 2 * _bytes(aparams, ospecs, mesh, itemsize=4) + 4  # m, v, step
        batch = inp.train_batch_specs(cfg, shape)
    else:
        acache = inp.abstract_cache(model, shape.global_batch, shape.seq_len)
        cspecs = policy.cache_specs(acache, shape.global_batch)
        held["cache"] = _bytes(acache, cspecs, mesh)
        if shape.mode == "prefill":
            batch = inp.prefill_batch_specs(cfg, shape)
        else:  # a decode step's inputs replicate, as in the reference
            batch = dict(zip(("tokens", "pos", "memory"), inp.decode_inputs(cfg, shape)))
            bspecs = {}
    batch_bytes = _bytes(batch, {k: bspecs.get(k, ()) for k in batch}, mesh)
    total = sum(held.values())
    per_card = {k: int(v.max()) for k, v in held.items()}
    per_card["total"] = int(total.max())

    n = mesh.size
    mflops = rl.model_flops(cfg, shape)
    if shape.mode == "train":
        moved = 2 * (held["params"] + held["opt_state"]) + batch_bytes
    else:  # prefill writes the cache, a decode step reads it
        moved = held["params"] + held["cache"] + batch_bytes
    if shape.mode == "train":
        coll = collectives(policy, cfg, shape, aparams, pspecs, ospecs, model.remat,
                           microbatches)
    else:
        coll = serving_collectives(policy, cfg, shape, aparams, pspecs, acache, cspecs)
    cost = {"flops": mflops / n, "transcendentals": 0.0, "bytes accessed": float(moved.max())}
    roof = rl.derive(cost, coll, num_devices=n, model_flops_total=mflops)
    return {
        "arch": arch, "shape": shape_name, "mode": shape.mode,
        "mesh": "x".join(str(s) for s in mesh.sizes), "multi_pod": multi_pod,
        "skipped": False, "cards": n,
        "model_overrides": {k: str(v) for k, v in (model_overrides or {}).items()},
        "bytes_per_card": per_card, "hbm_bytes": rl.HBM_BYTES,
        "fits_hbm": per_card["total"] <= rl.HBM_BYTES,
        "planner_estimate": _planner_estimate(cfg, shape, policy),
        "model_flops": mflops,
        "analysis": {"method": "lite", "cost": cost,
                     "collectives": {"bytes_by_kind": coll.bytes_by_kind,
                                     "count_by_kind": coll.count_by_kind},
                     "roofline": roof.to_dict()},
        "roofline": roof.to_dict(),
    }


def all_cells():
    for arch in cfgbase.arch_ids():
        for shape_name in cfgbase.SHAPES:
            yield arch, shape_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="architecture id (see configs)")
    ap.add_argument("--shape", help="input-shape id", choices=list(cfgbase.SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true", help="the (2,16,16) mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--xent", default="chunked", choices=["chunked", "naive", "seq_chunked"])
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch (and --shape) or --all")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = list(all_cells())
    elif not args.shape:
        cells = [(args.arch, s) for s in cfgbase.SHAPES]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_skip = n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
            path = out_dir / f"{tag}.json"
            try:
                rec = lower_cell(arch, shape_name, multi_pod=mp,
                                 model_overrides={"xent_impl": args.xent},
                                 microbatches=args.microbatches)
            except Exception as e:  # noqa: BLE001 - record the cell and go on
                n_fail += 1
                print(f"[FAIL] {tag}: {e}", flush=True)
                rec = {"arch": arch, "shape": shape_name, "multi_pod": mp, "failed": True,
                       "error": str(e), "traceback": traceback.format_exc()}
            else:
                if rec["skipped"]:
                    n_skip += 1
                    print(f"[SKIP] {tag}: {rec['reason']}", flush=True)
                else:
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"[OK]   {tag}: {rec['bytes_per_card']['total'] / 2**30:.2f} GiB/card "
                          f"fits={rec['fits_hbm']} bottleneck={r['bottleneck']} "
                          f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                          f"collective={r['collective_s']:.4f}s", flush=True)
            path.write_text(json.dumps(rec, indent=1))
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
