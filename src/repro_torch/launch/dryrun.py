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
  formulas of the port's sharded step (:func:`collectives`).

The prefill and decode cells plan the reference's sharded serving steps
(``jit_prefill_step`` / ``jit_decode_step``), which the port has not got:
their collective term counts only the weight gathers of a gather-at-read
step.  Records go to ``build/dryrun/`` (git-ignored), never under
``benchmarks/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path

import numpy as np

from repro_torch.configs import base as cfgbase
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Model
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


def collectives(policy, aparams, pspecs, ospecs, mode: str, reads: int) -> rl.CollectiveStats:
    """Bytes a card sends in one step of the port's sharded step, ring
    algorithms (R participants move (R - 1) / R of the data):

    * ``all-gather`` (model): each read of a leaf split on ``"model"``
      assembles it whole from its R = model-size blocks; ``reads`` reads a
      step (forward, remat's recompute, each microbatch);
    * train only, over the data axes (R = data size), per leaf of a card's
      param block: the gradient ``reduce-scatter`` into the ZeRO-1 shards
      (an ``all-reduce``, twice the bytes, where the moments are not split
      on data), then the updated params' ``all-gather``."""
    mesh = policy.mesh
    dp, tp = policy.dp_size, policy.tp_size
    by = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    count = {k: 0 for k in by}
    for (path, leaf), ps, os_ in zip(flatten_with_paths(aparams), leaves(pspecs, is_leaf=is_spec),
                                     leaves(ospecs, is_leaf=is_spec)):
        nbytes = leaf.numel() * leaf.element_size()
        if _counts(mesh, ps, leaf.ndim, (policy.tp,)) > 1:
            by["all-gather"] += reads * (tp - 1) / tp * nbytes
            count["all-gather"] += reads
        if mode != "train" or dp == 1:
            continue
        block = nbytes / _counts(mesh, ps, leaf.ndim, tuple(mesh.axis_names))
        split = (_counts(mesh, os_, leaf.ndim, policy.dp) > 1
                 or (getattr(os_, "group", None) or (None,))[0] is not None)
        if split:
            by["reduce-scatter"] += (dp - 1) / dp * block
            by["all-gather"] += (dp - 1) / dp * block
            count["reduce-scatter"] += 1
            count["all-gather"] += 1
        else:
            by["all-reduce"] += 2 * (dp - 1) / dp * block
            count["all-reduce"] += 1
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
    if shape.mode == "train":
        held["grads"] = _bytes(aparams, pspecs, mesh, itemsize=4)
        held["opt_state"] = 2 * _bytes(aparams, ospecs, mesh, itemsize=4) + 4  # m, v, step
        batch = inp.train_batch_specs(cfg, shape)
    else:
        acache = inp.abstract_cache(model, shape.global_batch, shape.seq_len)
        held["cache"] = _bytes(acache, policy.cache_specs(acache, shape.global_batch), mesh)
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
    reads = (2 if model.remat and shape.mode == "train" else 1) * microbatches
    coll = collectives(policy, aparams, pspecs, ospecs, shape.mode, reads)
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
