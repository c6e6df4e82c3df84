"""Train-step factories: loss, gradients, microbatch accumulation, AdamW,
and the sharded step over a mesh.

The port's counterpart of ``repro/train/step.py``.

``make_train_step``:

* microbatch gradient accumulation (every leaf of the batch split into
  ``microbatches`` equal parts along its first axis: ``tokens`` or a
  vision batch's ``embeds``, ``targets``, ``mask``), summed in
  ``grad_dtype`` (``bfloat16`` is the reference's compressed
  accumulation), then loss/n and grads/n;
* remat comes from the model (``Model.remat``);
* AdamW with the reference's decay mask
  (:func:`repro_torch.train.optimizer.decay_mask_like_reference`).

Metrics: ``loss``, ``grad_norm`` (before clipping) and ``lr``, plus ``ce``
and ``aux`` from the model when there is one microbatch (the reference
drops them when it accumulates).

``jit_train_step`` keeps the reference's name (``step.py:80``) and its
placements: params by ``ShardingPolicy.param_specs``, the AdamW moments by
``opt_state_specs`` (ZeRO-1), the batch by ``batch_specs``, and the same
placements out as in.  PyTorch runs it eagerly, coordinate by coordinate
(:class:`ShardedTrainStep`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import current
from repro_torch.sharding import placement as pl
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_dtype: str = "float32"  # "bfloat16" → compressed grad accumulation
    adamw: opt.AdamWConfig = opt.AdamWConfig()


@contextlib.contextmanager
def _requiring_grad(tensors):
    """``tensors`` require gradients inside the context, and not after."""
    for t in tensors:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t in tensors:
            t.requires_grad_(False)


def _loss_and_grads(model, params, batch: dict, wrt) -> Tuple[torch.Tensor, dict, tuple]:
    """(loss, metrics, the gradients of the loss with respect to each
    tensor of ``wrt``; zeros for one the loss does not use)."""
    loss, metrics = model.train_loss(params, batch)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def microbatches(batch: dict, n: int) -> List[dict]:
    """``batch`` as ``n`` contiguous equal slices along the first axis of
    every leaf; raises unless every leaf has the same first axis and it
    splits."""
    B = batch["targets"].shape[0]
    if any(v.shape[0] != B for v in batch.values()) or B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    r = B // n
    return [{k: v[i * r:(i + 1) * r] for k, v in batch.items()} for i in range(n)]


def value_and_grad(model, params, batch: dict) -> Tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``model.train_loss`` at ``params``; grads
    is a tree like params (zeros for a leaf the loss does not use)."""
    flat = leaves(params)
    with _requiring_grad(flat):
        loss, metrics, grads = _loss_and_grads(model, params, batch, flat)
    return loss, metrics, unflatten_like(params, grads)


def make_train_step(model, step_cfg: TrainStepConfig = TrainStepConfig()):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and the optimizer moments are updated in place."""
    gdt = getattr(torch, step_cfg.grad_dtype)
    n = step_cfg.microbatches

    def train_step(params, opt_state, batch):
        if n > 1:
            loss_sum = torch.zeros((), dtype=torch.float32, device=batch["targets"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt, device=p.device), params)
            for mb in microbatches(batch, n):
                loss, _, g = value_and_grad(model, params, mb)
                grads = tree_map(lambda a, gi: a + gi.to(gdt), grads, g)
                loss_sum = loss_sum + loss
                del g
            loss = loss_sum / n
            grads = tree_map(lambda g: g / n, grads)
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(model, params, batch)
        params, opt_state, om = opt.apply_adamw(
            step_cfg.adamw, params, grads, opt_state,
            decay_mask=opt.decay_mask_like_reference(model.cfg, params))
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------


class _Reader(dict):
    """A dict node of a placed param tree whose leaves are gathered where
    the model reads them: one layer's weights are whole only while that
    layer runs (and again in its recompute under remat)."""

    def __init__(self, node: dict, read):
        super().__init__(node)
        self._read = read

    def __getitem__(self, key):
        return self._read(dict.__getitem__(self, key))

    def get(self, key, default=None):
        return self[key] if key in self else default


def _row_batches(batch: dict, split: bool, n_rows: int, devices) -> List[dict]:
    """The batch of each data coordinate on its device: contiguous rows
    when ``split``, else the whole batch on the first coordinate only."""
    if not split:
        return [{k: v.to(devices[0]) for k, v in batch.items()}]
    return [{k: v.to(d) for k, v in rows.items()}
            for rows, d in zip(microbatches(batch, n_rows), devices)]


def _clone(x: pl.Placed) -> pl.Placed:
    return pl.Placed(x.sharding, x.shape, x.dtype, {k: t.clone() for k, t in x.store.items()})


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)`` on
    a mesh, the port's ``jit_train_step``.

    * **In:** params placed by the policy's param specs (a whole tensor is
      placed on the way in), the AdamW state by :meth:`init_opt_state`'s
      placements (the moments ZeRO-1 split), the batch as whole tensors
      split over the data axes by the batch specs.
    * **Each data coordinate** computes the loss and gradients of its rows
      on its device (the mesh's device at model index 0 of its row) through
      the model's own ``train_loss``: K5 and K6 run there as in the
      unsharded step.  A leaf is gathered from the row's blocks when the
      model reads it.  ``microbatches`` splits each row's batch further.
    * **Then** the gradients are summed over every microbatch of every data
      coordinate in coordinate order, in ``grad_dtype``, straight into the
      ZeRO-1 shard that owns each region (on that shard's device), and
      divided by their count; clipped by the global norm of the whole
      gradient; AdamW updates each shard on its device; each param block
      takes the updated regions, from the devices that updated them.
    * **Out:** params and moments updated in place (``donate=True``; else
      on copies), in the placements they came in.

    With ``dp`` data coordinates and ``m`` microbatches this computes
    ``make_train_step(TrainStepConfig(microbatches=dp * m))``: the losses
    and gradients of ``dp * m`` contiguous slices, averaged, which is how
    the reference's GSPMD step splits the global batch.  (The MoE aux loss
    is a product of means over its batch, so it is the mean of per-slice
    aux losses, as in the reference's microbatch path; for a dense family
    with an all-ones mask the loss equals the unsplit batch's up to
    rounding.)  A batch the specs do not split by rows (replicated, or
    split on the sequence at ``global_batch <= seq_parallel_threshold``)
    runs whole on the first data coordinate.  Only storage and the
    optimizer state are split along ``"model"``: each coordinate computes
    with whole weights.
    """

    def __init__(self, model, policy, abstract_params, step_cfg: TrainStepConfig,
                 batch_specs: Optional[dict], donate: bool):
        from repro_torch.sharding.policy import is_spec

        self.model, self.step_cfg, self.donate = model, step_cfg, donate
        self.abstract_params = abstract_params
        pspecs = policy.param_specs(abstract_params)
        self.param_shardings = policy.shardings(pspecs)
        self.opt_state_shardings = policy.opt_state_shardings(pspecs, abstract_params)
        self.decay = leaves(opt.decay_mask_like_reference(model.cfg, abstract_params))
        mesh = policy.mesh
        self.mesh = mesh
        coords = list(mesh.coords())
        dp = tuple(mesh.axis_names.index(a) for a in policy.dp if a in mesh.axis_names)
        sizes = [mesh.sizes[i] for i in dp]
        rows: Dict[int, list] = {}
        for c in coords:
            rows.setdefault(int(np.ravel_multi_index([c[i] for i in dp], sizes))
                            if dp else 0, []).append(c)
        self.rows = [rows[j] for j in sorted(rows)]  # each row's coordinates
        self.home = mesh.device(coords[0])
        specs = {k: v for k, v in (batch_specs or {}).items() if is_spec(v)}
        firsts = {tuple(pl.axes_of(s[0])) if len(s) else () for s in specs.values()}
        if len(firsts) > 1:
            raise ValueError(f"batch specs {specs} disagree on the batch axis")
        self.split_rows = bool(specs) and firsts == {tuple(policy.dp)}

    def init_opt_state(self) -> opt.AdamWState:
        """Step 0 and zero f32 moments, each block made on its device."""
        sh = self.opt_state_shardings
        zeros = lambda a, s: pl.zeros(s, a.shape, torch.float32)
        return opt.AdamWState(
            step=pl.zeros(sh.step, (), torch.int32),
            m=tree_map(zeros, self.abstract_params, sh.m),
            v=tree_map(zeros, self.abstract_params, sh.v))

    def _as_placed(self, x, sharding):
        if isinstance(x, pl.Placed):
            if x.sharding != sharding:
                raise ValueError(f"a leaf placed by {x.sharding.spec} where the step "
                                 f"expects {sharding.spec}; reshard it first "
                                 f"(repro_torch.ft.resilience.reshard_tree)")
            return x if self.donate else _clone(x)
        return pl.place(x, sharding)

    def __call__(self, params, opt_state, batch):
        cfg, model = self.step_cfg, self.model
        gdt = getattr(torch, cfg.grad_dtype)
        params = tree_map(self._as_placed, params, self.param_shardings)
        opt_state = opt.AdamWState(*(tree_map(self._as_placed, x, s) for x, s in
                                     zip(opt_state, self.opt_state_shardings)))
        P, M, V = leaves(params), leaves(opt_state.m), leaves(opt_state.v)
        # each moment block: (key, region, a coordinate holding it)
        shards = [[((b, self.mesh.device(c)), x.sharding.region(b, x.shape), c)
                   for b, held in x.copies().items() for c, _ in held] for x in M]

        rows = self.rows if self.split_rows else self.rows[:1]
        row_devices = [self.mesh.device(r[0]) for r in rows]
        row_batches = _row_batches(batch, self.split_rows, len(rows), row_devices)
        m = cfg.microbatches
        n = len(rows) * m
        acc: List[Dict] = [{} for _ in P]
        loss_sum, metrics = None, {}
        for coords, dev, rb in zip(rows, row_devices, row_batches):
            srcs = [pl.sources(x, dev, coords) for x in P]
            tensors = [t for s in srcs for t in s.values()]
            where = {}  # (leaf, block) -> index into tensors
            for i, s in enumerate(srcs):
                for b in s:
                    where[(i, b)] = len(where)
            ids = {id(x): i for i, x in enumerate(P)}

            def read(v, srcs=srcs, dev=dev):
                if isinstance(v, pl.Placed):
                    return pl.assemble(srcs[ids[id(v)]], v.sharding.counts(v.ndim), dev)
                if isinstance(v, dict):
                    return _Reader(v, read)
                if isinstance(v, list):
                    return [read(x) for x in v]
                return v

            view = read(params)
            with current(dev), _requiring_grad(tensors):
                for mb in microbatches(rb, m):
                    loss, metrics, grads = _loss_and_grads(model, view, mb, tensors)
                    loss = loss.to(self.home)
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    self._accumulate(acc, grads, where, srcs, P, shards, gdt)
                    del grads

        if n > 1:
            loss = loss_sum / n
            metrics = {}
            for a in acc:
                for key in a:
                    a[key] = a[key] / n
        else:
            loss = loss_sum
        new_step, om = self._apply_adamw(P, M, V, acc, shards, opt_state.step)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt.AdamWState(step=new_step, m=opt_state.m, v=opt_state.v), metrics

    @staticmethod
    def _accumulate(acc, grads, where, srcs, P, shards, gdt):
        """Add one microbatch's gradients into each moment block's region,
        on that block's device."""
        for i, (x, mine) in enumerate(zip(P, shards)):
            for key, region, _ in mine:
                for b in srcs[i]:
                    outer = x.sharding.region(b, x.shape)
                    if pl.contains(outer, region):
                        break
                else:
                    raise ValueError(f"{x}: a moment block {region} crosses param blocks")
                g = grads[where[(i, b)]][pl.slices_within(region, outer)]
                g = g.to(device=key[1], dtype=gdt)
                acc[i][key] = g.clone() if key not in acc[i] else acc[i][key] + g

    def _apply_adamw(self, P, M, V, acc, shards, step):
        acfg = self.step_cfg.adamw
        home = self.home
        # the global norm of the whole gradient: each region once
        sq = []
        for a, mine in zip(acc, shards):
            seen, parts = set(), []
            for key, region, _ in mine:
                if region not in seen:
                    seen.add(region)
                    parts.append(torch.sum(torch.square(a[key].float())).to(home))
            sq.append(torch.stack(parts).sum())
        gnorm = torch.sqrt(torch.stack(sq).sum())
        scale = opt.clip_scale(gnorm, acfg.clip_norm)
        new_step, lr, bc1, bc2 = opt.next_step(acfg, pl.gather(step, home))
        per_dev = {}

        def scalars(dev):
            if dev not in per_dev:
                per_dev[dev] = tuple(t.to(dev) for t in (scale, lr, bc1, bc2))
            return per_dev[dev]

        with torch.no_grad():
            for x, mx, vx, a, mine, decay in zip(P, M, V, acc, shards, self.decay):
                done = {}  # region -> devices that updated it
                for key, region, coord in mine:
                    s, lr_d, bc1_d, bc2_d = scalars(key[1])
                    pb = x.sharding.block(coord, x.ndim)
                    outer = x.sharding.region(pb, x.shape)
                    p = x.store[(pb, key[1])][pl.slices_within(region, outer)]
                    g = opt.scaled(a[key], s)
                    opt.adamw_update(acfg, p, g, mx.store[key], vx.store[key], decay,
                                     lr_d, bc1_d, bc2_d)
                    done.setdefault(region, []).append(key[1])
                # every param block takes the regions other devices updated
                for (pb, dev), t in x.store.items():
                    outer = x.sharding.region(pb, x.shape)
                    for region, devs in done.items():
                        if dev not in devs and pl.contains(outer, region):
                            src = x.store[(pb, devs[0])][pl.slices_within(region, outer)]
                            t[pl.slices_within(region, outer)].copy_(src)
        step_placed = pl.place(new_step, self.opt_state_shardings.step)
        return step_placed, {"grad_norm": gnorm, "lr": lr}


def jit_train_step(model, policy, abstract_params, step_cfg: TrainStepConfig = TrainStepConfig(),
                   batch_specs: Optional[dict] = None, donate: bool = True) -> ShardedTrainStep:
    """The sharded train step on ``policy.mesh`` (:class:`ShardedTrainStep`):
    in and out placements from the policy, as the reference's
    ``jit_train_step``.  ``abstract_params``: the param tree, concrete or
    ``meta`` (``repro_torch.launch.inputs.abstract_params``).  PyTorch runs
    the step eagerly; ``donate`` updates the placed params and moments in
    place, as the reference donates its buffers."""
    return ShardedTrainStep(model, policy, abstract_params, step_cfg, batch_specs, donate)
