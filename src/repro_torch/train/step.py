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
placements out as in.  PyTorch runs it eagerly (:class:`ShardedTrainStep`):
each data row's loss and gradients tensor parallel over its model
coordinates (:mod:`repro_torch.sharding.tensor_parallel`), each as GSPMD
splits the reference's compute along ``"model"``; at batch 1 each data row
computes its own span of the sequence (an enc-dec config's frames too),
as the reference's batch specs split it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import current
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_dtype: str = "float32"  # "bfloat16" → compressed grad accumulation
    adamw: opt.AdamWConfig = opt.AdamWConfig()


def _rounds_alike(a: torch.device, b: torch.device) -> bool:
    """Whether devices ``a`` and ``b`` run AdamW's arithmetic to the same
    bits: devices of one type do, a card and the CPU do not."""
    return a.type == b.type


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


def _loss_and_grads(model, params, batch: dict, wrt, ops=None,
                    materialize: bool = True) -> Tuple[torch.Tensor, dict, tuple]:
    """(loss, metrics, the gradients of the loss with respect to each
    tensor of ``wrt``; for one the loss does not use, zeros, or ``None``
    unless ``materialize``), the loss's sub-blocks through ``ops``."""
    loss, metrics = model.train_loss(params, batch, ops=ops)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=materialize)
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


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)`` on
    a mesh, the port's ``jit_train_step``.

    * **In:** params placed by the policy's param specs (a whole tensor is
      placed on the way in), the AdamW state by :meth:`init_opt_state`'s
      placements (the moments ZeRO-1 split), the batch as whole tensors
      split over the data axes by the batch specs.
    * **Each data row** computes the loss and gradients of its rows through
      the model's own ``train_loss`` with
      :class:`repro_torch.sharding.tensor_parallel.RowOps`, tensor parallel
      as GSPMD splits the reference's step along ``"model"``: attention on
      each model coordinate's q / KV heads (K5 on that coordinate's card,
      again in remat's recompute), RWKV's time-mix on its heads (K7
      likewise), the RG-LRU on its channels, the dense MLP, the experts,
      the shared expert and RWKV's channel-mix on its ``d_ff`` slice, the
      embedding looked up and the cross-entropy computed on its vocab
      block (K6's partial form), each from the coordinate's own blocks;
      the partial outputs summed, and the blocks' log-sum-exps combined,
      on the row's device (its first coordinate's), where norms and the
      MoE routing and aux loss run.  Every block the
      row reads requires gradients, so each block's gradient lands on its
      own device.  ``microbatches`` splits each row's batch further.
    * **Then** the gradients are summed over every microbatch of every data
      row in row order, in ``grad_dtype``, straight into the ZeRO-1 shard
      that owns each region (on that shard's device), and divided by their
      count: a region's gradient is the sum over every copy of its param
      block that the row read (a replicated leaf is read from the row's
      first coordinate only); clipped by the global norm of the whole
      gradient; AdamW updates each shard on its device; each param block
      takes the updated regions, from the devices that updated them.  A
      region whose moment block devices of two types hold (a card and the
      CPU, whose ``sqrt`` rounds apart in the last bit) is summed and
      updated only on the holders of its first holder's type, and the
      others take its moments from the first, so the copies of a block stay
      bit-equal on any mesh; devices of one type each update their own.
    * **Out:** params and moments updated in place (``donate=True``; else
      on copies), in the placements they came in.

    With ``dp`` data rows and ``m`` microbatches this computes
    ``make_train_step(TrainStepConfig(microbatches=dp * m))``: the losses
    and gradients of ``dp * m`` contiguous slices, averaged, which is how
    the reference's GSPMD step splits the global batch.  (The MoE aux loss
    is a product of means over its batch, so it is the mean of per-slice
    aux losses, as in the reference's microbatch path; for a dense family
    with an all-ones mask the loss equals the unsplit batch's up to
    rounding.)  At one model coordinate the sums are the unsharded step's
    bits; at more, the partial outputs are summed in f32 in coordinate
    order and cast once, so the step rounds differently from the
    unsharded one by design.

    **A batch the specs split on the sequence** (``global_batch <=
    seq_parallel_threshold`` that the data axes do not divide: batch 1)
    computes ``make_train_step(TrainStepConfig(microbatches=m))``, each
    microbatch's sequence as one slice: data row j runs the positions ``[j
    S / dp, (j + 1) S / dp)`` through ``Model.train_span``, the rows in
    order (each under its device), each layer reading what the rows before
    left it (K/V joined to its own and read through K5 with a query offset,
    RWKV's and the RG-LRU's state, the MoE slot counts and router sums);
    the loss is Σ over the rows of their masked CE sums over the
    sequence's mask total, plus the whole sequence's aux; then one
    ``torch.autograd.grad`` over the union of the rows' blocks (autograd
    carries each row's gradient back into the K/V and state the rows
    before handed on) and the accumulation as above.  An enc-dec config's
    ``src_embeds`` split on the frames likewise: data row j encodes ``[j T /
    dp, (j + 1) T / dp)``, layer by layer over every row's K/V
    (:func:`repro_torch.sharding.tensor_parallel.encode_over_rows`, each
    row's layer under remat's ``checkpoint`` with the other rows' K/V among
    its inputs), inside the same graph, so the one backward hands each
    row's K/V its share from every row's queries and the encoder blocks
    their gradients through ``row_tensors``; every row's decoder span reads
    the memory's spans, joined once on each device.  A sequence or a
    number of frames the data rows do not divide raises, as the reference's
    jit does, and so do microbatches that do not divide the batch (a batch
    of 1 into 2).  A batch the specs replicate (split neither way; every
    data row of the reference computes the same) runs once, on the first
    data row.

    The cross-entropy runs, as GSPMD splits the reference's, on each model
    coordinate's vocab block of the unembedding, combined by log-sum-exp
    (:func:`repro_torch.sharding.tensor_parallel.xent`), so no leaf split
    on ``"model"`` is gathered.  ``rwkv`` and ``rglru`` blocks run on each model coordinate's
    heads or channels (K7 on a coordinate's heads, forward and remat's
    recompute), as attention and the FFNs do.
    """

    def __init__(self, model, policy, abstract_params, step_cfg: TrainStepConfig,
                 batch_specs: Optional[dict], donate: bool):
        self.model, self.step_cfg, self.donate = model, step_cfg, donate
        self.abstract_params = abstract_params
        pspecs = policy.param_specs(abstract_params)
        self.param_shardings = policy.shardings(pspecs)
        self.opt_state_shardings = policy.opt_state_shardings(pspecs, abstract_params)
        self.decay = leaves(opt.decay_mask_like_reference(model.cfg, abstract_params))
        self.mesh = policy.mesh
        self.rows = tp.data_rows(self.mesh, policy.dp)  # each row's coordinates
        self.home = self.mesh.device(self.rows[0][0])
        self.split_rows = tp.splits_rows(batch_specs, policy.dp)
        self.split_seq = not self.split_rows and tp.splits_sequence(batch_specs, policy.dp)

    def init_opt_state(self) -> opt.AdamWState:
        """Step 0 and zero f32 moments, each block made on its device."""
        sh = self.opt_state_shardings
        zeros = lambda a, s: pl.zeros(s, a.shape, torch.float32)
        return opt.AdamWState(
            step=pl.zeros(sh.step, (), torch.int32),
            m=tree_map(zeros, self.abstract_params, sh.m),
            v=tree_map(zeros, self.abstract_params, sh.v))

    def __call__(self, params, opt_state, batch):
        cfg, model = self.step_cfg, self.model
        gdt = getattr(torch, cfg.grad_dtype)
        place = lambda x, s: pl.as_placed(x, s, self.donate)
        params = tree_map(place, params, self.param_shardings)
        opt_state = opt.AdamWState(*(tree_map(place, x, s) for x, s in
                                     zip(opt_state, self.opt_state_shardings)))
        P, M, V = leaves(params), leaves(opt_state.m), leaves(opt_state.v)
        # each moment block: (key, region, a coordinate holding it, whether
        # it updates the region: its device rounds as the first holder's)
        shards = []
        for x in M:
            mine = []
            for b, held in x.copies().items():
                first = self.mesh.device(held[0][0])
                mine += [((b, self.mesh.device(c)), x.sharding.region(b, x.shape), c,
                          _rounds_alike(self.mesh.device(c), first)) for c, _ in held]
            shards.append(mine)

        B, S = batch["targets"].shape
        m = cfg.microbatches
        acc: List[Dict] = [{} for _ in P]
        loss_sum, metrics = None, {}
        if self.split_seq:
            rows = tp.rows_over_sequence(self.mesh, self.rows, B // m, S)
            n = m
            for mb in microbatches(batch, m):
                loss, metrics, grads, reads = self._over_sequence(params, mb, rows, P)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                self._accumulate(acc, grads, reads, P, shards, gdt)
                del grads
        else:
            rows = tp.rows_at_work(self.mesh, self.rows, B, self.split_rows)
            n = len(rows) * m
            for row, rb in zip(rows, microbatches(batch, len(rows))):
                rb = {k: v.to(row.device) for k, v in rb.items()}
                reads = [tp.row_tensors(x, row) for x in P]  # [(block, tensor)] a leaf
                tensors = [t for r in reads for _, t in r]
                ops = tp.RowOps(model.cfg, row)
                # the backward pass on this thread alone: the autograd engine
                # runs each card's (and the CPU's) nodes on a thread of its own,
                # and two threads reaching one remat layer's nodes at once
                # would both run its non-reentrant recompute
                with (current(row.device), _requiring_grad(tensors),
                      torch.autograd.set_multithreading_enabled(False)):
                    for mb in microbatches(rb, m):
                        loss, metrics, grads = _loss_and_grads(model, params, mb, tensors, ops,
                                                               materialize=False)
                        loss = loss.to(self.home)
                        loss_sum = loss if loss_sum is None else loss_sum + loss
                        self._accumulate(acc, grads, reads, P, shards, gdt)
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

    def _over_sequence(self, params, batch: dict, rows, P):
        """One microbatch whose sequence is split over the data ``rows``:
        (loss, metrics, the gradients of every block the rows read, those
        blocks as [(block, tensor)] a leaf, each tensor once)."""
        model, cfg = self.model, self.model.cfg
        reads = []
        for x in P:
            seen, mine = set(), []
            for row in rows:
                for b, t in tp.row_tensors(x, row):
                    if id(t) not in seen:
                        seen.add(id(t))
                        mine.append((b, t))
            reads.append(mine)
        tensors = [t for r in reads for _, t in r]
        # one backward on this thread alone (see __call__)
        with _requiring_grad(tensors), torch.autograd.set_multithreading_enabled(False):
            memory = None
            if cfg.is_encdec:
                memory = tp.memory_by_device(
                    tp.encode_over_rows(model, params, batch["src_embeds"], self.mesh,
                                        self.rows, remat=model.remat), rows)
            ce = count = aux = carry = None
            for row in rows:
                part = {k: tp.span_of(v, row) for k, v in batch.items() if k != "src_embeds"}
                with current(row.device):
                    c, k, a, carry = model.train_span(params, part, row.span, carry,
                                                      tp.RowOps(cfg, row), memory)
                c, k, a = (t.to(self.home) for t in (c, k, a))
                ce, count, aux = (c, k, a) if ce is None else (ce + c, count + k, aux + a)
            ce = ce / torch.clamp(count, min=1.0)
            loss = ce + aux
            with current(self.home):
                grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                            materialize_grads=False)
        return loss.detach(), {"ce": ce.detach(), "aux": aux.detach()}, grads, reads

    @staticmethod
    def _accumulate(acc, grads, reads, P, shards, gdt):
        """Add one microbatch's gradients into each moment block's region,
        on the block's device where it updates the region: the region's
        part of the gradient of every copy of the param block that holds it
        (a copy the row did not read has none; no copy read: zeros)."""
        j = 0
        for i, (x, mine, read) in enumerate(zip(P, shards, reads)):
            got = grads[j:j + len(read)]
            j += len(read)
            for key, region, _, updates in mine:
                if not updates:
                    continue
                g, inside = None, False
                for (b, _), gb in zip(read, got):
                    outer = x.sharding.region(b, x.shape)
                    if not pl.contains(outer, region):
                        continue
                    inside = True
                    if gb is not None:
                        part = gb[pl.slices_within(region, outer)].to(device=key[1], dtype=gdt)
                        g = part if g is None else g + part
                if not inside:
                    raise ValueError(f"{x}: a moment block {region} crosses param blocks")
                if g is None:
                    g = torch.zeros(tuple(b - a for a, b in region), dtype=gdt, device=key[1])
                acc[i][key] = g.clone() if key not in acc[i] else acc[i][key] + g

    def _apply_adamw(self, P, M, V, acc, shards, step):
        acfg = self.step_cfg.adamw
        home = self.home
        # the global norm of the whole gradient: each region once
        sq = []
        for a, mine in zip(acc, shards):
            seen, parts = set(), []
            for key, region, _, _ in mine:
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
                done = {}  # region -> [(moment key, param block)] of its updates
                for key, region, coord, updates in mine:
                    if not updates:
                        continue
                    s, lr_d, bc1_d, bc2_d = scalars(key[1])
                    pb = x.sharding.block(coord, x.ndim)
                    outer = x.sharding.region(pb, x.shape)
                    p = x.store[(pb, key[1])][pl.slices_within(region, outer)]
                    g = opt.scaled(a[key], s)
                    opt.adamw_update(acfg, p, g, mx.store[key], vx.store[key], decay,
                                     lr_d, bc1_d, bc2_d)
                    done.setdefault(region, []).append((key, pb))
                # a moment copy that did not update its region takes the first
                # update's; every param block the regions other devices updated
                for key, region, _, updates in mine:
                    if not updates:
                        src = done[region][0][0]
                        mx.store[key].copy_(mx.store[src])
                        vx.store[key].copy_(vx.store[src])
                for (pb, dev), t in x.store.items():
                    outer = x.sharding.region(pb, x.shape)
                    for region, ups in done.items():
                        if dev not in {k[1] for k, _ in ups} and pl.contains(outer, region):
                            src, spb = ups[0]
                            from_ = x.store[(spb, src[1])][
                                pl.slices_within(region, x.sharding.region(spb, x.shape))]
                            t[pl.slices_within(region, outer)].copy_(from_)
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
