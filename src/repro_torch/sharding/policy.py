"""Sharding policies: logical parameter / cache / batch layouts → mesh axes.

Two policies live here, the port's counterparts of
``repro/sharding/policy.py``:

* :class:`ShardingPolicy`, the LM rule set (reference ``policy.py:60-263``),
  on the port's per-layer param tree.  The reference stacks each position
  of the block pattern over pattern groups (``g0/attn/wq`` of shape
  ``(G, d, H, h)``) and gives the group axis ``None``; the port keeps
  ``params["layers"][i]["attn"]["wq"]`` of shape ``(d, H, h)``, so its spec
  is the reference's without that first entry.  Each spec of a layer in a
  pattern group carries ``group = (entry, g, G)``
  (:class:`repro_torch.sharding.placement.Spec`): ``entry`` is the
  reference's for the group axis, ``g`` the layer's group and ``G`` the
  group count.  ZeRO-1 (:meth:`ShardingPolicy.opt_state_specs`) applies
  the reference's rule to the stacked shape, so where the reference gives
  the data axes to the group axis (Llama-3-8B on (16, 16): 32 groups) a
  layer's AdamW moments sit whole on the data coordinate that owns its
  group, the same bytes on the same cards.
  :func:`repro_torch.convert.restack` turns a spec tree back into the
  reference's layout.  Specs plan on any mesh, abstract included;
  placing needs devices (:mod:`repro_torch.sharding.placement`).
* :class:`DataParallelPolicy`, data parallelism for the CNN arena
  executors (reference ``policy.py:270-373``).  The reference places one
  global array with a ``NamedSharding`` and lets GSPMD run each device's
  shard; the port pads the batch to a multiple of the mesh size, splits it
  into contiguous shards, runs each shard on its device, and gathers the
  outputs onto the mesh's first device in shard order.

  - **Weights replicate**: :meth:`DataParallelPolicy.replicate` keeps one
    copy per distinct device (the models are microcontroller-sized).
  - **The batch shards**: each shard runs the whole executor, arena and
    all, on its device; rows never interact, so the sharded output is
    bit-exact against the unsharded one, and pad lanes never change a real
    row.
  - **Devices overlap**: the mesh's first device runs on the caller's
    current stream, every other distinct CUDA device on a stream of its
    own.  A call copies every shard to its device first, launches the
    other devices' shards, then the first device's, and gathers last, so
    no card waits for another's shard.  A shard on a card runs that card's
    kernels; nothing moves to the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.sharding.placement import NamedSharding, Spec
from repro_torch.train.optimizer import AdamWState
from repro_torch.tree import flatten_with_paths, leaves, tree_map, unflatten_like


def is_spec(x) -> bool:
    """A spec (a plain tuple or :class:`Spec`) as a tree leaf; a NamedTuple
    such as ``AdamWState`` is a node."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return dict(mesh.shape).get(name, 1)


def layer_group(cfg, path) -> Tuple[int, int] | None:
    """(group, group count) of the layer a tree path runs through when the
    reference stacks it in a pattern group (``g{i}``, ``enc_g0``), else
    None (top-level leaves, remainder layers ``r{i}``)."""
    if len(path) < 2 or path[0] not in ("layers", "enc_layers"):
        return None
    li = int(path[1])
    if path[0] == "enc_layers":
        return li, cfg.encoder_layers
    P = len(cfg.block_pattern)
    n_groups = cfg.num_layers // P
    return (li // P, n_groups) if li < n_groups * P else None


@dataclasses.dataclass
class ShardingPolicy:
    """The LM rule set: tensor parallelism on ``"model"`` (d_ff, attention
    heads, MoE expert-ff, RWKV heads, RG-LRU width, each only when it
    divides the axis, else replicated), data parallelism on ``("pod",
    "data")`` (the batch; the sequence for batch-1 cells), the decode
    caches' KV heads or else their length on ``"model"``, and ZeRO-1's
    extra data split of the AdamW moments.  Specs are plain tuples
    (:class:`Spec`); ``mesh`` is a :class:`repro_torch.launch.mesh.Mesh` or
    an abstract one."""

    mesh: Any
    cfg: Any
    zero1: bool = True
    shard_embed_vocab: bool = True
    seq_parallel_threshold: int = 1  # batch <= threshold -> shard seq instead

    def __post_init__(self):
        self.dp: Tuple[str, ...] = (
            ("pod", "data") if "pod" in self.mesh.axis_names else ("data",))
        self.tp = "model"
        self.dp_size = _axis_size(self.mesh, self.dp)
        self.tp_size = _axis_size(self.mesh, self.tp)

    def _m(self, dim: int):
        """'model' if divisible else None (replicate)."""
        return self.tp if dim % self.tp_size == 0 else None

    def named(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    # -- parameters ------------------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of one layer's leaf (no group axis), keyed by its tree
        path (``"layers/3/attn/wq"``), by the reference's rules."""
        leaf = path.split("/")[-1]
        parts = path.split("/")

        if leaf in ("embed", "unembed"):
            v = shape[0]
            return Spec((self.tp if (self.shard_embed_vocab and v % self.tp_size == 0)
                         else None, None))

        in_attn = "attn" in parts or "cross" in parts
        if in_attn and leaf in ("wq", "wk", "wv"):
            return Spec((None, self._m(shape[-2]), None))
        if in_attn and leaf == "wo":  # (H, h, d)
            return Spec((self._m(shape[-3]), None, None))
        if in_attn and leaf in ("bq", "bk", "bv"):
            return Spec((self._m(shape[-2]), None))

        if leaf in ("wi", "wg") and "ffn" in path and len(shape) >= 2 and "router" not in path:
            if len(shape) in (3, 4):  # (E, d, f)
                return Spec((None,) * (len(shape) - 1) + (self._m(shape[-1]),))
            return Spec((None, self._m(shape[-1])))
        if leaf == "wo" and "ffn" in path:
            if len(shape) >= 3:  # (E, f, d)
                return Spec((None,) * (len(shape) - 2) + (self._m(shape[-2]), None))
            return Spec((self._m(shape[-2]), None))
        if leaf in ("router", "shared_gate"):
            return Spec((None, None))

        in_tm = "tm" in parts
        if in_tm and leaf in ("wr", "wk", "wv", "wg"):
            return Spec((None, self._m(shape[-1])))
        if in_tm and leaf == "wo":
            return Spec((self._m(shape[-2]), None))
        if leaf == "bonus_u":
            return Spec((self._m(shape[-2]), None))
        if leaf in ("cm_wk", "cm_wr"):
            return Spec((None, self._m(shape[-1])))
        if leaf == "cm_wv":
            return Spec((self._m(shape[-2]), None))

        if leaf in ("w_gate", "w_rec", "w_a", "w_x", "conv_w"):
            return Spec((None, self._m(shape[-1])))
        if leaf == "w_out":
            return Spec((self._m(shape[-2]), None))

        return Spec((None,) * len(shape))  # 1-D / small leaves replicate

    def _per_leaf(self, fn, tree):
        flat = flatten_with_paths(tree)
        return unflatten_like(tree, [fn(path, leaf) for path, leaf in flat])

    def param_specs(self, abstract_params) -> Any:
        """A tree of specs like the param tree; a layer of a pattern group
        gets ``group = (None, g, G)`` (the reference leaves its group axis
        whole)."""
        def one(path, leaf):
            spec = self.param_spec("/".join(map(str, path)), tuple(leaf.shape))
            group = layer_group(self.cfg, path)
            return spec if group is None else Spec(spec, group=(None,) + group)

        return self._per_leaf(one, abstract_params)

    def _zero1(self, spec, shape):
        """The reference's ZeRO-1 rule on one (stacked) leaf: 'data' on the
        first unsharded dim that divides by the data axes and is at least
        twice their size."""
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (s, dim) in enumerate(zip(parts, shape)):
            if s is None and dim % self.dp_size == 0 and dim >= self.dp_size * 2:
                parts[i] = self.dp
                return tuple(parts)
        return tuple(spec)

    def opt_state_specs(self, param_specs_tree, abstract_params) -> Any:
        """ZeRO-1: the AdamW moments' specs, the param spec plus the data
        axes on the first free divisible dim of the reference's stacked
        leaf; when that dim is the group axis, ``group``'s entry takes it."""
        if not self.zero1:
            return param_specs_tree
        specs = leaves(param_specs_tree, is_leaf=is_spec)

        def one(spec, leaf):
            shape = tuple(leaf.shape)
            group = getattr(spec, "group", None)
            if group is None:
                return Spec(self._zero1(spec, shape))
            entry, g, G = group
            stacked = self._zero1((entry,) + tuple(spec), (G,) + shape)
            return Spec(stacked[1:], group=(stacked[0], g, G))

        return unflatten_like(abstract_params,
                              [one(s, leaf) for s, leaf in zip(specs, leaves(abstract_params))])

    # -- batches / activations ---------------------------------------------------
    def batch_specs(self, shape_cfg) -> Dict[str, Spec]:
        """Input-batch specs (tokens / targets / mask / embeds / src_embeds)."""
        B = shape_cfg.global_batch
        if B % self.dp_size == 0:
            tok, emb = Spec((self.dp, None)), Spec((self.dp, None, None))
        elif B <= self.seq_parallel_threshold:
            tok, emb = Spec((None, self.dp)), Spec((None, self.dp, None))  # sequence parallel
        else:
            tok, emb = Spec((None, None)), Spec((None, None, None))
        return {"tokens": tok, "targets": tok, "mask": tok, "embeds": emb, "src_embeds": emb}

    def activation_spec(self) -> Spec:
        return Spec((self.dp, None, None))

    # -- decode caches -------------------------------------------------------------
    def _length_axes(self, L: int):
        return self.dp + (self.tp,) if L % (self.dp_size * self.tp_size) == 0 else (self.tp,)

    def cache_specs(self, abstract_cache, batch: int) -> Any:
        """Specs for the port's decode cache (one state dict a decoder
        layer: kv ring buffers, their int8 scales, recurrent states)."""
        batch_ax = self.dp if batch % self.dp_size == 0 else None

        def spec(name, core):
            if name in ("k", "v"):
                _, L, K, _ = core
                if K % self.tp_size == 0:
                    return (batch_ax, None, self.tp, None)
                if batch_ax is None and L % self.tp_size == 0:
                    # batch-1 long context: flash-decoding over the cache length
                    return (None, self._length_axes(L), None, None)
                if L % self.tp_size == 0:
                    return (batch_ax, self.tp, None, None)
                return (batch_ax, None, None, None)
            if name in ("k_scale", "v_scale"):
                _, L, K = core
                if K % self.tp_size == 0:
                    return (batch_ax, None, self.tp)
                if batch_ax is None and L % self.tp_size == 0:
                    return (None, self._length_axes(L), None)
                if L % self.tp_size == 0:
                    return (batch_ax, self.tp, None)
                return (batch_ax, None, None)
            if name == "pos":
                _, L = core
                if batch_ax is None and L % self.tp_size == 0:
                    return (None, self._length_axes(L))
                return (batch_ax, None)
            if name == "s":  # rwkv state (B, H, hk, hv)
                return (batch_ax, self._m(core[1]), None, None)
            if name in ("tm_x", "cm_x"):
                return (batch_ax, None)
            if name == "h":  # griffin (B, rw)
                return (batch_ax, self._m(core[-1]))
            if name == "conv":  # (B, W-1, rw)
                return (batch_ax, None, self._m(core[-1]))
            return (None,) * len(core)

        def one(path, leaf):
            s = spec(str(path[-1]), tuple(leaf.shape))
            group = layer_group(self.cfg, ("layers",) + tuple(path))
            return Spec(s) if group is None else Spec(s, group=(None,) + group)

        return self._per_leaf(one, abstract_cache)

    # -- placements ------------------------------------------------------------------
    def shardings(self, spec_tree):
        """A tree of :class:`NamedSharding` (placements) like ``spec_tree``."""
        return tree_map(lambda s: NamedSharding(self.mesh, s), spec_tree, is_leaf=is_spec)

    def opt_state_shardings(self, param_specs_tree, abstract_params) -> AdamWState:
        """The AdamW state's placements: the step replicated, m and v by
        :meth:`opt_state_specs`."""
        o = self.shardings(self.opt_state_specs(param_specs_tree, abstract_params))
        return AdamWState(step=self.named(Spec(())), m=o, v=o)


class Replicas(dict):
    """``{device: tree}``: one copy of a tree of tensors per distinct device
    of a mesh (what :meth:`DataParallelPolicy.replicate` returns)."""


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def _to(tree, device: torch.device):
    return tree_map(lambda t: _move(t, device) if isinstance(t, torch.Tensor) else t, tree)


def _replica(fn):
    """``fn`` for another device: an arena executor gets a copy with arenas
    of its own (``ArenaExecutor.replica``); any other callable is shared."""
    replica = getattr(fn, "replica", None)
    return replica() if replica is not None else fn


@dataclasses.dataclass(frozen=True)
class DataParallelPolicy:
    """Batch-axis data parallelism over a 1-D ``("data",)`` mesh.

    ``mesh`` is a :class:`repro_torch.launch.mesh.DataMesh` (or any object
    with ``shape``, ``axis_names`` and ``devices``).  It must have a
    ``"data"`` axis; any other axis must have size 1.
    """

    mesh: object
    axis: str = "data"

    def __post_init__(self):
        shape = dict(self.mesh.shape)
        if self.axis not in shape:
            raise ValueError(
                f"mesh axes {tuple(self.mesh.axis_names)} have no "
                f"{self.axis!r} axis — build one with "
                "repro_torch.launch.mesh.make_data_mesh()")
        extra = {n: s for n, s in shape.items() if n != self.axis and s != 1}
        if extra:
            raise ValueError(
                f"data-parallel mesh must be 1-D over {self.axis!r}; "
                f"non-unit extra axes {extra} have no data-parallel meaning")

    @property
    def dp_size(self) -> int:
        return int(dict(self.mesh.shape)[self.axis])

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.mesh.devices)

    # -- remainder padding -----------------------------------------------------
    def padded_batch(self, n: int) -> int:
        """Smallest multiple of the mesh size >= n (the shardable batch)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        d = self.dp_size
        return ((int(n) + d - 1) // d) * d

    def pad_lanes(self, n: int) -> int:
        """How many padding lanes a batch of ``n`` needs."""
        return self.padded_batch(n) - int(n)

    def _padded_shards(self, xs) -> Tuple[List[torch.Tensor], int]:
        xs = torch.as_tensor(xs)
        n = int(xs.shape[0])
        pad = self.pad_lanes(n)
        if pad:
            xs = torch.cat([xs, xs.new_zeros((pad, *xs.shape[1:]))])
        return list(xs.split(xs.shape[0] // self.dp_size)), n

    def shard_batch(self, xs) -> Tuple[List[torch.Tensor], int]:
        """Pad ``xs`` (N, ...) with zero lanes up to a shardable batch and
        split it into ``dp_size`` contiguous shards, shard i on the mesh's
        device i.  Returns ``(shards, N)``; the caller slices ``[:N]`` off
        the gathered output."""
        shards, n = self._padded_shards(xs)
        return [_move(x, d) for x, d in zip(shards, self.devices)], n

    def replicate(self, tree) -> Replicas:
        """One copy of a tree of tensors (weights) per distinct device."""
        return Replicas({d: _to(tree, d) for d in dict.fromkeys(self.devices)})

    def wrap_batched(self, fn):
        """Lift a ``(params, xs) -> ys`` executor over the mesh and any batch.

        The returned ``run(replicas, xs)`` takes the weights as
        :meth:`replicate` gave them; it pads ``xs`` to a mesh multiple, runs
        each shard on its device, gathers the outputs onto the mesh's first
        device in shard order and returns the first N rows.  On a mesh of
        one device it is the plain ``fn(params, xs)``."""
        home = self.devices[0]
        if self.dp_size == 1:
            return lambda reps, xs: fn(reps[home], xs)
        runners = {d: fn if d == home else _replica(fn)
                   for d in dict.fromkeys(self.devices)}
        streams = {d: torch.cuda.Stream(d) for d in runners
                   if d.type == "cuda" and d != home}
        # the home device's shards last: its stream is the one the other
        # devices' input copies queue on
        order = sorted(range(self.dp_size), key=lambda i: self.devices[i] == home)

        def on(device):
            """``device`` and its stream current (the home device: as the
            caller left them)."""
            if device not in streams:
                return contextlib.nullcontext()
            stack = contextlib.ExitStack()
            stack.enter_context(torch.cuda.device(device))
            stack.enter_context(torch.cuda.stream(streams[device]))
            return stack

        def run(reps: Replicas, xs):
            shards, n = self._padded_shards(xs)
            devices = self.devices
            # A copy between cards queues on its source's current stream and
            # makes the destination's current stream wait for it.  So every
            # shard goes to its device before any shard's kernels are queued,
            # and each output comes home on its own device's stream.
            placed = []
            for x, d in zip(shards, devices):
                with on(d):
                    placed.append(_move(x, d))
            ys = [None] * len(shards)
            for i in order:
                with on(devices[i]):
                    ys[i] = runners[devices[i]](reps[devices[i]], placed[i])
            for i in order:
                with on(devices[i]):
                    ys[i] = _move(ys[i], home)
            return torch.cat(ys).narrow(0, 0, n)

        return run
