"""LM assembly: embeddings, a stack of attention, RG-LRU or RWKV6 blocks,
an optional encoder, logits.

The port's counterpart of ``repro/models/transformer.py``:
``Model.init_params``, ``init_cache``, ``encode``, ``prefill``,
``decode_step``, ``train_loss``, ``_embed`` and ``_logits_last``, over
block kinds ``attn``, ``swa``, ``local`` (with a dense or a MoE FFN),
``rglru`` (Griffin) and ``rwkv``, and the encoder's ``enc``.  Layers run as
a plain Python loop in place of the reference's ``lax.scan`` over pattern
groups, so params and caches are per-layer lists;
:func:`repro_torch.convert.lm_params_from_numpy` and the tests unstack the
reference's group-stacked layout.

Encoder-decoder configs (``cfg.encoder_layers > 0``, Seamless-M4T) keep
the encoder's layers in ``params["enc_layers"]`` (kind ``enc``: attention
over every position, a dense MLP) and give each decoder layer a
cross-attention sub-block (``norm_x``, ``cross``) after its
self-attention.  :meth:`Model.encode` turns frame embeddings
(``src_embeds``: the audio frontend is a stub in the reference too) into
the memory the decoder attends to; ``prefill`` and ``decode_step`` take it
as ``memory=``.  Without a memory the cross sub-blocks are skipped and the
decoder runs as a plain LM, which is how the reference's ``Engine`` serves
it.  Two reference quirks, kept: ``encode`` applies the decoder's
``final_norm`` to the encoder's output (there is no encoder norm), and the
enc-dec training loss reads the decoder's output without it
(``transformer.py:394-396,427``).

``kv_dtype="int8"`` keeps the attention caches in int8 with a scale per
(row, slot, KV head) (:func:`repro_torch.models.attention.init_kv_cache`).

Qwen2-VL's vision frontend is a stub in the reference too
(``configs/qwen2_vl_7b.py``): ``prefill`` and ``train_loss`` take
``batch["embeds"]`` (B, S, D) in place of the token embedding, cast to the
compute dtype with no lookup and no ``emb_scale`` (reference
``transformer.py:368-371,438-443``), so ``params["embed"]`` gets a zero
gradient in training (and AdamW still decays it); decode embeds tokens as
usual.  Its M-RoPE runs in text mode (:func:`repro_torch.models.attention._rope`).

Training (``train_loss`` / ``_xent``) follows the reference
(``transformer.py:334-398``): the mean cross-entropy over masked positions
plus the auxiliary loss, the MoE layers' Switch load-balancing losses
summed over the stack (zero for the families without MoE).  Every block
kind trains: attention (with a dense or a MoE FFN), ``rglru`` (the
doubling scan, differentiated as it is), ``rwkv`` and the enc-dec stacks.
Three CE paths:

* ``naive`` materializes (B, S, V) logits in the compute dtype;
* ``chunked`` and ``seq_chunked`` go through
  :func:`repro_torch.kernels.xent.ops.fused_xent`: K6 on the card (with the
  sequence-chunked plain VJP as its backward), and on the CPU the plain
  form the reference uses (vocab chunks of ``xent_chunk``, or sequence
  chunks of ``xent_seq_chunk``).

The CE runs through ``ops.xent`` on the unembedding as it is placed: on a
mesh, :class:`repro_torch.sharding.tensor_parallel.RowOps` runs each model
coordinate's vocab block (K6's partial form on the card) and combines the
blocks by log-sum-exp.

With ``remat`` each layer (of both stacks) runs under
``torch.utils.checkpoint``, its MoE aux loss a second output.
``remat_policy="block"`` saves nothing inside a layer, so the backward pass
runs each layer's forward again; ``"dots"`` is the reference's
``dots_with_no_batch_dims_saveable`` (``transformer.py:294-298``) through
selective checkpointing (:func:`dots_policy`): the outputs of products with
no batch dimension are saved and the rest is recomputed.  K5 and K7 are
not such products (the reference's ``pallas_call`` is not a dot), so they
run again in the recompute under either policy; K6 runs once, after the
stack.

The training forward (``_stack`` / ``_sequence_block``, the loss) and the
serving walk (``_walk``, ``encode``) take each sub-block, the input's
lookup, the reads of norms, the unembedding and the CE from an ``ops``
object:
:class:`LocalOps` on whole tensors, or the sharded steps'
:class:`repro_torch.sharding.tensor_parallel.RowOps` on one data row of a
mesh.

**Sequence parallelism.**  Where the batch specs split the sequence over
the data axes (batch 1, the reference's ``seq_parallel_threshold``), each
data row of the sharded steps walks its own contiguous span of positions
(:class:`Span`) through :meth:`Model.train_span` / :meth:`Model.prefill_span`,
the rows in order: each layer takes what the rows before it left (its
carry: an attention layer's K/V, which its queries read through K5 with a
query offset; RWKV's ``s``, ``tm_x`` and ``cm_x``; the RG-LRU's ``h`` and
conv tail; a MoE layer's per-expert slot counts and router sums) and hands
on its own.  Serving reads a recurrent layer's carry from the cache the row
before wrote.  The first span, with nothing carried, is the whole-sequence
walk's arithmetic on its positions.  An enc-dec config's frames split too
(the specs put ``src_embeds`` on the data axes alike): the encoder is not
causal, so :meth:`Model.encode_spans` walks it layer by layer across the
rows, every row's K/V of a layer before any row's attention of it, and
hands the decoder the memory as the rows' spans.

Every prefill or training attention over more than one query row runs K5
(causal, or not for the encoder and the cross-attention) and every
multi-token RWKV time-mix K7 (on the card, each inside a
``torch.autograd.Function`` whose backward is the plain VJP; their plain
versions on the CPU).  The RG-LRU scan and the MoE dispatch are plain
PyTorch, as they are XLA ops in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.models import attention, griffin, mlp, moe, rwkv6
from repro_torch.models.common import apply_norm, cdt, embed_init, make_norm_params, pdt

ATTN_KINDS = ("attn", "swa", "local")
# Leaves the reference reads in f32 whatever the compute dtype: norm scales
# and biases, RWKV's decay base, bonus and group-norm affine, the RG-LRU's
# gate products and Λ (griffin.py:114-116) and the MoE router (moe.py:68).
F32_LEAVES = frozenset({"scale", "bias", "decay_base", "bonus_u", "gn_scale", "gn_bias",
                        "w_a", "b_a", "w_x", "b_x", "lam", "router"})


# remat_policy="dots": the products with no batch dimension reach aten.mm
# (addmm with a bias) and are saved; batched products (aten.bmm: attention's
# per-head products, the MoE's dispatch, expert and combine einsums) and
# everything else are recomputed.
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat_policy="dots"``."""
    if op in SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


REMAT_CONTEXTS = {"block": noop_context_fn, "dots": _dots_context}


def store_compute_dtype(params: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Store every weight the model casts to the compute dtype at use in
    ``dtype`` once, in place, leaf by leaf (so the peak is the params plus
    one leaf); :data:`F32_LEAVES` keep their dtype.  The model computes the
    same values either way, since a cast to the dtype a tensor has is
    free.  Returns ``params``."""
    def walk(tree):
        for key, val in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if isinstance(val, (dict, list)):
                walk(val)
            elif key not in F32_LEAVES:
                tree[key] = val.to(dtype)

    walk(params)
    return params


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, device,
                cross: bool = False) -> dict:
    """One layer's params; ``cross`` adds a decoder layer's cross-attention
    (``norm_x``, ``cross``) and keeps its FFN dense, as an ``enc`` layer's."""
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": make_norm_params(cfg, d, device)}
    if kind in ATTN_KINDS or kind == "enc":
        p["attn"] = attention.init_attn_params(cfg, gen, device)
        p["norm2"] = make_norm_params(cfg, d, device)
        p["ffn"] = (moe.init_moe_params(cfg, gen, device)
                    if cfg.moe is not None and not cross and kind != "enc"
                    else mlp.init_mlp_params(cfg, gen, device))
    elif kind == "rglru":
        p["rec"] = griffin.init_griffin_params(cfg, gen, device)
        p["norm2"] = make_norm_params(cfg, d, device)
        p["ffn"] = mlp.init_mlp_params(cfg, gen, device)
    elif kind == "rwkv":
        p["tm"] = rwkv6.init_rwkv_params(cfg, gen, device)
        p["norm2"] = make_norm_params(cfg, d, device)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_x"] = make_norm_params(cfg, d, device)
        p["cross"] = attention.init_attn_params(cfg, gen, device, cross=True)
    return p


@dataclasses.dataclass(frozen=True)
class Span:
    """A data row's positions ``[start, stop)`` of a sequence of ``total``
    positions that the batch specs split over the data axes."""

    start: int
    stop: int
    total: int


def _sequence_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                    positions: torch.Tensor, rwkv_chunk: int,
                    memory: Optional[torch.Tensor] = None, ops=None,
                    span: Optional[Span] = None, carry: Optional[dict] = None):
    """One decoder layer over a whole sequence with no cache (the training
    forward; RG-LRU and RWKV from the zero state), each sub-block
    through ``ops`` (:class:`LocalOps` by default): (x, aux), aux the MoE
    FFN's load-balancing loss, an f32 zero for any other layer.  A
    decoder layer's cross sub-block runs when there is a ``memory``
    (reference ``transformer.py:124-126``).

    On a data row's ``span`` the layer starts from ``carry``, what the rows
    before left it (None for the first row), and returns (x, aux, its
    carry for the next row); a MoE layer's aux is the whole sequence's on
    the last span and zero before."""
    ops = ops or LocalOps(cfg)
    r = ops.read(p)
    h = apply_norm(cfg, r["norm1"], x)
    carry, new = carry or {}, {}
    if kind in ATTN_KINDS:
        if span is None:
            x = x + ops.attend(p["attn"], h, kind, positions)
        else:
            a, new["kv"] = ops.attend_span(p["attn"], h, kind, positions, span.start,
                                           carry.get("kv"))
            x = x + a
        if memory is not None and "cross" in p:
            x = x + ops.cross(p["cross"], apply_norm(cfg, r["norm_x"], x), memory)
        hf = apply_norm(cfg, r["norm2"], x)
        if span is None:
            f, aux = ops.ffn(p["ffn"], hf)
            return x + f, aux
        f, aux, moe_carry = ops.ffn_span(p["ffn"], hf, span, carry.get("moe"))
        if moe_carry is not None:
            new["moe"] = moe_carry
        return x + f, aux, new
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rglru":
        a, state = ops.rglru(p["rec"], h, carry or None)
        x = x + a
        x = x + ops.mlp(p["ffn"], apply_norm(cfg, r["norm2"], x))
        return (x, aux) if span is None else (x, aux, state)
    a, s, tm_x = ops.time_mix(p["tm"], h, carry.get("s"), carry.get("tm_x"), chunk=rwkv_chunk)
    x = x + a
    c, cm_x = ops.channel_mix(p["tm"], apply_norm(cfg, r["norm2"], x), carry.get("cm_x"))
    x = x + c
    return (x, aux) if span is None else (x, aux, {"s": s, "tm_x": tm_x, "cm_x": cm_x})


def _encoder_kv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, ops):
    """An encoder layer's first half on a data row's span of the frames:
    the norm and the span's K/V, as ``ops`` holds them (:meth:`LocalOps.
    encode_kv`)."""
    return ops.encode_kv(p["attn"], apply_norm(cfg, ops.read(p)["norm1"], x), positions)


def _encoder_rest(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, ops,
                  kvs: list) -> torch.Tensor:
    """The rest of the encoder layer on the span: its queries over every
    row's K/V (``kvs``, in row order), ``wo``, the residual and the FFN."""
    r = ops.read(p)
    x = x + ops.encode_attend(p["attn"], apply_norm(cfg, r["norm1"], x), positions, kvs)
    f, _ = ops.ffn(p["ffn"], apply_norm(cfg, r["norm2"], x))
    return x + f


def _init_block_state(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype,
                      device, kv_quant: bool = False) -> dict:
    if kind in ATTN_KINDS:
        spec = attention.cache_spec(cfg, kind, max_seq)
        return attention.init_kv_cache(cfg, spec, batch, dtype, device, quantized=kv_quant)
    if kind == "rglru":
        return griffin.init_griffin_state(cfg, batch, device)
    if kind == "rwkv":
        H = cfg.d_model // cfg.rwkv_head_dim
        hd = cfg.rwkv_head_dim
        return {
            "s": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
            "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        }
    raise ValueError(kind)


class LocalOps:
    """The sub-block operations of the model's layer walks (the training
    forward :meth:`Model.train_loss`, and serving's :meth:`Model.prefill`,
    :meth:`Model.decode_step`, :meth:`Model.encode`) on whole tensors on
    one device.  :class:`repro_torch.sharding.tensor_parallel.RowOps` has
    the same methods for one data row of a mesh."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def read(self, p: dict) -> dict:
        """A node whose leaves the walk reads as they are (norms, the
        blocks it computes itself)."""
        return p

    def lookup(self, table, tokens: torch.Tensor) -> torch.Tensor:
        return table[tokens.long()]

    def unembed(self, table, x_last: torch.Tensor) -> torch.Tensor:
        cd = cdt(self.cfg)
        return (x_last.to(cd) @ table.to(cd).T).float()

    def xent(self, table, x: torch.Tensor, targets: torch.Tensor, *, softcap: float,
             form: str, chunk: int, seq_chunk: int) -> torch.Tensor:
        """Per-token CE (B, S) f32 of ``x`` (B, S, D) against the whole
        unembedding ``table`` (V, D): ``form="naive"`` materializes the
        logits in the compute dtype, the other forms go through
        :func:`repro_torch.kernels.xent.ops.fused_xent`."""
        if form == "naive":
            cd = cdt(self.cfg)
            logits = torch.einsum("bsd,vd->bsv", x.to(cd), table.to(cd)).float()
            if softcap:
                logits = torch.tanh(logits / softcap) * softcap
            lse = torch.logsumexp(logits, dim=-1)
            return lse - torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return xent_ops.fused_xent(x.float(), table.float(), targets, softcap=softcap,
                                   form=form, chunk=chunk, seq_chunk=seq_chunk)

    def attend(self, p, h, kind, positions):
        return attention.attend_train(self.cfg, p, h, kind, positions)

    def attend_span(self, p, h, kind, positions, start: int, kv):
        """Attention of a data row's span from position ``start`` over
        ``kv``, the (k, v) of the positions before it (None at 0): (out,
        the (k, v) up to the span's end, for the next row)."""
        a, k, v = attention.attend_prefill(self.cfg, p, h, kind, positions, prefix=kv,
                                           q_offset=start)
        return a, (k, v)

    def attend_prefill(self, p, h, kind, positions, state, spec, start: int = 0, kv=None):
        """The prompt's attention (a data row's span from ``start`` over
        ``kv``, as :meth:`attend_span`), its K/V written into ``state``:
        (out, state, the (k, v) up to the span's end)."""
        a, k, v = attention.attend_prefill(self.cfg, p, h, kind, positions, prefix=kv,
                                           q_offset=start)
        attention.fill_kv_cache(state, spec, k[:, start:], v[:, start:], positions, start)
        return a, state, (k, v)

    def attend_decode(self, p, h, kind, pos, state, spec):
        return attention.attend_decode(self.cfg, p, h, state, kind, pos, spec)

    def cross(self, p, h, memory):
        return attention.attend_cross(self.cfg, p, h, memory)

    def encode_kv(self, p, h, positions):
        """A span's encoder K/V (:func:`repro_torch.models.attention.encoder_kv`)."""
        return attention.encoder_kv(self.cfg, p, h, positions)

    def encode_attend(self, p, h, positions, kvs):
        """A span's encoder attention over ``kvs``, every span's K/V in order."""
        return attention.attend_encoder_span(self.cfg, p, h, positions,
                                             torch.cat([k for k, _ in kvs], dim=1),
                                             torch.cat([v for _, v in kvs], dim=1))

    def ffn(self, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """The FFN after attention: (out, aux), aux the MoE layer's
        load-balancing loss, an f32 zero for the dense MLP (serving drops
        it)."""
        if "router" in p:
            return moe.apply_moe(self.cfg, p, x)
        return mlp.apply_mlp(self.cfg, p, x), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)

    def ffn_span(self, p, x, span, carry):
        """:meth:`ffn` on a data row's span: (out, aux, the carry; None
        for the dense MLP), the MoE layer's through
        :func:`repro_torch.models.moe.apply_moe_span`."""
        if "router" in p:
            return moe.apply_moe_span(self.cfg, p, x, span, carry)
        return self.ffn(p, x) + (None,)

    def mlp(self, p, x):
        return mlp.apply_mlp(self.cfg, p, x)

    def rglru(self, p, h, state):
        """The RG-LRU block from ``state`` (None: the zero state, no cache):
        (out, the new state)."""
        return griffin.griffin_block(self.cfg, p, h, state)

    def time_mix(self, p, h, state, last_x, chunk: int = 64):
        """RWKV's time-mix from the wkv state ``state`` and the token-shift
        input ``last_x`` (None: zeros): (out, the new state, the new
        ``last_x``)."""
        return rwkv6.time_mix(self.cfg, p, h, state, last_x, chunk=chunk)

    def channel_mix(self, p, x, last_x):
        """RWKV's channel-mix: (out, the new ``last_x``)."""
        return rwkv6.channel_mix(self.cfg, p, x, last_x)

    def read_state(self, state: dict) -> dict:
        return state

    def write_state(self, state: dict, new: dict) -> dict:
        """The layer's new state, in its state's dtypes."""
        return {k: v.to(state[k].dtype) for k, v in new.items()}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    xent_impl: str = "chunked"  # "naive" | "chunked" (vocab) | "seq_chunked"
    xent_chunk: int = 8192
    xent_seq_chunk: int = 256
    remat: bool = True
    remat_policy: str = "block"  # "block" (save nothing) | "dots" (save matmul outputs)
    rwkv_chunk: int = 64
    kv_dtype: str = "compute"  # "compute" | "int8" (the quantized KV cache)

    def __post_init__(self):
        if self.kv_dtype not in ("compute", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.xent_impl not in ("naive", "chunked", "seq_chunked"):
            raise ValueError(f"unknown xent_impl {self.xent_impl!r}")
        if self.remat_policy not in REMAT_CONTEXTS:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    # -- params ---------------------------------------------------------------
    def init_params(self, generator: torch.Generator, device="cuda",
                    store_dtype=None, shardings=None) -> dict:
        """Random params in ``param_dtype``, drawn from ``generator`` on its
        own device and placed on ``device``.  With ``store_dtype`` each
        embedding and layer is stored in it (:func:`store_compute_dtype`)
        as soon as it is drawn: the same draws and values as storing the
        whole tree afterwards, but no more than one layer's or embedding's
        ``param_dtype`` weights exist at a time.  With ``shardings`` (a tree
        of :class:`repro_torch.sharding.placement.NamedSharding` like the
        params, ``ShardingPolicy.shardings(param_specs(...))``) each leaf is
        placed by its sharding as soon as it is drawn and stored, and the
        drawn copy freed: bit for bit ``reshard_tree(init_params(...),
        shardings)``, but ``device`` never holds more than its blocks and
        one layer's draw, so a model larger than one device is drawn
        straight into its blocks.  The draws come in one order whatever
        the depth (the embeddings and the final norm before the layers), so
        the first L layers of a deeper model from one seed are those of
        the L-layer model.  On ``device="meta"`` the tree has its shapes
        and dtypes and nothing is drawn (``generator`` may be None):
        :func:`repro_torch.launch.inputs.abstract_params`."""
        from repro_torch.ft.resilience import reshard_tree

        cfg = self.cfg
        dev = resolve(device)

        def placed(tree, path):
            if shardings is None:
                return tree
            sh = shardings
            for key in path:
                sh = sh[key]
            return reshard_tree(tree, sh)

        def stored(tree, path):
            tree = tree if store_dtype is None else store_compute_dtype(tree, store_dtype)
            return placed(tree, path)

        def embed(name):
            w = embed_init(generator, (cfg.vocab_size, cfg.d_model), pdt(cfg), dev)
            return placed(w if store_dtype is None else w.to(store_dtype), (name,))

        params: Dict[str, Any] = {
            "embed": embed("embed"),
            "final_norm": placed(make_norm_params(cfg, cfg.d_model, dev), ("final_norm",)),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed("unembed")
        params["layers"] = [
            stored(_init_block(cfg, kind, generator, dev, cross=cfg.is_encdec), ("layers", i))
            for i, kind in enumerate(cfg.blocks())]
        if cfg.is_encdec:
            params["enc_layers"] = [stored(_init_block(cfg, "enc", generator, dev),
                                           ("enc_layers", i))
                                    for i in range(cfg.encoder_layers)]
        return params

    # -- embedding ------------------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor, ops=None) -> torch.Tensor:
        cfg = self.cfg
        x = (ops or LocalOps(cfg)).lookup(params["embed"], tokens).to(cdt(cfg))
        if cfg.emb_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt(cfg))
        return x

    def _input(self, params, batch: dict, ops=None) -> torch.Tensor:
        """The stack's input: ``batch["embeds"]`` (the vision stub's patch
        embeddings) in the compute dtype when given, else the embedding of
        ``batch["tokens"]``."""
        if "embeds" in batch:
            return batch["embeds"].to(cdt(self.cfg))
        return self._embed(params, batch["tokens"], ops)

    def _unembed_matrix(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["unembed"]

    def _logits_last(self, params, x_last: torch.Tensor, ops=None) -> torch.Tensor:
        """Logits for one position per batch row, f32 (B, V)."""
        cfg = self.cfg
        logits = (ops or LocalOps(cfg)).unembed(self._unembed_matrix(params), x_last)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return logits

    # -- losses ---------------------------------------------------------------
    def _xent(self, params, x: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, ops=None) -> torch.Tensor:
        """Mean CE over masked positions.  x: (B, S, D); targets: (B, S);
        the unembedding of ``params`` as it is placed, through ``ops.xent``
        (on a mesh, each model coordinate's vocab block)."""
        total, count = self._xent_sum(params, x, targets, mask, ops)
        return total / torch.clamp(count, min=1.0)

    def _xent_sum(self, params, x, targets, mask, ops=None):
        """(Σ of the masked CE, the mask's total): :meth:`_xent` before its
        division, so that the spans of a split sequence add up."""
        ce = (ops or LocalOps(self.cfg)).xent(
            self._unembed_matrix(params), x, targets, softcap=self.cfg.logit_softcap,
            form=self.xent_impl, chunk=self.xent_chunk, seq_chunk=self.xent_seq_chunk)
        return (ce * mask).sum(), mask.sum()

    def _stack(self, layers, kinds, x: torch.Tensor, memory=None,
               remat: bool = False, ops=None, span: Optional[Span] = None, carry=None):
        """One stack of layers over whole sequences with no cache, each
        sub-block through ``ops`` (:class:`LocalOps` by default), each layer
        under ``checkpoint`` (with ``remat_policy``'s context) when
        ``remat``: (x, the sum of the layers' aux losses in layer order).
        The non-reentrant ``checkpoint`` runs the layer's Python again in
        the backward pass, so ``ops``' per-device work is recomputed on its
        own devices.  On a data row's ``span`` each layer starts from its
        entry of ``carry`` (None: the first row), an input of its
        checkpoint, and the stack returns (x, aux, each layer's carry)."""
        B, S = x.shape[:2]
        p0 = 0 if span is None else span.start
        positions = torch.arange(p0, p0 + S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        carried = []
        for i, (kind, p) in enumerate(zip(kinds, layers)):
            args = (self.cfg, kind, p, x, positions, self.rwkv_chunk, memory, ops)
            if span is not None:
                args += (span, carry[i] if carry else None)
            if remat:
                out = checkpoint(_sequence_block, *args, use_reentrant=False,
                                 context_fn=REMAT_CONTEXTS[self.remat_policy])
            else:
                out = _sequence_block(*args)
            x, a = out[:2]
            carried += out[2:]
            aux = aux + a
        return (x, aux) if span is None else (x, aux, carried)

    def train_loss(self, params, batch: dict, ops=None) -> Tuple[torch.Tensor, dict]:
        """(loss, {"ce", "aux"}) of the batch against ``batch["targets"]``
        (B, S), weighted by ``batch["mask"]`` (default all ones): loss = ce +
        aux, aux the decoder stack's summed MoE aux losses.  The input is
        ``batch["tokens"]`` (B, S) or ``batch["embeds"]`` (B, S, D); an
        enc-dec config also takes ``batch["src_embeds"]`` (B, T, D), encoded
        with remat as the decoder is, and its decoder's output goes to the
        loss without ``final_norm``, as in the reference
        (``transformer.py:366-398``).  Every sub-block, the input's lookup,
        the reads of norms and the CE on the unembedding go through ``ops``
        (:class:`LocalOps` by default; the sharded train step's
        :class:`repro_torch.sharding.tensor_parallel.RowOps`)."""
        cfg = self.cfg
        ops = ops or LocalOps(cfg)
        top = ops.read(params)
        targets = batch["targets"]
        memory = None
        if cfg.is_encdec:
            memory = self.encode(params, batch["src_embeds"], ops, remat=self.remat)
        x, aux = self._stack(params["layers"], cfg.blocks(), self._input(params, batch, ops),
                             memory, remat=self.remat, ops=ops)
        if not cfg.is_encdec:
            x = apply_norm(cfg, top["final_norm"], x)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
        ce = self._xent(params, x, targets, mask, ops)
        return ce + aux, {"ce": ce, "aux": aux}

    def train_span(self, params, batch: dict, span: Span, carry=None, ops=None,
                   memory: Optional[torch.Tensor] = None):
        """:meth:`train_loss`'s forward on a data row's ``span`` of a
        sequence split over the data axes (``batch`` the span's tokens or
        embeds, targets and mask), each layer from its entry of ``carry``
        (what the rows before left; None for the first row).  An enc-dec
        decoder attends to ``memory``, the encoder's output: whole, or (the
        sharded steps' ``RowOps``) the data rows' spans of it
        (:meth:`encode_spans`) joined on each device.
        Returns (Σ of the span's masked CE, its mask total, its share of the
        aux loss (the whole sequence's on the last span), each layer's
        carry): the sequence's loss is Σ CE / Σ mask + Σ aux over the
        spans."""
        cfg = self.cfg
        ops = ops or LocalOps(cfg)
        x, aux, carry = self._stack(params["layers"], cfg.blocks(),
                                    self._input(params, batch, ops), memory,
                                    remat=self.remat, ops=ops, span=span, carry=carry)
        if not cfg.is_encdec:
            x = apply_norm(cfg, ops.read(params)["final_norm"], x)
        targets = batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
        total, count = self._xent_sum(params, x, targets, mask, ops)
        return total, count, aux, carry

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device="cuda") -> List[dict]:
        """One state dict per (decoder) layer: K/V/pos for attention (ring
        buffers for windowed layers; int8 K/V and their scales with
        ``kv_dtype="int8"``), (h, conv) for RG-LRU, (s, tm_x, cm_x) for
        RWKV."""
        dev = resolve(device)
        return [self._block_state(kind, batch, max_seq, dev) for kind in self.cfg.blocks()]

    def _block_state(self, kind: str, batch: int, max_seq: int, device) -> dict:
        return _init_block_state(self.cfg, kind, batch, max_seq, cdt(self.cfg), device,
                                 kv_quant=self.kv_dtype == "int8")

    def encode(self, params, src_embeds: torch.Tensor, ops=None,
               remat: bool = False) -> torch.Tensor:
        """The encoder (enc-dec configs): frame embeddings (B, T, D) → the
        memory (B, T, D) the decoder attends to, through the ``enc`` layers
        (K5, ``causal=False``; under ``checkpoint`` when ``remat``, as the
        training loss runs them) and the decoder's ``final_norm``, as in the
        reference (``transformer.py:417-427``): :meth:`encode_spans` over
        one span of every frame."""
        T = src_embeds.shape[1]
        return self.encode_spans(params, [src_embeds], [Span(0, T, T)],
                                 [ops or LocalOps(self.cfg)], remat=remat)[0]

    def encode_spans(self, params, srcs: List[torch.Tensor], spans: List[Span], ops_by_row: list,
                     remat: bool = False) -> List[torch.Tensor]:
        """:meth:`encode` of frames split over data rows: row j holds
        ``srcs[j]`` (B, T_j, D), the frames ``spans[j]`` of the utterance, and
        computes through ``ops_by_row[j]``.  The encoder sees every frame, so
        the walk goes layer by layer across the rows: (a) every row's norm
        and K/V of its span (:meth:`LocalOps.encode_kv`), then (b) every
        row's queries over all rows' K/V in row order
        (:meth:`LocalOps.encode_attend`: K5 without the mask), ``wo``, the
        residual and the FFN on its span.  No row holds the whole activation.
        Under ``remat`` each row's (a) and (b) run under ``checkpoint``, and
        (b)'s inputs hold every row's K/V, so the one backward recomputes
        each and hands each row's K/V its share of the gradient from every
        row's queries.  Returns the memory as spans: row j's (B, T_j, D)
        after ``final_norm``, on its device."""
        cfg = self.cfg
        xs = [s.to(cdt(cfg)) for s in srcs]
        positions = [torch.arange(sp.start, sp.stop, dtype=torch.int32,
                                  device=x.device)[None].expand(x.shape[0], -1)
                     for sp, x in zip(spans, xs)]
        context = REMAT_CONTEXTS[self.remat_policy]

        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False, context_fn=context)
            return fn(*args)

        for p in params["enc_layers"]:
            kvs = [run(_encoder_kv, cfg, p, x, pos, ops)
                   for x, pos, ops in zip(xs, positions, ops_by_row)]
            xs = [run(_encoder_rest, cfg, p, x, pos, ops, kvs)
                  for x, pos, ops in zip(xs, positions, ops_by_row)]
        return [apply_norm(cfg, ops.read(params)["final_norm"], x)
                for x, ops in zip(xs, ops_by_row)]

    def prefill(self, params, batch: dict, max_seq: int,
                memory: Optional[torch.Tensor] = None, ops=None,
                states=None) -> Tuple[List[dict], torch.Tensor]:
        """Process a prompt (``batch["tokens"]``: (B, S), or
        ``batch["embeds"]``: (B, S, D)), build the caches and return (cache,
        last-token logits).  Caches start from the zero
        state, so RWKV layers run K7, and RG-LRU layers the doubling scan.
        An enc-dec config's decoder attends to ``memory`` (from
        :meth:`encode`), or to the encoding of ``batch["src_embeds"]`` when
        no memory is given; with neither, it runs without its cross
        sub-blocks.  ``ops`` and ``states`` (the empty caches to fill) are
        the sharded step's (:class:`LocalOps`)."""
        cfg = self.cfg
        ops = ops or LocalOps(cfg)
        if cfg.is_encdec and memory is None and "src_embeds" in batch:
            memory = self.encode(params, batch["src_embeds"], ops)
        x = self._input(params, batch, ops)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        if states is None:
            states = self.init_cache(B, max_seq, x.device)
        return self._walk(ops, params, x, states, positions, max_seq, memory, decode=False)[:2]

    def prefill_span(self, params, batch: dict, max_seq: int, states, span: Span, carry=None,
                     ops=None, memory: Optional[torch.Tensor] = None):
        """:meth:`prefill` of a data row's ``span`` of a prompt split over
        the data axes into the cache ``states`` (the rows before filled
        theirs), each attention and MoE layer from its entry of ``carry``
        (None for the first row), each recurrent layer from the state the
        row before wrote; an enc-dec decoder attends to ``memory``, whole or
        (the sharded steps' ``RowOps``) as the data rows' spans
        (:meth:`encode_spans`) joined on each device.  Returns (states, the
        prompt's last-token logits on its last span, else None, each layer's
        carry)."""
        ops = ops or LocalOps(self.cfg)
        x = self._input(params, batch, ops)
        B, S = x.shape[:2]
        positions = torch.arange(span.start, span.start + S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        return self._walk(ops, params, x, states, positions, max_seq, memory, decode=False,
                          span=span, carry=carry)

    def decode_step(self, params, states: List[dict], tokens: torch.Tensor,
                    pos, max_seq: int, memory: Optional[torch.Tensor] = None,
                    ops=None) -> Tuple[torch.Tensor, List[dict]]:
        """One token for the whole batch.  tokens: (B, 1); pos: an int or a
        (B,) tensor of per-lane absolute positions; ``memory``: an enc-dec
        config's encoder output, whose cross K/V each step projects anew, as
        the reference's does.  KV caches are updated in place.  Returns
        (logits (B, V) f32, states)."""
        ops = ops or LocalOps(self.cfg)
        x = self._embed(params, tokens, ops)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(tokens.shape[0])
        states, logits, _ = self._walk(ops, params, x, states, pos, max_seq, memory,
                                       decode=True)
        return logits, states

    def _walk(self, ops, params, x: torch.Tensor, states: List[dict], positions,
              max_seq: int, memory, decode: bool, span: Optional[Span] = None,
              carry=None) -> Tuple[List[dict], Optional[torch.Tensor], List[dict]]:
        """The decoder stack over ``x`` with a cache, the one layer walk of
        the prefill (``positions`` (B, S), empty ``states`` filled; on a data
        row's ``span``, from the ``carry`` of the rows before and the states
        they wrote) and of a decode step (``positions`` the (B,) slots'
        positions, ``states`` read and updated), each sub-block through
        ``ops``.  Returns (the states, the last position's logits (None on a
        span before the last), each layer's carry (on a span))."""
        cfg = self.cfg
        out, carried = [], []
        for i, (kind, p, state) in enumerate(zip(cfg.blocks(), params["layers"], states)):
            r = ops.read(p)
            h = apply_norm(cfg, r["norm1"], x)
            prev, new = (carry[i] if carry else {}), {}
            if kind in ATTN_KINDS:
                spec = attention.cache_spec(cfg, kind, max_seq)
                if decode:
                    a, state = ops.attend_decode(p["attn"], h, kind, positions, state, spec)
                elif span is None:
                    a, state, _ = ops.attend_prefill(p["attn"], h, kind, positions, state, spec)
                else:
                    a, state, new["kv"] = ops.attend_prefill(p["attn"], h, kind, positions,
                                                             state, spec, span.start,
                                                             prev.get("kv"))
                x = x + a
                if memory is not None and "cross" in p:
                    x = x + ops.cross(p["cross"], apply_norm(cfg, r["norm_x"], x), memory)
                hf = apply_norm(cfg, r["norm2"], x)
                if span is None:
                    x = x + ops.ffn(p["ffn"], hf)[0]
                else:
                    f, _, moe_carry = ops.ffn_span(p["ffn"], hf, span, prev.get("moe"))
                    x = x + f
                    if moe_carry is not None:
                        new["moe"] = moe_carry
            elif kind == "rglru":  # a later span from the state the row before wrote
                a, rec = ops.rglru(p["rec"], h, ops.read_state(state))
                state = ops.write_state(state, rec)
                x = x + a
                x = x + ops.mlp(p["ffn"], apply_norm(cfg, r["norm2"], x))
            else:  # a prompt's first span from the zero state, a later one from the cache
                st = (ops.read_state(state) if decode or (span is not None and span.start)
                      else dict.fromkeys(state))
                a, s_new, tm_x = ops.time_mix(p["tm"], h, st["s"], st["tm_x"],
                                              chunk=self.rwkv_chunk)
                x = x + a
                c, cm_x = ops.channel_mix(p["tm"], apply_norm(cfg, r["norm2"], x), st["cm_x"])
                x = x + c
                state = ops.write_state(state, {"s": s_new, "tm_x": tm_x, "cm_x": cm_x})
            out.append(state)
            carried.append(new)
        if span is not None and span.stop < span.total:
            return out, None, carried
        x = apply_norm(cfg, ops.read(params)["final_norm"], x)
        return out, self._logits_last(params, x[:, -1], ops), carried
