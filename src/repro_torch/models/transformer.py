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


def _cross(cfg: ModelConfig, p: dict, x: torch.Tensor, memory) -> torch.Tensor:
    """The cross sub-block after self-attention: a residual attention over
    ``memory`` in decoder layers when there is one (reference
    ``transformer.py:124-126``); ``x`` as it is otherwise."""
    if memory is None or "cross" not in p:
        return x
    return x + attention.attend_cross(cfg, p["cross"], apply_norm(cfg, p["norm_x"], x), memory)


def _sequence_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                    positions: torch.Tensor, rwkv_chunk: int,
                    memory: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over a whole sequence with no cache (the training forward
    and the encoder; RG-LRU and RWKV from the zero state): (x, aux), aux
    the MoE FFN's load-balancing loss, an f32 zero for any other layer."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    if kind in ATTN_KINDS or kind == "enc":
        x = x + attention.attend_train(cfg, p["attn"], h, kind, positions)
        x = _cross(cfg, p, x, memory)
        h2 = apply_norm(cfg, p["norm2"], x)
        if "router" in p["ffn"]:
            f, aux = moe.apply_moe(cfg, p["ffn"], h2)
        else:
            f = mlp.apply_mlp(cfg, p["ffn"], h2)
        return x + f, aux
    if kind == "rglru":
        a, _ = griffin.griffin_block(cfg, p["rec"], h)
        x = x + a
        return x + mlp.apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x)), aux
    a, _, _ = rwkv6.time_mix(cfg, p["tm"], h, None, None, chunk=rwkv_chunk)
    x = x + a
    c, _ = rwkv6.channel_mix(cfg, p["tm"], apply_norm(cfg, p["norm2"], x))
    return x + c, aux


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The FFN after attention: the MoE layer (its aux loss dropped, as in
    serving) or the dense MLP."""
    if "router" in p:
        return moe.apply_moe(cfg, p, x)[0]
    return mlp.apply_mlp(cfg, p, x)


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
                    store_dtype=None) -> dict:
        """Random params in ``param_dtype``, drawn from ``generator`` on its
        own device and placed on ``device``.  With ``store_dtype`` each
        embedding and layer is stored in it (:func:`store_compute_dtype`)
        as soon as it is drawn: the same draws and values as storing the
        whole tree afterwards, but no more than one layer's or embedding's
        ``param_dtype`` weights exist at a time.  On ``device="meta"`` the
        tree has its shapes and dtypes and nothing is drawn (``generator``
        may be None): :func:`repro_torch.launch.inputs.abstract_params`."""
        cfg = self.cfg
        dev = resolve(device)

        def stored(tree):
            return tree if store_dtype is None else store_compute_dtype(tree, store_dtype)

        def embed():
            w = embed_init(generator, (cfg.vocab_size, cfg.d_model), pdt(cfg), dev)
            return w if store_dtype is None else w.to(store_dtype)

        params: Dict[str, Any] = {
            "embed": embed(),
            "final_norm": make_norm_params(cfg, cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed()
        params["layers"] = [stored(_init_block(cfg, kind, generator, dev, cross=cfg.is_encdec))
                            for kind in cfg.blocks()]
        if cfg.is_encdec:
            params["enc_layers"] = [stored(_init_block(cfg, "enc", generator, dev))
                                    for _ in range(cfg.encoder_layers)]
        return params

    # -- embedding ------------------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(cdt(cfg))
        if cfg.emb_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt(cfg))
        return x

    def _input(self, params, batch: dict) -> torch.Tensor:
        """The stack's input: ``batch["embeds"]`` (the vision stub's patch
        embeddings) in the compute dtype when given, else the embedding of
        ``batch["tokens"]``."""
        if "embeds" in batch:
            return batch["embeds"].to(cdt(self.cfg))
        return self._embed(params, batch["tokens"])

    def _unembed_matrix(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["unembed"]

    def _logits_last(self, params, x_last: torch.Tensor) -> torch.Tensor:
        """Logits for one position per batch row, f32 (B, V)."""
        cfg = self.cfg
        W = self._unembed_matrix(params)
        logits = (x_last.to(cdt(cfg)) @ W.to(cdt(cfg)).T).float()
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return logits

    # -- losses ---------------------------------------------------------------
    def _xent(self, params, x: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """Mean CE over masked positions.  x: (B, S, D); targets: (B, S)."""
        cfg = self.cfg
        W = self._unembed_matrix(params)  # (V, D)
        denom = torch.clamp(mask.sum(), min=1.0)
        if self.xent_impl == "naive":
            cd = cdt(cfg)
            logits = torch.einsum("bsd,vd->bsv", x.to(cd), W.to(cd)).float()
            if cfg.logit_softcap:
                logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
            return ((lse - tgt) * mask).sum() / denom
        ce = xent_ops.fused_xent(x.float(), W.float(), targets, softcap=cfg.logit_softcap,
                                 form=self.xent_impl, chunk=self.xent_chunk,
                                 seq_chunk=self.xent_seq_chunk)
        return (ce * mask).sum() / denom

    def _stack(self, layers, kinds, x: torch.Tensor, memory=None,
               remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """One stack of layers over whole sequences with no cache, each layer
        under ``checkpoint`` (with ``remat_policy``'s context) when
        ``remat``: (x, the sum of the layers' aux losses in layer order)."""
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p in zip(kinds, layers):
            args = (self.cfg, kind, p, x, positions, self.rwkv_chunk, memory)
            if remat:
                x, a = checkpoint(_sequence_block, *args, use_reentrant=False,
                                  context_fn=REMAT_CONTEXTS[self.remat_policy])
            else:
                x, a = _sequence_block(*args)
            aux = aux + a
        return x, aux

    def train_loss(self, params, batch: dict) -> Tuple[torch.Tensor, dict]:
        """(loss, {"ce", "aux"}) of the batch against ``batch["targets"]``
        (B, S), weighted by ``batch["mask"]`` (default all ones): loss = ce +
        aux, aux the decoder stack's summed MoE aux losses.  The input is
        ``batch["tokens"]`` (B, S) or ``batch["embeds"]`` (B, S, D); an
        enc-dec config also takes ``batch["src_embeds"]`` (B, T, D), encoded
        with remat as the decoder is, and its decoder's output goes to the
        loss without ``final_norm``, as in the reference
        (``transformer.py:366-398``)."""
        cfg = self.cfg
        targets = batch["targets"]
        memory = None
        if cfg.is_encdec:
            memory, _ = self._stack(params["enc_layers"], ("enc",) * cfg.encoder_layers,
                                    batch["src_embeds"].to(cdt(cfg)), remat=self.remat)
            memory = apply_norm(cfg, params["final_norm"], memory)
        x, aux = self._stack(params["layers"], cfg.blocks(), self._input(params, batch),
                             memory, remat=self.remat)
        if not cfg.is_encdec:
            x = apply_norm(cfg, params["final_norm"], x)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)
        ce = self._xent(params, x, targets, mask)
        return ce + aux, {"ce": ce, "aux": aux}

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

    def encode(self, params, src_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder (enc-dec configs): frame embeddings (B, T, D) → the
        memory (B, T, D) the decoder attends to, through the ``enc`` layers
        (K5, ``causal=False``) and the decoder's ``final_norm``, as in the
        reference (``transformer.py:417-427``)."""
        cfg = self.cfg
        x, _ = self._stack(params["enc_layers"], ("enc",) * cfg.encoder_layers,
                           src_embeds.to(cdt(cfg)))
        return apply_norm(cfg, params["final_norm"], x)

    def prefill(self, params, batch: dict, max_seq: int,
                memory: Optional[torch.Tensor] = None) -> Tuple[List[dict], torch.Tensor]:
        """Process a prompt (``batch["tokens"]``: (B, S), or
        ``batch["embeds"]``: (B, S, D)), build the caches and return (cache,
        last-token logits).  Caches start from the zero
        state, so RWKV layers run K7, and RG-LRU layers the doubling scan.
        An enc-dec config's decoder attends to ``memory`` (from
        :meth:`encode`), or to the encoding of ``batch["src_embeds"]`` when
        no memory is given; with neither, it runs without its cross
        sub-blocks."""
        cfg = self.cfg
        if cfg.is_encdec and memory is None and "src_embeds" in batch:
            memory = self.encode(params, batch["src_embeds"])
        x = self._input(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        states = []
        for kind, p in zip(cfg.blocks(), params["layers"]):
            h = apply_norm(cfg, p["norm1"], x)
            state = self._block_state(kind, B, max_seq, x.device)
            if kind in ATTN_KINDS:
                a, k, v = attention.attend_prefill(cfg, p["attn"], h, kind, positions)
                attention.fill_kv_cache(state, attention.cache_spec(cfg, kind, max_seq),
                                        k, v, positions)
                x = _cross(cfg, p, x + a, memory)
                x = x + _ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
            elif kind == "rglru":
                a, state = griffin.griffin_block(cfg, p["rec"], h, state)
                x = x + a
                x = x + mlp.apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
            else:
                a, s_new, tm_x = rwkv6.time_mix(cfg, p["tm"], h, None, None,
                                                chunk=self.rwkv_chunk)
                x = x + a
                c, cm_x = rwkv6.channel_mix(cfg, p["tm"], apply_norm(cfg, p["norm2"], x))
                x = x + c
                state = {"s": s_new, "tm_x": tm_x.to(state["tm_x"].dtype),
                         "cm_x": cm_x.to(state["cm_x"].dtype)}
            states.append(state)
        x = apply_norm(cfg, params["final_norm"], x)
        return states, self._logits_last(params, x[:, -1])

    def decode_step(self, params, states: List[dict], tokens: torch.Tensor,
                    pos, max_seq: int,
                    memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[dict]]:
        """One token for the whole batch.  tokens: (B, 1); pos: an int or a
        (B,) tensor of per-lane absolute positions; ``memory``: an enc-dec
        config's encoder output, whose cross K/V each step projects anew, as
        the reference's does.  KV caches are updated in place.  Returns
        (logits (B, V) f32, states)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(B)
        new_states = []
        for kind, p, state in zip(cfg.blocks(), params["layers"], states):
            h = apply_norm(cfg, p["norm1"], x)
            if kind in ATTN_KINDS:
                spec = attention.cache_spec(cfg, kind, max_seq)
                a, state = attention.attend_decode(cfg, p["attn"], h, state, kind, pos, spec)
                x = _cross(cfg, p, x + a, memory)
                x = x + _ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
            elif kind == "rglru":
                a, state = griffin.griffin_block(cfg, p["rec"], h, state)
                x = x + a
                x = x + mlp.apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
            else:
                a, s_new, tm_x = rwkv6.time_mix(cfg, p["tm"], h, state["s"], state["tm_x"],
                                                chunk=self.rwkv_chunk)
                x = x + a
                c, cm_x = rwkv6.channel_mix(cfg, p["tm"], apply_norm(cfg, p["norm2"], x),
                                            state["cm_x"])
                x = x + c
                state = {"s": s_new, "tm_x": tm_x.to(state["tm_x"].dtype),
                         "cm_x": cm_x.to(state["cm_x"].dtype)}
            new_states.append(state)
        x = apply_norm(cfg, params["final_norm"], x)
        return self._logits_last(params, x[:, 0]), new_states
