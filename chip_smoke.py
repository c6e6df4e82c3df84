#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--out FILE] [--mesh-only | --sharded-only]

Drives the port's paths — the paper's sequential pipeline, the DAG path
and the LM serving path, served, the paper's train → fuse → plan → emit C
→ gcc flow, and the LM training path, trained — and holds their kernels
against their plain PyTorch versions:

1. builds kernels K1 (``src/repro_torch/csrc/conv_pool.cu``), K2
   (``conv_pool_q8.cu``), K3 (``conv_pool_dw.cu``), K4
   (``conv_pool_dw_q8.cu``), K5 (``flash_fwd.cu``), K6 (``xent_fwd.cu``)
   and K7 (``wkv_fwd.cu``) with ``nvcc``, one process each, in parallel,
   and counts the tensor-core instructions (HGMMA, HMMA) in K5's and K6's
   SASS (``cuobjdump --dump-sass``): none in either fails the run;
2. holds each kernel against its plain version on the card: K1 on the
   reference's kernel test geometries plus an average-pool, a multi-tile
   (128x128), a rectangular case, MobileNet's head (256->256 1x1, 256 KB
   of f32 weights, avg 2x2, one launch), DS-CNN-KWS's head (64->64 1x1
   on 25x5, avg 25x5) and two wide 3x3 layers whose staged input K1 cuts
   into chunks of input channels (128->64 at 112x112, 256->64 at 56x56,
   one launch each), batches 1/8/16, f32 at
   rtol=atol=1e-5 and bf16 at 5e-2; K2 bit-exact on the §5 CIFAR
   conv1-conv3 geometries, the DS-CNN-KWS and MobileNet-V1 0.25 int8 heads
   and K1's two wide layers (batches 1/4/16), and a wider layer whose
   staged input K2 cuts into chunks (batches 1/4), max and average pools,
   one launch a call; K3 (f32
   1e-5, bf16 5e-2) and K4 (bit-exact, per-channel multipliers that make
   ties and saturation) on every depthwise shape of DS-CNN-KWS and
   MobileNet-V1 0.25 plus stride 2, 2x2 max and avg pools, no bias and no
   ReLU, batches 1/8/16, the streaming row blocks (64 channels, 3-9 rows
   of a width-5 map padded to 7, padding 0), and K3 with 5x5 and 3x1
   filters; plus one call
   of each kernel through strided arena views, as the executors make
   them; K5 on the Llama-3.2-1B attention
   shapes (H=32, K=8, h=64) at S 1/17/128/129/512/1000 and batch 1/2, a
   window, a softcap, h=128 and 256, RecurrentGemma-9B's and
   Qwen2-MoE's served shapes at S 509 and RecurrentGemma's at S 1000
   under a window of 256, Qwen2-VL-7B's GQA 7:1 (28 query heads over 4
   KV heads, h 128) at S 509 / 1,000 and its train shape (4, 512), without
   the causal mask at Seamless-M4T's encoder (S = T = 1,000) and
   cross-attention shapes (S 8 / 16 over T 509 / 1,000), strided views and
   views whose rows are not 16-byte aligned (f32 2e-5, bf16 5e-2 and each row within 2e-2
   of its largest value); K7 on the RWKV6-7B
   shapes (H=64, h=64) at S 2/63/64/256/509, chunk 64 and 8, f32 and bf16
   inputs, from the zero state and (S 63/256/509) from a carried state,
   and two other head shapes (o and s_final at rtol 1e-4, atol 1e-5 plus
   the f32 rounding of two summation orders, see ``k7_checks``); K6
   (3xTF32 on the tensor cores) on the five train shapes (N, D, V) =
   (4,096, 2,048, 128,256), (2,048, 4,096, 65,536), (2,048, 4,096,
   256,000), (2,048, 2,048, 151,936) and (2,048, 3,584, 152,064), an odd N
   with a vocab tail, a softcap of 30 and a vocab of 37, targets at 0, V-1
   and inside the last tile, at one split and at the automatic count (per
   token within 1e-5 relative + 1e-5 + 8 f32 epsilons of |x| max|w|, see
   ``K6_CASES``; the worst share of those epsilons is printed); and each
   autograd Function (K5, K6, K7 forward, the
   plain VJP backward) at small f32 shapes: a ``grad_fn``, one launch, and
   gradients equal to autograd through the plain version at 1e-5;
3. serves 64 requests in bursts of 8 through six engines (bucket ladder
   1/2/4/8/16): LeNet-5 f32 and §5 CIFAR int8 (sequential), DS-CNN-KWS and
   MobileNet-V1 0.25 in f32 and int8 (DAG), with every launch counter set
   to 0 just before and read just after each; checks the outputs against
   the port's plain path on a CPU copy (f32 at 1e-5 for LeNet, 1e-4 for the
   DAG nets; int8 bit-exact), the launches per batch (LeNet K1 2; CIFAR K2
   3; DS-CNN-KWS K3 4 + K1 1, or K4 4 + K2 1; MobileNet K3 13 + K1 1, or K4
   13 + K2 1; no other kernel), and that each executor's arena is exactly
   the plan's per image (8,800 / 11,264 / 64,000 / 16,000 / 98,304 /
   24,576 B); the engines' span tracer gives the host time of each stage of
   a batch (coalesce, stage, dispatch, device, complete); then
   (``mesh_phase``) serves the same six engines 64 requests in bursts of
   16 four ways: without a mesh, with ``mesh=make_data_mesh()`` (the one
   card), with a mesh of 4 shards over the one card and with
   ``persistent_cache_dir=`` a fresh directory: outputs bit-equal to the
   engine without a mesh, launches per batch equal (x4 on the shards),
   arenas the plan's bytes an image, and times each executor on one batch
   of 4,096 and one of 32,768 without a mesh, over 4 shards of the card
   and, on a machine of several cards, over them all, with each card's
   busy span (``--mesh-only`` stops after this phase);
   a second process loads K1-K4 from that directory and launches them
   with no ``nvcc`` run;
   then streams keyword spotting (``stream_phase``): DS-CNN and DS-CNN-KWS,
   f32 and int8, through ``StreamServer``, 4 streams opened at once and 256
   synthetic MFCC frames each pushed in turn, against the sliding
   full-window oracle on the card's plain path (int8 bit-exact at every
   emission, f32 at 1e-4, smoothed labels equal), K3 or K4 12 launches an
   emission, 4 an open, 0 a non-emitting frame, ring state and ring arena
   bytes pinned; push µs (p50 / p99), µs a frame against a batch-1 full
   recompute, and one profiled emission recorded; and times each compiled
   segment of the five report workloads, f32 and int8, with CUDA events
   (``report_phase``, `repro_torch.obs.report.workload_report`): each
   arena timeline's peak equal to its plan's bytes, DS-CNN's 2,539,840
   MACs;
4. runs one batch of 16 of ``residual_cifar`` (joins and branches) through
   the DAG executor in f32 and int8 against the CPU path;
5. emits C (``repro_torch.core.export_c``) for each of the six engines,
   builds it with ``gcc -O2 -std=c99 -lm`` and feeds it the first 16
   requests the engine served: int8 equal to the card's outputs bit for
   bit, f32 within the reference's C tests' tolerances, each C arena the
   plan's bytes; then the paper's flow: LeNet-5 trained on the card (150
   AdamW steps on the synthetic digits), fused, planned (8,800 B),
   emitted and built, its C engine held to the card's ``CNNEngine`` (K1)
   on 16 held-out digits at rtol 1e-4, atol 1e-5, at least 7 right
   (``c_export_phase``); no gcc fails the run;
6. serves Llama-3.2-1B (16 requests, 8 lanes, 32 new tokens), RWKV6-7B,
   RecurrentGemma-9B, Qwen2-MoE-A2.7B, Llama-3-8B, Nemotron-4-15B and
   Qwen2-VL-7B's text decoder (8 requests, 4 lanes, 16 new tokens each) at
   full width and depth, bf16 compute (each layer's weights stored in bf16
   as it is drawn), through ``Engine``, one model at a time: every request
   done, K5 = 16 / K7 = 32 / K5 = 12 / K5 = 24 / K5 = 32 / K5 = 32 / K5 =
   28 launches per prefill (no other kernel), the KV/state bytes
   (268,959,744 / 136,314,880 / 54,788,096 / 805,699,584 / 537,395,200 /
   537,395,200 / 235,339,776 B), each prompt's
   logits against the plain path on the card (the same model with K5/K7
   swapped for their plain versions, ``plain_kernels``), TTFT, prefill and
   decode tokens/s, peak memory, and the device time of K5 / K7, the
   RG-LRU scan and the MoE einsums over the served prompts' prefills;
   Qwen2-VL-7B then from patch embeddings (``vl_embeds_phase``): 4 lanes
   of 509 embedding rows through ``Model.prefill(batch={"embeds": ...})``,
   K5 28 launches, then 16 greedy decode steps on tokens, none, the
   prefill's logits against the plain path (``LM_LOGITS_TOL``), TTFT, ms a
   decode step and peak memory;
   then Seamless-M4T-large-v2 at full size (``encdec_phase``): two batches
   of 4 utterances (509 frames and 8-token prompts, 1,000 frames and
   16-token prompts), each ``encode`` -> ``prefill(memory=)`` -> 32 greedy
   steps of ``make_decode_step`` with ``memory``, K5 72 launches a batch
   (24 encoder and 24 cross without the mask, 24 causal) and none a decode
   step, the prefill logits against the plain path (``LM_LOGITS_TOL``),
   encode / prefill /
   TTFT ms, ms a decode step, tokens/s and K5's device ms; then
   Llama-3.2-1B through ``Engine`` with ``kv_dtype="int8"`` and the bf16
   cache (``kv_int8_phase``): 143,130,624 against 268,959,744 state bytes,
   the first prefill's and decode step's logits within
   tests/test_kv_quant.py's tolerances, ms a decode step both ways;
7. holds each served architecture at full width, 2 layers (RecurrentGemma 3;
   Seamless 2 encoder and 2 decoder layers over 200 frames, its training
   loss and gradients too, at step 9's limits), f32 compute, kernel path
   against plain path: prefill and 4 decode steps at 1e-4; then
   RWKV6-7B at full depth (32 layers) on prompts of 200 and 509 tokens,
   kernel path against plain path layer by layer, at f32 compute (final
   logits and K7's share of each layer held, see ``RWKV_F32_DRIFT_TOL``)
   and with the weights in bf16 (recorded);
8. trains Llama-3.2-1B at full width and depth (B 8 x S 512, 4 steps, a
   step of 2 microbatches, then a profiled step), and RWKV6-7B (2 layers),
   RecurrentGemma-9B (3), Qwen2-MoE-A2.7B (2) and Qwen2-VL-7B (2, on the
   launcher's embeds batches, and a step of 2 microbatches) at full width
   (B 4 x S 512, 2 steps, then a profiled step): f32 params, bf16 compute,
   remat, ``xent_impl="chunked"``, the launcher's AdamW, token-pipeline
   batches; every loss finite, launches per step pinned (Llama K5 32, K6
   1, or 64 and 2 with 2 microbatches; RWKV K7 4, K6 1; RecurrentGemma K5
   2, Qwen2-MoE and Qwen2-VL K5 4, K6 1; no other kernel), every parameter
   leaf with a nonzero finite gradient (an embeds batch's unread
   ``embed``: zero),
   step 1's loss and grad norm against the plain path (1e-2 and 5e-2
   relative); step ms, tokens/s, peak memory, K6's device ms per step,
   the device's idle share and MFU (on the active parameters for MoE);
9. holds the five trained architectures at full width, 2 layers
   (RecurrentGemma 3), f32 compute, kernel path against plain path: step
   1's loss at 1e-5 relative, every gradient leaf at rtol 1e-3 and 1e-3 of
   the leaf's largest value, and the losses of 2 AdamW steps at 1e-5
   relative; then (``remat_dots_phase``) one Llama-3.2-1B train step's
   loss and gradients under ``remat_policy="block"`` and under ``"dots"``:
   losses within 1e-6, K5 32 in both, both peaks recorded;
   then the multi-card half of training on the card: ``sharded_train``
   (Llama-3.2-1B whole, B 8 x S 512, 2 steps of ``jit_train_step`` on a
   ("data", "model") = (2, 2) mesh, over four cards when there are four,
   else over cuda:0 four times: params by ``ShardingPolicy``, the AdamW
   moments ZeRO-1 split, each data coordinate's rows through K5 and K6;
   step 1's loss bit-equal to the unsharded step with 2 microbatches,
   step 2's within 1e-5 relative, the f64 norm of every param and moment
   leaf within 1e-6 relative of the unsharded step's, K5 64 and K6 2 a
   step both ways, each coordinate's bytes equal to its specs'
   arithmetic, over distinct cards every copy of a block bit-equal across
   them, step ms and peak both ways), ``sharded_mixed`` (the branches
   that only distinct devices take, on one card: a widened reduced Llama
   at f32 on (2, 2) over cuda:0 and the CPU, every block on both; its
   copies bit-equal across them, the losses within 1e-5 and the leaf
   norms within 1e-4 of the same steps over cuda:0 alone), ``reshard``
   (the params saved whole and restored with ``shardings=`` onto (4, 1);
   the params and AdamW state by ``reshard_tree`` onto (4, 1), then onto
   (1, 1); every leaf bit-equal after each) and ``pipeline`` (GPipe, 2
   stages over cuda:0,
   or cuda:0 and cuda:1 when there are two, D 2,048, M 8, B 4, f32:
   outputs and gradients within 1e-5 of the sequential stack)
   (``--sharded-only`` builds, checks K5 and K6, runs these four phases
   and stops);
10. times each kernel at the main path's shapes (K1-K4 at batch 1 and 16,
    K3 and K4 at every distinct depthwise step of both nets, beside
    cuDNN's chain and the f64 chain, K5 at S 128/512/1000, at
    RecurrentGemma-9B's, Qwen2-MoE's, Llama-3-8B's, Nemotron-4-15B's and
    Qwen2-VL-7B's served shapes at S 509 and at Seamless-M4T's batch of 4
    at 1,000 frames (encoder and cross-attention without the mask,
    decoder), K7 at S 128/509/512/1000 (each of its two kernels by name),
    K5 also at the train shapes of Llama (B 8 x S 512; its launches, and
    K6's, lm_train's and sharded_train's), RecurrentGemma,
    Qwen2-MoE and Qwen2-VL (B 4 x S 512), K6 at the five train shapes) with
    CUDA events
    and the profiler, beside its plain version, a PyTorch library call
    computing the same function where there is one, and its bound from the
    shapes (K6's on its route, 3xTF32 at the TF32 tensor-core peak, with
    the f32 CUDA-core figure beside it).

Prints one JSON object per line: the phases' results, then the card's
``nvidia-smi`` name and power limit, then ``{"kernels": [...]}``, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without that last line.  It also exits non-zero, printing
nothing to stdout, when ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 on
# the CUDA cores, int8 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}

# The reference's kernel test geometries (tests/test_kernel_conv_pool.py),
# (H, W, cin, cout, k, conv_stride, padding, pool_k, pool_stride, pool).
K1_CASES = [
    (32, 32, 1, 6, 5, 1, 0, 2, 2, "max"),
    (14, 14, 6, 16, 5, 1, 0, 2, 2, "max"),
    (32, 32, 3, 32, 5, 1, 2, 2, 2, "max"),
    (16, 16, 32, 16, 5, 1, 2, 2, 2, "max"),
    (16, 16, 4, 8, 3, 1, 0, 3, 3, "max"),
    (16, 16, 4, 8, 3, 1, 0, 3, 2, "max"),
    (20, 20, 2, 4, 3, 2, 1, 2, 2, "max"),
    (16, 16, 4, 8, 3, 1, 0, 2, 2, "avg"),
    # the multi-tile image of tests/test_hotpaths.py: at batch 16 each CTA
    # takes two pooled rows
    (128, 128, 4, 8, 3, 1, 0, 2, 2, "max"),
    # the true DS-CNN stem: rectangular kernel, stride, padding and pool
    (49, 10, 1, 8, (10, 4), (2, 2), (5, 1), (5, 1), (5, 1), "avg"),
    (49, 10, 1, 8, (10, 4), (2, 2), (5, 1), (5, 1), (5, 1), "max"),
    # MobileNet-V1 0.25's head pw13+pool: 256*256 f32 weights (262,144 B)
    # exceed one CTA's shared memory, so K1 tiles the output channels
    (2, 2, 256, 256, 1, 1, 0, 2, 2, "avg"),
    # DS-CNN-KWS's head pw4+pool: a 1x1 conv under one 25x5 average window,
    # 125 conv values x 64 input channels per output
    (25, 5, 64, 64, 1, 1, 0, (25, 5), (25, 5), "avg"),
    # wide layers at large images: one pooled row of every input channel
    # exceeds a CTA's shared memory (238,976 / 247,232 B), so K1 stages the
    # input channels in chunks, in one launch
    (112, 112, 128, 64, 3, 1, 1, 2, 2, "max"),
    (56, 56, 256, 64, 3, 1, 1, 2, 2, "max"),
]
K1_BATCHES = (1, 8, 16)
K2_BATCHES = (1, 4, 16)
# K2 beyond CIFAR's steps, (H, W, cin, cout, k, conv_stride, padding, pool_k,
# pool_stride, batches), max and avg pools each: the int8 heads of DS-CNN-KWS
# (64->64 1x1 on 25x5 under one 25x5 window) and MobileNet-V1 0.25 (256->256
# 1x1 on 2x2), K1's two wide layers, and a wider one whose staged input K2
# cuts into chunks of input channels
K2_EXTRA = [
    (25, 5, 64, 64, 1, 1, 0, (25, 5), (25, 5), K2_BATCHES),
    (2, 2, 256, 256, 1, 1, 0, 2, 2, K2_BATCHES),
    (112, 112, 128, 64, 3, 1, 1, 2, 2, K2_BATCHES),
    (56, 56, 256, 64, 3, 1, 1, 2, 2, K2_BATCHES),
    (56, 56, 1024, 16, 3, 1, 1, 2, 2, (1, 4)),
]
DW_BATCHES = (1, 8, 16)
# Depthwise cases beyond the nets' own steps, (C, H, W, stride, pool_k,
# pool_stride, pool, activation, bias); every case has a 3x3 kernel, pad 1.
DW_EXTRA = [
    (16, 16, 16, 1, 2, 2, "max", "relu", True),
    (16, 16, 16, 1, 2, 2, "avg", "relu", True),
    (16, 15, 9, 2, 2, 1, "max", "relu", True),
    (8, 10, 12, 2, 3, 2, "avg", "none", False),
    (32, 8, 8, 1, 1, 1, "max", "none", False),
]
# K3 filters that are not 3x3, (kernel, padding): its loop over taps
K3_OTHER_FILTERS = [(5, 2), ((3, 1), (1, 0))]
# Streaming keyword spotting (``stream_phase``): on each net, f32 and int8,
# STREAMS streams opened at once take STREAM_FRAMES frames each, pushed in
# turn (one frame a stream a tick).
STREAM_NETS = ("ds_cnn", "ds_cnn_kws")
STREAMS, STREAM_FRAMES = 4, 256
STREAM_F32_TOL = 1e-4  # rtol = atol, tests/test_streaming.py:157
FRAME_PERIOD_MS = 20.0  # one 10-value MFCC frame every 20 ms (examples/stream_kws.py)
# (ring arena bytes, ring state bytes) by (net, bytes an element)
STREAM_BYTES = {("ds_cnn", 1): (65450, 53930), ("ds_cnn", 4): (261800, 215720),
                ("ds_cnn_kws", 1): (57770, 45290), ("ds_cnn_kws", 4): (231080, 181160)}
# K3 (f32) or K4 (int8) launches: 4 depthwise layers x (new rows, top patch,
# bottom patch) an emission; 4 to open a stream (the full-window warm start)
STREAM_DW_PER_EMISSION, STREAM_DW_PER_OPEN = 12, 4
FULL_RECOMPUTE_CALLS = 100  # batch-1 DagArenaExecutor calls, the comparison
REPORT_ITERS = 5  # timed_segments: best of this many runs a segment
PCTS = (("p50", 50), ("p99", 99))
BUCKETS = (1, 2, 4, 8, 16)
N_REQUESTS, BURST = 64, 8
DAG_F32_TOL = 1e-4  # rtol = atol; tests/test_rect_avgpool.py's for MobileNet
# The emitted C engines get the first C_INPUTS requests each engine served.
# Their f32 outputs are held to the card's at the reference's C tests'
# (rtol, atol) for the network (tests/test_core_exec.py:88 for LeNet,
# tests/test_rect_avgpool.py:416 for DS-CNN-KWS, tests/test_depthwise.py:397,
# DS-CNN's depthwise ladder, for MobileNet); int8 bit for bit.
C_INPUTS = 16
C_F32_TOL = {"lenet5_f32": (1e-5, 1e-6), "ds_cnn_kws_f32": (1e-4, 1e-5),
             "mobilenet_v1_0.25_f32": (1e-4, 1e-5)}
# The paper's flow (tests/test_system.py::test_paper_pipeline_end_to_end):
# LeNet-5 trained this many steps on the synthetic digits, its C engine held
# to the card's engine at (rtol, atol), at least C_MIN_CORRECT of 16 right.
LENET_TRAIN_STEPS = 150
LENET_C_TOL = (1e-4, 1e-5)
C_MIN_CORRECT = 7


class Report:
    """Prints each result as one JSON line, and keeps a copy in ``--out``."""

    def __init__(self, out):
        self.out = Path(out) if out else None
        if self.out:
            self.out.parent.mkdir(parents=True, exist_ok=True)
            self.out.write_text("")

    def emit(self, obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        if self.out:
            with self.out.open("a") as f:
                f.write(line + "\n")


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _taps(size: int, k: int, cs: int, pad: int, p: int, pk: int, ps: int) -> int:
    """Along one axis: the (conv position, tap) pairs that the p pooled
    positions need and that fall inside the input, not on its padding."""
    used = {q * ps + i for q in range(p) for i in range(pk)}
    return sum(0 <= o * cs - pad + d < size for o in used for d in range(k))


def bound(kind: str, n, cin, h, w, cout, k, cs, pad, pk, ps, depthwise=False):
    """(ms, "bytes" | "operations"): the least time for one call, the larger
    of each input byte read once and each output byte written once (the bias
    is 4-byte f32 or int32, and so are K4's per-channel multipliers) over
    HBM bandwidth, and the conv MACs the pooled outputs need, padding taps
    excluded, over the peak rate of the type.  A depthwise conv (cout = cin
    = C) has C·kh·kw weights and no sum over input channels: C·OH·OW·taps
    MACs."""
    (kh, kw), (csh, csw), (ph_, pw_) = _pair(k), _pair(cs), _pair(pad)
    (pkh, pkw), (psh, psw) = _pair(pk), _pair(ps)
    oh, ow = (h + 2 * ph_ - kh) // csh + 1, (w + 2 * pw_ - kw) // csw + 1
    ph, pw = (oh - pkh) // psh + 1, (ow - pkw) // psw + 1
    elem = {"f32": 4, "int8": 1}[kind]
    red = 1 if depthwise else cin  # input channels each output sums over
    nbytes = (n * cin * h * w + cout * red * kh * kw + n * cout * ph * pw) * elem
    nbytes += cout * 4 * (2 if depthwise and kind == "int8" else 1)
    macs = (n * cout * red * _taps(h, kh, csh, ph_, ph, pkh, psh)
            * _taps(w, kw, csw, pw_, pw, pkw, psw))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Wall time per call on the card's clock: CUDA events around a loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def profiled(torch, warm, run):
    """(``run()``'s result, the profiler's ``key_averages()`` of it).  The
    profiler first traces one ``warm()`` in its warmup step and drops it: a
    kernel launched as tracing starts can go unrecorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        out = run()
        torch.cuda.synchronize()
        prof.step()
    return out, prof.key_averages()


def kernel_events(torch, warm, run):
    """(``run()``'s result, its kernel events from the profiler, the device
    ms its step spans).  Only the kernels' own events are kept: an
    operator's self device time repeats its kernels', and the step's
    ``ProfilerStep#`` annotation, mirrored on the device, spans them."""
    from torch.autograd import DeviceType

    out, averages = profiled(torch, warm, run)
    device = [ev for ev in averages if ev.device_type == DeviceType.CUDA]
    step = [ev for ev in device if ev.key.startswith("ProfilerStep")]
    return (out, [ev for ev in device if not ev.key.startswith("ProfilerStep")],
            sum(ev.device_time_total for ev in step) / 1e3)


@contextlib.contextmanager
def profiler_ranges(torch):
    """Inside, each function of ``LM_RANGES`` runs under a
    ``record_function`` range of its name, so a profile can total the
    kernels it launches."""
    import importlib

    saved = []
    for module, fn_name, label in LM_RANGES:
        mod = importlib.import_module(module)
        fn = getattr(mod, fn_name)

        def ranged(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, ranged)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def range_device_ms(averages, label):
    """{"kernel_ms": the device time of the kernels launched inside every
    ``label`` range, "span_ms": the ranges' spans on the device, idle gaps
    included}, from ``key_averages()``; None when no range ran."""
    from torch.autograd import DeviceType

    host = [ev for ev in averages if ev.key == label and ev.device_type == DeviceType.CPU]
    if not host:
        return None
    dev = [ev for ev in averages if ev.key == label and ev.device_type == DeviceType.CUDA]
    return {"kernel_ms": sum(ev.device_time_total for ev in host) / 1e3,
            "span_ms": sum(ev.device_time_total for ev in dev) / 1e3,
            "calls": sum(ev.count for ev in host)}


def device_ms(torch, fn, iters: int = 50):
    """Device time per call, summed over every kernel ``fn`` launches, from
    the profiler; None when the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    def run():
        for _ in range(iters):
            fn()

    _, kernels, _ = kernel_events(torch, fn, run)
    total_us = sum(_per_call_us(ev, iters) for ev in kernels)
    return total_us / 1e3 if total_us > 0 else None


def _per_call_us(ev, iters: int) -> float:
    """A kernel's device µs per call of the traced function: its mean time
    a launch times its launches a call.  The profiler can drop a few
    launches' records, so the launches a call are the recorded count over
    ``iters``, rounded (at least one), and a dropped record does not pull
    the time down."""
    if ev.count == 0:
        return 0.0
    return ev.self_device_time_total / ev.count * max(1, round(ev.count / iters))


def device_ms_by_kernel(torch, fn, iters: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by the kernel's
    name (its template arguments and parameters cut), from the profiler."""
    import re

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    _, kernels, _ = kernel_events(torch, fn, run)
    out = {}
    for ev in kernels:
        name = next((w for w in re.findall(r"([A-Za-z_]\w*)\s*[<(]", ev.key)
                     if w != "void"), ev.key)
        out[name] = out.get(name, 0.0) + _per_call_us(ev, iters) / 1e3
    return out


def tensor_core_sass(path) -> dict:
    """Counts of the tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync)
    in a built library's SASS, from the toolkit's ``cuobjdump``."""
    import re
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}


def build_phase(report) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    usage = {}
    for name, p in paths.items():
        log = p.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        usage[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
    k5_sass = tensor_core_sass(paths["flash_fwd"])
    k6_sass = tensor_core_sass(paths["xent_fwd"])
    report.emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
                 "libraries": {n: p.name for n, p in paths.items()},
                 "ptxas": usage, "k5_tensor_core_sass": k5_sass,
                 "k6_tensor_core_sass": k6_sass})
    for name, sass in (("K5", k5_sass), ("K6", k6_sass)):
        if sum(sass.values()) == 0:
            raise AssertionError(f"{name}'s library has no tensor-core instruction "
                                 f"(HGMMA/HMMA)")


def k1_checks(torch, np, report) -> None:
    from repro_torch.kernels.conv_pool import ref
    from repro_torch.kernels.conv_pool.kernel import (K1_LAUNCHES, MAX_SMEM_BYTES,
                                                      k1_tiling)
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool

    worst = {"f32": 0.0, "bf16": 0.0}
    n_checks = 0
    for ci, (H, W, cin, cout, k, cs, pad, pk, ps, pool) in enumerate(K1_CASES):
        kh, kw = _pair(k)
        for n in K1_BATCHES:
            rng = np.random.default_rng(1000 * ci + n)
            x = rng.standard_normal((n, cin, H, W))
            w = rng.standard_normal((cout, cin, kh, kw)) * 0.2
            b = rng.standard_normal((cout,)) * 0.1
            for kind, dtype, tol in (("f32", torch.float32, 1e-5),
                                     ("bf16", torch.bfloat16, 5e-2)):
                xt, wt, bt = (torch.as_tensor(a, dtype=dtype, device="cuda")
                              for a in (x, w, b))
                geom = dict(conv_stride=cs, padding=pad, pool_k=pk,
                            pool_stride=ps, activation="relu", pool=pool)
                before = K1_LAUNCHES.count
                y = fused_conv_pool(xt, wt, bt, **geom)
                launches = K1_LAUNCHES.count - before
                y_ref = ref.conv_pool_ref(xt, wt, bt, **geom)
                torch.cuda.synchronize()
                if launches != 1:
                    raise AssertionError(f"K1 case {ci}: {launches} launches for "
                                         f"one call")
                if y.dtype != dtype or y.shape != y_ref.shape:
                    raise AssertionError(f"K1 case {ci} n={n} {kind}: "
                                         f"{y.dtype}{tuple(y.shape)} vs "
                                         f"{y_ref.dtype}{tuple(y_ref.shape)}")
                yf, rf = y.float(), y_ref.float()
                if not torch.allclose(yf, rf, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"K1 case {ci} {K1_CASES[ci]} n={n} {kind}: max abs err "
                        f"{float((yf - rf).abs().max())} beyond {tol}")
                worst[kind] = max(worst[kind], float((yf - rf).abs().max()))
                n_checks += 1
                if cout * cin * kh * kw * 4 > MAX_SMEM_BYTES and kind == "f32" and n == 16:
                    report.emit({"phase": "k1_head", "weights_bytes":
                                 cout * cin * kh * kw * 4, "batch": n,
                                 "launches": launches,
                                 "max_abs_err": float((yf - rf).abs().max())})
                tiles = k1_tiling(n, cin, H, W, cout, kh, kw, conv_stride=cs, padding=pad,
                                  pool_k=pk, pool_stride=ps)
                if tiles[2] < cin and kind == "f32":
                    report.emit({"phase": "k1_chunked_input", "case": ci, "batch": n,
                                 "tiling": tiles, "launches": launches,
                                 "max_abs_err": float((yf - rf).abs().max())})
    report.emit({"phase": "k1_vs_plain", "checks": n_checks,
                 "max_abs_err": worst, "tolerance": {"f32": 1e-5, "bf16": 5e-2}})


def k2_checks(torch, np, report) -> None:
    from repro_torch.core.graph import cifar_testnet
    from repro_torch.core.fusion import fuse
    from repro_torch.kernels.conv_pool.kernel import k2_tiling
    from repro_torch.quant.kernel_q8 import (K2_LAUNCHES, conv_pool_q8_ref,
                                             fused_conv_pool_q8)

    layers = _fused_conv_layers(fuse(cifar_testnet()))
    n_checks = 0
    for li, (name, layer, (cin, H, W)) in enumerate(layers):
        conv = layer.conv
        for n in K2_BATCHES:
            for pool in ("max", "avg"):
                rng = np.random.default_rng(100 * li + n)
                x = torch.as_tensor(rng.integers(-128, 128, (n, cin, H, W)),
                                    dtype=torch.int8, device="cuda")
                w = torch.as_tensor(
                    rng.integers(-127, 128, (conv.out_channels, cin,
                                             *conv.kernel_size)),
                    dtype=torch.int8, device="cuda")
                b = torch.as_tensor(rng.integers(-4000, 4000, (conv.out_channels,)),
                                    dtype=torch.int32, device="cuda")
                geom = dict(multiplier=float(np.float32(3e-4)),
                            conv_stride=conv.stride, padding=conv.padding,
                            pool_k=layer.pool_kernel,
                            pool_stride=layer.pool_stride, activation="relu",
                            pool=pool)
                y = fused_conv_pool_q8(x, w, b, **geom)
                y_ref = conv_pool_q8_ref(x, w, b, **geom)
                torch.cuda.synchronize()
                if y.dtype != torch.int8 or not torch.equal(y, y_ref):
                    raise AssertionError(
                        f"K2 {name} n={n} {pool}: not bit-exact, "
                        f"{int((y.int() - y_ref.int()).abs().max())} max diff")
                n_checks += 1
    # the int8 heads, the two wide layers and a layer whose staged input K2
    # cuts into chunks, each call one launch
    for ci, (H, W, cin, cout, k, cs, pad, pk, ps, batches) in enumerate(K2_EXTRA):
        kh, kw = _pair(k)
        # accumulators of ~N(0, (cin kh kw) 5,500^2): about 10 after requant
        m = float(np.float32(3e-4 * (800 / (cin * kh * kw)) ** 0.5))
        tiles = k2_tiling(max(batches), cin, H, W, cout, kh, kw, conv_stride=cs,
                          padding=pad, pool_k=pk, pool_stride=ps)
        for n in batches:
            for pool in ("max", "avg"):
                rng = np.random.default_rng(5000 + 100 * ci + n)
                x = torch.as_tensor(rng.integers(-128, 128, (n, cin, H, W)),
                                    dtype=torch.int8, device="cuda")
                w = torch.as_tensor(rng.integers(-127, 128, (cout, cin, kh, kw)),
                                    dtype=torch.int8, device="cuda")
                b = torch.as_tensor(rng.integers(-4000, 4000, (cout,)),
                                    dtype=torch.int32, device="cuda")
                geom = dict(multiplier=m, conv_stride=cs, padding=pad, pool_k=pk,
                            pool_stride=ps, activation="relu", pool=pool)
                before = K2_LAUNCHES.count
                y = fused_conv_pool_q8(x, w, b, **geom)
                launches = K2_LAUNCHES.count - before
                y_ref = conv_pool_q8_ref(x, w, b, **geom)
                torch.cuda.synchronize()
                if launches != 1 or y.dtype != torch.int8 or not torch.equal(y, y_ref):
                    raise AssertionError(
                        f"K2 {K2_EXTRA[ci]} n={n} {pool}: {launches} launches, not "
                        f"bit-exact, {int((y.int() - y_ref.int()).abs().max())} max diff")
                n_checks += 1
        report.emit({"phase": "k2_case", "case": K2_EXTRA[ci][:9], "batches": batches,
                     "tiling_at_largest_batch": tiles, "bit_exact": True})
    report.emit({"phase": "k2_vs_plain", "checks": n_checks, "bit_exact": True})


def _dw_steps(net):
    """(name, DepthwiseConv2d layer, input (C, H, W)) of a DAG net's plan."""
    from repro_torch.core import graph, schedule

    mat = schedule.materialize_dag(schedule.fuse_dag_priced(getattr(graph, net)()))
    return [(s.name, s.layer, tuple(s.in_shapes[0])) for s in mat.steps
            if s.layer.kind == "DepthwiseConv2d"]


def _stream_row_blocks():
    """(C, H, W) of every depthwise row block the streaming executor runs on
    ds_cnn and ds_cnn_kws: the new rows and both edge patches of each
    depthwise ring, padded by 1 on W and run at padding 0."""
    from repro_torch.core import graph, streaming

    blocks = set()
    for net in STREAM_NETS:
        for r in streaming.plan_streaming(getattr(graph, net)()).rings:
            if r.kind != "DepthwiseConv2d":
                continue
            for rows in {r.new_rows, r.top, r.bottom} - {0}:
                blocks.add((r.channels, (rows - 1) * r.stride + r.kernel,
                            r.width + 2 * r.padding))
    return sorted(blocks)


def dw_cases():
    """(label, C, H, W, stride, padding, pool_k, pool_stride, pool,
    activation, bias) for K3/K4: every depthwise step of both nets (as the
    executors run it, its ReLU folded), DW_EXTRA, then the streaming row
    blocks (padding 0)."""
    cases = []
    for net in ("ds_cnn_kws", "mobilenet_v1"):
        for name, layer, (c, h, w) in _dw_steps(net):
            cases.append((f"{net}/{name}", c, h, w, layer.stride[0], 1, 1, 1, "max",
                          "relu", True))
    cases += [(f"extra{i}", e[0], e[1], e[2], e[3], 1, *e[4:])
              for i, e in enumerate(DW_EXTRA)]
    cases += [(f"stream/{c}x{h}x{w}", c, h, w, 1, 0, 1, 1, "max", "relu", True)
              for c, h, w in _stream_row_blocks()]
    return cases


def _dw_multipliers(np, rng, c):
    """Per-channel multipliers: powers of two, where odd multiples of half
    a step tie, and large ones, which saturate."""
    return rng.choice(np.float32([2.0**-6, 2.0**-7, 2.0**-8, 0.05, 1e-3]), c)


def dw_checks(torch, np, report) -> None:
    """K3 (f32 1e-5, bf16 5e-2) and K4 (bit-exact) against their plain
    versions on every depthwise case, batches 1/8/16."""
    from repro_torch.kernels.conv_pool.depthwise import (
        depthwise_conv_pool_ref, fused_depthwise_conv_pool)
    from repro_torch.quant.kernel_q8 import (
        depthwise_conv_pool_q8_ref, fused_depthwise_conv_pool_q8)

    worst = {"f32": 0.0, "bf16": 0.0}
    n3 = n4 = ties = saturated = 0
    for ci, (label, c, h, w, s, pad, pk, ps, pool, act, bias) in enumerate(dw_cases()):
        geom = dict(conv_stride=s, padding=pad, pool_k=pk, pool_stride=ps,
                    activation=act, pool=pool)
        for n in DW_BATCHES:
            rng = np.random.default_rng(5000 + 10 * ci + n)
            x = rng.standard_normal((n, c, h, w))
            wt = rng.standard_normal((c, 1, 3, 3)) * 0.3
            b = rng.standard_normal(c) * 0.1
            for kind, dtype, tol in (("f32", torch.float32, 1e-5),
                                     ("bf16", torch.bfloat16, 5e-2)):
                xt, w_, bt = (torch.as_tensor(a, dtype=dtype, device="cuda")
                              for a in (x, wt, b))
                bt = bt if bias else None
                y = fused_depthwise_conv_pool(xt, w_, bt, **geom)
                y_ref = depthwise_conv_pool_ref(xt, w_, bt, **geom)
                torch.cuda.synchronize()
                yf, rf = y.float(), y_ref.float()
                if y.dtype != dtype or not torch.allclose(yf, rf, rtol=tol, atol=tol):
                    raise AssertionError(f"K3 {label} n={n} {kind}: max abs err "
                                         f"{float((yf - rf).abs().max())} beyond {tol}")
                worst[kind] = max(worst[kind], float((yf - rf).abs().max()))
                n3 += 1
            xq = torch.as_tensor(rng.integers(-128, 128, (n, c, h, w)),
                                 dtype=torch.int8, device="cuda")
            wq = torch.as_tensor(rng.integers(-127, 128, (c, 1, 3, 3)),
                                 dtype=torch.int8, device="cuda")
            bq = torch.as_tensor(rng.integers(-3000, 3000, c), dtype=torch.int32,
                                 device="cuda") if bias else None
            m = _dw_multipliers(np, rng, c)
            y = fused_depthwise_conv_pool_q8(xq, wq, bq, multiplier=m, **geom)
            y_ref = depthwise_conv_pool_q8_ref(xq, wq, bq, multiplier=m, **geom)
            torch.cuda.synchronize()
            if y.dtype != torch.int8 or not torch.equal(y, y_ref):
                raise AssertionError(f"K4 {label} n={n}: not bit-exact, "
                                     f"{int((y.int() - y_ref.int()).abs().max())} "
                                     f"max diff")
            saturated += int(((y_ref == 127) | (y_ref == -128)).sum())
            ties += int(np.isin(m, np.float32([2.0**-6, 2.0**-7, 2.0**-8])).sum())
            n4 += 1
    if not saturated or not ties:
        raise AssertionError("K4 cases made no saturated or tie-prone outputs")
    # K3's filters other than 3x3 take its loop over taps, not the unrolled case.
    for k, pad in K3_OTHER_FILTERS:
        kh, kw = _pair(k)
        rng = np.random.default_rng(5900 + kh * 10 + kw)
        x, wt, b = (rng.standard_normal(shape)
                    for shape in ((2, 24, 13, 11), (24, 1, kh, kw), (24,)))
        for kind, dtype, tol in (("f32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 5e-2)):
            xt, w_, bt = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (x, wt, b))
            geom = dict(conv_stride=1, padding=pad, pool_k=2, pool_stride=2, activation="relu",
                        pool="max")
            y = fused_depthwise_conv_pool(xt, w_, bt, **geom)
            y_ref = depthwise_conv_pool_ref(xt, w_, bt, **geom)
            torch.cuda.synchronize()
            yf, rf = y.float(), y_ref.float()
            if y.dtype != dtype or not torch.allclose(yf, rf, rtol=tol, atol=tol):
                raise AssertionError(f"K3 {k} filter {kind}: max abs err "
                                     f"{float((yf - rf).abs().max())} beyond {tol}")
            worst[kind] = max(worst[kind], float((yf - rf).abs().max()))
            n3 += 1
    report.emit({"phase": "k3_vs_plain", "checks": n3, "max_abs_err": worst,
                 "tolerance": {"f32": 1e-5, "bf16": 5e-2}})
    report.emit({"phase": "k4_vs_plain", "checks": n4, "bit_exact": True,
                 "saturated_outputs": saturated, "power_of_two_channels": ties})


def strided_view_checks(torch, np, report) -> None:
    """One call of each kernel reading one buffer of an (N, arena) tensor
    and writing another, as the executors do."""
    from repro_torch.kernels.conv_pool import ref
    from repro_torch.kernels.conv_pool.depthwise import (
        depthwise_conv_pool_ref, fused_depthwise_conv_pool)
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.quant.kernel_q8 import (
        conv_pool_q8_ref, depthwise_conv_pool_q8_ref, fused_conv_pool_q8,
        fused_depthwise_conv_pool_q8)

    rng = np.random.default_rng(7)
    n, arena_elems = 5, 2200
    arena = torch.zeros((n, arena_elems), device="cuda")
    x = arena[:, 1024:1024 + 1176].view(n, 6, 14, 14)
    x.copy_(torch.as_tensor(rng.standard_normal((n, 6, 14, 14)),
                            dtype=torch.float32))
    w = torch.as_tensor(rng.standard_normal((16, 6, 5, 5)) * 0.2,
                        dtype=torch.float32, device="cuda")
    b = torch.as_tensor(rng.standard_normal(16) * 0.1, dtype=torch.float32,
                        device="cuda")
    out = arena[:, 0:400].view(n, 16, 5, 5)
    fused_conv_pool(x, w, b, out=out)
    y_ref = ref.conv_pool_ref(x.contiguous(), w, b)
    if not torch.allclose(out, y_ref, rtol=1e-5, atol=1e-5):
        raise AssertionError("K1 through arena views disagrees with plain")

    arena8 = torch.zeros((n, 11264), dtype=torch.int8, device="cuda")
    xq = arena8[:, 0:3072].view(n, 3, 32, 32)
    xq.copy_(torch.as_tensor(rng.integers(-128, 128, (n, 3, 32, 32)),
                             dtype=torch.int8))
    wq = torch.as_tensor(rng.integers(-127, 128, (32, 3, 5, 5)),
                         dtype=torch.int8, device="cuda")
    bq = torch.as_tensor(rng.integers(-4000, 4000, 32), dtype=torch.int32,
                         device="cuda")
    outq = arena8[:, 3072:3072 + 8192].view(n, 32, 16, 16)
    geom = dict(multiplier=float(np.float32(2e-3)), padding=2)
    fused_conv_pool_q8(xq, wq, bq, out=outq, **geom)
    if not torch.equal(outq, conv_pool_q8_ref(xq.contiguous(), wq, bq, **geom)):
        raise AssertionError("K2 through arena views disagrees with plain")

    # MobileNet dw2 (16x32x32, stride 2) between two buffers of its arena
    # (24,576 elements per image), f32 and int8
    c, elems = 16, 24576
    dgeom = dict(conv_stride=2, padding=1, activation="relu")
    arena = torch.zeros((n, elems), device="cuda")
    xd = arena[:, 8192:8192 + 16384].view(n, c, 32, 32)
    xd.copy_(torch.as_tensor(rng.standard_normal((n, c, 32, 32)), dtype=torch.float32))
    wd = torch.as_tensor(rng.standard_normal((c, 1, 3, 3)), dtype=torch.float32,
                         device="cuda")
    bd = torch.as_tensor(rng.standard_normal(c), dtype=torch.float32, device="cuda")
    outd = arena[:, 0:4096].view(n, c, 16, 16)
    fused_depthwise_conv_pool(xd, wd, bd, out=outd, **dgeom)
    if not torch.allclose(outd, depthwise_conv_pool_ref(xd.contiguous(), wd, bd, **dgeom),
                          rtol=1e-5, atol=1e-5):
        raise AssertionError("K3 through arena views disagrees with plain")
    arena8 = torch.zeros((n, elems), dtype=torch.int8, device="cuda")
    xd8 = arena8[:, 8192:8192 + 16384].view(n, c, 32, 32)
    xd8.copy_(torch.as_tensor(rng.integers(-128, 128, (n, c, 32, 32)), dtype=torch.int8))
    wd8 = torch.as_tensor(rng.integers(-127, 128, (c, 1, 3, 3)), dtype=torch.int8,
                          device="cuda")
    bd8 = torch.as_tensor(rng.integers(-3000, 3000, c), dtype=torch.int32, device="cuda")
    m = _dw_multipliers(np, rng, c)
    outd8 = arena8[:, 0:4096].view(n, c, 16, 16)
    fused_depthwise_conv_pool_q8(xd8, wd8, bd8, multiplier=m, out=outd8,
                                 ms=torch.as_tensor(m, device="cuda"), **dgeom)
    if not torch.equal(outd8, depthwise_conv_pool_q8_ref(xd8.contiguous(), wd8, bd8,
                                                         multiplier=m, **dgeom)):
        raise AssertionError("K4 through arena views disagrees with plain")
    torch.cuda.synchronize()
    report.emit({"phase": "arena_views", "ok": True, "kernels": ["K1", "K2", "K3", "K4"]})


def _fused_conv_layers(fused_graph):
    """(name, FusedConvPool layer, input (C, H, W)) along a fused graph."""
    out = []
    shapes = fused_graph.shapes()
    for i, layer in enumerate(fused_graph.layers):
        if layer.kind == "FusedConvPool":
            out.append((layer.name, layer, tuple(shapes[i - 1])))
    return out


def _kernel_steps(fused_graph):
    """(name, layer, input (C, H, W)) of every step a kernel runs: the
    FusedConvPool layers of a sequential graph, or the FusedConvPool and
    DepthwiseConv2d steps of a DAG's plan."""
    from repro_torch.core import schedule
    from repro_torch.core.graph import DAGGraph

    if not isinstance(fused_graph, DAGGraph):
        return _fused_conv_layers(fused_graph)
    mat = schedule.materialize_dag(fused_graph)
    return [(s.name, s.layer, tuple(s.in_shapes[0])) for s in mat.steps
            if s.layer.kind in ("FusedConvPool", "DepthwiseConv2d")]


def _counters():
    from repro_torch.kernels.conv_pool.depthwise import K3_LAUNCHES
    from repro_torch.kernels.conv_pool.kernel import K1_LAUNCHES
    from repro_torch.kernels.flash.kernel import K5_LAUNCHES
    from repro_torch.kernels.wkv.kernel import K7_LAUNCHES
    from repro_torch.kernels.xent.kernel import K6_LAUNCHES
    from repro_torch.quant.kernel_q8 import K2_LAUNCHES, K4_LAUNCHES

    return {"K1": K1_LAUNCHES, "K2": K2_LAUNCHES, "K3": K3_LAUNCHES,
            "K4": K4_LAUNCHES, "K5": K5_LAUNCHES, "K6": K6_LAUNCHES,
            "K7": K7_LAUNCHES}


def engine_phase(torch, np, report):
    """Serve 64 requests through each engine; returns per-network results."""
    from repro_torch.core import fusion, nn, pingpong, planner, quantize, schedule
    from repro_torch.core.graph import cifar_testnet, ds_cnn_kws, lenet5, mobilenet_v1
    from repro_torch.quant import exec as qexec
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy

    policy = CoalescePolicy(max_batch=BUCKETS[-1], max_wait_s=0.002)
    arrivals = [(i // BURST) * 0.002 for i in range(N_REQUESTS)]
    rng = np.random.default_rng(0)
    counters = _counters()
    results = {}

    def serve(engine, images):
        """Serve with every counter set to 0 just before and read just
        after: {kernel: (count, {geometry key: count})}."""
        with engine:
            for c in counters.values():
                c.reset()
            reqs, run = engine.serve(images, arrivals)
            counts = {k: (c.count, dict(c.by_key)) for k, c in counters.items()}
        return np.stack([r.y for r in reqs]), run, counts

    def span_ms(tracer):
        """Host time of each engine span, batch by batch: {name: [ms, ...]}."""
        out = {}
        for _, dur_us, ev in tracer.spans():
            out.setdefault(ev["name"], []).append(dur_us / 1e3)
        return out

    def check_arena(engine, plan, name, want_bytes):
        for b in BUCKETS:
            a = engine.executor.arenas[b]
            if tuple(a.shape) != (b, plan.arena_elems):
                raise AssertionError(f"{name}: bucket {b} arena {tuple(a.shape)} "
                                     f"!= ({b}, {plan.arena_elems})")
            if plan.arena_elems * a.element_size() != want_bytes:
                raise AssertionError(f"{name}: arena {plan.arena_elems} x "
                                     f"{a.element_size()} B != {want_bytes} B")

    def check_launches(name, counts, run, per_batch):
        """Exactly ``per_batch[k]`` launches of kernel k per batch, and none
        of any other kernel."""
        for k, (count, _) in counts.items():
            want = per_batch.get(k, 0) * run.batches
            if count != want:
                raise AssertionError(f"{name}: {k} launched {count} times for "
                                     f"{run.batches} batches (want {want})")

    def record(name, engine, plan, fused, run, counts, want_bytes, per_batch,
               check, model, served):
        """``model``: the f32 params or the int8 model the engine serves;
        ``served``: (inputs, the card's outputs) of its first C_INPUTS
        requests, which ``c_export_phase`` feeds the emitted C engine."""
        check_launches(name, counts, run, per_batch)
        check_arena(engine, plan, name, want_bytes)
        results[name] = {"run": run, "counts": counts, "fused": fused, "plan": plan,
                         "model": model, "served": served,
                         "arena_bytes": want_bytes}
        report.emit({"phase": "engine", "net": name, "requests": N_REQUESTS,
                     **check, "tf32": {
                         "cudnn": torch.backends.cudnn.allow_tf32,
                         "matmul": torch.backends.cuda.matmul.allow_tf32},
                     **{f"{k.lower()}_launches": c for k, (c, _) in counts.items()},
                     "launches_per_batch": per_batch,
                     "arena_bytes_per_image": want_bytes,
                     **run.summary(), "bucket_hist": run.bucket_hist,
                     "spans_ms": span_ms(engine.tracer)})

    def cpu_params(params):
        return {k: {kk: v.cpu() for kk, v in p.items()} for k, p in params.items()}

    def float_engine(name, fused, plan, params, in_shape, tol, want_bytes,
                     per_batch, plain):
        engine = CNNEngine.from_graph(fused, plan, params, device="cuda",
                                      buckets=BUCKETS, policy=policy,
                                      tracer=Tracer())
        images = rng.standard_normal((N_REQUESTS, *in_shape)).astype(np.float32)
        y, run, counts = serve(engine, images)
        y_plain = plain(fused, plan)(cpu_params(params),
                                     torch.from_numpy(images)).numpy()
        if not np.isfinite(y).all() or y.shape != y_plain.shape:
            raise AssertionError(f"{name} engine output {y.shape} not finite")
        err = float(np.abs(y - y_plain).max())
        if not np.allclose(y, y_plain, rtol=tol, atol=tol):
            raise AssertionError(f"{name} engine vs plain CPU path: max abs err {err}")
        record(name, engine, plan, fused, run, counts, want_bytes, per_batch,
               {"max_abs_err_vs_cpu_plain": err, "tolerance": tol}, params,
               (images[:C_INPUTS], y[:C_INPUTS]))

    def int8_engine(name, qm, plan_q, in_shape, want_bytes, per_batch, simulate,
                    run_batch):
        engine = CNNEngine.from_quantized(qm, plan_q, device="cuda",
                                          buckets=BUCKETS, policy=policy,
                                          tracer=Tracer())
        xs = torch.from_numpy(rng.standard_normal((N_REQUESTS, *in_shape))
                              .astype(np.float32))
        xq = quantize.quantize_input(qm, xs).numpy()
        yq, run, counts = serve(engine, xq)
        y_sim = simulate(qm, torch.from_numpy(xq)).numpy()
        y_exec, _ = run_batch(qm, plan_q, torch.from_numpy(xq))
        if yq.dtype != np.int8 or yq.shape != y_sim.shape:
            raise AssertionError(f"{name} engine output {yq.dtype}{yq.shape}")
        if not (np.array_equal(yq, y_sim) and np.array_equal(yq, y_exec.numpy())):
            raise AssertionError(f"{name} int8 engine is not bit-exact vs the CPU "
                                 f"simulator and executor")
        record(name, engine, plan_q, qm.graph, run, counts, want_bytes,
               per_batch, {"bit_exact_vs_cpu_simulator": True}, qm,
               (xq[:C_INPUTS], yq[:C_INPUTS]))

    # -- LeNet-5, f32 (paper §3) ---------------------------------------------
    g = lenet5()
    fused = fusion.fuse(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device="cuda"))
    float_engine("lenet5_f32", fused, planner.plan_pingpong(g), params,
                 (1, 32, 32), 1e-5, 8800, {"K1": 2}, pingpong.make_scan_executor)

    # -- §5 CIFAR test net, int8 ---------------------------------------------
    c = cifar_testnet()
    cfused = fusion.fuse(c)
    cparams = fusion.rename_params(
        cfused, nn.init_params(c, torch.Generator().manual_seed(1), device="cpu"))
    calib = torch.from_numpy(rng.standard_normal((8, 3, 32, 32)).astype(np.float32))
    int8_engine("cifar_int8", quantize.quantize(cfused, cparams, calib),
                planner.plan_pingpong(c, io_dtype_bytes=1), (3, 32, 32), 11264,
                {"K2": 3}, quantize.simulate_int8_forward,
                qexec.run_batch_int8_with_arena)

    # -- the DAG path: DS-CNN-KWS and MobileNet-V1 0.25, f32 and int8 ----------
    for tag, g, seed, n_dw, (f32_bytes, int8_bytes) in (
            ("ds_cnn_kws", ds_cnn_kws(), 2, 4, (64000, 16000)),
            ("mobilenet_v1_0.25", mobilenet_v1(0.25), 3, 13, (98304, 24576))):
        fused = schedule.fuse_dag_priced(g)
        params = nn.init_params(fused, torch.Generator().manual_seed(seed),
                                device="cuda")
        in_shape = tuple(fused.nodes[0].layer.shape)
        float_engine(f"{tag}_f32", fused, schedule.plan_dag(g), params, in_shape,
                     DAG_F32_TOL, f32_bytes, {"K3": n_dw, "K1": 1},
                     pingpong.make_dag_executor)
        calib = torch.from_numpy(rng.standard_normal((8, *in_shape)).astype(np.float32))
        qm = quantize.quantize_dag(fused, cpu_params(params), calib)
        int8_engine(f"{tag}_int8", qm, schedule.plan_dag(g, io_dtype_bytes=1),
                    in_shape, int8_bytes, {"K4": n_dw, "K2": 1},
                    quantize.simulate_int8_dag_forward,
                    qexec.run_batch_int8_dag_with_arena)
    return results


# The mesh phase: the same 64 requests through each engine four ways, in
# bursts of 16 that each close into one batch of 16 (a burst is submitted
# within microseconds; the coalescer waits up to a second for the 16th), so
# every way runs the same rows together.  f32 rows are then bit-equal
# across the ways as long as the card's f32 kernels are batch-invariant
# between a batch of 16 and the 4-shard mesh's shards of 4, which the phase
# records (``_batch_invariance``): with TF32 off, on an H100 80GB HBM3 at
# 700 W, the three f32 nets' rows were equal at 2, 4 and 8 rows a call
# against 16, and not at 1 (cuBLAS's one-row path).
MESH_SHARDS = 4
MESH_BURST = 16
MESH_WAYS = ("no_mesh", "mesh_all_cards", f"shards_{MESH_SHARDS}", "persistent_cache")
MESH_OVERLAP_BATCHES = (4096, 32768)
MESH_OVERLAP_REPS = 7


def mesh_phase(torch, np, report, engines) -> None:
    """The six CNN engines without a mesh, with ``mesh=make_data_mesh()``
    (every card: the one card when run as the smoke run is), with a mesh of
    ``MESH_SHARDS`` shards over card 0 (the splitting, pad lanes and gather
    on the card) and with ``persistent_cache_dir=`` a fresh directory;
    outputs bit-equal to the engine without a mesh, launches per batch
    times the mesh's size, arenas the plan's bytes an image.  Then a second process
    loads K1-K4 from that directory and launches them without running
    ``nvcc``."""
    import shutil
    import tempfile

    from repro_torch.core import quantize
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import DataMesh, make_data_mesh
    from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy
    from repro_torch.serve.step import enable_persistent_cache

    counters = {k: c for k, c in _counters().items() if k in ("K1", "K2", "K3", "K4")}
    policy = CoalescePolicy(max_batch=MESH_BURST, max_wait_s=1.0)
    home = build.BUILD_DIR
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = Path(tempfile.mkdtemp(prefix="kernel-cache-", dir=ROOT / "build"))
    rng = np.random.default_rng(20)
    kw_by_way = {"no_mesh": {}, "mesh_all_cards": {"mesh": make_data_mesh()},
                 f"shards_{MESH_SHARDS}": {
                     "mesh": DataMesh((torch.device("cuda", 0),) * MESH_SHARDS)},
                 "persistent_cache": {"persistent_cache_dir": str(cache_dir)}}
    size = {way: len(kw["mesh"].devices) if "mesh" in kw else 1
            for way, kw in kw_by_way.items()}
    build.NVCC_RUNS.reset()
    filled = False
    try:
        for net, e in engines.items():
            int8 = net.endswith("int8")
            in_shape = tuple(e["fused"].layers[0].shape)
            xs = rng.standard_normal((N_REQUESTS, *in_shape)).astype(np.float32)
            if int8:
                xs = quantize.quantize_input(e["model"], torch.from_numpy(xs)).numpy()
            ways = {}
            for way in MESH_WAYS:
                if way == "persistent_cache" and not filled:
                    # K1-K4 into the fresh directory, all four at once (the
                    # engines would build each at its first launch)
                    enable_persistent_cache(cache_dir)
                    build.build(["conv_pool", "conv_pool_q8", "conv_pool_dw",
                                 "conv_pool_dw_q8"])
                    filled = True
                kw = dict(device="cuda", buckets=BUCKETS, policy=policy, **kw_by_way[way])
                engine = (CNNEngine.from_quantized(e["model"], e["plan"], **kw) if int8
                          else CNNEngine.from_graph(e["fused"], e["plan"], e["model"], **kw))
                with engine:
                    for c in counters.values():
                        c.reset()
                    served = [engine.serve(xs[i:i + MESH_BURST])
                              for i in range(0, N_REQUESTS, MESH_BURST)]
                    counts = {k: c.count for k, c in counters.items()}
                ys = [r.y for reqs, _ in served for r in reqs]
                lat = [r.latency_s * 1e3 for reqs, _ in served for r in reqs]
                stats = engine.stats.snapshot()
                arenas = {n: a.shape[1] * a.element_size()
                          for n, a in engine.executor.arenas.items()}
                ways[way] = {"y": np.stack(ys), "mesh_size": size[way],
                             "batches": stats.batches,
                             "burst_ms_median": _pct(np, [1e3 * run.wall_s
                                                          for _, run in served], 50),
                             "latency_ms_p50": _pct(np, lat, 50),
                             "bucket_hist": dict(stats.bucket_hist),
                             "launches_per_batch": {k: c / stats.batches
                                                    for k, c in counts.items() if c},
                             "arena_bytes_per_image": arenas}
            base = ways["no_mesh"]
            for way, w in ways.items():
                mult = size[way]
                want_arenas = sorted(b // mult for b in BUCKETS if b % mult == 0)
                want_launches = {k: v * mult for k, v in base["launches_per_batch"].items()}
                if w["bucket_hist"] != {MESH_BURST: N_REQUESTS // MESH_BURST}:
                    raise AssertionError(f"mesh {net} {way}: batches {w['bucket_hist']}, not "
                                         f"{N_REQUESTS // MESH_BURST} of {MESH_BURST}")
                if not (w["y"].dtype == base["y"].dtype and np.array_equal(w["y"], base["y"])):
                    err = float(np.abs(w["y"].astype(np.float64) - base["y"]).max())
                    raise AssertionError(f"mesh {net} {way}: outputs not bit-equal to the "
                                         f"engine without a mesh (max abs diff {err})")
                if w["launches_per_batch"] != want_launches:
                    raise AssertionError(f"mesh {net} {way}: launches per batch "
                                         f"{w['launches_per_batch']}, want {want_launches}")
                if (sorted(w["arena_bytes_per_image"]) != want_arenas
                        or set(w["arena_bytes_per_image"].values()) != {e["arena_bytes"]}):
                    raise AssertionError(f"mesh {net} {way}: arenas "
                                         f"{w['arena_bytes_per_image']}, want {want_arenas} "
                                         f"of {e['arena_bytes']} B")
            report.emit({"phase": "mesh", "net": net, "requests": N_REQUESTS,
                         "burst": MESH_BURST, "bit_equal": True,
                         "batch_invariance": _batch_invariance(torch, np, e, xs),
                         **{way: {k: v for k, v in w.items() if k != "y"}
                            for way, w in ways.items()}})
            for line in _mesh_overlap(torch, np, net, e):
                report.emit(line)
        built = build.NVCC_RUNS.count
        enable_persistent_cache(home)
        child = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             f"sys.exit(chip_smoke.persistent_cache_child({str(cache_dir)!r}))"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"persistent-cache process exited {child.returncode}:\n"
                                 f"{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
        loaded = json.loads(child.stdout.strip().splitlines()[-1])
        if loaded["nvcc_runs"] != 0 or min(loaded["launches"].values()) < 1:
            raise AssertionError(f"persistent-cache process: {loaded}")
        report.emit({"phase": "mesh_persistent_cache", "nvcc_runs_filling": built,
                     "second_process": loaded})
    finally:
        enable_persistent_cache(home)
        shutil.rmtree(cache_dir, ignore_errors=True)


def _executor(torch, e):
    """(executor, params on card 0) for one of ``engine_phase``'s engines."""
    from repro_torch.core import pingpong
    from repro_torch.core.graph import DAGGraph
    from repro_torch.quant.exec import make_int8_executor

    if isinstance(e["model"], dict):
        make = (pingpong.make_dag_executor if isinstance(e["fused"], DAGGraph)
                else pingpong.make_scan_executor)
        return make(e["fused"], e["plan"]), e["model"]
    return make_int8_executor(e["model"], e["plan"], device="cuda")


def _sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class _BusySpans:
    """An arena executor that records a CUDA event pair around each call, on
    the current stream of the current card (``wrap_batched`` makes a shard's
    card and stream current); its replicas, one a card, log to one list."""

    def __init__(self, torch, fn, log):
        self.torch, self.fn, self.log = torch, fn, log

    def replica(self):
        return _BusySpans(self.torch, self.fn.replica(), self.log)

    def __call__(self, params, x):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y = self.fn(params, x)
        ev[1].record()
        self.log.append(ev)
        return y


def _mesh_overlap(torch, np, net, e) -> list:
    """Recorded, not gated: each executor on one batch of each of
    ``MESH_OVERLAP_BATCHES`` images, without a mesh, over ``MESH_SHARDS``
    shards of card 0 and, where the machine has more than one card, over
    every card (``make_data_mesh()``).  For each way: the wall ms (median of
    ``MESH_OVERLAP_REPS`` calls, every card synchronised), the host ms until
    the call returns (a host that waits for a card returns late), the sum over its
    cards of each card's busy span (CUDA events around its shard, median
    over the calls) and its max |difference| from the run without a mesh.
    A busy sum above the wall time means the cards' spans overlapped."""
    from repro_torch.launch.mesh import DataMesh, make_data_mesh
    from repro_torch.sharding.policy import DataParallelPolicy

    fn, params = _executor(torch, e)
    log = []
    timed = _BusySpans(torch, fn, log)
    in_shape = tuple(e["fused"].layers[0].shape)
    meshes = {f"shards_{MESH_SHARDS}": DataMesh((torch.device("cuda", 0),) * MESH_SHARDS)}
    if torch.cuda.device_count() > 1:
        meshes["mesh_all_cards"] = make_data_mesh()
    ways = {"no_mesh": (timed, params)}
    for way, mesh in meshes.items():
        pol = DataParallelPolicy(mesh)
        ways[way] = (pol.wrap_batched(timed), pol.replicate(params))
    lines = []
    for batch in MESH_OVERLAP_BATCHES:
        x = torch.randn((batch, *in_shape), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(batch))
        if not isinstance(e["model"], dict):
            from repro_torch.core import quantize
            x = quantize.quantize_input(e["model"], x)
        out = {"phase": "mesh_overlap", "net": net, "batch": batch,
               "reps": MESH_OVERLAP_REPS, "cards": torch.cuda.device_count()}
        y0 = None
        for way, (run, weights) in ways.items():
            y = run(weights, x)
            _sync_all(torch)
            walls, hosts, busy = [], [], []
            for _ in range(MESH_OVERLAP_REPS):
                log.clear()
                t = time.perf_counter()
                run(weights, x)
                hosts.append(1e3 * (time.perf_counter() - t))
                _sync_all(torch)
                walls.append(1e3 * (time.perf_counter() - t))
                busy.append(sum(a.elapsed_time(b) for a, b in log))
            y0 = y if y0 is None else y0
            out[way] = {"wall_ms_median": _pct(np, walls, 50),
                        "host_ms_median": _pct(np, hosts, 50),
                        "busy_ms_sum_median": _pct(np, busy, 50),
                        "max_abs_diff": float((y.double() - y0.double()).abs().max())}
            del y
        lines.append(out)
        del x, y0
    torch.cuda.empty_cache()
    return lines


def _batch_invariance(torch, np, e, xs):
    """Recorded, not gated: {m: max |difference|} between the rows of one
    batch of 16 through the engine's executor and the same rows run m at a
    time, the property the f32 bit-equality of a sharded engine rests on
    (int8 sums are exact in any grouping)."""
    fn, params = _executor(torch, e)
    x = torch.as_tensor(xs[:MESH_BURST], device="cuda")
    y = fn(params, x).double()
    return {m: float((torch.cat([fn(params, x[i:i + m]) for i in range(0, MESH_BURST, m)])
                      .double() - y).abs().max()) for m in (1, 2, 4, 8)}


def persistent_cache_child(cache_dir: str) -> int:
    """A fresh process's view of a persistent kernel cache: DS-CNN-KWS f32
    (K3, K1) and int8 (K4, K2) engines built with ``persistent_cache_dir``
    and served 16 requests each; prints {"nvcc_runs", "launches", "libraries"}
    as JSON (``mesh_phase`` holds nvcc_runs at 0)."""
    import numpy as np
    import torch

    from repro_torch.core import nn, quantize, schedule
    from repro_torch.core.graph import ds_cnn_kws
    from repro_torch.kernels import build
    from repro_torch.serve.cnn_engine import CNNEngine

    g = ds_cnn_kws()
    fused = schedule.fuse_dag_priced(g)
    params = nn.init_params(fused, torch.Generator().manual_seed(2), device="cuda")
    xs = np.random.default_rng(21).standard_normal((16, 1, 49, 10)).astype(np.float32)
    cpu = {k: {kk: v.cpu() for kk, v in p.items()} for k, p in params.items()}
    qm = quantize.quantize_dag(fused, cpu, torch.from_numpy(xs[:8]))
    counters = _counters()
    for c in counters.values():
        c.reset()
    with CNNEngine.from_graph(fused, schedule.plan_dag(g), params, device="cuda",
                              persistent_cache_dir=cache_dir) as eng:
        eng.serve(xs)
    with CNNEngine.from_quantized(qm, schedule.plan_dag(g, io_dtype_bytes=1),
                                  device="cuda", persistent_cache_dir=cache_dir) as eng:
        eng.serve(quantize.quantize_input(qm, torch.from_numpy(xs)).numpy())
    torch.cuda.synchronize()
    names = ("conv_pool", "conv_pool_q8", "conv_pool_dw", "conv_pool_dw_q8")
    print(json.dumps({
        "nvcc_runs": build.NVCC_RUNS.count,
        "launches": {k: counters[k].count for k in ("K1", "K2", "K3", "K4")},
        "libraries": [str(build.library_path(n).relative_to(ROOT)) for n in names],
        "in_cache_dir": all(build.library_path(n).parent == Path(cache_dir).resolve()
                            and build.library_path(n).exists() for n in names)}))
    return 0


def residual_phase(torch, np, report) -> None:
    """One batch of 16 of residual_cifar (a Concat join, an Add join of
    three inputs, two isomorphic towers) through the DAG executor on the
    card, f32 and int8, against the same executor on a CPU copy."""
    from repro_torch.core import nn, pingpong, quantize, schedule
    from repro_torch.core.graph import residual_cifar
    from repro_torch.quant import exec as qexec

    counters = _counters()
    g = residual_cifar()
    fused = schedule.fuse_dag_priced(g)
    params = nn.init_params(fused, torch.Generator().manual_seed(4), device="cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((16, 3, 32, 32)).astype(np.float32))
    plan = schedule.plan_dag(g)
    dev_params = {k: {kk: v.cuda() for kk, v in p.items()} for k, p in params.items()}
    for cnt in counters.values():
        cnt.reset()
    y = pingpong.make_dag_executor(fused, plan)(dev_params, x.cuda()).cpu()
    k1 = counters["K1"].count
    y_cpu = pingpong.make_dag_executor(fused, plan)(params, x)
    err = float((y - y_cpu).abs().max())
    if k1 != 1 or not torch.allclose(y, y_cpu, rtol=DAG_F32_TOL, atol=DAG_F32_TOL):
        raise AssertionError(f"residual_cifar f32: K1 {k1} launches, max abs err {err}")
    qm = quantize.quantize_dag(fused, params, x[:8])
    plan_q = schedule.plan_dag(g, io_dtype_bytes=1)
    xq = quantize.quantize_input(qm, x)
    ex, p8 = qexec.make_int8_executor(qm, plan_q, device="cuda")
    for cnt in counters.values():
        cnt.reset()
    yq = ex(p8, xq.cuda()).cpu()
    k2 = counters["K2"].count
    if k2 != 1 or not torch.equal(yq, quantize.simulate_int8_dag_forward(qm, xq)):
        raise AssertionError(f"residual_cifar int8: K2 {k2} launches, not bit-exact "
                             f"vs the CPU simulator")
    report.emit({"phase": "residual_cifar_dag", "batch": 16,
                 "f32_max_abs_err_vs_cpu": err, "f32_tolerance": DAG_F32_TOL,
                 "int8_bit_exact_vs_cpu_simulator": True, "k1_launches": k1,
                 "k2_launches": k2, "arena_bytes_per_image":
                 {"f32": plan.arena_elems * 4, "int8": plan_q.arena_elems}})


def synthetic_mfcc(np, n_frames, seed, f=3.0):
    """A fake utterance: sine-modulated cepstral noise, (n, 1, 10) f32 (the
    function of ``examples/stream_kws.py``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)[:, None, None] / n_frames
    env = np.sin(np.pi * t) * np.cos(2 * np.pi * f * t)
    return np.asarray(env * rng.standard_normal((n_frames, 1, 10)), np.float32)


def _state_bytes(state) -> int:
    """Device bytes a stream's ring state holds: the storage behind its
    input ring and every layer ring."""
    tensors = [state["frames"], *state["rings"].values()]
    return sum(t.untyped_storage().nbytes() for t in tensors)


def _stream_push_times(torch, np, srv, frames):
    """Push ``frames`` into one fresh warm stream: (host µs of each push,
    emitted flags, µs a frame over the whole run, the last synchronize
    included)."""
    sid = "timed"
    srv.open(sid)
    for t in range(8):  # warm the stream's own tensors
        srv.push(sid, frames[t])
    torch.cuda.synchronize()
    times, emitted = [], []
    t_start = time.perf_counter()
    for fr in frames:
        t0 = time.perf_counter()
        out = srv.push(sid, fr)
        times.append((time.perf_counter() - t0) * 1e6)
        emitted.append(out is not None)
    torch.cuda.synchronize()
    per_frame_us = (time.perf_counter() - t_start) * 1e6 / len(frames)
    srv.close(sid)
    return np.asarray(times), np.asarray(emitted), per_frame_us


def _emission_profile(torch, srv, frames):
    """One emission of a warm stream under the profiler, a non-emitting
    push then an emitting one: kernel and memcpy records, K3/K4 device µs,
    all device µs."""
    sid = "profiled"
    srv.open(sid)
    srv.push(sid, frames[0])
    srv.push(sid, frames[1])

    def two():
        assert srv.push(sid, frames[2]) is None
        assert srv.push(sid, frames[3]) is not None

    _, events, _ = kernel_events(torch, two, two)
    srv.close(sid)
    kern = [ev for ev in events if not ev.key.startswith(("Memcpy", "Memset"))]
    n_kern = sum(ev.count for ev in kern)
    return {"kernel_records": n_kern,
            "memcpy_records": sum(ev.count for ev in events) - n_kern,
            "dw_kernel_device_us": sum(ev.self_device_time_total for ev in kern
                                       if "conv_pool_dw" in ev.key),
            "device_us": sum(ev.self_device_time_total for ev in events)}


def _full_recompute(torch, np, g, params_cpu, int8, rng):
    """The per-frame cost without streaming: one batch-1 call of the
    DagArenaExecutor on the fused graph's plan, its output downloaded, as a
    frame's classification needs (host µs: mean and p50; device µs from the
    profiler)."""
    from repro_torch.core import fusion, pingpong, quantize, schedule
    from repro_torch.quant import exec as qexec

    fused = schedule.fuse_dag_priced(g)
    p_fused = fusion.rename_params(fused, params_cpu)
    in_shape = tuple(g.nodes[0].layer.shape)
    x = torch.as_tensor(rng.standard_normal((1, *in_shape)), dtype=torch.float32)
    if int8:
        calib = torch.as_tensor(rng.standard_normal((8, *in_shape)), dtype=torch.float32)
        qmf = quantize.quantize_dag(fused, p_fused, calib)
        ex, params = qexec.make_int8_executor(qmf, schedule.plan_dag(g, io_dtype_bytes=1),
                                              device="cuda")
        x = quantize.quantize_input(qmf, x)
    else:
        ex = pingpong.make_dag_executor(fused, schedule.plan_dag(g))
        params = {k: {kk: v.cuda() for kk, v in p.items()} for k, p in p_fused.items()}
    x = x.cuda()

    def call():
        return ex(params, x).cpu()

    for _ in range(5):
        call()
    times = []
    for _ in range(FULL_RECOMPUTE_CALLS):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e6)
    dev = device_ms(torch, lambda: ex(params, x), iters=20)
    return {"us_mean": float(np.mean(times)), "us_p50": float(np.percentile(times, 50)),
            "device_us": None if dev is None else dev * 1e3}


def stream_phase(torch, np, report) -> list:
    """Streaming keyword spotting on the card through ``StreamServer``:
    ds_cnn and ds_cnn_kws, f32 and int8, STREAMS interleaved streams of
    STREAM_FRAMES frames, held against the sliding full-window oracle on the
    card's plain path (``nn.forward_dag`` / ``simulate_int8_dag_forward``,
    each stream's windows one batch): int8 bit-exact at every emission and
    every non-emitting push ``None``, f32 within STREAM_F32_TOL, the int8
    emissions' smoothed labels (``PosteriorSmoother``, window 3, mean and
    vote) those of the oracle's.  Launches pinned (K3 or K4: 12 an emission,
    4 an open, 0 a non-emitting frame; no other kernel), ring state and
    arena bytes pinned; push times, the full recompute and one profiled
    emission recorded."""
    from repro_torch.core import graph, nn, quantize, streaming
    from repro_torch.serve.cnn_engine import StreamServer

    counters = _counters()
    rows = []
    for ni, net in enumerate(STREAM_NETS):
        g = getattr(graph, net)()
        params = nn.init_params(g, torch.Generator().manual_seed(20 + ni), device="cpu")
        calib = torch.from_numpy(synthetic_mfcc(np, 49 * 8, 90 + ni).reshape(8, 1, 49, 10))
        qm = quantize.quantize_dag(g, params, calib)
        for int8 in (False, True):
            dtype, dw, db = ("int8", "K4", 1) if int8 else ("f32", "K3", 4)
            utts = [synthetic_mfcc(np, STREAM_FRAMES, 100 * ni + i, f=3.0 + 2 * i)
                    for i in range(STREAMS)]
            if int8:
                srv = StreamServer.from_quantized(qm, device="cuda")
                frames = [quantize.quantize_input(qm, torch.from_numpy(u)).numpy()
                          for u in utts]
                oracle = lambda _, w: quantize.simulate_int8_dag_forward(qm, w)  # noqa: E731
            else:
                srv = StreamServer.from_graph(g, params, device="cuda")
                frames = utts
                oracle = lambda p, w: nn.forward_dag(g, p, w)  # noqa: E731
            splan = srv.executor.splan
            want_arena, want_state = STREAM_BYTES[(net, db)]
            if (splan.plan.arena_bytes, splan.ring_elems * db) != (want_arena, want_state):
                raise AssertionError(f"stream {net} {dtype}: arena / state "
                                     f"{splan.plan.arena_bytes} / {splan.ring_elems * db} B")
            # -- the served run: every count set to 0 just before, read after
            sids = [f"s{i}" for i in range(STREAMS)]
            for c in counters.values():
                c.reset()
            for sid in sids:
                srv.open(sid)
            opened = {k: c.count for k, c in counters.items()}
            for c in counters.values():
                c.reset()
            got = {sid: [] for sid in sids}
            bad = None
            for t in range(STREAM_FRAMES):
                for i, sid in enumerate(sids):
                    before = counters[dw].count
                    out = srv.push(sid, frames[i][t])
                    launched = counters[dw].count - before
                    want = STREAM_DW_PER_EMISSION if out is not None else 0
                    if launched != want and bad is None:
                        bad = f"{launched} launches on frame {t} of {sid} (want {want})"
                    got[sid].append(out)
            counts = {k: c.count for k, c in counters.items()}
            torch.cuda.synchronize()
            if bad is not None:
                raise AssertionError(f"stream {net} {dtype}: {dw} {bad}")
            emissions = sum(o is not None for sid in sids for o in got[sid])
            want_counts = {k: 0 for k in counters}
            want_counts[dw] = STREAM_DW_PER_EMISSION * emissions
            want_open = {k: 0 for k in counters}
            want_open[dw] = STREAM_DW_PER_OPEN * STREAMS
            if counts != want_counts or opened != want_open:
                raise AssertionError(f"stream {net} {dtype}: launches {counts} for "
                                     f"{emissions} emissions (want {want_counts}), "
                                     f"opens {opened} (want {want_open})")
            state_bytes = {sid: _state_bytes(srv._states[sid]) for sid in sids}
            if set(state_bytes.values()) != {want_state}:
                raise AssertionError(f"stream {net} {dtype}: ring state on the card "
                                     f"{state_bytes} B, want {want_state}")
            # -- against the sliding full-window oracle on the card
            worst = 0.0
            for i, sid in enumerate(sids):
                ref, ref_em = streaming.sliding_window_reference(
                    g, srv.params, frames[i], forward_fn=oracle, device="cuda")
                if [o is not None for o in got[sid]] != ref_em.tolist():
                    raise AssertionError(f"stream {net} {dtype} {sid}: emissions on "
                                         f"other frames than the oracle's")
                mine, theirs = np.stack([o for o in got[sid] if o is not None]), ref[ref_em]
                if int8:
                    if mine.dtype != np.int8 or not np.array_equal(mine, theirs):
                        raise AssertionError(f"stream {net} int8 {sid}: not bit-exact "
                                             f"against the sliding oracle")
                    for mode in ("mean", "vote"):
                        sm_a, sm_b = (streaming.PosteriorSmoother(window=3, mode=mode)
                                      for _ in range(2))
                        if [sm_a.update(e) for e in mine] != [sm_b.update(e) for e in theirs]:
                            raise AssertionError(f"stream {net} int8 {sid}: smoothed "
                                                 f"labels ({mode}) differ")
                else:
                    err = float(np.abs(mine - theirs).max())
                    worst = max(worst, err)
                    if not np.isfinite(mine).all() or not np.allclose(
                            mine, theirs, rtol=STREAM_F32_TOL, atol=STREAM_F32_TOL):
                        raise AssertionError(f"stream {net} f32 {sid}: max abs err {err} "
                                             f"against the sliding oracle")
            for sid in sids:
                srv.close(sid)
            # -- recorded, not gated
            push_us, em, per_frame_us = _stream_push_times(torch, np, srv, frames[0])
            prof = _emission_profile(torch, srv, frames[1])
            full = _full_recompute(torch, np, g, params, int8, np.random.default_rng(ni))
            row = {"phase": "stream", "net": net, "dtype": dtype, "streams": STREAMS,
                   "frames_per_stream": STREAM_FRAMES, "emissions": emissions,
                   "emit_stride": splan.emit_stride,
                   **({"bit_exact": True, "smoothed_labels_equal": True} if int8 else
                      {"max_abs_err": worst, "tolerance": STREAM_F32_TOL}),
                   f"{dw.lower()}_launches": counts[dw],
                   f"{dw.lower()}_per_emission": STREAM_DW_PER_EMISSION,
                   f"{dw.lower()}_per_open": opened[dw] // STREAMS,
                   "ring_arena_bytes": splan.plan.arena_bytes,
                   "ring_state_bytes_on_card": want_state, "prewarm_s": srv.prewarm_s,
                   "push_us_emitting": {q: _pct(np, push_us[em], n) for q, n in PCTS},
                   "push_us_not_emitting": {q: _pct(np, push_us[~em], n)
                                            for q, n in PCTS},
                   "us_per_frame": per_frame_us,
                   "full_recompute_us_per_frame": full["us_mean"],
                   "full_recompute_us_p50": full["us_p50"],
                   "full_recompute_device_us": full["device_us"],
                   "full_over_stream": full["us_mean"] / per_frame_us,
                   "emission_profile": prof,
                   # the device's busy share of an emitting push (p50)
                   "device_share_of_emitting_push":
                       prof["device_us"] / _pct(np, push_us[em], 50),
                   "frame_period_ms": FRAME_PERIOD_MS,
                   "tf32": torch.backends.cudnn.allow_tf32}
            report.emit(row)
            rows.append(row)
    return rows


def report_phase(torch, np, report) -> list:
    """``obs.report.workload_report(timed=True)`` for the five workloads in
    f32 and int8 on the card: the arena timeline's peak equals the plan's
    bytes for each, ds_cnn totals 2,539,840 MACs, every segment timed with
    CUDA events; the three slowest segments and the three furthest from
    their MAC share printed."""
    from repro_torch.obs.report import WORKLOADS, workload_report

    def brief(seg_rows):
        return [{"segment": f"{x['first']}..{x['last']}", "kind": x["kind"],
                 "us": x["measured_s"] * 1e6, "measured_frac": x["measured_frac"],
                 "model_frac": x["model_frac"]} for x in seg_rows[:3]]

    rows = []
    for name in WORKLOADS:
        for int8 in (False, True):
            r = workload_report(name, int8=int8, timed=True, iters=REPORT_ITERS,
                                device="cuda")
            arena, seg, timing = r["arena"], r["segments"], r["timing"]
            if arena["peak_bytes"] != arena["arena_bytes"]:
                raise AssertionError(f"report {name} {r['dtype']}: timeline peak "
                                     f"{arena['peak_bytes']} != {arena['arena_bytes']} B")
            if name == "ds_cnn" and seg["total_macs"] != 2_539_840:
                raise AssertionError(f"report ds_cnn: {seg['total_macs']} MACs")
            if timing["clock"] != "cuda-events" or len(timing["by_time"]) != seg["n_segments"]:
                raise AssertionError(f"report {name} {r['dtype']}: {timing['clock']}, "
                                     f"{len(timing['by_time'])} timed segments")
            row = {"phase": "report", "workload": name, "dtype": r["dtype"],
                   "arena_bytes": arena["arena_bytes"], "peak_bytes": arena["peak_bytes"],
                   "n_segments": seg["n_segments"], "segments_by_kind": seg["segments_by_kind"],
                   "total_macs": seg["total_macs"], "total_us": timing["total_s"] * 1e6,
                   "slowest": brief(timing["by_time"]),
                   "largest_discrepancy": brief(timing["by_discrepancy"])}
            report.emit(row)
            rows.append(row)
    return rows


def _gcc_build(gcc, src: str, path: Path):
    """Write one emitted engine to ``path`` (.c) and start gcc on it, as the
    reference's C tests build theirs; returns (the binary, the process)."""
    path.write_text(src)
    binary = path.with_suffix("")
    proc = subprocess.Popen([gcc, "-O2", "-std=c99", str(path), "-o", str(binary), "-lm"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return binary, proc


def _gcc_wait(name, proc) -> None:
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"c_export {name}: gcc failed:\n{out[-4000:]}")


def _c_outputs(np, binary: Path, xs, dtype):
    """The C engine's output for each input: one run of its ``main()``
    harness a request (stdin -> nn_forward -> stdout)."""
    outs = []
    for x in xs:
        out = subprocess.run([str(binary)], input=np.ascontiguousarray(x).tobytes(),
                             capture_output=True, timeout=60, check=True).stdout
        outs.append(np.frombuffer(out, dtype))
    return np.stack(outs)


def _c_arena_bytes(src: str, elem: int) -> int:
    """Bytes of the one static arena an emitted engine declares."""
    import re

    (elems,) = re.findall(r"^static (?:float|int8_t) arena\[(\d+)\];$", src, re.M)
    return int(elems) * elem


def _train_lenet(torch, np):
    """LeNet-5 trained on the card on the synthetic digits, the reference's
    recipe (``tests/test_system.py::_short_train``): batches of 32 drawn
    from make_dataset(512, seed=0), the port's AdamW (peak 2e-3, 10 warmup
    steps, no weight decay), plain autograd through ``nn.forward``.
    Returns (graph, params on the card, final loss)."""
    from repro_torch.core import nn
    from repro_torch.core.graph import lenet5
    from repro_torch.data.mnist_synth import make_dataset
    from repro_torch.train import optimizer
    from repro_torch.tree import leaves, unflatten_like

    g = lenet5()
    params = nn.init_params(g, torch.Generator().manual_seed(0), device="cuda")
    imgs, labels = make_dataset(512, seed=0)
    imgs, labels = torch.from_numpy(imgs).cuda(), torch.from_numpy(labels).long().cuda()
    cfg = optimizer.AdamWConfig(lr_peak=2e-3, warmup_steps=10,
                                total_steps=LENET_TRAIN_STEPS, weight_decay=0.0)
    state = optimizer.init_state(params)
    rng = np.random.default_rng(0)
    loss = None
    for _ in range(LENET_TRAIN_STEPS):
        idx = torch.from_numpy(rng.integers(0, len(imgs), 32)).cuda()
        flat = [p.requires_grad_(True) for p in leaves(params)]
        logits = nn.forward(g, params, imgs[idx])
        y = labels[idx]
        loss = (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).mean()
        grads = unflatten_like(params, torch.autograd.grad(loss, flat))
        params, state, _ = optimizer.apply_adamw(cfg, params, grads, state)
    params = {k: {kk: v.detach() for kk, v in p.items()} for k, p in params.items()}
    return g, params, float(loss.detach())


def c_export_phase(torch, np, report, engines) -> None:
    """The paper's deliverable on the port: C engines emitted by
    `repro_torch.core.export_c`, built with gcc and held to the card.

    1. Each of the six CNN engines (same graph, plan and weights as served)
       is emitted, built, and fed the first C_INPUTS requests it served:
       int8 equal to the card's outputs (K2/K4, K2 heads) bit for bit, f32
       within C_F32_TOL; the C arena's bytes equal the plan's.
    2. The paper's flow: LeNet-5 trained on the card, fused, planned
       (8,800 B), emitted and built; its C engine agrees with the card's
       CNNEngine (K1, every counter set to 0 just before and read just
       after) on make_dataset(16, seed=42) within LENET_C_TOL, and gets at
       least C_MIN_CORRECT right.
    gcc is the host compiler nvcc needs; without it the phase raises."""
    import shutil

    from repro_torch.core import export_c, fusion, planner
    from repro_torch.core.graph import DAGGraph
    from repro_torch.data.mnist_synth import make_dataset
    from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy

    gcc = shutil.which("gcc")
    if gcc is None:
        raise AssertionError("c_export: no gcc on PATH (nvcc's host compiler)")
    gcc_version = subprocess.run([gcc, "--version"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.splitlines()[0]
    out_dir = ROOT / "build" / "c_engines"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    builds = {}
    for name, e in engines.items():
        dag = isinstance(e["fused"], DAGGraph)
        if name.endswith("_int8"):
            emit = export_c.generate_c_int8_dag if dag else export_c.generate_c_int8
            src = emit(e["model"], e["plan"], with_main=True)
        else:
            emit = export_c.generate_c_dag if dag else export_c.generate_c
            src = emit(e["fused"], e["plan"], e["model"], with_main=True)
        builds[name] = (src, *_gcc_build(gcc, src, out_dir / f"{name}.c"))
    results = {}
    for name, (src, binary, proc) in builds.items():
        _gcc_wait(name, proc)
        e = engines[name]
        xs, y_card = e["served"]
        int8 = name.endswith("_int8")
        y_c = _c_outputs(np, binary, xs, np.int8 if int8 else np.float32)
        y_card = y_card.reshape(len(xs), -1)
        c_bytes = _c_arena_bytes(src, 1 if int8 else 4)
        if c_bytes != e["arena_bytes"] or c_bytes != e["plan"].arena_bytes:
            raise AssertionError(f"c_export {name}: C arena {c_bytes} B, plan "
                                 f"{e['plan'].arena_bytes} B, engine {e['arena_bytes']} B")
        err = float(np.abs(y_c.astype(np.float64) - y_card).max())
        if int8:
            ok, tol = np.array_equal(y_c, y_card), "bit-exact"
        else:
            rtol, atol = C_F32_TOL[name]
            ok, tol = np.allclose(y_c, y_card, rtol=rtol, atol=atol), [rtol, atol]
        if not ok:
            raise AssertionError(f"c_export {name}: C engine vs the card: max abs "
                                 f"err {err} (tolerance {tol})")
        results[name] = {"inputs": len(xs), "max_abs_err_vs_card": err,
                         "tolerance": tol, "c_arena_bytes": c_bytes,
                         "plan_arena_bytes": e["plan"].arena_bytes,
                         "c_source_bytes": len(src)}

    # -- the paper's flow: train -> fuse -> plan -> emit C -> gcc ---------------
    t1 = time.perf_counter()
    g, params, final_loss = _train_lenet(torch, np)
    train_s = time.perf_counter() - t1
    if not final_loss < 2.3:  # uniform over 10 classes is ln 10 = 2.30
        raise AssertionError(f"c_export: LeNet-5 did not learn (loss {final_loss})")
    fused = fusion.fuse(g)
    fp = fusion.rename_params(fused, params)
    plan = planner.plan_pingpong(g)
    planner.verify_plan(plan)
    if plan.activation_bytes(4) != 8800:
        raise AssertionError(f"c_export: LeNet-5 plan {plan.activation_bytes(4)} B, "
                             f"not the paper's 8,800")
    src = export_c.generate_c(fused, plan, fp, with_main=True)
    binary, proc = _gcc_build(gcc, src, out_dir / "lenet5_trained.c")
    imgs, labels = make_dataset(16, seed=42)
    engine = CNNEngine.from_graph(fused, plan, fp, device="cuda", buckets=BUCKETS,
                                  policy=CoalescePolicy(max_batch=BUCKETS[-1]))
    counters = _counters()
    with engine:
        for c in counters.values():
            c.reset()
        reqs, run = engine.serve(imgs)
        counts = {k: c.count for k, c in counters.items()}
    y_card = np.stack([r.y for r in reqs]).reshape(len(imgs), -1)
    if counts["K1"] != 2 * run.batches or sum(counts.values()) != counts["K1"]:
        raise AssertionError(f"c_export: trained LeNet-5 engine launches {counts} "
                             f"for {run.batches} batches (want K1 2 a batch)")
    _gcc_wait("lenet5_trained", proc)
    y_c = _c_outputs(np, binary, imgs, np.float32)
    err = float(np.abs(y_c.astype(np.float64) - y_card).max())
    rtol, atol = LENET_C_TOL
    if not np.allclose(y_c, y_card, rtol=rtol, atol=atol):
        raise AssertionError(f"c_export: trained LeNet-5 C engine vs the card's "
                             f"engine: max abs err {err}")
    correct = int((y_c.argmax(-1) == labels).sum())
    if correct < C_MIN_CORRECT:
        raise AssertionError(f"c_export: trained LeNet-5 C engine gets {correct}/16")
    report.emit({"phase": "c_export", "gcc": gcc_version, "engines": results,
                 "paper_flow": {
                     "train_steps": LENET_TRAIN_STEPS, "train_s": train_s,
                     "final_loss": final_loss, "plan_bytes": plan.activation_bytes(4),
                     "c_arena_bytes": _c_arena_bytes(src, 4),
                     "k1_launches": counts["K1"], "batches": run.batches,
                     "max_abs_err_c_vs_card": err, "tolerance": [rtol, atol],
                     "correct": correct, "of": len(imgs)},
                 "seconds": time.perf_counter() - t0})


# Per kernel: (function name, type, depthwise, engines of the main path it
# runs in, source, TPU kernel it replaces).
KERNELS = {
    "K1": ("conv_pool_f32", "f32", False,
           ("lenet5_f32", "ds_cnn_kws_f32", "mobilenet_v1_0.25_f32"),
           "src/repro_torch/csrc/conv_pool.cu",
           "src/repro/kernels/conv_pool/kernel.py:89"),
    "K2": ("conv_pool_q8", "int8", False,
           ("cifar_int8", "ds_cnn_kws_int8", "mobilenet_v1_0.25_int8"),
           "src/repro_torch/csrc/conv_pool_q8.cu",
           "src/repro/quant/kernel_q8.py:46"),
    "K3": ("conv_pool_dw_f32", "f32", True,
           ("ds_cnn_kws_f32", "mobilenet_v1_0.25_f32"),
           "src/repro_torch/csrc/conv_pool_dw.cu",
           "src/repro/kernels/conv_pool/depthwise.py:34"),
    "K4": ("conv_pool_dw_q8", "int8", True,
           ("ds_cnn_kws_int8", "mobilenet_v1_0.25_int8"),
           "src/repro_torch/csrc/conv_pool_dw_q8.cu",
           "src/repro/quant/kernel_q8.py:95"),
}


def _geometry(layer, in_shape):
    """The kernel call a step makes: (cin, H, W, cout, (kh, kw), stride,
    padding, pool_k, pool_stride, activation, pool); a depthwise step's
    ReLU view is folded into the kernel."""
    cin, H, W = in_shape
    if layer.kind == "DepthwiseConv2d":
        return (cin, H, W, cin, layer.kernel_size, layer.stride, layer.padding,
                (1, 1), (1, 1), "relu", "max")
    conv = layer.conv
    cout = conv.channels if conv.kind == "DepthwiseConv2d" else conv.out_channels
    return (cin, H, W, cout, conv.kernel_size, conv.stride, conv.padding,
            layer.pool_kernel, layer.pool_stride, layer.activation, layer.pool)


def timing_phase(torch, np, report, engines):
    """Time each kernel at the main path's shapes, once per distinct call
    geometry; returns the kernels line's entries (N=16)."""
    entries = []
    rng = np.random.default_rng(3)
    for kname, (fn_name, kind, dw, nets, source, replaces) in KERNELS.items():
        seen = set()
        for net in nets:
            for name, layer, in_shape in _kernel_steps(engines[net]["fused"]):
                if (layer.kind == "DepthwiseConv2d"
                        or layer.conv.kind == "DepthwiseConv2d") != dw:
                    continue
                geo = _geometry(layer, in_shape)
                if geo in seen:
                    continue
                seen.add(geo)
                (cin, H, W, cout, k, cs, pad, pk, ps, act, pool) = geo
                key = (cin, H, W, cout, *k, *cs, *pad, *pk, *ps, pool)
                launches = sum(v for n2 in nets
                               for kk, v in engines[n2]["counts"][kname][1].items()
                               if kk[0] == fn_name and kk[2:] == key)
                geom = dict(conv_stride=cs, padding=pad, pool_k=pk, pool_stride=ps,
                            activation=act, pool=pool)
                shape_w = (cout, 1 if dw else cin, *k)
                groups = cin if dw else 1
                for n in (1, BUCKETS[-1]):
                    t, err, lib_note = _time_one(torch, np, rng, kind, dw, n,
                                                 in_shape, shape_w, cout, groups,
                                                 geom)
                    bms, bby = bound(kind, n, cin, H, W, cout, k, cs, pad, pk, ps,
                                     depthwise=dw)
                    report.emit({"phase": "timing", "kernel": kname,
                                 "layer": f"{net}/{name}", "batch": n,
                                 "max_abs_err": err, "bound_ms": bms,
                                 "bound_by": bby, "library": lib_note, **t})
                    if n == BUCKETS[-1]:
                        entries.append({
                            "name": f"{kname} {fn_name} [{net}/{name}, N={n}]",
                            "route": "cuda", "source": source, "replaces": replaces,
                            "launches": launches, "max_abs_err": err,
                            "ms": t["ms"], "plain_ms": t["plain_ms"],
                            "bound_ms": bms, "bound_by": bby,
                            "library_ms": t["library_ms"] if kind == "f32" else None,
                            "device_ms": t["device_ms"],
                        })
    return entries


def _time_one(torch, np, rng, kind, dw, n, in_shape, shape_w, cout, groups, geom):
    """({ms, plain_ms, library_ms, *device_ms}, max abs err, library note)
    for one kernel call at one shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv_pool import ref
    from repro_torch.kernels.conv_pool.depthwise import (
        depthwise_conv_pool_ref, fused_depthwise_conv_pool)
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.quant.kernel_q8 import (
        conv_pool_q8_ref, depthwise_conv_pool_q8_ref, fused_conv_pool_q8,
        fused_depthwise_conv_pool_q8)

    cs, pad, pk, ps = (geom[k] for k in ("conv_stride", "padding", "pool_k",
                                         "pool_stride"))
    pool_fn = F.max_pool2d if geom["pool"] == "max" else F.avg_pool2d
    if kind == "f32":
        x = torch.as_tensor(rng.standard_normal((n, *in_shape)), dtype=torch.float32,
                            device="cuda")
        w = torch.as_tensor(rng.standard_normal(shape_w) * 0.1, dtype=torch.float32,
                            device="cuda")
        b = torch.as_tensor(rng.standard_normal(cout) * 0.1, dtype=torch.float32,
                            device="cuda")
        if dw:
            kern = lambda: fused_depthwise_conv_pool(x, w, b, **geom)
            plain = lambda: depthwise_conv_pool_ref(x, w, b, **geom)
        else:
            kern = lambda: fused_conv_pool(x, w, b, **geom)
            plain = lambda: ref.conv_pool_ref(x, w, b, **geom)
        xl, wl, bl = x, w, b
        lib_note = (f"F.conv2d(groups={groups}) -> F.relu -> pool, f32, TF32 off"
                    if dw else "F.conv2d -> F.relu -> pool, f32, TF32 off")
    else:
        x = torch.as_tensor(rng.integers(-128, 128, (n, *in_shape)), dtype=torch.int8,
                            device="cuda")
        w = torch.as_tensor(rng.integers(-127, 128, shape_w), dtype=torch.int8,
                            device="cuda")
        b = torch.as_tensor(rng.integers(-4000, 4000, cout), dtype=torch.int32,
                            device="cuda")
        if dw:
            m = _dw_multipliers(np, rng, cout)
            ms = torch.as_tensor(m, device="cuda")
            kern = lambda: fused_depthwise_conv_pool_q8(x, w, b, multiplier=m, ms=ms,
                                                        **geom)
            plain = lambda: depthwise_conv_pool_q8_ref(x, w, b, multiplier=m, **geom)
        else:
            m = float(np.float32(3e-4))
            kern = lambda: fused_conv_pool_q8(x, w, b, multiplier=m, **geom)
            plain = lambda: conv_pool_q8_ref(x, w, b, multiplier=m, **geom)
        xl, wl, bl = x.double(), w.double(), b.double()
        lib_note = (f"float64 F.conv2d(groups={groups}) -> F.relu -> pool: a "
                    f"reference of another type, not int8")

    def library():
        y = F.conv2d(xl, wl, bl, stride=cs, padding=pad, groups=groups)
        if geom["activation"] == "relu":
            y = F.relu(y)
        return pool_fn(y, pk, ps) if tuple(pk) != (1, 1) else y

    y_k, y_p = kern(), plain()
    torch.cuda.synchronize()
    err = float((y_k.double() - y_p.double()).abs().max())
    t = {"ms": event_ms(torch, kern), "plain_ms": event_ms(torch, plain),
         "library_ms": event_ms(torch, library), "device_ms": device_ms(torch, kern),
         "plain_device_ms": device_ms(torch, plain),
         "library_device_ms": device_ms(torch, library)}
    return t, err, lib_note


# ---------------------------------------------------------------------------
# The LM serving path: K5 (flash attention) and K7 (chunked wkv6)
# ---------------------------------------------------------------------------
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# K5 on the Llama-3.2-1B attention shapes (H=32, K=8, h=64) and beyond:
# (B, S, H, K, h, window, softcap)
K5_SEQS = (1, 17, 128, 129, 512, 1000)
K5_EXTRA = [(1, 1000, 32, 8, 64, 256, 0.0), (1, 512, 32, 8, 64, 0, 50.0),
            (2, 129, 4, 1, 128, 0, 0.0), (1, 300, 2, 1, 256, 0, 0.0),
            # the served shapes of RecurrentGemma-9B's local layers (h 256,
            # 16 query heads over one KV head, window 2048) and Qwen2-MoE's
            # (h 128, 16 / 16), and RecurrentGemma's where the window bites
            (1, 509, 16, 1, 256, 2048, 0.0), (1, 509, 16, 16, 128, 0, 0.0),
            (1, 1000, 16, 1, 256, 256, 0.0),
            # Seamless-M4T's decoder self-attention at its served prompts
            (4, 8, 16, 16, 64, 0, 0.0), (4, 16, 16, 16, 64, 0, 0.0),
            # Qwen2-VL-7B: 28 query heads over 4 KV heads (GQA 7:1, h 128) at
            # its longest served prompt, at 1,000 tokens and at its train shape
            (1, 509, 28, 4, 128, 0, 0.0), (1, 1000, 28, 4, 128, 0, 0.0),
            (4, 512, 28, 4, 128, 0, 0.0)]
# K5 without the causal mask, (B, S, H, K, h, T): Seamless-M4T's encoder
# self-attention over 1,000 frames (S = T), one utterance and its served
# batches of 4 at 509 and 1,000 frames, and its decoder's cross-attention
# from prompts of 8 and 16 tokens over 509 and 1,000 frames (S != T)
K5_NONCAUSAL = [(1, 1000, 16, 16, 64, 1000), (4, 509, 16, 16, 64, 509),
                (4, 1000, 16, 16, 64, 1000), (4, 8, 16, 16, 64, 509),
                (4, 16, 16, 16, 64, 1000)]
K5_TOL = {"f32": 2e-5, "bf16": 5e-2}  # rtol = atol, tests/test_kernel_flash.py
# bf16 also per output row (one query, one head): max |diff| within this
# share of the row's largest |value|.  Two roundings to bf16 of nearly
# equal f32 values differ by at most one bf16 ulp, <= 2^-7 of the value.
K5_BF16_ROW_REL = 2e-2
# K7 on the RWKV6-7B time-mix shapes (H=64, hk=hv=64)
K7_SEQS = (2, 63, 64, 256, 509)
K7_CHUNKS = (64, 8)
# K7 off the RWKV6-7B head, ((B, H, hk, hv), S): a head size of 24 (the
# kernels' general path, not the one unrolled for 64) and value widths that
# are not whole 16-column slices (the carry's element-wise staging)
K7_OTHER_SHAPES = [((1, 4, 24, 40), 63), ((2, 3, 64, 20), 200)]
# K7 from a carried state (a chunked prefill's later pieces)
K7_S0_SEQS = (63, 256, 509)
K7_RTOL, K7_ATOL = 1e-4, 1e-5  # tests/test_kernel_wkv.py:50
# K7 timed at the served prompt lengths, 509 (prime) among them
K7_TIMING_SEQS = (128, 509, 512, 1000)
K7_KERNELS = ("wkv_intra_kernel", "wkv_carry_kernel")  # one K7 call launches both
# Served prefill logits (bf16, the configs' own compute dtype), kernel path
# against the plain path on the card: (max |difference|, |difference| /
# |plain logits| in the 2-norm), per architecture.  Both paths sum in f32 in
# different orders; 32 random-weight bf16 RWKV layers turn those last-bit
# differences into flipped bf16 roundings that grow layer by layer (at f32
# the same 32 layers differ by ~1e-4: rwkv_drift_phase), so RWKV6-7B's
# limit is set from its reading with headroom: 1.86 / 0.466 with the
# earlier one-CTA-a-head K7 and 1.859 / 0.466 with the two-pass one, on an
# H100 80GB HBM3 at 700 W (PERF.md section 6).  K7 is held tightly by
# k7_checks, lm_strict_phase and rwkv_drift_phase.  RecurrentGemma-9B's and
# Qwen2-MoE-A2.7B's limits are their first readings on an H100 80GB HBM3 at
# 700 W, 0.141 / 0.0319 and 0.266 / 0.0678, with ~3.5x / 3x headroom (the
# paths differ in K5's 12 / 24 layers; at f32 lm_strict holds both at 1e-4).
# Llama-3-8B's and Nemotron-4-15B's are their first readings on an H100
# 80GB HBM3 at 700 W, 0.0703 / 0.0165 and 0.0781 / 0.0188, with ~3.5x / 3x
# headroom (K5 in all 32 layers).  Seamless-M4T-large-v2's (encdec_phase,
# the prefill's logits after encode, both batches) are its first readings
# on an H100 80GB HBM3 at 700 W, 0.0586 / 0.0127 at 509 frames and 0.0547 /
# 0.0124 at 1,000, with ~3.5x / 3x headroom (K5 in 72 launches a batch).
# Qwen2-VL-7B's (served from tokens through Engine, and vl_embeds' prefill
# from embeds) is its first reading on an H100 80GB HBM3 at 700 W, 0.0679 /
# 0.0163 served and 0.0684 / 0.0151 from embeds, with ~3.5x / 3x headroom
# (K5 in all 28 layers).
LM_LOGITS_TOL = {"llama3.2-1b": (0.25, 0.05), "rwkv6-7b": (3.0, 0.75),
                 "recurrentgemma-9b": (0.5, 0.1), "qwen2-moe-a2.7b": (1.0, 0.2),
                 "llama3-8b": (0.25, 0.05), "nemotron-4-15b": (0.3, 0.06),
                 "seamless-m4t-large-v2": (0.2, 0.04), "qwen2-vl-7b": (0.25, 0.05)}
LM_STRICT_TOL = 1e-4  # f32 compute, TF32 off: rtol = atol
# RWKV6-7B at full depth, kernel path against plain path (rwkv_drift_phase),
# on the prompts below, at f32 compute: the final logits' (max |difference|,
# relative 2-norm), and K7's own share of each layer's time-mix output (the
# relative 2-norm on the plain path's input).  The earlier one-CTA-a-head K7
# read 4.58e-4 / 1.19e-4 and a share of at most 4.38e-7 on an H100 80GB
# HBM3 at 700 W (PERF.md section 6): about 8x and 20x headroom.
RWKV_DRIFT_PROMPTS = (200, 509)
RWKV_F32_DRIFT_TOL = (4e-3, 1e-3)
RWKV_F32_K7_SHARE = 1e-5
LM_ENGINES = {
    # arch: (seed, lanes, max_seq, max_new, fixed prompt lengths, (n, lo, hi)
    # drawn with np.random.default_rng(0).integers(lo, hi), kernel, per layer
    # of its kind).  Llama-3-8B and Nemotron-4-15B (32 attention layers, h
    # 128, GQA 32:8 / 48:8; Nemotron's squared-ReLU MLP) are served on
    # RecurrentGemma-9B's traffic.
    "llama3.2-1b": (0, 8, 1024, 32, (1, 128, 129, 509), (12, 2, 513), "K5"),
    "rwkv6-7b": (1, 4, 1024, 16, (2, 63, 64, 200, 256, 509), (2, 2, 257), "K7"),
    # 26 RG-LRU layers (the doubling scan, plain PyTorch) and 12 local
    # attention layers (K5, h 256, GQA 16:1; the window of 2048 is past
    # max_seq, so their caches are linear, not rings)
    "recurrentgemma-9b": (2, 4, 1024, 16, (1, 128, 129, 509), (4, 2, 513), "K5"),
    # 24 attention layers (K5, h 128, 16 KV heads, q/k/v bias), each with
    # 60 routed experts (top 4) and 4 shared ones (the GShard einsums)
    "qwen2-moe-a2.7b": (3, 4, 1024, 16, (1, 128, 129, 509), (4, 2, 513), "K5"),
    "llama3-8b": (4, 4, 1024, 16, (1, 128, 129, 509), (4, 2, 513), "K5"),
    "nemotron-4-15b": (5, 4, 1024, 16, (1, 128, 129, 509), (4, 2, 513), "K5"),
    # Qwen2-VL-7B's text decoder (28 attention layers, h 128, GQA 28:4, q/k/v
    # bias, M-RoPE in text mode), as Engine serves it; vl_embeds then drives
    # the same model from patch embeddings
    "qwen2-vl-7b": (6, 4, 1024, 16, (1, 128, 129, 509), (4, 2, 513), "K5"),
}
LM_KV_BYTES = {"llama3.2-1b": 268_959_744, "rwkv6-7b": 136_314_880,
               "recurrentgemma-9b": 54_788_096, "qwen2-moe-a2.7b": 805_699_584,
               "llama3-8b": 537_395_200, "nemotron-4-15b": 537_395_200,
               "qwen2-vl-7b": 235_339_776}
# A name every kernel of K5 / K7 has in the profiler
LM_KERNEL_SYMBOL = {"K5": "flash_fwd", "K7": "wkv_"}
# Plain-PyTorch parts of the served prefills timed as profiler ranges:
# (module, function, range name)
LM_RANGES = (("repro_torch.models.griffin", "rg_lru", "rg_lru_scan"),
             ("repro_torch.models.moe", "expert_mix", "moe_expert_einsums"))
# lm_strict: (arch, seed, prompt, layers); RecurrentGemma takes its first
# 3 layers, (rglru, rglru, local), so that K5 runs in the strict pass;
# Seamless-M4T 2 encoder and 2 decoder layers over LM_STRICT_SRC frames
LM_STRICT = (("llama3.2-1b", 10, 129, 2), ("rwkv6-7b", 11, 200, 2),
             ("recurrentgemma-9b", 12, 200, 3), ("qwen2-moe-a2.7b", 13, 200, 2),
             ("seamless-m4t-large-v2", 14, 16, 2), ("llama3-8b", 15, 200, 2),
             ("nemotron-4-15b", 16, 200, 2), ("qwen2-vl-7b", 17, 200, 2))
LM_STRICT_SRC = 200
# Seamless-M4T-large-v2 served (encdec_phase): (frames, prompt tokens) of
# each batch of ENCDEC_LANES utterances of one length (the reference has no
# memory mask, so a batch pads nothing), ENCDEC_STEPS greedy decode steps.
# 1,000 frames are 20 s of speech at the speech encoder's 50 Hz.
ENCDEC_BATCHES = ((509, 8), (1000, 16))
ENCDEC_LANES, ENCDEC_STEPS, ENCDEC_MAX_SEQ = 4, 32, 64
# kv_int8: Llama-3.2-1B served with an int8 and with a bf16 KV cache on one
# set of prompts; state bytes pinned; the first prefill's and decode step's
# logits held at tests/test_kv_quant.py's (rtol, atol) and their argmax
# agreeing on at least KV_INT8_ARGMAX_AGREE of the rows.
KV_INT8_BYTES = 143_130_624
KV_INT8_PREFILL_TOL, KV_INT8_DECODE_TOL = (0.2, 0.15), (0.25, 0.2)
KV_INT8_ARGMAX_AGREE = 0.5
# vl_embeds: Qwen2-VL-7B prefilled from VL_EMBEDS_LANES rows of
# VL_EMBEDS_ROWS patch embeddings ~ N(0, 1/D) each (the vision frontend is a
# stub in the reference: precomputed embeddings enter in place of the token
# embedding), then VL_EMBEDS_STEPS greedy decode steps on tokens.
VL_EMBEDS_LANES, VL_EMBEDS_ROWS, VL_EMBEDS_STEPS = 4, 509, 16


def _close(torch, a, b, rtol, atol):
    """(allclose, max abs err) of two tensors, compared in f32."""
    a, b = a.float(), b.float()
    return (bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
            float((a - b).abs().max()) if a.numel() else 0.0)


def _rows_close(y, y_ref, rel):
    """(ok, worst ratio): each row's max |y - y_ref| within ``rel`` of the
    row's largest |y_ref| (rows of zeros must match exactly)."""
    err = (y.float() - y_ref.float()).abs().amax(-1)
    ref = y_ref.float().abs().amax(-1)
    ratio = float((err / ref.clamp_min(1e-30)).max()) if err.numel() else 0.0
    return bool((err <= rel * ref).all()), ratio


@contextlib.contextmanager
def plain_kernels():
    """Inside, the model's K5, K6 and K7 calls (and so their autograd
    Functions) run their plain versions on any device, differentiable by
    autograd, so a pass on the card can be held against the kernel path."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.kernels.wkv.ref import wkv_chunked
    from repro_torch.kernels.xent import ops as xent_ops

    def wkv_plain(r, k, v, logw, u, *, chunk=64, s0=None):
        return wkv_chunked(r, k, v, logw.float(), u, s0,
                           chunk=wkv_ops.chunk_for(r.shape[1], chunk))

    def xent_plain(x, w, targets, **kw):
        return xent_ops.plain_xent(x.float(), w.float(), targets, **kw)

    saved = flash_ops.flash_attention, wkv_ops.wkv, xent_ops.fused_xent
    flash_ops.flash_attention, wkv_ops.wkv, xent_ops.fused_xent = (
        attention_ref, wkv_plain, xent_plain)
    try:
        yield
    finally:
        flash_ops.flash_attention, wkv_ops.wkv, xent_ops.fused_xent = saved


def k5_checks(torch, np, report) -> None:
    """K5 against its plain version: the Llama shapes at every S and batch,
    a window, a softcap, head dims 128 and 256, the non-causal shapes
    (``K5_NONCAUSAL``: T = S and T != S), and strided views."""
    from repro_torch.kernels.flash.kernel import K5_LAUNCHES
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref

    # (B, S, T, H, K, h, window, softcap, causal)
    cases = [(B, S, S, H, K, h, window, softcap, True) for B, S, H, K, h, window, softcap in
             [(B, S, 32, 8, 64, 0, 0.0) for S in K5_SEQS for B in (1, 2)] + K5_EXTRA]
    cases += [(B, S, T, H, K, h, 0, 0.0, False) for B, S, H, K, h, T in K5_NONCAUSAL]
    worst = {"f32": 0.0, "bf16": 0.0}
    worst_nc = {"f32": 0.0, "bf16": 0.0}
    worst_gqa7 = {"f32": 0.0, "bf16": 0.0}  # Qwen2-VL's 28 query heads over 4
    worst_row = 0.0
    n_checks = 0
    for ci, (B, S, T, H, K, h, window, softcap, causal) in enumerate(cases):
        rng = np.random.default_rng(9000 + ci)
        q = rng.standard_normal((B, S, H, h))
        k = rng.standard_normal((B, T, K, h))
        v = rng.standard_normal((B, T, K, h))
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            qt, kt, vt = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (q, k, v))
            geom = dict(causal=causal, window=window, softcap=softcap)
            before = K5_LAUNCHES.count
            y = flash_attention(qt, kt, vt, **geom)
            launches = K5_LAUNCHES.count - before
            y_ref = attention_ref(qt, kt, vt, **geom)
            torch.cuda.synchronize()
            ok, err = _close(torch, y, y_ref, K5_TOL[kind], K5_TOL[kind])
            row_ok, row = (_rows_close(y, y_ref, K5_BF16_ROW_REL)
                           if kind == "bf16" else (True, 0.0))
            if launches != 1 or y.dtype != dtype or not (ok and row_ok):
                raise AssertionError(f"K5 {(B, S, T, H, K, h, window, softcap, causal)} "
                                     f"{kind}: {launches} launches, max abs err {err}, "
                                     f"worst row share {row}")
            worst[kind] = max(worst[kind], err)
            if not causal:
                worst_nc[kind] = max(worst_nc[kind], err)
            if H == 7 * K:
                worst_gqa7[kind] = max(worst_gqa7[kind], err)
            worst_row = max(worst_row, row)
            n_checks += 1
    # strided views of one fused (B, S, H + 2K, h) projection, as they come
    rng = np.random.default_rng(9999)
    qkv = torch.as_tensor(rng.standard_normal((2, 129, 48, 64)), dtype=torch.bfloat16,
                          device="cuda")
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    y = flash_attention(q, k, v)
    y_ref = attention_ref(q, k, v)
    ok, err = _close(torch, y, y_ref, K5_TOL["bf16"], K5_TOL["bf16"])
    row_ok, row = _rows_close(y, y_ref, K5_BF16_ROW_REL)
    if not (ok and row_ok) or q.is_contiguous():
        raise AssertionError(f"K5 on strided views: max abs err {err}, worst row share {row}")
    # views whose base and head stride are not 16-byte aligned (the head dim
    # of a row of 65): K5 stages them by scalar loads in the same launch
    base = torch.as_tensor(rng.standard_normal((2, 130, 48, 65)), dtype=torch.bfloat16,
                           device="cuda")
    q, k, v = base[:, :, :32, 1:], base[:, :, 32:40, 1:], base[:, :, 40:, 1:]
    before = K5_LAUNCHES.count
    y = flash_attention(q, k, v)
    launches = K5_LAUNCHES.count - before
    y_ref = attention_ref(q, k, v)
    ok, mis_err = _close(torch, y, y_ref, K5_TOL["bf16"], K5_TOL["bf16"])
    row_ok, mis_row = _rows_close(y, y_ref, K5_BF16_ROW_REL)
    if not (ok and row_ok) or launches != 1 or q.data_ptr() % 16 == 0:
        raise AssertionError(f"K5 on misaligned views: {launches} launches, max abs err "
                             f"{mis_err}, worst row share {mis_row}")
    report.emit({"phase": "k5_vs_plain", "checks": n_checks + 2, "max_abs_err": worst,
                 "non_causal_checks": 2 * len(K5_NONCAUSAL),
                 "non_causal_max_abs_err": worst_nc,
                 "gqa_7_1_checks": 2 * sum(H == 7 * K for _, _, H, K, *_ in K5_EXTRA),
                 "gqa_7_1_max_abs_err": worst_gqa7,
                 "bf16_worst_row_share": max(worst_row, row, mis_row),
                 "strided_views_max_abs_err": err,
                 "misaligned_views_max_abs_err": mis_err, "tolerance": K5_TOL,
                 "bf16_row_share_limit": K5_BF16_ROW_REL})


def _wkv_inputs(torch, np, rng, B, S, H, h, dtype, hv=None):
    """r, k (head size h) and v (hv, h when None) in ``dtype``, logw in
    [-2, -0.02] and u, f32, on the card (the distributions of
    tests/test_kernel_wkv.py)."""
    r, k, v = (torch.as_tensor(rng.standard_normal((B, S, H, d)), dtype=dtype, device="cuda")
               for d in (h, h, hv or h))
    logw = torch.as_tensor(-rng.uniform(0.02, 2.0, (B, S, H, h)), dtype=torch.float32,
                           device="cuda")
    u = torch.as_tensor(rng.standard_normal((H, h)), dtype=torch.float32, device="cuda")
    return r, k, v, logw, u


def k7_round_units(hk: int, chunk: int) -> int:
    """How many f32 epsilons of an element's magnitude sum M two f32
    evaluations of the chunked scan may differ by: each element of o and
    s_final runs through a chain of at most hk + chunk sums (the pair term
    over hk, the pair times v over the chunk; the history read and the state
    update are no longer), each rounding by up to half an epsilon of M in
    each evaluation, and the decay exponents, differences of cumulative
    sums, add as much again; times 2 for headroom."""
    return 4 * (hk + chunk)


def k7_checks(torch, np, report) -> None:
    """K7 against its plain version (the chunked scan) at the RWKV6-7B
    shapes, chunk 64 and 8, r/k/v in f32 and bf16: o and s_final, from the
    zero state and (``K7_S0_SEQS``) from a carried state s0 ~ N(0, 1), as a
    chunked prefill starts, and at ``K7_OTHER_SHAPES``; K7 through ``wkv``
    (one launch), at its own tile, held to the allowance of the reference's
    chunk.  Both sum in f32 (K7 in a fixed order, the plain version in
    PyTorch's), so each element is held at rtol 1e-4, atol 1e-5 plus
    ``k7_round_units`` f32 epsilons of M, its terms' magnitudes summed: the
    same scan on |r|, |k|, |v|, |u| and |s0|.  A single misplaced term
    (|r k v| ~ 0.5) is ~25x that allowance at M ~ 300.  Emits the worst
    share of its own case's allowance, and that case."""
    from repro_torch.kernels.wkv.kernel import K7_LAUNCHES, TILE
    from repro_torch.kernels.wkv.ops import chunk_for, wkv
    from repro_torch.kernels.wkv.ref import wkv_chunked

    eps = torch.finfo(torch.float32).eps
    worst_share = (0.0, None)  # (share of its case's allowance, case)
    worst = {"o": 0.0, "s_final": 0.0}
    worst_units = {"o": 0.0, "s_final": 0.0}
    worst_s0 = {"o": 0.0, "s_final": 0.0}
    n_checks = n_s0 = 0
    rwkv = (1, 64, 64, 64)  # (B, H, hk, hv)
    cases = [(rwkv, S, chunk, False) for S in K7_SEQS for chunk in K7_CHUNKS]
    cases += [(rwkv, S, chunk, True) for S in K7_S0_SEQS for chunk in K7_CHUNKS]
    cases += [(shape, S, 64, carried) for shape, S in K7_OTHER_SHAPES
              for carried in (False, True)]
    for (B, H, hk, hv), S, chunk, carried in cases:
        c = chunk_for(S, chunk)
        units = k7_round_units(hk, c)
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            rng = np.random.default_rng(7000 + S * 10 + chunk + 5 * carried
                                        + (0 if (B, H, hk, hv) == rwkv else hk + hv))
            r, k, v, logw, u = _wkv_inputs(torch, np, rng, B, S, H, hk, dtype, hv)
            s0 = (torch.as_tensor(rng.standard_normal((B, H, hk, hv)), dtype=torch.float32,
                                  device="cuda") if carried else None)
            before = K7_LAUNCHES.count
            got = wkv(r, k, v, logw, u, chunk=chunk, s0=s0)
            launches = K7_LAUNCHES.count - before
            want = wkv_chunked(r, k, v, logw, u, s0, chunk=c)
            mags = wkv_chunked(r.abs(), k.abs(), v.abs(), logw, u.abs(),
                               None if s0 is None else s0.abs(), chunk=c)
            torch.cuda.synchronize()
            ok = launches == 1
            msg = []
            for name, x, y, m in zip(("o", "s_final"), got, want, mags):
                diff = (x - y).abs()
                allowed = K7_RTOL * y.abs() + K7_ATOL + units * eps * m
                ok &= bool((diff <= allowed).all())
                err = float(diff.max())
                used = float((diff / (eps * m).clamp_min(1e-30)).max())
                share = float((diff / allowed).max())
                worst[name] = max(worst[name], err)
                worst_units[name] = max(worst_units[name], used)
                if share > worst_share[0]:
                    worst_share = (share, f"{(B, H, hk, hv)} S={S} chunk={chunk} {kind} "
                                          f"s0={carried} {name}: {used:.2f} of {units} eps of M")
                if carried:
                    worst_s0[name] = max(worst_s0[name], err)
                msg.append(f"{name} max abs err {err} ({used:.1f} eps of M)")
            if not ok:
                raise AssertionError(f"K7 {(B, H, hk, hv)} S={S} chunk={chunk} {kind} "
                                     f"s0={carried}: "
                                     f"{launches} launches, {', '.join(msg)}, allowed "
                                     f"{units} eps of M")
            n_checks += 1
            n_s0 += carried
    report.emit({"phase": "k7_vs_plain", "checks": n_checks, "carried_state_checks": n_s0,
                 "tile": TILE, "max_abs_err": worst, "carried_state_max_abs_err": worst_s0,
                 "worst_eps_of_M": worst_units,
                 "worst_share_of_allowance": worst_share[0],
                 "worst_share_case": worst_share[1],
                 "rtol": K7_RTOL, "atol": K7_ATOL,
                 "allowed_eps_of_M": "4 (hk + chunk), chunk the reference's"})


def _lm_model(torch, arch, seed, **changes):
    """(model, params): the registry config at full width (``changes``
    applied), random weights from a seeded generator on the card, each
    layer stored in the compute dtype as soon as it is drawn
    (``init_params(store_dtype=)``: Nemotron-4-15B's 62.5 GB of f32
    weights never exist at once)."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(cfgbase.get_config(arch), **changes)
    model = Model(cfg, rwkv_chunk=64)
    params = model.init_params(torch.Generator("cuda").manual_seed(seed),
                               store_dtype=getattr(torch, cfg.compute_dtype))
    return model, params


def _prompt_lengths(np, fixed, drawn):
    n, lo, hi = drawn
    return list(fixed) + [int(x) for x in np.random.default_rng(0).integers(lo, hi, n)]


def _pct(np, xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def lm_state_bytes(cfg, lanes: int, max_seq: int) -> int:
    """The lanes' KV/state bytes from the config (bf16 compute): K/V and
    positions of each attention layer's cache (a ring of ``window`` slots
    or ``max_seq``), (s, tm_x, cm_x) of each RWKV layer, (h, conv) of each
    RG-LRU layer."""
    from repro_torch.models.attention import cache_spec

    total = 0
    for kind in cfg.blocks():
        if kind == "rwkv":
            H = cfg.d_model // cfg.rwkv_head_dim
            total += lanes * H * cfg.rwkv_head_dim ** 2 * 4 + 2 * lanes * cfg.d_model * 2
        elif kind == "rglru":
            rw = cfg.lru_width or cfg.d_model
            total += lanes * rw * 4 + lanes * (cfg.conv1d_width - 1) * rw * 2
        else:
            L = cache_spec(cfg, kind, max_seq).length
            total += 2 * lanes * L * cfg.num_kv_heads * cfg.head_dim * 2 + lanes * L * 4
    return total


def lm_engine_phase(torch, np, report) -> dict:
    """Serve each of ``LM_ENGINES`` at full width and depth through
    ``Engine``, one at a time; returns {arch: launch counts by key} for the
    kernels line."""
    from torch.autograd import DeviceType

    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Engine, Request, cache_bytes

    counters = _counters()
    out = {}
    for arch, (seed, lanes, max_seq, max_new, fixed, drawn, kern) in LM_ENGINES.items():
        model, params = _lm_model(torch, arch, seed)
        cfg = model.cfg
        lens = _prompt_lengths(np, fixed, drawn)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
        # warm-up outside the served run: cuBLAS handles, kernel libraries
        warm, _ = model.prefill(params, {"tokens": torch.as_tensor(prompts[1][None],
                                                                   device="cuda")}, max_seq)
        del warm
        tracer = Tracer()
        engine = Engine(model, params, lanes=lanes, max_seq=max_seq, device="cuda",
                        tracer=tracer)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        with tracer.span("serve"):
            stats = engine.run(reqs)
            torch.cuda.synchronize()
        counts = {k: (c.count, dict(c.by_key)) for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()

        # -- checks ------------------------------------------------------------
        if not all(r.done and len(r.out_tokens) == max_new for r in reqs):
            raise AssertionError(f"{arch}: not every request is done with {max_new} tokens")
        per_layer = {k: 0 for k in counters}
        kinds = ("rwkv",) if kern == "K7" else ("attn", "swa", "local")
        per_layer[kern] = sum(kind in kinds for kind in cfg.blocks())
        for k, (count, _) in counts.items():
            if count != per_layer[k] * stats.prefills:
                raise AssertionError(f"{arch}: {k} launched {count} times for "
                                     f"{stats.prefills} prefills (want "
                                     f"{per_layer[k] * stats.prefills})")
        plan = engine.plan_report()
        kv = plan["kv_state_bytes"]
        want = lm_state_bytes(cfg, lanes, max_seq)
        if not kv == want == cache_bytes(engine.cache) == LM_KV_BYTES[arch]:
            raise AssertionError(f"{arch}: kv_state_bytes {kv}, from the shapes {want}, "
                                 f"pinned {LM_KV_BYTES[arch]}")
        del engine
        # each prompt's last-token logits: kernel path against plain path.  The
        # kernel pass repeats the served prefills, under the profiler, for the
        # kernel's device time over the served run's prefills.
        max_abs, rel_rms = LM_LOGITS_TOL[arch]
        worst = {"max_abs": 0.0, "rel_rms": 0.0}
        toks = [{"tokens": torch.as_tensor(r.prompt[None], device="cuda")} for r in reqs]
        with profiler_ranges(torch):
            kernel_logits, averages = profiled(
                torch, lambda: model.prefill(params, toks[0], max_seq),
                lambda: [model.prefill(params, tok, max_seq)[1] for tok in toks])
        ranges = {label: range_device_ms(averages, label) for _, _, label in LM_RANGES}
        kern_events = [ev for ev in averages if ev.device_type == DeviceType.CUDA
                       and LM_KERNEL_SYMBOL[kern] in ev.key]
        kern_device_ms = sum(ev.self_device_time_total for ev in kern_events) / 1e3
        kern_records = sum(ev.count for ev in kern_events)
        for req, tok, lk in zip(reqs, toks, kernel_logits):
            before = {k: c.count for k, c in counters.items()}
            with plain_kernels():
                _, lp = model.prefill(params, tok, max_seq)
            if any(c.count != before[k] for k, c in counters.items()):
                raise AssertionError(f"{arch}: a kernel launched in the plain pass")
            err = float((lk - lp).abs().max())
            rel = float((lk - lp).norm() / lp.norm())
            if not (torch.isfinite(lk).all() and err <= max_abs and rel <= rel_rms
                    and int(lk[0].argmax()) == req.out_tokens[0]):
                raise AssertionError(f"{arch} prompt {len(req.prompt)}: logits vs plain "
                                     f"max abs err {err} (limit {max_abs}), relative "
                                     f"rms {rel} (limit {rel_rms}); first token "
                                     f"{int(lk[0].argmax())} vs served {req.out_tokens[0]}")
            worst = {"max_abs": max(worst["max_abs"], err),
                     "rel_rms": max(worst["rel_rms"], rel)}

        # -- numbers -------------------------------------------------------------
        serve_ts = tracer.spans("serve")[0][0]
        pre = tracer.spans("prefill")
        dec = tracer.spans("decode")
        ttft_ms = [(ts + dur - serve_ts) / 1e3 for ts, dur, _ in pre]
        prefill_s = sum(d for _, d, _ in pre) / 1e6
        decode_s = sum(d for _, d, _ in dec) / 1e6
        decode_tokens = sum(ev["args"]["active"] for _, _, ev in dec)
        report.emit({
            "phase": "lm_engine", "arch": arch, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "requests": len(reqs), "lanes": lanes,
            "max_seq": max_seq, "max_new": max_new, "prompt_lens": lens,
            "compute_dtype": cfg.compute_dtype, "rwkv_chunk": model.rwkv_chunk,
            "prefills": stats.prefills, "decode_steps": stats.decode_steps,
            "tokens_out": stats.tokens_out, "wall_s": stats.wall_s,
            "tokens_per_s": stats.tokens_per_s,
            **{f"{k.lower()}_launches": c for k, (c, _) in counts.items()},
            "plan_report": plan,
            f"{kern.lower()}_device_ms_served_prefills": kern_device_ms,
            f"{kern.lower()}_kernel_records_served_prefills": kern_records,
            **{f"{label}_served_prefills": r for label, r in ranges.items() if r},
            "logits_vs_plain": worst, "logits_limit": {"max_abs": max_abs,
                                                       "rel_rms": rel_rms},
            "ttft_ms_p50": _pct(np, ttft_ms, 50), "ttft_ms_p99": _pct(np, ttft_ms, 99),
            "prefill_tokens_per_s": sum(lens) / prefill_s,
            "decode_tokens_per_s": decode_tokens / decode_s,
            "decode_step_ms": 1e3 * decode_s / len(dec),
            "prefill_span_ms": [d / 1e3 for _, d, _ in pre],
            "decode_span_ms_p50": _pct(np, [d / 1e3 for _, d, _ in dec], 50),
            "decode_span_ms_p99": _pct(np, [d / 1e3 for _, d, _ in dec], 99),
            "max_memory_allocated": peak,
        })
        out[arch] = counts
        if cfg.frontend == "vision":
            vl_embeds_phase(torch, np, report, model, params, max_seq)
        del model, params
        torch.cuda.empty_cache()
    return out


def vl_embeds_phase(torch, np, report, model, params, max_seq) -> None:
    """Qwen2-VL-7B from patch embeddings, on the model ``lm_engine_phase``
    has just served: ``Model.prefill(batch={"embeds": e})`` on
    VL_EMBEDS_LANES rows of VL_EMBEDS_ROWS embeddings (N(0, 1/D), seeded),
    then VL_EMBEDS_STEPS greedy steps of ``make_decode_step`` on tokens,
    every launch counter set to 0 just before.  K5 runs once a layer in the
    prefill and never in a decode step, no other kernel runs; the prefill's
    logits, finite, are held against the plain path's on the same inputs
    within ``LM_LOGITS_TOL``.  Records TTFT (the prefill), ms a decode step
    (p50 / p99), tokens/s and peak memory."""
    from repro_torch.serve.step import make_decode_step

    counters = _counters()
    cfg = model.cfg
    B, S = VL_EMBEDS_LANES, VL_EMBEDS_ROWS
    gen = torch.Generator("cuda").manual_seed(60)
    embeds = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda") \
        / cfg.d_model ** 0.5
    decode = make_decode_step(model, max_seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    cache, logits = model.prefill(params, {"embeds": embeds}, max_seq)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    ttft_ms = 1e3 * (time.perf_counter() - t0)
    prefill_counts = {k: c.count for k, c in counters.items()}
    out, step_ms, step_counts = [tok], [], []
    for t in range(VL_EMBEDS_STEPS):
        before = {k: c.count for k, c in counters.items()}
        ts = time.perf_counter()
        tok, _, cache = decode(params, cache, tok, S + t)
        out.append(tok)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - ts))
        step_counts.append({k: c.count - before[k] for k, c in counters.items()})
    peak = torch.cuda.max_memory_allocated()
    seq = torch.cat(out, dim=1)
    del cache
    want = {k: 0 for k in counters}
    want["K5"] = sum(kind in ("attn", "swa", "local") for kind in cfg.blocks())
    if prefill_counts != want or any(any(c.values()) for c in step_counts):
        raise AssertionError(f"vl_embeds: launches {prefill_counts} in the prefill (want "
                             f"{want}), decode steps "
                             f"{[c for c in step_counts if any(c.values())][:2]} (want none)")
    if tuple(seq.shape) != (B, VL_EMBEDS_STEPS + 1) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"vl_embeds: tokens {tuple(seq.shape)}, logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    with plain_kernels():
        _, lp = model.prefill(params, {"embeds": embeds}, max_seq)
    err, rel = _diff(torch, logits, lp)
    max_abs, rel_rms = LM_LOGITS_TOL[cfg.name]
    report.emit({
        "phase": "vl_embeds", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype, "lanes": B,
        "embeds_rows": S, "max_seq": max_seq, "decode_steps": VL_EMBEDS_STEPS,
        "k5_launches_prefill": prefill_counts["K5"],
        "k5_launches_per_decode_step": max(c["K5"] for c in step_counts),
        "ttft_ms": ttft_ms, "prefill_tokens_per_s": B * S / (ttft_ms / 1e3),
        "decode_step_ms_p50": _pct(np, step_ms, 50),
        "decode_step_ms_p99": _pct(np, step_ms, 99),
        "decode_tokens_per_s": B * VL_EMBEDS_STEPS / (sum(step_ms) / 1e3),
        "max_memory_allocated": peak,
        "logits_vs_plain": {"max_abs": err, "rel": rel},
        "logits_tolerance": {"max_abs": max_abs, "rel": rel_rms},
    })
    if not (err <= max_abs and rel <= rel_rms):
        raise AssertionError(f"vl_embeds: prefill logits against the plain path max abs "
                             f"{err}, rel {rel} (allowed {max_abs}, {rel_rms})")


def encdec_phase(torch, np, report) -> dict:
    """Serve Seamless-M4T-large-v2 at full width and depth (24 encoder and
    24 decoder layers, bf16 compute) the way its encoder is driven: for each
    batch of ``ENCDEC_BATCHES``, ENCDEC_LANES utterances of one length,
    ``encode`` -> ``prefill(memory=)`` -> ENCDEC_STEPS greedy steps of
    ``make_decode_step`` with ``memory``, every launch counter set to 0
    just before.  K5 runs once a layer and stack in the encoder and the
    prefill (24 non-causal encoder, 24 causal decoder, 24 non-causal cross
    launches: 72 a batch) and never in a decode step, no other kernel runs;
    the prefill's logits, finite, are held against the plain path's on the
    same inputs within ``LM_LOGITS_TOL``.  Records encode, prefill and TTFT
    ms, decode ms a step (p50 / p99), tokens/s, peak memory and K5's device
    ms over encode and prefill.  Returns K5's launch counts by key over the served batches."""
    from torch.autograd import DeviceType

    from repro_torch.serve.step import make_decode_step

    counters = _counters()
    model, params = _lm_model(torch, "seamless-m4t-large-v2", 40)
    cfg = model.cfg
    decode = make_decode_step(model, ENCDEC_MAX_SEQ)
    max_abs, rel_rms = LM_LOGITS_TOL[cfg.name]
    k5_by_key = {}
    per_batch = {k: 0 for k in counters}
    per_batch["K5"] = cfg.encoder_layers + 2 * cfg.num_layers
    for bi, (T, S) in enumerate(ENCDEC_BATCHES):
        gen = torch.Generator("cuda").manual_seed(41 + bi)
        src = torch.randn((ENCDEC_LANES, T, cfg.d_model), generator=gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (ENCDEC_LANES, S), generator=gen,
                               device="cuda", dtype=torch.int32)

        def serve_prompt():
            memory = model.encode(params, src)
            return memory, *model.prefill(params, {"tokens": tokens}, ENCDEC_MAX_SEQ,
                                          memory=memory)

        serve_prompt()  # warm-up: cuBLAS handles, kernel libraries
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        memory = model.encode(params, src)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": tokens}, ENCDEC_MAX_SEQ,
                                      memory=memory)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prompt_counts = {k: c.count for k, c in counters.items()}
        for key, n in counters["K5"].by_key.items():
            k5_by_key[key] = k5_by_key.get(key, 0) + n
        out, step_ms, step_counts = [tok], [], []
        for t in range(ENCDEC_STEPS):
            before = {k: c.count for k, c in counters.items()}
            ts = time.perf_counter()
            tok, _, cache = decode(params, cache, tok, S + t, memory)
            out.append(tok)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - ts))
            step_counts.append({k: c.count - before[k] for k, c in counters.items()})
        peak = torch.cuda.max_memory_allocated()
        seq = torch.cat(out, dim=1)

        # -- checks ------------------------------------------------------------
        if prompt_counts != per_batch or any(any(c.values()) for c in step_counts):
            raise AssertionError(f"encdec T={T}: launches {prompt_counts} over encode and "
                                 f"prefill (want {per_batch}), decode steps "
                                 f"{[c for c in step_counts if any(c.values())][:2]} (want none)")
        if tuple(seq.shape) != (ENCDEC_LANES, ENCDEC_STEPS + 1) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"encdec T={T}: tokens {tuple(seq.shape)}, logits finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        with plain_kernels():
            _, _, lp = serve_prompt()
        err, rel = _diff(torch, logits, lp)
        kern = [ev for ev in profiled(torch, serve_prompt, serve_prompt)[1]
                if ev.device_type == DeviceType.CUDA and LM_KERNEL_SYMBOL["K5"] in ev.key]
        encode_ms, prefill_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1)
        decode_s = sum(step_ms) / 1e3
        report.emit({
            "phase": "encdec", "arch": cfg.name, "encoder_layers": cfg.encoder_layers,
            "decoder_layers": cfg.num_layers, "d_model": cfg.d_model,
            "compute_dtype": cfg.compute_dtype, "lanes": ENCDEC_LANES, "frames": T,
            "prompt": S, "decode_steps": ENCDEC_STEPS,
            "tokens_per_lane": ENCDEC_STEPS, "k5_launches_encode_prefill": prompt_counts["K5"],
            "k5_launches_per_decode_step": max(c["K5"] for c in step_counts),
            "encode_ms": encode_ms, "prefill_ms": prefill_ms,
            "ttft_ms": encode_ms + prefill_ms,
            "decode_step_ms_p50": _pct(np, step_ms, 50),
            "decode_step_ms_p99": _pct(np, step_ms, 99),
            "decode_tokens_per_s": ENCDEC_LANES * ENCDEC_STEPS / decode_s,
            "tokens_per_s": ENCDEC_LANES * (ENCDEC_STEPS + 1) / (t2 - t0 + decode_s),
            "max_memory_allocated": peak,
            "k5_device_ms_encode_prefill": sum(ev.self_device_time_total for ev in kern) / 1e3,
            "k5_kernel_records": sum(ev.count for ev in kern),
            "logits_vs_plain": {"max_abs": err, "rel": rel},
            "logits_tolerance": {"max_abs": max_abs, "rel": rel_rms},
        })
        if not (err <= max_abs and rel <= rel_rms):
            raise AssertionError(f"encdec T={T}: prefill logits against the plain path max abs "
                                 f"{err}, rel {rel} (allowed {max_abs}, {rel_rms})")
        del cache, memory
    del model, params
    torch.cuda.empty_cache()
    return k5_by_key


def kv_int8_phase(torch, np, report) -> None:
    """Llama-3.2-1B at full size served through ``Engine`` with
    ``kv_dtype="int8"`` and with the bf16 cache, on one set of 8 prompts, 8
    lanes, ``max_seq`` 1,024 (LM_ENGINES' Llama traffic cut to 8 requests
    and 16 new tokens): state bytes pinned (KV_INT8_BYTES, LM_KV_BYTES).
    Before, on the first 8 prompts cut to 128 tokens as one batch, the two
    caches' prefill logits and first decode step's logits held at
    tests/test_kv_quant.py's tolerances, argmax agreeing on at least half
    the rows.  Records ms a decode step both ways and how many served tokens
    agree."""
    from repro_torch.models.transformer import Model
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Engine, Request, cache_bytes

    arch = "llama3.2-1b"
    seed, _, max_seq, _, fixed, drawn, _ = LM_ENGINES[arch]
    lanes, max_new = 8, 16
    model_fp, params = _lm_model(torch, arch, seed)
    model_q = Model(model_fp.cfg, kv_dtype="int8", rwkv_chunk=model_fp.rwkv_chunk)
    cfg = model_fp.cfg
    lens = _prompt_lengths(np, fixed, drawn)[:lanes]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size, (lanes, 128)), dtype=torch.int32,
                            device="cuda")
    logits, caches = {}, {}
    for name, m in (("int8", model_q), ("compute", model_fp)):
        caches[name], logits[name] = m.prefill(params, {"tokens": batch}, max_seq)
    nxt = torch.argmax(logits["compute"], -1)[:, None].to(torch.int32)
    dec = {name: m.decode_step(params, caches[name], nxt, 128, max_seq)[0]
           for name, m in (("int8", model_q), ("compute", model_fp))}
    checks = {}
    for what, got, want, (rtol, atol) in (
            ("prefill", logits["int8"], logits["compute"], KV_INT8_PREFILL_TOL),
            ("decode", dec["int8"], dec["compute"], KV_INT8_DECODE_TOL)):
        ok, err = _close(torch, got, want, rtol, atol)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if not ok or agree < KV_INT8_ARGMAX_AGREE:
            raise AssertionError(f"kv_int8 {what}: logits max abs err {err} against the "
                                 f"bf16 cache (rtol {rtol}, atol {atol}), argmax agreeing "
                                 f"on {agree} of the rows")
        checks[what] = {"max_abs_err": err, "argmax_agree": agree, "rtol": rtol, "atol": atol}
    del caches, logits, dec
    served = {}
    for name, m in (("int8", model_q), ("compute", model_fp)):
        tracer = Tracer()
        engine = Engine(m, params, lanes=lanes, max_seq=max_seq, device="cuda", tracer=tracer)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
        stats = engine.run(reqs)
        torch.cuda.synchronize()
        kv = engine.plan_report()["kv_state_bytes"]
        want = KV_INT8_BYTES if name == "int8" else LM_KV_BYTES[arch]
        if not (kv == cache_bytes(engine.cache) == want
                and all(r.done and len(r.out_tokens) == max_new for r in reqs)):
            raise AssertionError(f"kv_int8 {name}: kv_state_bytes {kv}, pinned {want}; "
                                 f"every request done: {all(r.done for r in reqs)}")
        dec_ms = [d / 1e3 for _, d, _ in tracer.spans("decode")]
        served[name] = {"kv_state_bytes": kv, "decode_steps": stats.decode_steps,
                        "decode_step_ms_p50": _pct(np, dec_ms, 50),
                        "decode_step_ms_p99": _pct(np, dec_ms, 99),
                        "tokens": [r.out_tokens for r in reqs]}
        del engine
    tokens = [served[n].pop("tokens") for n in ("int8", "compute")]
    same = sum(a == b for ta, tb in zip(*tokens) for a, b in zip(ta, tb))
    report.emit({"phase": "kv_int8", "arch": arch, "lanes": lanes, "max_seq": max_seq,
                 "max_new": max_new, "prompt_lens": lens, "compute_dtype": cfg.compute_dtype,
                 "first_batch": checks, "served": served,
                 "served_tokens_equal": f"{same}/{sum(len(t) for t in tokens[0])}",
                 "bytes_ratio": served["int8"]["kv_state_bytes"]
                 / served["compute"]["kv_state_bytes"]})
    del model_fp, model_q, params
    torch.cuda.empty_cache()


def lm_strict_phase(torch, np, report) -> None:
    """Each architecture at full width, 2 layers (RecurrentGemma 3; Seamless
    2 encoder and 2 decoder layers over LM_STRICT_SRC frames), f32 compute,
    TF32 off: the kernel path against the plain path on the card, prefill
    logits (and Seamless's encoder memory) and 4 teacher-forced decode
    steps, at LM_STRICT_TOL.  Seamless's training loss (K5 forward in both
    stacks, K6, the plain VJPs) and every gradient leaf too, at the
    train_strict limits."""
    from repro_torch.train.step import value_and_grad

    for arch, seed, S, layers in LM_STRICT:
        changes = {"num_layers": layers, "compute_dtype": "float32"}
        if arch == "seamless-m4t-large-v2":
            changes["encoder_layers"] = layers
        model, params = _lm_model(torch, arch, seed, **changes)
        cfg = model.cfg
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, S + 4).astype(np.int32)
        batch = {"tokens": torch.as_tensor(toks[None, :S], device="cuda")}
        out = {}
        if cfg.is_encdec:
            batch["src_embeds"] = torch.as_tensor(
                rng.standard_normal((1, LM_STRICT_SRC, cfg.d_model)), dtype=torch.float32,
                device="cuda")
        for side in ("kernel", "plain"):
            with plain_kernels() if side == "plain" else contextlib.nullcontext():
                memory = model.encode(params, batch["src_embeds"]) if cfg.is_encdec else None
                cache, logits = model.prefill(params, batch, 512, memory=memory)
                steps = []
                for t in range(4):
                    tok = torch.as_tensor(toks[None, S + t: S + t + 1], device="cuda")
                    lt, cache = model.decode_step(params, cache, tok, S + t, 512, memory=memory)
                    steps.append(lt)
            out[side] = (memory, logits, steps)
            del cache
        (mk, lk, dk), (mp, lp, dp) = out["kernel"], out["plain"]
        errs = [_close(torch, lk, lp, LM_STRICT_TOL, LM_STRICT_TOL)]
        errs += [_close(torch, a, b, LM_STRICT_TOL, LM_STRICT_TOL) for a, b in zip(dk, dp)]
        if cfg.is_encdec:
            errs.append(_close(torch, mk, mp, LM_STRICT_TOL, LM_STRICT_TOL))
        torch.cuda.synchronize()
        if not all(ok for ok, _ in errs):
            raise AssertionError(f"{arch} strict: max abs errs {[e for _, e in errs]}")
        line = {"phase": "lm_strict", "arch": arch, "layers": layers, "prompt": S,
                "compute_dtype": "float32", "tf32": False,
                "max_abs_err": {"prefill": errs[0][1],
                                "decode": [e for _, e in errs[1:5]]},
                "tolerance": LM_STRICT_TOL}
        if cfg.is_encdec:
            line["encoder_layers"] = layers
            line["source_frames"] = LM_STRICT_SRC
            line["max_abs_err"]["memory"] = errs[5][1]
            del out
            tb = {"src_embeds": torch.as_tensor(
                      rng.standard_normal((2, LM_STRICT_SRC, cfg.d_model)),
                      dtype=torch.float32, device="cuda"),
                  **{k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)),
                                        dtype=torch.int32, device="cuda")
                     for k in ("tokens", "targets")}}
            counters = _counters()
            before = {k: c.count for k, c in counters.items()}
            loss_k, _, gk = value_and_grad(model, params, tb)
            launches = {k: c.count - before[k] for k, c in counters.items()}
            with plain_kernels():
                loss_p, _, gp = value_and_grad(model, params, tb)
            loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
            worst, bad = _grads_close(torch, gk, gp)
            # remat: each stack's K5 forward runs twice; K6 once
            want = {k: 0 for k in counters}
            want.update(K5=2 * (cfg.encoder_layers + 2 * cfg.num_layers), K6=1)
            if bad or loss_rel > STRICT_LOSS_RTOL or launches != want:
                raise AssertionError(f"{arch} strict train: loss rel {loss_rel}, launches "
                                     f"{launches} (want {want}), leaves off {bad[:5]}")
            line["train"] = {"batch": 2, "seq": 64, "loss": float(loss_k),
                             "loss_rel_err": loss_rel, "worst_leaf_err_of_max": worst,
                             "launches": launches,
                             "limits": {"loss_rtol": STRICT_LOSS_RTOL,
                                        "grad_rtol": STRICT_GRAD_RTOL,
                                        "grad_atol": f"{STRICT_GRAD_RTOL} x max |leaf|"}}
            del gk, gp
        report.emit(line)
        del model, params
        torch.cuda.empty_cache()


def _diff(torch, a, b):
    """(max |a - b|, |a - b| / |b| in the 2-norm), in f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()), float((a - b).norm() / b.norm().clamp_min(1e-30))


def _rwkv_drift_walk(torch, model, params, tokens):
    """``Model.prefill``'s layer walk over an RWKV stack, run twice side by
    side: the kernel path (K7) and the plain path (``plain_kernels``).  At
    each layer it compares the two time-mix outputs (the drift carried so
    far) and K7 against the plain scan on the plain path's own input (this
    layer's share).  Returns ({"stream": [...], "local": [...]} per layer
    as (max |Δ|, relative 2-norm), the kernel path's logits, the plain
    path's)."""
    from repro_torch.models import rwkv6
    from repro_torch.models.common import apply_norm

    cfg = model.cfg
    xk = xp = model._embed(params, tokens)
    stream, local = [], []
    for p in params["layers"]:
        hk_, hp = apply_norm(cfg, p["norm1"], xk), apply_norm(cfg, p["norm1"], xp)
        ak, _, _ = rwkv6.time_mix(cfg, p["tm"], hk_, None, None, chunk=model.rwkv_chunk)
        al, _, _ = rwkv6.time_mix(cfg, p["tm"], hp, None, None, chunk=model.rwkv_chunk)
        with plain_kernels():
            ap, _, _ = rwkv6.time_mix(cfg, p["tm"], hp, None, None, chunk=model.rwkv_chunk)
        stream.append(_diff(torch, ak, ap))
        local.append(_diff(torch, al, ap))
        xk, xp = xk + ak, xp + ap
        xk = xk + rwkv6.channel_mix(cfg, p["tm"], apply_norm(cfg, p["norm2"], xk))[0]
        xp = xp + rwkv6.channel_mix(cfg, p["tm"], apply_norm(cfg, p["norm2"], xp))[0]
    logits = [model._logits_last(params, apply_norm(cfg, params["final_norm"], x)[:, -1])
              for x in (xk, xp)]
    return {"stream": stream, "local": local}, logits[0], logits[1]


def rwkv_drift_phase(torch, np, report) -> None:
    """RWKV6-7B at full size (32 layers), the served model's weights (seed
    1), kernel path against plain path on one prompt of 200 tokens and one
    of 509 (chunks of 8 and of 1), first at f32 compute with TF32 off, then
    with the same weights stored in bf16, the served dtype: the time-mix
    output's drift at every layer and K7's own share of it, and the final
    logits.  At f32 the logits are held at ``RWKV_F32_DRIFT_TOL`` and every
    layer's K7 share at ``RWKV_F32_K7_SHARE``; at either dtype the kernel
    walk's logits must equal ``Model.prefill``'s."""
    import dataclasses

    from repro_torch.models.transformer import Model, store_compute_dtype

    model, params = _lm_model(torch, "rwkv6-7b", LM_ENGINES["rwkv6-7b"][0],
                              compute_dtype="float32")
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, model.cfg.vocab_size, S).astype(np.int32)
               for S in RWKV_DRIFT_PROMPTS]
    failed = []
    for dtype in ("float32", "bfloat16"):
        if dtype != model.cfg.compute_dtype:
            model = Model(dataclasses.replace(model.cfg, compute_dtype=dtype),
                          rwkv_chunk=model.rwkv_chunk)
            store_compute_dtype(params, getattr(torch, dtype))
        for toks in prompts:
            batch = torch.as_tensor(toks[None], device="cuda")
            layers, lk, lp = _rwkv_drift_walk(torch, model, params, batch)
            _, served = model.prefill(params, {"tokens": batch}, 1024)
            torch.cuda.synchronize()
            walk_vs_prefill = float((served - lk).abs().max())
            err, rel = _diff(torch, lk, lp)
            ok = bool(torch.isfinite(lk).all()) and walk_vs_prefill == 0.0
            share = max(x[1] for x in layers["local"])
            if dtype == "float32":
                ok &= (err <= RWKV_F32_DRIFT_TOL[0] and rel <= RWKV_F32_DRIFT_TOL[1]
                       and share <= RWKV_F32_K7_SHARE)
            if not ok:
                failed.append(f"{dtype} S={len(toks)}: logits max abs {err}, rel {rel} "
                              f"(f32 limit {RWKV_F32_DRIFT_TOL}), K7's largest share "
                              f"{share} (f32 limit {RWKV_F32_K7_SHARE}); walk vs "
                              f"prefill {walk_vs_prefill}")
            report.emit({"phase": "rwkv_drift", "arch": "rwkv6-7b",
                         "layers": model.cfg.num_layers, "compute_dtype": dtype,
                         "tf32": torch.backends.cuda.matmul.allow_tf32,
                         "prompt": len(toks), "chunk": _chunk_for(len(toks)),
                         "logits": {"max_abs": err, "rel": rel},
                         "walk_vs_prefill_max_abs": walk_vs_prefill,
                         "time_mix_stream": layers["stream"],
                         "time_mix_k7_share": layers["local"],
                         "f32_limit": {"logits": RWKV_F32_DRIFT_TOL,
                                       "k7_share": RWKV_F32_K7_SHARE}})
    del model, params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"rwkv drift: {'; '.join(failed)}")


def _chunk_for(S):
    from repro_torch.kernels.wkv.ops import chunk_for

    return chunk_for(S, 64)


def k5_bound(B, S, H, K, h, elem=2, causal=True, T=None):
    """(ms, by): q and o (B, S, H, h), k and v (B, T, K, h) moved once; 2
    products of 2 h flops per visible (query, key) pair: S (S + 1) / 2 of
    them under the causal mask (T = S), S T without it."""
    T = S if T is None else T
    nbytes = (2 * B * S * H * h + 2 * B * T * K * h) * elem
    pairs = S * (S + 1) // 2 if causal else S * T
    return _roofline(nbytes, 4 * h * B * H * pairs)


def k7_ops(S, h, tile):
    """Operations of the tiled scan at one head and tile (the last tile
    ragged): the pair term's 2 flops and one exp per (t > s, channel), the
    history read, the pair times v, the bonus and the state update (2 flops
    a multiply-add)."""
    ops = 0
    for c0 in range(0, S, tile):
        L = min(tile, S - c0)
        ops += (3 * L * (L - 1) // 2 * h      # pair: r*k, *exp, +
                + 2 * L * h * h               # history
                + L * (L - 1) * h             # pair times v
                + 5 * L * h                   # bonus
                + 2 * L * h * h + 2 * h * h)  # state update
    return ops


def k7_bound(B, S, H, h, elem=2):
    """(ms, by): r/k/v (``elem`` bytes), logw, u, o and s_final (f32) once;
    the function's least work, the fewest ``k7_ops`` over tiles of 1 to 64
    (the pair term grows with the tile, the state updates shrink with it),
    f32 on the CUDA cores, so at their peak."""
    nbytes = 3 * B * S * H * h * elem + 2 * B * S * H * h * 4 + H * h * 4 + B * H * h * h * 4
    ops = min(k7_ops(S, h, tile) for tile in range(1, min(S, 64) + 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, B * H * ops / PEAK_OPS_PER_S["f32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def lm_timing_phase(torch, np, report, lm_counts, train_counts, encdec_k5) -> list:
    """K5 and K7 at the served shapes (bf16, B=1, S 128 / 512 / 1000; K5
    also at RecurrentGemma-9B's, Qwen2-MoE's, Llama-3-8B's and
    Nemotron-4-15B's, S 509, and at Seamless-M4T's batch of 4 at 1,000
    frames: the encoder's and the cross-attention's, without the mask, and
    the decoder's), and K5 at Llama's train shape (B 8, S 512): event ms,
    device ms, plain ms, the library yardstick for K5 (SDPA, causal or
    not as K5), the bound.  ``encdec_k5``: K5's launches by key in the
    served enc-dec batches."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref

    entries = []
    rng = np.random.default_rng(11)
    k7_launches = lm_counts["rwkv6-7b"]["K7"][0]
    # (name, arch, B, S, T, H, K, h, causal, launches): Llama's served and
    # train shapes, the other families' served shapes at their longest
    # prompt (RecurrentGemma's window of 2048 is past S, so causal attention
    # is its function here), and Seamless's three modes at 1,000 frames
    cases = [("train" if B > 1 else "prefill", "llama3.2-1b", B, S, S, 32, 8, 64, True,
              train_counts["llama3.2-1b"]["K5"] if B > 1 else lm_counts["llama3.2-1b"]["K5"][0])
             for B, S in ((1, 128), (1, 512), (1, 1000), (8, 512))]
    cases += [("prefill", arch, 1, 509, 509, H, K, h, True, lm_counts[arch]["K5"][0])
              for arch, H, K, h in (("recurrentgemma-9b", 16, 1, 256),
                                    ("qwen2-moe-a2.7b", 16, 16, 128),
                                    ("llama3-8b", 32, 8, 128),
                                    ("nemotron-4-15b", 48, 8, 128),
                                    ("qwen2-vl-7b", 28, 4, 128))]
    # the train shapes of RecurrentGemma, Qwen2-MoE and Qwen2-VL (B 4 x S 512;
    # RecurrentGemma's window of 2048 is past S)
    cases += [("train", arch, 4, 512, 512, H, K, h, True, train_counts[arch]["K5"])
              for arch, H, K, h in (("recurrentgemma-9b", 16, 1, 256),
                                    ("qwen2-moe-a2.7b", 16, 16, 128),
                                    ("qwen2-vl-7b", 28, 4, 128))]
    T, S = ENCDEC_BATCHES[-1]
    cases += [(mode, "seamless-m4t-large-v2", ENCDEC_LANES, sq, tk, 16, 16, 64, causal,
               sum(n for key, n in encdec_k5.items() if key[1:8] == (ENCDEC_LANES, sq, tk, 16,
                                                                     16, 64, causal)))
              for mode, sq, tk, causal in (("encoder", T, T, False), ("cross", S, T, False),
                                           ("decoder", S, S, True))]
    for mode, arch, B, S, T, H, K, h, causal, launches in cases:
        q = torch.as_tensor(rng.standard_normal((B, S, H, h)), dtype=torch.bfloat16,
                            device="cuda")
        k, v = (torch.as_tensor(rng.standard_normal((B, T, K, h)), dtype=torch.bfloat16,
                                device="cuda") for _ in range(2))
        kern = lambda: flash_attention(q, k, v, causal=causal)
        plain = lambda: attention_ref(q, k, v, causal=causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                         enable_gqa=True)
        err = float((kern().float() - plain().float()).abs().max())
        t = _times(torch, kern, plain, library)
        bms, bby = k5_bound(B, S, H, K, h, causal=causal, T=T)
        report.emit({"phase": "timing", "kernel": "K5", "arch": arch, "mode": mode,
                     "shape": f"B={B} S={S} T={T} H={H} K={K} h={h} causal={causal} bf16",
                     "launches": launches, "max_abs_err": err, "bound_ms": bms,
                     "bound_by": bby,
                     "library": f"F.scaled_dot_product_attention(is_causal={causal}, "
                                f"enable_gqa), bf16",
                     **t})
        entries.append({
            "name": (f"K5 flash_fwd_bf16 [{arch} train attention, B={B} S={S}, "
                     f"H={H} K={K} h={h}]"
                     if mode == "train" else
                     f"K5 flash_fwd_bf16 [{arch} prefill attention, S={S}, H={H} K={K} h={h}]"
                     if mode == "prefill" else
                     f"K5 flash_fwd_bf16 [{arch} {mode} attention, B={B} S={S} T={T}, "
                     f"{'causal' if causal else 'no mask'}]"),
            "route": "cuda", "source": "src/repro_torch/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash/kernel.py:28",
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bms, "bound_by": bby,
            "library_ms": t["library_ms"], "device_ms": t["device_ms"]})
    return entries + k7_timing_phase(torch, np, report, rng, k7_launches)


def k7_timing_phase(torch, np, report, rng, k7_launches) -> list:
    """K7 at the served shapes (bf16, B=1, ``K7_TIMING_SEQS``), each kernel
    of the call by name."""
    from repro_torch.kernels.wkv import kernel as wkv_kernel
    from repro_torch.kernels.wkv.ops import chunk_for, wkv
    from repro_torch.kernels.wkv.ref import wkv_chunked

    entries = []
    for S in K7_TIMING_SEQS:
        r, k, v, logw, u = _wkv_inputs(torch, np, rng, 1, S, 64, 64, torch.bfloat16)
        c = chunk_for(S, 64)
        kern = lambda: wkv(r, k, v, logw, u, chunk=64)
        plain = lambda: wkv_chunked(r, k, v, logw, u, chunk=c)
        err = float((kern()[0] - plain()[0]).abs().max())
        t = _times(torch, kern, plain, None)
        bms, bby = k7_bound(1, S, 64, 64)
        report.emit({"phase": "timing", "kernel": "K7", "kernels": K7_KERNELS,
                     "shape": f"B=1 S={S} H=64 h=64 chunk={c} tile={wkv_kernel.TILE} bf16",
                     "max_abs_err": err, "bound_ms": bms, "bound_by": bby,
                     "library": "no library call", **t,
                     "device_ms_by_kernel": device_ms_by_kernel(torch, kern)})
        entries.append({
            "name": (f"K7 wkv_fwd_bf16 ({' + '.join(K7_KERNELS)}) [rwkv6-7b prefill "
                     f"time-mix, S={S}, chunk={c}, tile={wkv_kernel.TILE}]"),
            "route": "cuda", "source": "src/repro_torch/csrc/wkv_fwd.cu",
            "replaces": "src/repro/kernels/wkv/kernel.py:19", "launches": k7_launches,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bms, "bound_by": bby, "library_ms": None,
            "device_ms": t["device_ms"]})
    return entries


def _times(torch, kern, plain, library):
    """CUDA-event ms and profiler device ms of a kernel, its plain version
    and (when there is one) a library call."""
    t = {"ms": event_ms(torch, kern, iters=50, warmup=5),
         "plain_ms": event_ms(torch, plain, iters=5, warmup=1),
         "device_ms": device_ms(torch, kern, iters=20),
         "plain_device_ms": device_ms(torch, plain, iters=3)}
    if library is not None:
        t["library_ms"] = event_ms(torch, library, iters=50, warmup=5)
        t["library_device_ms"] = device_ms(torch, library, iters=20)
    else:
        t["library_ms"] = t["library_device_ms"] = None
    return t


# ---------------------------------------------------------------------------
# The LM training path: K6 (fused LM-head cross-entropy) on every loss, K5
# and K7 inside their autograd Functions
# ---------------------------------------------------------------------------
PEAK_F32_OPS_PER_S = PEAK_OPS_PER_S["f32"]
# K6 against its plain version, (N, D, V, softcap, w std): the two train
# shapes (w ~ N(0, 1/D), so logits ~ N(0, 1) as from the models' init), an
# odd N with a vocab tail, with and without a softcap that bites (w std 1:
# logits ~ N(0, 64)), and a tiny odd vocab; x ~ N(0, 1).
K6_CASES = [
    (4096, 2048, 128256, 0.0, None),
    (2048, 4096, 65536, 0.0, None),
    # the train shapes of RecurrentGemma-9B (tied, V 256,000), Qwen2-MoE and
    # Qwen2-VL (B 4 x S 512 tokens each)
    (2048, 4096, 256000, 0.0, None),
    (2048, 2048, 151936, 0.0, None),
    (2048, 3584, 152064, 0.0, None),
    (129, 64, 1000, 0.0, 0.1),
    (129, 64, 1000, 30.0, 1.0),
    (32, 16, 37, 0.0, 0.1),
]
# Per token: |K6 - plain| <= K6_RTOL |plain| + K6_ATOL + K6_EPS_UNITS eps M,
# M = |x_n| max_v |w_v| (Cauchy-Schwarz bound on a logit's magnitude sum
# sum_d |x_nd w_vd|).  1e-5 / 1e-5 is tests/test_kernel_xent.py's at
# D <= 64; the eps M term is the rounding of f32 dot products summed in
# two orders: an f32 dot's rounding error is ~u M with random-walk partial
# sums (u = eps / 2), so two evaluations, the target logit and the
# logsumexp stay within a few eps M (a CPU emulation of an FFMA kernel's
# sequential order at D = 2,048 differed from torch's by 0.51 eps M at
# most); 8 gives headroom.  K6's 3xTF32 route adds the TF32 split's
# rounding (under 2^-21 of each product, dropped x_lo w_lo included): its
# CPU model, scripts/k6_3xtf32_emulation.py, stays within 2.31 eps M on
# these cases, leaving the rest for the card's accumulation order.  A
# dropped vocab tile (Δ ~ 128 / V = 1e-3 at Llama's V) or a wrong target
# (Δ ~ 1) exceeds it.
K6_RTOL, K6_ATOL, K6_EPS_UNITS = 1e-5, 1e-5, 8
# The Functions' gradients against autograd through the plain version: the
# backward IS that plain VJP on the same inputs, so they agree up to f32
# re-association of the per-chunk sums of dw (xent).
GRAD_RTOL = GRAD_ATOL = 1e-5
# lm_train: step 1's loss and global grad norm, kernel path against plain
# path, bf16 compute, full depth.  The paths differ only in K5's and K6's
# f32 sums (and K5's output rounded to bf16 after them); served Llama
# logits differ by 0.012 in the relative 2-norm at full depth (PERF.md), the
# mean CE over 4,096 tokens much less, and the gradients flow through the
# same plain VJPs.
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-2, 5e-2
# train_strict (f32 compute, 2 layers): losses at 1e-5 relative; each
# gradient leaf within rtol 1e-3 and 1e-3 of the leaf's largest |value|.
STRICT_LOSS_RTOL, STRICT_GRAD_RTOL = 1e-5, 1e-3
# arch: (seed, layers (None: all), batch, seq, timed steps, a microbatches=2
# step, launches per step).  K5: 16 forward + 16 in remat's recompute; K6
# once per loss (2 with 2 microbatches; its backward is plain); K7: 2
# forward + 2 recompute.  RecurrentGemma, Qwen2-MoE and Qwen2-VL cut depth,
# never width (AdamW's 16 B a parameter at full depth is over 80 GB):
# RecurrentGemma-9B one (rglru, rglru, local) group, so K5 runs on its
# local layer (1 + 1); Qwen2-MoE-A2.7B and Qwen2-VL-7B 2 attention layers
# (2 + 2); Qwen2-VL trains on the launcher's embeds batch, and its
# microbatches=2 step splits a batch without tokens.
TRAIN_RUNS = {
    "llama3.2-1b": (20, None, 8, 512, 4, True, {"K5": 32, "K6": 1}),
    "rwkv6-7b": (21, 2, 4, 512, 2, False, {"K7": 4, "K6": 1}),
    "recurrentgemma-9b": (22, 3, 4, 512, 2, False, {"K5": 2, "K6": 1}),
    "qwen2-moe-a2.7b": (23, 2, 4, 512, 2, False, {"K5": 4, "K6": 1}),
    "qwen2-vl-7b": (24, 2, 4, 512, 2, True, {"K5": 4, "K6": 1}),
}
# train_strict: (arch, seed, layers) at f32 compute
TRAIN_STRICT = (("llama3.2-1b", 30, 2), ("rwkv6-7b", 31, 2), ("recurrentgemma-9b", 32, 3),
                ("qwen2-moe-a2.7b", 33, 2), ("qwen2-vl-7b", 34, 2))
# remat_dots: Llama-3.2-1B's train cell, one step's loss and gradients under
# each policy from the same params and batch: losses within
# REMAT_DOTS_LOSS_RTOL (the same forward: "dots" keeps the matmul outputs
# that "block" computes again in the backward)
REMAT_DOTS_LOSS_RTOL = 1e-6


def _xent_inputs(torch, np, rng, N, D, V, w_std):
    """x ~ N(0, 1) (N, D), w (V, D) of std ``w_std`` (1/sqrt(D) if None),
    f32 on the card, and int32 targets with 0, V - 1 and an id inside the
    last (partial) vocab tile among them."""
    x = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32, device="cuda")
    w = torch.as_tensor(rng.standard_normal((V, D)) * (w_std or D ** -0.5),
                        dtype=torch.float32, device="cuda")
    t = rng.integers(0, V, N).astype(np.int32)
    last_tile = (V - 1) // 128 * 128
    t[:3] = [0, V - 1, last_tile + (V - 1 - last_tile) // 2]
    return x, w, torch.as_tensor(t, device="cuda")


def k6_checks(torch, np, report) -> None:
    """K6 against its plain version (``seq_chunked_xent``) on K6_CASES, at the
    automatic split count and (small cases) at one split, per token within
    K6_RTOL |plain| + K6_ATOL + K6_EPS_UNITS eps M."""
    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent.kernel import K6_LAUNCHES, fused_xent_fwd, split_count

    eps = torch.finfo(torch.float32).eps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for ci, (N, D, V, cap, w_std) in enumerate(K6_CASES):
        rng = np.random.default_rng(6000 + ci)
        x, w, t = _xent_inputs(torch, np, rng, N, D, V, w_std)
        with torch.no_grad():
            want = xent_ref.seq_chunked_xent(x[None], w, t[None], softcap=cap)[0]
        M = x.norm(dim=1) * w.norm(dim=1).max()
        allowed = K6_RTOL * want.abs() + K6_ATOL + K6_EPS_UNITS * eps * M
        auto = split_count(N, V, sms)
        for splits in ((auto,) if N > 1024 else (auto, 1)):
            before = K6_LAUNCHES.count
            got = fused_xent_fwd(x, w, t, softcap=cap, splits=splits)
            launches = K6_LAUNCHES.count - before
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = float(diff.max())
            units = float((diff / (eps * M)).max())
            if launches != 1 or not bool((diff <= allowed).all()):
                raise AssertionError(f"K6 {(N, D, V, cap)} splits={splits}: {launches} "
                                     f"launches, max abs err {err} ({units:.2f} eps M), "
                                     f"allowed {float(allowed.min())} at least")
            rows.append({"N": N, "D": D, "V": V, "softcap": cap, "splits": splits,
                         "max_abs_err": err, "eps_of_M": units,
                         "ce_mean": float(want.mean())})
        del x, w, t, want
    report.emit({"phase": "k6_vs_plain", "route": K6_ROUTE, "checks": len(rows),
                 "worst_eps_of_M": max(r["eps_of_M"] for r in rows), "cases": rows,
                 "rtol": K6_RTOL, "atol": K6_ATOL, "allowed_eps_of_M": K6_EPS_UNITS,
                 "bounds_ms": {f"N={N} D={D} V={V}": {
                     "route": k6_bound(N, D, V)[0],
                     "f32_cuda_core": k6_f32_bound_ms(N, D, V)}
                     for N, D, V in K6_TRAIN_SHAPES.values()}})


def grad_checks(torch, np, report) -> None:
    """Each Function (K5, K6, K7 forward; the plain VJP backward) on small
    f32 inputs on the card: a ``grad_fn`` on its output, one launch, and the
    gradients of a random linear functional of its output equal to autograd
    through the plain version, at GRAD_RTOL / GRAD_ATOL."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.kernels.wkv.ref import wkv_chunked
    from repro_torch.kernels.xent import ops as xent_ops
    from repro_torch.kernels.xent import ref as xent_ref

    counters = _counters()
    rng = np.random.default_rng(8000)

    def leaf(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device="cuda").requires_grad_(True)

    def compare(name, kern, plain, inputs, counter, fn_name):
        outs_k = kern(*inputs)
        outs_k = outs_k if isinstance(outs_k, tuple) else (outs_k,)
        weights = [torch.as_tensor(rng.standard_normal(tuple(o.shape)), dtype=torch.float32,
                                   device="cuda") for o in outs_k]
        before = counters[counter].count
        outs_k = kern(*inputs)
        launches = counters[counter].count - before
        outs_k = outs_k if isinstance(outs_k, tuple) else (outs_k,)
        grad_fn = type(outs_k[0].grad_fn).__name__ if outs_k[0].grad_fn is not None else None
        gk = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs_k, weights)), inputs)
        outs_p = plain(*inputs)
        outs_p = outs_p if isinstance(outs_p, tuple) else (outs_p,)
        gp = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs_p, weights)), inputs)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(gk, gp)]
        ok = all(torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL) for a, b in zip(gk, gp))
        if launches != 1 or grad_fn is None or fn_name not in grad_fn or not ok:
            raise AssertionError(f"{name}: {launches} launches, grad_fn {grad_fn}, "
                                 f"gradient max abs errs {errs}")
        return {"name": name, "grad_fn": grad_fn, "grad_max_abs_err": errs}

    rows = []
    q, k, v = leaf((1, 129, 4, 64)), leaf((1, 129, 2, 64)), leaf((1, 129, 2, 64))
    for window, cap in ((0, 0.0), (32, 20.0)):
        geom = dict(causal=True, window=window, scale=0.125, softcap=cap)
        rows.append(compare(f"K5 window={window} softcap={cap}",
                            lambda q, k, v: flash_ops.flash_attention(q, k, v, **geom),
                            lambda q, k, v: attention_ref(q, k, v, **geom),
                            (q, k, v), "K5", "FlashAttention"))
    for S, cap, w_std in ((65, 0.0, 0.1), (300, 30.0, 1.0)):
        x, w = leaf((2, S, 64)), leaf((1000, 64), w_std)
        t = torch.as_tensor(rng.integers(0, 1000, (2, S)), dtype=torch.int32, device="cuda")
        rows.append(compare(f"K6 S={S} softcap={cap}",
                            lambda x, w: xent_ops.fused_xent(x, w, t, softcap=cap),
                            lambda x, w: xent_ref.seq_chunked_xent(x, w, t, softcap=cap),
                            (x, w), "K6", "FusedXent"))
    r, kk, vv = leaf((1, 63, 2, 64)), leaf((1, 63, 2, 64)), leaf((1, 63, 2, 64))
    logw = torch.as_tensor(-rng.uniform(0.02, 2.0, (1, 63, 2, 64)), dtype=torch.float32,
                           device="cuda").requires_grad_(True)
    u = leaf((2, 64))
    rows.append(compare("K7 S=63 chunk=63", lambda *a: wkv_ops.wkv(*a, chunk=64),
                        lambda *a: wkv_chunked(*a, chunk=63), (r, kk, vv, logw, u),
                        "K7", "WKV"))
    s0 = leaf((1, 2, 64, 64))
    rows.append(compare("K7 S=63 chunk=63 from a carried state",
                        lambda *a: wkv_ops.wkv(*a[:5], chunk=64, s0=a[5]),
                        lambda *a: wkv_chunked(*a, chunk=63), (r, kk, vv, logw, u, s0),
                        "K7", "WKV"))
    report.emit({"phase": "grad_checks", "checks": rows, "rtol": GRAD_RTOL,
                 "atol": GRAD_ATOL})


def _train_model(torch, arch, seed, layers, compute_dtype=None):
    """(model, params, cfg): the registry config at full width (``layers``
    layers if given), ``xent_impl="chunked"``, remat on, f32 params from a
    seeded generator on the card (never stored in the compute dtype)."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.models.transformer import Model

    changes = {} if layers is None else {"num_layers": layers}
    if compute_dtype:
        changes["compute_dtype"] = compute_dtype
    cfg = dataclasses.replace(cfgbase.get_config(arch), **changes)
    model = Model(cfg, xent_impl="chunked", remat=True, rwkv_chunk=64)
    params = model.init_params(torch.Generator("cuda").manual_seed(seed), device="cuda")
    return model, params, cfg


def _leaf_stats(torch, grads):
    """(leaves, leaves with a nonzero and finite gradient, names of the others)."""
    from repro_torch.tree import flatten_with_paths

    bad = [("/".join(map(str, path)))
           for path, g in flatten_with_paths(grads)
           if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
    n = len(flatten_with_paths(grads))
    return n, n - len(bad), bad


def _profile_step(torch, fn):
    """Run ``fn`` under the profiler: (result, {kernel-name substring: device
    ms}, total device kernel ms, the device ms the step spans, the 10
    kernels with the most device time as [name, launches, ms])."""
    out, kernels, span = kernel_events(torch, lambda: torch.ones(1, device="cuda").add_(1),
                                       fn)
    # by the names of K6's, K5's and K7's libraries (K7's two kernels: "wkv_")
    by = {name: sum(ev.self_device_time_total for ev in kernels if key in ev.key) / 1e3
          for name, key in (("xent_fwd", "xent_fwd"), ("flash_fwd", LM_KERNEL_SYMBOL["K5"]),
                            ("wkv_fwd", LM_KERNEL_SYMBOL["K7"]))}
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:10]
    return (out, by, sum(ev.self_device_time_total for ev in kernels) / 1e3, span,
            [[ev.key[:100], ev.count, ev.self_device_time_total / 1e3] for ev in top])


def _active_params(cfg, params) -> float:
    """The parameters a token's forward reads: every one, except that a MoE
    layer's routed experts count top_k / num_experts of their weights."""
    from repro_torch.tree import leaves

    n = sum(p.numel() for p in leaves(params))
    if cfg.moe is not None:
        routed = sum(layer["ffn"][k].numel() for layer in params["layers"]
                     if "router" in layer["ffn"] for k in ("wi", "wg", "wo")
                     if k in layer["ffn"])
        n -= routed * (1 - cfg.moe.top_k / cfg.moe.num_experts)
    return n


def lm_train_phase(torch, np, report) -> dict:
    """Train each of ``TRAIN_RUNS``: Llama-3.2-1B at full width and depth,
    RWKV6-7B, RecurrentGemma-9B, Qwen2-MoE-A2.7B and Qwen2-VL-7B at full
    width with a few layers (AdamW's 16 B a parameter at full depth is over
    the card's 80 GB): bf16 compute, f32 params, remat, the launcher's
    AdamW, token-pipeline batches (Qwen2-VL's as the launcher's embeds,
    ``frontend_batch``); the timed steps, a microbatches=2 step (Llama,
    Qwen2-VL), then one more step under the profiler for K6's device time
    and the device's busy time.  Before the run, step 1's gradients on the
    kernel path (every leaf nonzero and finite, but an embeds batch's
    unread ``embed``, exactly zero) and its loss and grad norm against the
    plain path.  MFU = 6 (active non-embedding params + V D) tokens / (step
    s x 989e12), the active params a MoE layer's top_k / num_experts of its
    routed experts (``_active_params``).  Returns {arch: {kernel: launches
    of the run}}."""
    from repro_torch.data import tokens as tok
    from repro_torch.launch.train import adamw_config, frontend_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, make_train_step, value_and_grad
    from repro_torch.tree import leaves

    counters = _counters()
    out = {}
    for arch, (seed, layers, B, S, steps, micro, per_step) in TRAIN_RUNS.items():
        model, params, cfg = _train_model(torch, arch, seed, layers)
        pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                       global_batch=B, seed=seed)
        b0 = frontend_batch(cfg, tok.device_batch(pipe, 0, "cuda"))
        loss_k, m0, grads = value_and_grad(model, params, b0)
        unread = ("embed",) if "embeds" in b0 else ()
        n_leaves, n_good, bad = _leaf_stats(torch, {k: v for k, v in grads.items()
                                                     if k not in unread})
        bad += [k for k in unread if bool(grads[k].any())]
        norm_k = float(opt.global_norm(grads))
        del grads
        before = {k: c.count for k, c in counters.items()}
        with plain_kernels():
            loss_p, _, grads = value_and_grad(model, params, b0)
        norm_p = float(opt.global_norm(grads))
        del grads
        if any(c.count != before[k] for k, c in counters.items()):
            raise AssertionError(f"{arch}: a kernel launched in the plain pass")
        loss_k, loss_p = float(loss_k), float(loss_p)
        if bad or not (abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
                       and abs(norm_k - norm_p) <= TRAIN_NORM_RTOL * norm_p):
            raise AssertionError(f"{arch}: leaves without a nonzero finite gradient "
                                 f"{bad}; loss {loss_k} vs plain {loss_p}, grad norm "
                                 f"{norm_k} vs plain {norm_p}")

        # `steps` steps, a microbatches=2 step (Llama, Qwen2-VL), then one
        # more step under the profiler for the device breakdown.
        kinds = ["timed"] * steps + (["micro"] if micro else []) + ["profiled"]
        adamw = adamw_config(len(kinds))
        step_fns = {1: make_train_step(model, TrainStepConfig(adamw=adamw)),
                    2: make_train_step(model, TrainStepConfig(microbatches=2, adamw=adamw))}
        opt_state = opt.init_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, launches = [], [], []
        for s, kind in enumerate(kinds):
            n_micro = 2 if kind == "micro" else 1
            step_fn = step_fns[n_micro]
            batch = frontend_batch(cfg, tok.device_batch(pipe, s, "cuda"))
            torch.cuda.synchronize()
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            if kind == "profiled":
                (params, opt_state, m), by, busy, span, top = _profile_step(
                    torch, lambda: step_fn(params, opt_state, batch))
            else:
                params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            counts = {k: c.count for k, c in counters.items()}
            want = {k: per_step.get(k, 0) * n_micro for k in counters}
            loss = float(m["loss"])
            if counts != want or not np.isfinite(loss):
                raise AssertionError(f"{arch} step {s + 1} ({kind}): launches {counts}, "
                                     f"want {want}; loss {loss}")
            losses.append(loss)
            launches.append(counts)
        peak = torch.cuda.max_memory_allocated()
        p50_ms = _pct(np, step_ms[:steps], 50)
        tokens = B * S
        n_params = sum(p.numel() for p in leaves(params))
        n_active = _active_params(cfg, params)
        emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        flops = 6 * (n_active - emb + cfg.vocab_size * cfg.d_model) * tokens
        report.emit({
            "phase": "lm_train", "arch": arch, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": B, "seq": S,
            "tokens_per_step": tokens, "compute_dtype": cfg.compute_dtype,
            "param_dtype": cfg.param_dtype, "remat": model.remat,
            "xent_impl": model.xent_impl, "params": n_params, "active_params": n_active,
            "batch_inputs": sorted(b0), "steps": kinds, "losses": losses,
            "launches_per_step": launches,
            "leaves_with_nonzero_finite_grad": f"{n_good}/{n_leaves}",
            "leaves_unread_with_zero_grad": list(unread),
            "step1_vs_plain": {"loss": loss_k, "plain_loss": loss_p, "grad_norm": norm_k,
                               "plain_grad_norm": norm_p, "aux": float(m0["aux"])},
            "limits": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_rtol": TRAIN_NORM_RTOL},
            "step_ms": step_ms, "step_ms_p50": p50_ms,
            "tokens_per_s": tokens / (p50_ms / 1e3),
            "profiled_step_kernel_device_ms": by, "profiled_step_device_busy_ms": busy,
            "profiled_step_device_span_ms": span, "profiled_step_top_kernels": top,
            "k6_device_ms_per_step": by["xent_fwd"],
            # kernel time of the profiled step against an unprofiled step's
            # wall time (the profiler slows the host, so the profiled
            # step's own span overstates the idle time)
            "device_idle_share": 1 - busy / p50_ms,
            "max_memory_allocated": peak,
            "mfu_flops_per_step": flops,
            "mfu": flops / (p50_ms / 1e3) / PEAK_BF16_OPS_PER_S,
        })
        out[arch] = {k: sum(c[k] for c in launches) for k in counters}
        del model, params, opt_state
        torch.cuda.empty_cache()
    return out


def _grads_close(torch, gk, gp):
    """(worst max |difference| over max |plain| of a leaf, the leaves off
    STRICT_GRAD_RTOL as (path, max |difference|, max |plain|)): each
    gradient leaf of the kernel path within rtol and atol STRICT_GRAD_RTOL
    of the leaf's largest |value| of the plain path's."""
    from repro_torch.tree import flatten_with_paths

    worst, bad = 0.0, []
    for (path, a), (_, b) in zip(flatten_with_paths(gk), flatten_with_paths(gp)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not torch.allclose(a, b, rtol=STRICT_GRAD_RTOL, atol=STRICT_GRAD_RTOL * scale):
            bad.append(("/".join(map(str, path)), err, scale))
    return worst, bad


def train_strict_phase(torch, np, report) -> None:
    """Each of ``TRAIN_STRICT`` at full width and a few layers, f32 compute,
    TF32 off: step 1's loss and every gradient leaf, then the losses of 2
    AdamW steps, kernel path against plain path (``plain_kernels``), from
    identical params (Qwen2-VL on the launcher's embeds batches)."""
    from repro_torch.data import tokens as tok
    from repro_torch.launch.train import adamw_config, frontend_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, make_train_step, value_and_grad

    for arch, seed, layers in TRAIN_STRICT:
        model, params_k, cfg = _train_model(torch, arch, seed, layers, "float32")
        _, params_p, _ = _train_model(torch, arch, seed, layers, "float32")
        pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                       global_batch=2, seed=seed)

        def batch_at(s):
            return frontend_batch(cfg, tok.device_batch(pipe, s, "cuda"))

        b0 = batch_at(0)
        loss_k, m_k, gk = value_and_grad(model, params_k, b0)
        with plain_kernels():
            loss_p, m_p, gp = value_and_grad(model, params_p, b0)
        worst, bad = _grads_close(torch, gk, gp)
        del gk, gp
        losses = {"kernel": [], "plain": []}
        for side, params in (("kernel", params_k), ("plain", params_p)):
            step_fn = make_train_step(model, TrainStepConfig(adamw=adamw_config(2)))
            state = opt.init_state(params)
            for s in range(2):
                batch = batch_at(s)
                with plain_kernels() if side == "plain" else contextlib.nullcontext():
                    params, state, m = step_fn(params, state, batch)
                losses[side].append(float(m["loss"]))
            del state
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"])]
        loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        if bad or loss_rel > STRICT_LOSS_RTOL or max(rel) > STRICT_LOSS_RTOL:
            raise AssertionError(f"{arch} train_strict: loss rel {loss_rel}, step losses "
                                 f"{losses}, leaves off {bad[:5]}")
        report.emit({"phase": "train_strict", "arch": arch, "layers": layers,
                     "compute_dtype": "float32", "tf32": False, "batch": 2, "seq": 256,
                     "loss_rel_err": loss_rel, "worst_leaf_err_of_max": worst,
                     "aux": {"kernel": float(m_k["aux"]), "plain": float(m_p["aux"])},
                     "adamw_step_losses": losses, "adamw_step_loss_rel_err": rel,
                     "limits": {"loss_rtol": STRICT_LOSS_RTOL,
                                "grad_rtol": STRICT_GRAD_RTOL,
                                "grad_atol": f"{STRICT_GRAD_RTOL} x max |leaf|"}})
        del model, params_k, params_p
        torch.cuda.empty_cache()


def remat_dots_phase(torch, np, report) -> None:
    """Llama-3.2-1B's train cell (``TRAIN_RUNS``): one step's loss and
    gradients (``value_and_grad``, the part of a step a remat policy
    changes) under ``remat_policy="block"`` and under ``"dots"``, from the
    same params and batch, every launch counter set to 0 just before:
    losses within REMAT_DOTS_LOSS_RTOL, K5 32 launches in both (the
    recompute runs K5 under either policy) and K6 1.  Records each one's
    peak memory ("dots" keeps the matmul outputs until the backward, so
    its peak is the higher), ms and grad norm."""
    from repro_torch.data import tokens as tok
    from repro_torch.models.transformer import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import value_and_grad

    arch = "llama3.2-1b"
    seed, layers, B, S, _, _, per_step = TRAIN_RUNS[arch]
    model, params, cfg = _train_model(torch, arch, seed, layers)
    batch = tok.device_batch(tok.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=seed), 0, "cuda")
    counters = _counters()
    want = {k: per_step.get(k, 0) for k in counters}
    out = {}
    for policy in ("block", "dots"):
        m_ = Model(cfg, xent_impl=model.xent_impl, remat=True, remat_policy=policy,
                   rwkv_chunk=model.rwkv_chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        loss, _, grads = value_and_grad(m_, params, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = {k: c.count for k, c in counters.items()}
        out[policy] = {"loss": float(loss), "grad_norm": float(opt.global_norm(grads)),
                       "launches": counts, "ms": ms,
                       "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del grads
        torch.cuda.empty_cache()
        if counts != want:
            raise AssertionError(f"remat_dots {policy}: launches {counts}, want {want}")
    lb, ld = out["block"]["loss"], out["dots"]["loss"]
    rel = abs(ld - lb) / abs(lb)
    report.emit({"phase": "remat_dots", "arch": arch, "layers": cfg.num_layers,
                 "batch": B, "seq": S, "compute_dtype": cfg.compute_dtype, **out,
                 "loss_rel_err": rel, "loss_rtol": REMAT_DOTS_LOSS_RTOL,
                 "peak_ratio_dots_over_block": out["dots"]["max_memory_allocated"]
                 / out["block"]["max_memory_allocated"]})
    if not np.isfinite(lb) or rel > REMAT_DOTS_LOSS_RTOL:
        raise AssertionError(f"remat_dots: loss block {lb}, dots {ld} (rel {rel})")
    del model, params
    torch.cuda.empty_cache()


# sharded_train: Llama-3.2-1B's train cell (TRAIN_RUNS) through
# jit_train_step on a ("data", "model") = (2, 2) mesh, 2 steps, against the
# unsharded step with 2 microbatches (what a data axis of 2 computes):
# step 1's loss bit-equal, step 2's within SHARDED_LOSS_RTOL (the global
# norm adds its parts in another order), and the f64 norm of every param
# and moment leaf after the steps within SHARDED_NORM_RTOL of the unsharded
# step's (the limit the CPU tests hold each leaf to)
SHARDED_STEPS = 2
SHARDED_LOSS_RTOL = 1e-5
SHARDED_NORM_RTOL = 1e-6
# pipeline: 2 stages of 2 tanh dense layers (D x D, f32) over cuda:0, M
# microbatches of B rows, against the sequential stack
PIPE_D, PIPE_M, PIPE_B, PIPE_TOL = 2048, 8, 4, 1e-5


def _sharded_mesh(torch):
    """(2, 2) over four distinct cards when there are four, else cuda:0
    four times."""
    from repro_torch.launch.mesh import make_mesh

    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(4)] if n >= 4
               else [torch.device("cuda", 0)])
    return make_mesh((2, 2), ("data", "model"), devices=devices)


def _coordinate_bytes(np, trees_and_shardings, mesh):
    """{coordinate: [bytes it holds, bytes its specs say]} over the trees."""
    from repro_torch.tree import leaves

    out = {}
    for tree, shardings in trees_and_shardings:
        for x, sh in zip(leaves(tree), leaves(shardings)):
            want = sh.bytes_per_coordinate(tuple(x.shape), x.dtype.itemsize)
            for coord in mesh.coords():
                t = x.shard(coord)
                got = 0 if t is None else t.numel() * t.element_size()
                key = ",".join(map(str, coord))
                acc = out.setdefault(key, [0, 0])
                acc[0] += got
                acc[1] += int(want[coord])
    return out


def _leaf_norms(torch, trees) -> list:
    """The f64 norm of every leaf of ``trees`` (a placed leaf gathered on
    cuda:0 first)."""
    from repro_torch.sharding import placement as pl
    from repro_torch.tree import leaves

    return [float(torch.linalg.vector_norm(pl.gather(x, "cuda").double()))
            for tree in trees for x in leaves(tree)]


def _copies_disagree(torch, trees) -> tuple:
    """(blocks held on more than one card, those whose copies are not all
    bit-equal to the first) over the placed leaves of ``trees``."""
    from repro_torch.tree import leaves

    several = unequal = 0
    for tree in trees:
        for x in leaves(tree):
            for held in x.copies().values():
                if len({t.device for _, t in held}) < 2:
                    continue
                several += 1
                first = held[0][1]
                unequal += not all(torch.equal(t.to(first.device), first)
                                   for _, t in held[1:])
    return several, unequal


def sharded_train_phase(torch, np, report):
    """Llama-3.2-1B at full width and depth (B 8 x S 512, bf16 compute, f32
    master weights, remat "block", the launcher's AdamW) two ways, from the
    same seeded weights and token-pipeline batches: the unsharded step with
    2 microbatches, then ``jit_train_step`` on ``_sharded_mesh`` (the
    params by ``ShardingPolicy.param_specs``, the moments ZeRO-1 split, the
    batch split over the data axis), every launch counter set to 0 just
    before each step.  Checks: step 1's loss bit-equal, step 2's within
    SHARDED_LOSS_RTOL, the f64 norm of every param, m and v leaf after the
    steps within SHARDED_NORM_RTOL of the unsharded step's, K5 and K6
    launches a step equal both ways (K5 64, K6 2: each data coordinate runs
    its rows' forward and remat's recompute), every leaf in its placement,
    each coordinate's bytes equal to its specs' arithmetic, and (over
    distinct cards) every copy of a block bit-equal across the cards.
    Records the step ms and peak memory (cuda:0's, and each card's) both
    ways and the bytes at each coordinate and on each card.  Returns (the
    sharded state, the sharded step, {kernel: launches over the sharded
    steps})."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import tokens as tok
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.train import adamw_config
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, jit_train_step, make_train_step
    from repro_torch.tree import leaves, tree_map

    arch = "llama3.2-1b"
    seed, layers, B, S, _, _, per_step = TRAIN_RUNS[arch]
    counters = _counters()
    adamw = adamw_config(SHARDED_STEPS)
    want = {k: 2 * per_step.get(k, 0) for k in counters}
    runs = {}

    cards = range(torch.cuda.device_count())

    def drive(name, step_fn, params, state, pipe):
        _sync_all(torch)
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        ms, losses, launches = [], [], []
        for s in range(SHARDED_STEPS):
            batch = tok.device_batch(pipe, s, "cuda")
            _sync_all(torch)
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            _sync_all(torch)
            ms.append(1e3 * (time.perf_counter() - t0))
            counts = {k: c.count for k, c in counters.items()}
            losses.append(float(m["loss"]))
            launches.append(counts)
            if counts != want or not np.isfinite(losses[-1]):
                raise AssertionError(f"sharded_train {name} step {s + 1}: launches "
                                     f"{counts}, want {want}; loss {losses[-1]}")
        runs[name] = {"losses": losses, "step_ms": ms, "launches_per_step": launches,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(0),
                      "max_memory_allocated_by_card": {
                          f"cuda:{i}": torch.cuda.max_memory_allocated(i) for i in cards}}
        return params, state

    model, params, cfg = _train_model(torch, arch, seed, layers)
    initial = tree_map(lambda p: p.to("cpu"), params)  # the sharded run's start
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=seed)
    unsharded = make_train_step(model, TrainStepConfig(microbatches=2, adamw=adamw))
    params, state = drive("unsharded_2_microbatches", unsharded, params,
                          opt.init_state(params), pipe)
    want_norms = _leaf_norms(torch, (params, state.m, state.v))
    del params, state
    torch.cuda.empty_cache()

    mesh = _sharded_mesh(torch)
    policy = ShardingPolicy(mesh, cfg)
    step = jit_train_step(model, policy, inp.abstract_params(model),
                          TrainStepConfig(adamw=adamw),
                          batch_specs=policy.batch_specs(cfgbase.ShapeConfig("train", S, B,
                                                                             "train")))
    params = reshard_tree(initial, step.param_shardings)
    del initial
    params, state = drive("sharded_2x2", step, params, step.init_opt_state(), pipe)
    norms = _leaf_norms(torch, (params, state.m, state.v))
    norm_rel = max(abs(a - b) / b if b else abs(a) for a, b in zip(norms, want_norms))
    several, unequal = _copies_disagree(torch, (params, state.m, state.v))

    by_coord = _coordinate_bytes(np, [(params, step.param_shardings),
                                      (state.m, step.opt_state_shardings.m),
                                      (state.v, step.opt_state_shardings.v)], mesh)
    by_card = {}
    for x in leaves(params) + leaves(state.m) + leaves(state.v):
        for dev, n in x.device_bytes().items():
            by_card[str(dev)] = by_card.get(str(dev), 0) + n
    placed = all(x.sharding == sh for x, sh in zip(leaves(params), leaves(step.param_shardings)))
    u, sh = runs["unsharded_2_microbatches"], runs["sharded_2x2"]
    rel2 = abs(sh["losses"][1] - u["losses"][1]) / abs(u["losses"][1])
    report.emit({"phase": "sharded_train", "arch": arch, "layers": cfg.num_layers,
                 "batch": B, "seq": S, "compute_dtype": cfg.compute_dtype,
                 "param_dtype": cfg.param_dtype, "remat_policy": model.remat_policy,
                 "mesh": {"shape": mesh.shape, "devices": [str(d) for d in mesh.devices.flat]},
                 **runs, "step1_loss_bit_equal": sh["losses"][0] == u["losses"][0],
                 "step2_loss_rel_err": rel2, "loss_rtol": SHARDED_LOSS_RTOL,
                 "leaves_norm_checked": len(norms), "leaf_norm_max_rel_err": norm_rel,
                 "norm_rtol": SHARDED_NORM_RTOL, "blocks_on_several_cards": several,
                 "blocks_with_unequal_copies": unequal,
                 "bytes_by_coordinate_held_vs_specs": by_coord, "bytes_by_card": by_card,
                 "placements_kept": placed})
    bad = {k: v for k, v in by_coord.items() if v[0] != v[1]}
    if (sh["losses"][0] != u["losses"][0] or rel2 > SHARDED_LOSS_RTOL or bad or not placed
            or not norm_rel <= SHARDED_NORM_RTOL or unequal):
        raise AssertionError(f"sharded_train: losses {sh['losses']} vs {u['losses']}, "
                             f"leaf norms {norm_rel} off, bytes off their specs {bad}, "
                             f"placements kept {placed}, {unequal} of {several} blocks "
                             f"on several cards with unequal copies")
    counts = {k: sum(c[k] for c in sh["launches_per_step"]) for k in counters}
    return (params, state), step, counts


# sharded_mixed: the sharded step over two distinct devices on one card.
# Llama-3.2-1B's reduced config widened to K5's head dim (2 layers, d 256,
# 4 heads of 64 over 2 KV heads, d_ff 512, vocab 1,024), f32 compute,
# B 4 x S 64, 2 steps; against the same steps on (2, 2) over cuda:0 alone:
# the losses within MIXED_LOSS_RTOL and every param / m / v leaf's norm
# within MIXED_NORM_RTOL (the LM path's gradient tolerance: one data row
# runs the plain versions on the CPU where the other mesh runs K5 and K6)
MIXED_LOSS_RTOL, MIXED_NORM_RTOL = 1e-5, 1e-4


def sharded_mixed_phase(torch, np, report) -> None:
    """The branches of ``jit_train_step`` that only distinct devices take,
    run on one card: a (2, 2) ("data", "model") mesh over
    [[cuda:0, cpu], [cpu, cuda:0]], so every param block is held on both
    devices, data row 0 computes on the card (K5, K6) and row 1 on the CPU
    (the plain versions), and each ZeRO-1 shard is updated on its own
    device and copied to the block's holder on the other.  Checks: every
    copy of a block bit-equal across the two devices, each coordinate's
    bytes its specs', the losses and leaf norms within MIXED_LOSS_RTOL and
    MIXED_NORM_RTOL of the same steps on (2, 2) over cuda:0 alone."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.data import tokens as tok
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, jit_train_step

    cfg = dataclasses.replace(cfgbase.get_reduced_config("llama3.2-1b"), d_model=256,
                              num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                              vocab_size=1024, compute_dtype="float32")
    B, S = 4, 64
    model = Model(cfg, xent_impl="chunked", remat=True)
    whole = model.init_params(torch.Generator("cpu").manual_seed(7), device="cpu")
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=7)
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    runs = {}
    for name, devices in (("cuda:0", [card]), ("cuda:0+cpu", [card, cpu, cpu, card])):
        mesh = make_mesh((2, 2), ("data", "model"), devices=devices)
        policy = ShardingPolicy(mesh, cfg)
        step = jit_train_step(model, policy, inp.abstract_params(model),
                              TrainStepConfig(adamw=opt.AdamWConfig(lr_peak=1e-3,
                                                                    warmup_steps=2,
                                                                    total_steps=10)),
                              batch_specs=policy.batch_specs(
                                  cfgbase.ShapeConfig("train", S, B, "train")))
        params, state = reshard_tree(whole, step.param_shardings), step.init_opt_state()
        losses = []
        for s in range(2):
            params, state, m = step(params, state, tok.device_batch(pipe, s, "cuda"))
            losses.append(float(m["loss"]))
        trees = (params, state.m, state.v)
        by_coord = _coordinate_bytes(np, list(zip(trees, (step.param_shardings,
                                                          step.opt_state_shardings.m,
                                                          step.opt_state_shardings.v))), mesh)
        several, unequal = _copies_disagree(torch, trees)
        runs[name] = {"devices": [str(d) for d in mesh.devices.flat], "losses": losses,
                      "norms": _leaf_norms(torch, trees), "blocks_on_several_devices": several,
                      "blocks_with_unequal_copies": unequal,
                      "coordinates_off_their_specs": sorted(k for k, v in by_coord.items()
                                                            if v[0] != v[1])}
    one, mixed = runs["cuda:0"], runs["cuda:0+cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mixed["losses"], one["losses"]))
    norm_rel = max(abs(a - b) / b if b else abs(a)
                   for a, b in zip(mixed.pop("norms"), one.pop("norms")))
    report.emit({"phase": "sharded_mixed", "layers": cfg.num_layers, "d_model": cfg.d_model,
                 "batch": B, "seq": S, "compute_dtype": cfg.compute_dtype, **runs,
                 "loss_max_rel_err": loss_rel, "loss_rtol": MIXED_LOSS_RTOL,
                 "leaf_norm_max_rel_err": norm_rel, "norm_rtol": MIXED_NORM_RTOL})
    if (not mixed["blocks_on_several_devices"] or mixed["blocks_with_unequal_copies"]
            or one["coordinates_off_their_specs"] or mixed["coordinates_off_their_specs"]
            or not loss_rel <= MIXED_LOSS_RTOL or not norm_rel <= MIXED_NORM_RTOL):
        raise AssertionError(f"sharded_mixed: {runs}, losses {loss_rel} and leaf norms "
                             f"{norm_rel} off the one-card mesh's")


def reshard_phase(torch, np, report, state, step) -> None:
    """Elastic re-mesh of the sharded train state from (2, 2): ``ckpt.save``
    of the placed params (whole leaves) and ``restore(shardings=)`` of them
    onto (4, 1); ``reshard_tree`` of the whole params and AdamW state onto
    (4, 1), and of that onto (1, 1) (over the same cards as
    ``_sharded_mesh``, or cuda:0).  Every leaf bit-equal to the (2, 2) one
    and in its new placement after each.  Records the save, restore and
    reshard seconds and the checkpoint's bytes."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.tree import leaves

    params, opt_state = state
    tree = {"params": params, "opt": opt_state}
    ckpt_dir = ROOT / "build" / "chip_reshard_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(ckpt_dir, 2, {"params": params})
    save_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in ckpt_dir.rglob("*") if p.is_file())
    devices = sorted(set(step.mesh.devices.flat), key=str)

    def shardings_on(sizes):
        mesh = make_mesh(sizes, ("data", "model"),
                         devices=devices if len(devices) == sizes[0] * sizes[1]
                         else devices[:1])
        policy = ShardingPolicy(mesh, step.model.cfg)
        specs = policy.param_specs(step.abstract_params)
        return {"params": policy.shardings(specs),
                "opt": policy.opt_state_shardings(specs, step.abstract_params)}

    def check(onto, how, want, got, shardings, seconds):
        equal = placed = 0
        for a, b, sh in zip(leaves(want), leaves(got), leaves(shardings)):
            placed += b.sharding == sh
            equal += bool(torch.equal(pl.gather(a, "cuda"), pl.gather(b, "cuda")))
        n = len(leaves(want))
        out.append({"onto": onto, "by": how, "seconds": seconds, "leaves": n,
                    "bit_equal": equal, "placed": placed})
        if equal != n or placed != n:
            raise AssertionError(f"reshard onto {onto} ({how}): {equal}/{n} leaves "
                                 f"bit-equal, {placed}/{n} in their placements")

    out, moved = [], tree
    for sizes in ((4, 1), (1, 1)):
        onto = "x".join(map(str, sizes))
        shardings = shardings_on(sizes)
        if sizes == (4, 1):
            t0 = time.perf_counter()
            _, restored = ckpt.restore(ckpt_dir, {"params": params},
                                       shardings={"params": shardings["params"]})
            _sync_all(torch)
            check(onto, "restore(shardings=) of the params", {"params": params}, restored,
                  {"params": shardings["params"]}, time.perf_counter() - t0)
            del restored
        t0 = time.perf_counter()
        moved = reshard_tree(moved, shardings)
        _sync_all(torch)
        check(onto, "reshard_tree of the params and AdamW state", tree, moved, shardings,
              time.perf_counter() - t0)
    del moved
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    report.emit({"phase": "reshard", "from": "2x2", "save_s": save_s,
                 "checkpoint_bytes": nbytes, "checks": out})


def pipeline_phase(torch, np, report) -> None:
    """``pipeline_forward`` (GPipe, M + P - 1 ticks) with 2 stages over
    cuda:0 (a ("pod",) mesh of the card twice; over cuda:0 and cuda:1 on a
    machine of two cards or more), each stage 2 tanh dense
    layers of PIPE_D, PIPE_M microbatches of PIPE_B rows, f32, TF32 off:
    the outputs within PIPE_TOL of the sequential stack, and the gradients
    of sum(y^2) too.  Records both forwards' ms."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.pipeline import pipeline_forward, stack_stage_params

    gen = torch.Generator("cuda").manual_seed(40)
    D = PIPE_D

    def stage(p, x):
        return torch.tanh(torch.tanh(x @ p["w1"]) @ p["w2"])

    stages = [{k: torch.randn(D, D, generator=gen, device="cuda") / D ** 0.5
               for k in ("w1", "w2")} for _ in range(2)]
    xs = torch.randn(PIPE_M, PIPE_B, D, generator=gen, device="cuda")
    mesh = make_mesh((2,), ("pod",), devices=[torch.device("cuda", i) for i in
                                              range(min(2, torch.cuda.device_count()))])
    run = pipeline_forward(stage, mesh)
    stacked = stack_stage_params(stages)
    for t in stacked.values():
        t.requires_grad_(True)
    y = run(stacked, xs)
    (y ** 2).sum().backward()
    flat = [t.detach().clone().requires_grad_(True) for t in (stacked["w1"], stacked["w2"])]
    seq = lambda w1, w2: torch.stack([stage({"w1": w1[1], "w2": w2[1]},
                                            stage({"w1": w1[0], "w2": w2[0]}, x))
                                      for x in xs])
    y_ref = seq(*flat)
    (y_ref ** 2).sum().backward()
    err = float((y - y_ref).detach().abs().max())
    gerr = max(float((stacked[k].grad - f.grad).abs().max() / f.grad.abs().max())
               for k, f in zip(("w1", "w2"), flat))
    with torch.no_grad():
        t_pipe = event_ms(torch, lambda: run(stacked, xs), iters=20, warmup=3)
        t_seq = event_ms(torch, lambda: seq(*flat), iters=20, warmup=3)
    report.emit({"phase": "pipeline", "devices": [str(d) for d in mesh.devices.flat],
                 "stages": 2, "microbatches": PIPE_M, "rows": PIPE_B,
                 "d": D, "dtype": "float32", "ticks": PIPE_M + 1, "max_abs_err": err,
                 "grad_rel_err": gerr, "tol": PIPE_TOL, "pipelined_ms": t_pipe,
                 "sequential_ms": t_seq})
    if not (err <= PIPE_TOL and gerr <= PIPE_TOL):
        raise AssertionError(f"pipeline: outputs {err}, gradients {gerr} off the "
                             f"sequential stack (limit {PIPE_TOL})")


PEAK_TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core rate
# K6 timed at each train cell's (N, D, V): B x S tokens, d_model, vocab
K6_TRAIN_SHAPES = {"llama3.2-1b": (4096, 2048, 128256), "rwkv6-7b": (2048, 4096, 65536),
                   "recurrentgemma-9b": (2048, 4096, 256000),
                   "qwen2-moe-a2.7b": (2048, 2048, 151936),
                   "qwen2-vl-7b": (2048, 3584, 152064)}
K6_ROUTE = ("3xTF32 on the tensor cores: mma.sync.m16n8k8 TF32 products of hi/lo "
            "splits of each f32 operand, f32 accumulation")


def k6_bound(N, D, V):
    """(ms, by): x, w, targets read and the loss written once; the
    operations of K6's route, 3 TF32 products per f32 product (2 N V D
    each) at the TF32 tensor-core peak."""
    t_bytes = 4 * (N * D + V * D + 2 * N) / HBM_BYTES_PER_S
    t_ops = 3 * 2 * N * V * D / PEAK_TF32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k6_f32_bound_ms(N, D, V):
    """The same work's floor in f32 on the CUDA cores (any FFMA design)."""
    return 2 * N * V * D / PEAK_F32_OPS_PER_S * 1e3


def k6_timing_phase(torch, np, report, train_counts) -> list:
    """K6 at each train cell's shape (``K6_TRAIN_SHAPES``): CUDA-event ms
    and profiler device ms, beside its plain version (``seq_chunked_xent``),
    the library call ``F.cross_entropy(x @ w.T, t, reduction="none")`` (f32,
    TF32 off) and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent.kernel import fused_xent_fwd

    entries = []
    for arch, (N, D, V) in K6_TRAIN_SHAPES.items():
        rng = np.random.default_rng(66)
        x, w, t = _xent_inputs(torch, np, rng, N, D, V, None)
        tl = t.long()
        kern = lambda: fused_xent_fwd(x, w, t)
        plain = lambda: xent_ref.seq_chunked_xent(x[None], w, t[None])
        library = lambda: F.cross_entropy(x @ w.T, tl, reduction="none")
        with torch.no_grad():
            err = float((kern() - plain()[0]).abs().max())
            lib_err = float((library() - plain()[0]).abs().max())
            t_ = {"ms": event_ms(torch, kern, iters=10, warmup=2),
                  "plain_ms": event_ms(torch, plain, iters=3, warmup=1),
                  "library_ms": event_ms(torch, library, iters=10, warmup=2),
                  "device_ms": device_ms(torch, kern, iters=5),
                  "plain_device_ms": device_ms(torch, plain, iters=2),
                  "library_device_ms": device_ms(torch, library, iters=5)}
        bms, bby = k6_bound(N, D, V)
        report.emit({"phase": "timing", "kernel": "K6",
                     "shape": f"N={N} D={D} V={V} f32 ({arch} train loss)",
                     "max_abs_err": err, "library_max_abs_err": lib_err,
                     "route": K6_ROUTE, "bound_ms": bms, "bound_by": bby,
                     "f32_cuda_core_bound_ms": k6_f32_bound_ms(N, D, V),
                     "library": "F.cross_entropy(x @ w.T, t, reduction='none'), f32, TF32 off",
                     **t_})
        entries.append({
            "name": f"K6 xent_fwd_f32 [{arch} train loss, N={N} D={D} V={V}]",
            "route": "cuda", "source": "src/repro_torch/csrc/xent_fwd.cu",
            "replaces": "src/repro/kernels/xent/kernel.py:23",
            "launches": train_counts[arch]["K6"], "max_abs_err": err, "ms": t_["ms"],
            "plain_ms": t_["plain_ms"], "bound_ms": bms, "bound_by": bby,
            "library_ms": t_["library_ms"], "device_ms": t_["device_ms"]})
        del x, w, t, tl
        torch.cuda.empty_cache()
    return entries


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every JSON line to this file")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, serve the six CNN engines, run the mesh phase and "
                         "stop (on a machine of several cards: the mesh over them all)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build, check K5 and K6, run the sharded_train, sharded_mixed, "
                         "reshard and pipeline phases and stop (on a machine of four "
                         "cards: the meshes over distinct cards)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 - fails here outside a checkout

    # f32 is compared at 1e-5 (kernels, LeNet) and 1e-4 (the DAG nets, whose
    # unfused 1x1 convs run through cuDNN): no TF32 anywhere.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = Report(args.out)
    t0 = time.perf_counter()
    report.emit({"phase": "start", "torch": torch.__version__,
                 "cuda": torch.version.cuda, "python": sys.version.split()[0],
                 "device": torch.cuda.get_device_name(0)})
    build_phase(report)

    def stop_early():
        print(card_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if args.sharded_only:
        k5_checks(torch, np, report)
        k6_checks(torch, np, report)
        state, step, _ = sharded_train_phase(torch, np, report)
        sharded_mixed_phase(torch, np, report)
        reshard_phase(torch, np, report, state, step)
        del state, step
        torch.cuda.empty_cache()
        pipeline_phase(torch, np, report)
        return stop_early()
    k1_checks(torch, np, report)
    k2_checks(torch, np, report)
    dw_checks(torch, np, report)
    strided_view_checks(torch, np, report)
    k5_checks(torch, np, report)
    k6_checks(torch, np, report)
    k7_checks(torch, np, report)
    grad_checks(torch, np, report)
    engines = engine_phase(torch, np, report)
    mesh_phase(torch, np, report, engines)
    if args.mesh_only:
        return stop_early()
    stream_phase(torch, np, report)
    report_phase(torch, np, report)
    residual_phase(torch, np, report)
    c_export_phase(torch, np, report, engines)
    lm_counts = lm_engine_phase(torch, np, report)
    encdec_k5 = encdec_phase(torch, np, report)
    kv_int8_phase(torch, np, report)
    lm_strict_phase(torch, np, report)
    rwkv_drift_phase(torch, np, report)
    train_counts = lm_train_phase(torch, np, report)
    train_strict_phase(torch, np, report)
    remat_dots_phase(torch, np, report)
    state, step, sharded_counts = sharded_train_phase(torch, np, report)
    for k, n in sharded_counts.items():
        train_counts["llama3.2-1b"][k] += n
    sharded_mixed_phase(torch, np, report)
    reshard_phase(torch, np, report, state, step)
    del state, step
    torch.cuda.empty_cache()
    pipeline_phase(torch, np, report)
    entries = timing_phase(torch, np, report, engines)
    entries += lm_timing_phase(torch, np, report, lm_counts, train_counts, encdec_k5)
    entries += k6_timing_phase(torch, np, report, train_counts)
    for net in engines:
        run = engines[net]["run"]
        report.emit({"phase": "serving", "net": net, "qps": run.qps,
                     "p50_ms": run.latency_ms(50), "p99_ms": run.latency_ms(99),
                     "batches": run.batches})
    card = card_line()
    report.emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3),
                 "card": card})
    print(card, flush=True)
    report.emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
