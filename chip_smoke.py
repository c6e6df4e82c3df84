#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--out FILE] [--mesh-only | --sharded-only | --examples-only
                           | --mixtral-only]

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
   window, a softcap, h=32, 128 and 256, RecurrentGemma-9B's and
   Qwen2-MoE's served shapes at S 509 and RecurrentGemma's at S 1000
   under a window of 256, Qwen2-VL-7B's GQA 7:1 (28 query heads over 4
   KV heads, h 128) at S 509 / 1,000 and its train shape (4, 512), without
   the causal mask at Seamless-M4T's encoder (S = T = 1,000) and
   cross-attention shapes (S 8 / 16 over T 509 / 1,000), at a query offset
   (``K5_OFFSET``: each data row's span of a batch-1 sequence at offsets 0
   and S / 2, a ragged span of 129 at offset 383, a window of 64 at 200),
   strided views and
   views whose rows are not 16-byte aligned (f32 2e-5, bf16 5e-2 and each row within 2e-2
   of its largest value); K7 on the RWKV6-7B
   shapes (H=64, h=64) at S 2/63/64/256/509, chunk 64 and 8, f32 and bf16
   inputs, from the zero state and (S 63/256/509) from a carried state,
   and two other head shapes, and at the shapes the sharded phases give it
   (``K7_SHARDED``: a data row's rows or span, 32 heads a model
   coordinate, at batch 1 the second span from a carried state) (o and
   s_final at rtol 1e-4, atol 1e-5 plus the f32 rounding of two summation
   orders, see ``k7_checks``); K6
   (3xTF32 on the tensor cores) on the five train shapes (N, D, V) =
   (4,096, 2,048, 128,256), (2,048, 4,096, 65,536), (2,048, 4,096,
   256,000), (2,048, 2,048, 151,936) and (2,048, 3,584, 152,064), an odd N
   with a vocab tail, a softcap of 30 and a vocab of 37, targets at 0, V-1
   and inside the last tile, at one split and at the automatic count (per
   token within 1e-5 relative + 1e-5 + 8 f32 epsilons of |x| max|w|, see
   ``K6_CASES``; the worst share of those epsilons is printed), and K6's
   partial form (``xent_part_f32``, the vocab-split loss of the sharded
   train step) on the same cases' vocabularies split in 2 and 4 blocks:
   each block's (lse, t) against ``xent_block_ref`` and their log-sum-exp
   combine against the whole-vocab plain CE, within the same gate, one
   launch a call (``k6_part_vs_plain``); and each
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
   (``scan_entry_phase``) the compiled single-image entry points under the
   reference's names (``run_with_arena_scan``, ``run_dag_with_arena_scan``,
   ``run_int8_with_arena_scan``, ``run_int8_dag_with_arena_scan``,
   ``make_int8_scan_executor``, ``aot_compile``) on a served input of
   LeNet-5, CIFAR int8 and DS-CNN-KWS f32 / int8: the same launches and
   bits as the executors; then (``mesh_phase``) serves the same six
   engines 64 requests in bursts of
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
   (``c_export_phase``); no gcc fails the run; then runs the repo's eleven
   user entry points on the port as a user does (``examples_phase``: the nine
   ``examples/torch_*.py``, ``scripts/torch_emit_c_artifacts.py`` and
   ``scripts/torch_obs_report.py ds_cnn --timed``, each ``--device cuda`` in
   a fresh process, four at a time, at reduced ``--steps`` / ``--requests``):
   each exits 0 with ``ok`` last, launches the kernels ``EXAMPLES`` lists for
   it (its ``kernels:`` line) and runs ``nvcc`` 0 times (``--examples-only``
   builds, runs this phase and stops);
6. serves Llama-3.2-1B (16 requests, 8 lanes, 32 new tokens), RWKV6-7B,
   RecurrentGemma-9B, Qwen2-MoE-A2.7B, Llama-3-8B, Nemotron-4-15B and
   Qwen2-VL-7B's text decoder (8 requests, 4 lanes, 16 new tokens each),
   Gemma3-1B (16 requests of up to 1,716 tokens, 8 lanes, ``max_seq``
   2,048, 32 new tokens) and Mixtral-8x7B (10 requests of 1 to 8,192
   tokens, 4 lanes, ``max_seq`` 8,448, 16 new tokens) at full width, at
   full depth but for ``LM_ENGINE_LAYERS`` (RWKV6-7B 16, RecurrentGemma-9B
   20, Qwen2-MoE 12, Llama-3-8B 16, Qwen2-VL 14 and Mixtral 8 layers),
   bf16 compute (each layer's
   weights stored in bf16 as it is drawn), through ``Engine``, one model
   at a time: every request done, K5 = 16 / K7 = 16 / K5 = 6 / K5 = 12 /
   K5 = 16 / K5 = 32 / K5 = 14 / K5 = 26 / K5 = 8 launches per prefill (no
   other kernel; Gemma3's 22 with its window of 512, 4 without; Mixtral's
   8 with its window of 4,096), the KV/state bytes (268,959,744 /
   68,157,440 / 27,557,888 / 402,849,792 / 268,697,600 / 537,395,200 /
   117,669,888 / 160,006,144 / 537,395,200 B: Gemma3's 22 local layers keep
   rings of 512 slots, Mixtral's 8 rings of 4,096), the request whose
   decode steps wrap the rings (Gemma3 509 + 32, Mixtral 4,090 + 16) and
   the longest prompt that overran them in the prefill (Gemma3 1,716,
   Mixtral 8,192: two MoE token groups) decoded again and held against a
   prefill of the whole sequence, each prompt's
   logits against the plain path on the card (the same model with K5/K7
   swapped for their plain versions, ``plain_kernels``), TTFT, prefill and
   decode tokens/s, peak memory, and the device time of K5 / K7, the
   RG-LRU scan and the MoE einsums over the served prompts' prefills;
   Qwen2-VL-7B then from patch embeddings (``vl_embeds_phase``): 4 lanes
   of 509 embedding rows through ``Model.prefill(batch={"embeds": ...})``,
   K5 14 launches, then 16 greedy decode steps on tokens, none, the
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
   Gemma3 6, over a prompt of 600 past its window; Mixtral 2 over a prompt
   of 4,200 past its window; Seamless 2 encoder and
   2 decoder layers over 200 frames, its training loss and gradients too,
   at step 9's limits), f32 compute, kernel path against plain path:
   prefill and 4 decode steps at 1e-4; then
   RWKV6-7B at full depth (32 layers) on prompts of 200 and 509 tokens,
   kernel path against plain path layer by layer, at f32 compute (final
   logits and K7's share of each layer held, see ``RWKV_F32_DRIFT_TOL``);
8. trains Llama-3.2-1B at full width and depth (B 8 x S 512, 4 steps, a
   step of 2 microbatches, then a profiled step), Gemma3-1B at full width
   and depth (B 4 x S 1,024, 2 steps, then a profiled step), and RWKV6-7B
   (2 layers), RecurrentGemma-9B (3), Qwen2-MoE-A2.7B (2), Qwen2-VL-7B
   (2, on the launcher's embeds batches, and a step of 2 microbatches) and
   Mixtral-8x7B (1: K5 2, K6 1 at (2,048, 4,096, 32,000)) at
   full width (B 4 x S 512, 2 steps, then a profiled step): f32 params,
   bf16 compute, remat, ``xent_impl="chunked"``, the launcher's AdamW,
   token-pipeline batches; every loss finite, launches per step pinned
   (Llama K5 32, K6 1, or 64 and 2 with 2 microbatches; Gemma3 K5 52, K6 1
   at V 262,144 on the tied table; RWKV K7 4, K6 1; RecurrentGemma K5 2,
   Qwen2-MoE and Qwen2-VL K5 4, K6 1; no other kernel), every parameter
   leaf with a nonzero finite gradient (an embeds batch's unread
   ``embed``: zero),
   step 1's loss and grad norm against the plain path (1e-2 and 5e-2
   relative); step ms, tokens/s, peak memory, K6's device ms per step,
   the device's idle share and MFU (on the active parameters for MoE);
9. holds the six trained architectures at full width, 2 layers
   (RecurrentGemma 3; Gemma3 6, at S 640), f32 compute, kernel path
   against plain path: step
   1's loss at 1e-5 relative, every gradient leaf at rtol 1e-3 and 1e-3 of
   the leaf's largest value, and the losses of 2 AdamW steps at 1e-5
   relative; then (``remat_dots_phase``) one Llama-3.2-1B train step's
   loss and gradients under ``remat_policy="block"`` and under ``"dots"``:
   losses within 1e-6, K5 32 in both, both peaks recorded;
   then the multi-card half of training on the card: ``sharded_train``
   (3 steps of ``jit_train_step`` beside the unsharded step with 2
   microbatches, params by ``ShardingPolicy``, the AdamW moments ZeRO-1
   split: Llama-3.2-1B at full width, 4 of its 16 layers, B 8 x S 512,
   on ("data", "model") = (2, 1) over cuda:0 twice, each data row's rows
   through K5 and K6 whole: step 1's loss bit-equal, the others within
   1e-5 relative, the f64 norm of every param and moment leaf within 1e-6
   relative, K5 16 and K6 2 a step; then tensor parallel on (2, 2), over
   four cards when there are four, else over cuda:0 four times: K5 32 (on
   each model coordinate's
   heads) and K6's partial form 4 a step (on each model coordinate's vocab
   block of the unembedding, a data row's rows), no leaf gathered, losses
   and leaf norms within the limits
   ``SHARDED_TP_*`` derives; Qwen2-MoE-A2.7B's 2 layers, B 4, on (2, 2):
   K5 16, the experts' d_ff split, losses, leaf norms and each row's aux
   loss through ``RowOps`` within ``SHARDED_MOE_*``; RWKV6-7B's 2 layers
   and RecurrentGemma-9B's 3, B 4, on (2, 2): K7 16 on each coordinate's
   32 heads (RWKV), K5 8 (RecurrentGemma), the RG-LRU on each coordinate's
   channels, no RWKV or RG-LRU leaf gathered, K7 only at ``K7_SHARDED``,
   losses and leaf norms (RWKV's median leaf) within ``SHARDED_RWKV_*`` /
   ``SHARDED_RG_*``, and RWKV6-7B's same steps at f32 compute, every
   leaf norm and loss within ``SHARDED_F32_*``; Gemma3-1B's 6 layers (one
   5:1 group), B 4 x S 1,024, on (2, 2): K5 48 on 2 of 4 query heads a
   coordinate, local and global, K6's partial form 4 on the tied table's
   vocab blocks, within its ``SHARDED_TP_LIMITS``; then at batch 1
   (``SEQ_SPLIT_TRAIN``: the batch specs split the sequence, each data row
   its span) beside the unsharded step at 1 microbatch: Llama-3.2-1B 1 x
   4,096 on (2, 1) and (2, 2), K5 16 / 32 a step at offsets 0 and 2,048,
   and RWKV6-7B, RecurrentGemma-9B, Qwen2-MoE-A2.7B and Gemma3-1B 1 x 2,048
   on (2, 2) (K7 16 a step, half from a carried state; Gemma3's local
   queries of the second row over the first row's last 511 keys), each
   within its (2, 2) limits (Llama's and Gemma3's: ``SEQ_SPLIT_LIMITS``),
   and Seamless-M4T-large-v2's 2
   encoder and 2 decoder layers at 1 x 1,024 frames + 1 x 512 tokens on
   (2, 2), each data row encoding its 512 frames over both rows' K/V (K5 48
   a step, K6's partial form 4; ``SEQ_SPLIT_LIMITS``); each coordinate's bytes
   equal to
   its specs' arithmetic, over distinct cards every copy of a block
   bit-equal across them, step ms and peak both ways, Llama's idle
   share unsharded and on (2, 2)), ``sharded_mixed`` (the branches
   that only distinct devices take, on one card: a widened reduced Llama
   at f32, tensor parallel on (2, 2) over cuda:0 and the CPU, every block
   on both, B 4 and B 1 (the sequence split: K/V and gradients cross the
   two devices), and a widened reduced Seamless-M4T at B 1 (64 frames: the
   encoder's K/V joined across the two devices); its
   copies bit-equal across them, the losses within 1e-5 and the leaf
   norms within 1e-4 of the same steps over cuda:0 alone), ``reshard``
   (the params saved whole and restored with ``shardings=`` onto (4, 1);
   the params and AdamW state by ``reshard_tree`` onto (4, 1), then onto
   (1, 1); every leaf bit-equal after each), ``sharded_serve`` (the
   sharded serving steps, ``jit_prefill_step`` / ``jit_decode_step``, on
   the same (2, 2) mesh beside the unsharded ``Model.prefill`` /
   ``make_decode_step`` on the same weights: Llama-3-8B whole at 4 x 509
   and 4 x 128 tokens (``max_seq`` 1,024) and 1 x 2,048 (``max_seq``
   4,096), RecurrentGemma-9B's first 3 layers and RWKV6-7B's first 4 at 4
   x 509 and 1 x 512 (``max_seq`` 1,024), Seamless-M4T-large-v2 whole
   at 4 x 509 frames + 8 tokens and 1 x 1,000 frames + 16 (``max_seq`` 64,
   its decode steps with the memory), and Gemma3-1B whole at 4 x 1,000
   (``max_seq`` 2,048) and 1 x 2,048 (``max_seq`` 4,096), its caches split
   on length (the rings of 512 slots in blocks of 256 or 128, overrun in
   the prefill and wrapped in decode), 16 greedy steps each, the
   sharded ones teacher-forced with the unsharded path's tokens; at batch
   1 each data row prefills its span of the prompt, and encodes its span
   of the frames layer by layer over both rows' K/V (Seamless K5 96 a
   stack, the encoder's at (1, 500, 8, 8, 64) over 1,000 frames; an
   utterance of 999 frames raising): the prefill's and
   every decode step's logits within ``LM_LOGITS_TOL``, K5 once an
   attention layer and K7 once an RWKV layer on each model coordinate of
   each data row (Llama-3-8B K5 128, at batch 1 at offsets 0 and 1,024;
   RecurrentGemma K5 4; RWKV6-7B K7 16 on 32 heads a coordinate, at batch
   1 8 of them from a carried state; Gemma3-1B K5 104, 2 of 4 query heads
   a coordinate) and no kernel in a decode step, a
   batch-1 prompt of 509 raising, no leaf gathered, each coordinate's
   cache bytes its specs'
   (Llama-3-8B: 4 of 8 KV heads; RecurrentGemma: a length block, and half
   the RG-LRU's channels of h and conv; RWKV6-7B: half the heads of s),
   ``next_tok`` placed by ``tok_spec``; TTFT, ms a decode step and
   greedy-token agreement (with the top-2 margin where they disagree)
   recorded; then the same steps on
   (2, 2) over [[cuda:0, cpu], [cpu, cuda:0]] against cuda:0 alone, f32,
   widened reduced configs, batch 4 and batch 1: logits within 1e-5,
   greedy tokens equal, every
   cache block on both devices bit-equal) and ``pipeline`` (GPipe, 2
   stages over cuda:0,
   or cuda:0 and cuda:1 when there are two, D 2,048, M 8, B 4, f32:
   outputs and gradients within 1e-5 of the sequential stack)
   (``--sharded-only`` builds, checks K5, K6 and K7, runs these five phases
   and stops);
10. times each kernel at the main path's shapes (K1-K4 at batch 1 and 16,
    K3 and K4 at every distinct depthwise step of both nets, beside
    cuDNN's chain and the f64 chain, K5 at S 128/512/1000, at
    RecurrentGemma-9B's, Qwen2-MoE's, Llama-3-8B's, Nemotron-4-15B's and
    Qwen2-VL-7B's served shapes at S 509 and at Seamless-M4T's batch of 4
    at 1,000 frames (encoder and cross-attention without the mask,
    decoder), at Gemma3-1B's served S 1,000 and train shape (B 4 x S
    1,024), under its window of 512 and without (SDPA's yardstick with
    the window as a boolean mask), at Mixtral-8x7B's served S 509 / 4,097
    / 8,192 and train shape (B 4 x S 512) under its window of 4,096, K7 at
    S 128/509/512/1000 (each of its
    two kernels by name)
    and at each shape the sharded phases gave it,
    K5 also at the train shapes of Llama (B 8 x S 512; its launches, and
    K6's, lm_train's and sharded_train's), RecurrentGemma,
    Qwen2-MoE and Qwen2-VL (B 4 x S 512) and at each shape the sharded
    prefills and the sharded train steps gave it (a data row's rows or, at
    batch 1, its span at its query offset, beside SDPA under the same mask;
    a model coordinate's heads), K6
    at the seven train shapes, and at the sharded train cells' data-row
    tokens over the whole vocab and, in its partial form, over one model
    coordinate's vocab block) with
    CUDA events
    and the profiler, beside its plain version, a PyTorch library call
    computing the same function where there is one, and its bound from the
    shapes (K6's on its route, 3xTF32 at the TF32 tensor-core peak, with
    the f32 CUDA-core figure beside it).

``--mixtral-only`` builds, checks K5 and K6 and runs ``mixtral_sharded``
alone: Mixtral-8x7B at full width and depth (46.70 B parameters, 93.4 GB of
bf16, over one card) on ("data", "model") = (1, 4) over four distinct cards
(or (1, 2) over two; with fewer it exits 2), every layer drawn straight
into its blocks (``Model.init_params(shardings=)``), served through the
sharded steps at 4 x 509 and 1 x 8,192 tokens (``max_seq`` 8,448, rings of
4,096 slots), 16 greedy steps each: first its 8-layer prefix against the
unsharded path on cuda:0, then all 32 layers held against themselves (see
``mixtral_sharded_phase``).

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
    """Prints each result as one JSON line, and keeps a copy in ``--out``.
    A phase's line carries ``t_s``, the seconds since the report began, so
    the lines show where the run's time went."""

    def __init__(self, out):
        self.out = Path(out) if out else None
        self.t0 = time.perf_counter()
        if self.out:
            self.out.parent.mkdir(parents=True, exist_ok=True)
            self.out.write_text("")

    def emit(self, obj) -> None:
        if "phase" in obj:
            obj = {**obj, "t_s": round(time.perf_counter() - self.t0, 3)}
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
    from repro_torch.kernels import launch_counters

    return launch_counters()


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


def scan_entry_phase(torch, np, report, engines) -> None:
    """The compiled single-image entry points under the reference's names
    on the card, on the first served input of four engines:
    ``run_with_arena_scan`` (LeNet-5 f32: K1 2), ``run_int8_with_arena_scan``
    and ``make_int8_scan_executor`` (CIFAR int8: K2 3 each),
    ``run_dag_with_arena_scan`` (DS-CNN-KWS f32: K3 4 + K1 1) and
    ``run_int8_dag_with_arena_scan`` (DS-CNN-KWS int8: K4 4 + K2 1), every
    counter set to 0 just before each call: their launches, outputs equal to
    a fresh executor's (bit for bit) and to the engine's (int8 bit for bit,
    f32 within 1e-5), stats those of the executor; then ``aot_compile`` of
    LeNet's executor at a batch of 4 (K1 2 while it prepares, its arena
    allocated then, the prepared call equal to the executor's, another
    shape raising ``TypeError``)."""
    from repro_torch.core import pingpong
    from repro_torch.quant import exec as qexec

    counters = _counters()

    def counted(fn):
        for c in counters.values():
            c.reset()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.count for k, c in counters.items() if c.count}

    rec, faults = {"phase": "scan_entry_points"}, []
    for name, fn, executor, want in (
            ("lenet5_f32", lambda e, x: pingpong.run_with_arena_scan(
                e["fused"], e["plan"], e["model"], x),
             lambda e: lambda x: pingpong.make_scan_executor(e["fused"], e["plan"])(
                 e["model"], x), {"K1": 2}),
            ("cifar_int8", lambda e, x: qexec.run_int8_with_arena_scan(e["model"], e["plan"], x),
             lambda e: qexec.make_int8_scan_executor(e["model"], e["plan"]), {"K2": 3}),
            ("ds_cnn_kws_f32", lambda e, x: pingpong.run_dag_with_arena_scan(
                e["fused"], e["plan"], e["model"], x),
             lambda e: lambda x: pingpong.make_dag_executor(e["fused"], e["plan"])(
                 e["model"], x), {"K3": 4, "K1": 1}),
            ("ds_cnn_kws_int8", lambda e, x: qexec.run_int8_dag_with_arena_scan(
                e["model"], e["plan"], x),
             lambda e: qexec.make_int8_scan_executor(e["model"], e["plan"]),
             {"K4": 4, "K2": 1})):
        e = engines[name]
        xs, ys = e["served"]
        x = torch.as_tensor(xs[0], device="cuda")
        (y, stats), got = counted(lambda: fn(e, x))
        run = executor(e)
        y_ex, got_ex = counted(lambda: run(x))
        err = float((y.float().cpu() - torch.as_tensor(ys[0]).float()).abs().max())
        exact = torch.equal(y, y_ex)
        rec[name] = {"launches": got, "executor_launches": got_ex, "stats": stats,
                     "equal_to_executor": exact, "max_abs_err_vs_engine": err}
        tol = 0.0 if x.dtype == torch.int8 else 1e-5
        if got != want or got_ex != want or not exact or not err <= tol:
            faults.append(name)
    e = engines["lenet5_f32"]
    fn = pingpong.make_scan_executor(e["fused"], e["plan"])
    compiled, got = counted(lambda: pingpong.aot_compile(fn, e["model"], (4, 1, 32, 32),
                                                         torch.float32))
    x = torch.as_tensor(e["served"][0][:4], device="cuda")
    prepared = set(fn.arenas)
    y, got_call = counted(lambda: compiled(e["model"], x))
    try:
        compiled(e["model"], x[:2])
        raised = False
    except TypeError:
        raised = True
    rec["aot_compile"] = {"launches_preparing": got, "launches_a_call": got_call,
                          "arenas_before_the_first_call": sorted(prepared),
                          "equal_to_executor": torch.equal(y, fn(e["model"], x)),
                          "another_shape_raises": raised}
    if (got != {"K1": 2} or got_call != {"K1": 2} or prepared != {4}
            or not rec["aot_compile"]["equal_to_executor"] or not raised):
        faults.append("aot_compile")
    report.emit(rec)
    if faults:
        raise AssertionError(f"scan_entry_points: {faults}: {rec}")


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


# The repo's user entry points on the port, each run as a user runs it (a
# fresh process, ``--device cuda``): (script, reduced arguments the reference
# entry point also takes, outputs under build/examples/, the kernels it must
# launch), longest first.  EXAMPLES_AT_ONCE processes run at a time: each
# spends ~10 s starting Python, PyTorch and its CUDA context (184 s for the
# eleven one at a time on an H100 host).
EXAMPLES_OUT = ROOT / "build" / "examples"
EXAMPLES = (
    ("examples/torch_train_llm.py", ("--steps", "20", "--ckpt-dir", "build/examples/train_ckpt"),
     ("K5", "K6")),
    ("examples/torch_deploy_microcontroller.py", ("--steps", "150"), ("K1", "K2")),
    ("scripts/torch_emit_c_artifacts.py", ("--out", "build/examples/c-engines"), ()),
    ("examples/torch_plan_residual_dag.py", (), ("K1", "K2")),
    ("examples/torch_deploy_ds_cnn.py", (), ("K1", "K2", "K3", "K4")),
    ("examples/torch_serve_llm.py", (), ("K5",)),
    ("examples/torch_serve_cnn.py", ("--requests", "32"), ("K1", "K2", "K4")),
    ("scripts/torch_obs_report.py", ("ds_cnn", "--timed", "--out", "build/examples/obs"),
     ("K1", "K2", "K3", "K4")),
    ("examples/torch_stream_kws.py", (), ("K4",)),
    ("examples/torch_trace_serving.py", ("--out", "build/examples/trace"), ("K1",)),
    ("examples/torch_quickstart.py", (), ("K1",)),
)
EXAMPLES_AT_ONCE = 4


def _run_example(script, extra, want) -> dict:
    """One entry point in a process of its own; raises unless it exits 0
    with ``ok`` last, every kernel of ``want`` launched and no ``nvcc``
    run."""
    cmd = [sys.executable, script, "--device", "cuda", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    (EXAMPLES_OUT / f"{Path(script).stem}.log").write_text(proc.stdout + proc.stderr)
    lines = proc.stdout.strip().splitlines()
    counts = [json.loads(ln[len("kernels:"):]) for ln in lines if ln.startswith("kernels:")]
    faults = []
    if proc.returncode != 0:
        faults.append(f"exit code {proc.returncode}")
    if not lines or lines[-1] != "ok":
        faults.append("last line is not 'ok'")
    if len(counts) != 1:
        faults.append("no single 'kernels:' line")
    else:
        counts = counts[0]
        faults += [f"{k} launched 0 times" for k in want if counts.get(k, 0) < 1]
        if counts.get("nvcc_runs") != 0:
            faults.append(f"nvcc ran {counts.get('nvcc_runs')} times")
    if faults:
        raise AssertionError(f"examples {script}: {'; '.join(faults)}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    return {"script": script, "args": cmd[2:], "seconds": seconds, "kernels": counts,
            "want": list(want), "stdout": lines}


def examples_phase(report) -> dict:
    """Each of the repo's entry points on the port (``EXAMPLES``) in a
    process of its own, ``python <script> --device cuda ...``, up to
    EXAMPLES_AT_ONCE at a time: exit code 0, ``ok`` as its last line, and
    its ``kernels:`` line (the process's launch counters,
    ``repro_torch.kernels.launch_counts``) showing every kernel listed for
    it launched and ``nvcc`` run 0 times: the kernels load from
    ``build/kernels/``, built by ``build_phase``.  Each entry's wall seconds
    (process start to exit, beside the others) and its output are recorded;
    the output is also kept in ``build/examples/<name>.log``.  Returns the
    entries by script name."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    EXAMPLES_OUT.mkdir(parents=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(EXAMPLES_AT_ONCE) as pool:
        runs = [pool.submit(_run_example, *e) for e in EXAMPLES]
        entries = {Path(e[0]).stem: r.result() for e, r in zip(EXAMPLES, runs)}
    report.emit({"phase": "examples", "at_once": EXAMPLES_AT_ONCE, "entries": entries,
                 "seconds": time.perf_counter() - t0})
    return entries


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
            (4, 512, 28, 4, 128, 0, 0.0),
            # Gemma3-1B: 4 query heads over one KV head (GQA 4:1, h 256), its
            # 22 local layers with the window of 512 (it bites past 512 keys)
            # and its 4 global layers without, at served prompts just past
            # the window, of 1,000 and of 1,716 (the longest lm_engine
            # serves), and at its train shape (B 4 x S 1,024)
            (1, 513, 4, 1, 256, 512, 0.0), (1, 1000, 4, 1, 256, 512, 0.0),
            (1, 1000, 4, 1, 256, 0, 0.0), (1, 1716, 4, 1, 256, 512, 0.0),
            (1, 1716, 4, 1, 256, 0, 0.0), (4, 1024, 4, 1, 256, 512, 0.0),
            (4, 1024, 4, 1, 256, 0, 0.0),
            # the repo's entry points (examples_phase): torch_serve_llm's
            # serve-demo-50m (8 query heads over 4 KV heads, h 32) at its
            # shortest, a middle and its longest prompt, and
            # torch_train_llm's microbatch (B 4 x S 128, 2 heads over 1, h 64)
            (1, 4, 8, 4, 32, 0, 0.0), (1, 41, 8, 4, 32, 0, 0.0), (1, 47, 8, 4, 32, 0, 0.0),
            (4, 128, 2, 1, 64, 0, 0.0),
            # Mixtral-8x7B: 32 query heads over 8 KV heads (GQA 4:1, h 128), every
            # layer under the window of 4,096: served at 509 (the window past
            # the keys), 4,097 and 8,192 (where it bites), and its train shape
            # (B 4 x S 512); the sharded shapes of --mixtral-only are
            # K5_MIXTRAL_SHARDED
            (1, 509, 32, 8, 128, 4096, 0.0), (1, 4097, 32, 8, 128, 4096, 0.0),
            (1, 8192, 32, 8, 128, 4096, 0.0), (4, 512, 32, 8, 128, 4096, 0.0)]
# K5 at the shapes the sharded prefills of sharded_serve give it on (2, 2): a
# data row's rows and a model coordinate's heads.  Llama-3-8B: 16 query heads
# over 4 KV heads (h 128) at prompts of 509 and 128; RecurrentGemma-9B's
# local layer: 8 query heads over its one KV head (GQA 8:1, h 256, window
# 2048) at batch 4 (two rows a data row) and a batch-1 prompt of 509 whole;
# batch-1 spans are K5_OFFSET's
K5_SHARDED_SERVE = [(2, 509, 16, 4, 128, 0, 0.0), (2, 128, 16, 4, 128, 0, 0.0),
                    (2, 509, 8, 1, 256, 2048, 0.0), (1, 509, 8, 1, 256, 2048, 0.0),
                    # Seamless-M4T's decoder at 4 x 8 tokens: two rows, 8 of 16 heads
                    (2, 8, 8, 8, 64, 0, 0.0),
                    # Gemma3-1B at 4 x 1,000: two rows, 2 of 4 query heads over
                    # its one KV head, local (window 512) and global
                    (2, 1000, 2, 1, 256, 512, 0.0), (2, 1000, 2, 1, 256, 0, 0.0)]
K5_EXTRA += K5_SHARDED_SERVE
# K5 at the shapes the sharded train steps of sharded_train give it: a data
# row's rows and a model coordinate's heads.  Llama-3.2-1B's B 8 split over 2
# data rows, every head on (2, 1), 16 query heads over 4 KV heads (h 64) a
# coordinate on (2, 2); Qwen2-MoE-A2.7B's B 4, 8 heads over 8 (h 128) on (2, 2);
# RecurrentGemma-9B's local layer, 8 heads over its one KV head (h 256,
# window 2048) on (2, 2)
K5_SHARDED_TRAIN = [(4, 512, 32, 8, 64, 0, 0.0), (4, 512, 16, 4, 64, 0, 0.0),
                    (2, 512, 8, 8, 128, 0, 0.0), (2, 512, 8, 1, 256, 2048, 0.0),
                    # Gemma3-1B's B 4 x S 1,024: 2 of 4 query heads over its one
                    # KV head, local (window 512) and global layers
                    (2, 1024, 2, 1, 256, 512, 0.0), (2, 1024, 2, 1, 256, 0, 0.0)]
K5_EXTRA += K5_SHARDED_TRAIN
# K5 without the causal mask, (B, S, H, K, h, T): Seamless-M4T's encoder
# self-attention over 1,000 frames (S = T), one utterance and its served
# batches of 4 at 509 and 1,000 frames, and its decoder's cross-attention
# from prompts of 8 and 16 tokens over 509 and 1,000 frames (S != T)
K5_NONCAUSAL = [(1, 1000, 16, 16, 64, 1000), (4, 509, 16, 16, 64, 509),
                (4, 1000, 16, 16, 64, 1000), (4, 8, 16, 16, 64, 509),
                (4, 16, 16, 16, 64, 1000)]
# ... and at the shapes the sharded phases give Seamless-M4T's encoder and
# cross-attention on (2, 2), a model coordinate's 8 of 16 heads: sharded_serve
# at 4 x 509 frames (two rows a data row, every frame) and at 1 x 1,000
# frames, where each data row's 500 frames' queries read all 1,000 frames
# (the encoder's sequence split) and its 8 of 16 tokens' read them too, and
# sharded_train at 1 x 1,024 frames and 512 tokens
K5_ENCODER_SPLIT = [(2, 509, 8, 8, 64, 509), (2, 8, 8, 8, 64, 509),
                    (1, 500, 8, 8, 64, 1000), (1, 8, 8, 8, 64, 1000),
                    (1, 512, 8, 8, 64, 1024), (1, 256, 8, 8, 64, 1024)]
K5_NONCAUSAL += K5_ENCODER_SPLIT
# K5 with a query offset, causal, (B, S, H, K, h, window, q_offset) over T =
# q_offset + S keys: the spans of a sequence split over 2 data rows at batch 1
# on (2, 2), a model coordinate's heads (sharded_serve's and sharded_train's
# batch-1 runs: each row's span at offset 0 and at S): Llama-3-8B's prefill
# of 2,048 (16 q heads over 4 KV, h 128), Llama-3.2-1B's train sequence of
# 4,096 (16 over 4, h 64; on (2, 1) every head, 32 over 8),
# RecurrentGemma-9B's local layer (8 over its 1, h 256, window 2,048) at the
# prefill of 512 and the train sequence of 2,048, Qwen2-MoE-A2.7B's train
# sequence of 2,048 (8 over 8, h 128); then a ragged
# span of 129 at offset 383 (not a multiple of a key block) and a window of
# 64 at offset 200 (the first key block read past key 0)
K5_OFFSET = [(1, 1024, 16, 4, 128, 0, 0), (1, 1024, 16, 4, 128, 0, 1024),
             (1, 2048, 16, 4, 64, 0, 0), (1, 2048, 16, 4, 64, 0, 2048),
             (1, 2048, 32, 8, 64, 0, 0), (1, 2048, 32, 8, 64, 0, 2048),
             (1, 256, 8, 1, 256, 2048, 0), (1, 256, 8, 1, 256, 2048, 256),
             (1, 1024, 8, 1, 256, 2048, 0), (1, 1024, 8, 1, 256, 2048, 1024),
             (1, 1024, 8, 8, 128, 0, 0), (1, 1024, 8, 8, 128, 0, 1024),
             # Seamless-M4T's decoder spans: the served prompt of 16, the
             # train sequence of 512 (8 of 16 heads, h 64)
             (1, 8, 8, 8, 64, 0, 0), (1, 8, 8, 8, 64, 0, 8),
             (1, 256, 8, 8, 64, 0, 0), (1, 256, 8, 8, 64, 0, 256),
             # Gemma3-1B's prefill of 2,048 and train sequence of 2,048: 2 of 4
             # query heads over its one KV head (h 256), the local layers'
             # window of 512 reaching back over the first row's last 511 keys
             (1, 1024, 2, 1, 256, 512, 0), (1, 1024, 2, 1, 256, 512, 1024),
             (1, 1024, 2, 1, 256, 0, 0), (1, 1024, 2, 1, 256, 0, 1024),
             (1, 129, 32, 8, 64, 0, 383), (1, 100, 32, 8, 64, 64, 200)]
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
# K7 at the shapes the sharded phases give it on (2, 2), (B, S, H, h, from a
# carried state): a data row's rows and a model coordinate's 32 of RWKV6-7B's
# 64 heads, in sharded_serve's prefills at batch 4 (S 509) and in
# sharded_train's steps (B 4 x S 512), and a batch-1 prompt of 509 whole; at
# batch 1 a data row's span of the sequence, the first from the zero state
# and the second from the state the first carried (the prefill of 512 and the
# train sequence of 2,048); every K7 launch there must be at one of them
K7_SHARDED = [(2, 509, 32, 64, False), (1, 509, 32, 64, False), (2, 512, 32, 64, False),
              (1, 256, 32, 64, False), (1, 256, 32, 64, True), (1, 1024, 32, 64, False),
              (1, 1024, 32, 64, True)]
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
# (K5 in all 28 layers).  Gemma3-1B's is its first reading on an H100 80GB
# HBM3 at 700 W, 0.1016 / 0.0227 served (the ring decode against a prefill
# 0.0742 / 0.0177, sharded_serve's steps 0.1133 / 0.0221 at most), with
# ~3.5x / 3x headroom (K5 in all 26 layers, 22 of them windowed).
# Mixtral-8x7B's is its first readings on an H100 80GB HBM3 at 700 W, with
# ~3.5x / 3x headroom: its 8 served layers against the plain path 0.900 /
# 0.248 (the largest), the (1, 4) prefix against the unsharded path 0.760 /
# 0.099 at 4 x 509 and 0.051 / 0.013 at 1 x 8,192, a decode over the rings
# against a prefill 0.047 / 0.012 under lifted_capacity.  The gaps at the
# real capacity are MoE routing's: a top-2 choice that K5's bf16 rounding
# flips moves a token's output by a whole expert and every later token's
# capacity slot; at f32 (lm_strict) the kernel path is within 1.8e-5.
LM_LOGITS_TOL = {"llama3.2-1b": (0.25, 0.05), "rwkv6-7b": (3.0, 0.75),
                 "recurrentgemma-9b": (0.5, 0.1), "qwen2-moe-a2.7b": (1.0, 0.2),
                 "llama3-8b": (0.25, 0.05), "nemotron-4-15b": (0.3, 0.06),
                 "seamless-m4t-large-v2": (0.2, 0.04), "qwen2-vl-7b": (0.25, 0.05),
                 "gemma3-1b": (0.36, 0.07), "mixtral-8x7b": (3.2, 0.75)}
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
    # Gemma3-1B: 22 local layers (K5 with the window of 512, h 256, GQA 4:1)
    # and 4 global ones (K5 without; RoPE theta 1M), tied embeddings scaled
    # by sqrt(d_model); the window is under max_seq, so the local layers'
    # caches are rings of 512 slots: prompts of 512 and 513 fill and
    # overrun them in the prefill, 509 + 32 new tokens wraps them in decode
    "gemma3-1b": (7, 8, 2048, 32, (1, 128, 509, 512, 513, 1000, 1500), (9, 2, 2017), "K5"),
    # Mixtral-8x7B: 32 sliding-window layers (K5 with the window of 4,096, h
    # 128, GQA 32:8), each a MoE of 8 experts of 14,336, top 2; max_seq
    # 8,448 is past the window, so every cache is a ring of 4,096 slots:
    # 4,090 + 16 new tokens wraps them in decode, 4,097 and 8,192 overrun
    # them in the prefill, and 8,192 (a multiple of 4,096) is routed in two
    # token groups of 4,096 (4,097 in one)
    "mixtral-8x7b": (8, 4, 8448, 16, (1, 128, 509, 4090, 4097, 8192), (4, 2, 8193), "K5"),
}
# lm_engine's depth where it cuts the config's, to keep the run's time
# within its bound as archs were added: Llama-3-8B 16 of 32 layers
# (sharded_serve serves it whole), RWKV6-7B 16 of 32 (rwkv_drift walks all
# 32 at f32 and bf16), Qwen2-MoE-A2.7B 12 of 24, Qwen2-VL-7B 14 of 28 (and
# vl_embeds on the same model), RecurrentGemma-9B 20 of 38 (six whole
# (rglru, rglru, local) groups and two rglru layers); every other served
# arch whole; Mixtral-8x7B 8 of 32 (23.5 GB of bf16 weights, what a card
# holds of the whole model on (1, 4); its 46.7 B parameters, 93.4 GB, are over
# one card: chip_smoke.py --mixtral-only serves all 32 over 2-4 cards)
LM_ENGINE_LAYERS = {"llama3-8b": 16, "rwkv6-7b": 16, "qwen2-moe-a2.7b": 12,
                    "qwen2-vl-7b": 14, "recurrentgemma-9b": 20, "mixtral-8x7b": 8}
LM_KV_BYTES = {"llama3.2-1b": 268_959_744, "rwkv6-7b": 68_157_440,
               "recurrentgemma-9b": 27_557_888, "qwen2-moe-a2.7b": 402_849_792,
               "llama3-8b": 268_697_600, "nemotron-4-15b": 537_395_200,
               "qwen2-vl-7b": 117_669_888, "gemma3-1b": 160_006_144,
               "mixtral-8x7b": 537_395_200}
# A name every kernel of K5 / K7 has in the profiler
LM_KERNEL_SYMBOL = {"K5": "flash_fwd", "K7": "wkv_"}
# Plain-PyTorch parts of the served prefills timed as profiler ranges:
# (module, function, range name)
LM_RANGES = (("repro_torch.models.griffin", "rg_lru", "rg_lru_scan"),
             ("repro_torch.models.moe", "expert_mix", "moe_expert_einsums"))
# lm_strict: (arch, seed, prompt, layers); RecurrentGemma takes its first
# 3 layers, (rglru, rglru, local), so that K5 runs in the strict pass;
# Seamless-M4T 2 encoder and 2 decoder layers over LM_STRICT_SRC frames;
# Gemma3-1B one whole 5:1 group (5 local layers, 1 global) on a prompt past
# its window, so the prefill overruns the rings and the decode steps write
# and read them wrapped; Mixtral-8x7B 2 layers on a prompt of 4,200, past its
# window of 4,096 (rings of 4,096 slots, one MoE token group of 4,200).  The
# cache holds max(LM_STRICT_MAX_SEQ, prompt + 4)
LM_STRICT = (("llama3.2-1b", 10, 129, 2), ("rwkv6-7b", 11, 200, 2),
             ("recurrentgemma-9b", 12, 200, 3), ("qwen2-moe-a2.7b", 13, 200, 2),
             ("seamless-m4t-large-v2", 14, 16, 2), ("llama3-8b", 15, 200, 2),
             ("nemotron-4-15b", 16, 200, 2), ("qwen2-vl-7b", 17, 200, 2),
             ("gemma3-1b", 18, 600, 6), ("mixtral-8x7b", 19, 4200, 2))
LM_STRICT_MAX_SEQ = 512
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


@contextlib.contextmanager
def lifted_capacity():
    """Inside, every MoE token group's expert capacity is its token count,
    so no (token, expert) choice is dropped.  A decode step never drops
    one; a prefill at the real capacity (1.25 x a group's share) does, and
    its dropped experts change the hidden states the cache holds, so a
    decode is held against a prefill of the same sequence only with the
    capacity lifted in both (as tests/test_torch_lm.py holds them)."""
    from repro_torch.models import moe

    saved = moe.capacity
    moe.capacity = lambda cfg, tokens_per_group, factor=1.25: tokens_per_group
    try:
        yield
    finally:
        moe.capacity = saved


def k5_cases() -> list:
    """Every shape ``k5_checks`` holds K5 at, in f32 and in bf16: (B, S,
    T, H, K, h, window, softcap, causal, q_offset)."""
    cases = [(B, S, S, H, K, h, window, softcap, True, 0)
             for B, S, H, K, h, window, softcap in
             [(B, S, 32, 8, 64, 0, 0.0) for S in K5_SEQS for B in (1, 2)] + K5_EXTRA]
    cases += [(B, S, T, H, K, h, 0, 0.0, False, 0) for B, S, H, K, h, T in K5_NONCAUSAL]
    return cases + [(B, S, off + S, H, K, h, window, 0.0, True, off)
                    for B, S, H, K, h, window, off in K5_OFFSET]


def k5_unheld(by_key) -> list:
    """K5's launch keys at a shape ``k5_checks`` does not hold."""
    held = set(k5_cases())
    return [k for k in by_key if (*k[1:7], k[8], k[9], k[7], k[10]) not in held]


def k5_checks(torch, np, report) -> None:
    """K5 against its plain version: the Llama shapes at every S and batch,
    a window, a softcap, head dims 32, 128 and 256, the non-causal shapes
    (``K5_NONCAUSAL``: T = S and T != S), the spans of a sequence split
    over the data rows at a query offset (``K5_OFFSET``), and strided
    views."""
    from repro_torch.kernels.flash.kernel import K5_LAUNCHES
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref

    cases = k5_cases()
    worst = {"f32": 0.0, "bf16": 0.0}
    worst_nc = {"f32": 0.0, "bf16": 0.0}
    worst_gqa7 = {"f32": 0.0, "bf16": 0.0}  # Qwen2-VL's 28 query heads over 4
    worst_sharded = {"f32": 0.0, "bf16": 0.0}  # K5_SHARDED_SERVE
    worst_sharded_train = {"f32": 0.0, "bf16": 0.0}  # K5_SHARDED_TRAIN
    worst_offset = {"f32": 0.0, "bf16": 0.0}  # K5_OFFSET, past offset 0
    worst_encoder = {"f32": 0.0, "bf16": 0.0}  # K5_ENCODER_SPLIT
    worst_window = {"f32": 0.0, "bf16": 0.0}  # a window some query row sees past
    worst_mixtral = {"f32": 0.0, "bf16": 0.0}  # Mixtral-8x7B's window of 4,096
    n_window = 0
    worst_row = 0.0
    n_checks = 0
    for ci, (B, S, T, H, K, h, window, softcap, causal, off) in enumerate(cases):
        rng = np.random.default_rng(9000 + ci)
        q = rng.standard_normal((B, S, H, h))
        k = rng.standard_normal((B, T, K, h))
        v = rng.standard_normal((B, T, K, h))
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            qt, kt, vt = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (q, k, v))
            geom = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
            before = K5_LAUNCHES.count
            y = flash_attention(qt, kt, vt, **geom)
            launches = K5_LAUNCHES.count - before
            y_ref = attention_ref(qt, kt, vt, **geom)
            torch.cuda.synchronize()
            ok, err = _close(torch, y, y_ref, K5_TOL[kind], K5_TOL[kind])
            row_ok, row = (_rows_close(y, y_ref, K5_BF16_ROW_REL)
                           if kind == "bf16" else (True, 0.0))
            if launches != 1 or y.dtype != dtype or not (ok and row_ok):
                raise AssertionError(f"K5 {(B, S, T, H, K, h, window, softcap, causal, off)} "
                                     f"{kind}: {launches} launches, max abs err {err}, "
                                     f"worst row share {row}")
            worst[kind] = max(worst[kind], err)
            if not causal:
                worst_nc[kind] = max(worst_nc[kind], err)
            if H == 7 * K:
                worst_gqa7[kind] = max(worst_gqa7[kind], err)
            if (B, S, H, K, h, window, softcap) in K5_SHARDED_SERVE and causal:
                worst_sharded[kind] = max(worst_sharded[kind], err)
            if (B, S, H, K, h, window, softcap) in K5_SHARDED_TRAIN and causal:
                worst_sharded_train[kind] = max(worst_sharded_train[kind], err)
            if off:
                worst_offset[kind] = max(worst_offset[kind], err)
            if not causal and (B, S, H, K, h, T) in K5_ENCODER_SPLIT:
                worst_encoder[kind] = max(worst_encoder[kind], err)
            if window and off + S > window:
                worst_window[kind] = max(worst_window[kind], err)
                n_window += 1
            if window == MIXTRAL_ATTENTION[3]:
                worst_mixtral[kind] = max(worst_mixtral[kind], err)
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
                 "sharded_serve_checks": 2 * len(K5_SHARDED_SERVE),
                 "sharded_serve_max_abs_err": worst_sharded,
                 "sharded_train_checks": 2 * len(K5_SHARDED_TRAIN),
                 "sharded_train_max_abs_err": worst_sharded_train,
                 "offset_checks": 2 * len(K5_OFFSET),
                 "offset_cases": [list(c) for c in K5_OFFSET],
                 "offset_max_abs_err": worst_offset,
                 "encoder_split_checks": 2 * len(K5_ENCODER_SPLIT),
                 "encoder_split_max_abs_err": worst_encoder,
                 "window_bites_checks": n_window, "window_bites_max_abs_err": worst_window,
                 "mixtral_checks": 2 * sum(c[6] == MIXTRAL_ATTENTION[3] for c in cases),
                 "mixtral_max_abs_err": worst_mixtral,
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
    chunk; and at ``K7_SHARDED``, the shapes the sharded phases give it.
    Both sum in f32 (K7 in a fixed order, the plain version in
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
    cases += [((B, H, h, h), S, 64, carried) for B, S, H, h, carried in K7_SHARDED]
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
                 "sharded_shapes_checked": [list(k) for k in K7_SHARDED],
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


def _ring_layers(cfg, max_seq: int) -> int:
    """The attention layers whose cache is a ring at ``max_seq``."""
    from repro_torch.models.attention import cache_spec

    return sum(cache_spec(cfg, kind, max_seq).ring for kind in cfg.blocks()
               if kind in ("attn", "swa", "local"))


def _k5_by_window(by_key) -> dict:
    """K5's launches by the window they ran with (0: none)."""
    out = {}
    for key, n in by_key.items():
        out[key[8]] = out.get(key[8], 0) + n
    return out


def _ring_decode_check(torch, np, model, params, req, max_seq, limit) -> dict:
    """A served request whose decode wraps the rings, or whose prompt
    overran them in the prefill: its prompt prefilled alone, then its
    served tokens fed back through ``make_decode_step`` (teacher-forced);
    the logits of the first step at a position past the window (its K/V
    written over a ring slot) and of the last step, each against
    ``Model.prefill`` of the whole sequence up to that position (a linear
    pass over every key); a MoE config's passes all under
    ``lifted_capacity``.  Raises unless both are finite and within
    ``limit`` (max abs, relative 2-norm)."""
    from repro_torch.serve.step import make_decode_step

    cfg = model.cfg
    P = len(req.prompt)
    seq = np.concatenate([req.prompt, np.asarray(req.out_tokens, np.int32)])
    first, last = max(cfg.window, P), P + len(req.out_tokens) - 2
    gaps = {}
    with lifted_capacity() if cfg.moe else contextlib.nullcontext():
        cache, _ = model.prefill(params, {"tokens": torch.as_tensor(seq[None, :P],
                                                                    device="cuda")}, max_seq)
        decode = make_decode_step(model, max_seq)
        for pos in range(P, last + 1):
            tok = torch.as_tensor(seq[None, pos:pos + 1], device="cuda")
            at = torch.tensor([pos], dtype=torch.int32, device="cuda")
            _, logits, cache = decode(params, cache, tok, at)
            if pos in (first, last):
                _, want = model.prefill(params, {"tokens": torch.as_tensor(
                    seq[None, :pos + 1], device="cuda")}, max_seq)
                gaps[pos] = {"max_abs": float((logits - want).abs().max()),
                             "rel_rms": float((logits - want).norm() / want.norm()),
                             "finite": bool(torch.isfinite(logits).all())}
        del cache
    out = {"prompt": P, "positions": sorted(gaps), "ring_slots": cfg.window,
           "moe_capacity_lifted": cfg.moe is not None,
           "logits_vs_prefill": {str(k): v for k, v in gaps.items()}, "limit": limit}
    if not all(g["finite"] and g["max_abs"] <= limit[0] and g["rel_rms"] <= limit[1]
               for g in gaps.values()):
        raise AssertionError(f"{cfg.name}: decode over a wrapped ring {out}")
    return out


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
        model, params = _lm_model(torch, arch, seed, **(
            {"num_layers": LM_ENGINE_LAYERS[arch]} if arch in LM_ENGINE_LAYERS else {}))
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
        # K5 a prefill by window: the windowed layers' with theirs, the others' without
        by_window = _k5_by_window(counts["K5"][1])
        want_window = {}
        for kind in cfg.blocks():
            if kind in ("attn", "swa", "local"):
                w = cfg.window if kind in ("swa", "local") else 0
                want_window[w] = want_window.get(w, 0) + stats.prefills
        if kern == "K5" and by_window != want_window:
            raise AssertionError(f"{arch}: K5 by window {by_window}, want {want_window}")
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
        # a request whose decode steps wrap the rings (Gemma3-1B's 509 + 32,
        # Mixtral's 4,090 + 16), and the longest prompt that overran them in
        # the prefill (Gemma3's 1,716, Mixtral's 8,192), decoded on from there
        rings = _ring_layers(cfg, max_seq)
        wraps = [r for r in reqs if rings and len(r.prompt) < cfg.window
                 < len(r.prompt) + max_new - 1]
        overran = sorted((r for r in reqs if rings and len(r.prompt) > cfg.window),
                         key=lambda r: len(r.prompt))
        ring_decode = [_ring_decode_check(torch, np, model, params, r, max_seq,
                                          LM_LOGITS_TOL[arch])
                       for r in wraps[:1] + overran[-1:]]
        if rings and not (wraps and overran):
            raise AssertionError(f"{arch}: no served request wraps its rings in decode, "
                                 f"or none overruns them in the prefill")

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
            "k5_launches_by_window": {str(w): n for w, n in sorted(by_window.items())},
            "ring_cache_layers": rings, "ring_decode": ring_decode or None,
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
        max_seq = max(LM_STRICT_MAX_SEQ, S + 4)
        for side in ("kernel", "plain"):
            with plain_kernels() if side == "plain" else contextlib.nullcontext():
                memory = model.encode(params, batch["src_embeds"]) if cfg.is_encdec else None
                cache, logits = model.prefill(params, batch, max_seq, memory=memory)
                steps = []
                for t in range(4):
                    tok = torch.as_tensor(toks[None, S + t: S + t + 1], device="cuda")
                    lt, cache = model.decode_step(params, cache, tok, S + t, max_seq,
                                                  memory=memory)
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
                "max_seq": max_seq, "ring_caches": _ring_layers(cfg, max_seq),
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


def k5_bound(B, S, H, K, h, elem=2, causal=True, T=None, q_offset=0, window=0):
    """(ms, by): q and o (B, S, H, h), k and v (B, T, K, h) moved once (with
    a window, only the keys some query sees); 2 products of 2 h flops per
    visible (query, key) pair: S q_offset + S (S + 1) / 2 of them under the
    causal mask (query row i at position q_offset + i, T = q_offset + S),
    min(q_offset + i + 1, window) for row i under a window, S T without a
    mask."""
    T = S + q_offset if T is None else T
    if window:
        pairs = sum(min(q_offset + i + 1, window) for i in range(S))
        T = min(T, S + window - 1)
    else:
        pairs = S * q_offset + S * (S + 1) // 2 if causal else S * T
    nbytes = (2 * B * S * H * h + 2 * B * T * K * h) * elem
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


def k7_bound(B, S, H, h, elem=2, carried=False):
    """(ms, by): r/k/v (``elem`` bytes), logw, u, o, s_final (f32) and, when
    ``carried``, s0 (f32) once;
    the function's least work, the fewest ``k7_ops`` over tiles of 1 to 64
    (the pair term grows with the tile, the state updates shrink with it),
    f32 on the CUDA cores, so at their peak."""
    nbytes = 3 * B * S * H * h * elem + 2 * B * S * H * h * 4 + H * h * 4 + B * H * h * h * 4
    nbytes += B * H * h * h * 4 if carried else 0
    ops = min(k7_ops(S, h, tile) for tile in range(1, min(S, 64) + 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, B * H * ops / PEAK_OPS_PER_S["f32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mixtral_timing_cases(lm_counts, train_counts) -> list:
    """``lm_timing_phase``'s cases for Mixtral-8x7B, (mode, arch, B, S, T, H,
    K, h, causal, launches, window, q_offset): under its window of 4,096 at
    the served prompts of 509 (the window past every key), 4,097 and 8,192
    (where it bites), each with the served launches of the prompts nearest
    it (up to 4,096 tokens, to 8,191, from 8,192; K5 launch keys carry S
    third), and at its train shape (B 4 x S 512)."""
    H, K, h, window = MIXTRAL_ATTENTION
    served = lm_counts["mixtral-8x7b"]["K5"][1]
    cases = []
    for S, lo, hi in ((509, 0, window), (window + 1, window + 1, 2 * window - 1),
                      (2 * window, 2 * window, None)):
        n = sum(c for key, c in served.items()
                if key[2] >= lo and (hi is None or key[2] <= hi))
        cases.append(("prefill", "mixtral-8x7b", 1, S, S, H, K, h, True, n, window, 0))
    return cases + [("train", "mixtral-8x7b", 4, 512, 512, H, K, h, True,
                     train_counts["mixtral-8x7b"]["K5"], window, 0)]


def k5_timing(torch, np, report, rng, cases) -> list:
    """K5 timed at each of ``cases``, (mode, arch, B, S, T, H, K, h, causal,
    launches, window, q_offset), bf16, inputs drawn from ``rng``: event ms,
    device ms, plain ms, SDPA's (causal or not as K5; at an offset or under
    a window that bites, the same mask as a boolean ``attn_mask``), the
    bound; a timing line and a kernels-line entry each."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref, visible

    entries = []
    for mode, arch, B, S, T, H, K, h, causal, launches, window, off in cases:
        q = torch.as_tensor(rng.standard_normal((B, S, H, h)), dtype=torch.bfloat16,
                            device="cuda")
        k, v = (torch.as_tensor(rng.standard_normal((B, T, K, h)), dtype=torch.bfloat16,
                                device="cuda") for _ in range(2))
        kern = lambda: flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
        plain = lambda: attention_ref(q, k, v, causal=causal, window=window, q_offset=off)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if off or (window and window < T):
            # SDPA's is_causal aligns the mask top-left and has no window:
            # the same mask as a tensor
            mask = visible(S, T, causal=causal, window=window, q_offset=off, device="cuda")
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True)
            lib_name = ("F.scaled_dot_product_attention(attn_mask=the "
                        + ("offset " if off else "") + ("windowed " if window else "")
                        + "causal mask")
        else:
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                             enable_gqa=True)
            lib_name = f"F.scaled_dot_product_attention(is_causal={causal}"
        err = float((kern().float() - plain().float()).abs().max())
        t = _times(torch, kern, plain, library)
        bms, bby = k5_bound(B, S, H, K, h, causal=causal, T=T, q_offset=off, window=window)
        at = (f" at offset {off}" if off else "") + (f", window {window}" if window else "")
        report.emit({"phase": "timing", "kernel": "K5", "arch": arch, "mode": mode,
                     "shape": f"B={B} S={S} T={T} H={H} K={K} h={h} causal={causal} "
                              f"window={window} q_offset={off} bf16",
                     "launches": launches, "max_abs_err": err, "bound_ms": bms,
                     "bound_by": bby, "library": f"{lib_name}, enable_gqa), bf16", **t})
        row = "a row's span" if B == 1 else "a row's"  # batch 1: the sequence split
        over = "" if causal else f" over T={T}, no mask"  # an enc-dec's encoder or cross
        entries.append({
            "name": (f"K5 flash_fwd_bf16 [{arch} train attention, B={B} S={S}{at}, "
                     f"H={H} K={K} h={h}]"
                     if mode == "train" else
                     f"K5 flash_fwd_bf16 [{arch} sharded prefill attention, {row} B={B} "
                     f"S={S}{at}{over}, a coordinate's H={H} K={K} h={h}]"
                     if mode == "sharded prefill" else
                     f"K5 flash_fwd_bf16 [{arch} sharded train attention, {row} B={B} "
                     f"S={S}{at}{over}, a coordinate's H={H} K={K} h={h}]"
                     if mode == "sharded train" else
                     f"K5 flash_fwd_bf16 [{arch} prefill attention, S={S}{at}, H={H} K={K} "
                     f"h={h}]"
                     if mode == "prefill" else
                     f"K5 flash_fwd_bf16 [{arch} {mode} attention, B={B} S={S} T={T}, "
                     f"{'causal' if causal else 'no mask'}]"),
            "route": "cuda", "source": "src/repro_torch/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash/kernel.py:28",
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bms, "bound_by": bby,
            "library_ms": t["library_ms"], "device_ms": t["device_ms"]})
    return entries


def lm_timing_phase(torch, np, report, lm_counts, train_counts, encdec_k5,
                    serve_keys, train_keys, demo_k5) -> list:
    """K5 and K7 at the served shapes (bf16, B=1, S 128 / 512 / 1000; K5
    also at RecurrentGemma-9B's, Qwen2-MoE's, Llama-3-8B's and
    Nemotron-4-15B's, S 509, and at Seamless-M4T's batch of 4 at 1,000
    frames: the encoder's and the cross-attention's, without the mask, and
    the decoder's), K5 at Llama's train shape (B 8, S 512), at Gemma3-1B's
    and Mixtral-8x7B's (``mixtral_timing_cases``) under their windows, and
    K5 at each shape the sharded prefills gave it (a data row's rows and a
    model coordinate's heads), and likewise at each shape the sharded train
    steps gave it, a batch-1 span at its query offset among them
    (``k5_timing``).  ``encdec_k5``: K5's launches by key in the served
    enc-dec batches; ``serve_keys`` and ``train_keys``: K5's and K7's
    launches by (arch,) + key in ``sharded_serve``'s prefills and
    ``sharded_train``'s steps; ``demo_k5``: K5's launches in
    ``examples_phase``'s run of ``examples/torch_serve_llm.py``
    (serve-demo-50m, h 32, timed at its longest prompt)."""
    from repro_torch.configs import base as cfgbase

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
    cases.append(("prefill", "serve-demo-50m", 1, 47, 47, 8, 4, 32, True, demo_k5))
    cases = [c + (0, 0) for c in cases]  # no window, query offset 0
    # Gemma3-1B's served prompt of 1,000 and train shape (B 4 x S 1,024): its
    # local layers under the window of 512, its global layers without (a
    # train step launches K5 on every layer alike)
    served = _k5_by_window(lm_counts["gemma3-1b"]["K5"][1])
    blocks = cfgbase.get_config("gemma3-1b").blocks()
    window = cfgbase.get_config("gemma3-1b").window
    for w, n in ((window, blocks.count("local")), (0, blocks.count("attn"))):
        cases.append(("prefill", "gemma3-1b", 1, 1000, 1000, 4, 1, 256, True, served[w], w, 0))
        cases.append(("train", "gemma3-1b", 4, 1024, 1024, 4, 1, 256, True,
                      train_counts["gemma3-1b"]["K5"] * n // len(blocks), w, 0))
    cases += mixtral_timing_cases(lm_counts, train_counts)
    for mode, by_key in (("sharded prefill", serve_keys["K5"]),
                         ("sharded train", train_keys["K5"])):
        cases += [(mode, key[0], *key[2:9], n, key[9], key[11])
                  for key, n in sorted(by_key.items(), key=lambda kv: str(kv[0]))]
    entries = k5_timing(torch, np, report, rng, cases)
    sharded_k7 = [(mode, key, n) for mode, by_key in (("sharded prefill", serve_keys["K7"]),
                                                      ("sharded train", train_keys["K7"]))
                  for key, n in sorted(by_key.items(), key=lambda kv: str(kv[0]))]
    return entries + k7_timing_phase(torch, np, report, rng, k7_launches, sharded_k7)


def k7_timing_phase(torch, np, report, rng, k7_launches, sharded=()) -> list:
    """K7 at the served shapes (bf16, B=1, H=64, ``K7_TIMING_SEQS``), each
    kernel of the call by name, and at each shape the sharded phases gave
    it (``sharded``: [(mode, key, launches)], a data row's rows and a model
    coordinate's heads)."""
    from repro_torch.kernels.wkv import kernel as wkv_kernel
    from repro_torch.kernels.wkv.ops import chunk_for, wkv
    from repro_torch.kernels.wkv.ref import wkv_chunked

    cases = [("prefill", 1, S, 64, k7_launches, False) for S in K7_TIMING_SEQS]
    # one row a (mode, shape): the bf16 and f32 sharded runs' launches summed
    merged = {}
    for mode, key, n in sharded:
        at = (mode, key[2], key[3], key[4], key[8])
        merged[at] = merged.get(at, 0) + n
    cases += [(mode, B, S, H, n, carried) for (mode, B, S, H, carried), n in merged.items()]
    entries = []
    for mode, B, S, H, launches, carried in cases:
        r, k, v, logw, u = _wkv_inputs(torch, np, rng, B, S, H, 64, torch.bfloat16)
        s0 = (torch.as_tensor(rng.standard_normal((B, H, 64, 64)), dtype=torch.float32,
                              device="cuda") if carried else None)
        c = chunk_for(S, 64)
        kern = lambda: wkv(r, k, v, logw, u, chunk=64, s0=s0)
        plain = lambda: wkv_chunked(r, k, v, logw, u, s0, chunk=c)
        err = float((kern()[0] - plain()[0]).abs().max())
        t = _times(torch, kern, plain, None)
        bms, bby = k7_bound(B, S, H, 64, carried=carried)
        report.emit({"phase": "timing", "kernel": "K7", "kernels": K7_KERNELS, "mode": mode,
                     "shape": f"B={B} S={S} H={H} h=64 chunk={c} tile={wkv_kernel.TILE} "
                              f"s0={carried} bf16",
                     "launches": launches, "max_abs_err": err, "bound_ms": bms,
                     "bound_by": bby, "library": "no library call", **t,
                     "device_ms_by_kernel": device_ms_by_kernel(torch, kern)})
        where = (f"prefill time-mix, S={S}" if mode == "prefill" else
                 f"{mode} time-mix, a row's B={B} S={S}, a coordinate's H={H}"
                 + (", from a carried state" if carried else ""))
        entries.append({
            "name": (f"K7 wkv_fwd_bf16 ({' + '.join(K7_KERNELS)}) [rwkv6-7b {where}, "
                     f"chunk={c}, tile={wkv_kernel.TILE}]"),
            "route": "cuda", "source": "src/repro_torch/csrc/wkv_fwd.cu",
            "replaces": "src/repro/kernels/wkv/kernel.py:19", "launches": launches,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bms, "bound_by": bby, "library_ms": None,
            "device_ms": t["device_ms"]})
    return entries


# A plain version slower than this a call (K7's plain scan in chunks of 1,
# thousands of launches a call) is timed over 2 calls and not profiled
# (tracing it takes the profiler ~10 s a call); the others over 5 calls and
# profiled over 3.
PLAIN_SLOW_MS = 100.0


def _times(torch, kern, plain, library):
    """CUDA-event ms and profiler device ms of a kernel, its plain version
    and (when there is one) a library call."""
    slow = event_ms(torch, plain, iters=1, warmup=1) > PLAIN_SLOW_MS
    t = {"ms": event_ms(torch, kern, iters=50, warmup=5),
         "plain_ms": event_ms(torch, plain, iters=2 if slow else 5, warmup=0),
         "device_ms": device_ms(torch, kern, iters=20),
         "plain_device_ms": None if slow else device_ms(torch, plain, iters=3)}
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
    # a data row's rows (and a microbatch's) of Llama-3.2-1B's, Qwen2-MoE's,
    # RWKV6-7B's and RecurrentGemma-9B's train batches in sharded_train and
    # the 2-microbatch steps, at the train shapes' D and V; split in
    # K6_PART_BLOCKS, they are the vocab blocks sharded_train gives K6's
    # partial form
    (2048, 2048, 128256, 0.0, None),
    (1024, 2048, 151936, 0.0, None),
    (1024, 4096, 65536, 0.0, None),
    (1024, 4096, 256000, 0.0, None),
    # Seamless-M4T-large-v2's batch-1 train sequence of 512 tokens split over
    # 2 data rows (d 1,024, its untied V 256,208): a row's span of 256
    (256, 1024, 256208, 0.0, None),
    # Gemma3-1B's tied table (d 1,152: 18 of K6's 64-deep stages, V 262,144:
    # 2,048 vocab tiles): lm_train's B 4 x S 1,024, and a data row's tokens
    # in sharded_train, B 4 x S 1,024 over 2 rows and 1 x 2,048 split on the
    # sequence (their blocks in K6_PART_BLOCKS)
    (4096, 1152, 262144, 0.0, None),
    (2048, 1152, 262144, 0.0, None),
    (1024, 1152, 262144, 0.0, None),
    # examples/torch_train_llm.py's microbatch: 4 x 128 tokens, d 128, tied V 512
    (512, 128, 512, 0.0, None),
    # Mixtral-8x7B's train shape: B 4 x S 512 tokens, d 4,096, untied V 32,000
    # (250 vocab tiles)
    (2048, 4096, 32000, 0.0, None),
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
# microbatches=2 step splits a batch without tokens.  Gemma3-1B at full
# depth (1.0 B params: AdamW's 16 GB fit), B 4 x S 1,024 so its window of
# 512 bites: K5 26 forward + 26 recompute, K6 at V 262,144 on the tied table.
TRAIN_RUNS = {
    "llama3.2-1b": (20, None, 8, 512, 4, True, {"K5": 32, "K6": 1}),
    "rwkv6-7b": (21, 2, 4, 512, 2, False, {"K7": 4, "K6": 1}),
    "recurrentgemma-9b": (22, 3, 4, 512, 2, False, {"K5": 2, "K6": 1}),
    "qwen2-moe-a2.7b": (23, 2, 4, 512, 2, False, {"K5": 4, "K6": 1}),
    "qwen2-vl-7b": (24, 2, 4, 512, 2, True, {"K5": 4, "K6": 1}),
    "gemma3-1b": (26, None, 4, 1024, 2, False, {"K5": 52, "K6": 1}),
    # Mixtral-8x7B at full width, 1 of 32 layers (1.713 B params, ~27.4 GB
    # under AdamW; 8 experts of 14,336): K5 1 + 1 under the window of 4,096,
    # K6 at V 32,000 untied
    "mixtral-8x7b": (27, 1, 4, 512, 2, False, {"K5": 2, "K6": 1}),
}
# train_strict: (arch, seed, layers, seq) at f32 compute, batch 2; Gemma3-1B
# one whole 5:1 group on sequences past its window
TRAIN_STRICT = (("llama3.2-1b", 30, 2, 256), ("rwkv6-7b", 31, 2, 256),
                ("recurrentgemma-9b", 32, 3, 256), ("qwen2-moe-a2.7b", 33, 2, 256),
                ("qwen2-vl-7b", 34, 2, 256), ("gemma3-1b", 35, 6, 640))
# remat_dots: Llama-3.2-1B's train cell, one step's loss and gradients under
# each policy from the same params and batch: losses within
# REMAT_DOTS_LOSS_RTOL (the same forward: "dots" keeps the matmul outputs
# that "block" computes again in the backward)
REMAT_DOTS_LOSS_RTOL = 1e-6


def _xent_inputs(torch, seed, N, D, V, w_std=None):
    """x ~ N(0, 1) (N, D), w (V, D) of std ``w_std`` (1/sqrt(D) if None),
    f32, and int32 targets with 0, V - 1 and an id inside the last
    (partial) vocab tile among them, drawn on the card from a generator
    seeded with ``seed`` (a vocabulary's weights drawn on the host take
    seconds a hundred million)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device="cuda")
    w = torch.randn((V, D), generator=gen, device="cuda") * (w_std or D ** -0.5)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda", dtype=torch.int32)
    last_tile = (V - 1) // 128 * 128
    t[:3] = torch.tensor([0, V - 1, last_tile + (V - 1 - last_tile) // 2], dtype=torch.int32)
    return x, w, t


def k6_checks(torch, report) -> None:
    """K6 against its plain version (``seq_chunked_xent``) on K6_CASES, at the
    automatic split count and (small cases) at one split, per token within
    K6_RTOL |plain| + K6_ATOL + K6_EPS_UNITS eps M, each case's inputs
    drawn by ``_xent_inputs``."""
    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent.kernel import K6_LAUNCHES, fused_xent_fwd, split_count

    eps = torch.finfo(torch.float32).eps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, part_rows = [], []
    for ci, (N, D, V, cap, w_std) in enumerate(K6_CASES):
        x, w, t = _xent_inputs(torch, 6000 + ci, N, D, V, w_std)
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
        part_rows += [_k6_part_case(torch, x, w, t, cap, want, M, n) for n in K6_PART_BLOCKS]
        del x, w, t, want
    report.emit({"phase": "k6_vs_plain", "route": K6_ROUTE, "checks": len(rows),
                 "worst_eps_of_M": max(r["eps_of_M"] for r in rows), "cases": rows,
                 "rtol": K6_RTOL, "atol": K6_ATOL, "allowed_eps_of_M": K6_EPS_UNITS,
                 "bounds_ms": {f"N={N} D={D} V={V}": {
                     "route": k6_bound(N, D, V)[0],
                     "f32_cuda_core": k6_f32_bound_ms(N, D, V)}
                     for N, D, V in K6_TRAIN_SHAPES.values()}})
    report.emit({"phase": "k6_part_vs_plain", "checks": len(part_rows),
                 "worst_eps_of_M": max(r["worst_eps_of_M"] for r in part_rows),
                 "rtol": K6_RTOL, "atol": K6_ATOL, "allowed_eps_of_M": K6_EPS_UNITS,
                 "cases": part_rows})


# K6's partial form: each K6_CASES vocabulary split in this many blocks
K6_PART_BLOCKS = (2, 4)


def k6_held(sms: int) -> set:
    """The K6 launch keys (entry, N, D, V, splits, softcap) that
    ``k6_checks`` holds against the plain version on a card of ``sms``
    SMs: each K6_CASES shape whole at its automatic split count (and one
    split where N <= 1,024), and each of its K6_PART_BLOCKS vocab blocks in
    the partial form at the block's automatic split count."""
    from repro_torch.kernels.xent.kernel import split_count

    held = set()
    for N, D, V, cap, _ in K6_CASES:
        for splits in {split_count(N, V, sms), *((1,) if N <= 1024 else ())}:
            held.add(("xent_fwd_f32", N, D, V, splits, float(cap)))
        for n in K6_PART_BLOCKS:
            for c in range(n):
                vb = (c + 1) * V // n - c * V // n
                held.add(("xent_part_f32", N, D, vb, split_count(N, vb, sms), float(cap)))
    return held


def k6_unheld(by_key) -> list:
    """K6's launch keys (entry, N, D, V, splits, softcap) at a shape and
    grid ``k6_checks`` does not hold."""
    import torch

    held = k6_held(torch.cuda.get_device_properties(0).multi_processor_count)
    return [k for k in by_key if tuple(k[:6]) not in held]


def _k6_part_case(torch, x, w, t, cap, want, M, n_blocks) -> dict:
    """K6's partial form on ``n_blocks`` contiguous vocab blocks of ``w``:
    each block's (lse, t) against ``xent_block_ref`` within K6's gate (M of
    the block's rows), one launch a call, and their combine,
    logsumexp(lse) - sum(t), against the whole-vocab plain CE ``want``
    within the gate of the whole vocab's ``M``.  Raises on a miss; returns
    the case's record."""
    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent.kernel import K6_LAUNCHES, fused_xent_part

    eps = torch.finfo(torch.float32).eps
    N, D = x.shape
    V = w.shape[0]
    worst, lses, ts = 0.0, [], []
    for c in range(n_blocks):
        v0, v1 = c * V // n_blocks, (c + 1) * V // n_blocks
        wb = w[v0:v1]
        before = K6_LAUNCHES.count
        lse, tt = fused_xent_part(x, wb, t - v0, softcap=cap)
        launches = K6_LAUNCHES.count - before
        with torch.no_grad():
            p_lse, p_t = (a[0] for a in xent_ref.xent_block_ref(x[None], wb, t[None], v0,
                                                               softcap=cap))
        Mb = x.norm(dim=1) * wb.norm(dim=1).max()
        for got, plain in ((lse, p_lse), (tt, p_t)):
            diff = (got - plain).abs()
            worst = max(worst, float((diff / (eps * Mb)).max()))
            if launches != 1 or not bool((diff <= K6_RTOL * plain.abs() + K6_ATOL
                                          + K6_EPS_UNITS * eps * Mb).all()):
                raise AssertionError(f"K6 part {(N, D, V, cap)} block [{v0}, {v1}): "
                                     f"{launches} launches, max abs err {float(diff.max())}")
        lses.append(lse)
        ts.append(tt)
    ce = torch.logsumexp(torch.stack(lses), dim=0) - torch.stack(ts).sum(dim=0)
    diff = (ce - want).abs()
    units = float((diff / (eps * M)).max())
    if not bool((diff <= K6_RTOL * want.abs() + K6_ATOL + K6_EPS_UNITS * eps * M).all()):
        raise AssertionError(f"K6 part {(N, D, V, cap)} in {n_blocks} blocks: combined CE "
                             f"max abs err {float(diff.max())} ({units:.2f} eps M)")
    return {"N": N, "D": D, "V": V, "softcap": cap, "blocks": n_blocks,
            "combined_max_abs_err": float(diff.max()), "combined_eps_of_M": units,
            "worst_eps_of_M": max(worst, units)}


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
    layers if given, an enc-dec's encoder too), ``xent_impl="chunked"``,
    remat on, f32 params from a seeded generator on the card (never stored
    in the compute dtype)."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.models.transformer import Model

    changes = {} if layers is None else {"num_layers": layers}
    if layers is not None and cfgbase.get_config(arch).is_encdec:
        changes["encoder_layers"] = layers
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

    for arch, seed, layers, seq in TRAIN_STRICT:
        model, params_k, cfg = _train_model(torch, arch, seed, layers, "float32")
        _, params_p, _ = _train_model(torch, arch, seed, layers, "float32")
        pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq,
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
                     "compute_dtype": "float32", "tf32": False, "batch": 2, "seq": seq,
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


# sharded_train: train cells (TRAIN_RUNS) through jit_train_step, beside the
# unsharded step with 2 microbatches (what a data axis of 2 computes) from
# the same seeded weights and token-pipeline batches: SHARDED_STEPS + 1 steps
# each way (Llama's last unsharded and (2, 2) step under the profiler, for
# the idle share).  Llama-3.2-1B on ("data", "model") =
# (2, 1) (each data row's whole model on its card: the same sums as the
# unsharded step, so step 1's loss bit-equal, the later ones within
# SHARDED_LOSS_RTOL, the global norm adding its parts in another order, and
# the f64 norm of every param and moment leaf within SHARDED_NORM_RTOL) and
# on (2, 2), tensor parallel: attention on each model coordinate's heads, the
# MLP on its d_ff slice, the embedding on its vocab block; the partial outputs
# summed in f32 in coordinate order round differently from the whole
# products, so the losses within SHARDED_TP_LOSS_RTOL and the leaf norms
# within SHARDED_TP_NORM_RTOL (about 3x and 2x the largest gaps of the
# reduced Llama in bf16 on a CPU (2, 2) mesh, 3 seeds, 3 steps: 1.40e-4 and
# 4.97e-3, tests/test_torch_tp_train.py::test_bf16_gaps_within_the_chip_limits).
# Qwen2-MoE-A2.7B's train cell (2 layers) on (2, 2): the experts' and the
# shared expert's d_ff split, the routing and aux loss once a data row; the
# losses within SHARDED_MOE_LOSS_RTOL, every leaf norm within
# SHARDED_MOE_NORM_RTOL, and each data row's aux loss, from the first batch
# through RowOps, within SHARDED_MOE_AUX_RTOL of the unsharded forward's on
# the same rows (3x the reduced config's 2.70e-4, 1.05e-1 and 1.08e-3; the
# widest leaf gaps are the attention biases', which start at zero, and the
# unsharded bf16 step is further from an f32 step than the split one:
# test_bf16_moe_leaf_gaps_are_bf16_rounding).  RWKV6-7B's train cell (2
# layers) and RecurrentGemma-9B's (3) on (2, 2): the time-mix on each
# coordinate's heads, the channel-mix on its d_ff slice, the RG-LRU on its
# channels; losses within SHARDED_RWKV_LOSS_RTOL / SHARDED_RG_LOSS_RTOL, 3x
# the reduced configs' largest gaps in bf16 over 3 seeds (RWKV 3.94e-4,
# RecurrentGemma 1.47e-4).  RecurrentGemma's largest leaf-norm gap within
# SHARDED_RG_NORM_RTOL (3x 1.56e-2).  RWKV's bf16 gradients are rounding at
# many leaves (the reduced config's first-step bf16 gradient is 13-119% of
# the f32 one away from it at its noisiest leaf, by seed), so one leaf's
# bf16 gap says nothing: its median leaf-norm gap is gated, within
# SHARDED_RWKV_MEDIAN_NORM_RTOL (3x 5.27e-3), its widest recorded by name;
# and the same 3 steps at f32 compute, (2, 2) against the unsharded step,
# hold the losses within SHARDED_F32_LOSS_RTOL and every param / m / v
# leaf's norm within the larger of SHARDED_F32_NORM_RTOL and
# SHARDED_F32_PROBE_FACTOR times the widest gap the unsharded f32 step
# shows against itself run at 1 microbatch (the same sums in another order:
# at full width the decay LoRA's and bonus_u's v move by 7.2e-4 under the
# split's reordering, against 1.68e-5 at most on the reduced config).  The
# floors are the CPU sharded tests' LEAF_TOL and LOSS_RTOL (the reduced
# RWKV reads 1.63e-7 at most); a leaf whose update is lost reads 1.
SHARDED_STEPS = 2
SHARDED_LOSS_RTOL = 1e-5
SHARDED_NORM_RTOL = 1e-6
SHARDED_TP_LOSS_RTOL, SHARDED_TP_NORM_RTOL = 4.2e-4, 1e-2
SHARDED_RWKV_LOSS_RTOL, SHARDED_RWKV_MEDIAN_NORM_RTOL = 1.2e-3, 1.6e-2
SHARDED_RG_LOSS_RTOL, SHARDED_RG_NORM_RTOL = 4.4e-4, 4.7e-2
# (loss limit, leaf-norm limit, the leaf-norm gap it holds: the widest or the median)
SHARDED_TP_LIMITS = {"llama3.2-1b": (SHARDED_TP_LOSS_RTOL, SHARDED_TP_NORM_RTOL, "max"),
                     "rwkv6-7b": (SHARDED_RWKV_LOSS_RTOL, SHARDED_RWKV_MEDIAN_NORM_RTOL,
                                  "median"),
                     "recurrentgemma-9b": (SHARDED_RG_LOSS_RTOL, SHARDED_RG_NORM_RTOL, "max"),
                     # Gemma3-1B's CPU bf16 readings on (2, 2) over 3 seeds
                     # (tests/torch_precision_readings.py): losses 1.15e-4,
                     # leaf norms 6.69e-3; 3x them, rounded up
                     "gemma3-1b": (3.5e-4, 2.1e-2, "max")}
SHARDED_F32_ARCHS = ("rwkv6-7b",)
SHARDED_F32_LOSS_RTOL, SHARDED_F32_NORM_RTOL, SHARDED_F32_PROBE_FACTOR = 1e-5, 1e-4, 3.0
SHARDED_MOE_LOSS_RTOL, SHARDED_MOE_NORM_RTOL, SHARDED_MOE_AUX_RTOL = 8.1e-4, 3.2e-1, 3.2e-3
# pipeline: 2 stages of 2 tanh dense layers (D x D, f32) over cuda:0, M
# microbatches of B rows, against the sequential stack
PIPE_D, PIPE_M, PIPE_B, PIPE_TOL = 2048, 8, 4, 1e-5


def _sharded_mesh(torch, model=2):
    """("data", "model") = (2, ``model``) over distinct cards when there are
    that many, else cuda:0 repeated."""
    from repro_torch.launch.mesh import make_mesh

    n = 2 * model
    devices = ([torch.device("cuda", i) for i in range(n)] if torch.cuda.device_count() >= n
               else [torch.device("cuda", 0)])
    return make_mesh((2, model), ("data", "model"), devices=devices)


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


def _rel_errs(a, b) -> list:
    return [abs(x - y) / abs(y) if y else abs(x) for x, y in zip(a, b)]


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


@contextlib.contextmanager
def _counting_gathers(params):
    """Inside, ``pl.gather`` counts its calls by the param leaf it gathers
    (its tree path); yields the dict it fills."""
    from repro_torch.sharding import placement as pl
    from repro_torch.tree import flatten_with_paths

    paths = {id(x): "/".join(map(str, p)) for p, x in flatten_with_paths(params)}
    counts, real = {}, pl.gather

    def counting(x, *args, **kw):
        if id(x) in paths:
            counts[paths[id(x)]] = counts.get(paths[id(x)], 0) + 1
        return real(x, *args, **kw)

    pl.gather = counting
    try:
        yield counts
    finally:
        pl.gather = real


def _device_batch(pipe, step, frames=None):
    """The token pipeline's batch ``step`` on the card; with ``frames`` (T,
    D), an enc-dec's ``src_embeds`` (B, T, D) ~ N(0, 1) beside it, f32,
    drawn on the card from the pipeline's seed and the step (the audio
    frontend is a stub: precomputed frame embeddings)."""
    import torch

    from repro_torch.data import tokens as tok

    batch = tok.device_batch(pipe, step, "cuda")
    if frames is not None:
        gen = torch.Generator("cuda").manual_seed(1000 * pipe.seed + step)
        batch["src_embeds"] = torch.randn((pipe.global_batch, *frames), generator=gen,
                                          device="cuda")
    return batch


def _k5_layers(cfg) -> int:
    """The attention layers that run K5 in a prefill or a train forward:
    the decoder's, and an enc-dec's encoder layers and cross sub-blocks."""
    n = sum(kind in ("attn", "swa", "local") for kind in cfg.blocks())
    return n + (cfg.encoder_layers + cfg.num_layers if cfg.is_encdec else 0)


def _train_drive(torch, np, name, step_fn, params, state, pipe, want, profile,
                 steps=SHARDED_STEPS + 1, frames=None):
    """``steps`` steps of ``step_fn`` on the pipeline's batches (an enc-dec's
    frames beside them: ``_device_batch``), every
    launch counter set to 0 just before each, the last under the profiler
    when ``profile`` (else timed as the others); raises unless each step's
    launches are ``want`` and its loss finite.  Returns (params, state, the
    run's record, {"K5", "K6", "K7": launches by key})."""
    counters = _counters()
    cards = range(torch.cuda.device_count())
    _sync_all(torch)
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    ms, losses, launches, by_key = [], [], [], {"K5": {}, "K6": {}, "K7": {}}
    for s in range(steps):
        batch = _device_batch(pipe, s, frames)
        _sync_all(torch)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        profiling = profile and s == steps - 1
        if not profiling:
            params, state, m = step_fn(params, state, batch)
        else:
            (params, state, m), by, busy, span, top = _profile_step(
                torch, lambda: step_fn(params, state, batch))
        _sync_all(torch)
        if not profiling:
            ms.append(1e3 * (time.perf_counter() - t0))
        counts = {k: c.count for k, c in counters.items()}
        for kernel, keys in by_key.items():
            for key, n in counters[kernel].by_key.items():
                keys[key] = keys.get(key, 0) + n
        losses.append(float(m["loss"]))
        launches.append(counts)
        if counts != want or not np.isfinite(losses[-1]):
            raise AssertionError(f"sharded_train {name} step {s + 1}: launches "
                                 f"{counts}, want {want}; loss {losses[-1]}")
    fastest = min(ms)  # the first step of a cold process also warms up
    rec = {"losses": losses, "step_ms": ms, "step_ms_min": fastest,
           "launches_per_step": launches[0],
           "max_memory_allocated": torch.cuda.max_memory_allocated(0),
           "max_memory_allocated_by_card": {
               f"cuda:{i}": torch.cuda.max_memory_allocated(i) for i in cards}}
    if profile:
        rec["profiled_step"] = {"busy_ms": busy, "span_ms": span,
                                "idle_share": 1 - busy / fastest, "k5_ms": by["flash_fwd"],
                                "k6_ms": by["xent_fwd"], "top_kernels": top}
    return params, state, rec, by_key


def _sharded_run(torch, np, name, model, initial, pipe, sizes_model, want, B, S, profile,
                 steps=SHARDED_STEPS + 1, frames=None):
    """``jit_train_step`` on ``_sharded_mesh(model=sizes_model)`` from the
    CPU copy ``initial``, ``steps`` steps: (params, state, step, the run's
    record with its gathers by leaf, bytes a coordinate and copies across
    cards, {"K5", "K6", "K7": launches by key})."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.train import adamw_config
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train.step import TrainStepConfig, jit_train_step
    from repro_torch.tree import leaves

    mesh = _sharded_mesh(torch, sizes_model)
    policy = ShardingPolicy(mesh, model.cfg)
    step = jit_train_step(model, policy, inp.abstract_params(model),
                          TrainStepConfig(adamw=adamw_config(SHARDED_STEPS + 1)),
                          batch_specs=policy.batch_specs(cfgbase.ShapeConfig("train", S, B,
                                                                             "train")))
    params = reshard_tree(initial, step.param_shardings)
    with _counting_gathers(params) as gathers:
        params, state, rec, k5 = _train_drive(torch, np, name, step, params,
                                              step.init_opt_state(), pipe, want, profile,
                                              steps, frames)
    trees = (params, state.m, state.v)
    several, unequal = _copies_disagree(torch, trees)
    by_coord = _coordinate_bytes(np, list(zip(trees, (step.param_shardings,
                                                      step.opt_state_shardings.m,
                                                      step.opt_state_shardings.v))), mesh)
    by_card = {}
    for x in leaves(params) + leaves(state.m) + leaves(state.v):
        for dev, n in x.device_bytes().items():
            by_card[str(dev)] = by_card.get(str(dev), 0) + n
    rec.update({"mesh": {"shape": mesh.shape, "devices": [str(d) for d in mesh.devices.flat]},
                "sequence_split": step.split_seq,
                "gathers_by_leaf": gathers, "blocks_on_several_cards": several,
                "blocks_with_unequal_copies": unequal,
                "bytes_by_coordinate_held_vs_specs": by_coord, "bytes_by_card": by_card,
                "placements_kept": all(x.sharding == sh for x, sh in
                                       zip(leaves(params), leaves(step.param_shardings)))})
    return params, state, step, rec, k5


# sharded_train at batch 1: (sequence length, model axes, steps, frames,
# (seed, layers) of a cell with no batch split, else None) a run.  The
# batch specs split the sequence over the 2 data rows: each row its span of
# S / 2 positions (K5 at the span's query offset over the rows' K/V, K7 and
# the RG-LRU from the state the row before left, the MoE router from its
# slot counts), beside the unsharded step at microbatches=1 on the same
# tokens and held to each arch's (2, 2) limits, or SEQ_SPLIT_LIMITS' where
# the split's own readings need another.  Llama-3.2-1B's 4,096 tokens are the
# lm_train cell's in one sequence (2 steps a run, the second profiled).
# Seamless-M4T-large-v2 at full width, 2 + 2 of its 24 + 24 layers (AdamW's
# 16 B a parameter at full depth is ~37 GB beside the vocab's), bf16 compute,
# f32 params: 1 x 1,024 frames + 1 x 512 tokens, the frames split too (each
# data row encodes its 512, layer by layer over both rows' K/V).
# Gemma3-1B at 1 x 2,048: each data row's span of 1,024, the second row's
# local layers reading the first row's last 511 keys through the window.
SEQ_SPLIT_TRAIN = {"llama3.2-1b": (4096, (1, 2), 2, None, None),
                   "qwen2-moe-a2.7b": (2048, (2,), 2, None, None),
                   "rwkv6-7b": (2048, (2,), 2, None, None),
                   "recurrentgemma-9b": (2048, (2,), 2, None, None),
                   "seamless-m4t-large-v2": (512, (2,), 2, 1024, (25, 2)),
                   "gemma3-1b": (2048, (2,), 2, None, None)}
# sharded_train's cells in order: (arch, the model axes of its batch-split
# runs, none for a batch-1 cell alone)
SHARDED_TRAIN = (("llama3.2-1b", (1, 2)), ("qwen2-moe-a2.7b", (2,)), ("rwkv6-7b", (2,)),
                 ("recurrentgemma-9b", (2,)), ("seamless-m4t-large-v2", ()),
                 ("gemma3-1b", (2,)))
# sharded_train's depth where it cuts an lm_train cell's (each trains whole
# in lm_train): Gemma3-1B at full width, 6 of its 26 layers, one whole 5:1
# group (both layer kinds and both RoPE thetas); Llama-3.2-1B 4 of its 16,
# to keep the run's time within its bound as archs were added
SHARDED_LAYERS = {"gemma3-1b": 6, "llama3.2-1b": 4}
# Llama-3.2-1B at batch 1: the joined K/V's gradient takes a bf16 rounding a
# row (each row's attention VJP rounds its share, then they are summed),
# which the batch split does not have.  Its CPU bf16 readings at 1 x 128 over
# 3 seeds, on (2, 2) against the unsharded step, 3 steps
# (tests/torch_precision_readings.py): losses 3.40e-4, leaf norms 7.01e-3;
# the limits are 3x them, as SHARDED_TP_* are 3x the batch split's (its
# first card reading: losses 1.25e-5, leaf norms 1.41e-2, over the batch
# split's 1e-2).  The other archs' readings are within their (2, 2) limits.
# Seamless-M4T-large-v2 (2 + 2 layers; no batch-split cell to borrow
# limits from): its CPU bf16 readings at 1 x 128 tokens beside 256 frames
# over 3 seeds, on (2, 2) against the unsharded step, 3 steps
# (tests/torch_precision_readings.py): losses 2.39e-4, leaf norms 1.08e-2;
# 3x them, rounded up.
# Gemma3-1B (6 layers): its CPU bf16 readings of the split at 1 x 128 over 3
# seeds on (2, 2): losses 1.85e-4, leaf norms 7.09e-3 (the batch split's
# 6.69e-3); 3x them, rounded up.
SEQ_SPLIT_LIMITS = {"llama3.2-1b": (1.0e-3, 2.1e-2, "max"),
                    "seamless-m4t-large-v2": (7.2e-4, 3.3e-2, "max"),
                    "gemma3-1b": (5.6e-4, 2.2e-2, "max")}


def _seq_split_train(torch, np, arch, model, initial, per_step, adamw, seed, names,
                     keys_all, faults) -> dict:
    """The batch-1 runs of SEQ_SPLIT_TRAIN for one arch from the CPU copy
    ``initial``: the unsharded step at microbatches=1, then
    ``jit_train_step`` on each mesh, the sequence split over the data rows.
    Checks each run's losses and leaf norms at its arch's (2, 2) limits, its
    launches a step (K5 and K7 once a layer a coordinate a row, twice with
    remat; K6 once a row, its partial form on (2, 2)), K5 at the spans'
    offsets 0 and S / 2, K7 from a carried state on the second row, an
    enc-dec's frames split too (every encoder K5 launch on a row's half of
    the frames over all of them, none over the whole), and what
    ``_sharded_faults`` checks.  Returns the runs' records by name;
    adds their launch keys to ``keys_all`` and what they broke to
    ``faults``."""
    from repro_torch.data import tokens as tok
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, make_train_step
    from repro_torch.tree import tree_map

    cfg = model.cfg
    S, meshes, steps, T, _ = SEQ_SPLIT_TRAIN[arch]
    frames = None if T is None else (T, cfg.d_model)
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=1,
                                   seed=seed)
    profile = arch == "llama3.2-1b"  # the idle share, unsharded and on (2, 2)
    want_u = {k: 0 for k in _counters()}
    want_u.update(per_step)
    one = make_train_step(model, TrainStepConfig(microbatches=1, adamw=adamw))
    params = tree_map(lambda p: p.to("cuda", copy=True), initial)
    params, state, u, _ = _train_drive(torch, np, f"{arch} batch 1 unsharded", one, params,
                                       opt.init_state(params), pipe, want_u, profile, steps,
                                       frames)
    want_norms = _leaf_norms(torch, (params, state.m, state.v))
    del params, state
    torch.cuda.empty_cache()
    runs = {"batch1_unsharded": u}
    n_attn = _k5_layers(cfg)
    n_rwkv = sum(kind == "rwkv" for kind in cfg.blocks())
    if arch in SEQ_SPLIT_LIMITS:
        loss_rtol, norm_rtol, read = SEQ_SPLIT_LIMITS[arch]
    elif cfg.moe is not None:
        loss_rtol, norm_rtol, read = SHARDED_MOE_LOSS_RTOL, SHARDED_MOE_NORM_RTOL, "max"
    else:
        loss_rtol, norm_rtol, read = SHARDED_TP_LIMITS[arch]
    for n_model in meshes:
        name = f"batch1_sharded_2x{n_model}"
        # each data row its span: K5 / K7 a layer a coordinate a row, twice
        # with remat; K6 once a row (its partial form on each coordinate's block)
        want = dict(want_u, K5=n_attn * n_model * 2 * 2, K7=n_rwkv * n_model * 2 * 2,
                    K6=2 * n_model)
        params, state, step, rec, by_key = _sharded_run(
            torch, np, f"{arch} {name}", model, initial, pipe, n_model, want, 1, S,
            profile and n_model > 1, steps, frames)
        norm_rel = _rel_errs(_leaf_norms(torch, (params, state.m, state.v)), want_norms)
        loss_rel = _rel_errs(rec["losses"], u["losses"])
        gap = max(norm_rel) if read == "max" else float(np.median(norm_rel))
        carried = sum(n for k, n in by_key["K7"].items() if k[7])
        offsets = sorted({k[10] for k in by_key["K5"]})
        if frames is not None:  # the encoder: each row's half of the frames over all
            enc = sum(n for k, n in by_key["K5"].items() if k[1:4] == (1, T // 2, T)
                      and not k[7])
            rec["encoder_k5_split"] = enc
            rec["encoder_k5_whole"] = sum(n for k, n in by_key["K5"].items() if k[2] == T)
        rec.update({"loss_rel_err": loss_rel, "leaves_norm_checked": len(norm_rel),
                    "leaf_norm_max_rel_err": max(norm_rel),
                    "leaf_norm_median_rel_err": float(np.median(norm_rel)),
                    "leaf_norm_worst": sorted(zip(norm_rel, names), reverse=True)[:5],
                    "loss_rtol": loss_rtol, "norm_rtol": norm_rtol, "norm_gap_gated": read,
                    "k5_query_offsets": offsets, "k7_from_carried_state": carried,
                    "k5_shapes": sorted(str(k[1:7] + k[10:]) for k in by_key["K5"]),
                    "k7_shapes": sorted(str(k[1:6] + k[7:]) for k in by_key["K7"]),
                    "k6_launches_by_entry_and_shape": {str(k[:4]): n
                                                       for k, n in by_key["K6"].items()}})
        entry = "xent_fwd_f32" if n_model == 1 else "xent_part_f32"
        problems = _sharded_faults(cfg, rec, by_key)
        problems += [f"K7 at {k} outside K7_SHARDED" for k in k7_unheld(by_key["K7"])]
        if any(k[0] != entry for k in by_key["K6"]):
            problems.append(f"K6 {sorted(by_key['K6'])}, want {entry} alone")
        if not max(loss_rel) <= loss_rtol or not gap <= norm_rtol:
            problems.append("outside its limits")
        if not rec["sequence_split"] or (n_attn and offsets != [0, S // 2]):
            problems.append(f"not split on the sequence: offsets {offsets}")
        if carried != n_rwkv * n_model * 2 * steps:  # the second row's, twice with remat
            problems.append(f"K7 from a carried state {carried} times")
        if frames is not None and (rec["encoder_k5_whole"] or rec["encoder_k5_split"]
                                   != cfg.encoder_layers * n_model * 2 * 2 * steps):
            problems.append(f"encoder K5 {rec['encoder_k5_split']} on a row's frames, "
                            f"{rec['encoder_k5_whole']} on all of them")
        if problems:
            faults.append(f"{arch} {name}: {problems}; {rec['losses']} vs {u['losses']}, "
                          f"leaf norms {max(norm_rel)}")
        for kernel, keys in by_key.items():
            for key, n in keys.items():
                at = (arch,) + key
                keys_all[kernel][at] = keys_all[kernel].get(at, 0) + n
        runs[name] = rec
        del params, state, step
        torch.cuda.empty_cache()
    return runs


def k7_unheld(by_key) -> list:
    """K7's launch keys at a shape ``K7_SHARDED`` does not hold (with or
    without a carried state)."""
    held = {(B, S, H, h, h, carried) for B, S, H, h, carried in K7_SHARDED}
    return [k for k in by_key if (*k[1:6], k[7]) not in held]


def _sharded_faults(cfg, rec, by_key) -> list:
    """What a sharded run broke of the checks every run keeps: bytes a
    coordinate off their specs, placements, unequal copies across cards, a
    gathered leaf (none is: the loss runs K6's partial form on each model
    coordinate's vocab block), K5 at a shape ``k5_checks`` does not hold,
    K6 at a shape and grid ``k6_checks`` does not."""
    k5 = by_key["K5"]
    faults = [f"bytes off their specs at {k}" for k, v in
              rec["bytes_by_coordinate_held_vs_specs"].items() if v[0] != v[1]]
    if not rec["placements_kept"]:
        faults.append("placements not kept")
    if rec["blocks_with_unequal_copies"]:
        faults.append(f"{rec['blocks_with_unequal_copies']} blocks with unequal copies")
    faults += [f"{path} gathered {n} times" for path, n in rec["gathers_by_leaf"].items()]
    faults += [f"K5 at {k} outside k5_cases" for k in k5_unheld(k5)]
    faults += [f"K6 at {k} outside K6_CASES" for k in k6_unheld(by_key["K6"])]
    return faults


def _batch_split_train(torch, np, arch, f32, model, params, initial, meshes, adamw, seed, B,
                       S, per_step, names, keys_all, faults):
    """The batch-split runs of one cell of ``sharded_train_phase``, from
    ``params`` on the card and their CPU copy ``initial``: the unsharded
    step at 2 microbatches (and, at f32 compute, at 1), then
    ``jit_train_step`` on each of ``meshes``.  Returns (the runs' records
    by name, Llama's (2, 2) ((params, state), step) or None); adds their
    launch keys to ``keys_all`` and what they broke to ``faults``."""
    from repro_torch.data import tokens as tok
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, make_train_step, microbatches
    from repro_torch.tree import tree_map

    cfg = model.cfg
    tag = " f32" if f32 else ""
    kept = None
    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=seed)
    aux_check = None
    if cfg.moe is not None:  # each data row's aux loss through RowOps, first batch
        from repro_torch.ft.resilience import reshard_tree
        from repro_torch.sharding.policy import ShardingPolicy

        mesh = _sharded_mesh(torch, 2)
        policy = ShardingPolicy(mesh, cfg)
        placed = reshard_tree(params, policy.shardings(policy.param_specs(params)))
        rows = tp.rows_at_work(mesh, tp.data_rows(mesh, policy.dp), B, True)
        aux_check = []
        with torch.no_grad():
            for row, mb in zip(rows, microbatches(_device_batch(pipe, 0), 2)):
                _, mu = model.train_loss(params, mb)
                _, ms = model.train_loss(placed, {k: v.to(row.device) for k, v in
                                                  mb.items()}, ops=tp.RowOps(cfg, row))
                aux_check.append([float(mu["aux"]), float(ms["aux"])])
        del placed
    unsharded = make_train_step(model, TrainStepConfig(microbatches=2, adamw=adamw))
    want_u = {k: 0 for k in _counters()}
    want_u.update({k: 2 * n for k, n in per_step.items()})
    # Llama's idle share, unsharded and on (2, 2)
    profile = cfg.moe is None and not f32
    params, state, u, _ = _train_drive(torch, np, f"{arch}{tag} unsharded",
                                       unsharded, params, opt.init_state(params),
                                       pipe, want_u, profile)
    want_norms = _leaf_norms(torch, (params, state.m, state.v))
    del params, state
    torch.cuda.empty_cache()
    runs = {"unsharded_2_microbatches": u}
    if f32:  # the unsharded step's own sums in another order: 1 microbatch
        one = make_train_step(model, TrainStepConfig(microbatches=1, adamw=adamw))
        params = tree_map(lambda p: p.to("cuda", copy=True), initial)
        params, state, u1, _ = _train_drive(
            torch, np, f"{arch}{tag} unsharded, 1 microbatch", one, params,
            opt.init_state(params), pipe, {**want_u, **per_step}, False)
        probe = _rel_errs(_leaf_norms(torch, (params, state.m, state.v)), want_norms)
        u1.update({"leaf_norm_max_rel_err": max(probe),
                   "leaf_norm_median_rel_err": float(np.median(probe)),
                   "leaf_norm_worst": sorted(zip(probe, names), reverse=True)[:5]})
        runs["unsharded_1_microbatch"] = u1
        del params, state
        torch.cuda.empty_cache()
    for n_model in meshes:
        name = f"sharded_2x{n_model}"
        n_attn = sum(kind in ("attn", "swa", "local") for kind in cfg.blocks())
        n_rwkv = sum(kind == "rwkv" for kind in cfg.blocks())
        # K6 once a data row (its partial form on each model coordinate's block)
        want = dict(want_u, K5=n_attn * n_model * 2 * 2, K7=n_rwkv * n_model * 2 * 2,
                    K6=2 * n_model)
        params, state, step, rec, by_key = _sharded_run(
            torch, np, f"{arch}{tag} {name}", model, initial, pipe, n_model, want, B, S,
            profile and n_model > 1)
        norm_rel = _rel_errs(_leaf_norms(torch, (params, state.m, state.v)), want_norms)
        loss_rel = _rel_errs(rec["losses"], u["losses"])
        rec.update({"loss_rel_err": loss_rel, "leaves_norm_checked": len(norm_rel),
                    "leaf_norm_max_rel_err": max(norm_rel),
                    "leaf_norm_median_rel_err": float(np.median(norm_rel)),
                    "leaf_norm_worst": sorted(zip(norm_rel, names), reverse=True)[:5],
                    "step1_loss_bit_equal": rec["losses"][0] == u["losses"][0]})
        if n_model == 1:
            rec.update(loss_rtol=SHARDED_LOSS_RTOL, norm_rtol=SHARDED_NORM_RTOL)
            bad = (not rec["step1_loss_bit_equal"]
                   or max(loss_rel) > SHARDED_LOSS_RTOL
                   or not max(norm_rel) <= SHARDED_NORM_RTOL)
        elif f32:
            norm_rtol = max(SHARDED_F32_NORM_RTOL,
                            SHARDED_F32_PROBE_FACTOR * u1["leaf_norm_max_rel_err"])
            rec.update(loss_rtol=SHARDED_F32_LOSS_RTOL, norm_rtol=norm_rtol)
            bad = (not max(loss_rel) <= SHARDED_F32_LOSS_RTOL
                   or not max(norm_rel) <= norm_rtol)
        elif cfg.moe is None:
            loss_rtol, norm_rtol, read = SHARDED_TP_LIMITS[arch]
            gap = max(norm_rel) if read == "max" else float(np.median(norm_rel))
            rec.update(loss_rtol=loss_rtol, norm_rtol=norm_rtol, norm_gap_gated=read)
            bad = not max(loss_rel) <= loss_rtol or not gap <= norm_rtol
        else:
            aux_rel = [abs(s_ - u_) / abs(u_) if u_ else float("inf")
                       for u_, s_ in aux_check]
            rec.update(loss_rtol=SHARDED_MOE_LOSS_RTOL,
                       norm_rtol=SHARDED_MOE_NORM_RTOL,
                       aux_unsharded_vs_rowops=aux_check, aux_rel_err=aux_rel,
                       aux_rtol=SHARDED_MOE_AUX_RTOL)
            bad = (not max(loss_rel) <= SHARDED_MOE_LOSS_RTOL
                   or not max(norm_rel) <= SHARDED_MOE_NORM_RTOL
                   or not max(aux_rel) <= SHARDED_MOE_AUX_RTOL)
        rec["k7_shapes"] = sorted(str(k[1:6]) for k in by_key["K7"])
        rec["k6_launches_by_entry_and_shape"] = {str(k[:4]): n
                                                 for k, n in by_key["K6"].items()}
        entry = "xent_fwd_f32" if n_model == 1 else "xent_part_f32"
        if any(k[0] != entry for k in by_key["K6"]):
            faults.append(f"{arch}{tag} {name}: K6 {sorted(by_key['K6'])}, want "
                          f"{entry} alone")
        problems = (_sharded_faults(cfg, rec, by_key)
                    + (["outside its limits"] if bad else [])
                    + [f"K7 at {k} outside K7_SHARDED"
                       for k in k7_unheld(by_key["K7"])])
        if problems:
            faults.append(f"{arch}{tag} {name}: {problems}; {rec['losses']} vs "
                          f"{u['losses']}, leaf norms {max(norm_rel)}")
        for kernel, keys in by_key.items():
            for key, n in keys.items():
                at = (arch,) + key
                keys_all[kernel][at] = keys_all[kernel].get(at, 0) + n
        runs[name] = rec
        if (arch, n_model) == ("llama3.2-1b", 2):
            kept = (params, state), step
        else:
            del params, state, step
        torch.cuda.empty_cache()
    return runs, kept


def sharded_train_phase(torch, np, report):
    """The train cells through ``jit_train_step`` beside the unsharded step
    with 2 microbatches (see SHARDED_STEPS' comment): Llama-3.2-1B at full
    width, 4 of its 16 layers (SHARDED_LAYERS; B 8 x S 512, bf16 compute,
    f32 master weights, remat "block", the launcher's AdamW) on (2, 1) and,
    tensor parallel, on (2, 2); Qwen2-MoE-A2.7B's 2 layers, RWKV6-7B's 2,
    RecurrentGemma-9B's 3 (B 4 x S 512) and Gemma3-1B's 6 (B 4 x S 1,024)
    on (2, 2), and RWKV6-7B's again at f32 compute (SHARDED_F32_ARCHS).
    Checks each run's losses and leaf norms at its limits (RWKV's bf16
    median leaf), its launches a step (K5 once an attention layer a model
    coordinate a data row and again in remat's recompute: Llama 16 on (2,
    1) and 32 on (2, 2), Qwen2-MoE 16, RecurrentGemma 8, Gemma3 48; K7 likewise once
    an RWKV layer, on a coordinate's 32 heads: RWKV6-7B 16; K6 once a data
    row on (2, 1), 2, and its partial form once a model coordinate a data
    row on (2, 2), 4), that no leaf is gathered (the unembedding neither:
    each coordinate's vocab block runs K6's partial form), K5 only at shapes
    ``k5_checks`` holds and K7 only at ``K7_SHARDED``, every leaf in its
    placement, each coordinate's bytes equal to its specs' arithmetic, and
    (over distinct cards) every copy of a block bit-equal across the cards;
    Qwen2-MoE's aux loss nonzero and each row's within SHARDED_MOE_AUX_RTOL
    through RowOps (``_batch_split_train``).  Then the batch-1 runs of
    SEQ_SPLIT_TRAIN (``_seq_split_train``), Seamless-M4T-large-v2's among
    them (a cell with no batch split: 2 + 2 layers, its frames and tokens
    split over the data rows).  Records step ms, peak memory, Llama's idle share of a
    profiled step unsharded and on (2, 2), gathers by leaf, bytes at each
    coordinate and on each card, each run's five widest leaf-norm gaps.
    Returns (the (2, 2) Llama state, its step, {"K5" / "K6" / "K7": their
    launches by (arch,) + key over the sharded runs})."""
    from repro_torch.launch.train import adamw_config
    from repro_torch.tree import flatten_with_paths, tree_map

    t_phase = time.perf_counter()
    adamw = adamw_config(SHARDED_STEPS + 1)
    keys_all, faults = {"K5": {}, "K6": {}, "K7": {}}, []
    out = None
    for arch, meshes in SHARDED_TRAIN:
        if arch in TRAIN_RUNS:
            seed, layers, B, S, _, _, per_step = TRAIN_RUNS[arch]
            if arch in SHARDED_LAYERS:  # a cut of the lm_train cell's depth
                layers, per_step = SHARDED_LAYERS[arch], None
        else:  # a batch-1 cell alone
            S, _, _, _, (seed, layers) = SEQ_SPLIT_TRAIN[arch]
            B, per_step = 1, None
        # the bf16 cell, then, for SHARDED_F32_ARCHS, the same steps at f32 compute
        for f32 in (False, True) if arch in SHARDED_F32_ARCHS else (False,):
            model, params, cfg = _train_model(torch, arch, seed, layers,
                                              "float32" if f32 else None)
            # each sharded run's start
            initial = tree_map(lambda p: p.to("cpu", copy=True), params)
            names = [f"{kind} {'/'.join(map(str, path))}" for kind in ("param", "m", "v")
                     for path, _ in flatten_with_paths(initial)]
            runs = {}
            if per_step is None:  # remat: forward + recompute
                per_step = {"K5": 2 * _k5_layers(cfg), "K6": 1}
            if meshes:
                runs, kept = _batch_split_train(torch, np, arch, f32, model, params, initial,
                                                meshes, adamw, seed, B, S, per_step, names,
                                                keys_all, faults)
                out = kept or out
            del params
            torch.cuda.empty_cache()
            if not f32 and arch in SEQ_SPLIT_TRAIN:
                runs.update(_seq_split_train(torch, np, arch, model, initial, per_step, adamw,
                                             seed, names, keys_all, faults))
            encdec = ({"encoder_layers": cfg.encoder_layers,
                       "frames": SEQ_SPLIT_TRAIN[arch][3]} if cfg.is_encdec else {})
            report.emit({"phase": "sharded_train", "arch": arch, "layers": cfg.num_layers,
                         "batch": B, "seq": S, **encdec, "compute_dtype": cfg.compute_dtype,
                         "param_dtype": cfg.param_dtype, "remat_policy": model.remat_policy,
                         **runs})
            del initial
    report.emit({"phase": "sharded_train_done",
                 "seconds": round(time.perf_counter() - t_phase, 3)})
    if faults:
        raise AssertionError(f"sharded_train: {faults}")
    return out[0], out[1], keys_all


# sharded_mixed: the sharded step over two distinct devices on one card.
# Llama-3.2-1B's reduced config widened to K5's head dim (2 layers, d 256,
# 4 heads of 64 over 2 KV heads, d_ff 512, vocab 1,024), f32 compute,
# B 4 x S 64 and B 1 x S 64 (MIXED_BATCHES; batch 1 splits the sequence, so
# each coordinate's K/V prefix crosses from the card to the CPU or back), 2
# steps; against the same steps on (2, 2) over cuda:0 alone:
# the losses within MIXED_LOSS_RTOL and every param / m / v leaf's norm
# within MIXED_NORM_RTOL (the LM path's gradient tolerance: one data row
# runs the plain versions on the CPU where the other mesh runs K5 and K6)
MIXED_LOSS_RTOL, MIXED_NORM_RTOL = 1e-5, 1e-4
MIXED_BATCHES = ((4, 64), (1, 64))
# ... and Seamless-M4T-large-v2's reduced config widened alike (2 + 2 layers,
# d 256, 4 heads of 64 over 4 KV heads), B 1 x MIXED_ENCDEC frames + S 64
# tokens: each data row encodes its half of the frames, the second row's
# coordinates reading the first's K/V across the two devices and back
MIXED_ENCDEC = 64


def sharded_mixed_phase(torch, np, report) -> None:
    """The branches of ``jit_train_step`` that only distinct devices take,
    run on one card: a (2, 2) ("data", "model") mesh over
    [[cuda:0, cpu], [cpu, cuda:0]], so every param block is held on both
    devices, data row 0 computes on the card (K5, K6) and row 1 on the CPU
    (the plain versions), the loss on each coordinate's vocab block on its
    device (K6's partial form on the card's two blocks a step, the plain
    block form on the CPU's), and each ZeRO-1 shard is updated on its own
    device and copied to the block's holder on the other; at batch 1 each
    data row computes its span of the sequence, the second row's
    coordinates reading the first's K/V across the two devices; then a
    widened reduced Seamless-M4T at batch 1 (``MIXED_ENCDEC`` frames), its
    encoder's K/V joined across the two devices both ways.  Checks:
    every copy of a block bit-equal across the two devices, each
    coordinate's bytes its specs', the losses and leaf norms within
    MIXED_LOSS_RTOL and MIXED_NORM_RTOL of the same steps on (2, 2) over
    cuda:0 alone."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(cfgbase.get_reduced_config("llama3.2-1b"), d_model=256,
                              num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                              vocab_size=1024, compute_dtype="float32")
    model = Model(cfg, xent_impl="chunked", remat=True)
    whole = model.init_params(torch.Generator("cpu").manual_seed(7), device="cpu")
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    for B, S in MIXED_BATCHES:
        _sharded_mixed_batch(torch, np, report, cfg, model, whole, B, S, card, cpu)
    cfg = dataclasses.replace(cfgbase.get_reduced_config("seamless-m4t-large-v2"), d_model=256,
                              num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512,
                              vocab_size=1024, compute_dtype="float32")
    model = Model(cfg, xent_impl="chunked", remat=True)
    whole = model.init_params(torch.Generator("cpu").manual_seed(7), device="cpu")
    _sharded_mixed_batch(torch, np, report, cfg, model, whole, 1, MIXED_BATCHES[-1][1], card,
                         cpu, frames=(MIXED_ENCDEC, cfg.d_model))


def _sharded_mixed_batch(torch, np, report, cfg, model, whole, B, S, card, cpu,
                         frames=None) -> None:
    """``sharded_mixed_phase`` at one batch: B x S (an enc-dec's ``frames``
    beside them), 2 steps each way."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.data import tokens as tok
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.kernels.xent.kernel import K6_LAUNCHES as k6
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainStepConfig, jit_train_step

    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=7)
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
        k6.reset()
        for s in range(2):
            params, state, m = step(params, state, _device_batch(pipe, s, frames))
            losses.append(float(m["loss"]))
        # K6's partial form on each vocab block the card holds, the CPU's plain
        k6_entries = {}
        for key, n in k6.by_key.items():
            k6_entries[key[0]] = k6_entries.get(key[0], 0) + n
        cuda_coords = sum(d.type == "cuda" for d in mesh.devices.flat)
        if k6_entries != {"xent_part_f32": 2 * cuda_coords}:
            raise AssertionError(f"sharded_mixed {name}: K6 launches {k6_entries}, want "
                                 f"xent_part_f32 {2 * cuda_coords} over 2 steps")
        trees = (params, state.m, state.v)
        by_coord = _coordinate_bytes(np, list(zip(trees, (step.param_shardings,
                                                          step.opt_state_shardings.m,
                                                          step.opt_state_shardings.v))), mesh)
        several, unequal = _copies_disagree(torch, trees)
        runs[name] = {"devices": [str(d) for d in mesh.devices.flat], "losses": losses,
                      "sequence_split": step.split_seq,
                      "k6_launches_by_entry": k6_entries,
                      "norms": _leaf_norms(torch, trees), "blocks_on_several_devices": several,
                      "blocks_with_unequal_copies": unequal,
                      "coordinates_off_their_specs": sorted(k for k, v in by_coord.items()
                                                            if v[0] != v[1])}
    one, mixed = runs["cuda:0"], runs["cuda:0+cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mixed["losses"], one["losses"]))
    norm_rel = max(abs(a - b) / b if b else abs(a)
                   for a, b in zip(mixed.pop("norms"), one.pop("norms")))
    report.emit({"phase": "sharded_mixed", "arch": cfg.name, "layers": cfg.num_layers,
                 "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model, "batch": B,
                 "seq": S, "frames": None if frames is None else frames[0],
                 "compute_dtype": cfg.compute_dtype, **runs,
                 "loss_max_rel_err": loss_rel, "loss_rtol": MIXED_LOSS_RTOL,
                 "leaf_norm_max_rel_err": norm_rel, "norm_rtol": MIXED_NORM_RTOL})
    if (not mixed["blocks_on_several_devices"] or mixed["blocks_with_unequal_copies"]
            or one["coordinates_off_their_specs"] or mixed["coordinates_off_their_specs"]
            or mixed["sequence_split"] != (B == 1)
            or not loss_rel <= MIXED_LOSS_RTOL or not norm_rel <= MIXED_NORM_RTOL):
        raise AssertionError(f"sharded_mixed {cfg.name} B={B}: {runs}, losses {loss_rel} and "
                             f"leaf norms {norm_rel} off the one-card mesh's")


# sharded_serve: the sharded prefill and decode steps (jit_prefill_step /
# jit_decode_step) on _sharded_mesh, beside the unsharded Model.prefill and
# make_decode_step on the same weights: (arch, seed, layers (None: all of
# them), [(batch, prompt length, max_seq, an enc-dec's frames else None)]),
# SERVE_SHARDED_STEPS greedy steps
# after each prefill.  At batch 1 the batch specs split the prompt over the 2
# data rows (sequence parallelism: each row its span, K5 at the span's query
# offset over the rows' K/V, RWKV and the RG-LRU from the state the row
# before left); such a prompt must split evenly (SERVE_SHARDED_UNEVEN
# raises).  RecurrentGemma-9B keeps its first pattern group (rglru, rglru,
# local) of 38 layers: its local layer's one KV head leaves the cache split
# on length (over "model" at batch 4, over ("data", "model") at batch 1),
# and its rglru layers run on each coordinate's half of the width.
# RWKV6-7B keeps 4 of its 32 layers, each coordinate's 32 of 64 heads (K7 on
# them in the prefill) and its d_ff slice, its state s on each coordinate's
# heads.
# Seamless-M4T-large-v2 at full size (24 + 24 layers) on its encdec cell's
# traffic (ENCDEC_BATCHES): 4 utterances of 509 frames + 8-token prompts
# (the batch split) and 1 of 1,000 frames + a 16-token prompt (each data row
# encodes its 500 frames, layer by layer over both rows' K/V, and prefills
# its 8 tokens), ENCDEC_MAX_SEQ, its decode steps with the memory; an
# utterance of SERVE_SHARDED_UNEVEN_FRAMES raises at batch 1.
# Gemma3-1B whole (26 layers): 4 x 1,000 (two rows a data row, 2 of 4 query
# heads a model coordinate over the replicated KV head; every cache split on
# length over "model", the local layers' rings of 512 slots in blocks of
# 256, overrun in the prefill and wrapped in decode) and 1 x 2,048,
# max_seq 4,096 (each data row's span of 1,024 filling the rings from its
# start, the second row's local queries reading the first row's last 511
# keys; the cache split on length over ("data", "model")).
SERVE_SHARDED = (("llama3-8b", 40, None, ((4, 509, 1024, None), (4, 128, 1024, None),
                                          (1, 2048, 4096, None))),
                 ("recurrentgemma-9b", 41, 3, ((4, 509, 1024, None), (1, 512, 1024, None))),
                 ("rwkv6-7b", 42, 4, ((4, 509, 1024, None), (1, 512, 1024, None))),
                 ("seamless-m4t-large-v2", 43, None,
                  tuple((B, S, ENCDEC_MAX_SEQ, T) for B, (T, S) in zip((ENCDEC_LANES, 1),
                                                                       ENCDEC_BATCHES))),
                 ("gemma3-1b", 44, None, ((4, 1000, 2048, None), (1, 2048, 4096, None))))
SERVE_SHARDED_STEPS, SERVE_SHARDED_UNEVEN, SERVE_SHARDED_UNEVEN_FRAMES = 16, 509, 999
# sharded_serve's distinct-device cases: f32, (2, 2) over cuda:0 and the
# CPU against (2, 2) over cuda:0 alone, logits within SERVE_MIXED_TOL (rtol
# = atol), prompts of SERVE_MIXED_S tokens (past the reduced window of 16:
# RecurrentGemma's local ring wraps), SERVE_MIXED_STEPS decode steps
SERVE_MIXED_TOL, SERVE_MIXED_S, SERVE_MIXED_STEPS, SERVE_MIXED_MAX_SEQ = 1e-5, 40, 4, 64


def _serve_run(torch, counters, prefill, decode, start, steps, force=None):
    """Time one prefill and ``steps`` greedy decode steps (each fed the
    step before's ``next_tok``, or with ``force`` its own entry of
    ``force``, another run's ``tokens``: teacher-forced), every launch
    counter set to 0 just before each: {logits (the prefill's, and each
    step's), ttft_ms, launches a
    prefill (and K5's and K7's by key), launches a decode step, ms a step, the
    tokens of each step (host), the last ``next_tok``'s placement, the
    cache}."""
    from repro_torch.sharding import placement as pl

    def counted(fn):
        _sync_all(torch)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        out = fn()
        _sync_all(torch)
        return out, 1e3 * (time.perf_counter() - t0), {k: c.count for k, c in counters.items()}

    (cache, logits), ttft, pre = counted(prefill)
    by_key = dict(counters["K5"].by_key)
    k7_by_key = dict(counters["K7"].by_key)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    tokens, ms, per_step, step_logits = [tok.cpu()], [], [], []
    for s in range(steps):
        feed = tok if force is None else force[s].to(logits.device)
        (tok, lg, cache), t, counts = counted(lambda: decode(cache, feed, start + s))
        ms.append(t)
        per_step.append(counts)
        step_logits.append(lg)
        tokens.append(pl.gather(tok, "cpu") if isinstance(tok, pl.Placed) else tok.cpu())
    return {"logits": logits, "step_logits": step_logits, "ttft_ms": ttft,
            "prefill_launches": pre, "k5_by_key": by_key, "k7_by_key": k7_by_key,
            "decode_launches": per_step,
            "decode_step_ms": ms, "tokens": tokens,
            "next_tok_sharding": getattr(tok, "sharding", None), "cache": cache}


def _logits_gap(got, want) -> dict:
    """{max_abs, rel_rms} of ``got`` (B, V) against ``want``, and
    ``top2_margin``: the widest gap between ``want``'s two largest logits
    over the rows whose argmax the two disagree on (None where none do)."""
    g, w = got.float(), want.to(got.device).float()
    top2 = w.topk(2, dim=-1).values
    off = g.argmax(-1) != w.argmax(-1)
    margin = (top2[:, 0] - top2[:, 1])[off]
    return {"max_abs": float((g - w).abs().max()),
            "rel_rms": float((g - w).norm() / w.norm()),
            "top2_margin": float(margin.max()) if margin.numel() else None}


def _sharded_steps(model, policy, B, S, max_seq):
    """The sharded prefill and decode steps (the latter ``with_memory`` for
    an enc-dec config)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import inputs as inp
    from repro_torch.serve.step import jit_decode_step, jit_prefill_step

    aparams, acache = inp.abstract_params(model), inp.abstract_cache(model, B, max_seq)
    specs = policy.batch_specs(cfgbase.ShapeConfig("prefill", S, B, "prefill"))
    return (jit_prefill_step(model, policy, aparams, acache, specs, B, max_seq),
            jit_decode_step(model, policy, aparams, acache, B, max_seq,
                            with_memory=model.cfg.is_encdec))


def sharded_serve_phase(torch, np, report) -> dict:
    """The sharded serving steps (``jit_prefill_step`` /
    ``jit_decode_step``) on ``_sharded_mesh``, each arch of SERVE_SHARDED
    at full width (bf16 weights as drawn), first through the unsharded
    ``Model.prefill`` / ``make_decode_step`` and then, on the same weights
    (placed by the policy, the whole copy freed), through the sharded
    steps, their decode steps teacher-forced with the unsharded run's
    tokens: every data row's attention on each model coordinate's heads
    (K5 in the prefill), RWKV's time-mix on its heads (K7 in the prefill),
    the RG-LRU on its channels, the FFN on its ``d_ff`` slice, the KV cache
    and the recurrent state on their shards; at batch 1 each data row on
    its span of the prompt (K5 at its query offset, K7 of the second row
    from the first's state); Seamless-M4T-large-v2's utterances encoded in
    the prefill (at batch 1 each data row its half of the frames, layer by
    layer over both rows' K/V), its decode steps reading the memory whole.
    Checks, for each batch: the prefill's and
    every decode step's logits within LM_LOGITS_TOL of the unsharded
    path's; K5 once an attention layer and K7 once an RWKV layer a model
    coordinate a data row in the prefill (at batch 1 half of RWKV's K7 from
    a carried state) and no kernel in a decode step, both ways as the
    unsharded path's counts say; K5 and K7 only at shapes ``k5_checks`` /
    ``k7_checks`` hold; no leaf gathered; every cache leaf placed by its
    spec, each coordinate holding its spec's bytes (Llama-3-8B: 4 of 8 KV
    heads a coordinate; RWKV's s and the RG-LRU's h and conv: half the heads
    or channels); ``next_tok`` placed by the reference's ``tok_spec``; a
    batch-1 prompt of SERVE_SHARDED_UNEVEN tokens raises, and an utterance
    of SERVE_SHARDED_UNEVEN_FRAMES frames; Seamless's encoder K5 once a
    layer a coordinate a data row (96 a prefill) on a row's rows, at batch
    1 on its 500 frames over all 1,000 and never over the whole.  Records
    greedy-token agreement a step, TTFT and ms a decode step both ways.
    Then ``_sharded_serve_mixed``.  Returns {"K5" / "K7": their launches by
    (arch,) + key over the sharded prefills}."""
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.serve.step import make_decode_step
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    counters = _counters()
    mesh = _sharded_mesh(torch)
    steps = SERVE_SHARDED_STEPS
    keys = {"K5": {}, "K7": {}}
    for arch, seed, layers, batches in SERVE_SHARDED:
        model, params = _lm_model(torch, arch, seed,
                                  **({} if layers is None else {"num_layers": layers}))
        cfg = model.cfg
        policy = ShardingPolicy(mesh, cfg)
        rng = np.random.default_rng(seed)
        prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                                   device="cuda") for B, S, _, _ in batches]
        # an enc-dec's utterances: (B, T, D) frame embeddings ~ N(0, 1)
        srcs = [None if T is None else torch.randn(
            (B, T, cfg.d_model), generator=torch.Generator("cuda").manual_seed(seed + i),
            device="cuda") for i, (B, _, _, T) in enumerate(batches)]
        inputs = [{"tokens": t} if src is None else {"tokens": t, "src_embeds": src}
                  for t, src in zip(prompts, srcs)]
        n_attn = _k5_layers(cfg)
        n_rwkv = sum(kind == "rwkv" for kind in cfg.blocks())
        # warm-up outside the timed runs: cuBLAS handles, the kernel library
        model.prefill(params, {k: v[:1, :8] for k, v in inputs[0].items()}, batches[0][2])
        # the decode steps' memory (an enc-dec's encoder output, whole, as the
        # reference's decode step takes it), made outside the timed runs
        memories = [None if src is None else model.encode(params, src) for src in srcs]
        unsharded = []
        for batch, memory, (_, S, max_seq, _) in zip(inputs, memories, batches):
            udecode = make_decode_step(model, max_seq)
            unsharded.append(_serve_run(
                torch, counters, lambda: model.prefill(params, batch, max_seq),
                lambda c, tok, pos: udecode(params, c, tok, pos, memory), S, steps))
            del unsharded[-1]["cache"]
        steps_by_batch = [_sharded_steps(model, policy, B, S, max_seq)
                          for B, S, max_seq, _ in batches]
        placed = reshard_tree(params, steps_by_batch[0][0].param_shardings)
        del params
        torch.cuda.empty_cache()
        for (B, S, max_seq, T), batch, memory, u, (pre, dec) in zip(
                batches, inputs, memories, unsharded, steps_by_batch):
            extra = () if memory is None else (memory,)
            # the decode steps are teacher-forced with the unsharded run's
            # tokens, so each step's logits are held against the unsharded
            # step's on the same history
            with _counting_gathers(placed) as gathers:
                sh = _serve_run(torch, counters, lambda: pre(placed, batch),
                                lambda c, tok, pos: dec(placed, c, tok, pos, *extra), S, steps,
                                force=u["tokens"])
            cache = sh.pop("cache")
            step_err = [_logits_gap(a, b) for a, b in zip(sh.pop("step_logits"),
                                                          u.pop("step_logits"))]
            # every data row computes: its rows, or at batch 1 its span of the prompt
            want_pre = {k: 0 for k in counters}
            want_pre["K5"] = n_attn * 2 * 2
            want_pre["K7"] = n_rwkv * 2 * 2
            k7_carried = sum(n for k, n in sh["k7_by_key"].items() if k[7])
            want_carried = n_rwkv * 2 if B == 1 else 0  # the second row's spans
            k5_offsets = sorted({k[10] for k in sh["k5_by_key"]})
            encoder = None
            if T is not None:  # each data row's rows, or at batch 1 its half of the frames
                want_key = (B // 2, T, T) if B % 2 == 0 else (B, T // 2, T)
                encoder = {
                    "k5_key": want_key, "want": cfg.encoder_layers * 2 * 2,
                    "launches": sum(n for k, n in sh["k5_by_key"].items()
                                    if k[1:4] == want_key and not k[7]),
                    "over_every_frame_at_batch_1": sum(n for k, n in sh["k5_by_key"].items()
                                                       if B == 1 and k[2] == T)}
            uneven = None
            if B == 1 and arch in ("rwkv6-7b", "seamless-m4t-large-v2"):
                # a prompt, or an utterance, the data rows do not divide
                n = SERVE_SHARDED_UNEVEN_FRAMES if T else SERVE_SHARDED_UNEVEN
                short = _sharded_steps(model, policy, 1, n if T is None else S, max_seq)[0]
                cut = ({"tokens": batch["tokens"][:, :n]} if T is None else
                       dict(batch, src_embeds=batch["src_embeds"][:, :n]))
                try:
                    short(placed, cut)
                    uneven = "ran"
                except ValueError as e:
                    uneven = f"ValueError: {e}"
            for kernel in keys:
                for k, n in sh[f"{kernel.lower()}_by_key"].items():
                    keys[kernel][(arch,) + k] = keys[kernel].get((arch,) + k, 0) + n
            # every shape K5 and K7 ran at here is one k5_checks / k7_checks
            # held against the plain version
            unchecked = k5_unheld(sh["k5_by_key"]) + k7_unheld(sh["k7_by_key"])
            lk = sh["logits"]
            gap = _logits_gap(lk, u["logits"])
            err, rel = gap["max_abs"], gap["rel_rms"]
            by_coord = _coordinate_bytes(np, [(cache, dec.cache_shardings)], mesh)
            attn = next((i for i, kind in enumerate(cfg.blocks())
                         if kind in ("attn", "swa", "local")), None)
            k_blocks = (None if attn is None else
                        sorted({tuple(cache[attn]["k"].shard(c).shape) for c in mesh.coords()}))
            # each attention kind's first layer: a ring's blocks beside a linear cache's
            by_kind = {}
            for i, kind in enumerate(cfg.blocks()):
                if kind in ("attn", "swa", "local") and kind not in by_kind:
                    by_kind[kind] = {"layout": tp.cache_layout(cache[i]["k"]),
                                     "slots": cache[i]["k"].shape[1],
                                     "k_block_shapes": sorted({tuple(cache[i]["k"].shard(c).shape)
                                                               for c in mesh.coords()})}
            # the recurrent state on each coordinate's heads or channels
            state_blocks = {name: sorted({tuple(layer[name].shard(c).shape)
                                          for c in mesh.coords()})
                            for layer in cache for name in ("s", "h", "conv") if name in layer}
            state_split = all(tp.split_dim(layer[name]) is not None for layer in cache
                              for name in ("s", "h", "conv") if name in layer)
            placed_ok = all(x.sharding == s for x, s in
                            zip(leaves(cache), leaves(dec.cache_shardings)))
            agree = [float((a == b).float().mean()) for a, b in zip(sh["tokens"], u["tokens"])]
            max_abs, rel_rms = LM_LOGITS_TOL[arch]
            steps_off = [i for i, e in enumerate(step_err)
                         if not (e["max_abs"] <= max_abs and e["rel_rms"] <= rel_rms)]
            rec = {"phase": "sharded_serve", "arch": arch, "layers": cfg.num_layers,
                   "d_model": cfg.d_model, "batch": B, "prompt": S, "max_seq": max_seq,
                   "decode_steps": steps, "compute_dtype": cfg.compute_dtype,
                   "sequence_split": pre.split_seq, "k5_query_offsets": k5_offsets,
                   "k7_from_carried_state": k7_carried,
                   "frames": T, "encoder_k5": encoder,
                   "uneven_prompt": None if uneven is None else
                   {"prompt" if T is None else "frames": SERVE_SHARDED_UNEVEN_FRAMES if T else
                    SERVE_SHARDED_UNEVEN, "result": uneven},
                   "mesh": {"shape": mesh.shape,
                            "devices": [str(d) for d in mesh.devices.flat]},
                   "cache_layout": None if attn is None else tp.cache_layout(cache[attn]["k"]),
                   "k_spec": None if attn is None else str(tuple(cache[attn]["k"].sharding.spec)),
                   "k_block_shapes": k_blocks, "cache_by_kind": by_kind,
                   "ring_cache_layers": _ring_layers(cfg, max_seq),
                   "state_block_shapes": state_blocks, "state_split_on_model": state_split,
                   "gathers_by_leaf": gathers,
                   "logits_vs_unsharded": gap,
                   "logits_limit": {"max_abs": max_abs, "rel_rms": rel_rms},
                   "prefill_launches": sh["prefill_launches"],
                   "prefill_launches_want": want_pre,
                   "unsharded_prefill_launches": u["prefill_launches"],
                   "decode_launches": sh["decode_launches"][0],
                   "decode_logits_vs_unsharded": step_err,
                   "decode_steps_off_limit": steps_off,
                   "greedy_token_agreement": agree,
                   "ttft_ms": {"sharded": sh["ttft_ms"], "unsharded": u["ttft_ms"]},
                   "decode_step_ms_p50": {"sharded": _pct(np, sh["decode_step_ms"], 50),
                                          "unsharded": _pct(np, u["decode_step_ms"], 50)},
                   "decode_step_ms": {"sharded": sh["decode_step_ms"],
                                      "unsharded": u["decode_step_ms"]},
                   "bytes_by_coordinate_held_vs_specs": by_coord,
                   "next_tok_spec": str(tuple(dec.tok_sharding.spec)),
                   "placements_kept": placed_ok,
                   "k5_k7_shapes_not_held": [str(k) for k in unchecked],
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
            report.emit(rec)
            no_kernels = {k: 0 for k in counters}
            bad = {k: v for k, v in by_coord.items() if v[0] != v[1]}
            want_spec = (("data",) if B % 2 == 0 else None, None)
            if (not torch.isfinite(lk).all() or err > max_abs or rel > rel_rms
                    or steps_off or sh["prefill_launches"] != want_pre
                    or u["prefill_launches"] != {**no_kernels, "K5": n_attn, "K7": n_rwkv}
                    or pre.split_seq != (B == 1) or k7_carried != want_carried
                    or (B == 1 and n_attn and k5_offsets != [0, S // 2])
                    or (uneven is not None and not uneven.startswith("ValueError"))
                    or (encoder is not None and (encoder["launches"] != encoder["want"]
                                                 or encoder["over_every_frame_at_batch_1"]))
                    or any(c != no_kernels for c in sh["decode_launches"] + u["decode_launches"])
                    or bad or not placed_ok or unchecked or gathers or not state_split
                    or tuple(dec.tok_sharding.spec) != want_spec
                    or sh["next_tok_sharding"] != dec.tok_sharding
                    or (arch == "llama3-8b"
                        and k_blocks != [(B // 2 if B % 2 == 0 else B, max_seq,
                                          cfg.num_kv_heads // 2, cfg.head_dim)])):
                raise AssertionError(f"sharded_serve {arch} batch {B}: {rec}")
            del cache
        del placed
        torch.cuda.empty_cache()
    _sharded_serve_mixed(torch, np, report)
    report.emit({"phase": "sharded_serve_done",
                 "seconds": round(time.perf_counter() - t_phase, 3)})
    return keys


def _sharded_serve_mixed(torch, np, report) -> None:
    """The branches of the sharded serving steps that only distinct devices
    take, on one card: a (2, 2) ("data", "model") mesh over [[cuda:0, cpu],
    [cpu, cuda:0]] against (2, 2) over cuda:0 alone, f32: a widened reduced
    Llama-3.2-1B (heads split: each data row's partial sums cross from the
    CPU to the card or back) at batch 4, and a widened reduced
    RecurrentGemma-9B (its cache split on length, its ring of 16 slots
    wrapped, its RG-LRU's ξ gathered across the two devices) at batch 4 and
    at batch 1 (the combine across all four coordinates, two devices), and
    a widened reduced RWKV6-7B (4 heads of 64: K7 on the card's
    coordinates, its plain version on the CPU's, the state s on both) at
    batch 4; at batch 1 (RecurrentGemma, and Llama and RWKV too) each data
    row prefills its span of the prompt, the second row's coordinates
    reading the first's K/V and state across the two devices.  Checks:
    every step's logits within
    SERVE_MIXED_TOL of cuda:0 alone, every cache block held on both devices
    bit-equal across them, each coordinate's cache bytes its specs'."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.sharding.policy import ShardingPolicy

    wide = dict(d_model=256, num_heads=4, head_dim=64, d_ff=512, vocab_size=1024,
                compute_dtype="float32")
    cases = (("llama3.2-1b", dict(num_kv_heads=2), 4),
             ("llama3.2-1b", dict(num_kv_heads=2), 1),
             ("recurrentgemma-9b", dict(num_kv_heads=1, lru_width=256), 4),
             ("recurrentgemma-9b", dict(num_kv_heads=1, lru_width=256), 1),
             ("rwkv6-7b", dict(num_kv_heads=4, rwkv_head_dim=64), 4),
             ("rwkv6-7b", dict(num_kv_heads=4, rwkv_head_dim=64), 1))
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    counters = _counters()
    for arch, changes, B in cases:
        cfg = dataclasses.replace(cfgbase.get_reduced_config(arch), **wide, **changes)
        model = Model(cfg)
        whole = model.init_params(torch.Generator("cpu").manual_seed(8), device="cpu")
        tokens = torch.as_tensor(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B, SERVE_MIXED_S)).astype(np.int32), device="cuda")
        runs = {}
        for name, devices in (("cuda:0", [card]), ("cuda:0+cpu", [card, cpu, cpu, card])):
            mesh = make_mesh((2, 2), ("data", "model"), devices=devices)
            pre, dec = _sharded_steps(model, ShardingPolicy(mesh, cfg), B, SERVE_MIXED_S,
                                      SERVE_MIXED_MAX_SEQ)
            params = reshard_tree(whole, pre.param_shardings)
            run = _serve_run(torch, counters, lambda: pre(params, {"tokens": tokens}),
                             lambda c, tok, pos: dec(params, c, tok, pos), SERVE_MIXED_S,
                             SERVE_MIXED_STEPS)
            by_coord = _coordinate_bytes(np, [(run["cache"], dec.cache_shardings)], mesh)
            several, unequal = _copies_disagree(torch, [run["cache"]])
            runs[name] = {"logits": torch.stack([run["logits"]] + run["step_logits"]),
                          "tokens": run["tokens"], "sequence_split": pre.split_seq,
                          "k5_prefill": run["prefill_launches"]["K5"],
                          "blocks_on_several_devices": several,
                          "blocks_with_unequal_copies": unequal,
                          "coordinates_off_their_specs": sorted(
                              k for k, v in by_coord.items() if v[0] != v[1])}
        one, mixed = runs["cuda:0"], runs["cuda:0+cpu"]
        ok, err = _close(torch, mixed.pop("logits"), one.pop("logits"), SERVE_MIXED_TOL,
                         SERVE_MIXED_TOL)
        same_tokens = all(torch.equal(a, b) for a, b in zip(mixed.pop("tokens"),
                                                            one.pop("tokens")))
        report.emit({"phase": "sharded_serve_mixed", "arch": arch, "d_model": cfg.d_model,
                     "batch": B, "prompt": SERVE_MIXED_S, "decode_steps": SERVE_MIXED_STEPS,
                     "compute_dtype": cfg.compute_dtype, **runs,
                     "logits_max_abs_err": err, "tol": SERVE_MIXED_TOL,
                     "greedy_tokens_equal": same_tokens})
        if (not ok or not same_tokens or not mixed["blocks_on_several_devices"]
                or mixed["sequence_split"] != (B == 1)
                or mixed["blocks_with_unequal_copies"] or one["coordinates_off_their_specs"]
                or mixed["coordinates_off_their_specs"]):
            raise AssertionError(f"sharded_serve_mixed {arch} batch {B}: {runs}, logits "
                                 f"{err} off cuda:0 alone")


# mixtral_sharded (python3 chip_smoke.py --mixtral-only): Mixtral-8x7B on
# ("data", "model") = (1, n) over n distinct cards, n the first of
# MIXTRAL_MODEL_AXES the machine has cards for (never one card: its 46.70 B
# parameters are 93.4 GB of bf16, over the card's 80 GB), through
# jit_prefill_step / jit_decode_step.  a: its first MIXTRAL_PREFIX_LAYERS
# layers from lm_engine's seed (init_params draws the embeddings first, so
# they are the full model's first layers), served unsharded on cuda:0, then
# drawn again straight into their blocks and served sharded, teacher-forced;
# b: all 32 layers drawn straight into their blocks and served, each batch's
# decode held against a sharded prefill of the sequence up to a step.
# MIXTRAL_ATTENTION is configs/mixtral_8x7b.py's (H, K, h, window), pinned
# by a CPU test; every K5 shape the phase launches is K5_MIXTRAL_SHARDED's.
MIXTRAL_SEED = LM_ENGINES["mixtral-8x7b"][0]
MIXTRAL_PREFIX_LAYERS = LM_ENGINE_LAYERS["mixtral-8x7b"]
MIXTRAL_MAX_SEQ = LM_ENGINES["mixtral-8x7b"][2]
MIXTRAL_BATCHES = ((4, 509), (1, 8192))  # (B, prompt): 8,192 overruns the rings
MIXTRAL_STEPS = 16
MIXTRAL_MODEL_AXES = (4, 2)
MIXTRAL_ATTENTION = (32, 8, 128, 4096)


def mixtral_check_positions(S: int) -> list:
    """The decode steps (by position) that part b holds against a sharded
    prefill of the sequence up to them, after a prompt of ``S``: the first
    at or past the window (its K/V written over a ring slot), where there
    is one, and the last."""
    window, last = MIXTRAL_ATTENTION[3], S + MIXTRAL_STEPS - 1
    return sorted({p for p in (max(window, S), last) if p <= last})


def mixtral_sharded_k5_shapes(n: int) -> list:
    """(B, S, H, K, h, window, softcap) of every K5 launch of
    ``mixtral_sharded_phase`` on (1, ``n``): a model coordinate's heads at
    each batch's prompt and at each check prefill's length."""
    H, K, h, window = MIXTRAL_ATTENTION
    return [(B, L, H // n, K // n, h, window, 0.0) for B, S in MIXTRAL_BATCHES
            for L in [S] + [p + 1 for p in mixtral_check_positions(S)]]


K5_MIXTRAL_SHARDED = [c for n in MIXTRAL_MODEL_AXES for c in mixtral_sharded_k5_shapes(n)]
K5_EXTRA += K5_MIXTRAL_SHARDED


def mixtral_cards(torch) -> int:
    """The first model-axis size of MIXTRAL_MODEL_AXES the machine has
    distinct cards for, or 0."""
    return next((n for n in MIXTRAL_MODEL_AXES if torch.cuda.device_count() >= n), 0)


def _layer_draw_bytes(model) -> int:
    """One layer's draw at its largest: the layer in ``param_dtype`` and
    its largest leaf once more (stored in the compute dtype beside it,
    ``store_compute_dtype``), from the abstract tree."""
    from repro_torch.launch import inputs as inp
    from repro_torch.tree import leaves

    layer = leaves(inp.abstract_params(model)["layers"][0])
    return (sum(x.numel() * x.element_size() for x in layer)
            + max(x.numel() * x.element_size() for x in layer))


def _mixtral_serve_checks(np, sh, dec, mesh, n_attn, gathers) -> dict:
    """What part a and part b both hold a sharded run to: finite logits; K5
    once an attention layer a model coordinate in the prefill and never in
    a decode step, only at shapes ``k5_checks`` holds; no leaf gathered;
    every cache leaf placed by its spec, each coordinate holding its spec's
    bytes, the rings split on KV heads.  Returns the readings with
    ``faults``."""
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.tree import leaves

    cache = sh["cache"]
    _, K, h, window = MIXTRAL_ATTENTION
    n = mesh.shape["model"]
    no_kernels = {k: 0 for k in sh["prefill_launches"]}
    by_coord = _coordinate_bytes(np, [(cache, dec.cache_shardings)], mesh)
    k_blocks = sorted({tuple(cache[0]["k"].shard(c).shape) for c in mesh.coords()})
    out = {"prefill_launches": sh["prefill_launches"],
           "decode_launches": sh["decode_launches"][0],
           "k5_keys": sorted(str(k) for k in sh["k5_by_key"]),
           "k5_shapes_not_held": [str(k) for k in k5_unheld(sh["k5_by_key"])],
           "gathers_by_leaf": gathers,
           "cache_layout": tp.cache_layout(cache[0]["k"]), "k_block_shapes": k_blocks,
           "cache_bytes_by_coordinate_held_vs_specs": by_coord,
           "placements_kept": all(x.sharding == s for x, s in
                                  zip(leaves(cache), leaves(dec.cache_shardings)))}
    B = cache[0]["k"].shape[0]
    faults = []
    if not all(bool(lg.isfinite().all()) for lg in [sh["logits"]] + sh["step_logits"]):
        faults.append("logits not finite")
    if sh["prefill_launches"] != {**no_kernels, "K5": n_attn * n}:
        faults.append(f"prefill launches {sh['prefill_launches']}, want K5 {n_attn * n}")
    if any(c != no_kernels for c in sh["decode_launches"]):
        faults.append("a kernel launched in a decode step")
    if out["k5_shapes_not_held"] or gathers or not out["placements_kept"]:
        faults.append("K5 at a shape k5_checks does not hold, a leaf gathered or a cache "
                      "leaf off its placement")
    if any(v[0] != v[1] for v in by_coord.values()):
        faults.append("a coordinate's cache bytes off its specs")
    if k_blocks != [(B, window, K // n, h)]:
        faults.append(f"ring blocks {k_blocks}, want {[(B, window, K // n, h)]}")
    out["faults"] = faults
    return out


def mixtral_sharded_phase(torch, np, report, devices, layers=None) -> None:
    """Mixtral-8x7B at full width on ("data", "model") = (1, len(devices))
    through ``jit_prefill_step`` / ``jit_decode_step`` (bf16 weights, every
    cache a ring of 4,096 slots split on KV heads), MIXTRAL_BATCHES'
    prompts, MIXTRAL_STEPS greedy steps each.

    a. Its first MIXTRAL_PREFIX_LAYERS layers served whole on cuda:0 and
       freed, then drawn again into their blocks (``init_params(shardings=)``)
       and served sharded, each decode step fed the unsharded run's token:
       the prefill's and every step's logits within LM_LOGITS_TOL of the
       unsharded path's, and ``_mixtral_serve_checks``.
    b. All ``layers`` (the config's 32) drawn into their blocks: each card
       holds its spec's bytes, fewer than the whole model's, and its peak
       during the draw stays under what it held before, its blocks and one
       layer's draw (``_layer_draw_bytes``).  Each batch served with greedy
       steps and held to ``_mixtral_serve_checks``; then, under
       ``lifted_capacity``, prefilled again and decoded teacher-forced with
       the served tokens, the logits of its steps at
       ``mixtral_check_positions`` each within LM_LOGITS_TOL of a sharded
       prefill of the whole sequence up to that step.  Records TTFT, ms a
       decode step, tokens/s, cache bytes and peak memory a card."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.serve.step import make_decode_step
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    mesh = make_mesh((1, len(devices)), ("data", "model"), devices=devices)
    cards = sorted({torch.device(d) for d in devices}, key=str)
    counters = _counters()
    steps, max_seq = MIXTRAL_STEPS, MIXTRAL_MAX_SEQ
    max_abs, rel_rms = LM_LOGITS_TOL["mixtral-8x7b"]
    full = cfgbase.get_config("mixtral-8x7b")
    rng = np.random.default_rng(MIXTRAL_SEED)
    prompts = [torch.as_tensor(rng.integers(0, full.vocab_size, (B, S)).astype(np.int32),
                               device="cuda") for B, S in MIXTRAL_BATCHES]
    mesh_rec = {"shape": mesh.shape, "devices": [str(d) for d in mesh.devices.flat]}

    def within(gap):
        return gap["max_abs"] <= max_abs and gap["rel_rms"] <= rel_rms

    def peaks():
        return {str(d): torch.cuda.max_memory_allocated(d) for d in cards}

    def reset_peaks():
        _sync_all(torch)
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)

    def warm_up(model, policy, placed):
        """A sharded prefill of 8 tokens outside the timed runs: each
        card's first cuBLAS calls and kernel loads."""
        _sharded_steps(model, policy, 1, 8, max_seq)[0](placed, {"tokens": prompts[0][:1, :8]})
        _sync_all(torch)

    # -- a: the prefix, whole on cuda:0, then drawn into its blocks ----------
    model, params = _lm_model(torch, "mixtral-8x7b", MIXTRAL_SEED,
                              num_layers=MIXTRAL_PREFIX_LAYERS)
    cfg = model.cfg
    model.prefill(params, {"tokens": prompts[0][:1, :8]}, max_seq)  # warm-up
    udecode = make_decode_step(model, max_seq)
    unsharded = []
    for tokens in prompts:
        u = _serve_run(torch, counters, lambda: model.prefill(params, {"tokens": tokens}, max_seq),
                       lambda c, tok, pos: udecode(params, c, tok, pos), tokens.shape[1], steps)
        del u["cache"]
        unsharded.append(u)
    del params, udecode
    torch.cuda.empty_cache()
    policy = ShardingPolicy(mesh, cfg)
    steps_by_batch = [_sharded_steps(model, policy, B, S, max_seq) for B, S in MIXTRAL_BATCHES]
    placed = model.init_params(torch.Generator("cuda").manual_seed(MIXTRAL_SEED),
                               store_dtype=torch.bfloat16,
                               shardings=steps_by_batch[0][0].param_shardings)
    warm_up(model, policy, placed)
    for (B, S), tokens, u, (pre, dec) in zip(MIXTRAL_BATCHES, prompts, unsharded,
                                             steps_by_batch):
        with _counting_gathers(placed) as gathers:
            sh = _serve_run(torch, counters, lambda: pre(placed, {"tokens": tokens}),
                            lambda c, tok, pos: dec(placed, c, tok, pos), S, steps,
                            force=u["tokens"])
        checks = _mixtral_serve_checks(np, sh, dec, mesh, cfg.num_layers, gathers)
        gaps = [_logits_gap(sh["logits"], u["logits"])] + [
            _logits_gap(a, b) for a, b in zip(sh["step_logits"], u["step_logits"])]
        off = [i for i, g in enumerate(gaps) if not within(g)]
        if u["prefill_launches"]["K5"] != cfg.num_layers:
            checks["faults"].append(f"unsharded prefill K5 {u['prefill_launches']['K5']}")
        rec = {"phase": "mixtral_sharded", "part": "a", "layers": cfg.num_layers,
               "d_model": cfg.d_model, "batch": B, "prompt": S, "max_seq": max_seq,
               "decode_steps": steps, "mesh": mesh_rec, **checks,
               "logits_vs_unsharded": gaps[0], "decode_logits_vs_unsharded": gaps[1:],
               "steps_off_limit": off, "logits_limit": {"max_abs": max_abs,
                                                        "rel_rms": rel_rms},
               "greedy_token_agreement": [float((a == b).float().mean())
                                          for a, b in zip(sh["tokens"], u["tokens"])],
               "ttft_ms": {"sharded": sh["ttft_ms"], "unsharded": u["ttft_ms"]},
               "decode_step_ms_p50": {"sharded": _pct(np, sh["decode_step_ms"], 50),
                                      "unsharded": _pct(np, u["decode_step_ms"], 50)},
               "max_memory_allocated": peaks()}
        report.emit(rec)
        if off or checks["faults"]:
            raise AssertionError(f"mixtral_sharded a, batch {B} x {S}: {rec}")
        del sh
    del placed, unsharded, steps_by_batch
    _sync_all(torch)
    torch.cuda.empty_cache()

    # -- b: every layer, drawn into its blocks --------------------------------
    model = Model(dataclasses.replace(cfg, num_layers=layers or full.num_layers),
                  rwkv_chunk=64)
    cfg = model.cfg
    policy = ShardingPolicy(mesh, cfg)
    steps_by_batch = [_sharded_steps(model, policy, B, S, max_seq) for B, S in MIXTRAL_BATCHES]
    shardings = steps_by_batch[0][0].param_shardings
    draw = _layer_draw_bytes(model)
    reset_peaks()
    before = {str(d): torch.cuda.memory_allocated(d) for d in cards}
    t0 = time.perf_counter()
    placed = model.init_params(torch.Generator("cuda").manual_seed(MIXTRAL_SEED),
                               store_dtype=torch.bfloat16, shardings=shardings)
    _sync_all(torch)
    draw_s = time.perf_counter() - t0
    draw_peak = peaks()
    held = {}
    for x in leaves(placed):
        for dev, nb in x.device_bytes().items():
            held[str(dev)] = held.get(str(dev), 0) + nb
    whole = sum(x.shape.numel() * x.dtype.itemsize for x in leaves(placed))
    by_coord = _coordinate_bytes(np, [(placed, shardings)], mesh)
    limit = {d: before[d] + held[d] + draw for d in held}
    faults = [f"{d}: peak {draw_peak[d]} over {limit[d]}" for d in held
              if draw_peak[d] > limit[d]]
    faults += [f"coordinate {c}: {v[0]} bytes, specs {v[1]}" for c, v in by_coord.items()
               if v[0] != v[1]]
    if len(cards) > 1:
        faults += [f"{d} holds {held[d]} of the whole {whole}" for d in held
                   if held[d] >= whole]
    rec = {"phase": "mixtral_sharded", "part": "b_draw", "layers": cfg.num_layers,
           "params": sum(x.shape.numel() for x in leaves(placed)), "param_bytes": whole,
           "mesh": mesh_rec, "draw_s": draw_s, "param_bytes_by_card": held,
           "param_bytes_by_coordinate_held_vs_specs": by_coord,
           "draw_peak_by_card": draw_peak, "draw_peak_limit_by_card": limit,
           "allocated_before_draw_by_card": before,
           "layer_draw_bytes": draw, "faults": faults}
    report.emit(rec)
    if faults:
        raise AssertionError(f"mixtral_sharded b, the draw: {rec}")
    warm_up(model, policy, placed)
    for (B, S), tokens, (pre, dec) in zip(MIXTRAL_BATCHES, prompts, steps_by_batch):
        reset_peaks()
        with _counting_gathers(placed) as gathers:
            sh = _serve_run(torch, counters, lambda: pre(placed, {"tokens": tokens}),
                            lambda c, tok, pos: dec(placed, c, tok, pos), S, steps)
        serve_peak = peaks()
        checks = _mixtral_serve_checks(np, sh, dec, mesh, cfg.num_layers, gathers)
        del sh["cache"]
        # held to itself, as _ring_decode_check: under lifted_capacity the
        # prompt prefilled again and the served tokens fed back through the
        # decode steps, the steps at mixtral_check_positions each against a
        # sharded prefill of the sequence up to them (a linear pass over
        # every key; K5 under the window where it bites)
        seq = torch.cat([tokens.cpu()] + sh["tokens"], dim=1)
        held_to_prefill = {}
        with lifted_capacity():
            again = _serve_run(torch, counters, lambda: pre(placed, {"tokens": tokens}),
                               lambda c, tok, pos: dec(placed, c, tok, pos), S, steps,
                               force=sh["tokens"])
            del again["cache"]
            for p in mixtral_check_positions(S):
                check_pre = _sharded_steps(model, policy, B, p + 1, max_seq)[0]
                for c in counters.values():
                    c.reset()
                _, want = check_pre(placed, {"tokens": seq[:, :p + 1].to("cuda")})
                unheld = k5_unheld(dict(counters["K5"].by_key))
                got = again["step_logits"][p - S]
                gap = {**_logits_gap(got, want), "finite": bool(torch.isfinite(got).all())}
                held_to_prefill[str(p)] = gap
                if not (gap["finite"] and within(gap)) or unheld:
                    checks["faults"].append(f"step at {p} against a prefill of {p + 1}: "
                                            f"{gap}, K5 unheld {unheld}")
                del check_pre, want
        del again
        ttft = sh["ttft_ms"]
        step_ms = _pct(np, sh["decode_step_ms"], 50)
        rec = {"phase": "mixtral_sharded", "part": "b", "layers": cfg.num_layers,
               "d_model": cfg.d_model, "batch": B, "prompt": S, "max_seq": max_seq,
               "decode_steps": steps, "mesh": mesh_rec, **checks,
               "decode_vs_sharded_prefill": held_to_prefill,
               "logits_limit": {"max_abs": max_abs, "rel_rms": rel_rms},
               "ttft_ms": ttft, "prefill_tokens_per_s": B * S / (ttft / 1e3),
               "decode_step_ms": sh["decode_step_ms"], "decode_step_ms_p50": step_ms,
               "decode_tokens_per_s": B / (step_ms / 1e3),
               "max_memory_allocated_by_card": serve_peak}
        report.emit(rec)
        if checks["faults"]:
            raise AssertionError(f"mixtral_sharded b, batch {B} x {S}: {rec}")
        del sh
    del placed, steps_by_batch
    _sync_all(torch)
    torch.cuda.empty_cache()
    report.emit({"phase": "mixtral_sharded_done",
                 "seconds": round(time.perf_counter() - t_phase, 3)})


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
                   "qwen2-vl-7b": (2048, 3584, 152064),
                   "gemma3-1b": (4096, 1152, 262144),
                   "mixtral-8x7b": (2048, 4096, 32000)}
K6_ROUTE = ("3xTF32 on the tensor cores: mma.sync.m16n8k8 TF32 products of hi/lo "
            "splits of each f32 operand, f32 accumulation")


def k6_bound(N, D, V, outputs=1):
    """(ms, by): x, w, targets read and ``outputs`` (N,) f32 outputs
    written once (1: the loss; 2: the partial form's lse and t); the
    operations of K6's route, 3 TF32 products per f32 product (2 N V D
    each) at the TF32 tensor-core peak."""
    t_bytes = 4 * (N * D + V * D + (1 + outputs) * N) / HBM_BYTES_PER_S
    t_ops = 3 * 2 * N * V * D / PEAK_TF32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k6_f32_bound_ms(N, D, V):
    """The same work's floor in f32 on the CUDA cores (any FFMA design)."""
    return 2 * N * V * D / PEAK_F32_OPS_PER_S * 1e3


def k6_timing_phase(torch, np, report, train_counts, sharded_k6) -> list:
    """K6 at each train cell's shape (``K6_TRAIN_SHAPES``), and at each
    (entry, N, D, V) that ``sharded_train`` launched for that arch or for
    a batch-1 cell of SEQ_SPLIT_TRAIN's with no lm_train cell, at its
    sequence, width and vocab (``sharded_k6``: K6's launches by
    (arch, entry, N, D, V, ...)): a data row's tokens over the whole vocab,
    or in the partial form over one model coordinate's vocab block; beside
    each block, the same row over the whole vocab as a reading (the first
    rows and the first block of the train shape's inputs,
    ``_xent_inputs``).  CUDA-event ms and profiler device ms,
    beside its plain version (``seq_chunked_xent`` / ``xent_block_ref``),
    the library call ``F.cross_entropy(x @ w.T, t, reduction="none")``
    (f32, TF32 off; for a block, the same matmul, log-sum-exp and target
    logit with the block's targets clamped into it) and its bound.  A
    kernels-line entry for each shape the main path launched."""
    import torch.nn.functional as F

    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent.kernel import fused_xent_fwd, fused_xent_part

    def launched(arch, entry, N, D, V):
        return sum(n for k, n in sharded_k6.items() if k[:5] == (arch, entry, N, D, V))

    by_arch = {}
    for k in sharded_k6:
        by_arch.setdefault(k[0], set()).add(k[1:5])
    all_shapes = dict(K6_TRAIN_SHAPES)
    for arch, (S, *_) in SEQ_SPLIT_TRAIN.items():
        if arch not in all_shapes:  # only the shapes sharded_train launched are timed
            cfg = cfgbase.get_config(arch)
            all_shapes[arch] = (S, cfg.d_model, cfg.vocab_size)
    if not set(by_arch) <= set(all_shapes):
        raise AssertionError(f"K6 timing: sharded_train ran {sorted(by_arch)}, "
                             f"K6_TRAIN_SHAPES and SEQ_SPLIT_TRAIN hold "
                             f"{sorted(all_shapes)}")
    entries = []
    for arch, (N, D, V) in all_shapes.items():
        x_all, w_all, t_all = _xent_inputs(torch, 66, N, D, V)
        rows = by_arch.get(arch, set())
        rows |= {("xent_fwd_f32", n, d, V) for e, n, d, _ in rows if e == "xent_part_f32"}
        if any(d != D or n > N or v > V for _, n, d, v in rows):
            raise AssertionError(f"K6 timing: {arch}'s sharded shapes {sorted(rows)} "
                                 f"outside its train shape {(N, D, V)}")
        shapes = ([("train loss", "xent_fwd_f32", N, V, train_counts[arch]["K6"])]
                  if arch in K6_TRAIN_SHAPES else [])
        shapes += [("sharded row, whole vocab" if entry == "xent_fwd_f32" else
                    "sharded row, a coordinate's vocab block", entry, n, v,
                    launched(arch, entry, n, D, v)) for entry, n, _, v in sorted(rows)]
        for mode, entry, n, v, launches in shapes:
            x, w, t = x_all[:n], w_all[:v], t_all[:n]
            tl = t.long()
            if entry == "xent_fwd_f32":
                kern = lambda: fused_xent_fwd(x, w, t)
                plain = lambda: xent_ref.seq_chunked_xent(x[None], w, t[None])
                library = lambda: F.cross_entropy(x @ w.T, tl, reduction="none")
                outputs = 1
            else:
                kern = lambda: fused_xent_part(x, w, t)
                plain = lambda: xent_ref.xent_block_ref(x[None], w, t[None], 0)
                tc = tl.clamp(0, v - 1)
                library = lambda: F.cross_entropy(x @ w.T, tc, reduction="none")
                outputs = 2
            with torch.no_grad():
                got, want = kern(), plain()
                if outputs == 1:
                    err = float((got - want[0]).abs().max())
                    lib_err = float((library() - want[0]).abs().max())
                else:
                    err = max(float((a - b[0]).abs().max()) for a, b in zip(got, want))
                    lib_err = None
                del got, want
                t_ = {"ms": event_ms(torch, kern, iters=10, warmup=2),
                      "plain_ms": event_ms(torch, plain, iters=3, warmup=1),
                      "library_ms": event_ms(torch, library, iters=10, warmup=2),
                      "device_ms": device_ms(torch, kern, iters=5),
                      "plain_device_ms": device_ms(torch, plain, iters=2),
                      "library_device_ms": device_ms(torch, library, iters=5)}
            bms, bby = k6_bound(n, D, v, outputs)
            report.emit({"phase": "timing", "kernel": "K6", "entry": entry, "arch": arch,
                         "mode": mode, "shape": f"N={n} D={D} V={v} f32 ({arch} {mode})",
                         "launches": launches, "max_abs_err": err,
                         "library_max_abs_err": lib_err, "route": K6_ROUTE,
                         "bound_ms": bms, "bound_by": bby,
                         "f32_cuda_core_bound_ms": k6_f32_bound_ms(n, D, v),
                         "library": "F.cross_entropy(x @ w.T, t, reduction='none'), f32, "
                                    "TF32 off", **t_})
            if launches:
                entries.append({
                    "name": f"K6 {entry} [{arch} {mode}, N={n} D={D} V={v}]",
                    "route": "cuda", "source": "src/repro_torch/csrc/xent_fwd.cu",
                    "replaces": "src/repro/kernels/xent/kernel.py:23",
                    "launches": launches, "max_abs_err": err, "ms": t_["ms"],
                    "plain_ms": t_["plain_ms"], "bound_ms": bms, "bound_by": bby,
                    "library_ms": t_["library_ms"], "device_ms": t_["device_ms"]})
        del x_all, w_all, t_all, x, w, t, tl
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
    ap.add_argument("--examples-only", action="store_true",
                    help="build, run the repo's entry points on the port (the examples "
                         "phase) and stop")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build, check K5, K6 and K7, run the sharded_train, sharded_mixed, "
                         "reshard, sharded_serve and pipeline phases and stop (on a "
                         "machine of four cards: the meshes over distinct cards)")
    ap.add_argument("--mixtral-only", action="store_true",
                    help="build, check K5 and K6, serve Mixtral-8x7B at full width and "
                         "depth over (1, 4) or (1, 2) distinct cards (the mixtral_sharded "
                         "phase) and stop; exits 2 with fewer than two cards")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 - fails here outside a checkout

    if args.mixtral_only and not mixtral_cards(torch):
        print(f"chip_smoke: --mixtral-only needs {MIXTRAL_MODEL_AXES[-1]} cards or more "
              f"(Mixtral-8x7B's 93.4 GB of bf16 weights are over one card); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

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

    if args.examples_only:
        examples_phase(report)
        return stop_early()
    if args.mixtral_only:
        k5_checks(torch, np, report)
        k6_checks(torch, report)
        mixtral_sharded_phase(torch, np, report, [torch.device("cuda", i)
                                                  for i in range(mixtral_cards(torch))])
        return stop_early()
    if args.sharded_only:
        k5_checks(torch, np, report)
        k6_checks(torch, report)
        k7_checks(torch, np, report)
        state, step, _ = sharded_train_phase(torch, np, report)
        sharded_mixed_phase(torch, np, report)
        reshard_phase(torch, np, report, state, step)
        del state, step
        torch.cuda.empty_cache()
        sharded_serve_phase(torch, np, report)
        pipeline_phase(torch, np, report)
        return stop_early()
    k1_checks(torch, np, report)
    k2_checks(torch, np, report)
    dw_checks(torch, np, report)
    strided_view_checks(torch, np, report)
    k5_checks(torch, np, report)
    k6_checks(torch, report)
    k7_checks(torch, np, report)
    grad_checks(torch, np, report)
    engines = engine_phase(torch, np, report)
    scan_entry_phase(torch, np, report, engines)
    mesh_phase(torch, np, report, engines)
    if args.mesh_only:
        return stop_early()
    stream_phase(torch, np, report)
    report_phase(torch, np, report)
    residual_phase(torch, np, report)
    c_export_phase(torch, np, report, engines)
    examples = examples_phase(report)
    lm_counts = lm_engine_phase(torch, np, report)
    encdec_k5 = encdec_phase(torch, np, report)
    kv_int8_phase(torch, np, report)
    lm_strict_phase(torch, np, report)
    rwkv_drift_phase(torch, np, report)
    train_counts = lm_train_phase(torch, np, report)
    train_strict_phase(torch, np, report)
    remat_dots_phase(torch, np, report)
    state, step, sharded_counts = sharded_train_phase(torch, np, report)
    sharded_mixed_phase(torch, np, report)
    reshard_phase(torch, np, report, state, step)
    del state, step
    torch.cuda.empty_cache()
    serve_keys = sharded_serve_phase(torch, np, report)
    pipeline_phase(torch, np, report)
    entries = timing_phase(torch, np, report, engines)
    entries += lm_timing_phase(torch, np, report, lm_counts, train_counts, encdec_k5,
                               serve_keys, sharded_counts,
                               examples["torch_serve_llm"]["kernels"]["K5"])
    entries += k6_timing_phase(torch, np, report, train_counts, sharded_counts["K6"])
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
