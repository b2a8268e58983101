#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``beforeholiday_tpu_torch``) on one
NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA source compiled by nvcc (in parallel), from the
   sources in the checkout (the Triton kernels compile at their first
   launch);
3. K1 (LayerNorm forward, CUDA C++) against its plain version at the
   engine's and the training step's shapes and at awkward ones (fp16, a
   strided view, rows not 16-byte aligned, hidden 16384 and 1001), each
   call twice and bitwise equal, strided views bitwise their contiguous
   copies, decode's 32 rows bitwise the same rows inside a prefill call, an
   empty call launching nothing; timed beside its bound and
   ``F.layer_norm``;
4. K2 (flash-attention forward, CUDA C++) against its plain version at the
   prefill, decode, GPT and BERT training shapes and at lengths off its
   tiles, timed beside its bound and ``F.scaled_dot_product_attention``
   (``is_causal`` on (B, H, S, D) with no mask where every length is full,
   the boolean mask where lengths are ragged); its decode path (Sq < 16)
   also at 9 and 15 query rows and at its chunks' edges, two calls bitwise
   equal, and timed at the engine's decode shape in bf16, fp32 and with
   dropout; then its paged mode at the engine's decode bucket (``K2_paged``:
   against its plain version, bitwise against the contiguous mode on the
   gathered, narrowed copies, timed beside its bound, its plain version and
   the gather chain it replaces);
5. K3-K12 (LayerNorm backward, CUDA C++, its dgamma/dbeta held bitwise
   equal across two calls; unscale, fused Adam, global sum of squares,
   LAMB stage 1, the trust-ratio update, fused SGD and the scaled masked
   softmax forward and backward, Triton; flash attention backward, CUDA
   C++, called twice and held bitwise equal) against their plain versions
   at the training shapes and at awkward ones (for K11/K12: sk not a power
   of two, sq not a multiple of 128, sk = 16384, fp32 and fp16, fully
   masked rows; for K4: lengths off its tiles), each timed beside its bound
   and a library call: the same function where one PyTorch call computes
   it, else the same traffic;
6. engine parity: the full-width bf16 GPT engine on the kernels against the
   same engine on the plain path, and paged decode against the contiguous
   forward; each decode call on the kernels launches K2's paged mode once a
   layer, the contiguous K2 never, and gathers no page;
7. serving: seeded requests through ``ContinuousBatcher.run()``, with bucket
   padding and preemption, the kernels' launch counts reset just before and
   read just after (K2 once a layer a prefill call, its paged mode once a
   layer a decode call); then the same mix again under ``torch.profiler``
   for the device time by layer, by page op (gathers, casts, copies,
   scatters) and the device's idle share; then ``decode_profile``: the
   decode step alone at the largest bucket (32 sequences of ~500 cached
   tokens), timed and profiled;
8. GPT step parity: one full-width amp O5 arena-native FusedAdam step at
   batch 2 on the kernels against the same step on the plain path;
9. GPT skip step: an overflowing step leaves the state bitwise unchanged and
   halves the dynamic loss scale;
10. GPT training: the flagship (``bench.py`` ``make_gpt_rung``) at batch 16
    on one fixed batch, 2 warm-up and TIMED_STEPS timed steps with the launch counts
    reset just before and read just after, under
    ``set_sync_debug_mode("warn")``; then several steps under
    ``torch.profiler``;
11. GPT with unfused attention (``use_flash_attention=False``: materialized
    scores, K11/K12, ``probs @ v``): the parity step, the unfused logits
    and loss against flash attention's on the same weights and batch, and
    the training phase;
12. BERT step parity, skip step and training: the same three phases for
    BERT-Large (8 layers) with FusedLAMB (``bench.py`` ``make_bert_rung``,
    ``bert_large_8layer_b128``), the parity step at batch 2 with ragged
    sequence lengths; then BERT with unfused attention as in 11, the
    key-padding mask built on the card from the lengths;
13. dropout (slice 6): K13 (the keep mask, CUDA C++) bitwise against its
    twin at the attention and hidden shapes, with the kept fraction within
    6 sigma of binomial; K2/K4 with in-kernel dropout against their plain
    versions fed the same key (the GPT and BERT shapes, fp32, and head dims
    8, 40, 256 and 512 with and without dropout, which only the CUDA-core
    row kernels take), K2, K4 and K13 dropping the same slots, and the laws
    of ``testing/tpu_checks.py`` ``check_flash_dropout``; the
    ``bench.py`` ``make_flash_dropout_rungs`` rung (causal, rate 0.1, B 2,
    H 16, S 4096, D 64, forward and backward) against the materialized
    plain path and ``F.scaled_dot_product_attention(dropout_p=0.1)``;
    then the GPT and BERT steps at dropout 0.1/0.1 with a per-step key
    folded from the device step count, flash and unfused: the parity step
    (same key, so the same masks), the skip step, flash against unfused on
    one key, and the timed and profiled run with K13's launches counted;
14. the fused label-smoothing cross entropy (slice 7): K14 and K15
    (``contrib/xentropy.py``, Triton) against their plain versions at the
    GPT head's shape (16,384 x 32,000, fp32 and bf16), BERT's (V 30,522),
    V 50,257 in bf16 and N 11 x V 96 in fp16, each timed beside its bound
    and ``F.cross_entropy``; the public ``softmax_cross_entropy_loss`` on
    the card with padded rows (loss and gradient exactly 0 there) and
    ``half_to_float``; then the flagship GPT step with this loss as a user
    script writes it (smoothing 0.1, padding index 0, the first 32 targets
    padded, the sum over the unpadded count) and the BERT step with its MLM
    term (padding index [MASK] over the unmasked positions, smoothing 0):
    the parity step, the skip step, BERT-xent against the ``pretrain_loss``
    step on the same weights and batch, and the timed and profiled run with
    K14's and K15's launches counted and the loss's device ms in its own
    column (the other steps' loss: ``logsumexp``, ``gather`` and their
    backward);
15. ResNet-50 (``bench.py`` ``make_resnet_rung``, the ``examples/imagenet``
    trainer with FusedSGD): one full-width O5 step at batch 2 on K5/K10
    against the plain path, an inf-weighted step that must change nothing,
    and the O5 and O0 trainers at batch 128 on one fixed batch (TIMED_STEPS
    timed steps with the launch counts held, then PROFILE_STEPS profiled ones), MFU from the
    convolutions' and ``fc``'s shapes;
16. slice 8, the last three TPU kernels: K16 (axpby with its non-finite
    flag), K17 (Adagrad) and K18 (NovoGrad, the per-tensor denominators
    read through K8's segment table), all Triton, against their plain
    versions at ResNet-50's arenas, odd lengths, both modes, bf16 and fp32,
    each ``arg_to_check`` and skipped steps, the padding held at 0; then
    five O5 ResNet-50 paths at batch 128: the FusedSGD trainer accumulating
    two micro-batches of 64 (Apex's ``unscale_with_stashed`` form on K16),
    and the trainer with FusedAdagrad, FusedNovoGrad, FusedLARS and
    ``use_larc`` (LARC around FusedSGD, at weight decay 0) on the list
    path. Each: the parity step at batch 2 with cuDNN deterministic (the
    gradients bitwise, masters and state within an ulp), the skip step, and
    the timed and profiled run with the optimizer step's own device ms;
17. slice 11, data parallel over ``torch.distributed`` (K5 also at
    ResNet-50's bf16 gradient arena above): a one-rank NCCL world through a
    FileStore in a temporary directory; ``ddp_world1_parity`` (ResNet-50
    at batch 2, cuDNN deterministic: the distributed O5 step with
    unsynchronized BN bitwise the one-device step, with one collective an
    arena, 4 MiB buckets and the backward-time hooks; the compressed
    reduction within its bound; SyncBN on K5/K10 against the plain path,
    and at O0 against the one-device step; one step's ledger);
    ``ddp_two_rank_card`` (two spawned processes on the one card, gloo on
    CUDA tensors, SyncBN, 4 MiB buckets, against one rank at the whole
    batch; O5, O5 with the hooks, O0); ``ddp_guard`` (the guarded world-1
    step: skip reasons, bitwise skips, rollback, the health state dict);
    and the batch-128 SyncBN step timed and profiled after the gradients,
    with the backward-time hooks and guarded (collectives a step from the
    ledger, NCCL's device ms among the profile's columns);
18. slice 13, amp O1-O4: K2 and K4 in fp16 against their plain versions
    (the GPT shape with and without dropout, BERT's with ragged lengths,
    head dim 40 on the row kernels; K4 twice, bitwise), fp16 into K2's
    decode and paged modes refused, K10 on ResNet-50's fp16 parameter arena
    with fp32 momentum, and the launch floors (an empty Triton kernel and an
    empty CUDA kernel launched through ``ctypes``, through the same timing
    harness); the flagship GPT at O2 (flash and unfused), O1
    and O4: the parity step at batch 2 (a static scale of 2^10), O2's skip
    step, and the timed and profiled run at batch 16 with its skipped steps
    and final loss scale; ResNet-50 at O2 (parity at batch 2 with cuDNN
    deterministic, and a step from a dynamic scale of 2^24 that overflows,
    changes nothing and halves the scale), then O2, O1, O3 and O4 at batch
    128, timed and profiled; the DCGAN example at O2 (K5 and K6 on its
    trees and one iteration on the kernels against the plain path, cuDNN
    deterministic; then 20 iterations at batch 32, its three per-loss
    scalers through their state dicts);
19. slice 14, amp O6 and e4m3 KV pages: the fp8 tier's parts at the
    flagship's four block GEMM shapes and a ragged one (``o6_gemm``: the
    e4m3 and e5m2 bytes bitwise the CPU's, each of the three products on
    ``torch._scaled_mm`` within its bound of the plain product and timed
    beside the O5 step's bf16 product and the fp8 bound; ``o6_quantize``:
    the op within ``quantized_matmul_error_bound``, the quantize passes
    timed); the engine on e4m3 pages (kernels against the plain path, K2's
    contiguous decode path once a layer a decode call and its paged mode
    never; against fp32 pages within ``kv_logit_error_bound``; the serving
    mix and its profile); the flagship GPT at O6 (the parity step at batch
    2 from a warm amax history against the plain path, its products plain
    too, and against unfused attention's spread; the poisoned history's
    skip through ``scaled_value_and_grad`` and ``StepGuard``; the timed and
    profiled run at batch 16 with 32 forward and 64 backward fp8 products
    a step, none plain, the fp8-aware MFU, the final scale and history, and
    the profile's ``fp8_gemm`` and ``fp8_quantize`` ranges; 50 steps against
    O5 within ``loss_parity_bound``);
20. slice 15, Megatron tensor + pipeline parallel (BASELINE config 5):
    ``tp_layers_world1`` (NCCL at world 1, the flagship's shapes: every TP/SP
    mapping, the column- and row-parallel layers, the vocab-parallel
    embedding and ``sp_fused_layer_norm`` on K1/K3 bitwise against their
    dense counterparts, forward and backward; the vocab-parallel cross
    entropy at smoothing 0 and 0.1 within K14's and K15's bounds);
    ``gpt_tp_pp_world1`` (the flagship's O5 step through the TP forward at
    tensor 1 x pipe 1 under ``forward_backward_no_pipelining`` and the 1F1B
    engine: one microbatch at batch 2 and 4 microbatches at batch 16
    against the one-device O5 step, then each schedule timed and profiled
    at batch 16 beside that step's median, launches and host syncs held);
    ``gpt_tp2_card`` (two spawned ranks on the one card over gloo on CUDA
    tensors, tensor parallel 2, sequence parallel off and on, an O5 step
    each at batch 16, against the one-device step; a correctness run: gloo
    stages through the host); and
    the new kernel shapes (``tp_shape`` lines: K1/K3 at 8192 and 4096 rows,
    K2/K4 at BH 128 and 64, K5/K6 at a TP 2 shard's arena);
21. slice 16, the rest of the serving tier: K2's paged mode over bf16 and
    fp16 pools at the engine's decode bucket (``K2_paged`` lines: against
    its plain version, bitwise the contiguous mode on the gathered copy,
    twice bitwise, bitwise the fp32 pools' launch on the same values, timed
    beside its bound, the fp32 pools and the gather chain);
    ``pages16_parity`` (the flagship engine on bf16 pages bitwise its fp32
    pages' logits, fp16 pages within 0.1, paged launches and no gather; the
    page bytes of every page dtype); the serving mix on bf16 pages (every
    stream the fp32 pages') and fp16 pages (agreement printed);
    ``prefix_serving`` (the driver's prefix-heavy trace through the radix
    prefix cache against the uncached run: hits, fewer prefill tokens, radix
    evictions, no leak, decode-extend logits against a fresh prefill);
    ``disagg_serving`` (prefill/decode disaggregation against the unified
    batcher: the signature gate closed, TTFT and tokens/s); ``serve_driver``
    (the open-loop driver with telemetry, then its crash dump);
22. slice 17, the rest of ``apex.transformer``: at world 1 over NCCL,
    ``cp_world1`` (ring attention over a context group of one, bitwise the
    causal flash launch, forward and gradients), ``collective_matmul_world1``
    (the collective matmul bitwise the monolithic sequence-parallel
    column-parallel path at the QKV shape, y and every gradient) and
    ``bert_tp_world1`` (BERT's TP forward bitwise its dense forward, sequence
    parallel off and on); ``gpt_tp2_card`` also runs the two ranks at
    dropout 0.1 (sequence parallel off and on) against the one-device
    dropout step at the same key; ``rank_place`` (K2, K4 and K13 at each TP
    2 rank's place bitwise the one-device launch's slice) with the places'
    timed rows; ``ring_attention`` (a context group of 8 emulated rank by
    rank at B 1, H 16, S 16384, D 64 bf16 through the port's hops and merge,
    K2 and K4 with dlse, against one whole-sequence launch; at S 2048 in fp32
    against the plain versions' ring) with the hops' timed rows;
23. slice 18, remat policies and the training monitor: at world 1 over
    NCCL, ``remat_1f1b_world1_parity`` (the 1F1B engine with its stage under
    "full" against the plain engine, batch 16 in TP_MICRO microbatches) and
    its timed run (each microbatch's blocks recomputed); on the flagship O5
    GPT step, ``remat_parity`` (each policy's step at batch 2 against the
    "none" step, bitwise or within that step's own rerun spread; its GEMMs
    counted under a dispatch mode: "dots_saveable" recomputes none, "full"
    and "save_boundaries" some) and
    ``remat_dropout_parity`` (the dropout step under "full": K13 redraws its
    masks in the recompute); each policy's monitored timed run (``remat:``
    lines: ``track_costs`` and ``track_memory`` on the step, a
    ``TrainMonitor`` updated every step, global norm on K9, a
    ``MetricsLogger`` copying every LOG_EVERY-th step; ms, peak GB, the
    allocator's temp_bytes, K2/K4 launches, no port sync but the logger's
    copies, "full"'s peak below "none"'s and "dots_saveable"'s) and the
    roofline ledger's MFU
    beside 6 N's (``roofline:``); BERT-Large 8 layers with FusedLAMB under
    "save_boundaries" (parity, timed run); ``imagenet_monitor`` (the
    ImageNet trainer's CLI on ResNet-50 with ``--profile-dir`` and
    ``--flight-recorder``: the trace parses and holds CUDA kernels, the
    flight dump holds every printed step);
24. slice 20, ZeRO-2 and ZeRO-3: ``zero_world1`` (NCCL at world 1: the
    flagship's O5 step on ``DistributedFusedAdam`` bitwise the FusedAdam
    step, masters, moments and model; ``ZeRO3FusedAdam`` bitwise ZeRO-2
    under "keep" and "regather" and at prefetch 0, 1 and 2, "regather"
    with twice the gathers; ``overlap_backward`` bitwise the phased step;
    the compressed step within its bound; BERT's ``DistributedFusedLAMB``
    against FusedLAMB; overflowing ZeRO-2 and LAMB steps held bitwise);
    the timed and profiled runs (``zero2``, ``zero3_keep``,
    ``zero3_regather``, ``bert_zero2_lamb``: ms, idle share, peak GB,
    state bytes, collectives and bytes a step from the ledger, beside the
    O5 FusedAdam and FusedLAMB medians, no port sync);
    ``zero_two_rank_card`` (two gloo ranks on the card at batch 8 each, the
    flagship at full width and 2 of its 8 layers since PR 21:
    ZeRO-2, compressed ZeRO-2 where gloo takes ``all_to_all`` on CUDA
    tensors, ZeRO-3; the ranks' models bitwise equal, ZeRO-3 bitwise
    ZeRO-2, ZeRO-2 against one NCCL rank at batch 16, state bytes halved);
    K6 at the flagship's world-2 shard, K7 and K8 at rank 1's shard of
    BERT's world-2 arena (K8 on its shard tables);
25. slice 21, the two-level (slice x intra) engines and the optimizer in
    the backward: ``multislice_world1`` (NCCL at world 1 inside
    ``make_two_level_mesh(1, 1)``: DDP, ZeRO-2 and ZeRO-3 "keep" with
    ``hierarchical=True`` each bitwise its flat step over the same spec,
    with the same collectives on the ledger) and ZeRO-2 hierarchical's
    timed run beside flat ZeRO-2's (``zero2_hier``); the flagship GPT at O5
    on FusedAdam and ResNet-50 at O5 on FusedSGD with the overlap hooks and
    ``MasterWeights.step_in_backward`` (``gpt_step_in_backward``,
    ``resnet_step_in_backward``: bitwise the phased step; an inf in one
    leaf skips the whole step, every arena, master, moment and count, and
    the dynamic scale halves), their timed runs (``gpt_oib``,
    ``resnet_oib``: K6's or K10's views mode, one launch an arena, no
    unscale) and the views tables each run built; ``multislice_card``
    (four gloo ranks on the card, a 2 x 2 carve, batch 4 a rank, the flagship
    at full width and 2 of its 8 layers: ZeRO-2 and
    ZeRO-3 hierarchical bitwise flat, the DDP reduce too with DCN bytes at
    half the flat reduce's, the four per-tier compression choices within
    their bound on a prefix of the step's gradients, the tripwire clean and
    tripped by rank 3 of slice 1, the 2 x 2 ZeRO-2 step against one NCCL
    rank at batch 16); K6's and K10's views mode against their plain
    versions and bitwise against the arena launch (``adam_views``,
    ``sgd_views``);
26. slice 22, Mixture-of-Experts: ``moe_layer_card`` (``moe_layer``
    against ``dense_oracle`` at the flagship's width, one group of 4096
    tokens, fp32 and bf16, no (T, E, C) tensor; the drop fraction at
    capacity factor 1.0 against the analytic count); the flagship GPT with
    ``moe_every=2`` (4 experts, top-2, capacity factor 1.25) at O5:
    ``moe_gpt_step_parity`` and ``moe_gpt_skip_step`` (2 layers, batch 2,
    kernels against the plain path), ``moe_gpt_training`` (8 layers, batch
    16: K1-K6 launches, no port host sync, MFU from the counted FLOPs), the
    router's scalars through ``TrainMonitor`` (``moe_gpt_router``) and the
    profiled split into router, dispatch/combine, experts and the rest
    (``moe_gpt_profile``); ``moe_ep_card`` (the ``moe_gpt`` example as four
    gloo ranks on the card, 2 x 2 and 1 x 4, full width at 2 layers, against
    the one-process all-experts-local reference);
27. slice 23, elastic training and the autotuner, on the flagship's O5
    step on ``ZeRO3FusedAdam`` ("keep") under a StepGuard:
    ``elastic_ckpt_card`` (``ElasticTrainer`` at world 1 over NCCL, batch
    16, 8 steps with a generation every 2 against the same steps without
    checkpoints: each step's ms, the ``ckpt`` ledger's stalls per phase and
    generation, the generation's bytes, K1-K6 launches; losses and final
    shard bitwise; the newest generation restored and 2 steps on, bitwise
    the uninterrupted run's); ``tune_card`` (``tune()`` over opt_level, the
    four remat policies and ZeRO-3 prefetch, 6 trials of 3 CUDA-event-timed
    steps with costs and memory on each trial's entry; the second search a
    cache hit with 0 trials; ``amp.initialize(tuned=True)`` and
    ``ZeRO3FusedAdam(tuned=True)`` resolving the manifest, explicit keywords
    winning, a miss warning once); ``elastic_kill_card`` (the SIGKILL drill:
    a spawned child killed with ``faults.kill_rank`` once generation 4 is
    durable, mid-write of the next if the timing allows; a fresh child
    restores at world 1 and runs to step 8, bitwise the uninterrupted run);
    ``elastic_resize_card`` (two gloo ranks, full width at 2 layers: a
    preemption naming world 1, a hang, a tripwire on a perturbed replica,
    each continuation bitwise a fresh world-1 restore of its generation,
    rank 1 leaving each run);
28. the total seconds, each phase's wall seconds (``phase_seconds``), the
    ``kernels`` JSON line (with ``launch_floor_ms``, the Triton floor, and
    ``launch_floor_cuda_ms``), the card line, and the
    final ``ok`` line.

``F.layer_norm``, ``F.scaled_dot_product_attention``, their backwards,
``torch._amp_foreach_non_finite_check_and_unscale_``,
``torch._fused_adamw_``, ``torch.linalg.vector_norm``,
``torch._fused_sgd_``, ``torch.softmax``,
``torch._softmax_backward_data``, ``F.cross_entropy(x, y,
reduction="none", label_smoothing=s, ignore_index=padding_idx)`` with its
autograd backward, ``Tensor.bernoulli_``, ``torch.add(x, y, alpha=b)`` and
``torch.optim.Adagrad(foreach=True).step`` are timed here only, as
yardsticks (``library_ms``); the port never calls them. No single PyTorch
call computes LAMB or NovoGrad, so K7, K8 and K18 have none; the library
softmax applies no scale and no mask, so K11's and K12's measure the same
traffic, not the same function, as ``torch.add`` does for K16 (no flag, a
of 1). No PyTorch call computes K13's hash: ``bernoulli_`` on a bool
tensor does the same work with other random bits, as the library's
attention dropout does for K2's and K4's dropout rows. ``torch._scaled_mm``
is not a yardstick: it is the port's fp8 GEMM (``ops/quantized.py``), a
library call, as the JAX package's fp8 ``dot_general`` is XLA's, so it
has its own ``o6_gemm`` lines and no row on the ``kernels`` line.
"""

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s for bf16 tensor cores and fp32 outside them
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
# the dropout hash's integer work, in SASS instructions of the busier of the
# two pipes that run it (csrc/dropout_mask.cu, cuobjdump -sass on sm_90a): a
# Philox4x32-10 call (four elements) is ten rounds of two IMAD.WIDE.U32 (both
# words of a 32x32 multiply) on the FMA-heavy pipe, 20 instructions, and on
# the ALU pipe ten rounds of two LOP3 (the three-way xors), 4 ISETP (the
# threshold compares), 4 SEL (a byte per element) and a LOP3 merging the
# bytes, 29 instructions: 7.25 an element. Each pipe retires 64 a clock on
# an SM: 64 x 132 SMs x 1980 MHz (clocks.max.sm) = 16.7e12 a second. (PR 9
# counted 26.5 operations an element against the 67 T/s fp32 rate, a bound
# 0.91 times this one.)
PEAK_INT32 = 64 * 132 * 1.98e9
PHILOX_OPS_PER_ELEMENT = 29 / 4

# the flagship GPT (bench.py make_gpt_rung) and its serving geometry
MODEL = dict(vocab_size=32000, seq_len=1024, d_model=1024, n_heads=16,
             n_layers=8, dtype=torch.bfloat16)
ENGINE = dict(max_seq_len=1024, page_size=16, num_pages=2049,
              batch_buckets=(8, 16, 32),
              prefill_seq_buckets=(128, 256, 512, 1024),
              weights_dtype="bfloat16")
# the serving run's pool: 32 resident requests of at most 64 pages each can
# never exhaust 2048 usable pages, so the run uses 768 to force preemption
SERVE_PAGES = 769
N_REQUESTS = 32
# the training step (bench.py make_gpt_rung: FusedAdam(lr=1e-4), batch 16)
TRAIN_BATCH = 16
PARITY_BATCH = 2
LR = 1e-4
# ROADMAP A29, the run's time budget: 6 timed and 2 profiled steps a run and
# 10 timed calls a kernel time (5 and 3 for the slow plain versions); they
# were 10, 3 and 20 until the run passed 850 s of its 1200
WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 2, 6, 2
# BERT-Large + FusedLAMB (bench.py make_bert_rung, bert_large_8layer_b128:
# bert_large(seq_len=128, n_layers=8, dtype=bf16), FusedLAMB(lr=1e-3,
# weight_decay=0.01), batch 128, no dropout)
BERT = dict(vocab_size=30522, seq_len=128, d_model=1024, n_heads=16,
            n_layers=8, dtype=torch.bfloat16)
BERT_BATCH = 128
BERT_LR = 1e-3
BERT_PARITY_LENS = (128, 77)
# dropout as the published configurations train (GPT-2: resid_pdrop and
# attn_pdrop 0.1; BERT: hidden_dropout_prob and attention_probs_dropout_prob
# 0.1); the base key of the dropout steps
DROPOUT = dict(dropout_rate=0.1, attention_dropout=0.1)
DROPOUT_SEED = 2024
# kernel launches per training step, by wrapper. GPT: 2 LayerNorms per layer
# plus the final one, one attention per layer, one unscale and one Adam pass
# per arena (bf16 and fp32). BERT: the embedding LayerNorm, 2 per layer and
# the MLM head's, one attention per layer, and per arena one unscale, one
# K9 call (the global grad norm), one K7 and one K8 pass; a K9 call is two
# launches of its Triton kernels (partials, then the fixed-order sum) and
# counts once, as K3's two do
# ResNet-50 (bench.py make_resnet_rung): one unscale and one SGD pass per
# arena at O5 (bf16 convs and fc, fp32 BN); at O0 one fp32 bucket, so one
# of each on the list path. Slice 8: accumulating two micro-batches
# unscales each (two arenas each) and adds them per arena (K16) before the
# SGD passes; the list-path optimizers at O5 unscale the bf16 and fp32
# gradient buckets and update the one fp32 master bucket in one pass (K17,
# K18, or K10 for LARS and LARC). Unfused attention: one softmax forward and one
# backward per layer in place of the flash pair
_NO_LAUNCH = {"layer_norm_fwd": 0, "layer_norm_bwd": 0, "flash_fwd": 0,
              "flash_bwd": 0, "unscale": 0, "adam": 0, "l2norm": 0,
              "lamb_stage1": 0, "scaled_update": 0, "sgd": 0,
              "softmax_fwd": 0, "softmax_bwd": 0, "dropout_mask": 0,
              "xent_fwd": 0, "xent_bwd": 0, "axpby": 0, "adagrad": 0,
              "novograd": 0, "paged_decode": 0, "adam_views": 0, "sgd_views": 0}
_GPT_STEP = {"layer_norm_fwd": 17, "layer_norm_bwd": 17, "unscale": 2,
             "adam": 2}
_BERT_STEP = {"layer_norm_fwd": 18, "layer_norm_bwd": 18, "unscale": 2,
              "l2norm": 2, "lamb_stage1": 2, "scaled_update": 2}
_FLASH = {"flash_fwd": 8, "flash_bwd": 8}
_UNFUSED = {"softmax_fwd": 8, "softmax_bwd": 8}
# dropout: K13 draws the embedding site's mask and two hidden sites' a layer
# (17), and on the unfused path each layer's probabilities' too (25); K2/K4
# drop in-kernel; nothing regenerates a mask in the backward (no remat)
_HIDDEN_DROP = {"dropout_mask": 17}
_UNFUSED_DROP = {"dropout_mask": 25}
# the fused cross entropy as the loss: one K14 and one K15 a step
_XENT = {"xent_fwd": 1, "xent_bwd": 1}
STEP_LAUNCHES = {
    "gpt": {**_NO_LAUNCH, **_GPT_STEP, **_FLASH},
    "bert": {**_NO_LAUNCH, **_BERT_STEP, **_FLASH},
    "gpt_unfused": {**_NO_LAUNCH, **_GPT_STEP, **_UNFUSED},
    "bert_unfused": {**_NO_LAUNCH, **_BERT_STEP, **_UNFUSED},
    "gpt_dropout": {**_NO_LAUNCH, **_GPT_STEP, **_FLASH, **_HIDDEN_DROP},
    "gpt_unfused_dropout": {**_NO_LAUNCH, **_GPT_STEP, **_UNFUSED, **_UNFUSED_DROP},
    "bert_dropout": {**_NO_LAUNCH, **_BERT_STEP, **_FLASH, **_HIDDEN_DROP},
    "bert_unfused_dropout": {**_NO_LAUNCH, **_BERT_STEP, **_UNFUSED,
                             **_UNFUSED_DROP},
    "gpt_xent": {**_NO_LAUNCH, **_GPT_STEP, **_FLASH, **_XENT},
    "bert_xent": {**_NO_LAUNCH, **_BERT_STEP, **_FLASH, **_XENT},
    "resnet_o5": {**_NO_LAUNCH, "unscale": 2, "sgd": 2},
    "resnet_o0": {**_NO_LAUNCH, "unscale": 1, "sgd": 1},
    "resnet_o5_accum": {**_NO_LAUNCH, "unscale": 4, "axpby": 2, "sgd": 2},
    "resnet_o5_adagrad": {**_NO_LAUNCH, "unscale": 2, "adagrad": 1},
    "resnet_o5_novograd": {**_NO_LAUNCH, "unscale": 2, "novograd": 1},
    "resnet_o5_lars": {**_NO_LAUNCH, "unscale": 2, "sgd": 1},
    "resnet_o5_larc": {**_NO_LAUNCH, "unscale": 2, "sgd": 1},
    # slice 11: the data-parallel step reduces the still-scaled gradient
    # arenas, then unscales and updates each as the one-device step does
    "ddp_resnet": {**_NO_LAUNCH, "unscale": 2, "sgd": 2},
    # slice 13, amp O1-O4: O2 as O5 (an fp16 and an fp32 arena); O1, O3 and
    # O4 on the list path with one gradient dtype (fp32 at O1/O4, where the
    # params are fp32; fp16 at O3, where every leaf is) and one K10 bucket
    "resnet_o2": {**_NO_LAUNCH, "unscale": 2, "sgd": 2},
    "resnet_o1": {**_NO_LAUNCH, "unscale": 1, "sgd": 1},
    "resnet_o3": {**_NO_LAUNCH, "unscale": 1, "sgd": 1},
    "resnet_o4": {**_NO_LAUNCH, "unscale": 1, "sgd": 1},
    # the GPT: O2 as O5; O1/O4 one fp32 gradient bucket on the list path
    # (one K5 and one K6 launch)
    "gpt_o2": {**_NO_LAUNCH, **_GPT_STEP, **_FLASH},
    "gpt_o2_unfused": {**_NO_LAUNCH, **_GPT_STEP, **_UNFUSED},
    "gpt_o1": {**_NO_LAUNCH, **_GPT_STEP, "unscale": 1, "adam": 1, **_FLASH},
    "gpt_o4": {**_NO_LAUNCH, **_GPT_STEP, "unscale": 1, "adam": 1, **_FLASH},
    # slice 14, O6: O5's launches, and the 4 block GEMMs of each layer on
    # the fp8 tier: one product forward, two backward (dx, dw), none plain
    "gpt_o6": {**_NO_LAUNCH, **_GPT_STEP, **_FLASH, "fp8_forward": 32,
               "fp8_backward": 64, "plain_forward": 0, "plain_backward": 0},
    # slice 15, the O5 step over TP x PP at world 1: every one of the
    # TP_MICRO microbatches runs the 17 LayerNorms and 8 attentions forward
    # and backward (the 1F1B engine's forward slot on the last stage only
    # stores its input, and the backward slot recomputes it); one unscale
    # and one Adam pass an arena a step
    "gpt_tp_pp_none": {**_NO_LAUNCH, "layer_norm_fwd": 17 * 4,
                       "layer_norm_bwd": 17 * 4, "flash_fwd": 8 * 4,
                       "flash_bwd": 8 * 4, "unscale": 2, "adam": 2},
}
STEP_LAUNCHES["gpt_tp_pp_1f1b"] = STEP_LAUNCHES["gpt_tp_pp_none"]
# slice 18, remat: the recompute repeats the blocks' 16 LayerNorms and 8
# attentions forward under "full" and "dots_saveable" (their outputs are not
# dot products); "save_boundaries" saves both (the norm output, the context
# and its lse), so nothing repeats. The monitored runs add global_norm's K9
# over the two gradient arenas. The 1F1B engine under "full" recomputes its
# stage (the blocks) once more in each microbatch's backward slot
_RECOMPUTE = {"layer_norm_fwd": 16, "flash_fwd": 8}
REMAT_POLICIES = ("none", "full", "dots_saveable", "save_boundaries")
for _p in REMAT_POLICIES:
    _r = _RECOMPUTE if _p in ("full", "dots_saveable") else {}
    STEP_LAUNCHES[f"gpt_remat_{_p}"] = {
        **STEP_LAUNCHES["gpt"], "l2norm": 2,
        **{k: STEP_LAUNCHES["gpt"][k] + v for k, v in _r.items()}}
# slice 20, ZeRO at world 1: ZeRO-2's step unscales the two gradient
# arenas (amp's K5), scales the reduce-scattered fp32 shard (one more K5,
# which gives the shard's overflow flag) and runs one K6 pass on the one
# shard; ZeRO-3 scales its loss itself, so only the shard's K5 and K6;
# "regather" recomputes the gather alone (the K1-K4 ops are saved), so its
# launches are "keep"'s. DistributedFusedLAMB: amp's two unscales, the
# shard's K5, one K9 (the clip norm), one K7 and one K8 pass
STEP_LAUNCHES["zero2"] = {**STEP_LAUNCHES["gpt"], "unscale": 3, "adam": 1}
STEP_LAUNCHES["zero3_keep"] = {**STEP_LAUNCHES["gpt"], "unscale": 1, "adam": 1}
STEP_LAUNCHES["zero3_regather"] = STEP_LAUNCHES["zero3_keep"]
STEP_LAUNCHES["bert_zero2_lamb"] = {**STEP_LAUNCHES["bert"], "unscale": 3, "l2norm": 1,
                                    "lamb_stage1": 1, "scaled_update": 1}
# slice 21: the optimizer in the backward reads the gradient leaves where
# they lie, one views-mode launch an arena (bf16 and fp32), no unscale pass
STEP_LAUNCHES["gpt_oib"] = {**STEP_LAUNCHES["gpt"], "unscale": 0, "adam": 0,
                            "adam_views": 2}
STEP_LAUNCHES["resnet_oib"] = {**STEP_LAUNCHES["resnet_o5"], "unscale": 0, "sgd": 0,
                               "sgd_views": 2}
STEP_LAUNCHES["gpt_tp_pp_1f1b_remat_full"] = {
    **STEP_LAUNCHES["gpt_tp_pp_1f1b"],
    **{k: STEP_LAUNCHES["gpt_tp_pp_1f1b"][k] + 4 * v for k, v in _RECOMPUTE.items()}}
# the levels whose params live in arenas (MasterWeights over PackedParams)
ARENA_LEVELS = ("O2", "O5", "O6")
# the GPT's activation dtype by level: fp16 storage at O2; at O1/O4 the
# residual stream stays fp32 and the autocast scope casts the dense layers
# and attention down
GPT_ACT = {"O5": torch.bfloat16, "O2": torch.float16, "O1": torch.float32,
           "O4": torch.float32}
# DCGAN (examples/dcgan: 32 x 32 images, ngf = ndf = 32) at its own batch
DCGAN_ITERS, DCGAN_BATCH, DCGAN_LR = 20, 32, 2e-4
PEAK_BF16 = 989e12
# the fp8 tensor cores' dense peak (e4m3 and e5m2, H100 SXM data sheet):
# twice the bf16 rate
PEAK_FP8 = 1979e12
# the ImageNet ResNet-50 step (bench.py make_resnet_rung: examples/imagenet
# build_trainer("resnet50", global_batch=128), 224x224 uint8 images,
# FusedSGD(0.1 * 128 / 256, momentum 0.9, weight_decay 1e-4)); the parity
# and skip steps at batch 2
RESNET_BATCH = 128
RESNET_IMAGE = 224
RESNET_LR = 0.1 * RESNET_BATCH / 256
RESNET_WD = 1e-4

# tolerances (PERF.md explains each)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
# fp16 outputs: the same one rounding at fp16's unit roundoff (8 times finer)
FP16_TOL = dict(rtol=2 ** -10, atol=2 ** -11)
FP32_TOL = dict(rtol=1e-5, atol=2e-5)
LOGIT_TOL = 0.1
# unfused against flash loss, relative: about 10 times the larger reading
UNFUSED_LOSS_TOL = 2e-4
# K11's probabilities: relative, since at sk 1024 most lie far below 2^-8;
# half types one rounding apart, fp32 exp and row sums in another order
PROB_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-8),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6),
            torch.float16: dict(rtol=2 ** -9, atol=1e-7)}
# K12's gradients: rtol (one rounding in half types) plus SUM_TOL times
# scale |y| sum|dy y|, which bounds the row sum's error in another order where
# dy - sum cancels; it follows each element, so a wrong row of small
# gradients fails
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -9}
SUM_TOL = 1e-5
# K14's loss and lse: |d| <= XENT_LOSS_TOL (|ref| + |lse|), since lse - x[label]
# cancels for rows that are confidently right; K15's dx: |d| <= GRAD_RTOL |ref|
# + XENT_P_TOL |dy| (p + s/V) (plus fp16's subnormal step), since p - s/V
# cancels; padded rows exactly 0
XENT_LOSS_TOL = 1e-5
XENT_P_TOL = 1e-6
# the GPT-xent step: the Transformer's label smoothing (Vaswani et al. 2017,
# 5.4), Apex's default padding index 0, and that many targets at the batch's
# start set to it so that padded rows are really exercised
XENT_SMOOTHING = 0.1
XENT_PADDED = 32


PHASE_SECONDS = {}
_MARK = [0.0]


@contextlib.contextmanager
def phase(name):
    """Adds the block's wall seconds to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
        _MARK[0] = time.perf_counter()


def mark(name):
    """PHASE_SECONDS[name]: the wall seconds since the last phase ended."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - _MARK[0]
    _MARK[0] = now


def line(phase, **fields):
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def time_ms(fn, iters=10):
    """Median CUDA-event time of one call, with L2 flushed before each. The
    device sleeps before the start event while the host enqueues the call,
    so the time is the device's, not the host's launch latency."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms of cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes, flops, dtype, int_ops=0):
    """The least time: bytes over the memory rate, or the operations of each
    type over its peak (float on ``dtype``'s, the dropout hash's ALU-pipe
    instructions on PEAK_INT32), whichever is larger."""
    t_bytes = nbytes / HBM_BPS
    t_ops = max(flops / PEAK_FLOPS[dtype], int_ops / PEAK_INT32)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, ref, tol):
    torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"{name}: {m}")
    return max_err(got, ref)


def check_dropped_pv(name, o, ref, ref_abs):
    """K2's bf16 output, at every dropout rate: ``|o - ref| <= 2^-7 |ref| +
    2^-8 ref_abs`` everywhere, ``ref_abs`` the plain version's sum of
    (dropped) p times |v| in fp32. The kernel rounds each kept p / (1 -
    rate) to bf16 for its product with v (relative 2^-9), so the sum may
    part from the fp32 one by 2^-9 ref_abs where its terms cancel; the
    bound is twice that plus one bf16 rounding of the output, and follows
    each element."""
    bound = 2 ** -7 * ref.float().abs() + 2 ** -8 * ref_abs
    err = (o.float() - ref.float()).abs()
    bad = err > bound
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} elements "
                             f"out of tolerance, first at "
                             f"{bad.nonzero()[0].tolist()}")
    return float(err.max())


def check_softmax_grad(name, dx, ref, y, dy, scale, rtol):
    """K12's check: ``|dx - ref| <= rtol |ref| + SUM_TOL scale |y|
    sum|dy y|`` everywhere."""
    y, dy = y.float(), dy.float()
    bound = SUM_TOL * scale * y.abs() * (y * dy).abs().sum(-1, keepdim=True)
    bound += rtol * ref.float().abs()
    err = (dx.float() - ref.float()).abs()
    bad = err > bound
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} elements "
                             f"out of tolerance, first at "
                             f"{bad.nonzero()[0].tolist()}")
    return float(err.max())


# ------------------------------------------------------------------- K1


def k1_phase(norm):
    """Check K1 everywhere (each call twice, bitwise equal; decode's 32 rows
    bitwise the same rows inside a prefill call; an empty call launches
    nothing), time it at the engine's two shapes and the training step's."""
    g = gen(1)
    checks = [  # rows, hidden, in dtype, rms, out dtype, row stride
        (16384, 1024, torch.bfloat16, False, torch.bfloat16, 1024),
        (8192, 1024, torch.bfloat16, False, torch.bfloat16, 1024),
        (32, 1024, torch.bfloat16, False, torch.bfloat16, 1024),
        (8192, 1024, torch.float32, False, torch.float32, 1024),
        (8192, 1024, torch.float32, True, torch.float32, 1024),
        (77, 1000, torch.float32, False, torch.float32, 1000),
        (64, 1000, torch.bfloat16, True, torch.float32, 1000),
        (8192, 1024, torch.float16, False, torch.float16, 1024),
        (4096, 1024, torch.bfloat16, False, torch.bfloat16, 1536),
        (4096, 1000, torch.bfloat16, False, torch.bfloat16, 1003),
        (256, 16384, torch.bfloat16, False, torch.bfloat16, 16384),
        (256, 16384, torch.float32, True, torch.float32, 16384),
        (300, 1001, torch.bfloat16, False, torch.bfloat16, 1001),
    ]
    rows_out = {}
    for rows, hidden, dt, rms, out_dt, stride in checks:
        x = (torch.randn(rows, stride, generator=g, device="cuda") * 2 + .5).to(dt)
        x = x[:, :hidden]
        # the training step's LayerNorms keep fp32 gamma/beta (amp O5)
        pdt = torch.float32 if rows == 16384 else dt
        w = (1 + .1 * torch.randn(hidden, generator=g, device="cuda")).to(pdt)
        b = None if rms else (.1 * torch.randn(hidden, generator=g, device="cuda")).to(pdt)
        args = (x, w, b, 1e-5, rms, out_dt)
        got = norm.ln_fwd_kernel(*args)
        again = norm.ln_fwd_kernel(*args)
        ref = norm.ln_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"{rows}x{hidden} {str(dt)[6:]}{' rms' if rms else ''}->{str(out_dt)[6:]}"
               f"{f' stride {stride}' if stride != hidden else ''}")
        err = check_close(f"K1 {tag}", got, ref, {torch.bfloat16: BF16_TOL,
                                                  torch.float16: FP16_TOL}.get(out_dt, FP32_TOL))
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {tag}: two calls differ")
        fields = dict(max_abs_err=err, two_calls="bitwise")
        if stride != hidden:
            # the strided view bitwise its contiguous copy (another layout,
            # another path when the stride breaks 16-byte rows)
            if not torch.equal(norm.ln_fwd_kernel(x.contiguous(), *args[1:]), got):
                raise AssertionError(f"K1 {tag}: differs from its contiguous copy")
            fields["contiguous_copy"] = "bitwise"
        if rows == 8192 and dt == torch.bfloat16:
            # decode-shape calls of 32 rows: bitwise the rows of the whole call
            for lo in (0, 4000, 8160):
                part = norm.ln_fwd_kernel(x[lo:lo + 32], w, b, 1e-5, rms, out_dt)
                if not torch.equal(part, got[lo:lo + 32]):
                    raise AssertionError(f"K1 {tag}: rows {lo}..{lo + 31} alone differ "
                                         "from the same rows in the whole call")
            fields["rows_alone"] = "bitwise"
            before = norm.ln_fwd_kernel.launches
            empty = norm.ln_fwd_kernel(x[:0], w, b, 1e-5, rms, out_dt)
            if empty.shape != (0, hidden) or norm.ln_fwd_kernel.launches != before:
                raise AssertionError(f"K1 0x{hidden}: {tuple(empty.shape)}, "
                                     f"{norm.ln_fwd_kernel.launches - before} launches")
            fields["empty_call"] = "no launch"
        if dt == torch.bfloat16 and hidden == stride == 1024 and not rms:
            nbytes = 2 * x.numel() * x.element_size() + 2 * hidden * w.element_size()
            bms, by = bound_ms(nbytes, 8 * x.numel(), torch.float32)
            wl, bl = w.to(dt), b.to(dt)
            fields.update(
                ms=time_ms(lambda: norm.ln_fwd_kernel(*args)),
                plain_ms=time_ms(lambda: norm.ln_fwd_torch(*args)),
                library_ms=time_ms(lambda: F.layer_norm(x, (hidden,), wl, bl, 1e-5)),
                bound_ms=bms, bound_by=by)
            rows_out[{16384: "train", 8192: "prefill"}.get(rows, "decode")] = (
                tag, fields)
        line("K1", shape=tag, **fields)
    return rows_out


# ------------------------------------------------------------------- K2


def live_pairs(q, k, lens, causal):
    """The (query, key) pairs a flash call computes: keys below each
    sequence's length, and at or before the query when causal."""
    BH, Sq, D = q.shape
    lens = lens.clamp(0, k.shape[1]).long().cpu()
    if causal:
        rows = torch.arange(Sq)
        return int(torch.minimum(lens[:, None], rows[None, :] + 1).sum())
    return int(lens.sum()) * Sq


def k2_flops_bytes(q, k, lens, causal):
    BH, Sq, D = q.shape
    pairs = live_pairs(q, k, lens, causal)
    es = q.element_size()
    lens = lens.clamp(0, k.shape[1]).long().cpu()
    nbytes = (2 * q.numel() * es + BH * Sq * 4 + BH * 4
              + 2 * int(lens.sum()) * D * es)
    return 4 * pairs * D, nbytes


def flash_key():
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import make_key

    return make_key(DROPOUT_SEED, device="cuda")


def sdpa_mask(lens, Sk, causal):
    """The boolean key mask of a flash call for the library's attention."""
    kj = torch.arange(Sk, device="cuda")
    keep = kj[None, None, :] < lens[:, None, None]
    if causal:
        keep = keep & (kj[None, :] <= kj[:, None])
    return keep


def k2_phase(attn):
    """K2 against its plain version; with dropout (``rate``) both fed the
    same key. Head dims 8, 40, 256 and 512 take the CUDA-core row kernel."""
    checks = [  # BH, Sq, Sk, D, causal, dtype, rate
        (256, 1024, 1024, 64, True, torch.bfloat16, 0.0),
        (128, 1024, 1024, 64, True, torch.bfloat16, 0.0),
        (512, 1, 1024, 64, False, torch.bfloat16, 0.0),
        (2048, 128, 128, 64, False, torch.bfloat16, 0.0),  # BERT, ragged lens
        (128, 1024, 1024, 64, True, torch.float32, 0.0),
        (512, 1, 1024, 64, False, torch.float32, 0.0),
        (8, 70, 70, 48, True, torch.float32, 0.0),
        (8, 33, 200, 128, False, torch.float32, 0.0),
        (8, 70, 70, 48, True, torch.bfloat16, 0.0),
        (8, 5, 5, 80, True, torch.bfloat16, 0.0),
        # dropout: the GPT and BERT training shapes, decode, fp32
        (256, 1024, 1024, 64, True, torch.bfloat16, 0.1),
        (2048, 128, 128, 64, False, torch.bfloat16, 0.1),
        (16, 5, 300, 64, False, torch.bfloat16, 0.1),
        (512, 1, 1024, 64, False, torch.bfloat16, 0.1),
        (8, 70, 70, 48, True, torch.float32, 0.1),
        # head dims only the row kernels take, with and without dropout
        (8, 100, 100, 8, True, torch.bfloat16, 0.1),
        (8, 100, 100, 40, False, torch.bfloat16, 0.0),
        (8, 100, 100, 40, True, torch.float32, 0.1),
        (8, 130, 130, 256, True, torch.bfloat16, 0.1),
        (8, 64, 64, 256, False, torch.float32, 0.0),
        (8, 100, 100, 512, True, torch.bfloat16, 0.0),
        (8, 70, 90, 512, False, torch.float32, 0.1),
        # the decode path: every row count in one block, chunk edges
        (64, 15, 700, 128, False, torch.bfloat16, 0.0),
        (64, 9, 9, 32, True, torch.float32, 0.0),
        (11, 1, 1025, 16, False, torch.bfloat16, 0.0),
        # the tensor-core kernel off its 128-row and 64-key tiles
        (8, 17, 17, 16, True, torch.bfloat16, 0.0),
        (8, 129, 129, 64, True, torch.bfloat16, 0.0),
        (8, 200, 1000, 96, False, torch.bfloat16, 0.0),
        (8, 1000, 1000, 112, True, torch.bfloat16, 0.1),
    ]
    rng = np.random.default_rng(2)
    key = flash_key()
    rows_out = {}
    for i, (BH, Sq, Sk, D, causal, dt, rate) in enumerate(checks):
        g = gen(10 + i)
        q, k, v = (torch.randn(BH, s, D, generator=g, device="cuda").to(dt)
                   for s in (Sq, Sk, Sk))
        lens_np = rng.integers(0, Sk + 1, BH)
        lens_np[:2] = (0, Sk)  # a fully masked row and a full one
        if BH == 11:  # the decode path's chunk edges
            lens_np[:] = (0, 1, 31, 32, 33, 64, 65, 512, 513, 1024, 1025)
        if BH == 256:
            lens_np[:] = Sk  # training: every sequence full
        lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
        args = (q, k, v, lens, causal, D ** -0.5, rate, key if rate else None)
        o, lse = attn.flash_fwd_kernel(*args)
        ro, rlse = attn.flash_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"BH{BH} Sq{Sq} Sk{Sk} D{D}{' causal' if causal else ''} "
               f"{str(dt)[6:]}{f' dropout {rate}' if rate else ''}")
        if BH != 256 and not (torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)):
            raise AssertionError(f"K2 {tag}: a lens-0 row is not exactly 0")
        if dt == torch.bfloat16:
            # K2 rounds each p to bf16 for its product with v at every
            # rate, so bf16 is held to the per-element bound everywhere
            ref_abs = attn.flash_fwd_torch(q.float(), k.float(), v.float().abs(),
                                           *args[3:])[0]
            err = check_dropped_pv(f"K2 {tag}", o, ro, ref_abs)
            del ref_abs
        else:
            err = check_close(f"K2 {tag}", o, ro,
                              BF16_TOL if dt == torch.bfloat16 else FP32_TOL)
        check_close(f"K2 lse {tag}", lse, rlse, dict(rtol=1e-5, atol=1e-4))
        if Sq < 16:  # the decode path's fixed-order merge
            o2, lse2 = attn.flash_fwd_kernel(*args)
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                raise AssertionError(f"K2 {tag}: two calls differ")
            del o2, lse2
        fields = dict(max_abs_err=err)
        decode = Sq == 1 and BH == 512
        if (dt == torch.bfloat16 and BH >= 128 and D == 64) or decode:
            flops, nbytes = k2_flops_bytes(q, k, lens, causal)
            int_ops = PHILOX_OPS_PER_ELEMENT * live_pairs(q, k, lens, causal) if rate else 0
            bms, by = bound_ms(nbytes, flops, dt, int_ops)
            # every length full: (B, H, S, D) with is_causal and no mask, the
            # call PyTorch routes to its flash backend (as k4_phase's);
            # ragged lengths need the mask
            full = bool((lens == Sk).all())
            if full:
                B = TRAIN_BATCH if causal else BERT_BATCH
                ql, kl, vl = (t.reshape(B, BH // B, -1, D) for t in (q, k, v))
                keep = None
            else:
                ql, kl, vl, keep = q, k, v, sdpa_mask(lens, Sk, causal)
            fields.update(
                ms=time_ms(lambda: attn.flash_fwd_kernel(*args)),
                plain_ms=time_ms(lambda: attn.flash_fwd_torch(*args), iters=5),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=keep, is_causal=full and causal,
                    scale=D ** -0.5, dropout_p=rate)),
                bound_ms=bms, bound_by=by)
            name = {256: "train", 2048: "bert"}.get(
                BH, "prefill" if causal else "decode")
            if rate:
                name = {"train": "gpt_dropout", "bert": "bert_dropout",
                        "decode": "decode_dropout"}[name]
            if dt == torch.float32:
                name += "_fp32"
            if decode and dt == torch.float32 and not rate:
                # the engine's decode over e4m3 pages runs the contiguous
                # decode mode in fp32 on the dequantized copy: that run's
                # decode launches
                fields.update(path="serving_e4m3_decode")
            elif decode:
                # fp32 pools decode on the paged mode, whose row counts them
                fields.update(launches=0)
            rows_out[name] = (tag, fields)
        line("K2", shape=tag, **fields)
    return rows_out


# the engine's decode bucket for K2's paged mode: B 32 sequences of H 16
# heads of D 64 over one layer's fp32 pools of ENGINE's 2049 pages of 16, 64
# slots a sequence (max_seq_len 1024)
PAGED = dict(B=32, H=16, D=64, pages=2049, page=16, slots=64)


def paged_inputs(seed):
    """One layer's pools holding bf16 values (as write_token widens them), a
    shuffled table with null slots past each sequence's pages, lengths
    uniform in 0..1024 with one 0 and one full, and q as a (B, 1, H*D)
    chunk of the QKV projection's (B, 1, 3*H*D) output."""
    B, H, D, P = PAGED["B"], PAGED["H"], PAGED["D"], PAGED["page"]
    g = gen(seed)
    kp, vp = (torch.randn(PAGED["pages"], P, H * D, generator=g, device="cuda")
              .bfloat16().float() for _ in range(2))
    qkv = torch.randn(B, 1, 3 * H * D, generator=g, device="cuda").bfloat16()
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, PAGED["slots"] * P + 1, B)
    lens[:2] = (0, PAGED["slots"] * P)
    perm = rng.permutation(np.arange(1, PAGED["pages"]))
    table = np.zeros((B, PAGED["slots"]), np.int32)
    for b, n in enumerate(lens):
        used = -(-int(n) // P)
        table[b, :used] = perm[b * PAGED["slots"]: b * PAGED["slots"] + used]
    return (qkv.chunk(3, dim=-1)[0], kp, vp, torch.from_numpy(table).to("cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def paged_phase(attn, kvcache):
    """K2's paged mode at the engine's decode bucket: against its plain
    version (check_dropped_pv), bitwise against the contiguous mode on the
    gathered, narrowed copies, twice bitwise, lens 0 exactly 0; timed beside
    its bound (the live fp32 rows), the plain version and the chain the
    gathered path runs for the same result (gather, narrow, the head split's
    copies, K2). No single PyTorch call reads paged pools: library_ms is
    null, and masked SDPA over the already gathered copies is printed as
    sdpa_on_gathered_ms."""
    B, H, D = PAGED["B"], PAGED["H"], PAGED["D"]
    q, kp, vp, table, lens = paged_inputs(20)
    scale = D ** -0.5
    args = (q, kp, vp, table, lens, H, scale)
    o, lse = attn._paged_decode_kernel(*args)
    o2, lse2 = attn._paged_decode_kernel(*args)
    ro, rlse = attn._paged_decode_torch(*args)

    def heads(t):
        return (t.reshape(B, t.shape[1], H, D).transpose(1, 2)
                .reshape(B * H, t.shape[1], D).contiguous())

    def chain():  # the gathered path of the engine, as it ran before
        kc = kvcache.gather_pages(kp, table).to(q.dtype)
        vc = kvcache.gather_pages(vp, table).to(q.dtype)
        return attn.flash_fwd_kernel(heads(q), heads(kc), heads(vc),
                                     lens.repeat_interleave(H), False, scale)

    co, clse = chain()
    torch.cuda.synchronize()
    tag = (f"B{B} H{H} D{D} bf16 q, fp32 pools {PAGED['pages']}x{PAGED['page']}, "
           f"{PAGED['slots']} slots, ragged lens")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError("K2 paged: two calls differ")
    if not (torch.equal(heads(o), co) and torch.equal(lse, clse)):
        raise AssertionError("K2 paged: not bitwise the contiguous mode on the "
                             "gathered, narrowed copies")
    if not (torch.all(o[0] == 0) and torch.all(lse[:H] == -1e30)):
        raise AssertionError("K2 paged: a lens-0 sequence is not exactly 0")
    ref_abs = attn._paged_decode_torch(q.float(), kp, vp.abs(), table, lens, H,
                                       scale)[0]
    err = check_dropped_pv("K2 paged", o, ro, ref_abs)
    check_close("K2 paged lse", lse, rlse, dict(rtol=1e-5, atol=1e-4))
    live = int(lens.long().sum())
    pages_read = int(((lens.long() + PAGED["page"] - 1) // PAGED["page"]).sum())
    nbytes = (2 * live * H * D * 4 + 2 * q.numel() * 2 + lse.numel() * 4
              + lens.numel() * 4 + pages_read * 4)
    bms, by = bound_ms(nbytes, 4 * live * H * D, torch.float32)
    kc, vc = (heads(kvcache.gather_pages(p, table).to(q.dtype)) for p in (kp, vp))
    keep = sdpa_mask(lens.repeat_interleave(H), kc.shape[1], False)
    fields = dict(
        max_abs_err=err, ms=time_ms(lambda: attn._paged_decode_kernel(*args)),
        plain_ms=time_ms(lambda: attn._paged_decode_torch(*args), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by,
        chain_ms=time_ms(chain),
        sdpa_on_gathered_ms=time_ms(lambda: F.scaled_dot_product_attention(
            heads(q), kc, vc, attn_mask=keep, scale=scale)),
        live_keys=live, path="serving")
    line("K2_paged", shape=tag, **fields)
    return {"decode": (tag, fields)}


POOL_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def paged_16bit_phase(attn, kvcache):
    """K2's paged mode over bf16 and fp16 pools at the engine's decode
    bucket (the values of ``paged_inputs``, bf16-representable, stored in
    the pool dtype): against its plain version (check_dropped_pv), bitwise
    against the contiguous mode on the gathered copy converted to q's dtype,
    twice bitwise, and bitwise the launch over fp32 pools holding the same
    values (the arithmetic follows q's dtype alone); timed beside its bound
    (the live rows' bytes in the pool dtype), its plain version, the fp32
    pools' launch and the gather chain it replaces. No single PyTorch call
    reads paged pools: library_ms is null, as for the fp32 row."""
    B, H, D = PAGED["B"], PAGED["H"], PAGED["D"]
    q, kp32, vp32, table, lens = paged_inputs(20)
    scale = D ** -0.5

    def heads(t):
        return (t.reshape(B, t.shape[1], H, D).transpose(1, 2)
                .reshape(B * H, t.shape[1], D).contiguous())

    rows = {}
    for tag_dt, dt in POOL_DTYPES.items():
        kp, vp = kp32.to(dt), vp32.to(dt)
        wide = (q, kp.float(), vp.float(), table, lens, H, scale)
        args = (q, kp, vp, table, lens, H, scale)
        o, lse = attn._paged_decode_kernel(*args)
        o2, lse2 = attn._paged_decode_kernel(*args)
        wo, wlse = attn._paged_decode_kernel(*wide)
        ro, rlse = attn._paged_decode_torch(*args)

        def chain(kp=kp, vp=vp):  # the gathered path on these pools
            kc = kvcache.gather_pages(kp, table).to(q.dtype)
            vc = kvcache.gather_pages(vp, table).to(q.dtype)
            return attn.flash_fwd_kernel(heads(q), heads(kc), heads(vc),
                                         lens.repeat_interleave(H), False, scale)

        co, clse = chain()
        torch.cuda.synchronize()
        name = f"K2 paged {tag_dt} pools"
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{name}: two calls differ")
        if not (torch.equal(heads(o), co) and torch.equal(lse, clse)):
            raise AssertionError(f"{name}: not bitwise the contiguous mode on the "
                                 f"gathered copy")
        if not (torch.equal(o, wo) and torch.equal(lse, wlse)):
            raise AssertionError(f"{name}: not bitwise the fp32 pools' launch on "
                                 f"the same values")
        if not (torch.all(o[0] == 0) and torch.all(lse[:H] == -1e30)):
            raise AssertionError(f"{name}: a lens-0 sequence is not exactly 0")
        ref_abs = attn._paged_decode_torch(q.float(), kp, vp.abs(), table, lens, H,
                                           scale)[0]
        err = check_dropped_pv(name, o, ro, ref_abs)
        check_close(f"{name} lse", lse, rlse, dict(rtol=1e-5, atol=1e-4))
        live = int(lens.long().sum())
        pages_read = int(((lens.long() + PAGED["page"] - 1) // PAGED["page"]).sum())
        nbytes = (2 * live * H * D * kp.element_size() + 2 * q.numel() * 2
                  + lse.numel() * 4 + lens.numel() * 4 + pages_read * 4)
        bms, by = bound_ms(nbytes, 4 * live * H * D, torch.float32)
        tag = (f"B{B} H{H} D{D} bf16 q, {tag_dt} pools {PAGED['pages']}x"
               f"{PAGED['page']}, {PAGED['slots']} slots, ragged lens")
        fields = dict(
            max_abs_err=err, ms=time_ms(lambda: attn._paged_decode_kernel(*args)),
            plain_ms=time_ms(lambda: attn._paged_decode_torch(*args), iters=5),
            library_ms=None, bound_ms=bms, bound_by=by,
            fp32_pools_ms=time_ms(lambda: attn._paged_decode_kernel(*wide)),
            chain_ms=time_ms(chain), bitwise_fp32_pools=True, live_keys=live,
            path=f"serving_{dict(bf16='bfloat16', fp16='float16')[tag_dt]}")
        line("K2_paged", shape=tag, **fields)
        rows[f"decode_{tag_dt}_pools"] = (tag, fields)
        del kp, vp, wide, args
    return rows


# ---------------------------------------------------------------- K3-K6


def grad_ms(fn, inputs, grad_out):
    """Device time of the backward alone: ``fn`` runs once, then its graph
    is replayed for the gradients of ``inputs``."""
    out = fn()
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad_out,
                                               retain_graph=True))


def k3_phase(norm):
    """LayerNorm backward: the training shape (O5 mix), the widths 768,
    4096 and 16,384, one row and one row more than a full wave of warps,
    fp16 x with bf16 w, and awkward shapes; dgamma/dbeta (and dx) bitwise
    equal across two calls."""
    g = gen(21)
    geo = norm.ln_bwd_geometry(1 << 30, 1024, 2, 2, norm.sm_count(0))
    wave = geo["blocks"] * geo["teams"]  # rows that one pass of the teams takes
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    checks = [  # rows, hidden, x/dy dtype, w dtype, rms, bias
        (16384, 1024, bf16, f32, False, True),
        (16384, 1024, f32, f32, False, True),
        (16384, 768, bf16, f32, False, True),
        (4096, 4096, bf16, f32, False, True),
        (4096, 4096, f32, f32, True, False),
        (256, 16384, bf16, f32, False, True),
        (256, 16384, f32, f32, False, True),
        (1, 1024, bf16, f32, False, True),
        (wave + 1, 1024, bf16, f32, False, True),
        (300, 1024, f16, bf16, False, True),
        (77, 1000, f32, f32, False, True),
        (77, 1000, f32, f32, True, False),
        (64, 1000, bf16, f32, True, False),
        (5, 48, bf16, bf16, False, True),
    ]
    dx_tol = {bf16: BF16_TOL, f16: dict(rtol=2 ** -10, atol=2 ** -11), f32: FP32_TOL}
    rows_out = {}
    for rows, hidden, dt, wdt, rms, bias in checks:
        x = (torch.randn(rows, hidden, generator=g, device="cuda") * 2 + .5).to(dt)
        dy = torch.randn(rows, hidden, generator=g, device="cuda").to(dt)
        w = (1 + .1 * torch.randn(hidden, generator=g, device="cuda")).to(wdt)
        args = (x, w, dy, 1e-5, rms)
        dx, dw, db = norm.ln_bwd_kernel(*args, bias)
        dx2, dw2, db2 = norm.ln_bwd_kernel(*args, bias)
        rdx, rdw, rdb = norm.ln_bwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"{rows}x{hidden} {str(dt)[6:]}/w {str(wdt)[6:]}"
               f"{' rms' if rms else ''}{'' if bias else ' no-bias'}")
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)
                and (not bias or torch.equal(db, db2))):
            raise AssertionError(f"K3 {tag}: two calls differ")
        err = check_close(f"K3 dx {tag}", dx, rdx, dx_tol[dt])
        # dgamma/dbeta: fp32 sums over every row in another order, then one
        # rounding to a half-typed w (2^-9 relative, so rtol 2^-8)
        wtol = (dict(rtol=1e-4, atol=1e-3) if wdt == torch.float32
                else dict(rtol=2 ** -8, atol=1e-3))
        err_w = check_close(f"K3 dw {tag}", dw.float(), rdw, wtol)
        if bias:
            check_close(f"K3 db {tag}", db.float(), rdb, wtol)
        fields = dict(max_abs_err=err, dw_max_abs_err=err_w, bitwise_across_calls=True)
        if rows == 16384 and hidden == 1024 and dt == torch.bfloat16:
            nbytes = (3 * x.numel() * x.element_size()
                      + 3 * hidden * w.element_size())
            bms, by = bound_ms(nbytes, 11 * x.numel(), torch.float32)
            xl = x.clone().requires_grad_(True)
            wl = w.to(dt).requires_grad_(True)
            bl = torch.zeros(hidden, device="cuda", dtype=dt, requires_grad=True)
            fields.update(
                ms=time_ms(lambda: norm.ln_bwd_kernel(*args, bias)),
                plain_ms=time_ms(lambda: norm.ln_bwd_torch(*args)),
                library_ms=grad_ms(lambda: F.layer_norm(xl, (hidden,), wl, bl, 1e-5),
                                   (xl, wl, bl), dy),
                bound_ms=bms, bound_by=by)
            rows_out["train"] = (tag, fields)
        line("K3", shape=tag, **fields)
        del x, dy, dx, dx2, rdx
    torch.cuda.empty_cache()
    return rows_out


def k4_flops_bytes(q, k, lens, causal):
    """Operations and bytes of one flash backward: five products over the
    live (query, key) pairs; q, k, v, o, do and lse read once, dq, dk, dv
    written once."""
    flops, _ = k2_flops_bytes(q, k, lens, causal)  # 4 * pairs * D
    BH, Sq, D = q.shape
    es = q.element_size()
    nbytes = 4 * q.numel() * es + BH * Sq * 4 + 4 * k.numel() * es
    return flops * 10 // 4, nbytes


def k4_phase(attn):
    """K4 against its plain version; with dropout (``rate``) both fed the
    forward's key."""
    checks = [  # BH, Sq, Sk, D, causal, dtype, dlse, rate
        (256, 1024, 1024, 64, True, torch.bfloat16, False, 0.0),
        (2048, 128, 128, 64, False, torch.bfloat16, False, 0.0),  # BERT, ragged
        (8, 70, 70, 48, True, torch.bfloat16, True, 0.0),
        (8, 100, 100, 80, True, torch.bfloat16, False, 0.0),
        (8, 64, 200, 128, False, torch.bfloat16, True, 0.0),
        (16, 256, 256, 64, True, torch.float32, False, 0.0),
        (8, 70, 70, 48, True, torch.float32, True, 0.0),
        (8, 100, 100, 80, False, torch.float32, True, 0.0),
        (8, 33, 70, 128, False, torch.float32, False, 0.0),
        # dropout: the GPT and BERT training shapes, fp32
        (256, 1024, 1024, 64, True, torch.bfloat16, False, 0.1),
        (2048, 128, 128, 64, False, torch.bfloat16, False, 0.1),
        (8, 70, 70, 48, True, torch.float32, True, 0.1),
        # head dims only the row kernels take, with and without dropout
        (8, 100, 100, 8, True, torch.bfloat16, False, 0.1),
        (8, 100, 100, 40, False, torch.bfloat16, True, 0.0),
        (8, 100, 100, 40, True, torch.float32, False, 0.1),
        (8, 130, 130, 256, True, torch.bfloat16, False, 0.1),
        (8, 64, 64, 256, False, torch.float32, True, 0.0),
        (8, 100, 100, 512, True, torch.bfloat16, False, 0.0),
        (8, 70, 90, 512, False, torch.float32, False, 0.1),
        # the tensor-core kernels off their 128-row, 32- and 64-key tiles
        (8, 17, 17, 16, True, torch.bfloat16, False, 0.0),
        (8, 129, 129, 64, True, torch.bfloat16, True, 0.0),
        (8, 200, 1000, 96, False, torch.bfloat16, False, 0.0),
        (8, 1000, 1000, 112, True, torch.bfloat16, True, 0.1),
    ]
    rng = np.random.default_rng(22)
    key = flash_key()
    rows_out = {}
    for i, (BH, Sq, Sk, D, causal, dt, with_dlse, rate) in enumerate(checks):
        g = gen(30 + i)
        q, k, v = (torch.randn(BH, s, D, generator=g, device="cuda").to(dt)
                   for s in (Sq, Sk, Sk))
        lens_np = (np.full(BH, Sk) if BH == 256 else rng.integers(0, Sk + 1, BH))
        if BH != 256:
            lens_np[:2] = (0, Sk)  # a fully masked row and a full one
        lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
        scale = D ** -0.5
        drop = (rate, key if rate else None)
        o, lse = attn.flash_fwd_torch(q, k, v, lens, causal, scale, *drop)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dt)
        dlse = (torch.randn(lse.shape, generator=g, device="cuda")
                if with_dlse else None)
        args = (q, k, v, o, do, lse, dlse, lens, causal, scale, *drop)
        got = attn.flash_bwd_kernel(*args)
        again = attn.flash_bwd_kernel(*args)
        ref = attn.flash_bwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"BH{BH} Sq{Sq} Sk{Sk} D{D}{' causal' if causal else ''} "
               f"{str(dt)[6:]}{' dlse' if with_dlse else ''}"
               f"{f' dropout {rate}' if rate else ''}")
        if BH != 256 and not all(torch.all(t[0] == 0) for t in got):
            raise AssertionError(f"K4 {tag}: a lens-0 row is not exactly 0")
        # deterministic: no atomics, so a second call is bitwise the first
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K4 {tag}: two calls differ")
        del again
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K4 {name} {tag}: non-finite")
            # bf16: the tensor-core kernel rounds p and ds to bf16 for its
            # products (as the TPU kernel does), the plain version keeps fp32
            tol = (dict(rtol=2e-2, atol=2e-2 * float(b.float().abs().max()))
                   if dt == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4))
            errs.append(check_close(f"K4 {name} {tag}", a, b, tol))
        fields = dict(max_abs_err=max(errs), repeat="bitwise")
        if BH in (256, 2048):
            flops, nbytes = k4_flops_bytes(q, k, lens, causal)
            int_ops = PHILOX_OPS_PER_ELEMENT * live_pairs(q, k, lens, causal) if rate else 0
            bms, by = bound_ms(nbytes, flops, dt, int_ops)
            B = TRAIN_BATCH if causal else BERT_BATCH
            H = BH // B
            ql, kl, vl = (t.reshape(B, H, -1, D).clone().requires_grad_(True)
                          for t in (q, k, v))
            # the library's backward with the same key padding (a boolean
            # mask; its fully masked rows give NaN there, which the timing
            # does not read)
            keep = (None if causal else
                    (torch.arange(Sk, device="cuda")[None, None, :]
                     < lens[:, None, None]).reshape(B, H, 1, Sk))
            fields.update(
                ms=time_ms(lambda: attn.flash_bwd_kernel(*args)),
                plain_ms=time_ms(lambda: attn.flash_bwd_torch(*args), iters=5),
                library_ms=grad_ms(
                    lambda: F.scaled_dot_product_attention(
                        ql, kl, vl, attn_mask=keep, is_causal=causal,
                        dropout_p=rate),
                    (ql, kl, vl), do.reshape(B, H, Sq, D)),
                bound_ms=bms, bound_by=by)
            name = "train" if BH == 256 else "bert"
            if rate:
                name = {"train": "gpt_dropout", "bert": "bert_dropout"}[name]
            rows_out[name] = (tag, fields)
        line("K4", shape=tag, **fields)
    return rows_out


# ------------------------------------------------------------- dropout


def k13_phase(attn):
    """K13 bitwise against its twin at the attention and hidden shapes of
    the dropout steps and at awkward ones (ragged edges, BH past 65,535);
    the kept fraction within 6 sigma of binomial. Returns the timed rows of
    the main paths' shapes, by path."""
    key = flash_key()
    checks = [  # shape, rate, the path that gives K13 this shape
        ((256, 1024, 1024), 0.1, "gpt_unfused_dropout"),  # GPT probabilities
        ((256, 1024, 1024), 0.3, None),
        ((1, 16384, 1024), 0.1, None),
        ((1, 16384, 1024), 0.3, None),
        ((16, 1024, 1024), 0.1, "gpt_dropout"),           # GPT hidden states
        ((128, 128, 1024), 0.1, "bert_dropout"),          # BERT hidden states
        ((2048, 128, 128), 0.1, "bert_unfused_dropout"),  # BERT probabilities
        ((3, 7, 13), 0.5, None),
        ((2, 1, 1), 0.3, None),
        ((70000, 3, 5), 0.2, None),     # BH past gridDim.y's 65,535
        ((66000, 4, 32), 0.1, None),
    ]
    rows_out = {}
    for shape, rate, path in checks:
        mask = attn.dropout_keep_mask_kernel(key, shape, rate)
        ref = attn.dropout_keep_mask_torch(key, shape, rate)
        torch.cuda.synchronize()
        tag = f"{shape} rate {rate}"
        if mask.dtype != torch.bool or not torch.equal(mask, ref):
            raise AssertionError(f"K13 {tag}: differs from its twin in "
                                 f"{int((mask != ref).sum())} slots")
        n, keep = mask.numel(), 1.0 - rate
        kept = int(mask.sum())
        sigma = (n * keep * rate) ** 0.5
        if abs(kept - n * keep) > 6 * sigma + 1:
            raise AssertionError(f"K13 {tag}: kept {kept} of {n}, expected "
                                 f"{n * keep} +- 6 x {sigma}")
        del ref
        fields = dict(max_abs_err=0.0, kept_fraction=kept / n,
                      sigmas=(kept - n * keep) / max(sigma, 1e-30))
        if path is not None:
            bms, by = bound_ms(n + 16, 0, torch.float32,
                               PHILOX_OPS_PER_ELEMENT * n)
            # the library: the same work, one bool a slot kept with
            # probability 1 - rate, from other random bits
            lib = torch.empty(shape, dtype=torch.bool, device="cuda")
            fields.update(
                ms=time_ms(lambda: attn.dropout_keep_mask_kernel(key, shape, rate)),
                plain_ms=time_ms(lambda: attn.dropout_keep_mask_torch(key, shape, rate),
                                 iters=5),
                library_ms=time_ms(lambda: lib.bernoulli_(1.0 - rate)),
                bound_ms=bms, bound_by=by)
            del lib
            rows_out[path] = (tag, fields)
        line("K13", shape=tag, **fields)
        del mask
        torch.cuda.empty_cache()
    return rows_out


def flash_dropout_laws_phase(attn):
    """``testing/tpu_checks.py`` ``check_flash_dropout`` on the card: rate 0
    is the no-dropout kernel bitwise, the key decides the mask, the mean of
    v = 1 stays 1 and its variance follows (rate/keep) sum p^2, K2, K4 and
    K13 drop the same slots, keys past kv_lens do not leak, and S 8192
    stays finite forward and backward."""
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import make_key

    key, other = flash_key(), make_key(42, device="cuda")
    g = gen(80)
    B, H, S, D = 2, 4, 512, 64
    q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda") for _ in range(3))
    fl = attn.flash_attention
    plain = fl(q, k, v)
    res = {"rate0_exact": torch.equal(plain, fl(q, k, v, dropout_rate=0.0,
                                                 dropout_key=key))}
    a = fl(q, k, v, dropout_rate=0.25, dropout_key=key)
    res["deterministic"] = torch.equal(a, fl(q, k, v, dropout_rate=0.25,
                                             dropout_key=key))
    res["key_sensitive"] = not torch.equal(a, fl(q, k, v, dropout_rate=0.25,
                                                 dropout_key=other))
    res["active"] = not torch.equal(a, plain)
    ones = fl(q, k, torch.ones_like(v), dropout_rate=0.25, dropout_key=key).double()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / D ** 0.5, -1)
    pred = (0.25 / 0.75) * float((p * p).sum(-1).mean())
    mean, ratio = float(ones.mean()), float(ones.var()) / pred
    res["mean_preserved"] = abs(mean - 1.0) < 0.01
    res["variance_law"] = 0.5 < ratio < 2.0
    # v = I makes o the dropped probabilities, do = I makes dv their
    # transpose: zero exactly where K13 drops
    BH, n = 8, 64
    q2, k2 = (torch.randn(BH, n, n, generator=g, device="cuda") for _ in range(2))
    eye = torch.eye(n, device="cuda").expand(BH, n, n).contiguous()
    lens = torch.full((BH,), n, dtype=torch.int32, device="cuda")
    o, lse = attn.flash_fwd_kernel(q2, k2, eye, lens, False, 0.125, 0.3, key)
    _, _, dv = attn.flash_bwd_kernel(q2, k2, eye, o, eye, lse, None, lens, False,
                                     0.125, 0.3, key)
    drop = ~attn.dropout_keep_mask_kernel(key, (BH, n, n), 0.3)
    res["k2_k4_k13_same_slots"] = (torch.equal(o == 0, drop)
                                   and torch.equal(dv.transpose(1, 2) == 0, drop))
    lens2 = torch.tensor([300, 500], dtype=torch.int32, device="cuda")
    v2 = v.clone()
    v2[0, :, 300:] = 99.0
    res["kv_lens_respected"] = torch.equal(
        fl(q, k, v, kv_lens=lens2, dropout_rate=0.25, dropout_key=key)[0],
        fl(q, k, v2, kv_lens=lens2, dropout_rate=0.25, dropout_key=key)[0])
    ql, kl, vl = (torch.randn(1, 8, 8192, 64, generator=g, device="cuda")
                  .bfloat16().requires_grad_(True) for _ in range(3))
    out = fl(ql, kl, vl, causal=True, dropout_rate=0.1, dropout_key=key)
    gq, gk, gv = torch.autograd.grad(out.float().sum(), (ql, kl, vl))
    res["s8192_fwd_bwd"] = bool(torch.isfinite(out).all()) and all(
        bool(torch.isfinite(t).all()) for t in (gq, gk, gv))
    torch.cuda.synchronize()
    failed = [name for name, ok in res.items() if not ok]
    if failed:
        raise AssertionError(f"flash dropout laws failed: {failed} (mean {mean}, "
                             f"variance ratio {ratio})")
    line("flash_dropout_laws", **{k_: "pass" for k_ in res}, mean=mean,
         variance_ratio=ratio)


def flash_dropout_rung_phase(attn):
    """``bench.py`` ``make_flash_dropout_rungs``: causal attention at rate
    0.1, B 2, H 16, S 4096, D 64, bf16, forward and backward, on K2/K4
    against the materialized plain path (``impl="torch"``), and
    ``F.scaled_dot_product_attention(dropout_p=0.1, is_causal=True)`` as the
    library's time (other random bits: the same work, not the same
    function). Printed under ``bench.py``'s names."""
    B, H, S, D = 2, 16, 4096, 64
    g = gen(81)
    q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda").bfloat16()
               .requires_grad_(True) for _ in range(3))
    key = flash_key()

    def fwdbwd(impl):
        def run():
            o = attn.flash_attention(q, k, v, causal=True, scale=D ** -0.5,
                                     dropout_rate=0.1, dropout_key=key, impl=impl)
            return torch.autograd.grad(o.float().sum(), (q, k, v))
        return run

    def library():
        o = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1, is_causal=True)
        return torch.autograd.grad(o.float().sum(), (q, k, v))

    got, ref = fwdbwd("kernel")(), fwdbwd("torch")()
    torch.cuda.synchronize()
    errs = [check_close(f"rung d{n}", a, b,
                        dict(rtol=2e-2, atol=2e-2 * float(b.float().abs().max())))
            for n, a, b in zip("qkv", got, ref)]
    del got, ref
    torch.cuda.empty_cache()
    flash_ms = time_ms(fwdbwd("kernel"), iters=10)
    plain_ms = time_ms(fwdbwd("torch"), iters=3)
    library_ms = time_ms(library, iters=10)
    line("flash_dropout_rung", shape=f"B{B} H{H} S{S} D{D} causal bf16 dropout 0.1",
         flash_dropout_s4096_fwdbwd_ms=flash_ms,
         flash_dropout_vs_unfused=plain_ms / flash_ms, unfused_fwdbwd_ms=plain_ms,
         library_fwdbwd_ms=library_ms, grad_max_abs_err=max(errs))


def o5_layout(params):
    """The ``PackedLayout`` of ``params`` under amp O5 (arena-native)."""
    from beforeholiday_tpu_torch.amp.frontend import _cast_params, opt_levels
    from beforeholiday_tpu_torch.ops.arena import PackedParams

    return PackedParams.pack(_cast_params(params, opt_levels["O5"], None)).layout


def o5_specs(params):
    """The ``ArenaSpec`` of each arena of ``params`` under amp O5, by dtype."""
    layout = o5_layout(params)
    return dict(zip(layout.dtypes, layout.specs))


def k5_phase(mt, n_bf16, n_fp32, n_resnet):
    """Unscale with the non-finite flag: the flagship's two gradient arenas
    and ResNet-50's bf16 one (the data-parallel step's), inf and NaN placed
    in them, and an output that overflows."""
    g = gen(40)
    rows_out = {}
    checks = [  # n, dtype, poison
        (n_bf16, torch.bfloat16, None),
        (n_fp32, torch.float32, None),
        (n_resnet, torch.bfloat16, None),
        (n_bf16, torch.bfloat16, float("inf")),
        (n_fp32, torch.float32, float("nan")),
        (100003, torch.float32, 3e38),  # finite input, output overflows
    ]
    for n, dt, poison in checks:
        x = (1e-3 * torch.randn(n, generator=g, device="cuda")).to(dt)
        if poison is not None:
            x[n // 3] = poison
        inv = torch.full((), 2.0 if poison == 3e38 else 1 / 1024, device="cuda")
        y, flag = mt.scale_kernel(x, inv, torch.float32)
        ry, rflag = mt.scale_torch(x, inv, torch.float32)
        torch.cuda.synchronize()
        tag = f"{n} {str(dt)[6:]}->float32{'' if poison is None else f' with {poison}'}"
        if bool(flag) != bool(rflag) or bool(flag) != (poison is not None):
            raise AssertionError(f"K5 {tag}: flag {bool(flag)}, plain {bool(rflag)}")
        if poison is None and not torch.equal(y, ry):
            raise AssertionError(f"K5 {tag}: values differ from the plain version")
        fields = dict(found_inf=bool(flag), max_abs_err=max_err(y, ry)
                      if poison is None else 0.0)
        if n in (n_bf16, n_resnet) and dt == torch.bfloat16 and poison is None:
            bms, by = bound_ms(n * (x.element_size() + 4), n, torch.float32)
            found = torch.zeros(1, device="cuda")
            one = torch.ones(1, device="cuda")
            # PyTorch's unscale takes no bf16 on CUDA: it runs in place on
            # the same gradient widened to fp32 (8 B/element, not 6)
            x32 = x.float()
            fields.update(
                ms=time_ms(lambda: mt.scale_kernel(x, inv, torch.float32)),
                plain_ms=time_ms(lambda: mt.scale_torch(x, inv, torch.float32)),
                library_ms=time_ms(
                    lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                        [x32], found, one)),
                bound_ms=bms, bound_by=by)
            rows_out["train" if n == n_bf16 else "ddp_resnet"] = (tag, fields)
        line("K5", shape=tag, **fields)
    return rows_out


def k6_phase(mt, n_bf16, n_fp32):
    """Fused AdamW over the flagship's arenas (bf16 copy for the bf16 one),
    L2 mode, no bias correction, an odd length, and a skipped step that
    must leave everything bitwise unchanged."""
    rows_out = {}
    checks = [  # n, copy dtype, adam_w_mode, bias_correction, skip
        (n_bf16, torch.bfloat16, True, True, False),
        (n_fp32, torch.float32, True, True, False),
        (100003, None, False, True, False),
        (100003, torch.bfloat16, True, False, False),
        (n_bf16, torch.bfloat16, True, True, True),
    ]
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                 grad_scale=1.0)
    for n, copy_dt, adam_w, bc, skip in checks:
        g = gen(50)
        grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
        p = 0.02 * torch.randn(n, generator=g, device="cuda")
        m = 1e-4 * torch.randn(n, generator=g, device="cuda")
        v = 1e-8 * torch.rand(n, generator=g, device="cuda")
        step = torch.full((), 4, dtype=torch.int32, device="cuda")
        found = torch.full((), skip, dtype=torch.bool, device="cuda")
        bc1, bc2 = mt._bias_corrections(bc, step, 0.9, 0.999)
        outs = {}
        for fn in (mt.adam_kernel, mt.adam_torch):
            st = (p.clone(), m.clone(), v.clone())
            cp = None if copy_dt is None else p.to(copy_dt, copy=True)
            fn(grad, *st, bc1=bc1, bc2=bc2, adam_w_mode=adam_w, found_inf=found,
               copy_out=cp, **hyper)
            outs[fn] = (*st, cp)
        torch.cuda.synchronize()
        tag = (f"{n} {'adamw' if adam_w else 'l2'}{'' if bc else ' no-bc'}"
               f"{'' if copy_dt is None else f' copy {str(copy_dt)[6:]}'}"
               f"{' skip' if skip else ''}")
        got, ref = outs[mt.adam_kernel], outs[mt.adam_torch]
        if skip:
            before = (p, m, v, None if copy_dt is None else p.to(copy_dt))
            if not all(a is None or torch.equal(a, b) for a, b in zip(got, before)):
                raise AssertionError(f"K6 {tag}: a skipped step changed state")
            err = 0.0
        else:
            # one ulp where the compiler contracts a multiply-add
            err = max(check_close(f"K6 {tag}", a, b, dict(rtol=1e-6, atol=1e-10))
                      for a, b in zip(got[:3], ref[:3]))
            if copy_dt is not None and not torch.equal(got[3], got[0].to(copy_dt)):
                raise AssertionError(f"K6 {tag}: copy is not the new params")
        fields = dict(max_abs_err=err)
        if n == n_bf16 and not skip:
            bms, by = bound_ms(n * 30, 20 * n, torch.float32)
            st, cp = (p.clone(), m.clone(), v.clone()), p.to(copy_dt)
            not_found = torch.zeros((), dtype=torch.bool, device="cuda")
            kw = dict(bc1=bc1, bc2=bc2, adam_w_mode=True, found_inf=not_found,
                      copy_out=cp, **hyper)
            steps = [torch.full((), 4.0, device="cuda")]
            fields.update(
                ms=time_ms(lambda: mt.adam_kernel(grad, *st, **kw)),
                plain_ms=time_ms(lambda: mt.adam_torch(grad, *st, **kw), iters=5),
                # the same fp32 arenas, no bf16 copy
                library_ms=time_ms(lambda: torch._fused_adamw_(
                    [st[0]], [grad], [st[1]], [st[2]], [], steps, lr=LR,
                    beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
                    amsgrad=False, maximize=False)),
                bound_ms=bms, bound_by=by)
            rows_out["train"] = (tag, fields)
        line("K6", shape=tag, **fields)
    return rows_out


# ---------------------------------------------------------------- K7-K9


def k9_phase(mt, n_bert):
    """Global sum of squares with the non-finite flag: BERT's fp32 gradient
    arena (after the unscale), with the inverse loss scale folded in, and
    awkward lengths with inf and NaN; two calls on the same input must agree
    bit for bit (no float atomics)."""
    g = gen(80)
    rows_out = {}
    checks = [  # n, dtype, scale, poison
        (n_bert, torch.float32, None, None),
        (n_bert, torch.float32, 1 / 1024, None),
        (100003, torch.float32, None, float("inf")),
        (100003, torch.bfloat16, None, float("nan")),
        (4099, torch.bfloat16, 0.5, None),
    ]
    for n, dt, scale, poison in checks:
        x = (1e-3 * torch.randn(n, generator=g, device="cuda")).to(dt)
        if poison is not None:
            x[n // 3] = poison
        s = None if scale is None else torch.full((), scale, device="cuda")
        sq, flag = mt.l2norm_sq_kernel(x, s)
        again, _ = mt.l2norm_sq_kernel(x, s)
        rsq, rflag = mt.l2norm_sq_torch(x, s)
        torch.cuda.synchronize()
        tag = (f"{n} {str(dt)[6:]}{'' if scale is None else f' scale {scale}'}"
               f"{'' if poison is None else f' with {poison}'}")
        if bool(flag) != bool(rflag) or bool(flag) != (poison is not None):
            raise AssertionError(f"K9 {tag}: flag {bool(flag)}, plain {bool(rflag)}")
        if not torch.equal(sq, again) and poison is None:
            raise AssertionError(f"K9 {tag}: two calls differ ({sq} vs {again})")
        # fp32 sums of squares in another order
        err = (check_close(f"K9 {tag}", sq, rsq, dict(rtol=1e-5, atol=0))
               if poison is None else 0.0)
        fields = dict(found_inf=bool(flag), max_abs_err=err, sq=float(sq),
                      bitwise_repeat=True)
        if n == n_bert and scale is None:
            bms, by = bound_ms(4 * n, 2 * n, torch.float32)
            fields.update(
                ms=time_ms(lambda: mt.l2norm_sq_kernel(x)),
                plain_ms=time_ms(lambda: mt.l2norm_sq_torch(x)),
                library_ms=time_ms(lambda: torch.linalg.vector_norm(x) ** 2),
                bound_ms=bms, bound_by=by)
            rows_out["bert"] = (tag, fields)
        line("K9", shape=tag, **fields)
    return rows_out


LAMB_HYPER = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                  weight_decay=0.01)


def k7_phase(mt, n_bert):
    """LAMB stage 1 over BERT's arena length (decoupled decay, the clip
    engaged) and an awkward length in L2 mode, and a skipped step with an
    inf in the gradient: u = 0, moments bitwise unchanged."""
    rows_out = {}
    checks = [  # n, mode, clip, skip
        (n_bert, 1, 2.5, False),
        (100003, 0, 1.0, False),
        (100003, 1, 3.0, True),
    ]
    for n, mode, clip, skip in checks:
        g = gen(81)
        grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
        if skip:
            grad[n // 2] = float("inf")
        p = 0.02 * torch.randn(n, generator=g, device="cuda")
        m = 1e-4 * torch.randn(n, generator=g, device="cuda")
        v = 1e-8 * torch.rand(n, generator=g, device="cuda")
        step = torch.full((), 4, dtype=torch.int32, device="cuda")
        bc1, bc2 = mt._bias_corrections(True, step, 0.9, 0.999)
        kw = dict(bc1=bc1, bc2=bc2, mode=mode,
                  clip=torch.full((), clip, device="cuda"),
                  found_inf=torch.full((), skip, dtype=torch.bool, device="cuda"),
                  **LAMB_HYPER)
        outs = {}
        for fn in (mt.lamb_stage1_kernel, mt.lamb_stage1_torch):
            st = (m.clone(), v.clone())
            outs[fn] = (fn(grad, p, *st, **kw), *st)
        torch.cuda.synchronize()
        tag = (f"{n} {'decoupled' if mode else 'l2'} clip {clip}"
               f"{' skip' if skip else ''}")
        got, ref = outs[mt.lamb_stage1_kernel], outs[mt.lamb_stage1_torch]
        if skip:
            if not (torch.all(got[0] == 0) and torch.equal(got[1], m)
                    and torch.equal(got[2], v)):
                raise AssertionError(f"K7 {tag}: a skipped step wrote u or moments")
            err = 0.0
        else:
            # a few ulp where the compiler contracts a multiply-add; where
            # the terms of u (or of m) cancel, those ulp are the largest
            # term's, so the absolute part scales with the array's maximum
            err = max(check_close(f"K7 {name} {tag}", a, b,
                                  dict(rtol=1e-5, atol=1e-6 * float(b.abs().max())))
                      for name, a, b in zip(("u", "m", "v"), got, ref))
        fields = dict(max_abs_err=err)
        if n == n_bert:
            # g, p, m, v read; u, m, v written: 28 B per fp32 element
            bms, by = bound_ms(28 * n, 16 * n, torch.float32)
            st = (m.clone(), v.clone())
            fields.update(
                ms=time_ms(lambda: mt.lamb_stage1_kernel(grad, p, *st, **kw)),
                plain_ms=time_ms(lambda: mt.lamb_stage1_torch(grad, p, *st, **kw),
                                 iters=5),
                library_ms=None, bound_ms=bms, bound_by=by)
            rows_out["bert"] = (tag, fields)
        line("K7", shape=tag, **fields)
    return rows_out


def k8_phase(mt, make_spec, bert_spec):
    """The trust-ratio update over BERT's bf16 arena layout with its bf16
    model copy, and over an awkward layout (tensors of 1 element, tensors
    straddling K8's blocks, a length that is no block multiple) with an fp32
    copy, without one, and skipped. u is non-zero on the padding too: the
    padding's ratio is 0, so p's padding must stay 0."""
    awkward = make_spec([(1,), (4095,), (3, 5), (4097,), (70000,), (1,),
                         (8193,), (2, 2)])
    rows_out = {}
    checks = [  # spec, copy dtype, skip
        (bert_spec, torch.bfloat16, False),
        (awkward, torch.float32, False),
        (awkward, None, False),
        (awkward, torch.bfloat16, True),
    ]
    for spec, copy_dt, skip in checks:
        g = gen(82)
        n = spec.padded_total
        p = 0.02 * torch.randn(n, generator=g, device="cuda")
        p[spec.total:] = 0
        u = torch.randn(n, generator=g, device="cuda")
        ratio = BERT_LR * (0.5 + torch.rand(spec.num_tensors, generator=g,
                                            device="cuda"))
        found = torch.full((), skip, dtype=torch.bool, device="cuda")
        outs = {}
        for fn in (mt.scaled_update_kernel, mt.scaled_update_torch):
            pk = p.clone()
            # the copy starts as the model arena does: the params' cast
            ck = None if copy_dt is None else p.to(copy_dt, copy=True)
            fn(pk, u, ratio, spec, found_inf=found, copy_out=ck)
            outs[fn] = (pk, ck)
        torch.cuda.synchronize()
        tag = (f"{n} ({spec.num_tensors} tensors)"
               f"{'' if copy_dt is None else f' copy {str(copy_dt)[6:]}'}"
               f"{' skip' if skip else ''}")
        (pk, ck), (pr, _) = outs[mt.scaled_update_kernel], outs[mt.scaled_update_torch]
        if skip:
            if not (torch.equal(pk, p) and torch.equal(ck, p.to(copy_dt))):
                raise AssertionError(f"K8 {tag}: a skipped step changed state")
            err = 0.0
        else:
            # one ulp where the compiler contracts p - c * u into an fma: an
            # ulp of p or of c * u, which may nearly cancel
            err = check_close(f"K8 {tag}", pk, pr,
                              dict(rtol=1e-6, atol=1e-6 * float(pr.abs().max())))
            if ck is not None and not torch.equal(ck, pk.to(copy_dt)):
                raise AssertionError(f"K8 {tag}: copy is not the new params")
            if not torch.all(pk[spec.total:] == 0):
                raise AssertionError(f"K8 {tag}: the padding of p moved")
        fields = dict(max_abs_err=err)
        if spec is bert_spec:
            # p, u read and p written in fp32, the bf16 copy written, one
            # ratio per tensor read: 14 B per element
            bms, by = bound_ms(14 * n + 4 * spec.num_tensors, 2 * n,
                               torch.float32)
            pk, ck = p.clone(), torch.empty(n, dtype=copy_dt, device="cuda")
            kw = dict(found_inf=found, copy_out=ck)
            fields.update(
                ms=time_ms(lambda: mt.scaled_update_kernel(pk, u, ratio, spec, **kw)),
                plain_ms=time_ms(lambda: mt.scaled_update_torch(pk, u, ratio, spec, **kw),
                                 iters=5),
                library_ms=None, bound_ms=bms, bound_by=by)
            rows_out["bert"] = (tag, fields)
        line("K8", shape=tag, **fields)
    return rows_out


# ------------------------------------------------------------------ K10

SGD_VARIANTS = {  # name -> the hyperparameters besides lr and weight decay
    "plain": dict(momentum=0.9, dampening=0.0, nesterov=False,
                  wd_after_momentum=False),
    "nesterov": dict(momentum=0.9, dampening=0.0, nesterov=True,
                     wd_after_momentum=False),
    "damp_wd_after": dict(momentum=0.9, dampening=0.1, nesterov=False,
                          wd_after_momentum=True),
    "no_momentum": dict(momentum=0.0, dampening=0.0, nesterov=False,
                        wd_after_momentum=False),
}


def k10_phase(mt, arenas):
    """Fused SGD over ResNet-50's arenas (``arenas``: name -> (spec, copy
    dtype)): the O5 bf16 arena with its bf16 model copy and the fp32 one
    with an fp32 copy, the O0 list path's arena without a copy, each at the
    first step (the momentum seeded with g) and a later one; Nesterov,
    dampening with decay after momentum, and no momentum at an awkward
    length with a gradient scale; and a skipped step that must leave p, m
    and the copy bitwise unchanged. The padding is 0 and must stay 0."""
    arenas = {**arenas, "awkward": (None, torch.bfloat16)}
    checks = [  # arena, first_run, skip, variant
        ("resnet_o5", False, False, "plain"),
        ("resnet_o5", True, False, "plain"),
        ("resnet_o5_fp32", False, False, "plain"),
        ("resnet_o0", False, False, "plain"),
        ("resnet_o0", True, False, "plain"),
        ("awkward", False, False, "nesterov"),
        ("awkward", True, False, "damp_wd_after"),
        ("awkward", False, False, "no_momentum"),
        ("resnet_o5", False, True, "plain"),
    ]
    rows_out = {}
    for key, first_run, skip, variant in checks:
        spec, copy_dt = arenas[key]
        n, total = (100003, 100003) if spec is None else (spec.padded_total, spec.total)
        g = gen(90)
        grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
        p = 0.02 * torch.randn(n, generator=g, device="cuda")
        m = 1e-3 * torch.randn(n, generator=g, device="cuda")
        for t in (grad, p, m):
            t[total:] = 0
        scale = (torch.full((), 0.5, device="cuda") if spec is None else 1.0)
        kw = dict(lr=RESNET_LR, weight_decay=RESNET_WD, scale=scale,
                  first_run=torch.full((), first_run, dtype=torch.bool, device="cuda"),
                  found_inf=torch.full((), skip, dtype=torch.bool, device="cuda"),
                  **SGD_VARIANTS[variant])
        outs = {}
        for fn in (mt.sgd_kernel, mt.sgd_torch):
            pk, mk = p.clone(), m.clone()
            # the copy starts as the model arena does: the params' cast
            ck = None if copy_dt is None else p.to(copy_dt, copy=True)
            fn(grad, pk, mk, copy_out=ck, **kw)
            outs[fn] = (pk, mk, ck)
        torch.cuda.synchronize()
        tag = (f"{n} {key} {variant}{' first' if first_run else ''}"
               f"{'' if copy_dt is None else f' copy {str(copy_dt)[6:]}'}"
               f"{' skip' if skip else ''}")
        (pk, mk, ck), (pr, mr, _) = outs[mt.sgd_kernel], outs[mt.sgd_torch]
        if skip:
            if not (torch.equal(pk, p) and torch.equal(mk, m)
                    and torch.equal(ck, p.to(copy_dt))):
                raise AssertionError(f"K10 {tag}: a skipped step changed state")
            err = 0.0
        else:
            # one ulp where the compiler contracts a multiply-add; where the
            # terms cancel, the ulp is the largest term's
            err = max(check_close(f"K10 {name} {tag}", a, b,
                                  dict(rtol=1e-6, atol=1e-6 * float(b.abs().max())))
                      for name, a, b in (("p", pk, pr), ("m", mk, mr)))
            if ck is not None and not torch.equal(ck, pk.to(copy_dt)):
                raise AssertionError(f"K10 {tag}: copy is not the new params")
            if not (torch.all(pk[total:] == 0) and torch.all(mk[total:] == 0)):
                raise AssertionError(f"K10 {tag}: the padding moved")
        fields = dict(max_abs_err=err)
        if key in ("resnet_o5", "resnet_o0") and not (first_run or skip):
            # g read; p and m read and written in fp32; the copy written
            per = 20 + (0 if copy_dt is None else torch.finfo(copy_dt).bits // 8)
            bms, by = bound_ms(per * n, 8 * n, torch.float32)
            st = (p.clone(), m.clone())
            cp = None if copy_dt is None else p.to(copy_dt)
            kwt = dict(kw, first_run=torch.zeros((), dtype=torch.bool, device="cuda"))
            fields.update(
                ms=time_ms(lambda: mt.sgd_kernel(grad, *st, copy_out=cp, **kwt)),
                plain_ms=time_ms(lambda: mt.sgd_torch(grad, *st, copy_out=cp, **kwt),
                                 iters=5),
                # the same fp32 arenas, no model copy
                library_ms=time_ms(lambda: torch._fused_sgd_(
                    [st[0]], [grad], [st[1]], weight_decay=RESNET_WD,
                    momentum=0.9, lr=RESNET_LR, dampening=0.0, nesterov=False,
                    maximize=False, is_first_step=False)),
                bound_ms=bms, bound_by=by)
            rows_out[key] = (tag, fields)
        line("K10", shape=tag, **fields)
    return rows_out


# ------------------------------------------------------------- K16-K18


def check_optimizer_arenas(name, tag, got, ref, total):
    """K17/K18's check: one ulp where the compiler contracts a multiply-add
    (relative 1e-6, and 1e-6 of the arena's largest value where terms
    cancel); the padding (past ``total``) stays 0."""
    err = 0.0
    for what, a, b in zip(("p", "state"), got, ref):
        err = max(err, check_close(f"{name} {what} {tag}", a, b,
                                   dict(rtol=1e-6, atol=1e-6 * float(b.abs().max()))))
        if a[total:].any():
            raise AssertionError(f"{name} {tag}: the padding of {what} moved")
    return err


def k16_phase(mt, rspecs):
    """axpby with its non-finite flag: the accumulation path's two fp32
    gradient arenas (a = b = 0.5, the new gradients checked), bf16 and fp32
    inputs and outputs at an odd length and at length 1 with each
    ``arg_to_check``, and inf and NaN placed in x or y, flagged only where
    checked."""
    n_bf16, n_fp32 = (rspecs[dt].padded_total for dt in (torch.bfloat16, torch.float32))
    f32, bf16 = torch.float32, torch.bfloat16
    checks = [  # n, input dtype, output dtype, arg_to_check, poison (x or y, value)
        (n_bf16, f32, f32, 0, None),
        (n_fp32, f32, f32, 0, None),
        (100003, bf16, bf16, -1, None),
        (100003, bf16, f32, 1, None),
        (100003, f32, bf16, 0, None),
        (1, f32, f32, -1, None),
        (100003, bf16, bf16, -1, ("x", float("nan"))),
        (100003, bf16, bf16, 1, ("x", float("nan"))),
        (100003, f32, f32, 0, ("y", float("inf"))),
        (100003, f32, f32, 1, ("y", float("inf"))),
        (n_bf16, f32, f32, 0, ("x", float("inf"))),
    ]
    rows_out = {}
    for n, dt, out_dt, check, poison in checks:
        g = gen(100)
        x = (1e-3 * torch.randn(n, generator=g, device="cuda")).to(dt)
        y = (1e-3 * torch.randn(n, generator=g, device="cuda")).to(dt)
        if poison is not None:
            (x if poison[0] == "x" else y)[n // 3] = poison[1]
        a, b = torch.full((), 0.5, device="cuda"), 0.5
        out, flag = mt.axpby_kernel(x, y, a, b, out_dt, check)
        ref, rflag = mt.axpby_torch(x, y, a, b, out_dt, check)
        torch.cuda.synchronize()
        expect = poison is not None and check in (-1, "xy".index(poison[0]))
        tag = (f"{n} {str(dt)[6:]}->{str(out_dt)[6:]} check {check}"
               f"{'' if poison is None else f' {poison[1]} in {poison[0]}'}")
        if bool(flag) != bool(rflag) or bool(flag) != expect:
            raise AssertionError(f"K16 {tag}: flag {bool(flag)}, plain "
                                 f"{bool(rflag)}, expected {expect}")
        # one ulp where the compiler contracts a x + b y into an fma (and
        # then one ulp of a half output); where the terms cancel, the
        # ulp is the larger term's
        rtol = 1e-6 if out_dt == f32 else 2 ** -7
        fin = torch.isfinite(ref)
        err = check_close(f"K16 {tag}", out[fin], ref[fin],
                          dict(rtol=rtol, atol=1e-6 * float(ref[fin].abs().max())))
        if not torch.equal(torch.isfinite(out), fin):
            raise AssertionError(f"K16 {tag}: non-finite elements differ")
        fields = dict(found_inf=bool(flag), max_abs_err=err)
        if n == n_bf16 and poison is None:
            # x and y read, out written, fp32: 12 B per element
            bms, by = bound_ms(12 * n, 3 * n, torch.float32)
            fields.update(
                ms=time_ms(lambda: mt.axpby_kernel(x, y, a, b, out_dt, check)),
                plain_ms=time_ms(lambda: mt.axpby_torch(x, y, a, b, out_dt, check),
                                 iters=5),
                # the same traffic: x + 0.5 y, no flag
                library_ms=time_ms(lambda: torch.add(x, y, alpha=0.5)),
                bound_ms=bms, bound_by=by)
            rows_out["resnet_o5_accum"] = (tag, fields)
        line("K16", shape=tag, **fields)
    return rows_out


def k17_phase(mt, spec):
    """Adagrad over the list path's fp32 master arena of ResNet-50 (``spec``)
    in both modes, a bf16 gradient at an odd length, a length of 1, and a
    skipped step with an inf in the gradient that must leave p and h
    bitwise unchanged. The padding is 0 and must stay 0."""
    checks = [  # n (None: the spec's), gradient dtype, mode, skip
        (None, torch.float32, 0, False),
        (None, torch.float32, 1, False),
        (100003, torch.bfloat16, 0, False),
        (1, torch.float32, 1, False),
        (None, torch.float32, 0, True),
    ]
    rows_out = {}
    for n, gdt, mode, skip in checks:
        n, total = (spec.padded_total, spec.total) if n is None else (n, n)
        g = gen(101)
        grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
        p = 0.02 * torch.randn(n, generator=g, device="cuda")
        h = 1e-6 * torch.rand(n, generator=g, device="cuda")
        for t in (grad, p, h):
            t[total:] = 0
        if skip:
            grad[n // 2] = float("inf")
        grad = grad.to(gdt)
        kw = dict(lr=torch.full((), RESNET_LR, device="cuda"), eps=1e-10,
                  weight_decay=RESNET_WD, mode=mode,
                  found_inf=torch.full((), skip, dtype=torch.bool, device="cuda"))
        outs = {}
        for fn in (mt.adagrad_kernel, mt.adagrad_torch):
            pk, hk = p.clone(), h.clone()
            fn(grad, pk, hk, **kw)
            outs[fn] = (pk, hk)
        torch.cuda.synchronize()
        tag = (f"{n} {'decoupled' if mode else 'l2'} g {str(gdt)[6:]}"
               f"{' skip' if skip else ''}")
        got, ref = outs[mt.adagrad_kernel], outs[mt.adagrad_torch]
        if skip:
            if not (torch.equal(got[0], p) and torch.equal(got[1], h)):
                raise AssertionError(f"K17 {tag}: a skipped step changed state")
            err = 0.0
        else:
            err = check_optimizer_arenas("K17", tag, got, ref, total)
        fields = dict(max_abs_err=err)
        if n == spec.padded_total and mode == 0 and not skip:
            # g read; p and h read and written: 20 B per fp32 element
            bms, by = bound_ms(20 * n, 7 * n, torch.float32)
            st = (p.clone(), h.clone())
            param = torch.nn.Parameter(p.clone())
            param.grad = grad.clone()
            # the same function: mode 0, no lr decay, initial sums 0
            adagrad = torch.optim.Adagrad([param], lr=RESNET_LR, eps=1e-10,
                                          weight_decay=RESNET_WD, foreach=True)
            fields.update(
                ms=time_ms(lambda: mt.adagrad_kernel(grad, *st, **kw)),
                plain_ms=time_ms(lambda: mt.adagrad_torch(grad, *st, **kw), iters=5),
                library_ms=time_ms(adagrad.step),
                bound_ms=bms, bound_by=by)
            rows_out["resnet_o5_adagrad"] = (tag, fields)
        line("K17", shape=tag, **fields)
    return rows_out


def k18_phase(mt, make_spec, spec):
    """NovoGrad's elementwise phase over the list path's master arena of
    ResNet-50 (``spec``, 161 tensors) in both modes, over an awkward layout
    (tensors of 1 element, tensors straddling K18's blocks, a length that is
    no block multiple) with bf16 and fp32 gradients, and a skipped step that
    must leave p and m bitwise unchanged. The per-tensor denominators are
    read through the segment table, and the padding (the gradient's is 0)
    must stay 0: the plain version's padding denominator is 1, as K18's."""
    awkward = make_spec([(1,), (4095,), (3, 5), (4097,), (70000,), (1,),
                         (8193,), (2, 2)])
    checks = [  # spec, gradient dtype, mode, skip
        (spec, torch.float32, 0, False),
        (spec, torch.float32, 1, False),
        (awkward, torch.bfloat16, 0, False),
        (awkward, torch.float32, 1, False),
        (awkward, torch.float32, 0, True),
    ]
    rows_out = {}
    for sp, gdt, mode, skip in checks:
        g = gen(102)
        n = sp.padded_total
        grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
        p = 0.02 * torch.randn(n, generator=g, device="cuda")
        m = 1e-4 * torch.randn(n, generator=g, device="cuda")
        for t in (grad, p, m):
            t[sp.total:] = 0
        if skip:
            grad[n // 3] = float("inf")
        grad = grad.to(gdt)
        denom = 0.5 + torch.rand(sp.num_tensors, generator=g, device="cuda")
        step = torch.full((), 4.0, device="cuda")
        kw = dict(beta1=0.95, beta3=0.05, bc1=1.0 - torch.pow(0.95, step),
                  lr=torch.full((), RESNET_LR, device="cuda"),
                  weight_decay=RESNET_WD, mode=mode,
                  found_inf=torch.full((), skip, dtype=torch.bool, device="cuda"))
        outs = {}
        for fn in (mt.novograd_kernel, mt.novograd_torch):
            pk, mk = p.clone(), m.clone()
            fn(grad, pk, mk, denom, sp, **kw)
            outs[fn] = (pk, mk)
        torch.cuda.synchronize()
        tag = (f"{n} ({sp.num_tensors} tensors) mode {mode} g {str(gdt)[6:]}"
               f"{' skip' if skip else ''}")
        got, ref = outs[mt.novograd_kernel], outs[mt.novograd_torch]
        if skip:
            if not (torch.equal(got[0], p) and torch.equal(got[1], m)):
                raise AssertionError(f"K18 {tag}: a skipped step changed state")
            err = 0.0
        else:
            err = check_optimizer_arenas("K18", tag, got, ref, sp.total)
        fields = dict(max_abs_err=err, padding="0")
        if sp is spec and mode == 0:
            # g read; p and m read and written; one denominator per tensor
            bms, by = bound_ms(20 * n + 4 * sp.num_tensors, 8 * n, torch.float32)
            st = (p.clone(), m.clone())
            fields.update(
                ms=time_ms(lambda: mt.novograd_kernel(grad, *st, denom, sp, **kw)),
                plain_ms=time_ms(lambda: mt.novograd_torch(grad, *st, denom, sp, **kw),
                                 iters=5),
                library_ms=None, bound_ms=bms, bound_by=by)
            rows_out["resnet_o5_novograd"] = (tag, fields)
        line("K18", shape=tag, **fields)
    return rows_out


# -------------------------------------------------------------- K11-K12

SOFTMAX_SCALE = 1 / 8  # 1/sqrt(head dim 64), both models


def softmax_checks():
    """(B, H, sq, sk, dtype, mask kind, row key): the GPT causal and BERT
    key-padding training shapes (timed), then awkward ones."""
    H = MODEL["n_heads"]
    return [
        (TRAIN_BATCH, H, MODEL["seq_len"], MODEL["seq_len"], torch.bfloat16,
         "causal", "gpt_unfused"),
        (BERT_BATCH, BERT["n_heads"], BERT["seq_len"], BERT["seq_len"],
         torch.bfloat16, "keys", "bert_unfused"),
        (8, 1, 1000, 1000, torch.bfloat16, "causal", None),
        (16, 1, 96, 96, torch.float32, "causal", None),
        (4, 2, 33, 77, torch.float32, "full", None),
        (4, 2, 33, 77, torch.bfloat16, "full", None),
        (2, 1, 4, 16384, torch.float32, "full", None),
        (3, 2, 5, 77, torch.float16, None, None),
    ]


def softmax_inputs(B, H, sq, sk, dtype, kind, seed):
    """Scores (scaled by 3 so the softmax is not nearly uniform), the mask
    as stored (None; a (B, 1, 1, sk) key-padding mask from ragged lengths
    with a length-0 row; or a (B, 1, sq, sk) mask with a fully masked row)
    and that mask expanded to the scores' shape as a view."""
    g = gen(seed)
    x = (3 * torch.randn(B, H, sq, sk, generator=g, device="cuda")).to(dtype)
    if kind in (None, "causal"):
        return x, None, None
    if kind == "keys":
        lens = np.random.default_rng(seed).integers(0, sk + 1, B)
        lens[:2] = (0, sk)
        lens = torch.tensor(lens, device="cuda")
        mask = (torch.arange(sk, device="cuda")[None, :] >= lens[:, None])
        mask = mask[:, None, None, :]
    else:
        mask = torch.rand(B, 1, sq, sk, generator=g, device="cuda") > 0.7
        mask[0, 0, 1] = True
    return x, mask, mask.expand(x.shape)


def softmax_tag(B, H, sq, sk, dtype, kind):
    return f"B{B} H{H} sq{sq} sk{sk} {str(dtype)[6:]} {kind or 'scale-only'}"


def k11_phase(sm):
    """K11 against its plain version: the probabilities in x's dtype and,
    with a mask, the fp32 ones the backward reads; a fully masked row must
    come out uniform 1/sk."""
    rows_out = {}
    for i, (B, H, sq, sk, dt, kind, key) in enumerate(softmax_checks()):
        x, mask, m4 = softmax_inputs(B, H, sq, sk, dt, kind, 110 + i)
        args = (x, SOFTMAX_SCALE, kind == "causal", m4)
        y, y32 = sm.softmax_fwd_kernel(*args)
        ry, ry32 = sm.softmax_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = softmax_tag(B, H, sq, sk, dt, kind)
        fields = dict(max_abs_err=check_close(f"K11 {tag}", y, ry, PROB_TOL[dt]),
                      **PROB_TOL[dt])
        if m4 is not None:
            fields["fp32_max_abs_err"] = check_close(
                f"K11 fp32 y {tag}", y32, ry32, PROB_TOL[torch.float32])
            if not torch.equal(y, y32.to(dt)):
                raise AssertionError(f"K11 {tag}: y is not the fp32 y's cast")
            row = y32[0, 0, 0] if kind == "keys" else y32[0, 0, 1]
            check_close(f"K11 fully masked row {tag}", row,
                        torch.full_like(row, 1 / sk), PROB_TOL[torch.float32])
        if key is not None:
            # x read once; y and, with a mask, the fp32 y written once; the
            # mask read as stored
            outs = [y] if y32 is None or y32 is y else [y, y32]
            nbytes = sum(t.numel() * t.element_size() for t in (x, *outs))
            nbytes += 0 if mask is None else mask.numel() * mask.element_size()
            bms, by = bound_ms(nbytes, 6 * x.numel(), torch.float32)
            fields.update(
                ms=time_ms(lambda: sm.softmax_fwd_kernel(*args)),
                plain_ms=time_ms(lambda: sm.softmax_fwd_torch(*args), iters=5),
                library_ms=time_ms(lambda: torch.softmax(x, -1)),
                bound_ms=bms, bound_by=by)
            rows_out[key] = (tag, fields)
        line("K11", shape=tag, **fields)
        del x, mask, m4, y, y32, ry, ry32
        torch.cuda.empty_cache()
    return rows_out


def k12_phase(sm):
    """K12 against its plain version on what the forward saved (y in x's
    dtype, or with a mask the fp32 y); masked slots must get exactly 0."""
    rows_out = {}
    for i, (B, H, sq, sk, dt, kind, key) in enumerate(softmax_checks()):
        x, mask, m4 = softmax_inputs(B, H, sq, sk, dt, kind, 120 + i)
        y, y32 = sm.softmax_fwd_torch(x, SOFTMAX_SCALE, kind == "causal", m4)
        saved = y if m4 is None else y32
        dy = torch.randn(x.shape, generator=gen(130 + i), device="cuda").to(dt)
        del x, y32
        args = (saved, dy, SOFTMAX_SCALE, m4)
        dx = sm.softmax_bwd_kernel(*args)
        rdx = sm.softmax_bwd_torch(*args)
        torch.cuda.synchronize()
        tag = softmax_tag(B, H, sq, sk, dt, kind)
        fields = dict(max_abs_err=check_softmax_grad(
            f"K12 {tag}", dx, rdx, saved, dy, SOFTMAX_SCALE, GRAD_RTOL[dt]),
                      rtol=GRAD_RTOL[dt], sum_tol=SUM_TOL)
        if m4 is not None and not torch.all(dx[m4] == 0):
            raise AssertionError(f"K12 {tag}: a masked slot has a gradient")
        if key is not None:
            nbytes = saved.numel() * (saved.element_size() + dy.element_size()
                                      + dx.element_size())
            nbytes += 0 if mask is None else mask.numel() * mask.element_size()
            bms, by = bound_ms(nbytes, 5 * saved.numel(), torch.float32)
            # the library's softmax backward over bf16 y and dy
            yl = saved.to(dt)
            fields.update(
                ms=time_ms(lambda: sm.softmax_bwd_kernel(*args)),
                plain_ms=time_ms(lambda: sm.softmax_bwd_torch(*args), iters=5),
                library_ms=time_ms(lambda: torch._softmax_backward_data(
                    dy, yl, -1, dt)),
                bound_ms=bms, bound_by=by)
            rows_out[key] = (tag, fields)
            del yl
        line("K12", shape=tag, **fields)
        del mask, m4, saved, dy, dx, rdx, y
        torch.cuda.empty_cache()
    return rows_out


# -------------------------------------------------------------- K14-K15


def xent_checks():
    """(N, V, dtype, smoothing, padding index, key, path): the GPT and BERT
    heads' shapes (on the GPT-xent and BERT-xent paths), then the GPT shape
    in bf16, V 50,257 in bf16 and N 11 x V 96 in fp16, each timed; ``path``
    names the run whose launches those rows report."""
    n, nb = TRAIN_BATCH * MODEL["seq_len"], BERT_BATCH * BERT["seq_len"]
    V, VB = MODEL["vocab_size"], BERT["vocab_size"]
    return [
        (n, V, torch.float32, XENT_SMOOTHING, 0, "gpt_xent", None),
        (nb, VB, torch.float32, 0.0, VB - 1, "bert_xent", None),
        (n, V, torch.bfloat16, XENT_SMOOTHING, 0, "gpt_xent_bf16", "gpt_xent"),
        (n, 50257, torch.bfloat16, XENT_SMOOTHING, 0, "v50257_bf16", "gpt_xent"),
        (11, 96, torch.float16, XENT_SMOOTHING, 0, "n11_v96_fp16", "gpt_xent"),
    ]


def xent_inputs(N, V, dtype, pad, seed):
    """Logits (std 2) and labels as the steps give them: with padding index
    0 random labels and the first XENT_PADDED set to 0; with BERT's [MASK]
    (V - 1) a target on 15% of the rows and [MASK] on the rest."""
    g = gen(seed)
    x = (2 * torch.randn(N, V, generator=g, device="cuda")).to(dtype)
    if pad == 0:
        lab = torch.randint(0, V, (N,), generator=g, device="cuda")
        lab[:XENT_PADDED] = 0
    else:
        lab = torch.randint(0, V - 1, (N,), generator=g, device="cuda")
        lab = torch.where(torch.rand(N, generator=g, device="cuda") < 0.15, lab, pad)
    return x, lab


def xent_tag(N, V, dtype, s, pad):
    return f"{N}x{V} {str(dtype)[6:]} s{s} pad{pad}"


def check_xent_loss(name, loss, lse, rloss, rlse):
    """K14's check: ``|loss - ref| <= XENT_LOSS_TOL (|ref| + |lse|)`` and
    ``|lse - ref| <= XENT_LOSS_TOL |lse|`` on every row."""
    bad = ((loss - rloss).abs() > XENT_LOSS_TOL * (rloss.abs() + rlse.abs())) | (
        (lse - rlse).abs() > XENT_LOSS_TOL * rlse.abs())
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} rows "
                             f"out of tolerance, first {bad.nonzero()[0].item()}")
    return max_err(loss, rloss)


def check_xent_grad(name, dx, ref, x, lse, dy, s, lse_err=None):
    """K15's check: ``|dx - ref| <= GRAD_RTOL |ref| + XENT_P_TOL |dy| (p +
    s/V)`` everywhere (plus fp16's subnormal step), p the softmax from the
    same lse. Where the two sides took their lse from K14 and from its plain
    version, ``lse_err`` (per row) adds what it moves: ``|dy| p lse_err``."""
    bad = 0
    for r in range(0, x.shape[0], 2048):  # row blocks: fp32 temporaries
        sl = slice(r, r + 2048)
        p = torch.exp(x[sl].float() - lse[sl, None])
        slack = XENT_P_TOL * (p + s / x.shape[1])
        if lse_err is not None:
            slack += p * lse_err[sl, None]
        bound = GRAD_RTOL[x.dtype] * ref[sl].float().abs() + dy[sl, None].abs() * slack
        if x.dtype == torch.float16:
            bound += 2 ** -24
        bad += int(((dx[sl].float() - ref[sl].float()).abs() > bound).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {dx.numel()} elements out of "
                             f"tolerance")
    return max_err(dx, ref)


def k14_phase(xent):
    """K14 against its plain version on every shape of ``xent_checks``,
    each timed beside its bound and ``F.cross_entropy``."""
    rows_out = {}
    for i, (N, V, dt, s, pad, key, path) in enumerate(xent_checks()):
        x, lab = xent_inputs(N, V, dt, pad, 140 + i)
        loss, lse = xent.xent_fwd_kernel(x, lab, s)
        rloss, rlse = xent.xent_fwd_torch(x, lab, s)
        torch.cuda.synchronize()
        tag = xent_tag(N, V, dt, s, pad)
        fields = dict(max_abs_err=check_xent_loss(f"K14 {tag}", loss, lse, rloss, rlse),
                      lse_max_abs_err=max_err(lse, rlse), tol=XENT_LOSS_TOL)
        # the logits and labels read once, loss and lse written once; max,
        # subtract, exp, rescale and the sum of x per element
        nbytes = x.numel() * x.element_size() + N * (lab.element_size() + 8)
        bms, by = bound_ms(nbytes, 6 * x.numel(), torch.float32)
        fields.update(
            ms=time_ms(lambda: xent.xent_fwd_kernel(x, lab, s)),
            plain_ms=time_ms(lambda: xent.xent_fwd_torch(x, lab, s), iters=5),
            library_ms=time_ms(lambda: F.cross_entropy(
                x, lab, reduction="none", label_smoothing=s, ignore_index=pad)),
            bound_ms=bms, bound_by=by, **({} if path is None else dict(path=path)))
        rows_out[key] = (tag, fields)
        line("K14", shape=tag, **fields)
        del x, lab, loss, lse, rloss, rlse
        torch.cuda.empty_cache()
    return rows_out


def k15_phase(xent):
    """K15 against its plain version on the same lse and dy (0 on the padded
    rows, as the wrapper hands it), which must get exactly 0; each shape
    timed beside its bound and ``F.cross_entropy``'s backward."""
    rows_out = {}
    for i, (N, V, dt, s, pad, key, path) in enumerate(xent_checks()):
        x, lab = xent_inputs(N, V, dt, pad, 150 + i)
        _, lse = xent.xent_fwd_torch(x, lab, s)
        dy = torch.randn(N, generator=gen(160 + i), device="cuda")
        dy = torch.where(lab == pad, 0.0, dy)
        dx = xent.xent_bwd_kernel(x, lab, lse, dy, s)
        rdx = xent.xent_bwd_torch(x, lab, lse, dy, s)
        torch.cuda.synchronize()
        tag = xent_tag(N, V, dt, s, pad)
        fields = dict(max_abs_err=check_xent_grad(f"K15 {tag}", dx, rdx, x, lse, dy, s),
                      rtol=GRAD_RTOL[dt], p_tol=XENT_P_TOL)
        if not torch.all(dx[lab == pad] == 0):
            raise AssertionError(f"K15 {tag}: a padded row has a gradient")
        del rdx
        # the logits read and dx written once, the per-row vectors read once;
        # subtract, exp, compare, multiply-add, subtract, multiply per element
        nbytes = x.numel() * 2 * x.element_size() + N * (lab.element_size() + 8)
        bms, by = bound_ms(nbytes, 6 * x.numel(), torch.float32)
        xl = x.clone().requires_grad_(True)
        fields.update(
            ms=time_ms(lambda: xent.xent_bwd_kernel(x, lab, lse, dy, s)),
            plain_ms=time_ms(lambda: xent.xent_bwd_torch(x, lab, lse, dy, s), iters=5),
            library_ms=grad_ms(lambda: F.cross_entropy(
                xl, lab, reduction="none", label_smoothing=s, ignore_index=pad),
                (xl,), dy.to(dt)),
            bound_ms=bms, bound_by=by, **({} if path is None else dict(path=path)))
        rows_out[key] = (tag, fields)
        line("K15", shape=tag, **fields)
        del x, xl, lab, lse, dy, dx
        torch.cuda.empty_cache()
    return rows_out


def xent_function_phase(xent):
    """``softmax_cross_entropy_loss`` on the card at the GPT head's shape,
    fp32 and bf16 with ``half_to_float``, forward and backward on K14/K15
    against the plain path: the losses in the dtype asked for, the padded
    rows' loss and gradient exactly 0, the rest within K14's and K15's
    bounds."""
    n, V = TRAIN_BATCH * MODEL["seq_len"], MODEL["vocab_size"]
    for dt, h2f in ((torch.float32, False), (torch.bfloat16, True)):
        x, lab = xent_inputs(n, V, dt, 0, 170)
        w = torch.randn(n, generator=gen(171), device="cuda")
        out = {}
        for impl in (None, "torch"):
            xl = x.clone().requires_grad_(True)
            loss = xent.softmax_cross_entropy_loss(
                xl, lab, smoothing=XENT_SMOOTHING, padding_idx=0,
                half_to_float=h2f, impl=impl)
            (loss.float() * w).sum().backward()
            torch.cuda.synchronize()
            if loss.dtype != (torch.float32 if h2f else dt) or xl.grad.dtype != dt:
                raise AssertionError(f"xent_function ({impl}): dtypes "
                                     f"{loss.dtype}, {xl.grad.dtype}")
            pad = lab == 0
            if not (torch.all(loss[pad] == 0) and torch.all(xl.grad[pad] == 0)):
                raise AssertionError(f"xent_function ({impl}): a padded row has "
                                     f"a loss or a gradient")
            out[impl] = (loss.detach().float(), xl.grad)
            del xl
        _, klse = xent.xent_fwd_kernel(x, lab, XENT_SMOOTHING)
        _, rlse = xent.xent_fwd_torch(x, lab, XENT_SMOOTHING)
        tag = xent_tag(n, V, dt, XENT_SMOOTHING, 0)
        (lk, gk), (lt, gt) = out[None], out["torch"]
        loss_err = check_xent_loss(f"xent_function {tag}", lk, klse, lt, rlse)
        dy = torch.where(lab == 0, 0.0, w)
        grad_err = check_xent_grad(f"xent_function {tag}", gk, gt, x, rlse, dy,
                                   XENT_SMOOTHING, lse_err=(klse - rlse).abs())
        line("xent_function", shape=tag, half_to_float=h2f,
             padded_rows=int((lab == 0).sum()), loss_max_abs_err=loss_err,
             grad_max_abs_err=grad_err, padded="loss and gradient exactly 0")
        del x, lab, w, out, lk, gk, lt, gt, klse, rlse, dy
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- engine


class counting:
    """``module.name`` replaced by a wrapper that counts its calls, restored
    on exit."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapper(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def engine_phase(infer, gpt, cast_floats, params, cfg, attn):
    """The full-width bf16 engine on K1/K2 against its plain path, and paged
    decode against the contiguous forward. On the kernels each decode call
    reads the pools in place: n_layers launches of K2's paged mode, no
    contiguous K2 and no gathered page."""
    ecfg = infer.EngineConfig(**ENGINE)
    engines = {impl: infer.InferenceEngine(params, cfg, ecfg, impl=impl)
               for impl in ("kernel", "torch")}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 769, 8)]
    alloc = infer.PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(infer.pages_for(len(p) + 8, ecfg.page_size))
              for p in prompts]
    toks = {i: e.prefill(prompts, tables) for i, e in engines.items()}
    feed, lens = toks["kernel"].tolist(), [len(p) for p in prompts]
    worst, flips = 0.0, 0
    for _ in range(4):
        paged, flash = attn._paged_decode_kernel.launches, attn.flash_fwd_kernel.launches
        with counting(infer.kvcache, "gather_pages") as gathers:
            got = torch.from_numpy(engines["kernel"].decode_logits(feed, lens, tables))
        if (attn._paged_decode_kernel.launches - paged != cfg.n_layers
                or attn.flash_fwd_kernel.launches != flash or gathers.calls):
            raise AssertionError(
                f"engine decode on the kernels: {attn._paged_decode_kernel.launches - paged} "
                f"paged launches (n_layers {cfg.n_layers}), "
                f"{attn.flash_fwd_kernel.launches - flash} contiguous, "
                f"{gathers.calls} gathers")
        ref = torch.from_numpy(engines["torch"].decode_logits(feed, lens, tables))
        if got.shape != (len(prompts), cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"engine logits malformed: {tuple(got.shape)}")
        err = max_err(got, ref)
        if err > LOGIT_TOL:
            raise AssertionError(f"engine kernel vs plain logits differ by {err}")
        worst = max(worst, err)
        # a token may differ only where the plain path's top two are closer
        # than the two paths' disagreement
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        flips += int((got.argmax(-1) != ref.argmax(-1))[clear].sum())
        feed, lens = got.argmax(-1).tolist(), [n + 1 for n in lens]
    if flips:
        raise AssertionError(f"{flips} greedy tokens differ beyond the tie margin")
    # paged incremental decode against the contiguous full forward (the
    # repo's own oracle): the last row of forward() over prompt + fed token
    eng = engines["kernel"]
    p0 = prompts[0] + [feed[0]]
    eng.reset_cache()
    t0 = [alloc.alloc(infer.pages_for(len(p0), ecfg.page_size))]
    eng.prefill([p0[:-1]], t0)
    paged = torch.from_numpy(eng.decode_logits([p0[-1]], [len(p0) - 1], t0))[0]
    with torch.no_grad():
        full = gpt.forward(cast_floats(params, torch.bfloat16),
                           torch.tensor([p0], device="cuda"), cfg)
    full_err = max_err(paged, full[0, -1].cpu())
    if full_err > LOGIT_TOL:
        raise AssertionError(f"paged decode vs contiguous forward: {full_err}")
    torch.cuda.synchronize()
    line("engine", kernel_vs_plain_max_abs_err=worst, tol=LOGIT_TOL,
         paged_vs_forward_max_abs_err=full_err, decode_steps=4,
         prompts=len(prompts), paged_launches_per_decode=cfg.n_layers,
         gathers_on_kernel_path=0)


# --------------------------------------------------------------- serving


def serving_requests(infer, cfg):
    """The seeded request mix: prompts of 64-768 tokens, 32-128 new ones."""
    rng = np.random.default_rng(4)
    lens = zip(rng.integers(64, 769, N_REQUESTS), rng.integers(32, 129, N_REQUESTS))
    return [infer.Request(rid=i,
                          prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                          max_new_tokens=int(m))
            for i, (n, m) in enumerate(lens)]


def serving_phase(infer, params, cfg, norm, attn, card, cache_dtype="float32",
                  label="serving"):
    """The seeded request mix through ``ContinuousBatcher.run()`` on pages of
    ``cache_dtype``, the launch counts reset just before and read just
    after: prefill attends on the contiguous K2; decode on K2's paged mode
    over fp32, bf16 and fp16 pages, on its contiguous decode path over the
    dequantized copy of e4m3 pages. Returns the engine, the launches and
    each request's stream."""
    ecfg = infer.EngineConfig(**{**ENGINE, "num_pages": SERVE_PAGES,
                                 "cache_dtype": cache_dtype})
    eng = infer.InferenceEngine(params, cfg, ecfg)
    reqs = serving_requests(infer, cfg)
    bat = infer.ContinuousBatcher(eng)
    for r in reqs:
        bat.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"layer_norm_fwd": norm.ln_fwd_kernel,
                "flash_fwd": attn.flash_fwd_kernel,
                "paged_decode": attn._paged_decode_kernel}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    fin = bat.run(max_steps=10000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    calls = eng.call_counts
    steps = calls["prefill"] + calls["decode"]
    in_place = cache_dtype != "e4m3"  # K2's paged mode reads the pools
    paged = cfg.n_layers * calls["decode"] * in_place
    expect = {"layer_norm_fwd": (2 * cfg.n_layers + 1) * steps,
              "flash_fwd": cfg.n_layers * steps - paged, "paged_decode": paged}
    if len(fin) != N_REQUESTS or any(len(r.out) != r.max_new_tokens for r in fin):
        raise AssertionError("not every request finished")
    if bat.allocator.available != ecfg.num_pages - 1:
        raise AssertionError("pages leaked")
    if not all(0 <= t < cfg.vocab_size for r in fin for t in r.out):
        raise AssertionError("token outside the vocabulary")
    preempt = sum(r.preemptions for r in fin)
    if preempt < 1:
        raise AssertionError("the serving run never preempted")
    for name, n in launches.items():
        if n != expect[name] or (n <= 0 and name != "paged_decode"):
            raise AssertionError(f"{label} {name}: {n} launches, engine calls "
                                 f"imply {expect[name]}")
    if launches["paged_decode"] <= 0 and in_place:
        raise AssertionError(f"{label}: no paged decode launched")
    tokens = sum(len(r.out) for r in fin)
    line(label, requests=len(fin), generated_tokens=tokens, cache_dtype=cache_dtype,
         launches=json.dumps(launches),
         prompt_tokens=sum(len(r.prompt) for r in reqs),
         prefill_calls=calls["prefill"], decode_calls=calls["decode"],
         preemptions=preempt, tokens_per_s=tokens / wall, wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         signatures=eng.compiled_signatures, card=f"'{card}'")
    return eng, launches, {r.rid: r.out for r in fin}


# K1's kernel symbol; "_ln_fwd" is the Triton K1 of older checkouts, which
# chip_ab.py profiles with these groups
K1_FRAGMENTS = ("ln_fwd_rows", "_ln_fwd")
# kernel-name fragments -> the layer of the serving path they belong to
KERNEL_GROUPS = (("K1 layer_norm_fwd", K1_FRAGMENTS),
                 ("K2 flash_fwd", ("flash_fwd_",)),
                 ("K2 decode", ("flash_decode_",)),
                 ("gemm", ("gemm", "sm90_", "cutlass", "xmma", "cublas", "nvjet")),
                 ("gather/scatter", ("index", "gather", "scatter")))
# the serving path's page and layout ops, by the outermost such op on the
# host: gathers of pages, dtype casts (the gathered pages' narrowing, the
# scatters' widening), layout copies (reshape or contiguous of a transposed
# view) and the scatters into the pools; each with its kernels' device ms
PAGE_OPS = (("gathers", ("aten::index",)), ("casts", ("aten::_to_copy",)),
            ("copies", ("aten::clone",)), ("scatters", ("aten::index_put_",)))


def op_groups_ms(prof, ops):
    """Device ms of the outermost events of each group of host ops in
    ``ops``, their children's kernels included."""
    group = {name: g for g, names in ops for name in names}
    out = {g: 0.0 for g, _ in ops}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or evt.name not in group:
            continue
        parent = evt.cpu_parent
        while parent is not None and parent.name not in group:
            parent = parent.cpu_parent
        if parent is None:
            out[group[evt.name]] += evt.device_time_total / 1e3
    return out


def profile_phase(infer, eng, cfg, label="profile", n_requests=None):
    """The same request mix again (its first ``n_requests``, default all)
    under torch.profiler: device time by layer and the device's idle share
    over the run (the timed run above is not profiled, so its wall time
    carries no profiler cost)."""
    bat = infer.ContinuousBatcher(eng)
    for r in serving_requests(infer, cfg)[:n_requests]:
        bat.submit(r)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bat.run(max_steps=10000)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, groups = device_ms_by_group(prof, KERNEL_GROUPS)
    busy = sum(by_name.values())
    if busy == 0:
        line(label, device_time="not measured (no CUDA events in the trace)")
        return
    require_k1(label, groups)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "by_layer_ms": groups, "page_ops_ms": op_groups_ms(prof, PAGE_OPS),
        "top_kernels_ms": {k[:90]: v for k, v in top}}), flush=True)


DECODE_BATCH = 32  # ENGINE's largest decode bucket
DECODE_CALLS = 8


def decode_profile(infer, params, cfg, seed=5):
    """The decode step alone at ENGINE's largest bucket: DECODE_BATCH
    sequences of 1..1000 prompt tokens (uniform, mean ~500) prefilled, then
    DECODE_CALLS decode calls timed on the host clock (each ends in the
    tokens' copy to the host) and DECODE_CALLS more under torch.profiler.
    Per call: wall ms, tokens/s, device busy ms, idle share, device ms by
    layer (KERNEL_GROUPS) and by page op (PAGE_OPS)."""
    ecfg = infer.EngineConfig(**ENGINE)
    eng = infer.InferenceEngine(params, cfg, ecfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(1, 1001, DECODE_BATCH)]
    alloc = infer.PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(infer.pages_for(len(p) + 2 * DECODE_CALLS + 1,
                                          ecfg.page_size)) for p in prompts]
    state = {"toks": eng.prefill(prompts, tables).tolist(),
             "lens": [len(p) for p in prompts]}

    def call():
        state["toks"] = eng.decode(state["toks"], state["lens"], tables).tolist()
        state["lens"] = [n + 1 for n in state["lens"]]

    call()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_CALLS):
        call()
    wall_ms = 1e3 * (time.perf_counter() - t0) / DECODE_CALLS
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_CALLS):
            call()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / DECODE_CALLS
    by_name, groups = device_ms_by_group(prof, KERNEL_GROUPS)
    busy = sum(by_name.values()) / DECODE_CALLS
    if busy == 0:
        raise AssertionError("decode profile: no CUDA events in the trace")
    require_k1("decode profile", groups)
    per = 1.0 / DECODE_CALLS
    return {"batch": DECODE_BATCH, "mean_len": float(np.mean(state["lens"])),
            "wall_ms_per_call": wall_ms, "tokens_per_s": DECODE_BATCH / wall_ms * 1e3,
            "profiled_wall_ms_per_call": prof_ms, "device_busy_ms_per_call": busy,
            "idle_share": 1.0 - busy / prof_ms,
            "by_layer_ms_per_call": {k: v * per for k, v in groups.items()},
            "page_ops_ms_per_call": {k: v * per for k, v in
                                     op_groups_ms(prof, PAGE_OPS).items()}}


def decode_profile_phase(infer, params, cfg):
    print("decode_profile: " + json.dumps(decode_profile(infer, params, cfg)),
          flush=True)


# -------------------------------------------------------------- training


def make_gpt_trainer(amp, gpt, fused_adam, params, cfg, impl=None,
                     loss_scale=None, loss_weight=None, loss=None, level="O5"):
    """The flagship step as ``bench.py`` ``make_gpt_rung`` builds it: amp O5
    (or ``level``: O2 arena-native too; O1/O4 plain FusedAdam on the fp32
    tree, which JAX refuses to pack), arena-native PackedParams,
    FusedAdam(lr=1e-4). ``impl="torch"`` puts every op on its plain version;
    ``loss_weight`` multiplies the loss; ``loss(logits, targets, impl)``
    replaces ``gpt.loss_fn``'s cross entropy, as a user script passes its
    own loss. A config with dropout rates trains with a per-step key (see
    :func:`scaled_step`)."""
    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl,
                              dropout_impl=impl)
    m = amp.initialize(lambda p, t, key: gpt.forward(p, t, cfg, dropout_key=key),
                       params, fused_adam(lr=LR, impl=impl), level,
                       arena_native=level in ARENA_LEVELS, loss_scale=loss_scale)

    def loss_fn(p, tok, tgt, key):
        fwd = lambda pp, t: m.apply(pp, t, key)
        if loss is None:
            value = gpt.loss_fn(p, tok, tgt, cfg, forward_fn=fwd)
        else:
            value = loss(fwd(p, tok), tgt, impl)
        return value if loss_weight is None else value * loss_weight

    return m, *scaled_step(amp, m, loss_fn, impl, has_dropout(cfg))


def make_bert_trainer(amp, bert, fused_lamb, params, cfg, impl=None,
                      loss_scale=None, loss_weight=None, loss=None):
    """The BERT step as ``bench.py`` ``make_bert_rung`` builds it: amp O5,
    arena-native PackedParams, FusedLAMB(lr=1e-3, weight_decay=0.01), the
    MLM + NSP pretraining loss; here under the amp loss scaler (K5).
    ``loss(mlm, nsp, targets, mask, nsp_labels, impl)`` replaces
    ``pretrain_loss``'s objective on the model's two heads."""
    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl,
                              dropout_impl=impl)
    m = amp.initialize(lambda p, t: bert.forward(p, t, cfg), params,
                       fused_lamb(lr=BERT_LR, weight_decay=0.01, impl=impl),
                       "O5", arena_native=True, loss_scale=loss_scale)

    def loss_fn(p, tok, tgt, mask, nsp, lens, key):
        if loss is None:
            value = bert.pretrain_loss(p.unpack(), tok, tgt, mask, nsp, cfg,
                                       seq_lens=lens, dropout_key=key)
        else:
            mlm, nsp_logits = bert.forward(p.unpack(), tok, cfg, seq_lens=lens,
                                           dropout_key=key)
            value = loss(mlm, nsp_logits, tgt, mask, nsp, impl)
        return value if loss_weight is None else value * loss_weight

    return m, *scaled_step(amp, m, loss_fn, impl, has_dropout(cfg))


def gpt_xent_loss(xent):
    """The GPT-xent step's loss as a user script writes it: Apex's fused
    cross entropy over the flattened logits with label smoothing
    XENT_SMOOTHING and padding index 0, summed and divided by the number of
    unpadded targets (at least 1), on the card with no host sync."""
    def loss(logits, tgt, impl):
        t = tgt.reshape(-1)
        per = xent.softmax_cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), t, smoothing=XENT_SMOOTHING,
            padding_idx=0, impl=impl)
        return per.sum() / torch.clamp((t != 0).sum(), min=1)

    return loss


def bert_xent_loss(xent, mask_id):
    """The BERT-xent step's loss: the MLM term through the fused cross
    entropy over ``where(mask, targets, [MASK])`` with padding index [MASK]
    (never a target) and no smoothing, summed and divided by ``max(sum(mask),
    1)``; the NSP term as in ``pretrain_loss``. This is ``pretrain_loss``'s
    objective."""
    def loss(mlm, nsp, tgt, mask, nsp_labels, impl):
        labels = torch.where(mask > 0, tgt, mask_id).reshape(-1)
        per = xent.softmax_cross_entropy_loss(
            mlm.reshape(-1, mlm.shape[-1]), labels, padding_idx=mask_id, impl=impl)
        mlm_loss = per.sum() / torch.clamp(mask.sum(), min=1.0)
        nsp_logz = torch.logsumexp(nsp, dim=-1)
        nsp_tgt = nsp.gather(-1, nsp_labels[:, None].long())[:, 0]
        return mlm_loss + (nsp_logz - nsp_tgt).mean()

    return loss


def xent_batch(batch):
    """The GPT batch with its first XENT_PADDED targets set to the padding
    index 0 (``testing/tpu_checks.py`` forces padded rows the same way)."""
    tok, tgt = batch
    tgt = tgt.clone()
    tgt.view(-1)[:XENT_PADDED] = 0
    return tok, tgt


def has_dropout(cfg):
    return cfg.dropout_rate > 0.0 or cfg.attention_dropout > 0.0


def scaled_step(amp, m, loss_fn, impl, dropout=False):
    """``(state, step)``: ``step(*batch)`` runs one scaled forward and
    backward and one optimizer step, in place on ``m.params`` and ``state``.
    The loss function's last argument is the step's dropout key: with
    ``dropout``, DROPOUT_SEED's key folded with the optimizer's step count,
    on the card (no host sync), else None."""
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import fold_in

    svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
    state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init()}
    base = flash_key() if dropout else None

    def step(*batch):
        key = None if base is None else fold_in(base, state["opt"]["inner"][0]["step"])
        loss, g, fi, state["scaler"] = svag(m.params, state["scaler"], *batch, key)
        m.params, state["opt"] = m.optimizer.step(m.params, g, state["opt"],
                                                  found_inf=fi)
        return loss, g, fi

    return state, step


def model_leaves(params):
    """The model's arenas (arena-native) or its tree's leaves."""
    from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten

    return params.arenas if isinstance(params, PackedParams) else tree_flatten(params)[0]


def snapshot(m, state):
    """Copies of everything a step may change, as flat lists: the model,
    the masters (none without MasterWeights), the optimizer's state tensors
    but the step counts, and the step counts."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    opt = state["opt"]
    inner = opt.get("inner", opt)
    inners = inner if isinstance(inner, tuple) else (inner,)
    moments = [t for b in inners for k in sorted(b) if k != "step"
               for t in tree_flatten(b[k])[0]]
    return ([a.clone() for a in model_leaves(m.params)],
            [a.clone() for a in tree_flatten(opt.get("master", ()))[0]],
            [t.clone() for t in moments], [int(b["step"]) for b in inners])


def step_parity_phase(label, trainer, batch, master_tol, why, ref=None,
                      ref_name="plain", loss_tol=5e-3, grad_tol=0.05):
    """One full-width step at batch 2 on the kernels and on the plain path
    from the same weights and batch; or, with ``ref`` (a trainer on the
    kernels too, named ``ref_name``), against ``ref``'s step. ``master_tol``
    bounds how far the two paths' masters may part (``why`` says why),
    ``loss_tol`` their losses (relative), ``grad_tol`` their gradient arenas
    (relative L2)."""
    res = {}
    makers = {"kernels": trainer,
              "ref": ref or (lambda **kw: trainer(impl="torch", **kw))}
    for name, make in makers.items():
        m, state, step = make()
        loss, g, fi = step(*batch)
        torch.cuda.synchronize()
        if bool(fi):
            raise AssertionError(f"{label} ({name}): found_inf set")
        model, masters, _, _ = snapshot(m, state)
        for arena, master in zip(model, masters):
            if not torch.equal(arena, master.to(arena.dtype)):
                raise AssertionError(
                    f"{label} ({name}): model arena != masters.to(dtype)")
        # no masters (O1/O4): the fp32 model is what Adam updates
        res[name] = (loss.item(), [a.clone() for a in model_leaves(g)],
                     masters or model)
        has_masters = bool(masters)
        del m, state, step, g
        torch.cuda.empty_cache()
    (lk, gk, mk), (lp, gp, mp) = res["kernels"], res["ref"]
    loss_err = abs(lk - lp) / abs(lp)
    if not (np.isfinite(lk) and loss_err < loss_tol):
        raise AssertionError(f"{label}: loss {lk} vs reference {lp}")
    grad_rel = [float((a - b).norm() / b.norm()) for a, b in zip(gk, gp)]
    if max(grad_rel) > grad_tol:
        raise AssertionError(f"{label}: grad arenas differ, rel L2 {grad_rel}")
    master_err = max(max_err(a, b) for a, b in zip(mk, mp))
    if master_err > master_tol:
        raise AssertionError(f"{label}: masters differ by {master_err} "
                             f"> {master_tol} ({why})")
    flips = sum(int(((a - b).abs() > master_tol / 2).sum()) for a, b in zip(mk, mp))
    line(label, batch=PARITY_BATCH, loss=lk, plain_loss=lp,
         reference=ref_name,
         loss_rel_err=loss_err, loss_tol=loss_tol, grad_rel_l2=max(grad_rel),
         grad_tol=grad_tol,
         grad_max_abs_err=max(max_err(a, b) for a, b in zip(gk, gp)),
         master_max_abs_err=master_err, master_tol=master_tol,
         master_sign_flips=flips,
         model_arena_is_master_cast="bitwise" if has_masters else "no masters")


def skip_phase(label, trainer, batch):
    """An O5 step with a dynamic loss scale whose gradients overflow. bf16
    shares fp32's exponent range and these gradients stay below 1, so no
    finite scale overflows them (and above 2**126 the scale's inverse is
    subnormal); the loss is multiplied by inf instead, as the JAX package's
    amp tests do. The step must leave masters, moments, step counts and
    model arenas bitwise unchanged and halve the scale."""
    inf = torch.full((), float("inf"), device="cuda")
    m, state, step = trainer(loss_scale="dynamic", loss_weight=inf)
    before = snapshot(m, state)
    scale0 = state["scaler"]["scale"].item()
    _, _, fi = step(*batch)
    torch.cuda.synchronize()
    after = snapshot(m, state)
    if not bool(fi):
        raise AssertionError(f"{label}: found_inf not set")
    same = all(torch.equal(a, b) for xs, ys in zip(before[:3], after[:3])
               for a, b in zip(xs, ys))
    if not same or after[3] != before[3]:
        raise AssertionError(f"{label}: the state changed")
    scale1 = state["scaler"]["scale"].item()
    if scale1 != scale0 / 2:
        raise AssertionError(f"{label}: scale {scale0} -> {scale1}")
    line(label, found_inf=True, state="bitwise unchanged",
         scale_before=scale0, scale_after=scale1, step_count=after[3][0])
    del m, state, step
    torch.cuda.empty_cache()


def launch_counters(norm, attn, mt, sm, xent):
    return {"layer_norm_fwd": norm.ln_fwd_kernel,
            "layer_norm_bwd": norm.ln_bwd_kernel,
            "flash_fwd": attn.flash_fwd_kernel,
            "flash_bwd": attn.flash_bwd_kernel,
            "unscale": mt.scale_kernel, "adam": mt.adam_kernel,
            "l2norm": mt.l2norm_sq_kernel, "lamb_stage1": mt.lamb_stage1_kernel,
            "scaled_update": mt.scaled_update_kernel, "sgd": mt.sgd_kernel,
            "softmax_fwd": sm.softmax_fwd_kernel,
            "softmax_bwd": sm.softmax_bwd_kernel,
            "dropout_mask": attn.dropout_keep_mask_kernel,
            "xent_fwd": xent.xent_fwd_kernel, "xent_bwd": xent.xent_bwd_kernel,
            "axpby": mt.axpby_kernel, "adagrad": mt.adagrad_kernel,
            "novograd": mt.novograd_kernel,
            "paged_decode": attn._paged_decode_kernel,
            "adam_views": mt.adam_views_kernel, "sgd_views": mt.sgd_views_kernel}


def unfused_vs_flash_phase(label, forward, batch):
    """The port's own version of ``tests/test_gpt_flagship.py``
    ``test_flash_matches_unfused`` at full width on the card: ``forward(
    flash, batch)`` returns ``(logits, loss)``; the unfused path (K11 and
    the bf16 score products) against flash attention (K2), both on the
    kernels, on the same weights and batch. Both round the probabilities to
    bf16 before their product with v, in other places."""
    with torch.no_grad():
        (lf, loss_f), (lu, loss_u) = forward(True, batch), forward(False, batch)
    torch.cuda.synchronize()
    if not torch.isfinite(lu).all():
        raise AssertionError(f"{label}: non-finite unfused logits")
    err = max_err(lu, lf)
    rel = abs(loss_u.item() - loss_f.item()) / abs(loss_f.item())
    if err > LOGIT_TOL or rel > UNFUSED_LOSS_TOL:
        raise AssertionError(f"{label}: logits differ by {err} (tol {LOGIT_TOL}), "
                             f"loss {loss_u.item()} vs flash {loss_f.item()}")
    line(label, batch=batch[0].shape[0], unfused_loss=loss_u.item(),
         flash_loss=loss_f.item(), loss_rel_err=rel, loss_tol=UNFUSED_LOSS_TOL,
         logits_max_abs_err=err, logits_tol=LOGIT_TOL)


def dropout_flash_vs_unfused_phase(label, gpt, bert, params, bparams, mcfg,
                                   model, bcfg):
    """Flash against unfused attention at dropout 0.1/0.1 on one key, both
    on the kernels, forward: K2's in-kernel mask and K13's mask on the
    unfused probabilities are drawn at the same (b H + h, query, key), so
    the two paths drop the same probabilities. GPT at batch 16, BERT at
    batch 128 with ragged lengths."""
    from beforeholiday_tpu_torch.ops._autocast import cast_floats

    key = flash_key()
    if model == "gpt":
        p16 = cast_floats(params, torch.bfloat16)
        batch = gpt.synthetic_batch(mcfg, TRAIN_BATCH, generator=gen(73),
                                    device="cuda")

        def forward(flash, b):
            c = dataclasses.replace(mcfg, use_flash_attention=flash)
            logits = gpt.forward(p16, b[0], c, dropout_key=key)
            return logits, gpt._cross_entropy(logits, b[1])
    else:
        p16 = cast_floats(bparams, torch.bfloat16)
        ragged = np.random.default_rng(74).integers(1, mcfg.seq_len + 1, BERT_BATCH)
        batch = bert_batch(bert, bcfg, BERT_BATCH, 74, ragged.tolist())

        def forward(flash, b):
            c = dataclasses.replace(mcfg, use_flash_attention=flash)
            mlm, _ = bert.forward(p16, b[0], c, seq_lens=b[4], dropout_key=key)
            return mlm, bert.pretrain_loss(p16, *b[:4], c, seq_lens=b[4],
                                           dropout_key=key)
    unfused_vs_flash_phase(label, forward, batch)
    del p16
    torch.cuda.empty_cache()


@contextlib.contextmanager
def watch_syncs():
    """Records every synchronizing CUDA call of the block, under
    ``set_sync_debug_mode("warn")``: yields ``(syncs, port_syncs)``, the
    count by site (the warning's, and the innermost frame of this
    repository that led to it) and the sites whose frame is in the port."""
    syncs, port_syncs = {}, []

    def record_sync(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "beforeholiday_tpu_torch" in f.filename
                or f.filename.endswith("chip_smoke.py")]
        site = "/".join(filename.split("/")[-3:]) + f":{lineno}"
        if ours:
            site += f" <- {ours[-1].filename.split('/')[-1]}:{ours[-1].lineno}"
            if "beforeholiday_tpu_torch" in ours[-1].filename:
                port_syncs.append(site)
        syncs[site] = syncs.get(site, 0) + 1

    torch.cuda.set_sync_debug_mode("warn")  # warns once itself: not recorded
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record_sync
            yield syncs, port_syncs
    finally:
        torch.cuda.set_sync_debug_mode("default")


def training_phase(label, profile_label, step, batch, counters, expect,
                   groups, card, *, unit, units, flops, peak, fp8_flops=0.0,
                   ranges=None, timed_steps=TIMED_STEPS, profile=True, **fields):
    """2 warm-up and TIMED_STEPS timed steps on one fixed batch, the launch
    counts reset just before the timed steps and read just after, under
    ``set_sync_debug_mode("warn")``; then PROFILE_STEPS steps under
    torch.profiler. ``units`` (tokens or images) and ``flops`` are one
    step's work, ``peak`` the FLOP/s the MFU is taken against, and
    ``fp8_flops`` the work that runs on the fp8 tensor cores (taken against
    PEAK_FP8); ``fields`` are printed as they are; ``ranges`` (see
    :func:`train_profile`) adds profiler ranges; ``timed_steps`` and
    ``profile=False`` shorten a run whose time the budget cannot afford.
    The loss must fall: the last timed step's below the loss the first
    warm-up step returns, which no update of this phase has touched yet.
    Returns the timed steps' launch counts."""
    start = step(*batch)[0]
    for _ in range(WARMUP_STEPS - 1):
        step(*batch)
    torch.cuda.synchronize()
    start = start.item()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    events, losses, flags = [], [], []
    with watch_syncs() as (syncs, port_syncs):
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss, _, fi = step(*batch)
            b.record()
            events.append((a, b))
            losses.append(loss)
            flags.append(fi)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, per_step in expect.items():
        if launches[k] != per_step * timed_steps:
            raise AssertionError(f"{label} {k}: {launches[k]} launches in "
                                 f"{timed_steps} steps, the model implies "
                                 f"{per_step} per step")
    if port_syncs:
        raise AssertionError(f"{label}: the port's code synchronized the host: "
                             f"{port_syncs}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    first, last = losses[0].item(), losses[-1].item()
    if not (np.isfinite(start) and np.isfinite(last) and last < start):
        raise AssertionError(f"{label}: loss {start} (before the phase's "
                             f"updates) -> {last}")
    med = float(np.median(step_ms))
    MEDIANS[label] = med
    mfu = (flops / peak + fp8_flops / PEAK_FP8) / (med / 1e3)
    line(label, steps=timed_steps, batch=batch[0].shape[0], **fields,
         **{f"{unit}_per_step": units}, median_step_ms=med,
         min_step_ms=min(step_ms),
         **{f"{unit}_per_s": units * timed_steps / wall},
         model_flops_per_step=flops + fp8_flops,
         **({"fp8_flops_per_step": fp8_flops} if fp8_flops else {}), mfu=mfu,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         start_loss=start, first_loss=first, last_loss=last,
         losses=json.dumps([round(x.item(), 4) for x in losses]),
         skipped_steps=int(torch.stack(flags).sum()),
         host_syncs=sum(syncs.values()), sync_sites=json.dumps(syncs),
         launches_per_step=json.dumps(
             {k: v // timed_steps for k, v in launches.items()}),
         card=f"'{card}'")
    if profile:
        train_profile(profile_label, step, batch, groups, ranges)
    return launches


# each timed run's median step ms, by its line's label (for the phases that
# put another step's time beside their own)
MEDIANS = {}


def lm_work(m, batch):
    """One language-model step's work: its tokens, and 6 N FLOPs per token
    against the bf16 (and fp16) peak."""
    tokens = batch[0].numel()
    n_params = (sum(spec.total for spec in m.params.layout.specs)
                if hasattr(m.params, "layout")
                else sum(t.numel() for t in model_leaves(m.params)))
    return dict(unit="tokens", units=tokens, flops=6.0 * n_params * tokens,
                peak=PEAK_BF16, params=n_params)


def require_k1(label, groups):
    """A profile of a path with LayerNorms must find K1's kernel by its
    symbol (K1_FRAGMENTS): an empty K1 group means the fragments no longer
    match what the card ran."""
    if groups.get("K1 layer_norm_fwd", 1.0) == 0.0:
        raise AssertionError(f"{label}: no kernel in the trace matched K1's group")


def device_ms_by_group(prof, groups, ranges=()):
    """Device time per kernel name (device events only: an op's row repeats
    its kernels' time), grouped by name fragments. The device-side spans of
    OPT_RANGE and of the profiler ranges ``ranges`` are ranges, not
    kernels, and are left out."""
    by_name = {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA or evt.key == OPT_RANGE
                or evt.key in ranges):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    out = {g: 0.0 for g, _ in groups}
    out["other"] = 0.0
    for key, ms in by_name.items():
        g = next((g for g, frags in groups
                  if any(f in key for f in frags)), "other")
        out[g] += ms
    return by_name, out


GEMM_FRAGMENTS = ("gemm", "sm90_", "cutlass", "xmma", "cublas", "nvjet")
TRAIN_GROUPS = (("K1 layer_norm_fwd", K1_FRAGMENTS),
                ("K3 layer_norm_bwd", ("ln_bwd",)),
                ("K2 flash_fwd", ("flash_fwd_",)),
                ("K4 flash_bwd", ("flash_bwd_",)),
                ("K5 unscale", ("_scale_flag",)),
                ("K6 adam", ("_adam",)),
                ("K11 softmax_fwd", ("_softmax_fwd",)),
                ("K12 softmax_bwd", ("_softmax_bwd",)),
                ("K13 dropout_mask", ("dropout_mask_kernel",)),
                ("K14 xent_fwd", ("_xent_fwd",)),
                ("K15 xent_bwd", ("_xent_bwd",)),
                ("gemm", GEMM_FRAGMENTS))
# LAMB's per-tensor norms of p and u are plain torch.dot calls (cuBLAS dot
# and its reduction), listed before the GEMM fragments they share "cublas"
# with
BERT_GROUPS = (("K1 layer_norm_fwd", K1_FRAGMENTS),
               ("K3 layer_norm_bwd", ("ln_bwd",)),
               ("K2 flash_fwd", ("flash_fwd_",)),
               ("K4 flash_bwd", ("flash_bwd_",)),
               ("K5 unscale", ("_scale_flag",)),
               ("K9 l2norm", ("_sumsq",)),
               ("K7 lamb_stage1", ("_lamb1",)),
               ("K8 scaled_update", ("_scaled_update",)),
               ("K11 softmax_fwd", ("_softmax_fwd",)),
               ("K12 softmax_bwd", ("_softmax_bwd",)),
               ("K13 dropout_mask", ("dropout_mask_kernel",)),
               ("K14 xent_fwd", ("_xent_fwd",)),
               ("K15 xent_bwd", ("_xent_bwd",)),
               ("per-tensor norms", ("dot_kernel", "reduce_1Block")),
               ("gemm", GEMM_FRAGMENTS))


# the library cross entropy's ops (``gpt._cross_entropy``, ``pretrain_loss``):
# their device time with their children's, the backward nodes' with the
# engine's sum of the two logits gradients that it runs inside them
LOSS_OPS = ("aten::logsumexp", "aten::gather",
            "autograd::engine::evaluate_function: LogsumexpBackward0",
            "autograd::engine::evaluate_function: GatherBackward0")


def loss_ops_ms(prof):
    """Device ms of the outermost LOSS_OPS events of a profile."""
    total = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or evt.name not in LOSS_OPS:
            continue
        parent = evt.cpu_parent
        while parent is not None and parent.name not in LOSS_OPS:
            parent = parent.cpu_parent
        if parent is None:
            total += evt.device_time_total / 1e3
    return total


def range_kernels_ms(prof, name, fragments=None, nested=()):
    """Device ms of the kernels that run inside the device-side spans of the
    profiler range ``name`` (the span of the kernels launched inside it);
    with ``fragments``, of those whose name holds one of them. ``nested``
    names the ranges opened inside it, whose own device-side spans are not
    kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.name == name]
    return sum(e.time_range.elapsed_us() for e in events
               if e.name != name and e.name not in nested
               and (fragments is None or any(f in e.name for f in fragments))
               and any(a <= e.time_range.start < b for a, b in spans)) / 1e3


def train_profile(label, step, batch, groups, ranges=None):
    """PROFILE_STEPS more steps under torch.profiler: device time by layer
    (per step), the library cross entropy's device time (LOSS_OPS; the
    fused one is K14 + K15 in the layers), the optimizer step's where it
    runs in the OPT_RANGE range (``wrap_optimizer``) and the device's idle
    share over the window. ``ranges``, a context manager factory, opens
    profiler ranges around parts of the step while it profiles and returns
    their names: each range's kernels' device ms, and of them the GEMMs',
    are reported too."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with (ranges() if ranges else contextlib.nullcontext(())) as names, \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, by_group = device_ms_by_group(prof, groups, names)
    busy = sum(by_name.values())
    if busy == 0:
        line(label, device_time="not measured (no CUDA events in the trace)")
        return
    require_k1(label, by_group)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    per = 1.0 / PROFILE_STEPS
    opt_ms = range_kernels_ms(prof, OPT_RANGE)
    in_ranges = {name: {"all": range_kernels_ms(prof, name) * per,
                        "gemm": range_kernels_ms(prof, name, GEMM_FRAGMENTS) * per}
                 for name in names}
    print(f"{label}: " + json.dumps({
        "steps": PROFILE_STEPS, "wall_ms_per_step": wall_ms * per,
        "device_busy_ms_per_step": busy * per, "idle_share": 1.0 - busy / wall_ms,
        "by_layer_ms_per_step": {k: v * per for k, v in by_group.items()},
        "loss_ops_ms_per_step": loss_ops_ms(prof) * per,
        **({"optimizer_ms_per_step": opt_ms * per} if opt_ms else {}),
        **({"ranges_ms_per_step": in_ranges} if in_ranges else {}),
        "top_kernels_ms_per_step": {k[:90]: v * per for k, v in top}}),
        flush=True)


def bert_batch(bert, cfg, batch, seed, lens=None):
    """A synthetic MLM batch on the card plus its sequence lengths (None:
    every sequence full, as ``make_bert_rung`` trains)."""
    tok, tgt, mask, nsp = bert.synthetic_batch(cfg, batch, generator=gen(seed),
                                               device="cuda")
    if lens is not None:
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return tok, tgt, mask, nsp, lens


# ---------------------------------------------------------------- ResNet


def resnet_batch(cfg, batch, seed):
    """Seeded uint8 NHWC images and labels on the card, as the trainer
    takes them."""
    g = gen(seed)
    images = torch.randint(0, 256, (batch, RESNET_IMAGE, RESNET_IMAGE, 3),
                           generator=g, device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=g,
                           device="cuda")
    return images, labels


def resnet_trainer(main_amp, cfg, weights, opt_level, batch, **kw):
    """``examples/imagenet`` ``build_trainer`` for ``cfg`` from the given
    ``(params, bn_state)``, as ``bench.py`` ``make_resnet_rung`` builds it."""
    params, bn_state = weights
    return main_amp.build_trainer(cfg=cfg, opt_level=opt_level,
                                  global_batch=batch, params=params,
                                  bn_state=bn_state, **kw)


def resnet_state(tr):
    """Copies of the state a step may change, as flat lists: the model's
    arenas (arena-native) or leaves (the list path), the masters, every
    optimizer state tensor but the step counts, and the step counts (one
    per arena, or one)."""
    return snapshot(tr, {"opt": tr.opt_state})


def resnet_step_parity_phase(main_amp, fused_sgd, tree_flatten, cfg, weights,
                             level="O5"):
    """One full-width O5 (or ``level``: O2, with cuDNN held to its
    deterministic algorithms and a static loss scale of 2^10, so that the
    step compared is not one the dynamic scale skips) step at batch 2 on
    K5 and K10 against the same step
    with both on their plain versions, from the same weights and batch. The
    convolutions (cuDNN) and BatchNorm (plain torch) are the same on both
    paths; cuDNN's weight gradients may sum in another order from run to
    run, so the gradients are held to a relative L2 bound and the masters
    and momentum to what those gradient differences move: one SGD step from
    the same masters moves the masters by lr·g and seeds the momentum with
    g + decay·p."""
    images, labels = resnet_batch(cfg, PARITY_BATCH, 64)
    label = "resnet_step_parity" if level == "O5" else f"resnet_{level.lower()}_step_parity"
    kw = {} if level == "O5" else dict(loss_scale=2.0 ** 10)
    torch.backends.cudnn.deterministic = level != "O5"
    res = {}
    for impl in (None, "torch"):
        grads = []

        class RecordingSGD(fused_sgd):
            """FusedSGD that keeps a copy of each gradient arena it is given."""

            def step_flat(self, flat_params, flat_grads, state, **kw):
                grads.append(flat_grads.clone())
                return super().step_flat(flat_params, flat_grads, state, **kw)

        opt = RecordingSGD(RESNET_LR, 0.9, weight_decay=RESNET_WD, impl=impl)
        tr = resnet_trainer(main_amp, cfg, weights, level, PARITY_BATCH,
                            fused_optimizer=opt, impl=impl, **kw)
        met = tr.step(images, labels, RESNET_LR)
        torch.cuda.synchronize()
        if bool(met["found_inf"]):
            raise AssertionError(f"{label} ({impl}): found_inf set")
        model, masters, moms, steps = resnet_state(tr)
        for arena, master in zip(model, masters):
            if not torch.equal(arena, master.to(arena.dtype)):
                raise AssertionError(
                    f"{label} ({impl}): model arena != masters.to(dtype)")
        if steps != [1, 1]:
            raise AssertionError(f"{label} ({impl}): step counts {steps}")
        res[impl] = (met["loss"].item(), grads, masters, moms,
                     [t.clone() for t in tree_flatten(tr.bn_state)[0]])
        del tr, opt
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (lk, gk, mk, bk, sk), (lp, gp, mp, bp, sp) = res[None], res["torch"]
    loss_err = abs(lk - lp) / abs(lp)
    if not (np.isfinite(lk) and loss_err < 1e-5):
        raise AssertionError(f"{label}: loss {lk} vs plain {lp}")
    grad_rel = [float((a - b).norm() / b.norm()) for a, b in zip(gk, gp)]
    if max(grad_rel) > 0.05:
        raise AssertionError(f"{label}: grad arenas differ, rel L2 {grad_rel}")
    worst = {}
    for name, got, ref, coef in (("master", mk, mp, RESNET_LR), ("momentum", bk, bp, 1.0)):
        for a, b, ga, gb in zip(got, ref, gk, gp):
            dg = max_err(ga, gb)
            # what the gradients' difference moves, plus an ulp of the value
            tol = coef * dg + 2 ** -22 * float(b.abs().max())
            err = max_err(a, b)
            if err > tol:
                raise AssertionError(f"{label}: {name} differs by "
                                     f"{err} > {tol} (grads differ by {dg})")
            worst[name] = max(worst.get(name, 0.0), err)
    bn_err = max(check_close(f"{label} BN state", a, b,
                             dict(rtol=1e-5, atol=1e-6)) for a, b in zip(sk, sp))
    line(label, batch=PARITY_BATCH, image=RESNET_IMAGE, opt_level=level, loss=lk,
         plain_loss=lp, loss_rel_err=loss_err, grad_rel_l2=max(grad_rel),
         grad_max_abs_err=max(max_err(a, b) for a, b in zip(gk, gp)),
         master_max_abs_err=worst["master"],
         momentum_max_abs_err=worst["momentum"], bn_state_max_abs_err=bn_err,
         model_arena_is_master_cast="bitwise")


def resnet_skip_phase(main_amp, cfg, weights, level="O5"):
    """An O5 step whose loss is weighted by inf (the trainer's static loss
    scale set to inf: bf16 gradients cannot overflow from a finite scale
    here, as the GPT skip step explains): model arenas, masters, momentum
    and step counts stay bitwise unchanged. At O2 the dynamic scale starts
    at 2^24 instead (JAX's test_dynamic_scaler_skips_do_not_poison_params):
    the fp16 gradients overflow, the state stays bitwise the same and the
    scale halves."""
    if level == "O5":
        tr = resnet_trainer(main_amp, cfg, weights, "O5", PARITY_BATCH,
                            loss_scale=float("inf"))
        label = "resnet_skip_step"
    else:
        tr = resnet_trainer(main_amp, cfg, weights, level, PARITY_BATCH,
                            loss_scale="dynamic")
        tr.scaler_state["scale"].fill_(2.0 ** 24)
        label = f"resnet_{level.lower()}_skip_step"
    scale0 = tr.scaler_state["scale"].item()
    before = resnet_state(tr)
    met = tr.step(*resnet_batch(cfg, PARITY_BATCH, 65), RESNET_LR)
    torch.cuda.synchronize()
    after = resnet_state(tr)
    if not bool(met["found_inf"]):
        raise AssertionError(f"{label}: found_inf not set")
    same = all(torch.equal(a, b) for xs, ys in zip(before[:3], after[:3])
               for a, b in zip(xs, ys))
    if not same or after[3] != [0, 0]:
        raise AssertionError(f"{label}: the state changed (steps {after[3]})")
    scale1 = tr.scaler_state["scale"].item()
    if level != "O5" and scale1 != scale0 / 2:
        raise AssertionError(f"{label}: scale {scale0} -> {scale1}")
    line(label, found_inf=True, state="bitwise unchanged",
         step_count=after[3][0], scale_before=scale0, scale_after=scale1)
    del tr
    torch.cuda.empty_cache()


def resnet_flops_per_image(resnet, cfg, weights):
    """Training FLOPs of one image from the convolutions' and ``fc``'s
    shapes: PyTorch's FLOP counter over a one-image forward (2 per
    multiply-add, BatchNorm and pooling not counted), times 3 for the
    forward and the backward."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(1, RESNET_IMAGE, RESNET_IMAGE, 3, device="cuda")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        resnet.forward(*weights, x, cfg, training=False)
    return 3 * counter.get_total_flops()


# convolutions are cuDNN's (implicit-GEMM kernels) and fc cuBLAS's; torch's
# casts and the conv weights' permutes run copy kernels; BatchNorm, ReLU,
# the residual adds and the loss run torch's elementwise and reduction
# kernels
RESNET_GROUPS = (("NCCL collectives", ("nccl",)),
                 ("K10 sgd", ("_sgd",)),
                 ("K5 unscale", ("_scale_flag",)),
                 ("K16 axpby", ("_axpby_flag",)),
                 ("K17 adagrad", ("_adagrad",)),
                 ("K18 novograd", ("_novograd",)),
                 ("per-tensor norms", ("dot_kernel", "reduce_1Block")),
                 ("copies and casts", ("copy",)),
                 ("convs and fc", ("conv", "cudnn", "implicit", "fprop", "dgrad",
                                   "wgrad", "nhwc", *GEMM_FRAGMENTS)),
                 ("elementwise and reductions (BN, ReLU, residual, loss)",
                  ("elementwise", "reduce")))
# the profiler range around a ResNet trainer's optimizer step (wrap_optimizer)
OPT_RANGE = "optimizer_step"


def wrap_optimizer(tr, grads=None):
    """Wrap the trainer's optimizer step (an attribute set on its instance,
    which the train step looks up on each call) in the OPT_RANGE profiler
    range; with a list ``grads``, append copies of the gradients each step
    is given."""
    from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten

    opt = tr.amp_model.optimizer
    inner = opt.step

    def step(params, g, state, **kw):
        if grads is not None:
            leaves = g.arenas if isinstance(g, PackedParams) else tree_flatten(g)[0]
            grads.append([t.clone() for t in leaves])
        with torch.profiler.record_function(OPT_RANGE):
            return inner(params, g, state, **kw)

    opt.step = step


def trainer_step(tr):
    """``step(images, labels) -> (loss, None, found_inf)``: the trainer's own
    train step at RESNET_LR."""
    def step(images, labels):
        met = tr.step(images, labels, RESNET_LR)
        return met["loss"], None, met["found_inf"]

    return step


def resnet_training_phase(label, profile_label, tr, step, counters, expect,
                          flops_per_image, peak, n_params, card, **fields):
    """The trainer ``tr`` at batch 128 on one fixed batch, driven by
    ``step`` (``training_phase``), its optimizer step in the OPT_RANGE
    profiler range."""
    wrap_optimizer(tr)
    return training_phase(
        label, profile_label, step, resnet_batch(tr.cfg, RESNET_BATCH, 72),
        counters, expect, RESNET_GROUPS, card, unit="images",
        units=RESNET_BATCH, flops=RESNET_BATCH * flops_per_image, peak=peak,
        image=RESNET_IMAGE, params=n_params,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, **fields)


# ------------------------------------------------- ResNet-50, slice 8 paths


def resnet_paths(opt):
    """The five paths of slice 8, all O5: label -> (the trainer's options
    for an ``impl``, micro-batches a step). ``opt`` is the port's
    ``optimizers``. The optimizers' other hyperparameters are the JAX
    defaults; lr is what the step passes (RESNET_LR)."""
    return {
        # the arena-native FusedSGD trainer, accumulating two micro-batches
        "resnet_o5_accum": (lambda impl: {}, 2),
        "resnet_o5_adagrad": (lambda impl: dict(fused_optimizer=opt.FusedAdagrad(
            weight_decay=RESNET_WD, impl=impl)), 1),
        "resnet_o5_novograd": (lambda impl: dict(fused_optimizer=opt.FusedNovoGrad(
            weight_decay=RESNET_WD, impl=impl)), 1),
        "resnet_o5_lars": (lambda impl: dict(fused_optimizer=opt.FusedLARS(
            RESNET_LR, momentum=0.9, weight_decay=RESNET_WD,
            trust_coefficient=0.001, impl=impl)), 1),
        # LARC(FusedSGD), as the JAX trainer builds it; LARC refuses an
        # inner decay, so it runs only at weight_decay 0
        "resnet_o5_larc": (lambda impl: dict(use_larc=True, weight_decay=0.0), 1),
    }


def accum_step(amp, main_amp, mt, tr, impl=None):
    """The O5 arena-native FusedSGD step over two micro-batches, as a user
    script accumulates gradients when a batch does not fit: the scaled
    forward and backward of each half (K5 unscales each), then per gradient
    arena Apex's ``unscale_with_stashed`` form ``multi_tensor_axpby([g2],
    [g1], 0.5, 0.5, arg_to_check=0)`` (K16: the mean of the two halves'
    gradients, the new ones checked), its flag ORed with both unscale flags
    into ``found_inf``, then one K10 pass per arena. BN's running stats
    advance once a micro-batch. Returns ``step(images, labels) -> (loss,
    None, found_inf)``, the loss the mean of the two halves'."""
    m = tr.amp_model
    mean = torch.from_numpy(main_amp._MEAN).to(tr.device)
    std = torch.from_numpy(main_amp._STD).to(tr.device)

    def loss_fn(p, images, labels, bn):
        logits, new_bn = m.apply(p, bn, (images.float() - mean) / std)
        return main_amp.softmax_cross_entropy(logits, labels), new_bn

    svag = amp.scaled_value_and_grad(loss_fn, m.scaler, has_aux=True, impl=impl)

    def step(images, labels):
        losses, grads, found = [], [], None
        for x, y in zip(images.chunk(2), labels.chunk(2)):
            loss, tr.bn_state, g, fi, tr.scaler_state = svag(
                tr.params, tr.scaler_state, x, y, tr.bn_state)
            losses.append(loss)
            grads.append(g)
            found = fi if found is None else found | fi
        acc = []
        for g2, g1 in zip(grads[1].arenas, grads[0].arenas):
            (out,), flag = mt.multi_tensor_axpby([g2], [g1], 0.5, 0.5,
                                                 arg_to_check=0, impl=impl)
            acc.append(out)
            found = found | flag
        tr.params, tr.opt_state = m.optimizer.step(
            tr.params, grads[0].replace_arenas(acc), tr.opt_state,
            found_inf=found, lr=RESNET_LR)
        return (losses[0] + losses[1]) / 2, None, found

    return step


def resnet_path(paths, label, amp, main_amp, mt, cfg, weights, batch,
                impl=None, **kw):
    """Path ``label``'s trainer at ``batch`` images a step (from the shared
    weights) and its ``step``."""
    options, micro = paths[label]
    tr = resnet_trainer(main_amp, cfg, weights, "O5", batch, impl=impl,
                        **options(impl), **kw)
    step = accum_step(amp, main_amp, mt, tr, impl) if micro == 2 else trainer_step(tr)
    return tr, step


def resnet_path_parity_phase(label, make, micro, cfg):
    """One full-width step of a path at batch 2 (two micro-batches of 2 when
    it accumulates) on the kernels against the same step on the plain path,
    from the same weights and batch. cuDNN is held to its deterministic
    algorithms here, so the two paths' convolutions give the same bits: the
    loss, the gradients the optimizer is given, and the BN state must agree
    bitwise, and the masters and optimizer state within one ulp of the
    optimizer's arithmetic (relative 1e-6, and 1e-6 of each tensor's
    largest value where terms cancel); the model is the masters' cast."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    images, labels = resnet_batch(cfg, PARITY_BATCH * micro, 66)
    torch.backends.cudnn.deterministic = True
    res = {}
    for impl in (None, "torch"):
        tr, step = make(PARITY_BATCH * micro, impl)
        grads = []
        wrap_optimizer(tr, grads)
        loss, _, fi = step(images, labels)
        torch.cuda.synchronize()
        if bool(fi):
            raise AssertionError(f"{label}_step_parity ({impl}): found_inf set")
        model, masters, state, steps = resnet_state(tr)
        for arena, master in zip(model, masters):
            if not torch.equal(arena, master.to(arena.dtype)):
                raise AssertionError(f"{label}_step_parity ({impl}): the model "
                                     "is not the masters' cast")
        if steps != [1] * len(steps):
            raise AssertionError(f"{label}_step_parity ({impl}): step counts {steps}")
        res[impl] = (loss.item(), grads[0], masters, state,
                     [t.clone() for t in tree_flatten(tr.bn_state)[0]])
        del tr, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (lk, gk, mk, sk, bk), (lp, gp, mp, sp, bp) = res[None], res["torch"]
    same = (lk == lp and all(torch.equal(a, b) for a, b in zip(gk, gp))
            and all(torch.equal(a, b) for a, b in zip(bk, bp)))
    if not same:
        raise AssertionError(f"{label}_step_parity: loss, gradients or BN state "
                             f"differ (loss {lk} vs {lp})")
    worst = {}
    for name, got, ref in (("master", mk, mp), ("state", sk, sp)):
        worst[name] = max(check_close(f"{label}_step_parity {name}", a, b,
                                      dict(rtol=1e-6, atol=1e-6 * float(b.abs().max())))
                          for a, b in zip(got, ref))
    line(f"{label}_step_parity", batch=PARITY_BATCH * micro, micro_batches=micro,
         image=RESNET_IMAGE, loss=lk, plain_loss=lp, grads="bitwise",
         bn_state="bitwise", master_max_abs_err=worst["master"],
         state_max_abs_err=worst["state"], model_is_master_cast="bitwise")


def resnet_path_skip_phase(label, make, micro, cfg):
    """A step whose loss is weighted by inf (a static loss scale of inf):
    the model, masters, optimizer state and step counts stay bitwise
    unchanged."""
    tr, step = make(PARITY_BATCH * micro, None, loss_scale=float("inf"))
    before = resnet_state(tr)
    _, _, fi = step(*resnet_batch(cfg, PARITY_BATCH * micro, 67))
    torch.cuda.synchronize()
    after = resnet_state(tr)
    if not bool(fi):
        raise AssertionError(f"{label}_skip_step: found_inf not set")
    same = all(torch.equal(a, b) for xs, ys in zip(before[:3], after[:3])
               for a, b in zip(xs, ys))
    if not same or any(after[3]):
        raise AssertionError(f"{label}_skip_step: the state changed (steps {after[3]})")
    line(f"{label}_skip_step", found_inf=True, state="bitwise unchanged",
         step_count=after[3][0])
    del tr, step
    torch.cuda.empty_cache()


# ------------------------------------- slice 11: data-parallel ResNet-50 O5

# the reference's DDP defaults: SyncBN over the data axis, and gradient
# buckets of parallel.bucketing.DEFAULT_BUCKET_BYTES (4 MiB)
DDP_BUCKET_BYTES = 4 << 20
DDP_KW = dict(distributed=True, sync_bn=True, bucket_bytes=DDP_BUCKET_BYTES)
# the two-rank check: two processes on the one card, gloo on CUDA tensors,
# TWO_RANK_BATCH images each, held against one rank at twice that
TWO_RANK_BATCH = 2
TWO_RANK_TIMEOUT = 600
# (run, opt level, extra trainer options); O5 is the slice's path, O0 holds
# the ranks to fp32 rounding (see ddp_world1_parity_phase)
TWO_RANK_RUNS = (("o5_bucketed", "O5", {}),
                 ("o5_overlap", "O5", dict(overlap_backward=True)),
                 ("o0_bucketed", "O0", {}))
# PERF.md's full-width ResNet-50 row: loss relative error, gradients'
# relative L2; masters, momentum and BN state as ratios to their bounds
ROW_BOUNDS = dict(loss_rel_err=1e-5, grad_rel_l2=0.05, masters_err_over_tol=1.0,
                  moms_err_over_tol=1.0, bn_err_over_tol=1.0)
# fp32 (O0): the one-pass moments of the one-device step and SyncBN's
# two-pass ones part by fp32 rounding that 53 layers accumulate, a few times
# the row's BN-state bound (PERF.md's tolerance table has the reading): the
# BN state is held at rtol 1e-4, atol 1e-5, 10 times the row's
O0_BOUNDS = dict(ROW_BOUNDS, bn_err_over_tol=10.0)
# bf16 (O5): the same rounding moves bf16 activations across their rounding
# boundaries layer after layer, so two correct computations of one step
# part far beyond the row (PERF.md). An O5 run is held to the row or to
# SPREAD_FACTOR times the spread measured in the same run between the
# one-device step and the world-1 SyncBN step, whichever is larger
SPREAD_FACTOR = 4.0


def init_nccl(store_dir):
    """A one-rank NCCL world through a FileStore in ``store_dir`` (no TCP
    port). A failed init raises, and so fails the run."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{store_dir}/nccl_store",
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    return dist.get_backend()


def one_step(main_amp, cfg, weights, images, labels, level="O5", impl=None, **kw):
    """One ImageNet trainer step (``build_trainer(**kw)`` at the batch's
    size, this rank's slice of it): the loss, copies of the gradients the
    optimizer was given (arenas at O5, leaves at O0), the model, the fp32
    masters (at O0 the params themselves), the momentum and the BN state
    after it."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    tr = resnet_trainer(main_amp, cfg, weights, level, len(labels), impl=impl, **kw)
    grads = []
    wrap_optimizer(tr, grads)
    met = tr.step(*tr.shard_batch(images, labels), RESNET_LR)
    if level == "O5":
        model, masters, moms, steps = resnet_state(tr)
    else:
        model = [t.clone() for t in tree_flatten(tr.params)[0]]
        masters = model
        moms = [t.clone() for t in tree_flatten(tr.opt_state["momentum_buffer"])[0]]
        steps = [int(tr.opt_state["step"])]
    out = dict(loss=met["loss"].item(), found_inf=bool(met["found_inf"]),
               grads=grads[0], model=model, masters=masters, moms=moms,
               bn=[t.clone() for t in tree_flatten(tr.bn_state)[0]], steps=steps)
    del tr
    torch.cuda.empty_cache()
    if out["found_inf"] or set(steps) != {1}:
        raise AssertionError(f"one_step {level} {kw}: found_inf {out['found_inf']}, "
                             f"steps {steps}")
    return out


def host_copy(res):
    """A ``one_step`` result with its tensors on the host."""
    return {k: ([t.cpu() if isinstance(t, torch.Tensor) else t for t in v]
                if isinstance(v, list) else v) for k, v in res.items()}


def resnet_row_errors(got, ref):
    """``got`` against ``ref`` in PERF.md's full-width ResNet-50 row's
    terms (ROW_BOUNDS): loss relative error, the gradients' worst relative
    L2, the masters' and momentum's worst error over what the gradients'
    difference moves (one SGD step moves a master by lr g and seeds the
    momentum with g + decay p; plus an ulp of the value), the BN state's
    worst error over rtol 1e-5, atol 1e-6."""
    out = dict(loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
               grad_rel_l2=max(float((a - b).norm() / b.norm())
                               for a, b in zip(got["grads"], ref["grads"])))
    for name, coef in (("masters", RESNET_LR), ("moms", 1.0)):
        worst = 0.0
        for a, b, ga, gb in zip(got[name], ref[name], got["grads"], ref["grads"]):
            tol = coef * max_err(ga, gb) + 2 ** -22 * float(b.abs().max())
            worst = max(worst, max_err(a, b) / tol)
        out[f"{name}_err_over_tol"] = worst
    out["bn_err_over_tol"] = max(
        float(((a - b).abs() / (1e-6 + 1e-5 * b.abs())).max())
        for a, b in zip(got["bn"], ref["bn"]))
    return out


def out_of_bounds(errs, bounds):
    return {k: v for k, v in errs.items() if not v <= bounds[k]}


def bitwise_equal(a, b):
    return (a["loss"] == b["loss"] and all(
        all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
        for k in ("grads", "model", "masters", "moms", "bn")))


def expected_step_ledger(weights, metrics=True):
    """The collectives of one world-1 step with SyncBN, by site: the
    gradient arenas (padded) at ``ddp.*``; per BatchNorm of C channels, the
    sums with the count (4 C + 4 bytes) and the centred squares (4 C) in the
    forward, (sum_dy, sum_dy_xmu) (8 C) in the backward; the trainer's
    metrics (16 bytes), unless ``metrics`` is off."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    means = tree_flatten(weights[1])[0][0::2]  # running_mean, running_var pairs
    chans = sum(t.numel() for t in means)
    specs = o5_specs(weights[0])
    want = {"arena_bytes": sum(s.padded_total * torch.finfo(dt).bits // 8
                               for dt, s in specs.items()),
            "sync_bn.stats": (2 * len(means), 8 * chans + 4 * len(means)),
            "sync_bn.backward": (len(means), 8 * chans)}
    if metrics:
        want["trainer.metrics"] = (1, 16)
    return want


def check_step_ledger(label, records, weights, metrics=True):
    """One bucketed step's ledger against :func:`expected_step_ledger`;
    returns the collectives and bytes a step."""
    want = expected_step_ledger(weights, metrics)
    sites = {}
    for r in records:
        calls, nbytes = sites.get(r["site"], (0, 0))
        sites[r["site"]] = (calls + r["calls"], nbytes + r["bytes"])
    grad = sites.pop("ddp.bucketed_reduce", None) or sites.pop("ddp.overlap_hook:ddp",
                                                               (0, 0))
    if grad[1] != want.pop("arena_bytes") or sites != want:
        raise AssertionError(f"{label}: the ledger {records} is not one step's "
                             f"collectives {want}")
    every = (grad, *sites.values())
    return sum(c for c, _ in every), sum(b for _, b in every)


def ddp_world1_parity_phase(main_amp, bucketing, comms, cfg, weights):
    """NCCL at world 1, full-width ResNet-50 at batch 2, cuDNN
    deterministic. O5 with unsynchronized BN: the distributed step (one
    collective a gradient arena, 4 MiB buckets, the backward-time hooks) is
    the one-device step bitwise (an all-reduce over one rank and a division
    by 1 are exact). O5 with SyncBN: the step on K5/K10 against the same
    step on their plain versions at PERF.md's row, and its ledger; its
    distance from the one-device step (two-pass against one-pass moments)
    is the O5 rounding spread the two-rank check scales. O0 with SyncBN
    against the one-device O0 step at O0_BOUNDS. Compressed, every gradient
    element within ``compression_error_bound`` of the uncompressed one.
    Returns the O5 spread."""
    images, labels = resnet_batch(cfg, PARITY_BATCH, 80)
    step = lambda **kw: one_step(main_amp, cfg, weights, images, labels, **kw)  # noqa: E731
    torch.backends.cudnn.deterministic = True
    try:
        ref = step(distributed=False)
        exact = {}
        for name, kw in (("unbucketed", {}),
                         ("bucketed", dict(bucket_bytes=DDP_BUCKET_BYTES)),
                         ("overlap", dict(bucket_bytes=DDP_BUCKET_BYTES,
                                          overlap_backward=True))):
            exact[name] = bitwise_equal(step(distributed=True, **kw), ref)
        comp = step(distributed=True, compress=True, bucket_bytes=DDP_BUCKET_BYTES)
        comp_worst = max(float(((a - b).abs() / bucketing.compression_error_bound(
            b.abs()).clamp_min(1e-30)).max()) for a, b in zip(comp["grads"], ref["grads"]))
        comms.reset_comms_ledger()
        sync_k = step(**DDP_KW)
        records = comms.comms_records()
        sync_p = step(impl="torch", **DDP_KW)
        o0 = resnet_row_errors(step(level="O0", **DDP_KW),
                               step(level="O0", distributed=False))
    finally:
        torch.backends.cudnn.deterministic = False
    kernels = resnet_row_errors(sync_k, sync_p)
    spread = resnet_row_errors(sync_k, ref)
    calls, nbytes = check_step_ledger("ddp_world1_parity", records, weights)
    line("ddp_world1_parity", backend="nccl", world=1, batch=PARITY_BATCH,
         image=RESNET_IMAGE, **{f"bitwise_{k}": v for k, v in exact.items()},
         compressed_err_over_bound=comp_worst,
         o5_syncbn_kernels_vs_plain=json.dumps(kernels),
         o5_syncbn_vs_one_device_spread=json.dumps(spread),
         o0_syncbn_vs_one_device=json.dumps(o0), collectives_per_step=calls,
         collective_bytes_per_step=nbytes)
    if not all(exact.values()):
        raise AssertionError(f"ddp_world1_parity: not bitwise the one-device step: {exact}")
    if comp_worst > 1.0:
        raise AssertionError(f"ddp_world1_parity: compressed grads off the bound "
                             f"({comp_worst} of it)")
    for name, errs, bounds in (("O5 kernels vs plain", kernels, ROW_BOUNDS),
                               ("O0 SyncBN vs one device", o0, O0_BOUNDS)):
        if out_of_bounds(errs, bounds):
            raise AssertionError(f"ddp_world1_parity {name}: {out_of_bounds(errs, bounds)}")
    return spread


def two_rank_worker(rank, store, out_dir, batch_seed, cfg):
    """One rank of the two-rank check (a spawned process): gloo on CUDA
    tensors, the SyncBN trainer with 4 MiB buckets on ``cfg`` from the
    parent's seeded weights, each run of TWO_RANK_RUNS one step on this
    rank's half of the global batch, cuDNN deterministic."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        from beforeholiday_tpu_torch.examples.imagenet import main_amp
        from beforeholiday_tpu_torch.models import resnet

        weights = resnet.init(cfg, gen(2), device="cuda")
        images, labels = resnet_batch(cfg, 2 * TWO_RANK_BATCH, batch_seed)
        out = {name: host_copy(one_step(main_amp, cfg, weights, images, labels,
                                        level=level, **DDP_KW, **kw))
               for name, level, kw in TWO_RANK_RUNS}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def ddp_two_rank_card_phase(main_amp, cfg, weights, tmp, spread):
    """Two processes on the one card, gloo on CUDA tensors (NCCL refuses two
    ranks on one device), SyncBN and 4 MiB buckets, uncompressed, batch
    2 x TWO_RANK_BATCH, cuDNN deterministic. The ranks against each other
    (bitwise: reduced gradients, replicated state), and each run against a
    one-rank NCCL world at the whole batch: O0 at O0_BOUNDS, O5 (after the
    gradients, and with the backward-time hooks, where a bucket read before
    its all-reduce finished would show) at the row or SPREAD_FACTOR times
    the O5 ``spread`` of ddp_world1_parity_phase."""
    import multiprocessing as mp

    seed = 81
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=two_rank_worker,
                         args=(r, f"{tmp}/gloo_store", tmp, seed, cfg))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, TWO_RANK_TIMEOUT - (time.perf_counter() - t0)))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join(10)
        raise AssertionError(f"ddp_two_rank_card: the world did not finish in "
                             f"{TWO_RANK_TIMEOUT} s; its processes were killed")
    if any(p.exitcode != 0 for p in procs):
        errors = [open(f"{tmp}/rank{r}.err").read() for r in range(2)
                  if os.path.exists(f"{tmp}/rank{r}.err")]
        raise AssertionError(f"ddp_two_rank_card: exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    images, labels = resnet_batch(cfg, 2 * TWO_RANK_BATCH, seed)
    torch.backends.cudnn.deterministic = True
    try:
        refs = {level: host_copy(one_step(main_amp, cfg, weights, images, labels,
                                          level=level, **DDP_KW))
                for level in ("O5", "O0")}
    finally:
        torch.backends.cudnn.deterministic = False
    o5_bounds = {k: max(v, SPREAD_FACTOR * spread[k]) for k, v in ROW_BOUNDS.items()}
    fields, failures = {}, []
    for name, level, _ in TWO_RANK_RUNS:
        a, b = ranks[0][name], ranks[1][name]
        same = all(torch.equal(x, y) for k in ("grads", "model", "masters", "moms", "bn")
                   for x, y in zip(a[k], b[k]))
        errs = resnet_row_errors(a, refs[level])
        bad = out_of_bounds(errs, O0_BOUNDS if level == "O0" else o5_bounds)
        fields[name] = dict(ranks_bitwise=same, loss=a["loss"],
                            one_rank_loss=refs[level]["loss"], **errs)
        if not same or bad:
            failures.append(f"{name}: ranks bitwise {same}, out of bounds {bad}")
    line("ddp_two_rank_card", backend="gloo", world=2, device="'one card'",
         batch_per_rank=TWO_RANK_BATCH, bucket_bytes=DDP_BUCKET_BYTES,
         o5_bounds=json.dumps(o5_bounds), seconds=time.perf_counter() - t0,
         **{k: json.dumps(v) for k, v in fields.items()})
    if failures:
        raise AssertionError("ddp_two_rank_card: " + "; ".join(failures))


def guarded_step(main_amp, faults, tr, guard, ddp):
    """The O5 trainer's step under ``guard`` with ``ddp``'s reduction,
    driving ``tr``'s state: ``step(images, labels, weight=None,
    poison=False) -> (loss, None, skip)``. ``weight`` multiplies the loss (a
    device scalar: NaN makes it non-finite); ``poison`` NaNs one element of
    the reduced gradients (``faults.poison_grads``). The guard state is
    ``step.gstate``."""
    m = tr.amp_model
    mean = torch.from_numpy(main_amp._MEAN).to(tr.device)
    std = torch.from_numpy(main_amp._STD).to(tr.device)
    one = torch.ones((), device=tr.device)

    def loss_fn(p, x, labels, bn, weight):
        logits, new_bn = m.apply(p, bn, x)
        return main_amp.softmax_cross_entropy(logits, labels) * weight, new_bn

    def poisoned(g):
        return faults.poison_grads(ddp.reduce(g), seed=5)

    def step(images, labels, weight=None, poison=False):
        vg = guard.value_and_grad(loss_fn, has_aux=True,
                                  reduce_grads=poisoned if poison else ddp.reduce)
        loss, new_bn, grads, verdict = vg(tr.params, step.gstate,
                                          (images.float() - mean) / std, labels,
                                          tr.bn_state, one if weight is None else weight)
        tr.params, tr.opt_state, step.gstate = guard.apply_update(
            m.optimizer, tr.params, grads, tr.opt_state, step.gstate, verdict,
            lr=RESNET_LR)
        tr.bn_state = new_bn
        return loss, None, verdict["grad_overflow"] | verdict["loss_nonfinite"]

    step.gstate = guard.init(tr.params)
    return step


def ddp_guard_phase(main_amp, amp, guard_mod, faults, parallel, cfg, weights):
    """The world-1 NCCL DDP step (SyncBN, 4 MiB buckets) under
    ``StepGuard(LossScaler(init_scale=2, min_loss_scale=1), rollback_after=2,
    check_params=True)``: a clean step; a non-finite loss skips with reason
    2 (the scale 2 -> 1, its floor); a clean step; a poisoned gradient skips
    with reason 1, the model arenas, masters and momentum bitwise unchanged;
    a second one, the scale at its floor, rolls the (deliberately drifted)
    model arena back to the snapshot bitwise, reason 4; the health
    round-trips through ``AmpModel.state_dict``."""
    tr = resnet_trainer(main_amp, cfg, weights, "O5", PARITY_BATCH, **DDP_KW)
    guard = guard_mod.StepGuard(amp.LossScaler(init_scale=2.0, min_loss_scale=1.0),
                                rollback_after=2, check_params=True)
    ddp = parallel.DistributedDataParallel(bucket_bytes=DDP_BUCKET_BYTES)
    step = guarded_step(main_amp, faults, tr, guard, ddp)
    images, labels = resnet_batch(cfg, PARITY_BATCH, 82)
    nan = torch.full((), float("nan"), device="cuda")

    def health():
        return {k: int(v) for k, v in step.gstate["health"].items()}

    def unchanged(before):
        return all(torch.equal(a, b) for xs, ys in zip(before, resnet_state(tr)[:3])
                   for a, b in zip(xs, ys))

    reasons = []
    step(images, labels)
    before = resnet_state(tr)[:3]
    step(images, labels, weight=nan)
    reasons.append(health()["last_skip_reason"])
    loss_skip_unchanged = unchanged(before)
    scale_after = float(step.gstate["scaler"]["scale"])
    step(images, labels)
    snap = [a.clone() for a in tr.params.arenas]
    before = resnet_state(tr)[:3]
    step(images, labels, poison=True)
    reasons.append(health()["last_skip_reason"])
    grad_skip_unchanged = unchanged(before)
    tr.params.arenas[0].add_(1.0)  # a drift the rollback must undo
    step(images, labels, poison=True)
    reasons.append(health()["last_skip_reason"])
    rolled_back = all(torch.equal(a, b) for a, b in zip(tr.params.arenas, snap))
    h = health()
    sd = tr.amp_model.state_dict(step.gstate)
    restored = tr.amp_model.load_state_dict(sd)
    round_trip = ({k: int(v) for k, v in restored["health"].items()} == h
                  and float(restored["scaler"]["scale"]) == float(
                      step.gstate["scaler"]["scale"]))
    line("ddp_guard", backend="nccl", world=1, reasons=reasons, health=json.dumps(h),
         loss_skip_bitwise=loss_skip_unchanged, grad_skip_bitwise=grad_skip_unchanged,
         scale_after_first_skip=scale_after, rolled_back_bitwise=rolled_back,
         health_round_trip=round_trip)
    want = dict(consecutive_overflows=0, skipped_total=3, last_skip_reason=4,
                rollbacks_total=1)
    if not (reasons == [2, 1, 4] and loss_skip_unchanged and grad_skip_unchanged
            and scale_after == 1.0 and rolled_back and round_trip and h == want):
        raise AssertionError(f"ddp_guard: reasons {reasons}, health {h}")
    del tr, step
    torch.cuda.empty_cache()


def ddp_training_phases(main_amp, amp, guard_mod, faults, parallel, comms, cfg,
                        weights, counters, flops_per_image, n_params, card):
    """The batch-128 O5 step at world 1 on NCCL with SyncBN and 4 MiB
    buckets, timed as the one-device O5 step is (the first run also
    profiled): after the gradients, then with the backward-time hooks, then
    guarded (StepGuard with rollback and the parameter sentinel). Each: one step's collectives
    from the ledger first (held to what one step must issue), then
    ``resnet_training_phase`` (0 host syncs, K5 and K10 launches held).
    Returns each run's launch counts."""
    launches = {}
    for label, kw, guarded in (("ddp_resnet", {}, False),
                               ("ddp_resnet_overlap", dict(overlap_backward=True), False),
                               ("ddp_resnet_guarded", {}, True)):
        def make():
            tr = resnet_trainer(main_amp, cfg, weights, "O5", RESNET_BATCH, **DDP_KW,
                                **kw)
            if not guarded:
                return tr, trainer_step(tr)
            guard = guard_mod.StepGuard(amp.LossScaler(loss_scale=1.0),
                                        rollback_after=2, check_params=True)
            return tr, guarded_step(main_amp, faults, tr, guard,
                                    parallel.DistributedDataParallel(
                                        bucket_bytes=DDP_BUCKET_BYTES))

        # one step's collectives, on a trainer of its own (the timed one
        # starts from the weights, as the one-device step's does)
        tr, step = make()
        comms.reset_comms_ledger()
        step(*resnet_batch(cfg, RESNET_BATCH, 72))
        torch.cuda.synchronize()
        # the guarded step reduces no metrics
        calls, nbytes = check_step_ledger(label, comms.comms_records(), weights,
                                          metrics=not guarded)
        del tr, step
        tr, step = make()
        # A29's time budget: only the plain DDP run is profiled; the
        # hooks' and the guarded run keep their timed steps and checks
        launches[label] = resnet_training_phase(
            f"{label}_training", f"{label}_profile", tr, step, counters,
            STEP_LAUNCHES["ddp_resnet"], flops_per_image, PEAK_BF16, n_params,
            card, profile=label == "ddp_resnet", opt_level="O5", backend="nccl",
            world=1, sync_bn=True,
            bucket_bytes=DDP_BUCKET_BYTES,
            overlap_backward=bool(kw.get("overlap_backward")), guarded=guarded,
            collectives_per_step=calls, collective_bytes_per_step=nbytes)
        del tr, step
        torch.cuda.empty_cache()
    return launches


# (kernel key, route, source, the TPU kernel it replaces)
# ---------------------------------------------- slice 13: amp O1-O4, fp16


def fp16_pv_bound(attn, q, k, v, lens, causal, scale, ro, rate, key):
    """K2's fp16 output bound, :func:`check_dropped_pv`'s form at fp16's
    unit roundoff (8 times finer than bf16's): 2^-10 |ref| + 2^-11 sum
    p~|v| (each kept p rounded to fp16 for p.v, the output rounded once),
    plus 2^-24 |v|max for each live key, for the p that fall below 2^-14,
    where fp16 is subnormal and its step absolute (2^-24)."""
    ref_abs = attn.flash_fwd_torch(q.float(), k.float(), v.float().abs(),
                                   lens, causal, scale, rate, key)[0]
    vmax = v.float().abs().amax((1, 2))[:, None, None]
    keys = lens.float().clamp(max=k.shape[1])[:, None, None] / (1.0 - rate)
    return 2 ** -10 * ro.float().abs() + 2 ** -11 * ref_abs + 2 ** -24 * keys * vmax


def check_bound(name, got, ref, bound):
    """``|got - ref| <= bound`` everywhere; returns the worst error and the
    worst share of the bound."""
    err = (got.float() - ref.float()).abs()
    bad = err > bound
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} elements "
                             f"out of tolerance, first at {bad.nonzero()[0].tolist()}")
    live = bound > 0  # rows of length 0 are exactly 0 on both sides
    return float(err.max()), float((err[live] / bound[live]).max())


# K4's fp16 tolerance: bf16's relative form (2e-2) at fp16's unit roundoff
K4_FP16_TOL = 2.5e-3
FP16_FLASH = [  # BH, S, D, causal, rate, row name, ragged lens
    (256, 1024, 64, True, 0.0, "gpt_o2", False),       # the O2/O1 GPT's calls
    (256, 1024, 64, True, 0.1, "gpt_fp16_dropout", False),
    (2048, 128, 64, False, 0.0, "bert_fp16", True),
    (128, 512, 40, True, 0.0, "fp16_d40", False),       # the row kernels
]


def launch_source(name):
    """Where an fp16 flash row's launches come from: the GPT O2 run for its
    training shape; no main path runs the others in fp16."""
    return dict(path=name) if name == "gpt_o2" else dict(launches=0)


def k2_k4_fp16_phase(attn):
    """K2 and K4 on fp16 (amp O1/O2) against their plain versions at the GPT
    training shape with and without dropout, BERT's with ragged lengths and
    head dim 40 (the CUDA-core row kernels), each timed beside its bound
    (the bf16 rows' bytes and operations; fp16 runs at bf16's tensor-core
    rate) and the library's fp16 attention (SDPA: is_causal where every
    length is full, the boolean mask where lengths are ragged). K4 is called
    twice and held bitwise. fp16 q into K2's decode path and its paged mode
    must raise. Returns the K2 and K4 rows."""
    key = flash_key()
    rng = np.random.default_rng(13)
    fwd_rows, bwd_rows = {}, {}
    for i, (BH, S, D, causal, rate, name, ragged) in enumerate(FP16_FLASH):
        g = gen(130 + i)
        q, k, v = (torch.randn(BH, S, D, generator=g, device="cuda").half()
                   for _ in range(3))
        lens_np = rng.integers(0, S + 1, BH) if ragged else np.full(BH, S)
        if ragged:
            lens_np[:2] = (0, S)
        lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
        scale = D ** -0.5
        drop = (rate, key if rate else None)
        args = (q, k, v, lens, causal, scale, *drop)
        o, lse = attn.flash_fwd_kernel(*args)
        ro, rlse = attn.flash_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"BH{BH} Sq{S} Sk{S} D{D}{' causal' if causal else ''} float16"
               f"{' ragged lens' if ragged else ''}{f' dropout {rate}' if rate else ''}")
        if ragged and not (torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)):
            raise AssertionError(f"K2 {tag}: a lens-0 row is not exactly 0")
        err, share = check_bound(f"K2 {tag}", o, ro,
                                 fp16_pv_bound(attn, q, k, v, lens, causal, scale,
                                               ro, *drop))
        check_close(f"K2 lse {tag}", lse, rlse, dict(rtol=1e-5, atol=1e-4))
        B = BH // 16
        full = not ragged
        ql, kl, vl = (t.reshape(B, 16, S, D) for t in (q, k, v))
        keep = None if full else sdpa_mask(lens, S, causal).reshape(B, 16, -1, S)
        flops, nbytes = k2_flops_bytes(q, k, lens, causal)
        int_ops = PHILOX_OPS_PER_ELEMENT * live_pairs(q, k, lens, causal) if rate else 0
        bms, by = bound_ms(nbytes, flops, torch.float16, int_ops)
        fields = dict(max_abs_err=err, bound_share=share,
                      ms=time_ms(lambda: attn.flash_fwd_kernel(*args)),
                      plain_ms=time_ms(lambda: attn.flash_fwd_torch(*args), iters=5),
                      library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                          ql, kl, vl, attn_mask=keep, is_causal=full and causal,
                          scale=scale, dropout_p=rate)),
                      bound_ms=bms, bound_by=by, **launch_source(name))
        fwd_rows[name] = (tag, fields)
        line("K2", shape=tag, **fields)

        do = torch.randn(ro.shape, generator=g, device="cuda").half()
        bargs = (q, k, v, ro, do, rlse, None, lens, causal, scale, *drop)
        got = attn.flash_bwd_kernel(*bargs)
        again = attn.flash_bwd_kernel(*bargs)
        ref = attn.flash_bwd_torch(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K4 {tag}: two calls differ")
        del again
        if ragged and not all(torch.all(t[0] == 0) for t in got):
            raise AssertionError(f"K4 {tag}: a lens-0 row is not exactly 0")
        errs = []
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K4 {gname} {tag}: non-finite")
            tol = dict(rtol=K4_FP16_TOL, atol=K4_FP16_TOL * float(b.float().abs().max()))
            errs.append(check_close(f"K4 {gname} {tag}", a, b, tol))
        flops, nbytes = k4_flops_bytes(q, k, lens, causal)
        bms, by = bound_ms(nbytes, flops, torch.float16, int_ops)
        qg, kg, vg = (t.reshape(B, 16, S, D).clone().requires_grad_(True)
                      for t in (q, k, v))
        fields = dict(max_abs_err=max(errs), repeat="bitwise",
                      ms=time_ms(lambda: attn.flash_bwd_kernel(*bargs)),
                      plain_ms=time_ms(lambda: attn.flash_bwd_torch(*bargs), iters=5),
                      library_ms=grad_ms(
                          lambda: F.scaled_dot_product_attention(
                              qg, kg, vg, attn_mask=keep, is_causal=full and causal,
                              scale=scale, dropout_p=rate),
                          (qg, kg, vg), do.reshape(B, 16, S, D)),
                      bound_ms=bms, bound_by=by, **launch_source(name))
        bwd_rows[name] = (tag, fields)
        line("K4", shape=tag, **fields)
        del q, k, v, o, ro, do, got, ref, qg, kg, vg, keep
        torch.cuda.empty_cache()
    # no fp16 decode path: the contiguous decode mode and the paged mode raise
    refused = []
    q = torch.zeros(4, 1, 64, dtype=torch.float16, device="cuda")
    for sq in (1, 15):
        qd = torch.zeros(4, sq, 64, dtype=torch.float16, device="cuda")
        lens = torch.full((4,), 8, dtype=torch.int32, device="cuda")
        try:
            attn.flash_fwd_kernel(qd, qd, qd, lens, False, 0.125)
        except ValueError as e:
            refused.append("float16" in str(e))
    pool = torch.zeros(9, 4, 64, device="cuda")
    table = torch.zeros(4, 2, dtype=torch.int32, device="cuda")
    try:
        attn._paged_decode_kernel(q, pool, pool, table, torch.full(
            (4,), 8, dtype=torch.int32, device="cuda"), 1, 0.125)
    except ValueError as e:
        refused.append("float16" in str(e))
    if refused != [True, True, True]:
        raise AssertionError(f"K2: fp16 into the decode or paged mode was not "
                             f"refused by name ({refused})")
    line("K2_fp16_decode", contiguous_sq1="refused", contiguous_sq15="refused",
         paged="refused")
    return fwd_rows, bwd_rows


def k10_half_phase(mt, spec):
    """K10 on an fp16 parameter arena with fp32 momentum (amp O3's list path
    over ResNet-50's 25.56M parameters) against its plain version: the fp32
    momentum at the fp32 rows' bound, p at that bound plus one fp16
    rounding (the two fp32 values, one of them contracted into an fma, may
    straddle a rounding boundary; the atol, 1e-6 of the largest value,
    also covers fp16's absolute step of 2^-24 below 2^-14); a skipped step
    bitwise; the padding stays 0. No single PyTorch call takes fp16 params with fp32 momentum and
    gradients, so the row has no library time."""
    n, total = spec.padded_total, spec.total
    g = gen(95)
    grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
    p = (0.02 * torch.randn(n, generator=g, device="cuda")).half()
    m = 1e-3 * torch.randn(n, generator=g, device="cuda")
    for t in (grad, p, m):
        t[total:] = 0
    tag = f"{n} resnet_o3 plain p float16"

    def hyper(skip):
        return dict(lr=RESNET_LR, weight_decay=RESNET_WD, scale=1.0,
                    first_run=torch.zeros((), dtype=torch.bool, device="cuda"),
                    found_inf=torch.full((), skip, dtype=torch.bool, device="cuda"),
                    copy_out=None, **SGD_VARIANTS["plain"])

    out = {}
    for skip in (False, True):
        for fn in (mt.sgd_kernel, mt.sgd_torch):
            pk, mk = p.clone(), m.clone()
            fn(grad, pk, mk, **hyper(skip))
            out[fn, skip] = (pk, mk)
    torch.cuda.synchronize()
    (pk, mk), (pr, mr) = out[mt.sgd_kernel, False], out[mt.sgd_torch, False]
    err = max(check_close(f"K10 m {tag}", mk, mr,
                          dict(rtol=1e-6, atol=1e-6 * float(mr.abs().max()))),
              check_close(f"K10 p {tag}", pk.float(), pr.float(),
                          dict(rtol=2 ** -10, atol=1e-6 * float(pr.float().abs().max()))))
    if not (torch.all(pk[total:] == 0) and torch.all(mk[total:] == 0)):
        raise AssertionError(f"K10 {tag}: the padding moved")
    if not all(torch.equal(a, b) for a, b in zip(out[mt.sgd_kernel, True], (p, m))):
        raise AssertionError(f"K10 {tag}: a skipped step changed state")
    # g read in fp32, p read and written in fp16, m read and written in fp32
    bms, by = bound_ms(16 * n, 8 * n, torch.float32)
    st, kw = (p.clone(), m.clone()), hyper(False)  # a step that is taken
    fields = dict(max_abs_err=err, skip="bitwise",
                  ms=time_ms(lambda: mt.sgd_kernel(grad, *st, **kw)),
                  plain_ms=time_ms(lambda: mt.sgd_torch(grad, *st, **kw), iters=5),
                  library_ms=None, bound_ms=bms, bound_by=by, path="resnet_o3")
    line("K10", shape=tag, **fields)
    return {"resnet_o3": (tag, fields)}


def launch_floor_phase():
    """The least time a kernel launch costs the card, through :func:`time_ms`
    (L2 flushed), the harness every row of the kernels line uses: an empty
    Triton kernel of one program, and an empty CUDA kernel of one warp
    launched through ``ctypes`` as K1-K4 are (``csrc/layer_norm_fwd.cu``
    ``empty_launch``). A row near its route's floor is a launch, not its
    work. Returns both, Triton's first."""
    import ctypes

    from beforeholiday_tpu_torch import _build
    from beforeholiday_tpu_torch.ops.multi_tensor import _triton

    triton = _triton()

    @triton.jit
    def _empty(x_ptr):
        pass

    x = torch.zeros(1, device="cuda")
    ms = time_ms(lambda: _empty[(1,)](x))
    line("launch_floor", kernel="'empty Triton kernel, one program'", ms=ms)
    empty = _build.load("layer_norm_fwd").empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if empty(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty CUDA kernel did not launch")

    cuda_ms = time_ms(launch)
    line("launch_floor", kernel="'empty CUDA kernel, one warp, through ctypes'",
         ms=cuda_ms)
    return ms, cuda_ms


def scale_line(label, scaler_state):
    """The loss scale at the end of a timed run, and the steps since its
    last overflow."""
    line(label, loss_scale_end=scaler_state["scale"].item(),
         unskipped=int(scaler_state["unskipped"]))


def gpt_amp_phases(amp, gpt, fused_adam, cfg, counters, card):
    """The flagship GPT at amp O2 (fp16 storage, fp32 LayerNorm leaves and
    masters, the dynamic scale from 2^16), flash and unfused, and at O1
    (fp16) and O4 (bf16) autocast over fp32 storage: the parity step at
    batch 2 (flash; a static scale of 2^10, so that the step compared is
    not one the dynamic scale skips), O2's skip step, and the timed and
    profiled run at TRAIN_BATCH. Returns each run's launch counts."""
    params = gpt.init(cfg, gen(0), device="cuda")
    batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    launches = {}
    for level, flash in (("O2", True), ("O2", False), ("O1", True), ("O4", True)):
        key = f"gpt_{level.lower()}{'' if flash else '_unfused'}"
        lcfg = dataclasses.replace(cfg, dtype=GPT_ACT[level],
                                   use_flash_attention=flash)

        def trainer(lcfg=lcfg, level=level, **kw):
            return make_gpt_trainer(amp, gpt, fused_adam, params, lcfg,
                                    level=level, **kw)

        if flash:
            step_parity_phase(
                f"{key}_step_parity",
                lambda **kw: trainer(**{"loss_scale": 2.0 ** 10, **kw}),
                gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60),
                                    device="cuda"),
                2 * LR + 1e-6, "2 lr: a gradient sign flip")
        if key == "gpt_o2":
            skip_phase("gpt_o2_skip_step", trainer, gpt.synthetic_batch(
                cfg, PARITY_BATCH, generator=gen(61), device="cuda"))
        m, state, step = trainer()
        launches[key] = training_phase(
            f"{key}_training", f"{key}_profile", step, batch, counters,
            STEP_LAUNCHES[key], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
            opt_level=level, activations=str(GPT_ACT[level])[6:],
            attention="flash" if flash else "unfused", **lm_work(m, batch))
        scale_line(f"{key}_loss_scale", state["scaler"])
        del m, state, step
        torch.cuda.empty_cache()
    return launches


def resnet_amp_phases(main_amp, fused_sgd, tree_flatten, cfg, weights, counters,
                      flops_per_image, n_params, card):
    """ResNet-50 at amp O2 (the North star's recipe: fp16 arenas, BN fp32,
    the dynamic scale): the parity step and the overflowing step at batch
    2; then O2, O1 and O4 (autocast over fp32 storage, the list path) and
    O3 (fp16 storage without masters: K10 on fp16 params) timed and
    profiled at RESNET_BATCH. Returns each run's launch counts."""
    resnet_step_parity_phase(main_amp, fused_sgd, tree_flatten, cfg, weights,
                             level="O2")
    resnet_skip_phase(main_amp, cfg, weights, level="O2")
    launches = {}
    for level in ("O2", "O1", "O3", "O4"):
        key = f"resnet_{level.lower()}"
        tr = resnet_trainer(main_amp, cfg, weights, level, RESNET_BATCH)
        launches[key] = resnet_training_phase(
            f"{key}_training", f"{key}_profile", tr, trainer_step(tr), counters,
            STEP_LAUNCHES[key], flops_per_image, PEAK_BF16, n_params, card,
            opt_level=level)
        scale_line(f"{key}_loss_scale", tr.scaler_state)
        del tr
        torch.cuda.empty_cache()
    return launches


def check_master_cast(label, pairs):
    """Each ``(params, optimizer state)``'s model leaves are its masters'
    cast, bit for bit."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    for params, state in pairs:
        if not all(torch.equal(p, m.to(p.dtype)) for p, m in zip(
                tree_flatten(params)[0], tree_flatten(state["master"])[0])):
            raise AssertionError(f"{label}: model != masters.to(fp16)")


def dcgan_parity_phase(dcgan, amp):
    """DCGAN O2 on the kernels against ``impl="torch"`` from the same
    weights (``build``'s seed) and batch at DCGAN_BATCH, cuDNN
    deterministic, so that both paths take the same gradients. First the
    kernels alone on DCGAN's trees: K5 unscaling D's fp16 real-loss
    gradients (bitwise, the flag clear on both), then K6 stepping D's
    masters from those gradients (K6's row tolerance on masters and
    moments; the fp16 model the masters' cast bitwise). Then one whole
    iteration: errD and errG to 5e-3 relative, D's and G's masters within
    2 lr (a gradient sign flip: G's loss reads the updated fp16 D), each
    fp16 model the masters' cast bitwise, and the three scaler states
    equal, no step skipped."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    torch.backends.cudnn.deterministic = True
    real, z = (torch.from_numpy(a).cuda()
               for a in next(dcgan.synthetic_batches(DCGAN_BATCH, 1)))
    paths = {impl: dcgan.build("O2", DCGAN_LR, device="cuda", impl=impl)
             for impl in (None, "torch")}
    # K5 alone: D's scaled fp16 gradients, unscaled to fp32
    grads, flags = {}, {}
    for impl, (d, _) in paths.items():
        svag = amp.scaled_value_and_grad(
            lambda p, x, d=d: dcgan.bce_logits(d.apply(p, x), 1.0),
            d.scalers[0], impl=impl)
        scale0 = d.scalers[0].init(device="cuda")
        _, grads[impl], flags[impl], _ = svag(d.params, scale0, real)
    gk, gp = (tree_flatten(grads[i])[0] for i in (None, "torch"))
    if bool(flags[None]) or bool(flags["torch"]):
        raise AssertionError("dcgan parity: K5 flagged D's real-loss gradients")
    if not all(torch.equal(a, b) for a, b in zip(gk, gp)):
        raise AssertionError("dcgan parity: K5's gradients differ from the plain")
    # K6 alone: one MasterWeights step of D from the same gradients
    stepped = {}
    for impl, (d, _) in paths.items():
        state = d.optimizer.init(d.params)
        stepped[impl] = d.optimizer.step(
            d.params, {k: v.clone() for k, v in grads[None].items()}, state,
            found_inf=flags[None])
    (pk, sk), (pp, sp) = stepped[None], stepped["torch"]
    k6_err = 0.0
    for name in ("master", "inner"):
        for x, y in zip(tree_flatten(sk[name])[0], tree_flatten(sp[name])[0]):
            if x.is_floating_point():
                k6_err = max(k6_err, check_close(f"dcgan parity: K6 {name}", x, y,
                                                 dict(rtol=1e-6, atol=1e-10)))
    check_master_cast("dcgan parity: K6", ((pk, sk), (pp, sp)))
    # the whole iteration, each path from its own fresh state
    out = {}
    for impl, (d, g) in paths.items():
        dp, gp = d.params, g.params
        d_opt, g_opt = d.optimizer.init(dp), g.optimizer.init(gp)
        scalers = tuple(s.init(device="cuda") for s in (*d.scalers, *g.scalers))
        step = dcgan.make_train_step(d, g, impl=impl)
        out[impl] = step(dp, gp, d_opt, g_opt, scalers, real, z)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    (dk, gk_, dok, gok, sck, mk), (dpl, gpl, dop, gop, scp, mp) = (
        out[None], out["torch"])
    loss_err = {k: abs(float(mk[k]) - float(mp[k])) / abs(float(mp[k]))
                for k in ("errD", "errG")}
    if not all(np.isfinite(float(mk[k])) and e < 5e-3 for k, e in loss_err.items()):
        raise AssertionError(f"dcgan parity: losses {loss_err}")
    tol = 2 * DCGAN_LR + 1e-6
    master_err = 0.0
    for ok, op in ((dok, dop), (gok, gop)):
        for a, b in zip(tree_flatten(ok["master"])[0], tree_flatten(op["master"])[0]):
            master_err = max(master_err, max_err(a, b))
    if master_err > tol:
        raise AssertionError(f"dcgan parity: masters differ by {master_err} > {tol} "
                             f"(2 lr: a gradient sign flip)")
    check_master_cast("dcgan parity", ((dk, dok), (gk_, gok), (dpl, dop), (gpl, gop)))
    for a, b in zip(sck, scp):
        if not all(torch.equal(a[k], b[k]) for k in b):
            raise AssertionError(f"dcgan parity: scaler states {a} vs {b}")
    if [int(s["unskipped"]) for s in sck] != [1, 1, 1]:
        raise AssertionError(f"dcgan parity: a step was skipped {sck}")
    line("dcgan_o2_parity", batch=DCGAN_BATCH, k5_grads="bitwise",
         k6_max_abs_err=k6_err, k6_tol="'rtol 1e-6, atol 1e-10'",
         errD=float(mk["errD"]), plain_errD=float(mp["errD"]),
         errD_rel_err=loss_err["errD"], errG=float(mk["errG"]),
         plain_errG=float(mp["errG"]), errG_rel_err=loss_err["errG"], loss_tol=5e-3,
         master_max_abs_err=master_err, master_tol=tol,
         model_is_master_cast="bitwise", scaler_states="equal")
    del paths, out, stepped, grads
    torch.cuda.empty_cache()


def dcgan_phase(dcgan, counters, card):
    """The multi-loss DCGAN example at O2 (examples/dcgan: D on two per-loss
    dynamic scalers, G on one, MasterWeights(FusedAdam) on fp16 trees):
    DCGAN_ITERS iterations at DCGAN_BATCH on seeded synthetic batches, each
    timed by CUDA events, the launch counts reset before and read after (K5
    three times and K6 twice an iteration); the losses finite, D(x)
    reported, and the per-loss scaler states through the state dicts and
    back."""
    d, g = dcgan.build("O2", DCGAN_LR, device="cuda")
    dp, gp = d.params, g.params
    d_opt, g_opt = d.optimizer.init(dp), g.optimizer.init(gp)
    scalers = tuple(s.init(device="cuda") for s in (*d.scalers, *g.scalers))
    step = dcgan.make_train_step(d, g)
    batches = [(torch.from_numpy(r).cuda(), torch.from_numpy(z).cuda())
               for r, z in dcgan.synthetic_batches(DCGAN_BATCH, DCGAN_ITERS)]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    events, metrics = [], []
    t0 = time.perf_counter()
    for real, z in batches:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dp, gp, d_opt, g_opt, scalers, m = step(dp, gp, d_opt, g_opt, scalers, real, z)
        b.record()
        events.append((a, b))
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if launches != {"unscale": 3 * DCGAN_ITERS, "adam": 2 * DCGAN_ITERS}:
        raise AssertionError(f"dcgan: launches {launches}, expected K5 3 and K6 2 "
                             f"an iteration")
    vals = {k: [float(m[k]) for m in metrics] for k in ("errD", "errG", "D_x")}
    if not all(np.isfinite(v).all() for v in vals.values()):
        raise AssertionError(f"dcgan: non-finite losses {vals}")
    if any(t.dtype != torch.float16 for t in (*dp.values(), *gp.values())):
        raise AssertionError("dcgan: O2's model params are not fp16")
    sd_d, sd_g = d.state_dict(list(scalers[:2])), g.state_dict(scalers[2])
    if set(sd_d) != {"loss_scaler0", "loss_scaler1"} or set(sd_g) != {"loss_scaler0"}:
        raise AssertionError(f"dcgan: state dict keys {set(sd_d)}, {set(sd_g)}")
    back = list(d.load_state_dict(sd_d, device="cuda")) + [
        g.load_state_dict(sd_g, device="cuda")]
    if not all(torch.equal(a[k], b[k]) for a, b in zip(back, scalers) for k in b):
        raise AssertionError("dcgan: the scaler states did not round-trip")
    it_ms = [a.elapsed_time(b) for a, b in events]
    line("dcgan_o2", iterations=DCGAN_ITERS, batch=DCGAN_BATCH,
         median_iteration_ms=float(np.median(it_ms)),
         mean_iteration_ms=1e3 * wall / DCGAN_ITERS,
         errD_first=vals["errD"][0], errD_last=vals["errD"][-1],
         errG_last=vals["errG"][-1], D_x_first=vals["D_x"][0],
         D_x_last=vals["D_x"][-1],
         loss_scales=json.dumps([s["scale"].item() for s in scalers]),
         unskipped=json.dumps([int(s["unskipped"]) for s in scalers]),
         launches_per_iteration=json.dumps(
             {k: v // DCGAN_ITERS for k, v in launches.items()}),
         state_dict="round-trips", card=f"'{card}'")


# ------------------------------------------------------ slice 14, amp O6

# the flagship's four block GEMMs at batch 16 (M = 16 x 1024 tokens; (K, N)
# of wqkv, wo, wi, wo2), a ragged shape, padded to multiples of 16, and two
# small ones, where the tensor cores' own accumulation shows beside K·2^-24
O6_SHAPES = ((16384, 1024, 3072), (16384, 1024, 1024), (16384, 1024, 4096),
             (16384, 4096, 1024), (16383, 1000, 1000), (1000, 40, 24), (33, 17, 9))
# the card's fp8 product against its plain version, per element:
# (FP8_SUM_C·K·2^-24 + FP8_MMA_REL)·Σ|â||b̂| times the output scale. Two fp32
# sums of K terms in two orders part by up to 2·K·2^-24·Σ; the fp8 tensor
# cores align each k-group's products to a narrow window before cuBLAS adds
# it into fp32 (use_fast_accum=False), a cost that does not shrink with K:
# at small K a K-proportional bound alone would need a c of 100 or more
# (the o6_gemm lines' of_k_ulp_sum, PERF.md)
FP8_SUM_C, FP8_MMA_REL = 2.0, 2.0 ** -11
O6_GEMMS = ("wqkv", "wo", "wi", "wo2")
O6_VS_O5_STEPS = 50
# the O6 parity step, kernels against plain (batch 2, a warm history): the
# GPT step rows' loss and master bounds. The gradients part further than at
# O5: an input one rounding apart that straddles an fp8 midpoint moves a
# whole fp8 step (2^-3 in e4m3, 2^-2 in e5m2), and 8 layers pass it on
# (measured 0.151 in relative L2, PERF.md), so they are held at about twice
# that and within twice the spread of two correct O6 steps (flash against
# unfused attention, both on the kernels); the history's grad row at about
# twice its reading (0.0197), its weight row bitwise
O6_PARITY_TOL = dict(loss=5e-3, grad=0.3, grad_of_spread=2.0,
                     master=2 * LR + 1e-6, history=0.05)


def fp8_product_bound(qa, qb, inv):
    s = (qa.float().abs() @ qb.float().abs()) * inv.abs()
    return (FP8_SUM_C * qa.shape[1] * 2.0 ** -24 + FP8_MMA_REL) * s


class ProductCount:
    """A launch counter over ``ops.quantized.product_counts[key]``, for
    :func:`training_phase`'s counters."""

    def __init__(self, q8, key):
        self.q8, self.key = q8, key

    @property
    def launches(self):
        return self.q8.product_counts[self.key]

    @launches.setter
    def launches(self, n):
        self.q8.product_counts[self.key] = n


def product_counters(q8):
    return {k: ProductCount(q8, k) for k in q8.product_counts}


@contextlib.contextmanager
def plain_products(q8):
    """The plain path of the fp8 tier: ``quantized_matmul``'s products on
    their plain version (the same fp8 values widened to fp32) where the op
    would call the card's fp8 GEMM, so that a trainer with ``impl="torch"``
    runs every op of the step plain."""
    real = q8._fp8_mm
    q8._fp8_mm = q8._plain_mm
    try:
        yield
    finally:
        q8._fp8_mm = real


@contextlib.contextmanager
def o6_ranges(q8):
    """Profiler ranges around the fp8 tier's two parts while a step is
    profiled: ``fp8_gemm`` (each product, its operands' fp8 transposes and
    padding included) and ``fp8_quantize`` (the amax, scale, clamp and cast
    passes, the step's amax observations included)."""
    names = {"_fp8_mm": "fp8_gemm", "_amax": "fp8_quantize",
             "_q_e4m3": "fp8_quantize", "_q_e5m2": "fp8_quantize"}
    real = {n: getattr(q8, n) for n in names}

    def ranged(fn, name):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    for n, r in names.items():
        setattr(q8, n, ranged(real[n], r))
    try:
        yield ("fp8_gemm", "fp8_quantize")
    finally:
        for n, fn in real.items():
            setattr(q8, n, fn)


def o6_gemm_phase(q8):
    """``quantized_matmul``'s parts on the card at O6_SHAPES: the quantized
    bytes of x (e4m3), w (e4m3) and the cotangent (e5m2) bitwise the CPU's
    quantization of the same fp32 values; the three products (forward, dx,
    dw) on ``torch._scaled_mm`` within ``fp8_product_bound`` of their plain
    version, each timed beside the bf16 product the O5 step runs at that
    shape (``_HalfDense32``'s bf16 x bf16 -> fp32 forward, bf16 backward)
    and the bound max(bytes / HBM, flops / the fp8 peak); the op within
    ``quantized_matmul_error_bound`` of the fp32 product; the quantize
    passes timed. Returns the rows for PERF.md's fp8 table."""
    e4, e5 = q8.E4M3_MAX, q8.E5M2_MAX
    for M, K, N in O6_SHAPES:
        g = gen(80)
        x = torch.randn(M, K, device="cuda", generator=g).bfloat16()
        w = (torch.randn(K, N, device="cuda", generator=g) * 0.02).bfloat16()
        dyb = torch.randn(M, N, device="cuda", generator=g).bfloat16()
        dy = dyb.float()
        sx, sw = (q8._jit_scale(q8._amax(t), e4) for t in (x, w))
        sg = q8._jit_scale(q8._amax(dy), e5)
        qx, qw, qdy = q8._q_e4m3(x, sx), q8._q_e4m3(w, sw), q8._q_e5m2(dy, sg)
        for name, q, t, s, cast in (("x", qx, x, sx, q8._q_e4m3),
                                    ("w", qw, w, sw, q8._q_e4m3),
                                    ("dy", qdy, dy, sg, q8._q_e5m2)):
            if not torch.equal(q.view(torch.uint8).cpu(),
                               cast(t.cpu(), s.cpu()).view(torch.uint8)):
                raise AssertionError(f"o6_gemm {M}x{K}x{N}: {name}'s fp8 bytes "
                                     f"differ from the CPU's")
        shape = f"{M}x{K}x{N}"
        products = (("forward", qx, qw, q8.div(1.0, sx * sw),
                     lambda: torch.mm(x, w, out_dtype=torch.float32)),
                    ("dx", qdy, qw.t(), q8.div(1.0, sg * sw), lambda: dyb @ w.t()),
                    ("dw", qx.t(), qdy, q8.div(1.0, sx * sg), lambda: x.t() @ dyb))
        for name, a, b, inv, o5 in products:
            got = q8._fp8_mm(a, b, inv, "forward")
            ref = q8._plain_mm(a, b, inv, "forward")
            sums = ((a.float().abs() @ b.float().abs()) * inv.abs()).clamp_min(1e-38)
            bound = fp8_product_bound(a, b, inv).clamp_min(1e-38)
            ratio = float(((got - ref).abs() / bound).max())
            # the same difference in units of K·2^-24·Σ and of Σ
            of_sum = float(((got - ref).abs() / sums).max())
            if not ratio <= 1.0:
                raise AssertionError(f"o6_gemm {shape} {name}: at {ratio} of its "
                                     f"bound")
            m, k, n = a.shape[0], a.shape[1], b.shape[1]
            nbytes = m * k + k * n + 4 * m * n  # fp8 in, fp32 out
            flops = 2.0 * m * n * k
            line("o6_gemm", shape=shape, product=name,
                 operands=f"'{str(a.dtype)[6:]} x {str(b.dtype)[6:]} -> fp32'",
                 max_abs_err=float((got - ref).abs().max()), of_bound=ratio,
                 of_k_ulp_sum=of_sum / (a.shape[1] * 2.0 ** -24), of_sum=of_sum,
                 ms=time_ms(lambda: q8._fp8_mm(a, b, inv, "forward")),
                 plain_ms=time_ms(lambda: q8._plain_mm(a, b, inv, "forward"), iters=5),
                 bf16_ms=time_ms(o5),
                 bound_ms=1e3 * max(nbytes / HBM_BPS, flops / PEAK_FP8),
                 bound_by="bytes" if nbytes / HBM_BPS > flops / PEAK_FP8
                 else "operations")
            del got, ref
        with torch.no_grad():
            y = q8.quantized_matmul(x, w)
            err = float((y - x.float() @ w.float()).abs().max())
        bound = float(q8.quantized_matmul_error_bound(x, w))
        if not err <= bound:
            raise AssertionError(f"o6_gemm {shape}: op error {err} > {bound}")
        line("o6_quantize", shape=shape, op_max_abs_err=err, op_bound=bound,
             amax_ms=time_ms(lambda: q8._amax(x)),
             e4m3_x_ms=time_ms(lambda: q8._q_e4m3(x, sx)),
             e5m2_dy_ms=time_ms(lambda: q8._q_e5m2(dy, sg)),
             fp8_transpose_x_ms=time_ms(lambda: qx.t().contiguous()),
             bytes_bound_x_ms=1e3 * (2 + 1) * M * K / HBM_BPS)
        del x, w, dy, dyb, qx, qw, qdy, y
        torch.cuda.empty_cache()


def o6_trainer(amp, gpt, fused_adam, params, cfg, q8):
    """The flagship's O6 step (``bench.py`` ``make_gpt_rung("O6")``):
    ``make_gpt_trainer`` at level O6; with ``impl="torch"`` its products
    plain too (:func:`plain_products`, entered around each step)."""
    def make(impl=None, **kw):
        m, state, step = make_gpt_trainer(amp, gpt, fused_adam, params, cfg,
                                          impl=impl, level="O6", **kw)
        if impl != "torch":
            return m, state, step

        def plain_step(*batch):
            with plain_products(q8):
                return step(*batch)
        return m, state, plain_step
    return make


def reset_products(q8):
    for k in q8.product_counts:
        q8.product_counts[k] = 0


def gpt_o6_parity_phase(trainer, unfused, q8, batch, warm, n_layers):
    """One full-width O6 step at batch 2 on the kernels (K1-K6, the fp8
    GEMMs) and on the plain path, from the same weights, batch and scaler
    state: a warm amax history (``warm``, the observations of one step on
    the same weights), so the delayed scales are the steady state's, not
    step 0's. Loss, gradient arenas, masters, the model arena as the
    masters' cast, the history after the step and each path's product
    counts. The gradients are also held against the spread of two correct
    O6 steps: the same step on the kernels with unfused attention
    (``unfused``), which rounds the attention at other places."""
    res = {}
    for name, impl, make in (("kernels", None, trainer), ("plain", "torch", trainer),
                             ("unfused", None, unfused)):
        m, state, step = make(impl=impl)
        state["scaler"]["amax_history"][:, 0] = warm
        reset_products(q8)
        loss, g, fi = step(*batch)
        torch.cuda.synchronize()
        counts = dict(q8.product_counts)
        path = "fp8" if impl is None else "plain"
        n = len(O6_GEMMS) * n_layers
        if counts != {**{k: 0 for k in counts}, f"{path}_forward": n,
                      f"{path}_backward": 2 * n} or bool(fi):
            raise AssertionError(f"gpt_o6_step_parity ({name}): products {counts}, "
                                 f"found_inf {bool(fi)}")
        model, masters, _, _ = snapshot(m, state)
        for arena, master in zip(model, masters):
            if not torch.equal(arena, master.to(arena.dtype)):
                raise AssertionError(f"gpt_o6_step_parity ({name}): model arena "
                                     f"!= masters.to(dtype)")
        res[name] = (loss.item(), [a.clone() for a in model_leaves(g)], masters,
                     state["scaler"]["amax_history"].clone())
        del m, state, step, g
        torch.cuda.empty_cache()
    (lk, gk, mk, hk), (lp, gp, mp, hp) = res["kernels"], res["plain"]
    loss_err = abs(lk - lp) / abs(lp)
    grad_rel = [float((a - b).norm() / b.norm()) for a, b in zip(gk, gp)]
    spread = [float((a - b).norm() / b.norm()) for a, b in zip(gk, res["unfused"][1])]
    master_err = max(max_err(a, b) for a, b in zip(mk, mp))
    hist_rel = float(((hk - hp).abs() / hp.abs().clamp_min(1e-30)).max())
    tol = O6_PARITY_TOL
    if not (np.isfinite(lk) and loss_err < tol["loss"] and max(grad_rel) < tol["grad"]
            and all(g <= tol["grad_of_spread"] * s_ for g, s_ in zip(grad_rel, spread))
            and master_err <= tol["master"] and hist_rel <= tol["history"]
            and torch.equal(hk[0], hp[0]) and torch.equal(hk[:, 1:], hp[:, 1:])):
        raise AssertionError(f"gpt_o6_step_parity: loss {lk} vs {lp}, grads rel L2 "
                             f"{grad_rel} (flash vs unfused {spread}), masters "
                             f"{master_err}, history {hist_rel} (tolerances {tol})")
    line("gpt_o6_step_parity", batch=batch[0].shape[0], loss=lk, plain_loss=lp,
         loss_rel_err=loss_err, grad_rel_l2=json.dumps(grad_rel),
         flash_vs_unfused_grad_rel_l2=json.dumps(spread),
         grad_max_abs_err=max(max_err(a, b) for a, b in zip(gk, gp)),
         master_max_abs_err=master_err, history_rel_err=hist_rel,
         history=json.dumps(hk[:, :2].tolist()), tolerances=json.dumps(tol),
         products_a_step=n, model_arena_is_master_cast="bitwise")


def gpt_o6_skip_phase(amp, gpt, fused_adam, guard_mod, params, cfg, batch):
    """The grad row of the amax history poisoned (amax 1e-30, so the e5m2
    cotangent overflows at the scale it implies), as
    ``tests/test_quantized.py`` does: through ``scaled_value_and_grad`` and
    through ``StepGuard``, found_inf set, masters, moments, step counts and
    model arenas bitwise unchanged, the scale halved, the history finite
    (the inf observation dropped)."""
    for via in ("scaled_value_and_grad", "StepGuard"):
        if via == "StepGuard":
            m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params,
                               fused_adam(lr=LR), "O6", arena_native=True)
            guard = guard_mod.StepGuard(m.scaler)
            gstate = guard.init(m.params)
            state = {"opt": m.optimizer.init(m.params), "scaler": gstate["scaler"]}
            vg = guard.value_and_grad(
                lambda p, tok, tgt: gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply))

            def step(*b):
                loss, g, verdict = vg(m.params, gstate, *b)
                m.params, state["opt"], new = guard.apply_update(
                    m.optimizer, m.params, g, state["opt"], gstate, verdict)
                gstate.update(new)
                state["scaler"] = gstate["scaler"]
                return loss, g, verdict["grad_overflow"]
        else:
            m, state, step = make_gpt_trainer(amp, gpt, fused_adam, params, cfg,
                                              level="O6")
        state["scaler"]["amax_history"][1, 0] = 1e-30
        before = snapshot(m, state)
        scale0 = state["scaler"]["scale"].item()
        _, _, fi = step(*batch)
        torch.cuda.synchronize()
        after = snapshot(m, state)
        hist = state["scaler"]["amax_history"]
        if not bool(fi):
            raise AssertionError(f"gpt_o6_skip_step ({via}): found_inf not set")
        same = all(torch.equal(a, b) for xs, ys in zip(before[:3], after[:3])
                   for a, b in zip(xs, ys))
        if not same or after[3] != before[3]:
            raise AssertionError(f"gpt_o6_skip_step ({via}): the state changed")
        scale1 = state["scaler"]["scale"].item()
        if scale1 != scale0 / 2 or not torch.isfinite(hist).all():
            raise AssertionError(f"gpt_o6_skip_step ({via}): scale {scale0} -> "
                                 f"{scale1}, history {hist[:, :2].tolist()}")
        line("gpt_o6_skip_step", via=via, found_inf=True, state="bitwise unchanged",
             scale_before=scale0, scale_after=scale1,
             history=json.dumps(hist[:, :2].tolist()), step_count=after[3][0])
        del m, state, step
        torch.cuda.empty_cache()


def gpt_o6_vs_o5_phase(amp, gpt, fused_adam, q8, params, cfg, batch):
    """``testing/quantized_bench.py``'s parity rung at full width: O6_VS_O5_STEPS
    steps of O5 and of O6 from one init on one fixed batch, every step's
    |loss_O6 - loss_O5| within ``loss_parity_bound(t, n_matmuls=32,
    loss_ceiling=the largest O5 loss)``; the largest margin and the last
    deviation printed, as the bench prints them."""
    losses, skipped = {}, {}
    for level in ("O5", "O6"):
        _, _, step = make_gpt_trainer(amp, gpt, fused_adam, params, cfg, level=level)
        ls, fs = [], []
        for _ in range(O6_VS_O5_STEPS):
            loss, _, fi = step(*batch)
            ls.append(loss)
            fs.append(fi)
        losses[level] = torch.stack(ls).tolist()
        skipped[level] = int(torch.stack(fs).sum())
        del step
        torch.cuda.empty_cache()
    l5, l6 = losses["O5"], losses["O6"]
    n = len(O6_GEMMS) * cfg.n_layers
    ceiling = max(abs(v) for v in l5)
    margins = [abs(a - b) / q8.loss_parity_bound(t, n_matmuls=n, loss_ceiling=ceiling)
               for t, (a, b) in enumerate(zip(l5, l6))]
    if not (all(np.isfinite(l6)) and max(margins) <= 1.0 and l6[-1] < l6[0]):
        raise AssertionError(f"gpt_o6_vs_o5: margins up to {max(margins)}, O6 "
                             f"losses {l6[0]} -> {l6[-1]}")
    line("gpt_o6_vs_o5", steps=O6_VS_O5_STEPS, batch=batch[0].shape[0],
         n_matmuls=n, loss_ceiling=ceiling, largest_margin=max(margins),
         margin_at_step=int(np.argmax(margins)),
         first_bound=q8.loss_parity_bound(0, n_matmuls=n, loss_ceiling=ceiling),
         last_deviation=abs(l5[-1] - l6[-1]),
         largest_deviation=max(abs(a - b) for a, b in zip(l5, l6)),
         o5_final_loss=l5[-1], o6_final_loss=l6[-1], skipped=json.dumps(skipped),
         o5_losses=json.dumps([round(x, 4) for x in l5[::7]]),
         o6_losses=json.dumps([round(x, 4) for x in l6[::7]]))


def gpt_o6_phases(amp, gpt, fused_adam, guard_mod, q8, cfg, counters, card):
    """The flagship GPT at amp O6: the parity step at batch 2 from a warm
    history, the poisoned-history skip through both entry points, the timed
    and profiled run at TRAIN_BATCH (launches, products, host syncs,
    skipped steps, the final scale and history, peak memory, the fp8-aware
    MFU; the profile's fp8 GEMM and quantize ranges), and the 50-step
    parity rung against O5. Returns the run's launch counts."""
    params = gpt.init(cfg, gen(0), device="cuda")
    trainer = o6_trainer(amp, gpt, fused_adam, params, cfg, q8)
    unfused = o6_trainer(amp, gpt, fused_adam, params,
                         dataclasses.replace(cfg, use_flash_attention=False), q8)
    parity = gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60), device="cuda")
    m, state, step = trainer()
    step(*parity)
    warm = state["scaler"]["amax_history"][:, 0].clone()
    del m, state, step
    gpt_o6_parity_phase(trainer, unfused, q8, parity, warm, cfg.n_layers)
    gpt_o6_skip_phase(amp, gpt, fused_adam, guard_mod, params, cfg,
                      gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(61),
                                          device="cuda"))
    batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    m, state, step = trainer()
    work = lm_work(m, batch)
    n_fp8 = sum(params["blocks"][k].numel() for k in O6_GEMMS)
    fp8_flops = 6.0 * n_fp8 * work["units"]
    work["flops"] -= fp8_flops
    launches = training_phase(
        "gpt_o6_training", "gpt_o6_profile", step, batch,
        {**counters, **product_counters(q8)}, STEP_LAUNCHES["gpt_o6"],
        TRAIN_GROUPS, card, seq_len=cfg.seq_len, opt_level="O6",
        fp8_flops=fp8_flops, fp8_params=n_fp8,
        ranges=lambda: o6_ranges(q8), **work)
    scale_line("gpt_o6_loss_scale", state["scaler"])
    line("gpt_o6_amax_history", rows=json.dumps(
        {r: state["scaler"]["amax_history"][i, :4].tolist()
         for i, r in enumerate(q8.HISTORY_ROLES)}))
    del m, state, step
    torch.cuda.empty_cache()
    gpt_o6_vs_o5_phase(amp, gpt, fused_adam, q8, params, cfg, batch)
    del params
    torch.cuda.empty_cache()
    return launches


def serving_e4m3_phase(infer, params, cfg, attn, norm, card):
    """The flagship engine on e4m3 pages: (a) on the kernels against
    ``impl="torch"`` (fp32 logits within LOGIT_TOL; each decode call runs
    K2's contiguous decode once a layer over the dequantized pages, its
    paged mode never); (b) against fp32 pages on the same prompts, both on
    the kernels: each decode step's logits within ``kv_logit_error_bound``,
    the greedy tokens' agreement printed; (c) the serving mix through
    ``ContinuousBatcher`` and its profile, and the page-bytes ratio."""
    ecfg = infer.EngineConfig(**{**ENGINE, "cache_dtype": "e4m3"})
    engines = {impl: infer.InferenceEngine(params, cfg, ecfg, impl=impl)
               for impl in ("kernel", "torch")}
    engines["fp32"] = infer.InferenceEngine(params, cfg, infer.EngineConfig(**ENGINE))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 769, 8)]
    alloc = infer.PageAllocator(ecfg.num_pages)
    tables = [alloc.alloc(infer.pages_for(len(p) + 8, ecfg.page_size))
              for p in prompts]
    toks = {i: e.prefill(prompts, tables) for i, e in engines.items()}
    feed, lens = toks["fp32"].tolist(), [len(p) for p in prompts]
    worst, devs, agree = 0.0, [], []
    for t in range(4):
        paged, flash = attn._paged_decode_kernel.launches, attn.flash_fwd_kernel.launches
        got = torch.from_numpy(engines["kernel"].decode_logits(feed, lens, tables))
        if (attn.flash_fwd_kernel.launches - flash != cfg.n_layers
                or attn._paged_decode_kernel.launches != paged):
            raise AssertionError("serving_e4m3: decode on the kernels launched "
                                 f"{attn.flash_fwd_kernel.launches - flash} K2, "
                                 f"{attn._paged_decode_kernel.launches - paged} paged")
        ref = torch.from_numpy(engines["torch"].decode_logits(feed, lens, tables))
        f32 = torch.from_numpy(engines["fp32"].decode_logits(feed, lens, tables))
        if not torch.isfinite(got).all() or max_err(got, ref) > LOGIT_TOL:
            raise AssertionError(f"serving_e4m3: kernels vs plain {max_err(got, ref)}")
        worst = max(worst, max_err(got, ref))
        dev = max_err(got, f32)
        bound = infer.kv_logit_error_bound(t, n_layers=cfg.n_layers,
                                           logit_ceiling=float(f32.abs().max()))
        if not dev <= bound:
            raise AssertionError(f"serving_e4m3: e4m3 vs fp32 pages {dev} > {bound}")
        devs.append((dev, bound))
        agree.append(float((got.argmax(-1) == f32.argmax(-1)).float().mean()))
        feed, lens = f32.argmax(-1).tolist(), [n + 1 for n in lens]
    torch.cuda.synchronize()
    lay = engines["kernel"].layout
    ratio = dataclasses.replace(lay, dtype_name="float32").page_bytes / lay.page_bytes
    if ratio < 1.8:
        raise AssertionError(f"serving_e4m3: page bytes ratio {ratio}")
    line("serving_e4m3_parity", kernel_vs_plain_max_abs_err=worst, tol=LOGIT_TOL,
         vs_fp32_pages=json.dumps([[round(d, 6), round(b, 4)] for d, b in devs]),
         greedy_agreement=json.dumps(agree), decode_steps=4, prompts=len(prompts),
         k2_decode_launches_per_call=cfg.n_layers, paged_launches=0,
         page_bytes_fp32_over_e4m3=ratio)
    del engines
    torch.cuda.empty_cache()
    eng, launches, _ = serving_phase(infer, params, cfg, norm, attn, card,
                                     cache_dtype="e4m3", label="serving_e4m3")
    # its decode calls' share of K2's launches: the contiguous decode mode
    decode = {"flash_fwd": cfg.n_layers * eng.call_counts["decode"]}
    # ROADMAP A29's cuts: the e4m3 mix's trace holds a small kernel a page op
    # and reading it back took most of this phase, so the profile covers the
    # mix's first quarter
    profile_phase(infer, eng, cfg, label="serving_e4m3_profile",
                  n_requests=N_REQUESTS // 4)
    del eng
    torch.cuda.empty_cache()
    return launches, decode


# --------------------------------------------- slice 16: the serving tier


def page_bytes_line(infer, cfg):
    """Device bytes of a page and of a 1024-token sequence, k and v over
    every layer, for each page dtype of the flagship engine."""
    out = {}
    for dt in ("float32", "bfloat16", "float16", "e4m3"):
        lay = infer.PagedLayout(n_layers=cfg.n_layers, n_pages=ENGINE["num_pages"],
                                page_size=ENGINE["page_size"],
                                kv_dim=cfg.n_heads * cfg.head_dim, dtype_name=dt)
        out[dt] = {"page": lay.page_bytes,
                   "sequence_1024": lay.page_bytes * (1024 // lay.page_size)}
    return out


def pages16_parity_phase(infer, params, cfg, attn):
    """The flagship engine on bf16 and fp16 pages against fp32 pages, all on
    the kernels, fed the same tokens: prefill logits (which attend to the
    exact k and v) and four decode steps (K2's paged mode once a layer, no
    gathered page). bf16 pages hold the bf16 k and v the fp32 pages hold, so
    every logit is bitwise the fp32 run's; fp16 pages within LOGIT_TOL."""
    kinds = ("float32", "bfloat16", "float16")
    engines = {dt: infer.InferenceEngine(params, cfg, infer.EngineConfig(
        **{**ENGINE, "cache_dtype": dt})) for dt in kinds}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(64, 769, 8)]
    alloc = infer.PageAllocator(ENGINE["num_pages"])
    tables = [alloc.alloc(infer.pages_for(len(p) + 8, ENGINE["page_size"]))
              for p in prompts]
    first = {dt: e.prefill_logits(prompts, tables) for dt, e in engines.items()}
    errs = {dt: [max_err(torch.from_numpy(first[dt]), torch.from_numpy(first["float32"]))]
            for dt in kinds[1:]}
    feed, lens = first["float32"].argmax(-1).tolist(), [len(p) for p in prompts]
    agree = {dt: [] for dt in kinds[1:]}
    for _ in range(4):
        logits = {}
        for dt, e in engines.items():
            paged = attn._paged_decode_kernel.launches
            with counting(infer.kvcache, "gather_pages") as gathers:
                logits[dt] = torch.from_numpy(e.decode_logits(feed, lens, tables))
            if attn._paged_decode_kernel.launches - paged != cfg.n_layers or gathers.calls:
                raise AssertionError(f"pages16 {dt}: decode launched "
                                     f"{attn._paged_decode_kernel.launches - paged} "
                                     f"paged, gathered {gathers.calls}")
        for dt in kinds[1:]:
            if not torch.isfinite(logits[dt]).all():
                raise AssertionError(f"pages16 {dt}: non-finite logits")
            errs[dt].append(max_err(logits[dt], logits["float32"]))
            agree[dt].append(float((logits[dt].argmax(-1)
                                    == logits["float32"].argmax(-1)).float().mean()))
        feed, lens = logits["float32"].argmax(-1).tolist(), [n + 1 for n in lens]
    torch.cuda.synchronize()
    if max(errs["bfloat16"]) != 0.0:
        raise AssertionError(f"pages16: bf16 pages' logits not bitwise fp32 pages' "
                             f"({errs['bfloat16']})")
    if max(errs["float16"]) > LOGIT_TOL:
        raise AssertionError(f"pages16: fp16 pages' logits {errs['float16']} > "
                             f"{LOGIT_TOL}")
    line("pages16_parity", bf16_vs_fp32_max_abs_err=json.dumps(errs["bfloat16"]),
         fp16_vs_fp32_max_abs_err=json.dumps(errs["float16"]), tol=LOGIT_TOL,
         greedy_agreement=json.dumps(agree), decode_steps=4, prompts=len(prompts),
         paged_launches_per_decode=cfg.n_layers, gathers_on_kernel_path=0,
         page_bytes=json.dumps(page_bytes_line(infer, cfg)))
    del engines
    torch.cuda.empty_cache()


def serving_16bit_phases(infer, params, cfg, norm, attn, card, fp32_streams):
    """The serving mix on bf16 and fp16 pages (``serving_phase``: every
    decode call on K2's paged mode over the 16-bit pools). bf16: every
    greedy stream identical to the fp32-pages run's. fp16: the streams'
    token agreement with that run, printed, not gated (an fp16 page rounds
    a bf16 value below 2^-14, which may flip a near tie)."""
    launches = {}
    for dt in ("bfloat16", "float16"):
        eng, launches[f"serving_{dt}"], streams = serving_phase(
            infer, params, cfg, norm, attn, card, cache_dtype=dt,
            label=f"serving_{dt}")
        del eng
        torch.cuda.empty_cache()
        same = sum(streams[r] == fp32_streams[r] for r in fp32_streams)
        tokens = [a == b for r in fp32_streams
                  for a, b in zip(streams[r], fp32_streams[r])]
        if dt == "bfloat16" and same != len(fp32_streams):
            raise AssertionError(f"serving_bfloat16: {len(fp32_streams) - same} "
                                 f"streams differ from fp32 pages'")
        line(f"serving_{dt}_vs_fp32", streams_identical=same,
             requests=len(fp32_streams), token_agreement=float(np.mean(tokens)),
             gated=dt == "bfloat16")
    return launches


# the prefix-heavy mix: the driver's synthetic_trace with four shared
# 512-token system prompts (Zipf over families), tails of 16-128 tokens and
# 32-128 new tokens
PREFIX_TRACE = dict(shared_prefix_tokens=512, prefix_families=4,
                    prompt_range=(16, 129), new_tokens_range=(32, 129))
PREFIX_REQUESTS = 32


def prefix_trace(driver, cfg, n=PREFIX_REQUESTS, seed=9, rate=50.0):
    reqs = driver.synthetic_trace(n, rate, seed=seed, vocab=cfg.vocab_size,
                                  **PREFIX_TRACE)
    for r in reqs:
        r.arrival = 0.0  # a closed run: every request is there at the start
    return reqs


def prefix_serving_phase(infer, driver, params, cfg):
    """The prefix-heavy mix through ``ContinuousBatcher(prefix_cache=True)``
    with ``ServingTelemetry`` on the serving pool (768 usable pages), and
    again without the cache on the same pages. Gated: every request
    finishes; the tree's hit rate is above 0; fewer prompt tokens go
    through prefill than in the uncached run, and the telemetry counts
    prefix-hit tokens; page famine evicts at least one tree leaf; no page
    leaks, and after ``radix.clear()`` every refcount is 0 and the pool
    full; for each prefix-hit request, the logits of its first token
    through decode-extend lie within LOGIT_TOL of a fresh prefill of the
    same prompt. Stream agreement with the uncached run is printed, not
    gated: decode-extend computes the tail's k and v in GEMMs of another M
    than prefill, which may flip a near tie in bf16."""
    ecfg = infer.EngineConfig(**{**ENGINE, "num_pages": SERVE_PAGES})
    eng = infer.InferenceEngine(params, cfg, ecfg)

    class FirstLogits(infer.ContinuousBatcher):
        """Records each prefix-hit request's first-token logits: on the
        decode tick that feeds its last prompt token, the same call through
        ``decode_logits`` first (it writes the same k and v)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.hits, self.first, self.evicted = set(), {}, 0
            evict = self.radix.evict

            def counted(n=1):
                got = evict(n)
                self.evicted += got
                return got

            self.radix.evict = counted

        def _try_extend(self, req, now):
            ok = super()._try_extend(req, now)
            if ok:
                self.hits.add(req.rid)
            return ok

        def _decode(self):
            rows = [i for i, r in enumerate(self.active)
                    if r.rid in self.hits and r.rid not in self.first
                    and r.cached == len(r.prompt) - 1]
            if rows:
                logits = self.engine.decode_logits(
                    [r.sequence[r.cached] for r in self.active],
                    [r.cached for r in self.active],
                    [r.pages for r in self.active])
                for i in rows:
                    self.first[self.active[i].rid] = logits[i]
            super()._decode()

    results = {}
    for cached in (False, True):
        eng.reset_cache()
        tel = infer.ServingTelemetry()
        cls = FirstLogits if cached else infer.ContinuousBatcher
        bat = cls(eng, telemetry=tel, prefix_cache=cached)
        reqs = prefix_trace(driver, cfg)
        prefill_tokens = 0
        real_prefill = eng.prefill

        def prefill(prompts, tables):
            nonlocal prefill_tokens
            prefill_tokens += sum(len(p) for p in prompts)
            return real_prefill(prompts, tables)

        eng.prefill = prefill
        try:
            for r in reqs:
                bat.submit(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fin = bat.run(max_steps=20000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del eng.prefill
        if len(fin) != PREFIX_REQUESTS or any(len(r.out) != r.max_new_tokens
                                              for r in fin):
            raise AssertionError(f"prefix_serving (cache {cached}): not every "
                                 f"request finished")
        results[cached] = dict(bat=bat, tel=tel, wall=wall, prefill_tokens=prefill_tokens,
                               streams={r.rid: r.out for r in fin},
                               prompts={r.rid: r.prompt for r in fin})
    off, on = results[False], results[True]
    bat, rep = on["bat"], on["tel"].serving_report()
    if off["bat"].allocator.available != ecfg.num_pages - 1:
        raise AssertionError("prefix_serving (uncached): pages leaked")
    if not bat.radix.hit_rate > 0.0 or not rep["prefix_hit_tokens"] > 0:
        raise AssertionError(f"prefix_serving: hit rate {bat.radix.hit_rate}, "
                             f"hit tokens {rep['prefix_hit_tokens']}")
    if not on["prefill_tokens"] < off["prefill_tokens"]:
        raise AssertionError(f"prefix_serving: {on['prefill_tokens']} prompt tokens "
                             f"through prefill, uncached {off['prefill_tokens']}")
    if bat.evicted < 1:
        raise AssertionError("prefix_serving: no radix eviction under page pressure")
    held = bat.radix.pages_held
    if bat.allocator.available + held != ecfg.num_pages - 1:
        raise AssertionError(f"prefix_serving: {bat.allocator.available} free + "
                             f"{held} in the tree != {ecfg.num_pages - 1}")
    bat.radix.clear()
    if (bat.allocator.available != ecfg.num_pages - 1
            or any(bat.allocator.refcount(p) for p in range(ecfg.num_pages))):
        raise AssertionError("prefix_serving: pages held after radix.clear()")
    # each prefix-hit request's first token through decode-extend against a
    # fresh prefill of its prompt
    worst, checked = 0.0, sorted(bat.first)
    if not checked:
        raise AssertionError("prefix_serving: no prefix hit reached its first token")
    for i in range(0, len(checked), 8):
        rids = checked[i:i + 8]
        prompts = [on["prompts"][r] for r in rids]
        alloc = infer.PageAllocator(ecfg.num_pages)
        tables = [alloc.alloc(infer.pages_for(len(p), ecfg.page_size)) for p in prompts]
        ref = torch.from_numpy(eng.prefill_logits(prompts, tables))
        got = torch.from_numpy(np.stack([bat.first[r] for r in rids]))
        if not torch.isfinite(got).all():
            raise AssertionError("prefix_serving: non-finite decode-extend logits")
        worst = max(worst, max_err(got, ref))
    if worst > LOGIT_TOL:
        raise AssertionError(f"prefix_serving: decode-extend vs prefill logits {worst}")
    same = sum(on["streams"][r] == off["streams"][r] for r in off["streams"])
    tokens = sum(len(s) for s in on["streams"].values())
    line("prefix_serving", requests=PREFIX_REQUESTS, hit_rate=bat.radix.hit_rate,
         prefix_hits=rep["prefix_hits"], prefix_hit_tokens=rep["prefix_hit_tokens"],
         prefill_prompt_tokens=on["prefill_tokens"],
         uncached_prefill_prompt_tokens=off["prefill_tokens"],
         radix_evictions=bat.evicted, tree_pages_at_end=held,
         preemptions=rep["preemptions"],
         extend_vs_prefill_max_abs_err=worst, extend_checked=len(checked),
         tol=LOGIT_TOL, streams_equal_uncached=same,
         tokens_per_s=tokens / on["wall"],
         uncached_tokens_per_s=tokens / off["wall"],
         ttft_p50_ms=rep["ttft_p50_ms"], ttft_p99_ms=rep["ttft_p99_ms"],
         uncached_ttft_p50_ms=off["tel"].serving_report()["ttft_p50_ms"],
         uncached_ttft_p99_ms=off["tel"].serving_report()["ttft_p99_ms"],
         signatures=eng.compiled_signatures)
    del eng, results, bat
    torch.cuda.empty_cache()


def disagg_serving_phase(infer, params, cfg):
    """``DisaggregatedBatcher`` (prefill buckets 8 and 16, one decode bucket
    of 32) against the unified batcher on the seeded serving mix and the
    same 768 usable pages, each with ``ServingTelemetry``. Gated: the strict
    signature gate stays closed (any undeclared signature raises), every
    request finishes, no page leaks. Printed: TTFT p50/p99, tokens/s and the
    streams' agreement."""
    out = {}
    for label, cls, extra in (
            ("unified", infer.ContinuousBatcher, {}),
            ("disagg", infer.DisaggregatedBatcher,
             dict(batch_buckets=(8, 16), decode_batch_buckets=(32,)))):
        ecfg = infer.EngineConfig(**{**ENGINE, "num_pages": SERVE_PAGES, **extra})
        eng = infer.InferenceEngine(params, cfg, ecfg)
        tel = infer.ServingTelemetry()
        bat = cls(eng, telemetry=tel)
        for r in serving_requests(infer, cfg):
            bat.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = bat.run(max_steps=20000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(fin) != N_REQUESTS or any(len(r.out) != r.max_new_tokens for r in fin):
            raise AssertionError(f"disagg_serving {label}: not every request finished")
        if bat.allocator.available != ecfg.num_pages - 1:
            raise AssertionError(f"disagg_serving {label}: pages leaked")
        if eng.compiled_signatures > ecfg.declared_signatures:
            raise AssertionError(f"disagg_serving {label}: {eng.compiled_signatures} "
                                 f"signatures > {ecfg.declared_signatures}")
        rep = tel.serving_report()
        out[label] = dict(streams={r.rid: r.out for r in fin},
                          tokens_per_s=sum(len(r.out) for r in fin) / wall,
                          ttft_p50_ms=rep["ttft_p50_ms"], ttft_p99_ms=rep["ttft_p99_ms"],
                          itl_p99_ms=rep["itl_p99_ms"], preemptions=rep["preemptions"],
                          signatures=eng.compiled_signatures,
                          declared=ecfg.declared_signatures, calls=eng.call_counts)
        del eng, bat
        torch.cuda.empty_cache()
    same = sum(out["disagg"]["streams"][r] == out["unified"]["streams"][r]
               for r in out["unified"]["streams"])
    line("disagg_serving", requests=N_REQUESTS, streams_identical=same,
         **{f"{k}_{f}": (json.dumps(v[f]) if isinstance(v[f], dict) else v[f])
            for k, v in out.items() for f in v if f != "streams"})


def serve_driver_phase(infer, driver, params, cfg, tmp):
    """The port driver's ``serve()`` (the asyncio open loop with the armed
    flight recorder) on the flagship engine, with ``ServingTelemetry`` and
    the prefix cache, over an open-loop prefix trace: the report's
    histograms filled, p99 finite, its tokens the finished requests' and no
    flight file written. Then ``fail_after_steps=3``: the loop raises, and
    the dump it wrote holds the JAX schema's keys and the scheduler rows."""
    ecfg = infer.EngineConfig(**{**ENGINE, "num_pages": SERVE_PAGES})
    eng = infer.InferenceEngine(params, cfg, ecfg)
    trace = driver.synthetic_trace(24, 40.0, seed=3, vocab=cfg.vocab_size,
                                   **PREFIX_TRACE)
    tel = infer.ServingTelemetry()
    path = os.path.join(tmp, "flight.json")
    fin = driver.serve(trace, eng, flight_path=path, telemetry=tel, prefix_cache=True)
    rep = tel.serving_report()
    if len(fin) != len(trace) or rep["finished"] != len(trace):
        raise AssertionError("serve_driver: not every request finished")
    if not (tel.ttft.count == tel.e2e.count == len(trace) and tel.itl.count > 0):
        raise AssertionError(f"serve_driver: histograms {tel.ttft.count}/"
                             f"{tel.itl.count}/{tel.e2e.count}")
    if not all(np.isfinite(rep[k]) for k in ("ttft_p99_ms", "itl_p99_ms", "e2e_p99_ms")):
        raise AssertionError("serve_driver: a p99 is not finite")
    if rep["tokens_delivered"] != sum(len(r.out) for r in fin):
        raise AssertionError("serve_driver: report tokens differ from the requests'")
    if os.path.exists(path):
        raise AssertionError("serve_driver: a clean run wrote a flight dump")
    eng.reset_cache()
    crash = driver.synthetic_trace(8, 40.0, seed=4, vocab=cfg.vocab_size)
    try:
        driver.serve(crash, eng, flight_path=path, fail_after_steps=3)
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    else:
        raise AssertionError("serve_driver: fail_after_steps=3 did not raise")
    with open(path) as f:
        dump = json.load(f)
    schema = {"reason", "created_unix", "capacity", "last_checkpoint", "n_snapshots",
              "snapshots", "loss_scale_trajectory", "last_health", "dispatch_summary",
              "comms_summary", "compile_summary", "probe_failures"}
    if set(dump) != schema or dump["reason"] != "exception:RuntimeError":
        raise AssertionError(f"serve_driver: dump keys {sorted(dump)}, reason "
                             f"{dump.get('reason')}")
    if dump["n_snapshots"] != 3 or set(dump["snapshots"][-1]["metrics"]) != {
            "active", "waiting", "finished", "free_pages", "tokens_out"}:
        raise AssertionError("serve_driver: the dump lacks the scheduler rows")
    line("serve_driver", requests=len(fin), tokens=rep["tokens_delivered"],
         tokens_per_s=rep["tokens_per_s"], ttft_p50_ms=rep["ttft_p50_ms"],
         ttft_p99_ms=rep["ttft_p99_ms"], itl_p99_ms=rep["itl_p99_ms"],
         e2e_p99_ms=rep["e2e_p99_ms"], quantile_error_bound=rep["quantile_error_bound"],
         prefix_hit_rate=rep["prefix_hit_rate"], preemptions=rep["preemptions"],
         crash_dump_reason=dump["reason"], crash_dump_snapshots=dump["n_snapshots"])
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------- slice 15: tensor + pipeline parallel
# BASELINE config 5, apex.transformer's tensor + pipeline parallel GPT, driven
# as a Megatron user script drives it. The card has one H100 and NCCL refuses
# two ranks on one device, so what runs where is fixed here:
# * tp_layers_world1 and gpt_tp_pp_world1: NCCL at world 1 (tensor 1 x pipe
#   1): every collective and ring of the TP/SP mappings and the schedules
#   runs, over one rank;
# * gpt_tp2_card: two spawned ranks on the one card over gloo on CUDA tensors,
#   tensor parallel 2, pipe 1, sequence parallel off and on: this PyTorch's
#   gloo takes CUDA tensors for all-reduce (sum and max), broadcast,
#   all-gather and reduce-scatter (a two-rank probe on the card), which is
#   every collective of the TP and SP regions, the vocab-parallel embedding
#   and cross entropy and the overflow flag; its point-to-point send of a
#   CUDA tensor kills the process (gloo's TCP pair: "writev ... Bad
#   address"), so a pipe of more than one rank runs across ranks in the CPU
#   tests only.
TP_MICRO = 4  # microbatches of TRAIN_BATCH // TP_MICRO in the world-1 steps
TP_TIMED_STEPS = 3  # the world-1 TP x PP runs' timed steps
# ROADMAP A29's cut: one step a run (the ranks' checks hold after it)
TP_TWO_RANK_STEPS = 1
TP_TWO_RANK_TIMEOUT = 600
# the O5 step over TP x PP against the one-device O5 step. At one microbatch
# only the cross entropy's formula differs: the loss agrees to 1e-5 (at world
# 1 it is bitwise), but the logits' gradient parts by fp32 rounding (~1e-7),
# and the bf16 backward then rounds its cotangents at other places, one bf16
# rounding (2^-8) spread over every gradient, about 2^-8 / sqrt(3) in
# relative L2 (a CPU rehearsal of this phase at 2 layers read 2.3e-3 on the
# bf16 arena, and 2e-5 on the fp32-only leaves; the card at full width,
# through K2/K4's bf16 products, 6.2e-3); so 2^-6, not the 1e-4 of the
# BERT-xent vs pretrain_loss row, whose two losses give the same logits
# gradient to the bit. At TP_MICRO microbatches the gradient sums run in
# another order, and at TP 2 in two ranks' halves: the O5 row
TP_M1_BOUNDS = dict(loss_rel_err=1e-5, grad_rel_l2=2 ** -6,
                    master_max_abs_err=2 * LR + 1e-6)
# lamb_tensor_sharded_check: masters of two FusedLAMB steps with and without
# the tensor-sharded mask at world 1, in units of 2^-24 (|master| + lr)
LAMB_SHARDED_ULPS = 8.0
TP_M4_BOUNDS = dict(loss_rel_err=5e-3, grad_rel_l2=0.05, master_max_abs_err=2 * LR + 1e-6)
TP_REPLICATED = ("pos_embed", "lnf_scale", "lnf_bias")
TP_REPLICATED_BLOCKS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "bo", "bo2")


def tp_pp_trainer(amp, gpt, fused_adam, shard, cfg, M, schedule, impl=None,
                  dropout=False, remat=None):
    """The flagship's amp O5 step over this rank's (tensor, pipe) shard, as
    a Megatron user script builds it from the port's public functions:
    ``amp.initialize(..., "O5", arena_native=True)`` on the shard, FusedAdam
    on its arenas, the batch split into M microbatches through
    ``forward_backward_no_pipelining`` (``schedule="none"``) or the 1F1B
    engine (the embedding on the first stage, the final LayerNorm and the
    head on the last; the tied embedding's embed and head gradients, both
    pipe-all-reduced, summed), the loss scaled by the dynamic scale, K5's
    unscale and its overflow flag reduced over the tensor and pipe groups.
    With ``dropout`` (``schedule="none"``) the forward drops under the key
    :func:`scaled_step` derives, DROPOUT_SEED's folded with the optimizer's
    step count, so a step draws the one-device step's masks.
    ``(m, state, step)``; ``step(tokens, targets)`` returns ``(loss, fp32
    grads, found_inf)``, with no host sync."""
    from beforeholiday_tpu_torch.parallel import parallel_state
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import fold_in
    from beforeholiday_tpu_torch.transformer import pipeline_parallel as pp
    from beforeholiday_tpu_torch.transformer import reduce_found_inf
    from beforeholiday_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy,
    )

    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl)
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), shard,
                       fused_adam(lr=LR, impl=impl), "O5", arena_native=True)
    state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init()}

    def step(tokens, targets):
        B, S = tokens.shape
        toks, tgts = tokens.reshape(M, B // M, S), targets.reshape(M, B // M, S)
        scale = state["scaler"]["scale"]
        tree = m.params.unpack()  # views of the arenas
        blocks = {"blocks": {k: v.unbind(0) for k, v in tree["blocks"].items()}}
        rest = {k: v for k, v in tree.items() if k != "blocks"}

        def loss_fn(logits, tgt):
            return m.scaler.scale_loss(vocab_parallel_cross_entropy(
                logits, tgt, cfg.vocab_size).mean(), state["scaler"])

        if schedule == "none":
            key = (fold_in(flash_key(), state["opt"]["inner"][0]["step"])
                   if dropout else None)
            loss, g = pp.forward_backward_no_pipelining(
                lambda p, t: gpt.forward(p, t, cfg, dropout_key=key), loss_fn,
                {**blocks, **rest}, toks, tgts, remat_policy=remat)
        else:
            tp = parallel_state.get_tensor_model_parallel_world_size()
            shape = ((S // tp, B // M, cfg.d_model) if cfg.sequence_parallel
                     else (B // M, S, cfg.d_model))
            loss, pg = pp.forward_backward_pipelining_without_interleaving(
                lambda sp, x: gpt.blocks(sp, x, cfg), loss_fn, blocks, toks, tgts,
                embed_fn=lambda ep, t: gpt.embed(ep, t, cfg),
                embed_params={k: rest[k] for k in ("tok_embed", "pos_embed")},
                head_fn=lambda hp, h: gpt.head(hp, h, cfg),
                head_params={k: rest[k] for k in ("tok_embed", "lnf_scale", "lnf_bias")},
                tensor_shape=shape, dtype=cfg.dtype, remat_policy=remat)
            g = {**pg.stage, "pos_embed": pg.embed["pos_embed"],
                 "tok_embed": pg.embed["tok_embed"] + pg.head["tok_embed"],
                 "lnf_scale": pg.head["lnf_scale"], "lnf_bias": pg.head["lnf_bias"]}
        grads = m.params.zeros_like()
        views = grads.unpack()
        for k, v in g.items():
            if k == "blocks":
                for name, per_layer in v.items():
                    for i, gi in enumerate(per_layer):
                        views["blocks"][name][i].copy_(gi)
            else:
                views[k].copy_(v)
        grads, found = m.scaler.unscale(grads, state["scaler"], impl=impl)
        found = reduce_found_inf(found)
        state["scaler"] = m.scaler.update(state["scaler"], found)
        m.params, state["opt"] = m.optimizer.step(m.params, grads, state["opt"],
                                                  found_inf=found)
        return loss / scale, grads, found

    return m, state, step


def step_result(m, state, res):
    """One step's (loss, fp32 grad arenas, masters) on the host."""
    loss, g, fi = res
    torch.cuda.synchronize()
    if bool(fi):
        raise AssertionError("found_inf set")
    return dict(loss=loss.item(), grads=[a.to("cpu", copy=True) for a in g.arenas],
                masters=[a.to("cpu", copy=True) for a in state["opt"]["master"]])


def step_errors(got, ref):
    """``got`` against ``ref`` (step_result dicts): loss relative error, the
    grad arenas' worst relative L2, the masters' largest difference."""
    return dict(
        loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_rel_l2=max(float((a - b).norm() / b.norm())
                        for a, b in zip(got["grads"], ref["grads"])),
        master_max_abs_err=max(max_err(a, b)
                               for a, b in zip(got["masters"], ref["masters"])))


def tp_layers_world1_phase(norm, xent):
    """At world 1 over NCCL, at the flagship's shapes (16 x 1024 tokens,
    d_model 1024, vocab 32000, bf16): every mapping forward and backward,
    ``column_parallel_linear`` (plain, ``gather_output``, sequence
    parallel), ``row_parallel_linear`` (plain, input not parallel, sequence
    parallel), ``vocab_parallel_embedding`` and ``sp_fused_layer_norm`` (K1
    forward, K3 backward) bitwise against their dense counterparts, outputs
    and gradients; ``vocab_parallel_cross_entropy`` at smoothing 0 and 0.1
    against K14's and K15's plain versions within K14's and K15's row
    bounds."""
    from beforeholiday_tpu_torch.ops.normalization import fused_layer_norm
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp
    from beforeholiday_tpu_torch.transformer.layers import sp_fused_layer_norm

    t0 = time.perf_counter()
    ps.initialize_model_parallel(1, 1)
    g = gen(150)
    D, V = MODEL["d_model"], MODEL["vocab_size"]
    x = torch.randn(TRAIN_BATCH, MODEL["seq_len"], D, generator=g, device="cuda").bfloat16()
    checks = {}

    def vjp(fn, primals, dy):
        ps_ = [p.detach().clone().requires_grad_(True) for p in primals]
        out = fn(*ps_)
        return out, torch.autograd.grad(out, ps_, dy)

    def same(name, fn, dense, primals):
        out, grads = vjp(fn, primals, dy_for(fn, primals))
        rout, rgrads = vjp(dense, primals, dy_for(fn, primals))
        checks[name] = bool(torch.equal(out, rout) and all(
            torch.equal(a, b) for a, b in zip(grads, rgrads)))

    cot = {}

    def dy_for(fn, primals):
        key = (fn, tuple(p.shape for p in primals))
        if key not in cot:
            with torch.no_grad():
                shape = fn(*primals).shape
            cot[key] = torch.randn(shape, generator=g, device="cuda").bfloat16()
        return cot[key]

    ident = lambda t: t * 1  # noqa: E731 - the dense counterpart of a region at world 1
    for name, fn in (("copy", tp.copy_to_tensor_model_parallel_region),
                     ("reduce", tp.reduce_from_tensor_model_parallel_region),
                     ("scatter", tp.scatter_to_tensor_model_parallel_region),
                     ("gather", tp.gather_from_tensor_model_parallel_region),
                     ("sp_scatter", tp.scatter_to_sequence_parallel_region),
                     ("sp_gather", tp.gather_from_sequence_parallel_region),
                     ("sp_reduce_scatter", tp.reduce_scatter_to_sequence_parallel_region)):
        same(name, fn, ident, [x])
    w = (0.02 * torch.randn(D, 3 * D, generator=g, device="cuda")).bfloat16()
    b = (0.1 * torch.randn(3 * D, generator=g, device="cuda")).bfloat16()
    wo = (0.02 * torch.randn(D, D, generator=g, device="cuda")).bfloat16()
    bo = (0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    dense = lambda x_, w_, b_: x_ @ w_ + b_  # noqa: E731 - two roundings, as JAX writes it
    xs = x.transpose(0, 1).contiguous()  # (S, B, D) for sequence parallel
    same("column", lambda *a: tp.column_parallel_linear(*a), dense, [x, w, b])
    same("column_gather", lambda *a: tp.column_parallel_linear(*a, gather_output=True),
         dense, [x, w, b])
    same("column_sp", lambda *a: tp.column_parallel_linear(*a, sequence_parallel=True),
         dense, [xs, w, b])
    same("row", lambda *a: tp.row_parallel_linear(*a), dense, [x, wo, bo])
    same("row_scatter", lambda *a: tp.row_parallel_linear(*a, input_is_parallel=False),
         dense, [x, wo, bo])
    same("row_sp", lambda *a: tp.row_parallel_linear(*a, sequence_parallel=True),
         dense, [xs, wo, bo])
    tokens = torch.randint(0, V, (TRAIN_BATCH, MODEL["seq_len"]), generator=g,
                           device="cuda")
    table = (0.02 * torch.randn(V, D, generator=g, device="cuda")).bfloat16()
    same("vocab_embedding", lambda t_: tp.vocab_parallel_embedding(
        tokens, t_, vocab_size=V), lambda t_: t_[tokens], [table])
    scale = (1 + 0.1 * torch.randn(D, generator=g, device="cuda"))
    bias = 0.1 * torch.randn(D, generator=g, device="cuda")
    sp_norm = lambda x_, s_, b_: sp_fused_layer_norm(  # noqa: E731
        x_, s_, b_, sequence_parallel=True)
    dy_for(sp_norm, [xs, scale, bias])
    before = norm.ln_fwd_kernel.launches, norm.ln_bwd_kernel.launches
    vjp(sp_norm, [xs, scale, bias], dy_for(sp_norm, [xs, scale, bias]))
    ln_launches = (norm.ln_fwd_kernel.launches - before[0],
                   norm.ln_bwd_kernel.launches - before[1])
    same("sp_layer_norm", sp_norm, lambda x_, s_, b_: fused_layer_norm(
        x_, s_, b_), [xs, scale, bias])
    # the vocab-parallel cross entropy against K14/K15's plain versions: the
    # same objective, its sums and exp in another order
    logits = 4 * torch.randn(TRAIN_BATCH * MODEL["seq_len"], V, generator=g,
                             device="cuda")
    labels = torch.randint(0, V, (logits.shape[0],), generator=g, device="cuda")
    dy = torch.rand(logits.shape[0], generator=g, device="cuda")
    ce_err = {}
    for s in (0.0, XENT_SMOOTHING):
        loss, (dx,) = vjp(lambda l_: tp.vocab_parallel_cross_entropy(l_, labels, V, s),
                          [logits], dy)
        rloss, rlse = xent.xent_fwd_torch(logits, labels, s)
        rdx = xent.xent_bwd_torch(logits, labels, rlse, dy, s)
        torch.cuda.synchronize()
        ce_err[s] = (check_xent_loss(f"tp_ce s={s}", loss, rlse, rloss, rlse),
                     check_vocab_ce_grad(f"tp_ce dx s={s}", dx, rdx, logits, rlse,
                                         dy, s))
        del loss, dx, rdx
    ps.destroy_model_parallel()
    bad = [k for k, v in checks.items() if not v]
    line("tp_layers_world1", backend="nccl", world=1, tensor=1, pipe=1,
         tokens=x.shape[0] * x.shape[1], d_model=D, vocab=V,
         bitwise=json.dumps(checks),
         sp_layer_norm_launches=f"K1 {ln_launches[0]}, K3 {ln_launches[1]}",
         vocab_ce_max_abs_err=json.dumps({str(k): v for k, v in ce_err.items()}),
         seconds=time.perf_counter() - t0)
    if bad or min(ln_launches) < 1:
        raise AssertionError(f"tp_layers_world1: not bitwise the dense counterparts: "
                             f"{bad}; LayerNorm launches {ln_launches}")
    del x, xs, logits
    torch.cuda.empty_cache()


def check_vocab_ce_grad(name, dx, ref, x, lse, dy, s):
    """K15's check (:func:`check_xent_grad`) plus what the two softmax forms
    part by: the vocab-parallel cross entropy takes ``exp(x - max) / sum``,
    K15's plain version ``exp(x - lse)``; each rounds its exponent's
    argument once, which moves p by up to ``|x - lse| 2^-24`` relative on
    each side, beyond K15's ``XENT_P_TOL`` once ``|x - lse|`` passes 16
    (where p is near s/V, ``p - s/V`` cancels)."""
    bad = 0
    for r in range(0, x.shape[0], 2048):  # row blocks: fp32 temporaries
        sl = slice(r, r + 2048)
        arg = x[sl].float() - lse[sl, None]
        p = torch.exp(arg)
        slack = XENT_P_TOL * (p + s / x.shape[1]) + p * arg.abs() * 2 ** -23
        bound = GRAD_RTOL[x.dtype] * ref[sl].float().abs() + dy[sl, None].abs() * slack
        bad += int(((dx[sl].float() - ref[sl].float()).abs() > bound).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {dx.numel()} elements out of "
                             f"tolerance")
    return max_err(dx, ref)


def dense_reference_steps(amp, gpt, fused_adam, params, cfg, batches):
    """The one-device O5 step (``make_gpt_trainer``, the kernels) from
    ``params`` on each batch: its step_result. Runs before model
    parallelism is initialized, so the GPT is the dense one."""
    out = []
    for batch in batches:
        m, state, step = make_gpt_trainer(amp, gpt, fused_adam, params, cfg)
        out.append(step_result(m, state, step(*batch)))
        del m, state, step
        torch.cuda.empty_cache()
    return out


def gpt_tp_pp_world1_phase(amp, gpt, fused_adam, cfg, counters, card, params,
                           refs, batches):
    """The flagship O5 step through the TP forward at tensor 1 x pipe 1
    over NCCL: under ``forward_backward_no_pipelining`` and the 1F1B engine
    at S = 1. One microbatch at batch 2 against the one-device O5 step
    (TP_M1_BOUNDS), TP_MICRO microbatches of 4 at batch 16 against it
    (TP_M4_BOUNDS); then each schedule's timed and profiled run at batch
    16, TP_MICRO microbatches, beside the one-device O5 step's median from
    this run. Returns the timed runs' launch counts."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    ps.initialize_model_parallel(1, 1)
    shard = gpt.shard_params(params, cfg, 0, 1)
    errs, launches = {}, {}
    try:
        for schedule in ("none", "1f1b"):
            for M, batch, ref, bounds in ((1, batches[0], refs[0], TP_M1_BOUNDS),
                                          (TP_MICRO, batches[1], refs[1], TP_M4_BOUNDS)):
                m, state, step = tp_pp_trainer(amp, gpt, fused_adam, shard, cfg, M,
                                               schedule)
                e = step_errors(step_result(m, state, step(*batch)), ref)
                errs[f"{schedule} M={M}"] = e
                del m, state, step
                torch.cuda.empty_cache()
                if out_of_bounds(e, bounds):
                    raise AssertionError(f"gpt_tp_pp_world1 {schedule} M={M}: "
                                         f"{out_of_bounds(e, bounds)}")
        line("gpt_tp_pp_world1", backend="nccl", tensor=1, pipe=1,
             errors=json.dumps(errs), m1_bounds=json.dumps(TP_M1_BOUNDS),
             m4_bounds=json.dumps(TP_M4_BOUNDS))
        for schedule in ("none", "1f1b"):
            m, _, step = tp_pp_trainer(amp, gpt, fused_adam, shard, cfg, TP_MICRO,
                                       schedule)
            key = f"gpt_tp_pp_{schedule}"
            # A29's time budget: 3 timed steps each, only 1F1B profiled
            launches[key] = training_phase(
                f"{key}_training", f"{key}_profile", step, batches[1], counters,
                STEP_LAUNCHES[key], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
                ranges=None if schedule == "none" else pp_slot_ranges,
                timed_steps=TP_TIMED_STEPS, profile=schedule != "none",
                schedule=f"'{'forward_backward_no_pipelining' if schedule == 'none' else '1F1B, S 1'}'",
                micro_batches=TP_MICRO, tensor=1, pipe=1,
                one_device_o5_median_ms=MEDIANS.get("training"), **lm_work(m, batches[1]))
            del m, step
            torch.cuda.empty_cache()
    finally:
        ps.destroy_model_parallel()
    return launches


def pp_slot_ranges():
    """The 1F1B engine's spans (``schedules.py``: each tick's forward and
    backward slots and its ring exchange), as profiler ranges: their
    kernels' device ms, and not their spans', in the profile."""
    return contextlib.nullcontext(("pp_forward_slot", "pp_backward_slot",
                                   "pp_p2p_rings"))


# (run, sequence parallel, dropout at DROPOUT's rates)
TP2_RUNS = (("tp2", False, False), ("tp2_sp", True, False),
            ("tp2_dropout", False, True), ("tp2_sp_dropout", True, True))


def tp2_worker(rank, store, out_dir):
    """One rank of the two-rank TP check (a spawned process): gloo on CUDA
    tensors, tensor parallel 2, pipe 1, the flagship from the parent's
    seeded weights; for each run of TP2_RUNS (sequence parallel off, on;
    without and with dropout), TP_TWO_RANK_STEPS O5 steps at batch 16 (one
    microbatch,
    ``forward_backward_no_pipelining``) with the launch counts read. Saves
    each step's loss, overflow flag and replicated masters, and step 1's
    grads and masters (trees), on the host."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        from beforeholiday_tpu_torch import amp
        from beforeholiday_tpu_torch.contrib import xentropy as xent
        from beforeholiday_tpu_torch.ops import attention as attn
        from beforeholiday_tpu_torch.ops import multi_tensor as mt
        from beforeholiday_tpu_torch.ops import normalization as norm
        from beforeholiday_tpu_torch.ops import softmax as sm
        from beforeholiday_tpu_torch.ops.arena import tree_map
        from beforeholiday_tpu_torch.optimizers import FusedAdam
        from beforeholiday_tpu_torch.parallel import parallel_state as ps
        from beforeholiday_tpu_torch.testing import gpt

        def host(t):
            return t.to("cpu", copy=True)

        ps.initialize_model_parallel(2, 1)
        params = gpt.init(gpt.GPTConfig(**MODEL), gen(0), device="cuda")
        counters = launch_counters(norm, attn, mt, sm, xent)
        out = {}
        for run, sp, drop in TP2_RUNS:
            cfg = gpt.GPTConfig(**MODEL, **(DROPOUT if drop else {}),
                                sequence_parallel=sp)
            shard = gpt.shard_params(params, cfg, ps.get_tensor_model_parallel_rank(), 2)
            batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70),
                                        device="cuda")
            m, state, step = tp_pp_trainer(amp, gpt, FusedAdam, shard, cfg, 1, "none",
                                           dropout=drop)
            for fn in counters.values():
                fn.launches = 0
            res = {"steps": []}
            t0 = time.perf_counter()
            for i in range(TP_TWO_RANK_STEPS):
                loss, g, fi = step(*batch)
                masters = m.params.replace_arenas(state["opt"]["master"]).unpack()
                # host copies: the next step updates the arenas in place
                rec = dict(loss=loss.item(), found_inf=bool(fi),
                           replicated={k: host(masters[k]) for k in TP_REPLICATED},
                           replicated_blocks={k: host(masters["blocks"][k])
                                              for k in TP_REPLICATED_BLOCKS})
                if i == 0:
                    rec["grads"] = tree_map(host, g.unpack())
                    rec["masters"] = tree_map(host, masters)
                res["steps"].append(rec)
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = {k: fn.launches for k, fn in counters.items()}
            out[run] = res
            del m, state, step, shard, g, masters
            torch.cuda.empty_cache()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(out, f"{out_dir}/tp2_rank{rank}.pt")
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/tp2_rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def gpt_tp2_card_phase(gpt, cfg, layout, refs, tmp):
    """Two processes on the one card, gloo on CUDA tensors (NCCL refuses two
    ranks on one device; gloo stages every collective through the host, so
    the phase's time is a correctness run's, not a speed): the full-width
    flagship at tensor parallel 2, pipe 1, sequence parallel off and on,
    without and with dropout (DROPOUT's rates, each rank drawing its part
    of the one-device masks through the rank places of K2, K4 and K13),
    TP_TWO_RANK_STEPS O5 steps each at batch 16. Each run's reassembled
    step-1 loss, grads and
    masters against the one-device O5 step (``refs[dropout]``, with dropout
    at the same key) at TP_M4_BOUNDS (``layout``: its arenas' layout); the
    overflow flags and losses equal on both ranks; the replicated leaves'
    masters bitwise equal across the ranks after each step. Returns rank
    0's launch counts, by run."""
    import multiprocessing as mp
    from beforeholiday_tpu_torch.ops.arena import tree_flatten, unflatten

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp2_worker, args=(r, f"{tmp}/tp2_store", tmp))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, TP_TWO_RANK_TIMEOUT - (time.perf_counter() - t0)))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join(10)
        raise AssertionError(f"gpt_tp2_card: the world did not finish in "
                             f"{TP_TWO_RANK_TIMEOUT} s; its processes were killed")
    if any(p.exitcode != 0 for p in procs):
        errors = [open(f"{tmp}/tp2_rank{r}.err").read() for r in range(2)
                  if os.path.exists(f"{tmp}/tp2_rank{r}.err")]
        raise AssertionError(f"gpt_tp2_card: exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    seconds = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/tp2_rank{r}.pt") for r in range(2)]
    wants = {}
    for drop, ref in refs.items():
        wants[drop] = dict(loss=ref["loss"])
        for key in ("grads", "masters"):
            wants[drop][key] = [torch.cat([t.reshape(-1) for t in unflatten(arena, spec)])
                                for arena, spec in zip(ref[key], layout.specs)]
    fields, failures, launches = {}, [], {}
    for run, sp, drop in TP2_RUNS:
        want = wants[drop]
        expect = STEP_LAUNCHES["gpt_dropout" if drop else "gpt"]
        a, b = ranks[0][run], ranks[1][run]
        flags_equal = all(x["found_inf"] == y["found_inf"] is False
                          for x, y in zip(a["steps"], b["steps"]))
        losses_equal = all(x["loss"] == y["loss"] for x, y in zip(a["steps"], b["steps"]))
        replicated_bitwise = all(
            all(torch.equal(x[kind][k], y[kind][k]) for k in x[kind])
            for x, y in zip(a["steps"], b["steps"])
            for kind in ("replicated", "replicated_blocks"))
        # the reassembled trees as the one-device step's arenas hold them:
        # each bucket's leaves, in its order, end to end (padding left out)
        got = dict(loss=a["steps"][0]["loss"])
        for key in ("grads", "masters"):
            leaves = tree_flatten(gpt.unshard_params(
                [[a["steps"][0][key], b["steps"][0][key]]], cfg))[0]
            got[key] = [torch.cat([leaves[i].reshape(-1) for i in idx])
                        for idx in layout.indices]
        errs = step_errors(got, want)
        bad_launches = {k: v for k, v in a["launches"].items()
                        if k in expect and v != expect[k] * TP_TWO_RANK_STEPS}
        fields[run] = dict(sequence_parallel=sp, dropout=drop,
                           losses=[x["loss"] for x in a["steps"]], errors=errs,
                           found_inf_equal=flags_equal, losses_equal=losses_equal,
                           replicated_bitwise=replicated_bitwise,
                           rank_seconds_per_step=a["seconds"] / TP_TWO_RANK_STEPS,
                           launches_per_step={k: v // TP_TWO_RANK_STEPS
                                              for k, v in a["launches"].items() if v})
        if not (flags_equal and replicated_bitwise and losses_equal) or bad_launches \
                or out_of_bounds(errs, TP_M4_BOUNDS):
            failures.append(
                f"{run}: flags equal {flags_equal}, replicated bitwise "
                f"{replicated_bitwise}, losses equal {losses_equal}, launches "
                f"{bad_launches}, out of bounds {out_of_bounds(errs, TP_M4_BOUNDS)}")
        launches[run] = a["launches"]
    line("gpt_tp2_card", backend="gloo", world=2, device="'one card'", tensor=2,
         pipe=1, batch=TRAIN_BATCH, micro_batches=1, steps=TP_TWO_RANK_STEPS,
         note="'gloo stages every collective through the host: a correctness run, "
              "not a speed'",
         one_rank_loss=refs[False]["loss"], one_rank_dropout_loss=refs[True]["loss"],
         bounds=json.dumps(TP_M4_BOUNDS),
         rank_peak_mem_gb=ranks[0]["peak_mem_gb"], seconds=seconds,
         **{k: json.dumps(v) for k, v in fields.items()})
    if failures:
        raise AssertionError("gpt_tp2_card: " + "; ".join(failures))
    return launches


def tp_kernel_rows(norm, attn, mt, n_bf16):
    """K1/K3 at 8192 rows (a tensor rank's sequence half under sequence
    parallelism at TP 2), K2/K4 at BH 128 (8 local heads x 16, TP 2, one
    microbatch) and at BH 64 (16 heads x 4, a microbatch of the world-1
    steps), K1/K3 at 4096 rows (a world-1 microbatch), K5/K6 at a TP 2
    shard's bf16 arena (``n_bf16`` elements): each against its plain version, timed beside its
    bound and library call. Returns rows to merge, keyed by kernel."""
    g = gen(160)
    rows = {k: {} for k in ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                            "flash_bwd", "unscale", "adam")}
    for n_rows, key in ((8192, "tp2_sp"), (4096, "tp_world1")):
        x = (torch.randn(n_rows, 1024, generator=g, device="cuda") * 2 + .5).bfloat16()
        w = 1 + .1 * torch.randn(1024, generator=g, device="cuda")
        b = .1 * torch.randn(1024, generator=g, device="cuda")
        dy = torch.randn(n_rows, 1024, generator=g, device="cuda").bfloat16()
        args = (x, w, b, 1e-5, False, torch.bfloat16)
        err = check_close(f"K1 {n_rows}", norm.ln_fwd_kernel(*args),
                          norm.ln_fwd_torch(*args), BF16_TOL)
        bms, by = bound_ms(2 * x.numel() * 2 + 2 * 1024 * 4, 8 * x.numel(), torch.float32)
        wl, bl = w.bfloat16(), b.bfloat16()
        rows["layer_norm_fwd"][key] = (f"{n_rows}x1024 bfloat16, fp32 w", dict(
            max_abs_err=err, ms=time_ms(lambda: norm.ln_fwd_kernel(*args)),
            plain_ms=time_ms(lambda: norm.ln_fwd_torch(*args)),
            library_ms=time_ms(lambda: F.layer_norm(x, (1024,), wl, bl, 1e-5)),
            bound_ms=bms, bound_by=by))
        bargs = (x, w, dy, 1e-5, False)
        dx, dw, db = norm.ln_bwd_kernel(*bargs, True)
        rdx, rdw, rdb = norm.ln_bwd_torch(*bargs)
        err = check_close(f"K3 dx {n_rows}", dx, rdx, BF16_TOL)
        check_close(f"K3 dw {n_rows}", dw.float(), rdw, dict(rtol=1e-4, atol=1e-3))
        bms, by = bound_ms(3 * x.numel() * 2 + 3 * 1024 * 4, 11 * x.numel(),
                           torch.float32)
        xl = x.clone().requires_grad_(True)
        wl = w.bfloat16().requires_grad_(True)
        bl = b.bfloat16().requires_grad_(True)
        rows["layer_norm_bwd"][key] = (f"{n_rows}x1024 bfloat16/w float32", dict(
            max_abs_err=err, ms=time_ms(lambda: norm.ln_bwd_kernel(*bargs, True)),
            plain_ms=time_ms(lambda: norm.ln_bwd_torch(*bargs)),
            library_ms=grad_ms(lambda: F.layer_norm(xl, (1024,), wl, bl, 1e-5),
                               (xl, wl, bl), dy),
            bound_ms=bms, bound_by=by))
        if key == "tp_world1":
            for k in ("layer_norm_fwd", "layer_norm_bwd"):
                rows[k][key][1]["path"] = "gpt_tp_pp_1f1b"
        del x, dy, dx, rdx, xl
    for BH, B, key in ((128, TRAIN_BATCH, "tp2"), (64, TRAIN_BATCH // TP_MICRO,
                                                   "tp_world1")):
        S, D = MODEL["seq_len"], 64
        q, k, v = (torch.randn(BH, S, D, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        lens = torch.full((BH,), S, dtype=torch.int32, device="cuda")
        fargs = (q, k, v, lens, True, D ** -0.5)
        o, lse = attn.flash_fwd_kernel(*fargs)
        ro, rlse = attn.flash_fwd_torch(*fargs)
        ref_abs = attn.flash_fwd_torch(q.float(), k.float(), v.float().abs(), *fargs[3:])[0]
        err = check_dropped_pv(f"K2 BH{BH}", o, ro, ref_abs)
        check_close(f"K2 lse BH{BH}", lse, rlse, dict(rtol=1e-5, atol=1e-4))
        del ref_abs
        flops, nbytes = k2_flops_bytes(q, k, lens, True)
        bms, by = bound_ms(nbytes, flops, torch.bfloat16)
        ql, kl, vl = (t.reshape(B, BH // B, S, D) for t in (q, k, v))
        tag = f"BH{BH} S{S} D{D} causal bfloat16"
        rows["flash_fwd"][key] = (tag, dict(
            max_abs_err=err, ms=time_ms(lambda: attn.flash_fwd_kernel(*fargs)),
            plain_ms=time_ms(lambda: attn.flash_fwd_torch(*fargs), iters=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, scale=D ** -0.5)),
            bound_ms=bms, bound_by=by))
        do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
        bargs = (q, k, v, ro, do, rlse, None, lens, True, D ** -0.5)
        got, ref = attn.flash_bwd_kernel(*bargs), attn.flash_bwd_torch(*bargs)
        err = max(check_close(f"K4 {n} BH{BH}", a_, b_, dict(
            rtol=2e-2, atol=2e-2 * float(b_.float().abs().max())))
            for n, a_, b_ in zip(("dq", "dk", "dv"), got, ref))
        flops, nbytes = k4_flops_bytes(q, k, lens, True)
        bms, by = bound_ms(nbytes, flops, torch.bfloat16)
        qg, kg, vg = (t.reshape(B, BH // B, S, D).clone().requires_grad_(True)
                      for t in (q, k, v))
        rows["flash_bwd"][key] = (tag, dict(
            max_abs_err=err, ms=time_ms(lambda: attn.flash_bwd_kernel(*bargs)),
            plain_ms=time_ms(lambda: attn.flash_bwd_torch(*bargs), iters=5),
            library_ms=grad_ms(lambda: F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True), (qg, kg, vg), do.reshape(B, BH // B, S, D)),
            bound_ms=bms, bound_by=by))
        if key == "tp_world1":
            for kk in ("flash_fwd", "flash_bwd"):
                rows[kk][key][1]["path"] = "gpt_tp_pp_1f1b"
        del q, k, v, o, ro, got, ref, qg, kg, vg
        torch.cuda.empty_cache()
    # K5 / K6 at a TP 2 shard's arenas
    x = (1e-3 * torch.randn(n_bf16, generator=g, device="cuda")).bfloat16()
    inv = torch.full((), 1 / 1024, device="cuda")
    y, flag = mt.scale_kernel(x, inv, torch.float32)
    ry, _ = mt.scale_torch(x, inv, torch.float32)
    if not torch.equal(y, ry) or bool(flag):
        raise AssertionError("K5 at the TP 2 shard: differs from the plain version")
    bms, by = bound_ms(n_bf16 * 6, n_bf16, torch.float32)
    x32 = x.float()
    found, one = torch.zeros(1, device="cuda"), torch.ones(1, device="cuda")
    rows["unscale"]["tp2"] = (f"{n_bf16} bfloat16->float32 (TP 2 shard)", dict(
        max_abs_err=0.0, ms=time_ms(lambda: mt.scale_kernel(x, inv, torch.float32)),
        plain_ms=time_ms(lambda: mt.scale_torch(x, inv, torch.float32)),
        library_ms=time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
            [x32], found, one)),
        bound_ms=bms, bound_by=by))
    del x, y, ry, x32
    n = n_bf16
    grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
    st = (0.02 * torch.randn(n, generator=g, device="cuda"),
          1e-4 * torch.randn(n, generator=g, device="cuda"),
          1e-8 * torch.rand(n, generator=g, device="cuda"))
    step = torch.full((), 4, dtype=torch.int32, device="cuda")
    bc1, bc2 = mt._bias_corrections(True, step, 0.9, 0.999)
    no = torch.zeros((), dtype=torch.bool, device="cuda")
    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                 grad_scale=1.0, bc1=bc1, bc2=bc2, adam_w_mode=True, found_inf=no)
    outs = []
    for fn in (mt.adam_kernel, mt.adam_torch):
        s_ = tuple(t.clone() for t in st)
        cp = s_[0].bfloat16()
        fn(grad, *s_, copy_out=cp, **hyper)
        outs.append(s_)
    # the multi-tensor family's bound (PERF.md): where the update nearly
    # cancels p, Triton's division and square root part from PyTorch's by
    # more than K6's seeded check's atol of 1e-10
    err = max(check_close("K6 TP 2 shard", a_, b_,
                          dict(rtol=1e-6, atol=1e-6 * float(b_.abs().max())))
              for a_, b_ in zip(*outs))
    cp = st[0].bfloat16()
    steps = [torch.full((), 4.0, device="cuda")]
    bms, by = bound_ms(n * 30, 20 * n, torch.float32)
    rows["adam"]["tp2"] = (f"{n} adamw copy bfloat16 (TP 2 shard)", dict(
        max_abs_err=err, ms=time_ms(lambda: mt.adam_kernel(grad, *st, copy_out=cp, **hyper)),
        plain_ms=time_ms(lambda: mt.adam_torch(grad, *st, copy_out=cp, **hyper), iters=5),
        library_ms=time_ms(lambda: torch._fused_adamw_(
            [st[0]], [grad], [st[1]], [st[2]], [], steps, lr=LR, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)),
        bound_ms=bms, bound_by=by))
    for kname, r in rows.items():
        for key, (tag, f) in r.items():
            line(f"tp_shape {kname}", shape=tag, **{k: v for k, v in f.items()
                                                  if k != "path"})
    del grad, st, outs
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- slice 17
# the rest of apex.transformer: rank places of the dropout masks, context
# parallelism (ring attention), the collective matmul, BERT over TP

# the flagship's attention width at long context, a context group of 8
RING = dict(B=1, H=16, S=16384, D=64, cp=8)
RING_SMALL_S = 2048  # the fp32 ring against the plain ring
# the bf16 ring against one whole-sequence launch (PERF.md): each hop's o
# is rounded to bf16 (2^-9 of sum over its keys of p|v|) and K2 rounds each
# p to bf16 for p.v, as the one launch does on other values (2^-9 of sum
# p|v| each side), and the merged o is rounded once more (2^-9 |o|): so
# |o - ref| <= 2^-7 |ref| + 2^-7 sum p|v|, twice those. The gradients: K4's
# bf16 row (rtol 2e-2, atol 2e-2 max|ref|) for each of the cp contributions
# to dq (its hops) and to dk, dv (its chunk's hops on every rank), each
# rounded to bf16 and summed in bf16 (2 cp - 1 roundings of 2^-9 of the
# contributions' magnitudes, 0.029 at cp 8): rtol and atol 0.05
RING_GRAD_TOL = 0.05


def emulated_ring(cpar, q, k, v, cp, causal, scale, impl=None):
    """The cp-rank ring of ``ring_attention``'s flash path on one device:
    for each rank r, ``context_parallel._hop`` over the K/V chunks in the
    order r receives them (chunk ``(r - t) mod cp`` at step t; indexed here
    where the ring ppermutes them) merged by ``_merge_by_lse``. q, k, v
    (B, H, S, D) whole; returns the whole (B, H, S, D) output in q's dtype,
    differentiable through K2/K4 (or their plain versions, ``impl``)."""
    B, H, S, D = q.shape
    Sl = S // cp
    qc, kc, vc = ([c.reshape(B * H, Sl, D) for c in t.chunk(cp, dim=2)]
                  for t in (q, k, v))
    outs = []
    for r in range(cp):
        o, lse = cpar._hop(qc[r], kc[r], vc[r], causal_hop=causal, kv_len=Sl,
                           scale=scale, impl=impl)
        for t in range(1, cp):
            src = (r - t) % cp
            o_t, lse_t = cpar._hop(qc[r], kc[src], vc[src], causal_hop=False,
                                   kv_len=Sl if not causal or src < r else 0,
                                   scale=scale, impl=impl)
            o, lse = cpar._merge_by_lse(o, lse, o_t, lse_t)
        outs.append(torch.where((lse > cpar._NEG / 2)[..., None], o, 0.0))
    return torch.stack(outs, 1).reshape(B, H, S, D).to(q.dtype)


def check_ring_grad(name, got, ref):
    tol = RING_GRAD_TOL
    return check_close(name, got, ref, dict(rtol=tol, atol=tol * float(ref.float().abs().max())))


def ring_phase(attn, cpar):
    """Ring attention as a context group of RING["cp"] ranks runs it,
    emulated rank by rank on the one card at the flagship's heads at long
    context (B 1, H 16, S 16384, D 64, bf16, causal; S_local 2048): the
    forward and the gradients of sum(o w) through K2 hops and K4 with the
    merge's dlse, the launches counted, against one whole-sequence K2/K4
    launch (RING_GRAD_TOL, and the forward's per-element bound); at S 2048
    in fp32 the kernels' ring against the plain versions' ring at K2's and
    K4's fp32 rows. Then the hops' and K4-with-dlse's timed rows. Returns
    rows to merge, keyed by kernel."""
    g = gen(170)
    B, H, S, D, cp = (RING[k] for k in ("B", "H", "S", "D", "cp"))
    scale = D ** -0.5
    q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    w = torch.randn(B, H, S, D, generator=g, device="cuda").bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attn.flash_fwd_kernel.launches = attn.flash_bwd_kernel.launches = 0
    o = emulated_ring(cpar, *leaves, cp, True, scale, impl="kernel")
    grads = torch.autograd.grad((o.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    launches = (attn.flash_fwd_kernel.launches, attn.flash_bwd_kernel.launches)
    if launches != (cp * cp, cp * cp):
        raise AssertionError(f"ring: K2/K4 launches {launches}, expected {cp * cp} each")
    rleaves = [t.reshape(B * H, S, D).clone().requires_grad_(True) for t in (q, k, v)]
    ro, _ = attn.flash_attention_with_lse(*rleaves, causal=True, scale=scale)
    rgrads = torch.autograd.grad((ro.float() * w.reshape(B * H, S, D).float()).sum(),
                                 rleaves)
    lens = torch.full((B * H,), S, dtype=torch.int32, device="cuda")
    ref_abs = attn.flash_fwd_kernel(q.reshape(B * H, S, D).float(),
                                    k.reshape(B * H, S, D).float(),
                                    v.reshape(B * H, S, D).float().abs(), lens, True,
                                    scale)[0]
    ro = ro.reshape(B, H, S, D)
    bound = 2 ** -7 * ro.float().abs() + 2 ** -7 * ref_abs.reshape(B, H, S, D)
    err = (o.float() - ro.float()).abs()
    if (err > bound).any():
        raise AssertionError(f"ring bf16 forward: {int((err > bound).sum())} elements "
                             f"out of bound")
    errs = {"o": float(err.max()), "o_of_bound": float((err / bound).max())}
    for n, a_, b_ in zip("qkv", grads, rgrads):
        errs[f"d{n}"] = check_ring_grad(f"ring bf16 d{n}", a_, b_.reshape(a_.shape))
    del o, grads, ro, rgrads, ref_abs, bound, err, leaves, rleaves
    torch.cuda.empty_cache()
    # fp32 at a reduced S: the kernels' ring against the plain versions'
    Ss = RING_SMALL_S
    qs, ks, vs, ws = (torch.randn(B, H, Ss, D, generator=g, device="cuda")
                      for _ in range(4))
    small = {}
    for impl in ("kernel", "torch"):
        ls = [t.clone().requires_grad_(True) for t in (qs, ks, vs)]
        os_ = emulated_ring(cpar, *ls, cp, True, scale, impl=impl)
        small[impl] = (os_, torch.autograd.grad((os_ * ws).sum(), ls))
    errs["fp32_o"] = check_close("ring fp32 o", small["kernel"][0], small["torch"][0],
                                 FP32_TOL)
    for n, a_, b_ in zip("qkv", small["kernel"][1], small["torch"][1]):
        errs[f"fp32_d{n}"] = check_close(f"ring fp32 d{n}", a_, b_,
                                         dict(rtol=1e-5, atol=1e-4))
    del small
    line("ring_attention", shape=f"'B{B} H{H} S{S} D{D} bfloat16 causal, cp {cp}'",
         k2_launches=launches[0], k4_launches=launches[1],
         grad_tol=RING_GRAD_TOL, max_abs_err=json.dumps(errs))
    # the timed rows: one hop of the ring's shape (BH 16, S_local 2048)
    Sl, BH = S // cp, B * H
    q3, k3, v3 = (torch.randn(BH, Sl, D, generator=g, device="cuda").bfloat16()
                  for _ in range(3))
    rows = {"flash_fwd": {}, "flash_bwd": {}}
    for key, n_keys in (("ring_full", Sl), ("ring_empty", 0)):
        lens = torch.full((BH,), n_keys, dtype=torch.int32, device="cuda")
        fargs = (q3, k3, v3, lens, False, scale)
        o3, lse3 = attn.flash_fwd_kernel(*fargs)
        ro3, rlse3 = attn.flash_fwd_torch(*fargs)
        if n_keys:
            ref_abs = attn.flash_fwd_torch(q3.float(), k3.float(), v3.float().abs(),
                                           *fargs[3:])[0]
            err = check_dropped_pv(f"K2 {key}", o3, ro3, ref_abs)
            check_close(f"K2 lse {key}", lse3, rlse3, dict(rtol=1e-5, atol=1e-4))
            flops, nbytes = k2_flops_bytes(q3, k3, lens, False)
            ql, kl, vl = (t.reshape(B, H, Sl, D) for t in (q3, k3, v3))
            library = time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, scale=scale))
        else:
            # no key: o is 0 and lse -1e30, exactly, with nothing read but
            # the lengths
            if not (torch.equal(o3, torch.zeros_like(o3))
                    and bool((lse3 == -1e30).all())):
                raise AssertionError("K2 ring_empty: not o = 0, lse = -1e30")
            err, flops = 0.0, 0
            nbytes = o3.numel() * o3.element_size() + lse3.numel() * 4 + BH * 4
            library = None  # attention over no keys is no library call's function
        bms, by = bound_ms(nbytes, flops, torch.bfloat16)
        rows["flash_fwd"][key] = (
            f"BH{BH} S{Sl} D{D} bfloat16, kv_lens {n_keys} (a ring hop)", dict(
                max_abs_err=err, ms=time_ms(lambda: attn.flash_fwd_kernel(*fargs)),
                plain_ms=time_ms(lambda: attn.flash_fwd_torch(*fargs), iters=5),
                library_ms=library, bound_ms=bms, bound_by=by, launches=launches[0]))
    lens = torch.full((BH,), Sl, dtype=torch.int32, device="cuda")
    o3, lse3 = attn.flash_fwd_torch(q3, k3, v3, lens, False, scale)
    do = torch.randn(o3.shape, generator=g, device="cuda").bfloat16()
    dlse = torch.randn(lse3.shape, generator=g, device="cuda")
    bargs = (q3, k3, v3, o3, do, lse3, dlse, lens, False, scale)
    got, ref = attn.flash_bwd_kernel(*bargs), attn.flash_bwd_torch(*bargs)
    err = max(check_close(f"K4 dlse {n}", a_, b_, dict(
        rtol=2e-2, atol=2e-2 * float(b_.float().abs().max())))
        for n, a_, b_ in zip(("dq", "dk", "dv"), got, ref))
    flops, nbytes = k4_flops_bytes(q3, k3, lens, False)
    bms, by = bound_ms(nbytes + dlse.numel() * 4, flops, torch.bfloat16)
    rows["flash_bwd"]["ring_dlse"] = (
        f"BH{BH} S{Sl} D{D} bfloat16, with dlse (the ring's merge)", dict(
            max_abs_err=err, ms=time_ms(lambda: attn.flash_bwd_kernel(*bargs)),
            plain_ms=time_ms(lambda: attn.flash_bwd_torch(*bargs), iters=5),
            library_ms=None, bound_ms=bms, bound_by=by, launches=launches[1]))
    for kname, r in rows.items():
        for key, (tag, f) in r.items():
            line(f"ring_row {kname}", shape=tag, **f)
    del q, k, v, w, q3, k3, v3, got, ref
    torch.cuda.empty_cache()
    return rows


def rank_place_phase(attn):
    """K2, K4 and K13 at each TP 2 rank's place, bitwise the one-device
    launch's slice at the flagship's shapes, dropout 0.1: K2/K4 over the
    rank's 8 of 16 heads (BH 128 of 256, S 1024, causal bf16), K13 over its
    heads' planes of the (256, 1024, 1024) probabilities and its rows of
    the (16, 1024, 1024) hidden states under sequence parallelism, K13 also
    bitwise its plain version at both places. Then the timed rows at the
    TP 2 runs' shapes. Returns rows to merge, keyed by kernel."""
    g = gen(180)
    key = flash_key()
    B, H, S, D, rate = TRAIN_BATCH, MODEL["n_heads"], MODEL["seq_len"], 64, 0.1
    hl, scale = H // 2, D ** -0.5
    q, k, v, do = (torch.randn(B * H, S, D, generator=g, device="cuda").bfloat16()
                   for _ in range(4))
    lens = torch.full((B * H,), S, dtype=torch.int32, device="cuda")
    o, lse = attn.flash_fwd_kernel(q, k, v, lens, True, scale, rate, key)
    grads = attn.flash_bwd_kernel(q, k, v, o, do, lse, None, lens, True, scale, rate, key)
    hidden = attn.dropout_keep_mask_kernel(key, (B, S, MODEL["d_model"]), rate)
    probs = attn.dropout_keep_mask_kernel(key, (B * H, S, S), rate)

    def heads(t, r):
        return t.reshape(B, H, *t.shape[1:])[:, r * hl:(r + 1) * hl].reshape(
            B * hl, *t.shape[1:]).contiguous()

    checks = {}
    for r in range(2):
        place = attn.RankPlace(hl, H, r * hl)
        qr, kr, vr, dor = (heads(t, r) for t in (q, k, v, do))
        lr = lens[:B * hl].contiguous()
        orr, lser = attn.flash_fwd_kernel(qr, kr, vr, lr, True, scale, rate, key, place)
        gr = attn.flash_bwd_kernel(qr, kr, vr, orr, dor, lser, None, lr, True, scale,
                                   rate, key, place)
        checks[f"K2 rank {r}"] = bool(torch.equal(orr, heads(o, r))
                                      and torch.equal(lser, heads(lse, r)))
        checks[f"K4 rank {r}"] = all(torch.equal(a_, heads(b_, r))
                                     for a_, b_ in zip(gr, grads))
        # K13 at the rank's heads and at its sequence-parallel rows: the
        # one-device launch's slice, and its plain version at the same place
        for what, shape_, place_, whole in (
                ("heads", (B * hl, S, S), place, heads(probs, r)),
                ("rows", (B, S // 2, MODEL["d_model"]), attn.RankPlace(1, 1, 0, r * S // 2),
                 hidden[:, r * S // 2:(r + 1) * S // 2])):
            mask = attn.dropout_keep_mask_kernel(key, shape_, rate, place_)
            plain = attn.dropout_keep_mask_torch(key, shape_, rate, place_)
            checks[f"K13 {what} rank {r}"] = bool(torch.equal(mask, whole))
            checks[f"K13 {what} rank {r} plain"] = bool(torch.equal(mask, plain))
            del mask, plain
    torch.cuda.synchronize()
    line("rank_place", shape=f"'B{B} H{H} S{S} D{D} causal bfloat16, rate {rate}, TP 2'",
         bitwise=json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"rank places: not the one-device slices: {checks}")
    del o, lse, grads, hidden, probs
    torch.cuda.empty_cache()
    # the timed rows: rank 1's place at the TP 2 runs' shapes
    place = attn.RankPlace(hl, H, hl)
    qr, kr, vr, dor = (heads(t, 1) for t in (q, k, v, do))
    lr = lens[:B * hl].contiguous()
    fargs = (qr, kr, vr, lr, True, scale, rate, key, place)
    o, lse = attn.flash_fwd_kernel(*fargs)
    ro, rlse = attn.flash_fwd_torch(*fargs)
    ref_abs = attn.flash_fwd_torch(qr.float(), kr.float(), vr.float().abs(), *fargs[3:])[0]
    err = check_dropped_pv("K2 place", o, ro, ref_abs)
    del ref_abs
    flops, nbytes = k2_flops_bytes(qr, kr, lr, True)
    int_ops = PHILOX_OPS_PER_ELEMENT * live_pairs(qr, kr, lr, True)
    bms, by = bound_ms(nbytes, flops, torch.bfloat16, int_ops)
    tag = f"BH{B * hl} S{S} D{D} causal bfloat16, rate {rate}, heads {hl}-{H - 1} of {H}"
    rows = {"flash_fwd": {}, "flash_bwd": {}, "dropout_mask": {}}
    rows["flash_fwd"]["tp2_dropout"] = (tag, dict(
        max_abs_err=err, ms=time_ms(lambda: attn.flash_fwd_kernel(*fargs)),
        plain_ms=time_ms(lambda: attn.flash_fwd_torch(*fargs), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by))
    bargs = (qr, kr, vr, ro, dor, rlse, None, lr, True, scale, rate, key, place)
    got, ref = attn.flash_bwd_kernel(*bargs), attn.flash_bwd_torch(*bargs)
    err = max(check_close(f"K4 place {n}", a_, b_, dict(
        rtol=2e-2, atol=2e-2 * float(b_.float().abs().max())))
        for n, a_, b_ in zip(("dq", "dk", "dv"), got, ref))
    flops, nbytes = k4_flops_bytes(qr, kr, lr, True)
    bms, by = bound_ms(nbytes, flops, torch.bfloat16, int_ops)
    rows["flash_bwd"]["tp2_dropout"] = (tag, dict(
        max_abs_err=err, ms=time_ms(lambda: attn.flash_bwd_kernel(*bargs)),
        plain_ms=time_ms(lambda: attn.flash_bwd_torch(*bargs), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by))
    shape, rows_place = (B, S // 2, MODEL["d_model"]), attn.RankPlace(1, 1, 0, S // 2)
    mask = attn.dropout_keep_mask_kernel(key, shape, rate, rows_place)
    plain = attn.dropout_keep_mask_torch(key, shape, rate, rows_place)
    err = float((mask.float() - plain.float()).abs().max())
    if err != 0.0:
        raise AssertionError(f"K13 place: {int((mask != plain).sum())} elements of the "
                             f"rows place differ from the plain version")
    del mask, plain
    n = B * S // 2 * MODEL["d_model"]
    bms, by = bound_ms(n + 16, 0, torch.float32, PHILOX_OPS_PER_ELEMENT * n)
    rows["dropout_mask"]["tp2_sp_dropout"] = (
        f"{shape} rate {rate}, rows {S // 2}-{S - 1} (a sequence-parallel rank)", dict(
            max_abs_err=err,
            ms=time_ms(lambda: attn.dropout_keep_mask_kernel(key, shape, rate, rows_place)),
            plain_ms=time_ms(lambda: attn.dropout_keep_mask_torch(key, shape, rate,
                                                                  rows_place), iters=5),
            library_ms=None, bound_ms=bms, bound_by=by))
    for kname, r in rows.items():
        for key_, (tag_, f) in r.items():
            line(f"place_row {kname}", shape=tag_, **f)
    del q, k, v, do, qr, kr, vr, dor, o, ro, got, ref
    torch.cuda.empty_cache()
    return rows


def cp_world1_phase(attn, cpar):
    """``ring_attention`` over a context group of one (NCCL, world 1) at
    the GPT's attention shape: one causal hop, bitwise the causal
    ``flash_attention_with_lse`` launch, forward and gradients."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    ps.initialize_model_parallel(1, 1, context_parallel_size=1)
    try:
        g = gen(190)
        B, H, S, D = TRAIN_BATCH, MODEL["n_heads"], MODEL["seq_len"], 64
        q, k, v, w = (torch.randn(B, H, S, D, generator=g, device="cuda").bfloat16()
                      for _ in range(4))
        ring = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = cpar.ring_attention(*ring, causal=True, scale=D ** -0.5, impl="kernel")
        grads = torch.autograd.grad((o.float() * w.float()).sum(), ring)
        ref = [t.reshape(B * H, S, D).clone().requires_grad_(True) for t in (q, k, v)]
        ro, _ = attn.flash_attention_with_lse(*ref, causal=True, scale=D ** -0.5,
                                              impl="kernel")
        rgrads = torch.autograd.grad(
            (ro.float() * w.reshape(B * H, S, D).float()).sum(), ref)
        bitwise = {"o": bool(torch.equal(o.reshape(ro.shape), ro))}
        bitwise.update({f"d{n}": bool(torch.equal(a_.reshape(b_.shape), b_))
                        for n, a_, b_ in zip("qkv", grads, rgrads)})
    finally:
        ps.destroy_model_parallel()
    line("cp_world1", backend="nccl", context=1,
         shape=f"'B{B} H{H} S{S} D{D} causal bfloat16'", bitwise=json.dumps(bitwise))
    if not all(bitwise.values()):
        raise AssertionError(f"cp_world1: not the causal launch's bits: {bitwise}")


def collective_matmul_world1_phase():
    """The collective matmul at world 1 over NCCL at the flagship's QKV
    shape (sequence-first 1024 x 16 x 1024 bf16, w 1024 x 3072):
    ``column_parallel_linear(sequence_parallel=True, collective_matmul=True)``
    bitwise its monolithic path, y and the gradients of x, w and b."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp

    ps.initialize_model_parallel(1, 1)
    try:
        g = gen(200)
        S, D = MODEL["seq_len"], MODEL["d_model"]
        x = torch.randn(S, TRAIN_BATCH, D, generator=g, device="cuda").bfloat16()
        w = (0.02 * torch.randn(D, 3 * D, generator=g, device="cuda")).bfloat16()
        b = (0.1 * torch.randn(3 * D, generator=g, device="cuda")).bfloat16()
        dy = torch.randn(S, TRAIN_BATCH, 3 * D, generator=g, device="cuda").bfloat16()
        outs = {}
        for on in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            y = tp.column_parallel_linear(*leaves, sequence_parallel=True,
                                          collective_matmul=on)
            outs[on] = [y] + list(torch.autograd.grad(y, leaves, dy))
        bitwise = {n: bool(torch.equal(a_, b_))
                   for n, a_, b_ in zip(("y", "dx", "dw", "db"), outs[True], outs[False])}
    finally:
        ps.destroy_model_parallel()
    line("collective_matmul_world1", backend="nccl", tensor=1,
         shape=f"'x {S}x{TRAIN_BATCH}x{D} bfloat16, w {D}x{3 * D}'",
         bitwise=json.dumps(bitwise))
    if not all(bitwise.values()):
        raise AssertionError(f"collective_matmul_world1: not the monolithic bits: "
                             f"{bitwise}")


def bert_tp_world1_phase(bert, bcfg):
    """BERT's TP forward at world 1 over NCCL (the 8-layer BERT-Large at
    batch 128 x 128, bf16, ragged lengths), sequence parallel off and on,
    bitwise the dense forward: the MLM and NSP logits."""
    from beforeholiday_tpu_torch.ops._autocast import cast_floats
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    cfg = dataclasses.replace(bcfg, dtype=torch.bfloat16)
    params = cast_floats(bert.init(cfg, gen(1), device="cuda"), torch.bfloat16)
    lens = [BERT["seq_len"] - (i % 50) for i in range(BERT_BATCH)]
    tok, _, _, _, lens = bert_batch(bert, cfg, BERT_BATCH, 210, lens)
    with torch.no_grad():
        dense = bert.forward(params, tok, cfg, seq_lens=lens)
        bitwise = {}
        for sp in (False, True):
            ps.initialize_model_parallel(1, 1)
            try:
                got = bert.forward(params, tok, dataclasses.replace(
                    cfg, sequence_parallel=sp), seq_lens=lens)
            finally:
                ps.destroy_model_parallel()
            bitwise[f"sp={sp}"] = all(bool(torch.equal(a_, b_))
                                      for a_, b_ in zip(got, dense))
            del got
    line("bert_tp_world1", backend="nccl", tensor=1, batch=BERT_BATCH,
         layers=cfg.n_layers, bitwise=json.dumps(bitwise))
    if not all(bitwise.values()):
        raise AssertionError(f"bert_tp_world1: not the dense forward's bits: {bitwise}")
    del dense
    lamb_tensor_sharded_check(bert, cfg, params)
    del params
    torch.cuda.empty_cache()


def lamb_tensor_sharded_check(bert, cfg, params):
    """The TP BERT's optimizer at world 1 over NCCL: the arena-native
    ``MasterWeights(FusedLAMB(tensor_sharded=bert.tensor_sharded(cfg)))``
    step from random gradients. Its second step synchronizes the host
    nowhere in the port (the first builds the cached device masks), and its
    masters are the unmasked step's within LAMB_SHARDED_ULPS units of
    2^-24 (|master| + lr): at world 1 only the clip norm's ``total -
    sharded + psum(sharded)`` differs, by an ulp of the squared norm, which
    moves an update (at most lr an element) by a few of its ulps and a
    master's rounding by one a step."""
    from beforeholiday_tpu_torch.ops.arena import PackedParams
    from beforeholiday_tpu_torch.optimizers import FusedLAMB, MasterWeights
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    g, lr = gen(212), 1e-3
    base = PackedParams.pack(params)
    grads = base.replace_arenas([1e-2 * torch.randn(a.shape, generator=g, device="cuda")
                                 .to(a.dtype) for a in base.arenas])
    masters, port = {}, {}
    ps.initialize_model_parallel(1, 1)
    try:
        for name, mask in (("dense", None), ("tensor_sharded", bert.tensor_sharded(cfg))):
            opt = MasterWeights(FusedLAMB(lr=lr, weight_decay=0.01, tensor_sharded=mask))
            model = PackedParams.pack(params)
            state = opt.init(model)
            model, state = opt.step(model, grads, state)
            with watch_syncs() as (_, port_syncs):
                model, state = opt.step(model, grads, state)
            torch.cuda.synchronize()
            masters[name], port[name] = state["master"], port_syncs
    finally:
        ps.destroy_model_parallel()
    ulps = max(float(((a - b).abs() / ((b.abs() + lr) * 2.0 ** -24)).max())
               for a, b in zip(masters["tensor_sharded"], masters["dense"]))
    line("lamb_tensor_sharded", backend="nccl", tensor=1, steps=2,
         max_master_ulps=ulps, bound_ulps=LAMB_SHARDED_ULPS,
         port_host_syncs=json.dumps(port))
    if port["tensor_sharded"]:
        raise AssertionError(f"lamb_tensor_sharded: the port synchronized the host: "
                             f"{port['tensor_sharded']}")
    if not ulps <= LAMB_SHARDED_ULPS:
        raise AssertionError(f"lamb_tensor_sharded: masters {ulps} ulps from the "
                             f"unmasked step's (bound {LAMB_SHARDED_ULPS})")


# ---------------------------------------------- slice 18: remat, the monitor

LOG_EVERY = 5  # the MetricsLogger's cadence on the monitored runs
IMAGENET_MONITOR = dict(batch=64, iters=3)  # the trainer's profiled run


def remat_cfg(cfg, policy):
    return dataclasses.replace(cfg, remat_policy=None if policy == "none" else policy)


def result_diff(got, ref):
    """The largest difference between two step_result dicts: loss, every
    gradient arena and every master."""
    return max([abs(got["loss"] - ref["loss"])]
               + [max_err(a, b) for a, b in zip(got["grads"], ref["grads"])]
               + [max_err(a, b) for a, b in zip(got["masters"], ref["masters"])])


# the products a "dots_saveable" region saves, by name (any overload: the
# card's bf16 GEMMs with an fp32 result are mm's and addmm's ``.dtype``)
GEMM_OPS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "_scaled_mm")


def gemm_counter():
    """A dispatch mode that counts the GEMMs run in its scope, the backward
    and the recompute included (the autograd engine's threads inherit it);
    a product that a selective checkpoint saved is not run again, so not
    counted."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class GemmCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in GEMM_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    return GemmCount()


def remat_parity_phase(label, make, batch, policies, gemms=False):
    """One step at batch 2 under each policy against the ``"none"`` step from
    the same weights, on the kernels. A recompute runs the same kernels on
    the same inputs, so the loss, the gradient arenas and the masters must
    be bitwise the "none" step's. The bound is the run-to-run spread of the
    "none" step itself, measured here by running it twice (0 where every
    kernel of the step is deterministic). With ``gemms`` each step runs
    under :func:`gemm_counter`: "dots_saveable" must run no more GEMMs than
    "none" (it saves every product, so its recompute runs none), "full" and
    "save_boundaries" more (they recompute the blocks' products)."""
    counted = {}

    def run(policy):
        m, state, step = make(policy)
        with gemm_counter() if gemms else contextlib.nullcontext() as mode:
            out = step(*batch)
        res = step_result(m, state, out)
        if gemms:
            counted[policy] = mode.n
        del m, state, step, out
        torch.cuda.empty_cache()
        return res

    ref = run("none")
    floor = result_diff(run("none"), ref)
    diffs = {p: result_diff(run(p), ref) for p in policies}
    bad = {p: d for p, d in diffs.items() if d > floor}
    if bad:
        raise AssertionError(f"{label}: policies differ from the none step by "
                             f"{bad}, beyond its run-to-run spread {floor}")
    recomputed = {p: n - counted["none"] for p, n in counted.items()}
    if gemms and not (recomputed.get("dots_saveable", 0) == 0 and all(
            recomputed[p] > 0 for p in ("full", "save_boundaries") if p in recomputed)):
        raise AssertionError(f"{label}: GEMMs run beyond the none step's "
                             f"{counted['none']}: {recomputed}; dots_saveable must "
                             f"recompute none, full and save_boundaries some")
    line(label, batch=batch[0].shape[0], none_rerun_max_abs_diff=floor,
         max_abs_diff=json.dumps(diffs),
         bitwise=all(d == 0.0 for d in diffs.values()) and floor == 0.0,
         **({"gemms_none": counted["none"],
             "gemms_recomputed": json.dumps(recomputed)} if gemms else {}))


def monitored_run(label, monitor, step, state, batch, counters, expect, entry):
    """WARMUP_STEPS + TIMED_STEPS steps of ``step`` under the monitor, as a
    user script runs it: ``track_costs`` and ``track_memory`` on the step,
    a ``TrainMonitor`` updated after every step on the device (loss, the
    gradient arenas' global norm on K9, the loss scale), its packed vector
    handed to a ``MetricsLogger`` that copies it to the host every
    LOG_EVERY-th step. The timed steps run under ``watch_syncs``: the
    port's code may synchronize only in the logger's one copy a logged
    step. Returns the run's numbers."""
    mon = monitor.TrainMonitor()
    fetched = []

    class Logger(monitor.MetricsLogger):
        def _fetch(self, packed):
            fetched.append(1)
            return super()._fetch(packed)

    logger = Logger(mon, every=LOG_EVERY, warn_overflow_streak=0)
    tracked = monitor.track_costs(entry)(monitor.track_memory(entry)(step))
    metrics = [mon.init()]
    rows = []

    def monitored(i):
        loss, g, _ = tracked(*batch)
        metrics[0] = mon.update(metrics[0], loss=loss, grads=g,
                                scaler_state=state["scaler"])
        row = logger.log(mon.pack(metrics[0]), step=i)
        if row is not None:
            rows.append(row)
        return loss

    start = monitored(1)
    for i in range(2, WARMUP_STEPS + 1):
        monitored(i)
    torch.cuda.synchronize()
    start = start.item()
    for fn in counters.values():
        fn.launches = 0
    del fetched[:]
    events, losses = [], []
    timed = range(WARMUP_STEPS + 1, WARMUP_STEPS + TIMED_STEPS + 1)
    with watch_syncs() as (syncs, port_syncs):
        for i in timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(monitored(i))
            b.record()
            events.append((a, b))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()  # the last tracked step's peak
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, per_step in expect.items():
        if launches[k] != per_step * TIMED_STEPS:
            raise AssertionError(f"{label} {k}: {launches[k]} launches in "
                                 f"{TIMED_STEPS} steps, expected {per_step} a step")
    logged = [i for i in timed if i % LOG_EVERY == 0]
    # every sync of the port's code is the logger's copy (export.py's _fetch)
    outside = [s for s in port_syncs if "export.py:" not in s.split("<-")[-1]]
    if outside or len(fetched) != len(logged):
        raise AssertionError(f"{label}: the port synchronized outside the logger's "
                             f"copies ({outside}), or made {len(fetched)} copies in "
                             f"{len(logged)} logged steps")
    last = losses[-1].item()
    if not (np.isfinite(start) and np.isfinite(last) and last < start):
        raise AssertionError(f"{label}: loss {start} -> {last}")
    row = rows[-1]
    at = losses[logged[-1] - timed[0]].item()
    if row["steps"] != logged[-1] or row["loss"] != at or not (
            row["grad_norm"] > 0 and np.isfinite(row["grad_norm"])):
        raise AssertionError(f"{label}: the drained row {row} disagrees with the "
                             f"run (step {logged[-1]}, loss {at})")
    step_ms = [a.elapsed_time(b) for a, b in events]
    monitor.record_wall_time(entry, sum(step_ms) / 1e3, steps=TIMED_STEPS)
    mem = monitor.memory_records()[entry]["signatures"][0]
    return dict(median_step_ms=float(np.median(step_ms)), peak_gb=peak / 1e9,
                temp_bytes=mem["temp_bytes"], memory_method=mem["method"],
                launches_per_step={k: v // TIMED_STEPS for k, v in launches.items()
                                   if v}, host_syncs=sum(syncs.values()),
                port_syncs=len(port_syncs), logged_steps=len(logged),
                copies=len(fetched), start_loss=start, last_loss=last,
                drained_row={k: row[k] for k in ("step", "steps", "loss", "loss_ema",
                                                 "grad_norm", "loss_scale")})


def remat_monitor_phase(amp, gpt, bert, fused_adam, fused_lamb, cfg, bcfg,
                        counters, card):
    """Slice 18 on the flagship O5 GPT step (bench.py make_gpt_rung, batch
    16, full width): each remat policy's step held to the "none" step at
    batch 2 (bitwise, or within the none step's own run-to-run spread), the
    dropout step under "full" too (K13 redraws its masks in the
    recompute); then each policy's monitored, timed run (``remat:`` lines:
    ms, peak GB, the memory ledger's temp_bytes, K2/K4 launches, host
    syncs, copies) and the roofline ledger's MFU for each (``roofline:``).
    BERT-Large 8 layers with FusedLAMB under "save_boundaries": parity and
    a timed run (K7, K8, K9)."""
    from beforeholiday_tpu_torch import monitor

    params = gpt.init(cfg, gen(0), device="cuda")
    make = lambda policy, c=cfg: make_gpt_trainer(  # noqa: E731
        amp, gpt, fused_adam, params, remat_cfg(c, policy))
    remat_parity_phase("remat_parity", make, gpt.synthetic_batch(
        cfg, PARITY_BATCH, generator=gen(60), device="cuda"), REMAT_POLICIES[1:],
        gemms=True)
    dcfg = dataclasses.replace(cfg, **DROPOUT)
    remat_parity_phase("remat_dropout_parity", lambda p: make(p, dcfg),
                       gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(61),
                                           device="cuda"), ("full",))
    monitor.reset_roofline_ledger()
    monitor.reset_memory_ledger()
    batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    runs = {}
    for policy in REMAT_POLICIES:
        m, state, step = make(policy)
        work = lm_work(m, batch)
        r = monitored_run(f"remat_{policy}", monitor, step, state, batch, counters,
                          STEP_LAUNCHES[f"gpt_remat_{policy}"], f"gpt_{policy}")
        r["mfu_6n"] = work["flops"] / work["peak"] / (r["median_step_ms"] / 1e3)
        runs[policy] = r
        line("remat", policy=policy, batch=TRAIN_BATCH, steps=TIMED_STEPS,
             median_step_ms=r["median_step_ms"], peak_gb=r["peak_gb"],
             temp_bytes=r["temp_bytes"], memory_method=r["memory_method"],
             k2_launches_per_step=r["launches_per_step"].get("flash_fwd", 0),
             k4_launches_per_step=r["launches_per_step"].get("flash_bwd", 0),
             launches_per_step=json.dumps(r["launches_per_step"]),
             host_syncs=r["host_syncs"], port_syncs=r["port_syncs"],
             logged_steps=r["logged_steps"], copies=r["copies"],
             start_loss=r["start_loss"], last_loss=r["last_loss"],
             drained_row=json.dumps(r["drained_row"]), card=f"'{card}'")
        del m, state, step
        torch.cuda.empty_cache()
    if not runs["full"]["peak_gb"] < runs["none"]["peak_gb"]:
        raise AssertionError(f"remat: full's peak {runs['full']['peak_gb']} GB is "
                             f"not below none's {runs['none']['peak_gb']} GB")
    # dots_saveable keeps the products that full drops
    if not runs["dots_saveable"]["peak_gb"] > runs["full"]["peak_gb"]:
        raise AssertionError(f"remat: dots_saveable's peak "
                             f"{runs['dots_saveable']['peak_gb']} GB is not above "
                             f"full's {runs['full']['peak_gb']} GB")
    report = monitor.perf_report()
    rows = {r["entry"]: r for r in report["entries"]}
    line("roofline", chip=f"'{report['chip']['name']}'",
         peak_tflops=report["chip"]["peak_tflops"], hbm_gbs=report["chip"]["hbm_gbs"],
         mfu=json.dumps({p: report[f"gpt_{p}_mfu"] for p in REMAT_POLICIES}),
         mfu_6n=json.dumps({p: runs[p]["mfu_6n"] for p in REMAT_POLICIES}),
         flops_per_step=json.dumps({p: rows[f"gpt_{p}"]["flops_per_step"]
                                    for p in REMAT_POLICIES}),
         by_primitive=json.dumps(monitor.roofline_records()["gpt_none"]["signatures"][0]
                                 ["by_primitive"]),
         bound=rows["gpt_none"]["bound"], card=f"'{card}'")
    del params, batch
    torch.cuda.empty_cache()

    bparams = bert.init(bcfg, gen(1), device="cuda")
    bmake = lambda policy: make_bert_trainer(  # noqa: E731
        amp, bert, fused_lamb, bparams, remat_cfg(bcfg, policy))
    remat_parity_phase("bert_remat_parity", bmake, bert_batch(
        bert, bcfg, PARITY_BATCH, 62, BERT_PARITY_LENS), ("save_boundaries",))
    m, _, step = bmake("save_boundaries")
    batch = bert_batch(bert, bcfg, BERT_BATCH, 71)
    launches = training_phase(
        "bert_remat_save_boundaries_training", "bert_remat_save_boundaries_profile",
        step, batch, counters, STEP_LAUNCHES["bert"], BERT_GROUPS, card,
        seq_len=bcfg.seq_len, remat_policy="'save_boundaries'", **lm_work(m, batch))
    del m, step, bparams
    torch.cuda.empty_cache()
    return launches


def remat_1f1b_world1_phase(amp, gpt, fused_adam, cfg, counters, card, params,
                            batch):
    """The 1F1B engine at world 1 over NCCL (TP_MICRO microbatches, batch
    16) with its stage under "full": one step bitwise (or within the plain
    engine's run-to-run spread) the plain engine's, then the timed run,
    each microbatch's blocks recomputed once more in its backward slot."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    ps.initialize_model_parallel(1, 1)
    shard = gpt.shard_params(params, cfg, 0, 1)
    try:
        def make(policy):
            return tp_pp_trainer(amp, gpt, fused_adam, shard, cfg, TP_MICRO, "1f1b",
                                 remat=None if policy == "none" else policy)

        remat_parity_phase("remat_1f1b_world1_parity", make, batch, ("full",))
        m, _, step = make("full")
        key = "gpt_tp_pp_1f1b_remat_full"
        launches = training_phase(
            f"{key}_training", f"{key}_profile", step, batch, counters,
            STEP_LAUNCHES[key], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
            ranges=pp_slot_ranges, schedule="'1F1B, S 1'", remat_policy="'full'",
            micro_batches=TP_MICRO, one_device_o5_median_ms=MEDIANS.get("training"),
            **lm_work(m, batch))
        del m, step
        torch.cuda.empty_cache()
    finally:
        ps.destroy_model_parallel()
    return {key: launches}


def imagenet_monitor_phase(main_amp, tmp):
    """The ImageNet trainer's CLI for IMAGENET_MONITOR's iterations of
    ResNet-50 at O5 with ``--profile-dir`` and ``--flight-recorder``: the
    profiler trace of the epoch exists, parses and holds CUDA kernels
    (its convolutions among them), and the flight dump holds every printed
    step."""
    prof_dir = os.path.join(tmp, "profile")
    flight = os.path.join(tmp, "flight.json")
    n = IMAGENET_MONITOR["iters"]
    t0 = time.perf_counter()
    best = main_amp.main(["-a", "resnet50", "-b", str(IMAGENET_MONITOR["batch"]),
                          "--opt-level", "O5", "--iters", str(n), "--print-freq", "1",
                          "--deterministic", "--profile-dir", prof_dir,
                          "--flight-recorder", flight])
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"imagenet_monitor: {traces} in {prof_dir}")
    path = os.path.join(prof_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    with open(flight) as f:
        dump = json.load(f)
    if not kernels or dump["reason"] != "run_end" or dump["n_snapshots"] != n or [
            s["step"] for s in dump["snapshots"]] != list(range(1, n + 1)):
        raise AssertionError(f"imagenet_monitor: {len(kernels)} CUDA kernels in the "
                             f"trace; flight dump {dump['reason']}, "
                             f"{dump['n_snapshots']} snapshots")
    if not all(np.isfinite(s["metrics"]["loss"]) for s in dump["snapshots"]):
        raise AssertionError(f"imagenet_monitor: non-finite loss in {dump['snapshots']}")
    line("imagenet_monitor", arch="resnet50", batch=IMAGENET_MONITOR["batch"], iters=n,
         images_per_s_best=best, trace_mb=os.path.getsize(path) / 1e6,
         trace_events=len(events), cuda_kernel_events=len(kernels),
         flight_snapshots=dump["n_snapshots"],
         flight_dispatch_ops=len(dump["dispatch_summary"]),
         seconds=time.perf_counter() - t0)


# ------------------------------------------------- slice 20: ZeRO-2 and ZeRO-3

# the two-rank check: two gloo processes on the one card, the flagship at
# ZERO_TWO_RANK_BATCH a rank, ZERO_TWO_RANK_STEPS steps each of ZeRO-2 and
# ZeRO-3, against one NCCL rank at twice the batch
ZERO_TWO_RANK_BATCH = 8
ZERO_TWO_RANK_STEPS = 2
# the multi-rank checks on the card (two gloo ranks here, four in slice
# 21's 2 x 2 carve) run the flagship at full width and its depth cut to
# CARD_LAYERS of 8 (A29's time budget: gloo stages every collective through
# the host), against one NCCL rank of the same depth
CARD_LAYERS = 2


def card_model():
    """MODEL with its depth cut to CARD_LAYERS."""
    return {**MODEL, "n_layers": CARD_LAYERS}
ZERO_TIMEOUT = 600
# PERF.md's GPT O5 bf16 row: loss relative error, the gradient arenas'
# relative L2, the masters' largest difference (a gradient sign flip moves
# Adam's first step by 2 lr)
ZERO_ROW = dict(loss_rel_err=5e-3, grad_rel_l2=0.05, master_max_abs_err=2 * LR + 1e-6)
# (param_residency, prefetch) of the ZeRO-3 runs held bitwise to ZeRO-2
ZERO3_RUNS = (("keep", 1), ("regather", 1), ("keep", 0), ("keep", 2))
# ZeRO-2's bucket for the overlap and compressed runs (bucketing's default)
ZERO_BUCKET_BYTES = 4 << 20


def zero_gpt_trainer(amp, gpt, params, cfg, impl=None, loss_scale=None,
                     loss_weight=None, **zkw):
    """The flagship's O5 step with ZeRO-2 as a user script builds it:
    ``amp.initialize(..., "O5", arena_native=True)`` with no optimizer,
    ``DistributedFusedAdam(lr=LR, **zkw)`` on the arena-native params, the
    grads (born flat, unscaled by K5) through ``scaled_value_and_grad``.
    ``(m, opt, state, step)``; ``step(tokens, targets)`` returns ``(loss,
    fp32 grads, found_inf)`` with no host sync."""
    from beforeholiday_tpu_torch.optimizers import DistributedFusedAdam

    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl)
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params, None, "O5",
                       arena_native=True, loss_scale=loss_scale)
    opt = DistributedFusedAdam(lr=LR, impl=impl, **zkw)

    def loss_fn(p, tok, tgt):
        value = gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply)
        return value if loss_weight is None else value * loss_weight

    svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
    state = {"opt": opt.init(m.params), "scaler": m.scaler.init()}

    def step(tok, tgt):
        loss, g, fi, state["scaler"] = svag(m.params, state["scaler"], tok, tgt)
        m.params, state["opt"] = opt.step(m.params, g, state["opt"], found_inf=fi)
        return loss, g, fi

    return m, opt, state, step


def zero3_gpt_trainer(amp, gpt, params, cfg, residency="keep", prefetch=1, **zkw):
    """The flagship's O5 step with ZeRO-3: the O5 cast tree (bf16, the norm
    leaves fp32) only seeds the master shard; each step gathers the params
    (``prefetch``), unbinds the blocks, runs the loss under
    ``wrap_residency`` and steps on ``master.grad`` with ``grad_scale`` the
    inverse loss scale. ``(opt, layout, state, step)``; ``step`` returns
    ``(loss, the grad shard, found_inf)``, the flag read from the step
    count on the card."""
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, zero3

    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params, None, "O5")
    opt = ZeRO3FusedAdam(lr=LR, prefetch=prefetch, param_residency=residency, **zkw)
    layout = zero3.layout_of(m.params)
    state = {"opt": opt.init(m.params), "scaler": m.scaler.init()}
    m.params = None  # the shard is the model's one copy

    def scaled_loss(master, tok, tgt):
        p = opt.gather_params(master, layout)
        p = {**p, "blocks": {k: v.unbind(0) for k, v in p["blocks"].items()}}
        return m.scaler.scale_loss(gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
                                   state["scaler"])

    wrapped = opt.wrap_residency(scaled_loss)

    def step(tok, tgt):
        scale = state["scaler"]["scale"]
        master = state["opt"]["master"].detach().requires_grad_(True)
        value = wrapped(master, tok, tgt)
        value.backward()
        before = state["opt"]["step"]
        state["opt"] = opt.step(master.grad, state["opt"], grad_scale=1.0 / scale)
        return value.detach() / scale, master.grad, state["opt"]["step"] == before

    return opt, layout, state, step


def zero_bert_trainer(amp, bert, params, cfg, impl=None, loss_scale=None,
                      loss_weight=None):
    """BERT-Large's O5 step with ``DistributedFusedLAMB(lr=1e-3,
    weight_decay=0.01)`` (ZeRO-2) on the arena-native params, the
    ``pretrain_loss`` grads through ``scaled_value_and_grad``."""
    from beforeholiday_tpu_torch.optimizers import DistributedFusedLAMB

    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl)
    m = amp.initialize(lambda p, t: bert.forward(p, t, cfg), params, None, "O5",
                       arena_native=True, loss_scale=loss_scale)
    opt = DistributedFusedLAMB(lr=BERT_LR, weight_decay=0.01, impl=impl)

    def loss_fn(p, tok, tgt, mask, nsp, lens):
        value = bert.pretrain_loss(p.unpack(), tok, tgt, mask, nsp, cfg, seq_lens=lens)
        return value if loss_weight is None else value * loss_weight

    svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
    state = {"opt": opt.init(m.params), "scaler": m.scaler.init()}

    def step(*batch):
        loss, g, fi, state["scaler"] = svag(m.params, state["scaler"], *batch)
        m.params, state["opt"] = opt.step(m.params, g, state["opt"], found_inf=fi)
        return loss, g, fi

    return m, opt, state, step


def zero_state_bytes(state):
    return sum(state[k].numel() * state[k].element_size()
               for k in ("master", "exp_avg", "exp_avg_sq"))


def zero_flat(tree):
    """A tree's leaves, flattened, in tree order, on the host."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    return [t.reshape(-1).to("cpu", torch.float32, copy=True) for t in tree_flatten(tree)[0]]


def zero_full_master(opt, m, state):
    """The whole packed fp32 master arena (every rank's shard, gathered) cut
    into the arena-native buckets' segments, on the host."""
    from beforeholiday_tpu_torch.optimizers.distributed_fused import layout_of_params

    full = opt._gather_full(state["master"])
    lay = layout_of_params(m.params)
    return [full[b: b + s.total].to("cpu", copy=True)
            for b, s in zip(lay.bases, lay.packed.specs)]


def zero_world1_parity(amp, gpt, bert, comms, bucketing, params, bparams, cfg, bcfg):
    """At world 1 over NCCL: ZeRO-2 against the port's FusedAdam O5 step
    (two steps at batch 2, the static scale of O5): the reduce-scatter over
    one rank is a copy, /1 and *1.0 are exact, K6 is the same kernel, so
    masters, moments and the bf16 model are bitwise. ZeRO-3 bitwise ZeRO-2
    for each of ZERO3_RUNS; ``overlap_backward`` bitwise the phased step;
    the compressed step's reduce-scatter within ``wire_eps * |g|`` of the
    exact one on the step's own gradients, its masters within ZERO_ROW's
    bound a step of the uncompressed step's (a gradient near 0 that the
    wire's rounding flips moves Adam's step by 2 lr) and its model a bf16
    rounding of them;
    BERT's DistributedFusedLAMB against FusedLAMB (two steps at batch 2,
    ragged lengths) within LAMB_SHARDED_ULPS of 2^-24 (|master| + lr), and
    3 lr; an overflowing ZeRO-2 step and an overflowing DistributedFusedLAMB
    step leave masters, moments and step counts bitwise unchanged. Returns
    the world-1 ZeRO-2 state bytes and the batch-16 reference step."""
    from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from beforeholiday_tpu_torch.optimizers.distributed_fused import layout_of_params

    t0 = time.perf_counter()
    batch = gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60), device="cuda")
    fields = {}
    # the port's FusedAdam O5 step
    m, state, step = make_gpt_trainer(amp, gpt, FusedAdam, params, cfg)
    for _ in range(2):
        step(*batch)
    ref = dict(model=[a.clone() for a in m.params.arenas],
               master=[a.clone() for a in state["opt"]["master"]],
               m=[b["exp_avg"].clone() for b in state["opt"]["inner"]],
               v=[b["exp_avg_sq"].clone() for b in state["opt"]["inner"]])
    del m, state, step
    # ZeRO-2, phased
    m, opt, state, step = zero_gpt_trainer(amp, gpt, params, cfg)
    for _ in range(2):
        _, g, fi = step(*batch)
    lay = layout_of_params(m.params)
    cut = lambda t: [t[b: b + s.total] for b, s in zip(lay.bases, lay.packed.specs)]
    z = state["opt"]
    bitwise = dict(
        model=all(torch.equal(a, b) for a, b in zip(m.params.arenas, ref["model"])),
        master=all(torch.equal(a, b[: len(a)]) for a, b in zip(cut(z["master"]), ref["master"])),
        exp_avg=all(torch.equal(a, b[: len(a)]) for a, b in zip(cut(z["exp_avg"]), ref["m"])),
        exp_avg_sq=all(torch.equal(a, b[: len(a)])
                       for a, b in zip(cut(z["exp_avg_sq"]), ref["v"])))
    fields["zero2_vs_fused_adam_bitwise"] = bitwise
    fields["zero2_vs_fused_adam_max_abs_err"] = max(
        max_err(a, b[: len(a)]) for a, b in zip(cut(z["master"]), ref["master"]))
    z2_master = opt.state_dict(m.params, z)["master"]
    z2_model = m.params.unpack()
    z2 = dict(master=zero_flat(z2_master), model=zero_flat(z2_model),
              step=int(z["step"]))
    # the compressed reduce-scatter on this step's own gradient arena
    gflat = opt._full_arena(g, lay)
    exact = bucketing.bucketed_psum_scatter(gflat, "data", site="check.exact",
                                            bucket_bytes=ZERO_BUCKET_BYTES)
    wire = bucketing.bucketed_psum_scatter(gflat, "data", site="check.wire",
                                           bucket_bytes=ZERO_BUCKET_BYTES, compress=True)
    rs_err = float(((wire - exact).abs()
                    - bucketing.wire_eps(torch.bfloat16) * gflat.abs()).max())
    fields["compressed_reduce_scatter_excess_over_bound"] = rs_err
    del m, opt, state, step, g, gflat, exact, wire, z, ref
    torch.cuda.empty_cache()
    failures = [k for k, v in bitwise.items() if not v]
    if rs_err > 0:
        failures.append(f"compressed reduce-scatter {rs_err} past wire_eps |g|")
    # ZeRO-2 overlap_backward, and compressed
    for name, kw in (("overlap", dict(overlap_backward=True,
                                      bucket_bytes=ZERO_BUCKET_BYTES)),
                     ("compressed", dict(compress=True, bucket_bytes=ZERO_BUCKET_BYTES))):
        m, opt, state, step = zero_gpt_trainer(amp, gpt, params, cfg, **kw)
        for _ in range(2):
            step(*batch)
        got_master = zero_flat(opt.state_dict(m.params, state["opt"])["master"])
        got_model = zero_flat(m.params.unpack())
        if name == "overlap":
            same = (all(torch.equal(a, b) for a, b in zip(got_master, z2["master"]))
                    and all(torch.equal(a, b) for a, b in zip(got_model, z2["model"])))
            fields["overlap_bitwise_phased"] = same
            if not same:
                failures.append("overlap_backward is not bitwise the phased step")
        else:
            err = max(max_err(a, b) for a, b in zip(got_master, z2["master"]))
            rounding = all(torch.equal(a, b.to(torch.bfloat16).float())
                           for a, b in zip(got_model, got_master))
            fields["compressed_master_max_abs_err"] = err
            fields["compressed_model_is_bf16_of_master"] = rounding
            if not (err <= 2 * ZERO_ROW["master_max_abs_err"] and rounding):
                failures.append(f"compressed: masters {err}, model bf16 of master "
                                f"{rounding}")
        del m, opt, state, step
        torch.cuda.empty_cache()
    # ZeRO-3 bitwise ZeRO-2
    z3 = {}
    for residency, prefetch in ZERO3_RUNS:
        comms.reset_comms_ledger()
        opt, layout, state, step = zero3_gpt_trainer(amp, gpt, params, cfg, residency,
                                                     prefetch)
        for _ in range(2):
            step(*batch)
        calls = {r["site"]: r["calls"] for r in comms.comms_records()
                 if r["site"].startswith("zero3.")}
        same = (all(torch.equal(a, b) for a, b in zip(
            zero_flat(opt.state_dict(layout, state["opt"])["master"]), z2["master"]))
            and all(torch.equal(a, b) for a, b in zip(
                zero_flat(opt.gather_params(state["opt"]["master"], layout)),
                z2["model"]))
            and int(state["opt"]["step"]) == z2["step"])
        z3[f"{residency}_p{prefetch}"] = dict(bitwise_zero2=same, calls=calls)
        if not same:
            failures.append(f"zero3 {residency} prefetch {prefetch} is not bitwise ZeRO-2")
        del opt, state, step
        torch.cuda.empty_cache()
    fields["zero3"] = z3
    keep, again = z3["keep_p1"]["calls"], z3["regather_p1"]["calls"]
    if again.get("zero3.gather_params") != 2 * keep.get("zero3.gather_params", 0):
        failures.append(f"regather's gathers {again} are not twice keep's {keep}")
    # the skip steps: an overflow changes nothing
    inf = torch.full((), float("inf"), device="cuda")
    skips = {}
    for name, make, b in (
            ("zero2", lambda: zero_gpt_trainer(amp, gpt, params, cfg,
                                               loss_scale="dynamic", loss_weight=inf),
             gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(61), device="cuda")),
            ("zero2_lamb", lambda: zero_bert_trainer(amp, bert, bparams, bcfg,
                                                     loss_scale="dynamic",
                                                     loss_weight=inf),
             bert_batch(bert, bcfg, PARITY_BATCH, 63, BERT_PARITY_LENS))):
        m, opt, state, step = make()
        before = {k: v.clone() for k, v in state["opt"].items()}
        model = [a.clone() for a in m.params.arenas]
        _, _, fi = step(*b)
        torch.cuda.synchronize()
        held = (bool(fi) and all(torch.equal(before[k], state["opt"][k]) for k in before)
                and all(torch.equal(a, b_) for a, b_ in zip(model, m.params.arenas)))
        skips[name] = held
        if not held:
            failures.append(f"{name}: an overflowing step changed the state")
        del m, opt, state, step, before, model
        torch.cuda.empty_cache()
    fields["skip_bitwise_held"] = skips
    # BERT: DistributedFusedLAMB against FusedLAMB
    bb = bert_batch(bert, bcfg, PARITY_BATCH, 62, BERT_PARITY_LENS)
    m, state, step = make_bert_trainer(amp, bert, FusedLAMB, bparams, bcfg)
    for _ in range(2):
        step(*bb)
    ref_master = [a.clone() for a in state["opt"]["master"]]
    del m, state, step
    m, opt, state, step = zero_bert_trainer(amp, bert, bparams, bcfg)
    for _ in range(2):
        step(*bb)
    lay = layout_of_params(m.params)
    got = [state["opt"]["master"][b: b + s.total]
           for b, s in zip(lay.bases, lay.packed.specs)]
    ulps = max(float(((a - r[: len(a)]).abs() / ((r[: len(a)].abs() + BERT_LR)
                                                   * 2.0 ** -24)).max())
               for a, r in zip(got, ref_master))
    err = max(max_err(a, r[: len(a)]) for a, r in zip(got, ref_master))
    fields["lamb_vs_fused_lamb"] = dict(max_master_ulps=ulps, bound_ulps=LAMB_SHARDED_ULPS,
                                        max_abs_err=err, row_3lr=3 * BERT_LR)
    if not ulps <= LAMB_SHARDED_ULPS:
        failures.append(f"DistributedFusedLAMB masters {ulps} ulps from FusedLAMB's")
    del m, opt, state, step, ref_master, got
    torch.cuda.empty_cache()
    # the batch-16 reference of the multi-rank checks at their depth
    # (card_model), and its world-1 state
    tb = gpt.synthetic_batch(cfg, 2 * ZERO_TWO_RANK_BATCH, generator=gen(70),
                             device="cuda")
    ccfg = gpt.GPTConfig(**card_model())
    m, opt, state, step = zero_gpt_trainer(amp, gpt, gpt.init(ccfg, gen(0), device="cuda"),
                                           ccfg)
    loss, g, fi = step(*tb)
    lay = layout_of_params(m.params)
    one_rank = dict(loss=loss.item(), grads=[a[: s.total].to("cpu", copy=True)
                                             for a, s in zip(g.arenas, lay.packed.specs)],
                    masters=zero_full_master(opt, m, state["opt"]),
                    state_bytes=zero_state_bytes(state["opt"]))
    del m, opt, state, step, g
    torch.cuda.empty_cache()
    line("zero_world1", backend="nccl", world=1, batch=PARITY_BATCH, steps=2,
         seconds=time.perf_counter() - t0,
         **{k: json.dumps(v) for k, v in fields.items()})
    if failures:
        raise AssertionError("zero_world1: " + "; ".join(failures))
    return one_rank


def zero_ledger_per_step(prefix, steps):
    """The ``prefix.*`` ledger rows as collectives and bytes a step."""
    from beforeholiday_tpu_torch.monitor import comms

    out = {}
    for r in comms.comms_records():
        if r["site"].startswith(prefix + "."):
            row = out.setdefault(r["site"], {"kind": r["kind"], "calls": 0, "bytes": 0})
            row["calls"] += r["calls"] / steps
            row["bytes"] += r["bytes"] / steps
    return out


class counted:
    """A step function that counts its calls (the ledger's steps)."""

    def __init__(self, step):
        self.step, self.n = step, 0

    def __call__(self, *batch):
        self.n += 1
        return self.step(*batch)


def zero_training_phases(amp, gpt, bert, comms, params, bparams, cfg, bcfg, counters,
                         card):
    """The timed and profiled runs: the flagship at batch 16 on ZeRO-2 and
    on ZeRO-3 ("keep" and "regather", prefetch 1), BERT-Large at 128 x 128
    on DistributedFusedLAMB; each with its state bytes and its collectives
    and bytes a step from the ledger (every step the phase ran), beside the
    O5 FusedAdam and FusedLAMB medians of this run. Returns the launch
    counts by run."""
    batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    bb = bert_batch(bert, bcfg, BERT_BATCH, 71)
    launches = {}
    runs = (("zero2", "gpt"), ("zero3_keep", "gpt"), ("zero3_regather", "gpt"),
            ("bert_zero2_lamb", "bert"))
    for name, model in runs:
        comms.reset_comms_ledger()
        if name == "zero2":
            m, opt, state, step = zero_gpt_trainer(amp, gpt, params, cfg)
            work, b = lm_work(m, batch), batch
        elif model == "gpt":
            residency = name.split("_")[1]
            opt, layout, state, step = zero3_gpt_trainer(amp, gpt, params, cfg,
                                                         residency, 1)
            work = dict(unit="tokens", units=batch[0].numel(),
                        flops=6.0 * layout.spec.total * batch[0].numel(),
                        peak=PEAK_BF16, params=layout.spec.total)
            b = batch
        else:
            m, opt, state, step = zero_bert_trainer(amp, bert, bparams, bcfg)
            work, b = lm_work(m, bb), bb
        st = counted(step)
        label = f"{name}_training"
        launches[name] = training_phase(
            label, f"{name}_profile", st, b, counters, STEP_LAUNCHES[name],
            BERT_GROUPS if model == "bert" else TRAIN_GROUPS, card,
            seq_len=(bcfg if model == "bert" else cfg).seq_len, world=1,
            optimizer=f"'{type(opt).__name__}'",
            state_bytes=zero_state_bytes(state["opt"]),
            fused_median_ms=MEDIANS.get("bert_training" if model == "bert"
                                        else "training"), **work)
        prefix = "zero3" if name.startswith("zero3") else "zero2"
        line(f"{name}_ledger", steps=st.n,
             per_step=json.dumps(zero_ledger_per_step(prefix, st.n)))
        del opt, state, step, st
        if model != "gpt" or name == "zero2":
            del m
        torch.cuda.empty_cache()
    return launches


def gloo_all_to_all_probe(rank):
    """Does this PyTorch's gloo take ``all_to_all`` on CUDA tensors (the
    compressed reduce-scatter's exchange)? ``(ok, error)``."""
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
    out = torch.empty_like(x)
    try:
        dist.all_to_all_single(out, x)
    except RuntimeError as e:
        return False, str(e).splitlines()[0][:200]
    want = [0.0, 1.0, 10.0, 11.0] if rank == 0 else [2.0, 3.0, 12.0, 13.0]
    ok = torch.tensor([float(out.tolist() == want)], device="cuda")
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item()), None


def zero_two_rank_worker(rank, store, out_dir):
    """One rank of the two-rank ZeRO check (a spawned process): gloo on CUDA
    tensors, the flagship at CARD_LAYERS layers (full width) from the
    parent's seeded weights, this rank's half
    of the batch-16 batch; ZERO_TWO_RANK_STEPS steps of ZeRO-2, of ZeRO-3
    ("keep", prefetch 1) and, where gloo takes ``all_to_all`` on CUDA
    tensors (:func:`gloo_all_to_all_probe`, first), of compressed ZeRO-2.
    Rank 0 saves each run's step-1 loss (the ranks' mean), reduced grads
    (ZeRO-2) and masters, whether the ranks' models were bitwise equal after
    every step, its state bytes and launch counts."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        from beforeholiday_tpu_torch import amp
        from beforeholiday_tpu_torch.contrib import xentropy as xent
        from beforeholiday_tpu_torch.ops import attention as attn
        from beforeholiday_tpu_torch.ops import multi_tensor as mt
        from beforeholiday_tpu_torch.ops import normalization as norm
        from beforeholiday_tpu_torch.ops import softmax as sm
        from beforeholiday_tpu_torch.ops.arena import tree_flatten
        from beforeholiday_tpu_torch.optimizers.distributed_fused import layout_of_params
        from beforeholiday_tpu_torch.testing import gpt

        cfg = gpt.GPTConfig(**card_model())
        params = gpt.init(cfg, gen(0), device="cuda")
        tok, tgt = gpt.synthetic_batch(cfg, 2 * ZERO_TWO_RANK_BATCH, generator=gen(70),
                                       device="cuda")
        B = ZERO_TWO_RANK_BATCH
        batch = (tok[rank * B:(rank + 1) * B], tgt[rank * B:(rank + 1) * B])
        counters = launch_counters(norm, attn, mt, sm, xent)

        def same_on_both(tensors):
            flags = []
            for t in tensors:
                other = t.clone()
                dist.broadcast(other, 0)
                flags.append(torch.equal(other, t))
            ok = torch.tensor([float(all(flags))], device="cuda")
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            return bool(ok.item())

        def mean_loss(loss):
            lt = loss.detach().float().reshape(1).clone()
            dist.all_reduce(lt)
            return float(lt) / 2

        probe, probe_error = gloo_all_to_all_probe(rank)
        runs = [("zero2", {})] + ([("zero2_compressed", dict(
            compress=True, bucket_bytes=ZERO_BUCKET_BYTES))] if probe else [])
        out, t0 = {"probe": (probe, probe_error)}, time.perf_counter()
        for name, kw in runs + [("zero3", None)]:
            for fn in counters.values():
                fn.launches = 0
            rec = {"ranks_bitwise": []}
            if kw is None:
                opt, layout, state, step = zero3_gpt_trainer(amp, gpt, params, cfg)
            else:
                m, opt, state, step = zero_gpt_trainer(amp, gpt, params, cfg, **kw)
            for i in range(ZERO_TWO_RANK_STEPS):
                loss, g, fi = step(*batch)
                last = i == ZERO_TWO_RANK_STEPS - 1
                if kw is not None:
                    rec["ranks_bitwise"].append(same_on_both(m.params.arenas))
                elif last:
                    model = opt.gather_params(state["opt"]["master"], layout)
                    rec["ranks_bitwise"].append(same_on_both(tree_flatten(model)[0]))
                    del model
                rec.setdefault("losses", []).append(mean_loss(loss))
                rec.setdefault("found_inf", []).append(bool(fi))
                if i == 0 and kw is not None:
                    lay = layout_of_params(m.params)
                    grads = []
                    for a, s in zip(g.arenas, lay.packed.specs):
                        red = a[: s.total].clone()
                        dist.all_reduce(red)
                        grads.append((red / 2).to("cpu"))
                    rec["grads"] = grads
                    rec["masters"] = zero_full_master(opt, m, state["opt"])
                if last:
                    # the masters in tree order, whatever the arena's order
                    lay = (layout.zero_layout() if kw is None
                           else layout_of_params(m.params))
                    rec["masters_tree"] = zero_flat(opt._tree_of_arena(
                        opt._gather_full(state["opt"]["master"]), lay))
                rec["state_bytes"] = zero_state_bytes(state["opt"])
            torch.cuda.synchronize()
            rec["launches"] = {k: fn.launches for k, fn in counters.items() if fn.launches}
            out[name] = rec
            del opt, state, step
            if kw is not None:
                del m
            torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if rank == 0:
            torch.save(out, f"{out_dir}/zero_rank0.pt")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/zero_rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def zero_two_rank_card_phase(one_rank, tmp):
    """Two processes on the one card over gloo on CUDA tensors (a
    correctness run: gloo stages every collective through the host): ZeRO-2
    (and, where gloo takes ``all_to_all`` on CUDA tensors, compressed
    ZeRO-2) and ZeRO-3 at ZERO_TWO_RANK_BATCH a
    rank: the ranks' models bitwise equal after each step, ZeRO-3 bitwise
    ZeRO-2, ZeRO-2's step 1 against one NCCL rank at batch 16 (``one_rank``)
    within ZERO_ROW, each rank's state bytes half of world 1's (to a TILE a
    state arena). Returns rank 0's launch counts."""
    from beforeholiday_tpu_torch.ops.arena import TILE

    t0 = time.perf_counter()
    codes = spawn_ranks(2, zero_two_rank_worker,
                        lambda r: (r, f"{tmp}/zero_store", tmp), ZERO_TIMEOUT,
                        "zero_two_rank_card")
    if any(codes):
        errors = [open(f"{tmp}/zero_rank{r}.err").read() for r in range(2)
                  if os.path.exists(f"{tmp}/zero_rank{r}.err")]
        raise AssertionError(f"zero_two_rank_card: exit codes {codes}\n"
                             + "\n".join(errors))
    res = torch.load(f"{tmp}/zero_rank0.pt")
    probe, probe_error = res.pop("probe")
    z2, z3 = res["zero2"], res["zero3"]
    failures, fields = [], {}
    errs = step_errors(dict(loss=z2["losses"][0], grads=z2["grads"],
                            masters=z2["masters"]), one_rank)
    fields["zero2_vs_one_rank"] = errs
    if out_of_bounds(errs, ZERO_ROW):
        failures.append(f"ZeRO-2 against one rank: {out_of_bounds(errs, ZERO_ROW)}")
    # after the last step: ZeRO-3's masters are ZeRO-2's, bit for bit
    z3_bitwise = (z3["losses"] == z2["losses"] and all(
        torch.equal(a, b) for a, b in zip(z3["masters_tree"], z2["masters_tree"])))
    fields["zero3_bitwise_zero2"] = z3_bitwise
    if not z3_bitwise:
        failures.append("two-rank ZeRO-3 is not bitwise two-rank ZeRO-2")
    for name in [k for k in ("zero2", "zero2_compressed", "zero3") if k in res]:
        r = res[name]
        fields[f"{name}_ranks_bitwise"] = r["ranks_bitwise"]
        if not all(r["ranks_bitwise"]) or any(r["found_inf"]):
            failures.append(f"{name}: ranks bitwise {r['ranks_bitwise']}, "
                            f"found_inf {r['found_inf']}")
    if "zero2_compressed" in res:
        err = max(max_err(a, b) for a, b in zip(res["zero2_compressed"]["masters_tree"],
                                                z2["masters_tree"]))
        fields["compressed_master_max_abs_err"] = err
        if not err <= ZERO_TWO_RANK_STEPS * ZERO_ROW["master_max_abs_err"]:
            failures.append(f"compressed two-rank masters {err} from uncompressed")
    half = abs(2 * z2["state_bytes"] - one_rank["state_bytes"])
    fields["state_bytes"] = dict(world1=one_rank["state_bytes"], world2=z2["state_bytes"],
                                 zero3_world2=z3["state_bytes"])
    if half > 3 * 4 * TILE or z3["state_bytes"] != z2["state_bytes"]:
        failures.append(f"state bytes a rank not half of world 1's: {fields['state_bytes']}")
    line("zero_two_rank_card", backend="gloo", world=2, device="'one card'",
         layers=CARD_LAYERS,
         batch_per_rank=ZERO_TWO_RANK_BATCH, steps=ZERO_TWO_RANK_STEPS,
         gloo_all_to_all_on_cuda=probe, probe_error=f"'{probe_error}'",
         bounds=json.dumps(ZERO_ROW),
         note="'gloo stages every collective through the host: a correctness run, "
              "not a speed'",
         rank_seconds=res["seconds"], rank_peak_mem_gb=res["peak_mem_gb"],
         seconds=time.perf_counter() - t0,
         one_rank_loss=one_rank["loss"],
         losses=json.dumps({k: res[k]["losses"] for k in ("zero2", "zero3")}),
         **{k: json.dumps(v) for k, v in fields.items()})
    if failures:
        raise AssertionError("zero_two_rank_card: " + "; ".join(failures))
    return {k: res[k]["launches"] for k in ("zero2", "zero2_compressed", "zero3")
            if k in res}


def zero_kernel_rows(mt, gpt_spec, bert_spec, launches):
    """The ZeRO shapes on the ``kernels`` line: K6 on the flagship's world-2
    shard (no model copy; library ``torch._fused_adamw_`` on the shard),
    K7 and K8 on rank 1's shard of BERT's world-2 arena (K8 from the
    shard's tables: the shard starts inside a tensor), each against its
    plain version with the existing tolerances. ``launches``: the two-rank
    run's counts (K6), none for BERT (no two-rank BERT run)."""
    from beforeholiday_tpu_torch.ops.arena import ArenaShard
    from beforeholiday_tpu_torch.optimizers.distributed_fused import _shard_len

    rows = {"adam": {}, "lamb_stage1": {}, "scaled_update": {}}
    g = gen(90)
    # K6 on the GPT's world-2 shard
    n = _shard_len(gpt_spec.padded_total, 2)
    grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
    p = 0.02 * torch.randn(n, generator=g, device="cuda")
    m = 1e-4 * torch.randn(n, generator=g, device="cuda")
    v = 1e-8 * torch.rand(n, generator=g, device="cuda")
    step = torch.full((), 4, dtype=torch.int32, device="cuda")
    bc1, bc2 = mt._bias_corrections(True, step, 0.9, 0.999)
    kw = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
              grad_scale=1.0, bc1=bc1, bc2=bc2, adam_w_mode=True,
              found_inf=torch.zeros((), dtype=torch.bool, device="cuda"), copy_out=None)
    outs = {}
    for fn in (mt.adam_kernel, mt.adam_torch):
        st = (p.clone(), m.clone(), v.clone())
        fn(grad, *st, **kw)
        outs[fn] = st
    torch.cuda.synchronize()
    err = max(check_close("K6 zero2 shard", a, b, dict(rtol=1e-6, atol=1e-10))
              for a, b in zip(outs[mt.adam_kernel], outs[mt.adam_torch]))
    st = (p.clone(), m.clone(), v.clone())
    steps = [torch.full((), 4.0, device="cuda")]
    bms, by = bound_ms(28 * n, 20 * n, torch.float32)
    tag = f"{n} fp32, a world-2 shard, no copy"
    rows["adam"]["zero2_shard"] = (tag, dict(
        max_abs_err=err, ms=time_ms(lambda: mt.adam_kernel(grad, *st, **kw)),
        plain_ms=time_ms(lambda: mt.adam_torch(grad, *st, **kw), iters=5),
        library_ms=time_ms(lambda: torch._fused_adamw_(
            [st[0]], [grad], [st[1]], [st[2]], [], steps, lr=LR, beta1=0.9,
            beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)),
        bound_ms=bms, bound_by=by, launches=launches.get("adam", 0)))
    line("K6", shape=tag, **{k: v_ for k, v_ in rows["adam"]["zero2_shard"][1].items()})
    del grad, p, m, v, st, outs
    # K7 and K8 on rank 1's shard of BERT's world-2 arena
    n = _shard_len(bert_spec.padded_total, 2)
    seg = ArenaShard(bert_spec, 1, n)
    grad = 1e-3 * torch.randn(n, generator=g, device="cuda")
    p = 0.02 * torch.randn(n, generator=g, device="cuda")
    p[max(bert_spec.total - n, 0):] = 0
    m = 1e-4 * torch.randn(n, generator=g, device="cuda")
    v = 1e-8 * torch.rand(n, generator=g, device="cuda")
    kw7 = dict(bc1=bc1, bc2=bc2, mode=1, clip=torch.full((), 2.5, device="cuda"),
               found_inf=torch.zeros((), dtype=torch.bool, device="cuda"), **LAMB_HYPER)
    outs = {}
    for fn in (mt.lamb_stage1_kernel, mt.lamb_stage1_torch):
        st = (m.clone(), v.clone())
        outs[fn] = (fn(grad, p, *st, **kw7), *st)
    torch.cuda.synchronize()
    err = max(check_close(f"K7 zero2 shard {nm}", a, b,
                          dict(rtol=1e-5, atol=1e-6 * float(b.abs().max())))
              for nm, a, b in zip("umv", outs[mt.lamb_stage1_kernel],
                                  outs[mt.lamb_stage1_torch]))
    u = outs[mt.lamb_stage1_kernel][0]
    st = (m.clone(), v.clone())
    bms, by = bound_ms(28 * n, 16 * n, torch.float32)
    tag = f"{n} fp32, rank 1 of BERT's world-2 arena, clip on"
    rows["lamb_stage1"]["zero2_shard"] = (tag, dict(
        max_abs_err=err, ms=time_ms(lambda: mt.lamb_stage1_kernel(grad, p, *st, **kw7)),
        plain_ms=time_ms(lambda: mt.lamb_stage1_torch(grad, p, *st, **kw7), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by, launches=0))
    line("K7", shape=tag, **rows["lamb_stage1"]["zero2_shard"][1])
    ratio = BERT_LR * (0.5 + torch.rand(bert_spec.num_tensors, generator=g, device="cuda"))
    outs = {}
    for fn in (mt.scaled_update_kernel, mt.scaled_update_torch):
        pk = p.clone()
        fn(pk, u, ratio, bert_spec, found_inf=None, copy_out=None, shard=seg)
        outs[fn] = pk
    torch.cuda.synchronize()
    pk, pr = outs[mt.scaled_update_kernel], outs[mt.scaled_update_torch]
    err = check_close("K8 zero2 shard", pk, pr,
                      dict(rtol=1e-6, atol=1e-6 * float(pr.abs().max())))
    first = mt._segment_tables(bert_spec, pk.device, seg.base, n)[0]
    pk = p.clone()
    bms, by = bound_ms(12 * n + 4 * bert_spec.num_tensors, 2 * n, torch.float32)
    tag = (f"{n} fp32, rank 1 of BERT's world-2 arena from tensor {int(first[0])} "
           f"of {bert_spec.num_tensors}, shard tables, no copy")
    rows["scaled_update"]["zero2_shard"] = (tag, dict(
        max_abs_err=err, ms=time_ms(lambda: mt.scaled_update_kernel(
            pk, u, ratio, bert_spec, found_inf=None, copy_out=None, shard=seg)),
        plain_ms=time_ms(lambda: mt.scaled_update_torch(
            pk, u, ratio, bert_spec, found_inf=None, copy_out=None, shard=seg), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by, launches=0))
    line("K8", shape=tag, **rows["scaled_update"]["zero2_shard"][1])
    return rows


# ------------------------------------------------------------ slice 21


# the two-level (slice x intra) spec of parallel_state.make_two_level_mesh
MS_AX = ("slice", "intra")
# the 2 x 2 carve on the card: four gloo ranks, batch 4 a rank (the batch
# 16 of the one-rank reference, ZERO_TWO_RANK_BATCH * 2)
MS_CARD_BATCH = 4
MS_CARD_TIMEOUT = 900
# the per-tier compression check runs on this many leading elements of the
# step's bf16-bucket gradient arena (an elementwise bound: a prefix of the
# real gradient is a fair sample, and it keeps gloo's host copies short)
MS_COMPRESS_ELEMS = 1 << 24
MS_COMBOS = ((False, False), (True, False), (False, True), (True, True))
# the optimizer-in-backward runs' reduction buckets (the hooks' and the
# per-bucket flags' geometry)
OIB_BUCKET_BYTES = 4 << 20


def ddp_gpt_trainer(amp, gpt, fused_adam, params, cfg, ddp):
    """The flagship's O5 FusedAdam step with DDP's reduce of the
    still-scaled gradient arenas before K5 (the ImageNet trainer's order),
    as a user script builds it: ``(m, state, step)``."""
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params,
                       fused_adam(lr=LR), "O5", arena_native=True)
    svag = amp.scaled_value_and_grad(
        lambda p, tok, tgt: gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply),
        m.scaler, reduce_grads=ddp.reduce)
    state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init()}

    def step(tok, tgt):
        loss, g, fi, state["scaler"] = svag(m.params, state["scaler"], tok, tgt)
        m.params, state["opt"] = m.optimizer.step(m.params, g, state["opt"],
                                                  found_inf=fi)
        return loss, g, fi

    return m, state, step


def ledger_calls(kinds=None):
    """The ledger's collectives (of ``kinds``, default all) as
    ``{"site:kind": calls}``."""
    from beforeholiday_tpu_torch.monitor import comms

    out = {}
    for r in comms.comms_records():
        if kinds is None or r["kind"] in kinds:
            key = f"{r['site']}:{r['kind']}"
            out[key] = out.get(key, 0) + r["calls"]
    return out


# the reductions, whose collectives a degenerate two-level carve issues
# exactly as the flat spelling does (JAX's contract); the flat gather over
# the mesh's joint group is kept at size 1, where the two-level gather
# drops both size-1 tiers, as JAX's does
REDUCE_KINDS = ("psum", "psum_scatter", "pmax", "pmin", "all_to_all")


def multislice_world1_phase(amp, gpt, fused_adam, comms, params, cfg, counters, card):
    """NCCL at world 1 with a ``("slice", "intra")`` spec on a 1 x 1 carve
    (``make_two_level_mesh(1, 1)``, entered): DDP, ZeRO-2 and ZeRO-3
    ("keep") with ``hierarchical=True``, each two steps at batch 2 bitwise
    its flat step over the same spec, with the same reductions on the
    ledger (both tiers are size 1, so both spellings drop them; the gathers
    are reported beside them, see REDUCE_KINDS); then
    ZeRO-2 hierarchical's timed and profiled run at batch 16 beside the
    flat ZeRO-2 median of this run. Returns its launch counts."""
    from beforeholiday_tpu_torch.parallel import DistributedDataParallel
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    t0 = time.perf_counter()
    batch = gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60), device="cuda")
    fields, failures = {}, []
    mesh = ps.make_two_level_mesh(1, 1)
    try:
        with mesh:
            for engine in ("ddp", "zero2", "zero3_keep"):
                res = {}
                for hier in (False, True):
                    comms.reset_comms_ledger()
                    if engine == "ddp":
                        m, state, step = ddp_gpt_trainer(
                            amp, gpt, fused_adam, params, cfg, DistributedDataParallel(
                                axis_name=MS_AX, bucket_bytes=DDP_BUCKET_BYTES,
                                hierarchical=hier))
                        for _ in range(2):
                            step(*batch)
                        out = list(m.params.arenas) + list(state["opt"]["master"])
                    elif engine == "zero2":
                        m, opt, state, step = zero_gpt_trainer(
                            amp, gpt, params, cfg, axis_name=MS_AX,
                            bucket_bytes=ZERO_BUCKET_BYTES, hierarchical=hier)
                        for _ in range(2):
                            step(*batch)
                        out = list(m.params.arenas) + [state["opt"]["master"]]
                    else:
                        opt, layout, state, step = zero3_gpt_trainer(
                            amp, gpt, params, cfg, "keep", 1, axis_name=MS_AX,
                            hierarchical=hier)
                        for _ in range(2):
                            step(*batch)
                        out = [state["opt"]["master"]]
                    torch.cuda.synchronize()
                    res[hier] = ([t.clone() for t in out], ledger_calls(REDUCE_KINDS),
                                 ledger_calls(("all_gather",)))
                    del out, state, step
                    torch.cuda.empty_cache()
                same = all(torch.equal(a, b) for a, b in zip(res[False][0], res[True][0]))
                fields[f"{engine}_bitwise_flat"] = same
                fields[f"{engine}_reductions"] = res[True][1]
                fields[f"{engine}_gathers"] = {"flat": res[False][2],
                                               "hierarchical": res[True][2]}
                if not same:
                    failures.append(f"{engine}: hierarchical is not bitwise flat")
                if res[True][1] != res[False][1]:
                    failures.append(f"{engine}: reductions {res[True][1]} against "
                                    f"flat's {res[False][1]}")
                del res
                torch.cuda.empty_cache()
            line("multislice_world1", backend="nccl", world=1, carve="'1 x 1'",
                 batch=PARITY_BATCH, steps=2, seconds=time.perf_counter() - t0,
                 **{k: json.dumps(v) for k, v in fields.items()})
            if failures:
                raise AssertionError("multislice_world1: " + "; ".join(failures))
            tb = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
            m, opt, state, step = zero_gpt_trainer(amp, gpt, params, cfg,
                                                   axis_name=MS_AX, hierarchical=True)
            launches = training_phase(
                "zero2_hier_training", "zero2_hier_profile", step, tb, counters,
                STEP_LAUNCHES["zero2"], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
                world=1, carve="'1 x 1'", optimizer="'DistributedFusedAdam'",
                hierarchical=True, flat_zero2_median_ms=MEDIANS.get("zero2_training"),
                **lm_work(m, tb))
            del m, opt, state, step
    finally:
        mesh.destroy()
    torch.cuda.empty_cache()
    return {"zero2_hier": launches}


def spawn_ranks(n, target, args_of, timeout, label):
    """``n`` spawned processes of ``target`` (``args_of(rank)``), joined
    under ``timeout``: their exit codes."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join(10)
        raise AssertionError(f"{label}: the world did not finish in {timeout} s; "
                             "its processes were killed")
    return [p.exitcode for p in procs]


def multislice_card_worker(rank, store, out_dir):
    """One rank of the 2 x 2 carve on the one card (a spawned process of a
    gloo world of 4 on CUDA tensors): the flagship at CARD_LAYERS layers
    (full width) from the parent's seeded weights, this rank's quarter of
    the batch-16 batch, inside
    ``make_two_level_mesh(2, 2)``. One step each of ZeRO-2 flat and
    hierarchical and ZeRO-3 ("keep") flat and hierarchical; on ZeRO-2's
    step-1 gradients the DDP reduce flat against hierarchical (and its DCN
    bytes), the four per-tier compression choices on a prefix of them
    against the exact reduce, and the consistency tripwire, clean and with
    rank 3 (slice 1) perturbed. Every flag is the AND over the ranks; rank
    0 saves the results."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=4)
        from beforeholiday_tpu_torch import amp
        from beforeholiday_tpu_torch.monitor import comms
        from beforeholiday_tpu_torch.optimizers.distributed_fused import layout_of_params
        from beforeholiday_tpu_torch.parallel import bucketing, distributed
        from beforeholiday_tpu_torch.parallel import parallel_state as ps
        from beforeholiday_tpu_torch.testing import gpt

        t0 = time.perf_counter()
        cfg = gpt.GPTConfig(**card_model())
        params = gpt.init(cfg, gen(0), device="cuda")
        tok, tgt = gpt.synthetic_batch(cfg, 4 * MS_CARD_BATCH, generator=gen(70),
                                       device="cuda")
        B = MS_CARD_BATCH
        batch = (tok[rank * B:(rank + 1) * B], tgt[rank * B:(rank + 1) * B])
        mesh = ps.make_two_level_mesh(2, 2)
        out, flags = {}, {}

        def all_ranks(ok):
            t = torch.tensor([float(ok)], device="cuda")
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            return bool(t.item())

        with mesh:
            runs = {}
            for name, hier in (("zero2_flat", False), ("zero2_hier", True)):
                m, opt, state, step = zero_gpt_trainer(
                    amp, gpt, params, cfg, axis_name=MS_AX,
                    bucket_bytes=ZERO_BUCKET_BYTES, hierarchical=hier)
                loss, g, fi = step(*batch)
                lay = layout_of_params(m.params)
                runs[name] = dict(model=[a.clone() for a in m.params.arenas],
                                  master=state["opt"]["master"].clone(),
                                  found_inf=bool(fi))
                if hier:
                    lt = loss.detach().float().reshape(1).clone()
                    dist.all_reduce(lt)
                    out["loss"] = float(lt) / 4
                    out["masters"] = zero_full_master(opt, m, state["opt"])
                    grads, model = g, m.params
                del opt, state, step
                if not hier:
                    del m, g
                torch.cuda.empty_cache()
            a, b = runs["zero2_flat"], runs["zero2_hier"]
            flags["zero2_bitwise_flat"] = all_ranks(
                torch.equal(a["master"], b["master"])
                and all(torch.equal(x, y) for x, y in zip(a["model"], b["model"])))
            flags["zero2_no_skip"] = all_ranks(not (a["found_inf"] or b["found_inf"]))
            z2_master = b["master"]
            del runs, a, b
            for name, hier in (("zero3_flat", False), ("zero3_hier", True)):
                opt, layout, state, step = zero3_gpt_trainer(
                    amp, gpt, params, cfg, "keep", 1, axis_name=MS_AX, hierarchical=hier)
                step(*batch)
                out[f"{name}_master"] = state["opt"]["master"].clone()
                del opt, layout, state, step
                torch.cuda.empty_cache()
            flags["zero3_bitwise_flat"] = all_ranks(torch.equal(
                out.pop("zero3_flat_master"), out["zero3_hier_master"]))
            # ZeRO-3's arena is in tree order, ZeRO-2's in packed order: the
            # shards differ in layout, so ZeRO-3 is held to its own flat step
            out.pop("zero3_hier_master")
            del z2_master
            # the DDP reduce of ZeRO-2's step-1 gradients (unscaled fp32)
            red = {}
            for hier in (False, True):
                comms.reset_comms_ledger()
                red[hier] = distributed.reduce_gradients(
                    grads, axis_name=MS_AX, bucket_bytes=DDP_BUCKET_BYTES,
                    hierarchical=hier)
                row = next(r for r in comms.comms_summary() if r["subsystem"] == "ddp")
                out[f"ddp_{'hier' if hier else 'flat'}_tiers"] = {
                    t: dict(v) for t, v in row["by_tier"].items()}
            flags["ddp_bitwise_flat"] = all_ranks(all(
                torch.equal(x, y) for x, y in zip(red[False].arenas, red[True].arenas)))
            out["grads"] = [x[: s.total].to("cpu", copy=True)
                            for x, s in zip(red[False].arenas, lay.packed.specs)]
            del red
            # per-tier compression on a prefix of the bf16 bucket's gradients
            x = grads.arenas[0][:MS_COMPRESS_ELEMS].contiguous()
            exact = bucketing.bucketed_psum(x, MS_AX, site="ms.exact",
                                            bucket_bytes=DDP_BUCKET_BYTES)
            sum_abs = bucketing.bucketed_psum(x.abs(), MS_AX, site="ms.abs",
                                              bucket_bytes=DDP_BUCKET_BYTES)
            excess = {}
            for ci, cd in MS_COMBOS:
                comp = bucketing.hierarchical_psum(
                    x, MS_AX, site="ms.comp", bucket_bytes=DDP_BUCKET_BYTES,
                    compress_intra=ci, compress_dcn=cd)
                bound = bucketing.hierarchical_compression_error_bound(
                    sum_abs, compress_intra=ci, compress_dcn=cd)
                excess[f"{int(ci)}{int(cd)}"] = float(((comp - exact).abs() - bound).max())
                if not (ci or cd):
                    flags["uncompressed_bitwise"] = all_ranks(torch.equal(comp, exact))
                del comp, bound
            flags["compression_within_bound"] = all_ranks(max(excess.values()) <= 0)
            out["compression_excess_over_bound"] = excess
            del x, exact, sum_abs, grads
            # the tripwire on the (replicated) model arenas
            clean = distributed.check_replicated_consistency(model, MS_AX)
            bad = model.replace_arenas([t.clone() for t in model.arenas])
            if rank == 3:
                bad.arenas[0][0] += 1.0
            tripped = distributed.check_replicated_consistency(bad, MS_AX)
            flags["tripwire_clean_passes"] = all_ranks(not bool(clean))
            flags["tripwire_slice1_trips_every_rank"] = all_ranks(bool(tripped))
            del bad, model
        out["flags"] = flags
        out["seconds"] = time.perf_counter() - t0
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        mesh.destroy()
        if rank == 0:
            torch.save(out, f"{out_dir}/ms_rank0.pt")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/ms_rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def multislice_card_phase(one_rank, tmp):
    """Four processes on the one card over gloo on CUDA tensors, a 2 x 2
    carve (a correctness run: gloo stages every collective through the
    host): the flags of :func:`multislice_card_worker` must all hold, the
    hierarchical reduce's DCN bytes be the flat reduce's / 2, and the 2 x 2
    ZeRO-2 step (batch 4 a rank) sit within ZERO_ROW of one NCCL rank at
    batch 16 (``one_rank``, from zero_world1's run)."""
    t0 = time.perf_counter()
    codes = spawn_ranks(4, multislice_card_worker,
                        lambda r: (r, f"{tmp}/ms_store", tmp), MS_CARD_TIMEOUT,
                        "multislice_card")
    if any(codes):
        errors = [open(f"{tmp}/ms_rank{r}.err").read() for r in range(4)
                  if os.path.exists(f"{tmp}/ms_rank{r}.err")]
        raise AssertionError(f"multislice_card: exit codes {codes}\n" + "\n".join(errors))
    res = torch.load(f"{tmp}/ms_rank0.pt")
    failures = [k for k, v in res["flags"].items() if not v]
    flat_dcn = res["ddp_flat_tiers"]["dcn"]["bytes"]
    hier_dcn = res["ddp_hier_tiers"]["dcn"]["bytes"]
    if flat_dcn != 2 * hier_dcn:
        failures.append(f"DCN bytes {hier_dcn} are not flat's {flat_dcn} / 2")
    errs = step_errors(dict(loss=res["loss"], grads=res["grads"],
                            masters=res["masters"]), one_rank)
    if out_of_bounds(errs, ZERO_ROW):
        failures.append(f"2 x 2 ZeRO-2 against one rank: {out_of_bounds(errs, ZERO_ROW)}")
    line("multislice_card", backend="gloo", world=4, carve="'2 x 2'", layers=CARD_LAYERS,
         device="'one card'", batch_per_rank=MS_CARD_BATCH, steps=1,
         note="'gloo stages every collective through the host: a correctness run, "
              "not a speed'",
         flags=json.dumps(res["flags"]),
         ddp_dcn_bytes=json.dumps({"flat": flat_dcn, "hierarchical": hier_dcn}),
         ddp_tiers=json.dumps({"flat": res["ddp_flat_tiers"],
                               "hierarchical": res["ddp_hier_tiers"]}),
         compression_prefix_elements=MS_COMPRESS_ELEMS,
         compression_excess_over_bound=json.dumps(res["compression_excess_over_bound"]),
         zero2_vs_one_rank=json.dumps(errs), bounds=json.dumps(ZERO_ROW),
         rank_seconds=res["seconds"], rank_peak_mem_gb=res["peak_mem_gb"],
         seconds=time.perf_counter() - t0)
    if failures:
        raise AssertionError("multislice_card: " + "; ".join(failures))


def oib_gpt_trainer(amp, gpt, fused_adam, params, cfg, loss_scale=None, poison=None):
    """The flagship's O5 FusedAdam step with the optimizer in the backward,
    as a user script builds it: the arena-native model's leaves (the
    blocks unbound per layer) through ``overlap.hook_tree`` (the
    backward-time reduce over the data axis), the scaled loss's tree
    gradients, ``MasterWeights.step_in_backward`` (K6's views mode on each
    arena, one folded flag) with the inverse loss scale, and the scaler's
    update on the flag. ``poison(grads)`` edits the gradients before the
    step. ``(m, state, step)``; ``step`` returns ``(loss, grads, flag)``."""
    from beforeholiday_tpu_torch.amp.frontend import differentiate
    from beforeholiday_tpu_torch.parallel import overlap

    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params, fused_adam(lr=LR),
                       "O5", arena_native=True, loss_scale=loss_scale)
    state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init()}

    def step(tok, tgt):
        sstate = state["scaler"]
        tree = m.params.unpack()
        tree = {**tree, "blocks": {k: v.unbind(0) for k, v in tree["blocks"].items()}}

        def objective(p):
            p = overlap.hook_tree(p, axis_name="data", bucket_bytes=OIB_BUCKET_BYTES)
            loss = gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply)
            return m.scaler.scale_loss(loss, sstate), loss

        loss, grads = differentiate(objective, tree)
        if poison is not None:
            poison(grads)
        m.params, state["opt"], flag = m.optimizer.step_in_backward(
            m.params, grads, state["opt"], grad_scale=1.0 / sstate["scale"],
            bucket_bytes=OIB_BUCKET_BYTES)
        state["scaler"] = m.scaler.update(sstate, flag)
        return loss.detach(), grads, flag

    return m, state, step


def oib_resnet_trainer(main_amp, cfg, weights, batch, loss_scale=None, poison=None):
    """The ImageNet trainer's O5 FusedSGD step with the optimizer in the
    backward (K10's views mode), built from the trainer's parts as a user
    script does: the hooked leaves, the scaled loss's tree gradients,
    ``MasterWeights.step_in_backward`` at the trainer's lr, the scaler's
    update on the folded flag and the new BN state. ``(tr, step)``;
    ``step(images, labels)`` returns ``(loss, grads, flag)``."""
    from beforeholiday_tpu_torch.amp.frontend import differentiate
    from beforeholiday_tpu_torch.parallel import overlap

    tr = resnet_trainer(main_amp, cfg, weights, "O5", batch,
                        **({} if loss_scale is None else dict(loss_scale=loss_scale)))
    m = tr.amp_model
    mean = torch.from_numpy(main_amp._MEAN).to("cuda")
    std = torch.from_numpy(main_amp._STD).to("cuda")

    def step(images, labels):
        sstate = tr.scaler_state
        x = (images.float() - mean) / std

        def objective(p):
            p = overlap.hook_tree(p, axis_name="data", bucket_bytes=OIB_BUCKET_BYTES)
            logits, new_bn = m.apply(p, tr.bn_state, x)
            loss = main_amp.softmax_cross_entropy(logits, labels)
            return m.scaler.scale_loss(loss, sstate), (loss, new_bn)

        (loss, new_bn), grads = differentiate(objective, tr.params.unpack())
        if poison is not None:
            poison(grads)
        tr.params, tr.opt_state, flag = m.optimizer.step_in_backward(
            tr.params, grads, tr.opt_state, grad_scale=1.0 / sstate["scale"],
            bucket_bytes=OIB_BUCKET_BYTES, lr=RESNET_LR)
        tr.scaler_state = m.scaler.update(sstate, flag)
        tr.bn_state = new_bn
        return loss.detach(), grads, flag

    return tr, step


def poison_one_leaf(grads):
    """An inf in one element of one leaf: one bucket of the step."""
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    leaves = tree_flatten(grads)[0]
    leaves[len(leaves) // 2].view(-1)[0] = float("inf")


def oib_parity_and_skip(label, make_phased, make_oib, batch, state_of, scale_of):
    """Two steps of the phased trainer and of the optimizer-in-backward one
    from the same weights on ``batch``: model arenas, masters, moments and
    step counts bitwise (``state_of(handle)`` snapshots them; ``make_*``
    return ``(handle, step)``). Then the skip: an inf in one leaf's
    gradient, a dynamic scale: every arena, master, moment and count
    unchanged, the flag set, the scale (``scale_of(handle)``) halved."""
    snaps = {}
    for name, make in (("phased", make_phased), ("oib", make_oib)):
        tr, step = make()
        for _ in range(2):
            _, _, fi = step(*batch)
        torch.cuda.synchronize()
        if bool(fi):
            raise AssertionError(f"{label} ({name}): found_inf set")
        snaps[name] = state_of(tr)
        del tr, step
        torch.cuda.empty_cache()
    (m1, ms1, mo1, c1), (m2, ms2, mo2, c2) = snaps["phased"], snaps["oib"]
    bitwise = (all(torch.equal(a, b) for a, b in zip(m1 + ms1 + mo1, m2 + ms2 + mo2))
               and c1 == c2 == [2] * len(c1))
    del snaps, m1, ms1, mo1, m2, ms2, mo2
    torch.cuda.empty_cache()
    tr, step = make_oib(loss_scale="dynamic", poison=poison_one_leaf)
    before = state_of(tr)
    scale = float(scale_of(tr))
    _, _, flag = step(*batch)
    torch.cuda.synchronize()
    after = state_of(tr)
    held = (bool(flag) and after[3] == before[3]
            and all(torch.equal(a, b) for a, b in zip(before[0] + before[1] + before[2],
                                                      after[0] + after[1] + after[2])))
    new_scale = float(scale_of(tr))
    del tr, step, before, after
    torch.cuda.empty_cache()
    line(label, batch=batch[0].shape[0], steps=2, bitwise_phased=bitwise,
         skip_held_everything=held, scale_before=scale, scale_after=new_scale)
    if not (bitwise and held and new_scale < scale):
        raise AssertionError(f"{label}: bitwise {bitwise}, skip held {held}, scale "
                             f"{scale} -> {new_scale}")


def bucket_pieces(layout, dtype):
    """The leaf shapes of ``layout``'s ``dtype`` arena in arena order, a
    stacked leaf as its per-layer pieces (what the optimizer-in-backward
    runs hand the views mode)."""
    b = layout.dtypes.index(dtype)
    out = []
    for i, shape in zip(layout.indices[b], layout.specs[b].shapes):
        if layout.stacked and layout.stacked[i]:
            out += [tuple(shape[1:])] * shape[0]
        else:
            out.append(tuple(shape))
    return out


def step_in_backward_phases(amp, gpt, main_amp, fused_adam, params, cfg, rcfg,
                            rweights, counters, flops_per_image, n_params, card):
    """NCCL at world 1: the flagship GPT at O5 on FusedAdam and ResNet-50 at
    O5 on FusedSGD with the overlap hooks and ``step_in_backward`` (K6's and
    K10's views mode): bitwise the phased step, the whole-step skip and the
    scale's backoff (:func:`oib_parity_and_skip`), then the timed and
    profiled runs beside the phased steps' medians, with the views tables
    built during them. Returns the launch counts by run."""
    from beforeholiday_tpu_torch.ops import multi_tensor as mt

    launches = {}
    # the GPT: the phased step is make_gpt_trainer's O5 FusedAdam step
    gpt_state = lambda t: snapshot(t[0], t[1])  # noqa: E731
    gpt_scale = lambda t: t[1]["scaler"]["scale"]  # noqa: E731

    def phased_gpt(**kw):
        m, state, step = make_gpt_trainer(amp, gpt, fused_adam, params, cfg, **kw)
        return (m, state), step

    def oib_gpt(**kw):
        m, state, step = oib_gpt_trainer(amp, gpt, fused_adam, params, cfg, **kw)
        return (m, state), step

    batch = gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60), device="cuda")
    oib_parity_and_skip("gpt_step_in_backward", phased_gpt, oib_gpt, batch, gpt_state,
                        gpt_scale)
    tb = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    m, _, step = oib_gpt_trainer(amp, gpt, fused_adam, params, cfg)
    built = mt.views_tables_built[0]
    launches["gpt_oib"] = training_phase(
        "gpt_oib_training", "gpt_oib_profile", step, tb, counters,
        STEP_LAUNCHES["gpt_oib"], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
        optimizer="'MasterWeights(FusedAdam).step_in_backward'",
        phased_median_ms=MEDIANS.get("training"), **lm_work(m, tb))
    line("gpt_oib_views_tables", built=mt.views_tables_built[0] - built,
         steps=WARMUP_STEPS + TIMED_STEPS + PROFILE_STEPS)
    del m, step
    torch.cuda.empty_cache()
    # ResNet-50: the phased step is the ImageNet trainer's own, cuDNN held
    # to its deterministic algorithms for the bitwise check
    def phased_resnet(**kw):
        tr = resnet_trainer(main_amp, rcfg, rweights, "O5", PARITY_BATCH)
        return tr, trainer_step(tr)

    def oib_resnet(**kw):
        return oib_resnet_trainer(main_amp, rcfg, rweights, PARITY_BATCH, **kw)

    images, labels = resnet_batch(rcfg, PARITY_BATCH, 64)
    torch.backends.cudnn.deterministic = True
    try:
        oib_parity_and_skip("resnet_step_in_backward", phased_resnet, oib_resnet,
                            (images, labels), resnet_state,
                            lambda tr: tr.scaler_state["scale"])
    finally:
        torch.backends.cudnn.deterministic = False
    tr, step = oib_resnet_trainer(main_amp, rcfg, rweights, RESNET_BATCH)
    built = mt.views_tables_built[0]
    launches["resnet_oib"] = training_phase(
        "resnet_oib_training", "resnet_oib_profile", step,
        resnet_batch(tr.cfg, RESNET_BATCH, 72), counters, STEP_LAUNCHES["resnet_oib"],
        RESNET_GROUPS, card, unit="images", units=RESNET_BATCH,
        flops=RESNET_BATCH * flops_per_image, peak=PEAK_BF16, image=RESNET_IMAGE,
        params=n_params, optimizer="'MasterWeights(FusedSGD).step_in_backward'",
        phased_median_ms=MEDIANS.get("resnet_training"))
    line("resnet_oib_views_tables", built=mt.views_tables_built[0] - built,
         steps=WARMUP_STEPS + TIMED_STEPS + PROFILE_STEPS)
    del tr, step
    torch.cuda.empty_cache()
    return launches


def views_kernel_rows(mt, gpt_pieces, resnet_pieces, launches):
    """K6's and K10's views mode at the arenas the optimizer-in-backward
    runs give them (the flagship's bf16 bucket, per-layer pieces; ResNet-50's
    bf16 bucket): each launch held against its per-leaf plain version (an
    fma's ulp) and bitwise against the arena launch on the packed
    gradients, a skipped step bitwise unchanged; timed beside the plain
    version and the library call over the leaf lists (``_fused_adamw_`` and
    ``_fused_sgd_``, fp32 gradients: they take no bf16 gradient beside fp32
    params). Bound: bytes, the gradient read in bf16 (2 B) and the arenas'
    elements the leaves cover: 28 B an element for K6 with a bf16 copy
    (p, m, v read and written 24, copy 2), 20 B for K10 (p and m 16, copy
    2). Returns the rows."""
    from beforeholiday_tpu_torch.ops.arena import flatten, make_spec

    rows_out = {"adam_views": {}, "sgd_views": {}}
    for kname, shapes, tag in (("adam_views", gpt_pieces, "gpt_o5_bf16"),
                               ("sgd_views", resnet_pieces, "resnet_o5_bf16")):
        spec = make_spec(shapes)
        g = gen(81)
        leaves = [1e-3 * torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                  for s in shapes]
        n, total = spec.padded_total, spec.total
        p = torch.zeros(n, device="cuda")
        p[:total] = 0.02 * torch.randn(total, generator=g, device="cuda")
        mom = torch.zeros(n, device="cuda")
        mom[:total] = 1e-4 * torch.randn(total, generator=g, device="cuda")
        v = torch.zeros(n, device="cuda")
        v[:total] = 1e-8 * torch.rand(total, generator=g, device="cuda")
        step_t = torch.full((), 4, dtype=torch.int32, device="cuda")
        if kname == "adam_views":
            bc1, bc2 = mt._bias_corrections(True, step_t, 0.9, 0.999)
            hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, bc1=bc1, bc2=bc2,
                         weight_decay=0.01, adam_w_mode=True, grad_scale=0.5)
            state = lambda: (p.clone(), mom.clone(), v.clone())  # noqa: E731
            views, arena, plain = mt.adam_views_kernel, mt.adam_kernel, mt.adam_views_torch
            nbytes, flops = 28 * total, 20 * total
        else:
            hyper = dict(lr=RESNET_LR, weight_decay=RESNET_WD, momentum=0.9,
                         dampening=0.0, nesterov=False,
                         first_run=torch.zeros((), dtype=torch.bool, device="cuda"),
                         wd_after_momentum=False, scale=0.5)
            state = lambda: (p.clone(), mom.clone())  # noqa: E731
            views, arena, plain = mt.sgd_views_kernel, mt.sgd_kernel, mt.sgd_views_torch
            nbytes, flops = 20 * total, 8 * total
        packed = flatten(leaves)[0]
        outs = {}
        for name in ("views", "arena", "plain", "skip"):
            st = state()
            cp = torch.zeros(n, dtype=torch.bfloat16, device="cuda")
            fi = torch.full((), name == "skip", dtype=torch.bool, device="cuda")
            kw = dict(found_inf=fi, copy_out=cp, **hyper)
            if name in ("views", "skip"):
                views(leaves, *st, spec, **kw)
            elif name == "arena":
                arena(packed, *st, **kw)
            else:
                plain(leaves, *st, spec, **kw)
            outs[name] = (*st, cp)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs["views"], outs["arena"])):
            raise AssertionError(f"{kname}: not bitwise the arena launch")
        if not (all(torch.equal(a, b) for a, b in zip(outs["skip"][:-1], state()))
                and not outs["skip"][-1].any()):
            raise AssertionError(f"{kname}: a skipped step changed state")
        # an fma's ulp, of the update where m's two terms nearly cancel (as
        # test_k6_matches_plain's atol allows)
        err = max(check_close(f"{kname} {tag}", a, b, dict(rtol=1e-6, atol=1e-9))
                  for a, b in zip(outs["views"][:-1], outs["plain"][:-1]))
        del outs
        st = state()
        cp = torch.zeros(n, dtype=torch.bfloat16, device="cuda")
        not_found = torch.zeros((), dtype=torch.bool, device="cuda")
        kw = dict(found_inf=not_found, copy_out=cp, **hyper)
        g32 = [t.float() for t in leaves]
        pv = [p_ for p_ in st[0][:total].split([math.prod(s) for s in shapes])]
        mv = [m_ for m_ in st[1][:total].split([math.prod(s) for s in shapes])]
        g32v = [t.reshape(-1) for t in g32]
        if kname == "adam_views":
            vv = [v_ for v_ in st[2][:total].split([math.prod(s) for s in shapes])]
            steps = [torch.full((), 4.0, device="cuda") for _ in shapes]
            library = lambda: torch._fused_adamw_(  # noqa: E731
                pv, g32v, mv, vv, [], steps, lr=LR, beta1=0.9, beta2=0.999,
                weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)
        else:
            library = lambda: torch._fused_sgd_(  # noqa: E731
                pv, g32v, mv, weight_decay=RESNET_WD, momentum=0.9, lr=RESNET_LR,
                dampening=0.0, nesterov=False, maximize=False, is_first_step=False)
        bms, by = bound_ms(nbytes, flops, torch.float32)
        fields = dict(max_abs_err=err, leaves=len(shapes),
                      ms=time_ms(lambda: views(leaves, *st, spec, **kw)),
                      plain_ms=time_ms(lambda: plain(leaves, *st, spec, **kw), iters=3),
                      library_ms=time_ms(library), bound_ms=bms, bound_by=by,
                      arena_launch_ms=time_ms(lambda: arena(packed, *st, **kw)))
        path = "gpt_oib" if kname == "adam_views" else "resnet_oib"
        fields["launches"] = launches[path][kname]
        rows_out[kname][path] = (f"{total} {len(shapes)} leaves bf16 g, copy bf16", fields)
        line(kname, shape=tag, **fields)
        del st, cp, leaves, packed, g32, g32v, pv, mv
        torch.cuda.empty_cache()
    return rows_out


# ------------------------------------------- slice 22: mixture of experts

# the flagship's MoE blocks (bench.py make_gpt_rung plus the JAX defaults and
# the moe_gpt example's): every second block's MLP a routed layer of 4
# experts, top-2, capacity factor 1.25; the MoE step launches K1-K6 as the
# dense step does (the router, the dispatch and the grouped GEMMs are
# library calls)
MOE = dict(moe_every=2, moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
STEP_LAUNCHES["moe_gpt"] = dict(STEP_LAUNCHES["gpt"])
MOE_LAYER_TOKENS = 4096  # moe_layer_card's routing group at the flagship's width
MOE_LAYER_CF = 8.0  # no drops: moe_layer against dense_oracle
# the example's step as four gloo ranks on the card: a carve (data, expert),
# sequences a rank, steps
MOE_EP_CARVES = ((2, 2), (1, 4))
MOE_EP_BATCH = 2
MOE_EP_STEPS = 3
MOE_EP_TIMEOUT = 900
# the ranks against the one-process reference: relative L2 of each leaf of
# the first step's reduced gradients (bf16 activations; the expert GEMMs run
# at other batch shapes there, and gloo sums in another order) and the
# relative gap of the mean loss (1.2e-6 measured on an NVIDIA H100 80GB
# HBM3 at 700.00 W)
MOE_EP_GRAD_TOL = 1e-2
MOE_EP_LOSS_TOL = 1e-4


def make_moe_gpt_trainer(amp, gpt, fused_adam, params, cfg, impl=None,
                         loss_scale=None, loss_weight=None):
    """The MoE GPT's step as a user script builds it: amp O5, arena-native,
    FusedAdam(lr=LR), the objective ``loss_and_aux``'s (the cross entropy
    plus the weighted router losses) through the amp-wrapped apply. The
    step's ``aux`` dict holds the last step's router scalars."""
    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl,
                              dropout_impl=impl)
    m = amp.initialize(lambda p, tok, tgt: gpt.loss_and_aux(p, tok, tgt, cfg),
                       params, fused_adam(lr=LR, impl=impl), "O5",
                       arena_native=True, loss_scale=loss_scale)
    seen = {}

    def loss_fn(p, tok, tgt, key):
        value, seen["aux"] = m.apply(p, tok, tgt)
        return value if loss_weight is None else value * loss_weight

    state, step = scaled_step(amp, m, loss_fn, impl)
    step.aux = seen
    return m, state, step


def moe_layer_card_phase(moe):
    """``moe_layer`` against the port's ``dense_oracle`` at the flagship's
    width (D 1024, F 4096, 4 experts, top-2), one group of
    MOE_LAYER_TOKENS tokens at capacity factor MOE_LAYER_CF (no drops), fp32
    and bf16: bitwise where cuBLAS's batched GEMM gives a row the same bits
    at C and at T rows, else within fp32's rtol 1e-5 (bf16: one ulp) and the
    gap printed; at capacity factor 1.0 the drop fraction against the
    analytic count (expert e keeps min(n1_e, C) first choices and
    min(n2_e, C - kept1_e) second ones); at the training step's group (16
    sequences, capacity factor 1.25, bf16) no op of the forward makes a
    tensor of the dense dispatch's T x E x C elements (every op's output
    recorded under a dispatch mode) and its peak memory beside that
    tensor's fp32 bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from beforeholiday_tpu_torch.moe.router import route_compact

    g = gen(80)
    D, E, T = MODEL["d_model"], MOE["moe_experts"], MOE_LAYER_TOKENS
    params = moe.init_experts(g, E, D, 4 * D, out_std=0.02 / math.sqrt(2 * MODEL["n_layers"]))
    w = torch.randn(D, E, generator=g, device="cuda") * 0.02
    x = torch.randn(T, D, generator=g, device="cuda")
    cfg = moe.MoEConfig(E, 2, MOE_LAYER_CF)
    C = cfg.capacity(T)
    dense_bytes = T * E * C * 4
    res = {}
    # (rtol, atol over the largest |ref|): fp32's reordering; bf16 one ulp
    for name, dt, (rtol, atol) in (("fp32", torch.float32, (1e-5, 1e-6)),
                                   ("bf16", torch.bfloat16, (2 ** -7, 2 ** -7))):
        xx = x.to(dt)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, aux = moe.moe_layer(xx, w, params, cfg)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        ref, _ = moe.dense_oracle(xx, w, params, cfg)
        if float(aux["moe_drop_fraction"]) != 0.0:
            raise AssertionError(f"moe_layer_card {name}: tokens dropped at cf {MOE_LAYER_CF}")
        if not torch.isfinite(y).all() or y.shape != (T, D) or y.dtype != dt:
            raise AssertionError(f"moe_layer_card {name}: bad output")
        bitwise = torch.equal(y, ref)
        err = max_err(y, ref)
        bound = rtol * ref.float().abs() + atol * float(ref.float().abs().max())
        if not bitwise and not bool(((y.float() - ref.float()).abs() <= bound).all()):
            raise AssertionError(f"moe_layer_card {name}: moe_layer vs dense_oracle {err}")
        res[name] = dict(bitwise=bitwise, max_abs_err=err, peak_extra_bytes=extra,
                         ms=time_ms(lambda: moe.moe_layer(xx, w, params, cfg)),
                         oracle_ms=time_ms(lambda: moe.dense_oracle(xx, w, params, cfg)))
        del y, ref
    cfg1 = moe.MoEConfig(E, 2, 1.0)
    C1 = cfg1.capacity(T)
    r = route_compact(moe.router_logits(x, w), cfg1, C1)
    e = r.expert.cpu().numpy()
    n1, n2 = np.bincount(e[0], minlength=E), np.bincount(e[1], minlength=E)
    kept1 = np.minimum(n1, C1)
    kept = int(kept1.sum() + np.minimum(n2, C1 - kept1).sum())
    want = float(np.float32(1.0) - np.float32(kept) / np.float32(2 * T))
    _, aux1 = moe.moe_layer(x, w, params, cfg1)
    got = float(aux1["moe_drop_fraction"])
    if got != want:
        raise AssertionError(f"moe_layer_card: drop fraction {got}, analytic {want}")

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    Tt = TRAIN_BATCH * MODEL["seq_len"]
    cfg_t = moe.MoEConfig(E, 2, MOE["moe_capacity_factor"])
    Ct = cfg_t.capacity(Tt)
    xt = torch.randn(Tt, D, generator=g, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with Largest() as largest:
        moe.moe_layer(xt, w, params, cfg_t)
    torch.cuda.synchronize()
    train_extra = torch.cuda.max_memory_allocated() - base
    if largest.numel >= Tt * E * Ct:
        raise AssertionError(f"moe_layer_card: an op made {largest.numel} elements, "
                             f"the dense dispatch's T x E x C is {Tt * E * Ct}")
    line("moe_layer_card", tokens=T, experts=E, d_model=D, d_ff=4 * D, capacity=C,
         capacity_factor=MOE_LAYER_CF, dense_tec_bytes=dense_bytes,
         train_group=Tt, train_capacity=Ct, train_tec_elements=Tt * E * Ct,
         train_largest_op_elements=largest.numel, train_peak_extra_bytes=train_extra,
         train_tec_fp32_bytes=Tt * E * Ct * 4,
         results=json.dumps(res), drop_capacity_factor=1.0, drop_capacity=C1,
         drop_fraction=got, analytic_drop_fraction=want,
         first_choices=json.dumps(n1.tolist()), second_choices=json.dumps(n2.tolist()))


def moe_gpt_step_parity_phase(amp, gpt, fused_adam):
    """One MoE step at batch 2, the flagship at full width and CARD_LAYERS
    layers (one MoE group), on the kernels against the plain path: loss,
    gradient arenas (the ``moe`` leaves in them) and masters at the dense
    step's rows."""
    pcfg = gpt.GPTConfig(**card_model(), **MOE)
    params = gpt.init(pcfg, gen(0), device="cuda")
    trainer = lambda **kw: make_moe_gpt_trainer(amp, gpt, fused_adam, params, pcfg, **kw)  # noqa: E731
    step_parity_phase("moe_gpt_step_parity", trainer, gpt.synthetic_batch(
        pcfg, PARITY_BATCH, generator=gen(60), device="cuda"), 2 * LR + 1e-6,
        "2 lr: a gradient sign flip")
    skip_phase("moe_gpt_skip_step", trainer, gpt.synthetic_batch(
        pcfg, PARITY_BATCH, generator=gen(61), device="cuda"))
    del params
    torch.cuda.empty_cache()


# the trace spans (profiler ranges) ``moe_layer`` opens around the whole layer and its parts
MOE_RANGES = ("moe_layer", "moe_router", "moe_dispatch", "moe_experts", "moe_combine")


def _kernels_under(evt, fragments=None):
    """Device ms of the kernels ``evt`` and its CPU children launched (with
    ``fragments``: of those whose name holds one)."""
    us = sum(k.duration for k in evt.kernels
             if fragments is None or any(f in k.name for f in fragments))
    return us / 1e3 + sum(_kernels_under(c, fragments) for c in evt.cpu_children)


def moe_split(prof, names):
    """Each range's device ms, forward (the kernels inside its device-side
    spans) and backward: the backward nodes whose sequence numbers the
    range's forward ops carry, each counted once with its children; with
    the GEMMs among them apart."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = [e for e in prof.events() if e.device_type != cuda]
    spans = {n: [(e.time_range.start, e.time_range.end, e.thread)
                 for e in cpu if e.name == n] for n in names}

    def inside(e, n):
        return any(a <= e.time_range.start and e.time_range.end <= b and th == e.thread
                   for a, b, th in spans[n])

    seqs = {n: {e.sequence_nr for e in cpu
                if getattr(e, "sequence_nr", -1) >= 0 and inside(e, n)} for n in names}
    out = {}
    for n in names:
        # the backward nodes: the same sequence numbers outside every forward
        # range (the autograd engine runs them later, on its own thread on
        # the card)
        chosen = [e for e in cpu if getattr(e, "sequence_nr", -1) in seqs[n]
                  and not any(inside(e, m) for m in names)]
        ids = {id(e) for e in chosen}

        def outer(e):
            p = e.cpu_parent
            while p is not None:
                if id(p) in ids:
                    return False
                p = p.cpu_parent
            return True

        top = [e for e in chosen if outer(e)]
        out[n] = dict(fwd=range_kernels_ms(prof, n, nested=names),
                      fwd_gemm=range_kernels_ms(prof, n, GEMM_FRAGMENTS, names),
                      bwd=sum(_kernels_under(e) for e in top),
                      bwd_gemm=sum(_kernels_under(e, GEMM_FRAGMENTS) for e in top))
    return out


def moe_profile(label, step, batch):
    """PROFILE_STEPS MoE steps under torch.profiler: busy, idle, the device
    time by layer, and the MoE layers' split into the router, the dispatch
    and combine, the expert FFN (its GEMMs apart) and the rest, forward and
    backward, per step, from the ranges ``moe_layer`` records
    (MOE_RANGES)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = MOE_RANGES
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, by_group = device_ms_by_group(prof, TRAIN_GROUPS, names)
    busy = sum(by_name.values())
    if busy == 0:
        line(label, device_time="not measured (no CUDA events in the trace)")
        return
    require_k1(label, by_group)
    per = 1.0 / PROFILE_STEPS
    parts = moe_split(prof, names)
    inner = [n for n in names if n != "moe_layer"]
    # the profiler gives a kernel's device span to its innermost range, and
    # every op of the layer's forward runs inside one of its four parts: the
    # layer's forward is theirs; its backward comes from the sequence numbers
    for k in ("fwd", "fwd_gemm"):
        parts["moe_layer"][k] = sum(parts[n][k] for n in inner)
    both = {n: (p["fwd"] + p["bwd"]) * per for n, p in parts.items()}
    experts = parts["moe_experts"]
    split = {
        "router": both["moe_router"],
        "dispatch_combine": both["moe_dispatch"] + both["moe_combine"],
        "experts": both["moe_experts"],
        "expert_gemms": (experts["fwd_gemm"] + experts["bwd_gemm"]) * per,
        # the layer's backward outside its four parts' nodes (should be ~0)
        "layer_unattributed": both["moe_layer"] - sum(both[n] for n in inner),
        "rest": busy * per - both["moe_layer"]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"{label}: " + json.dumps({
        "steps": PROFILE_STEPS, "wall_ms_per_step": wall_ms * per,
        "device_busy_ms_per_step": busy * per, "idle_share": 1.0 - busy / wall_ms,
        "moe_split_ms_per_step": split,
        "moe_parts_ms_per_step": {n: {k: v * per for k, v in p.items()}
                                  for n, p in parts.items()},
        "backward_attributed": parts["moe_layer"]["bwd"] > 0,
        "by_layer_ms_per_step": {k: v * per for k, v in by_group.items()},
        "top_kernels_ms_per_step": {k[:90]: v * per for k, v in top}}), flush=True)


def moe_gpt_training_phase(amp, gpt, fused_adam, monitor, cfg, counters, card):
    """The flagship GPT with MoE blocks (MOE) at full width, 8 layers,
    batch 16, amp O5 arena-native FusedAdam: FLOPs a step from the roofline
    ledger's ``FlopCounterMode`` count (one counted step), then the timed
    run (``training_phase``: median of TIMED_STEPS after WARMUP_STEPS,
    tokens/s, MFU against the counted FLOPs, peak GB, K1-K6 launches a
    step, no port host sync), the router's three scalars through
    ``TrainMonitor``, and the profiled split (:func:`moe_profile`)."""
    mcfg = dataclasses.replace(cfg, **MOE)
    params = gpt.init(mcfg, gen(0), device="cuda")
    m, _, step = make_moe_gpt_trainer(amp, gpt, fused_adam, params, mcfg)
    batch = gpt.synthetic_batch(mcfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    costs = monitor.estimate_costs(step, *batch)
    work = lm_work(m, batch)
    tokens = batch[0].numel()
    launches = training_phase(
        "moe_gpt_training", "moe_gpt_profile", step, batch, counters,
        STEP_LAUNCHES["moe_gpt"], TRAIN_GROUPS, card, unit="tokens", units=tokens,
        flops=costs["flops"], peak=PEAK_BF16, profile=False, seq_len=mcfg.seq_len,
        params=work["params"], flops_6n=work["flops"],
        flops_method=f"'{costs['method']}'", moe=f"'{json.dumps(MOE)}'",
        moe_groups=mcfg.moe_groups, capacity=mcfg.moe_cfg().capacity(tokens))
    loss, _, _ = step(*batch)
    mon = monitor.TrainMonitor()
    aux = {k: v.detach() for k, v in step.aux["aux"].items()}
    met = mon.unpack_host(mon.pack(mon.update(mon.init(), loss=loss.detach(),
                                              moe=aux)).cpu())
    if not all(np.isfinite(met[k]) for k in ("moe_aux_loss", "moe_z_loss",
                                             "moe_drop_fraction")):
        raise AssertionError(f"moe_gpt_router: {met}")
    line("moe_gpt_router", loss=met["loss"], moe_aux_loss=met["moe_aux_loss"],
         moe_z_loss=met["moe_z_loss"], moe_drop_fraction=met["moe_drop_fraction"],
         via="'TrainMonitor'")
    moe_profile("moe_gpt_profile", step, batch)
    del m, step, params
    torch.cuda.empty_cache()
    return launches


def moe_ep_spec(dp, ep):
    """The ported example's run (``moe_gpt.train``) at full width and
    CARD_LAYERS layers (flash attention, bf16 activations over fp32
    parameters, FusedAdam) on a dp x ep carve."""
    return dict(model={**card_model(), **MOE}, dp=dp, ep=ep, steps=MOE_EP_STEPS,
                batch=MOE_EP_BATCH, lr=3e-4, log_every=MOE_EP_STEPS, device="cuda")


def moe_ep_leaf_stats(res, ref, ep):
    """This rank's result of one carve against the reference, leaf by leaf
    (``ref``: the tree paths and the one-process run's first-step gradients
    and final parameters, the whole expert stack): the squared L2 of the
    gradient's difference and of the reference over the part this rank
    holds (its ``E / ep`` experts of an expert leaf), the parameters'
    largest difference there, and digests of the gradient and parameter
    bytes, which every rank holding that part must share."""
    stats = []
    for path, g, p, rg, rp in zip(ref["paths"], res["first_grads"], res["params"],
                                  ref["first_grads"], ref["params"]):
        rg, rp = rg.numpy(), rp.numpy()
        if "experts" in path:
            n = rg.shape[1] // ep
            cut = slice(res["expert_rank"] * n, (res["expert_rank"] + 1) * n)
            rg, rp = rg[:, cut], rp[:, cut]
        d = g.astype(np.float64) - rg
        stats.append(dict(d2=float(np.vdot(d, d)), r2=float(np.vdot(rg, rg.astype(np.float64))),
                          param_err=float(np.abs(p - rp).max()),
                          grad_digest=hashlib.sha1(g.tobytes()).hexdigest(),
                          param_digest=hashlib.sha1(p.tobytes()).hexdigest()))
    return stats


def moe_ep_card_worker(rank, store, out_dir, carves):
    """One rank of four gloo ranks on the one card: the example's
    ``train`` on each carve of ``carves``, compared here with the reference
    the parent saved (:func:`moe_ep_leaf_stats`); saves the losses, the
    ledger, the metrics and those statistics."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=4)
        from beforeholiday_tpu_torch.examples.simple.distributed import moe_gpt

        ref = torch.load(f"{out_dir}/moe_ep_ref.pt", mmap=True)
        out = {}
        for dp, ep in carves:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = moe_gpt.train(moe_ep_spec(dp, ep))
            seconds = time.perf_counter() - t0
            out[(dp, ep)] = dict(
                losses=res["losses"], ledger=res["ledger"], metrics=res["metrics"],
                expert_rank=res["expert_rank"], seconds=seconds,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                leaves=moe_ep_leaf_stats(res, ref, ep))
        dist.destroy_process_group()
        torch.save(out, f"{out_dir}/moe_ep_rank{rank}.pt")
    except BaseException:
        with open(f"{out_dir}/moe_ep_rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def moe_ep_card_phase(tmp):
    """The ported ``moe_gpt`` example's step as four gloo ranks on the card
    (a correctness run: gloo stages every exchange through the host), on a
    2 x 2 and a 1 x 4 (data x expert) carve, held against the one-process
    reference (every group with all experts local, the groups' losses
    averaged): each rank's reduced gradients of the first step (the expert
    stack assembled from the expert ranks; replicated leaves and an expert
    rank's shard bitwise equal on every rank that holds them) at relative
    L2 MOE_EP_GRAD_TOL a leaf, where a wrong reduction (the JAX example's
    mean over the expert group, a missing 1 / ep, a flipped sign) is off by
    0.5 or more; the mean loss each step at relative MOE_EP_LOSS_TOL; every
    parameter within 2 lr a step + 1e-6 (Adam's sign flips); the ledger's
    dispatch and combine calls and bytes exactly."""
    from beforeholiday_tpu_torch.examples.simple.distributed import moe_gpt
    from beforeholiday_tpu_torch.ops.arena import tree_paths
    from beforeholiday_tpu_torch.testing import gpt

    t0 = time.perf_counter()
    # one reference serves every carve (the same four groups, model and
    # steps); run first, it compiles every Triton variant the ranks launch
    # into the shared cache, which the four ranks then load
    spec = moe_ep_spec(1, 4)
    ref = moe_gpt.reference_steps(spec)
    paths = tree_paths(moe_gpt.initial_params(spec, "cpu"))
    torch.save({"paths": paths,
                "first_grads": [torch.from_numpy(g) for g in ref["first_grads"]],
                "params": [torch.from_numpy(p) for p in ref["params"]]},
               f"{tmp}/moe_ep_ref.pt")
    ref_losses = ref["losses"]
    del ref
    ref_s = time.perf_counter() - t0
    codes = spawn_ranks(4, moe_ep_card_worker,
                        lambda r: (r, f"{tmp}/moe_store", tmp, MOE_EP_CARVES),
                        MOE_EP_TIMEOUT, "moe_ep_card")
    if any(codes):
        errors = [open(f"{tmp}/moe_ep_rank{r}.err").read() for r in range(4)
                  if os.path.exists(f"{tmp}/moe_ep_rank{r}.err")]
        raise AssertionError(f"moe_ep_card: exit codes {codes}\n" + "\n".join(errors))
    ranks = [torch.load(f"{tmp}/moe_ep_rank{r}.pt", weights_only=False) for r in range(4)]
    spawn_s = time.perf_counter() - t0 - ref_s
    failures = []
    for dp, ep in MOE_EP_CARVES:
        spec = moe_ep_spec(dp, ep)
        res = [r[(dp, ep)] for r in ranks]
        cfg = gpt.GPTConfig(**spec["model"])
        loss = np.mean([r["losses"] for r in res], axis=0)
        loss_err = float(np.max(np.abs(loss - ref_losses) / np.abs(ref_losses)))
        if not loss_err < MOE_EP_LOSS_TOL:
            failures.append(f"{dp} x {ep}: losses {loss.tolist()} vs {ref_losses}")
        grad_rel, worst = {}, 0.0
        for i, path in enumerate(paths):
            # the part of the leaf each rank holds: its experts, or all of it
            held = {}
            for r in res:
                st = r["leaves"][i]
                first = held.setdefault(r["expert_rank"] if "experts" in path else 0, st)
                if (st["grad_digest"], st["param_digest"]) != (
                        first["grad_digest"], first["param_digest"]):
                    failures.append(f"{dp} x {ep}: {path} differs across the ranks "
                                    "that hold it")
            d2 = sum(st["d2"] for st in held.values())
            r2 = sum(st["r2"] for st in held.values())
            grad_rel[".".join(path)] = math.sqrt(d2 / r2) if r2 else math.sqrt(d2)
            worst = max([worst] + [st["param_err"] for st in held.values()])
        worst_grad = max(grad_rel.values())
        if not worst_grad <= MOE_EP_GRAD_TOL:
            failures.append(f"{dp} x {ep}: first-step grads, rel L2 {grad_rel}")
        tol = 2 * spec["lr"] * MOE_EP_STEPS + 1e-6
        if worst > tol:
            failures.append(f"{dp} x {ep}: params {worst} > {tol}")
        C = cfg.moe_cfg().capacity(MOE_EP_BATCH * cfg.seq_len)
        calls = cfg.moe_groups * MOE_EP_STEPS
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        payload = cfg.moe_experts * C * cfg.d_model * itemsize * calls
        ledger = {}
        for r in res:
            rows = {x["site"]: (x["calls"], x["bytes"]) for x in r["ledger"]}
            for site in ("moe.dispatch", "moe.combine", "moe.dispatch.bwd",
                         "moe.combine.bwd"):
                if rows.get(site) != (calls, payload):
                    failures.append(f"{dp} x {ep}: {site} {rows.get(site)} vs "
                                    f"{(calls, payload)}")
            ledger = rows
        line("moe_ep_card", backend="gloo", world=4, carve=f"'{dp} x {ep}'",
             layers=CARD_LAYERS, device="'one card'", batch_per_rank=MOE_EP_BATCH,
             steps=MOE_EP_STEPS, note="'gloo stages every exchange through the host: a "
             "correctness run, not a measurement of NCCL'",
             losses=json.dumps(loss.tolist()), ref_losses=json.dumps(ref_losses),
             loss_rel_err=loss_err, loss_tol=MOE_EP_LOSS_TOL,
             grad_rel_l2=worst_grad, grad_tol=MOE_EP_GRAD_TOL,
             grad_rel_l2_by_leaf=json.dumps(grad_rel),
             param_max_abs_err=worst, param_tol=tol,
             ledger=json.dumps({k: list(v) for k, v in ledger.items()}),
             rank_seconds=max(r["seconds"] for r in res),
             rank_step_seconds=max(r["seconds"] for r in res) / MOE_EP_STEPS,
             rank_peak_mem_gb=max(r["peak_mem_gb"] for r in res),
             metrics=json.dumps(res[0]["metrics"][-1][1]))
    torch.cuda.empty_cache()
    line("moe_ep_card_world", reference_seconds=ref_s, spawned_seconds=spawn_s,
         seconds=time.perf_counter() - t0)
    if failures:
        raise AssertionError("moe_ep_card: " + "; ".join(failures))


KERNEL_ROWS = (
    ("layer_norm_fwd", "cuda", "beforeholiday_tpu_torch/csrc/layer_norm_fwd.cu",
     "beforeholiday_tpu/ops/normalization.py:55"),
    ("flash_fwd", "cuda", "beforeholiday_tpu_torch/csrc/flash_fwd.cu",
     "beforeholiday_tpu/ops/attention.py:152"),
    ("layer_norm_bwd", "cuda", "beforeholiday_tpu_torch/csrc/layer_norm_bwd.cu",
     "beforeholiday_tpu/ops/normalization.py:69"),
    ("flash_bwd", "cuda", "beforeholiday_tpu_torch/csrc/flash_bwd.cu",
     "beforeholiday_tpu/ops/attention.py:305"),
    ("unscale", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:179"),
    ("adam", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:273"),
    ("lamb_stage1", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:455"),
    ("scaled_update", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:558"),
    ("l2norm", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:228"),
    ("sgd", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:376"),
    ("softmax_fwd", "triton", "beforeholiday_tpu_torch/ops/softmax.py",
     "beforeholiday_tpu/ops/softmax.py:48"),
    ("softmax_bwd", "triton", "beforeholiday_tpu_torch/ops/softmax.py",
     "beforeholiday_tpu/ops/softmax.py:63"),
    ("dropout_mask", "cuda", "beforeholiday_tpu_torch/csrc/dropout_mask.cu",
     "beforeholiday_tpu/testing/tpu_checks.py:84"),
    ("xent_fwd", "triton", "beforeholiday_tpu_torch/contrib/xentropy.py",
     "beforeholiday_tpu/contrib/xentropy.py:48"),
    ("xent_bwd", "triton", "beforeholiday_tpu_torch/contrib/xentropy.py",
     "beforeholiday_tpu/contrib/xentropy.py:64"),
    ("axpby", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:195"),
    ("adagrad", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:343"),
    ("novograd", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:514"),
    # K2's decode path in paged mode, reading the engine's pools in place
    ("paged_decode", "cuda", "beforeholiday_tpu_torch/csrc/flash_fwd.cu",
     "beforeholiday_tpu/ops/attention.py:152"),
    # K6's and K10's views mode: the gradient leaves read where they lie
    ("adam_views", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:273"),
    ("sgd_views", "triton", "beforeholiday_tpu_torch/ops/multi_tensor.py",
     "beforeholiday_tpu/ops/_pallas_mt.py:376"),
)


# ---- slice 23: elastic training and the autotuner --------------------------

# the elastic runs: ElasticTrainer's defaults at the flagship, generations
# every 2 committed steps, the newest 2 kept
ELASTIC_STEPS = 8
ELASTIC_EVERY = 2
ELASTIC_TIMEOUT = 600
# the two gloo ranks' resize drills: a step takes seconds (gloo stages the
# gather and the reduce-scatter through the host), so the watchdog's window
# spans two of them
RESIZE_BATCH = 8
RESIZE_HANG_TIMEOUT_S = 2.0
RESIZE_MAX_STEPS = 24
# the tuner's card subset of shipped_space(), its budget
TUNE_KNOBS = ("opt_level", "remat_policy", "prefetch")
TUNE_TRIALS, TUNE_STEPS, TUNE_ITERS = 6, 3, 1


def elastic_gpt_engine(amp, gpt, q8, guard_mod, params, cfg, opt_level="O5",
                       remat=None, prefetch=1):
    """The flagship's step on ``ZeRO3FusedAdam`` ("keep") under a StepGuard,
    as ``ElasticTrainer`` wants it: ``(cast params, layout, opt, guard,
    make_step)``. ``make_step(mesh, world)`` returns ``step(state, gstate,
    batch)``: this rank's rows of the global batch, the scaled loss through
    the gathered params (O6: in the history's fp8 scope, the amax
    observations into the guard), the flags and observations agreed over
    the ranks, ``apply_sharded_update`` with the inverse scale; the row is
    the ranks' mean loss."""
    from contextlib import nullcontext

    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, zero3

    mcfg = remat_cfg(cfg, remat) if remat else cfg
    m = amp.initialize(lambda p, t: gpt.forward(p, t, mcfg), params, None, opt_level)
    cast, m.params = m.params, None
    opt = ZeRO3FusedAdam(lr=LR, prefetch=prefetch, param_residency="keep")
    layout = zero3.layout_of(cast)
    guard = guard_mod.StepGuard(m.scaler)

    def scaled_loss(master, tok, tgt, sstate):
        p = opt.gather_params(master, layout)
        p = {**p, "blocks": {k: v.unbind(0) for k, v in p["blocks"].items()}}
        return m.scaler.scale_loss(gpt.loss_fn(p, tok, tgt, mcfg, forward_fn=m.apply),
                                   sstate)

    wrapped = opt.wrap_residency(scaled_loss)

    def make_step(mesh, world):
        r = mesh.axis_index("data")

        def agree(t, op):
            return t if world == 1 else op(t, "data", site="elastic.step")

        def step(state, gstate, batch):
            tok, tgt = batch
            b = tok.shape[0] // world
            tok, tgt = tok[r * b:(r + 1) * b], tgt[r * b:(r + 1) * b]
            sstate = gstate["scaler"]
            scale = sstate["scale"]
            sw, sg = m.scaler.quantized_scales(sstate)
            master = state["master"].detach().requires_grad_(True)
            with nullcontext() if sw is None else q8.quantized_scope(sw, sg):
                value = wrapped(master, tok, tgt, sstate)
                value.backward()
            g = master.grad
            verdict = {k: agree(v.to(torch.int32), comms.pmax) > 0
                       for k, v in guard.check_grads(value.detach(), g).items()}
            if sw is not None:
                verdict["amax"] = (agree(q8.amax_of_tree(state["master"]), comms.pmax),
                                   agree(q8.amax_of_tree(g), comms.pmax))
            state, gstate = guard.apply_sharded_update(opt, state, g, gstate, verdict,
                                                       grad_scale=1.0 / scale)
            loss = agree(value.detach().float() / scale, comms.psum) / world
            return state, gstate, {"loss": loss}

        return step

    return cast, layout, opt, guard, make_step


def elastic_trainer(etr, engine, directory, **kw):
    cast, layout, opt, guard, make_step = engine
    return etr.ElasticTrainer(opt, layout, make_step, directory=directory, guard=guard,
                              **kw)


def state_digest(state):
    """sha256 of the shard triplet and the step count, on the host."""
    h = hashlib.sha256()
    for k in ("master", "exp_avg", "exp_avg_sq", "step"):
        h.update(state[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def stamped(batch, stamps):
    """``batch_fn`` that books the wall clock at each step's start."""
    def fn(step):
        stamps.append(time.perf_counter())
        return batch
    return fn


def step_ms(stamps, end):
    """Each step's wall ms from the stamps at the steps' starts; the first
    step (warm-up) dropped."""
    edges = stamps + [end]
    return [1e3 * (b - a) for a, b in zip(edges[1:-1], edges[2:])]


def elastic_ckpt_card_phase(etr, amp, gpt, q8, guard_mod, cfg, counters, card, tmp):
    """``ElasticTrainer`` on the flagship at world 1 over NCCL (O5, ZeRO-3
    "keep", batch 16): ELASTIC_STEPS steps with a generation every
    ELASTIC_EVERY (keep 2) against the same steps without checkpoints —
    each step's wall ms, the ``ckpt`` ledger, the launches; the final shard
    and every loss bitwise; then the uninterrupted run goes 2 steps further
    and a fresh trainer restored from the newest generation takes the same
    2 steps, bitwise. A step's ms runs from one step's start to the next's
    (the poll, the step, the row read, a submit); the last step ends when
    ``run`` returns, before the drain. Returns the uninterrupted run's
    losses and digest at ELASTIC_STEPS (the SIGKILL drill's reference)."""
    params = gpt.init(cfg, gen(0), device="cuda")
    engine = elastic_gpt_engine(amp, gpt, q8, guard_mod, params, cfg)
    del params
    batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    etr.reset_ckpt_ledger()
    runs = {}
    for name, every in (("with_ckpt", ELASTIC_EVERY), ("without", 0)):
        stamps = []
        tr = elastic_trainer(etr, engine, f"{tmp}/{name}", checkpoint_every=every, keep=2)
        tr.init(engine[0])
        for fn in counters.values():
            fn.launches = 0
        rows = tr.run(ELASTIC_STEPS, stamped(batch, stamps))
        torch.cuda.synchronize()
        end = time.perf_counter()
        if every:
            tr._manager.wait()  # the last generations land (booked "wait")
        runs[name] = dict(ms=step_ms(stamps, end), losses=[r["loss"] for r in rows],
                          digest=state_digest(tr.state), trainer=tr,
                          launches={k: fn.launches for k, fn in counters.items()
                                    if fn.launches})
        if every:
            tr.close()
            runs[name]["trainer"] = None
            summary = etr.ckpt_summary()
    a, b = runs["with_ckpt"], runs["without"]
    if a["losses"] != b["losses"] or a["digest"] != b["digest"]:
        raise AssertionError(f"elastic_ckpt_card: checkpointing changed the run: "
                             f"{a['losses']} vs {b['losses']}")
    if a["launches"].get("adam") != ELASTIC_STEPS or a["launches"] != b["launches"]:
        raise AssertionError(f"elastic_ckpt_card: launches {a['launches']} vs "
                             f"{b['launches']}")
    gens = [s for s, _, d in etr.list_generations(f"{tmp}/with_ckpt") if d]
    if gens != [ELASTIC_STEPS - ELASTIC_EVERY, ELASTIC_STEPS]:
        raise AssertionError(f"elastic_ckpt_card: durable generations {gens}")
    reference = dict(losses=b["losses"], digest=b["digest"])
    # 2 more steps: the uninterrupted run against a restore of the newest
    tail = b["trainer"].run(2, lambda s: batch)
    b_digest = state_digest(b["trainer"].state)
    b["trainer"].close()
    del b["trainer"]
    tr = elastic_trainer(etr, engine, f"{tmp}/with_ckpt", checkpoint_every=0)
    t0 = time.perf_counter()
    resumed = tr.restore(world=1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    again = tr.run(2, lambda s: batch)
    if resumed != ELASTIC_STEPS or [r["loss"] for r in again] != [r["loss"] for r in tail] \
            or state_digest(tr.state) != b_digest:
        raise AssertionError("elastic_ckpt_card: the restored generation did not "
                             "continue bitwise")
    tr.close()
    del tr, engine
    torch.cuda.empty_cache()
    phases = {r["phase"]: (r["calls"], round(r["seconds"], 4)) for r in summary["phases"]}
    n = summary["generations"]
    submits = [i % ELASTIC_EVERY == 0 for i in range(2, ELASTIC_STEPS + 1)]
    line("elastic_ckpt_card", steps=ELASTIC_STEPS, every=ELASTIC_EVERY,
         median_ms_with_ckpt=float(np.median(a["ms"])),
         median_ms_without=float(np.median(b["ms"])),
         median_ms_between_generations=float(np.median(
             [x for x, sub in zip(a["ms"], submits) if not sub])),
         ckpt_step_ms=[round(x, 2) for x, sub in zip(a["ms"], submits) if sub],
         generations=n, generation_bytes=summary["bytes"] // max(1, n),
         exposed_s_per_generation=summary["exposed_s"] / max(1, n),
         write_s_per_generation=phases.get("write", (0, 0.0))[1] / max(1, n),
         serialize_s_per_generation=phases.get("serialize", (0, 0.0))[1] / max(1, n),
         hidden_fraction=summary["hidden_fraction"], phases=json.dumps(phases),
         restore_s=restore_s, launches=json.dumps(a["launches"]),
         bitwise="losses,shard,restore+2", card=f"'{card}'")
    return reference


class _Proc:
    """The ``subprocess.Popen`` surface ``faults.kill_rank`` drives, over a
    ``multiprocessing`` process."""

    def __init__(self, proc):
        self.proc = proc

    def send_signal(self, sig):
        os.kill(self.proc.pid, sig)

    def wait(self, timeout=None):
        self.proc.join(timeout)
        return self.proc.exitcode


def elastic_kill_child(mode, directory, out):
    """A spawned process of the SIGKILL drill: one NCCL rank on the card and
    the flagship's elastic run. ``train`` runs ELASTIC_STEPS steps with a
    generation every ELASTIC_EVERY (it is killed on the way); ``resume``
    restores the newest durable generation at world 1 and runs to
    ELASTIC_STEPS without writing generations, then saves its losses, the
    digest of its shard and the restore's and a reshard's seconds."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        os.makedirs(f"{out}/{mode}_store")
        init_nccl(f"{out}/{mode}_store")
        from beforeholiday_tpu_torch import amp, elastic as etr, guard as guard_mod
        from beforeholiday_tpu_torch.ops import quantized as q8
        from beforeholiday_tpu_torch.optimizers import zero3
        from beforeholiday_tpu_torch.testing import gpt

        cfg = gpt.GPTConfig(**MODEL)
        engine = elastic_gpt_engine(amp, gpt, q8, guard_mod,
                                    gpt.init(cfg, gen(0), device="cuda"), cfg)
        batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
        tr = elastic_trainer(etr, engine, directory, keep=2,
                             checkpoint_every=ELASTIC_EVERY if mode == "train" else 0)
        if mode == "train":
            tr.init(engine[0])
            tr.run(ELASTIC_STEPS, lambda s: batch)
            tr._manager.wait()
            time.sleep(ELASTIC_TIMEOUT)  # the parent kills it first
            raise AssertionError("the training child was meant to be killed")
        t0 = time.perf_counter()
        resumed = tr.restore(world=1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        manifest, shards = zero3.load_shard_files(etr.latest_generation(directory)[1])
        t0 = time.perf_counter()
        zero3.reshard_state(shards, manifest, 1)
        reshard_s = time.perf_counter() - t0
        rows = tr.run(ELASTIC_STEPS - resumed, lambda s: batch)
        torch.save(dict(resumed=resumed, losses=[r["loss"] for r in rows],
                        digest=state_digest(tr.state), restore_s=restore_s,
                        reshard_s=reshard_s), f"{out}/resume.pt")
        tr.close()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}/{mode}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def elastic_kill_card_phase(etr, faults, reference, card, tmp):
    """The SIGKILL drill: a spawned child trains the flagship's elastic run;
    once generation 4 is durable the parent waits (a while) for the next
    generation's directory to appear and SIGKILLs the child with
    ``faults.kill_rank``, mid-write if the timing allows. A fresh child
    restores at world 1 and runs to ELASTIC_STEPS: its losses and final
    shard bitwise ``elastic_ckpt_card``'s uninterrupted run."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    directory = f"{tmp}/kill"
    os.makedirs(directory)
    child = ctx.Process(target=elastic_kill_child, args=("train", directory, tmp))
    t0 = time.perf_counter()
    child.start()
    first, nxt = 4, 4 + ELASTIC_EVERY
    while True:
        latest = etr.latest_generation(directory)
        if latest is not None and latest[0] >= first:
            break
        if not child.is_alive() or time.perf_counter() - t0 > ELASTIC_TIMEOUT:
            raise AssertionError(f"elastic_kill_card: the child ended or stalled "
                                 f"before generation {first} (exit {child.exitcode})")
        time.sleep(0.01)
    torn_dir = etr.generation_dir(directory, nxt)
    deadline = time.perf_counter() + 30
    while not os.path.isdir(torn_dir) and time.perf_counter() < deadline \
            and child.is_alive():
        time.sleep(0.002)
    code = faults.kill_rank(_Proc(child))
    mid_write = os.path.isdir(torn_dir) and not os.path.exists(f"{torn_dir}/manifest.json")
    if code != -9:
        raise AssertionError(f"elastic_kill_card: the child exited {code}, not by SIGKILL")
    gens = [(s, d) for s, _, d in etr.list_generations(directory)]
    codes = spawn_ranks(1, elastic_kill_child, lambda r: ("resume", directory, tmp),
                        ELASTIC_TIMEOUT, "elastic_kill_card")
    if codes != [0]:
        err = f"{tmp}/resume.err"
        raise AssertionError("elastic_kill_card: the resumed child failed:\n" + (
            open(err).read() if os.path.exists(err) else str(codes)))
    res = torch.load(f"{tmp}/resume.pt")
    want = reference["losses"][res["resumed"]:]
    ok = res["losses"] == want and res["digest"] == reference["digest"]
    if not ok:
        raise AssertionError(f"elastic_kill_card: resumed at {res['resumed']}, losses "
                             f"{res['losses']} vs {want}, digest "
                             f"{res['digest'] == reference['digest']}")
    line("elastic_kill_card", killed_exit=code, generations_at_kill=json.dumps(gens),
         mid_write=mid_write, resumed_from=res["resumed"],
         restore_s=res["restore_s"], reshard_s=res["reshard_s"],
         bitwise="losses,shard", seconds=time.perf_counter() - t0, card=f"'{card}'")


def elastic_resize_worker(rank, store, out_dir, tmp):
    """One of two gloo ranks on the card: the flagship at full width and 2
    of its 8 layers, batch RESIZE_BATCH a rank, three elastic runs from a
    fresh start — a preemption naming world 1, a hang (``hang_rank`` silences
    rank 1's beats while it keeps stepping), a tripwire (a replicated value
    perturbed on rank 1). Rank 0 holds each continuation against a fresh
    world-1 trainer restored from a copy of the generation the run resumed
    from: losses and final shard bitwise; rank 1 leaves every run."""
    import shutil

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        from beforeholiday_tpu_torch import amp, elastic as etr, guard as guard_mod
        from beforeholiday_tpu_torch.ops import quantized as q8
        from beforeholiday_tpu_torch.parallel import check_replicated_consistency
        from beforeholiday_tpu_torch.testing import faults, gpt

        cfg = gpt.GPTConfig(**card_model())
        engine = elastic_gpt_engine(amp, gpt, q8, guard_mod,
                                    gpt.init(cfg, gen(0), device="cuda"), cfg)
        batch = gpt.synthetic_batch(cfg, 2 * RESIZE_BATCH, generator=gen(70),
                                    device="cuda")
        cast, layout, opt, guard, make_step = engine
        calls = {"n": 0}

        def tripped(mesh, world):
            inner = make_step(mesh, world)

            def step(state, gstate, b):
                calls["n"] += 1
                state, gstate, row = inner(state, gstate, b)
                seen = {"loss": row["loss"]}
                if calls["n"] == 3:
                    seen = faults.perturb_rank_grads(seen, "data", rank=1)
                row["mismatch"] = check_replicated_consistency(seen, "data",
                                                               site="elastic.tripwire")
                return state, gstate, row

            return step

        out = {}
        for name in ("preemption", "hang", "tripwire"):
            calls["n"] = 0
            d = f"{tmp}/{name}"
            kw, preemption = {}, None
            if name == "preemption":
                preemption = faults.preempt_after(3, surviving_world=1)
            if name == "hang":
                wd = etr.HangWatchdog(2, hang_timeout_s=RESIZE_HANG_TIMEOUT_S,
                                      poll_interval_s=0.05)
                faults.hang_rank(wd, 1, after_step=2)
                kw["watchdog"] = wd.start()
            step_factory = tripped if name == "tripwire" else make_step
            tr = etr.ElasticTrainer(opt, layout, step_factory, directory=f"{d}/live",
                                    guard=guard, checkpoint_every=ELASTIC_EVERY, keep=8,
                                    **kw)
            t0 = time.perf_counter()
            tr.init(cast)
            # a step at a time until the event (the hang's step is the
            # watchdog's to pick), then 2 more on the survivor
            while not tr.events and tr.global_step < RESIZE_MAX_STEPS:
                tr.run(1, lambda s: batch, preemption=preemption)
            if not tr.retired:
                tr.run(2, lambda s: batch)
            if name == "hang":
                wd.stop()
            rec = {"events": [dataclasses.asdict(e) for e in tr.events],
                   "retired": tr.retired, "seconds": time.perf_counter() - t0}
            if not tr.retired:
                tr._manager.wait()
                ev = tr.events[-1]
                tail = [r["loss"] for r in tr.history if r["step"] > ev.resumed_from
                        and r["world"] == 1]
                final = {k: v.clone() for k, v in tr.state.items()}
                shutil.copytree(etr.generation_dir(f"{d}/live", ev.resumed_from),
                                etr.generation_dir(f"{d}/ref", ev.resumed_from))
            tr.close()
            ref = etr.ElasticTrainer(opt, layout, make_step, directory=f"{d}/ref",
                                     guard=guard, checkpoint_every=0)
            if not tr.retired:
                ref.restore(world=1)
                again = [r["loss"] for r in ref.run(len(tail), lambda s: batch)]
                rec["bitwise"] = (again == tail and all(
                    torch.equal(final[k], ref.state[k]) for k in final))
                rec["tail"] = tail
            ref.close()
            out[name] = rec
            del tr, ref
            torch.cuda.empty_cache()
        torch.save(out, f"{out_dir}/resize_rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_dir}/resize_rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def elastic_resize_card_phase(card, tmp):
    """Two gloo ranks on the card (:func:`elastic_resize_worker`): each
    ResizeEvent with its stall, rank 0's continuations bitwise their fresh
    world-1 restores, rank 1 gone from every run."""
    codes = spawn_ranks(2, elastic_resize_worker,
                        lambda r: (r, f"{tmp}/resize_store", tmp, f"{tmp}/runs"),
                        ELASTIC_TIMEOUT, "elastic_resize_card")
    if codes != [0, 0]:
        errs = [open(f"{tmp}/resize_rank{r}.err").read() for r in range(2)
                if os.path.exists(f"{tmp}/resize_rank{r}.err")]
        raise AssertionError(f"elastic_resize_card: exit codes {codes}\n" + "\n".join(errs))
    res = [torch.load(f"{tmp}/resize_rank{r}.pt") for r in range(2)]
    for name, rec in res[0].items():
        other = res[1][name]
        want = {"preemption": "preemption", "hang": "hang", "tripwire": "tripwire"}[name]
        evs = rec["events"]
        same = [{k: v for k, v in e.items() if k != "stall_s"} for e in evs] == \
            [{k: v for k, v in e.items() if k != "stall_s"} for e in other["events"]]
        if [e["reason"] for e in evs] != [want] or evs[0]["new_world"] != 1 \
                or rec["retired"] or not rec["bitwise"] or not other["retired"] \
                or not same:
            raise AssertionError(f"elastic_resize_card {name}: {rec} / rank 1 {other}")
        e = evs[0]
        line("elastic_resize_card", run=name, reason=e["reason"], at_step=e["at_step"],
             worlds=f"{e['old_world']}->{e['new_world']}", resumed_from=e["resumed_from"],
             stall_s=e["stall_s"], continued_steps=len(rec["tail"]),
             run_seconds=rec["seconds"], rank1="left", bitwise="losses,shard",
             card=f"'{card}'")


def tune_card_phase(amp, gpt, q8, guard_mod, tune, monitor, cfg, card, tmp):
    """``tune()`` over ``shipped_space()``'s TUNE_KNOBS (opt_level O5/O6, the
    four remat policies, ZeRO-3 prefetch) on the flagship's ZeRO-3 step at
    world 1 over NCCL: TUNE_TRIALS trials of TUNE_STEPS steps, each warmed
    up, its costs and memory registered under the trial's entry
    (``measure_costs``, ``measure_memory``), its steps timed with CUDA
    events and one synchronize. Then the same key again is a cache hit with
    0 trials; ``amp.initialize(tuned=True)`` and ``ZeRO3FusedAdam(tuned=
    True)`` take the manifest's ``opt_level`` and ``prefetch``, an explicit
    keyword wins, and a manifest miss warns once and keeps the defaults."""
    import logging

    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam
    from beforeholiday_tpu_torch.parallel.parallel_state import carve_data_mesh
    from beforeholiday_tpu_torch.utils.logging import reset_warn_once

    params = gpt.init(cfg, gen(0), device="cuda")
    tok, tgt = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    mesh = carve_data_mesh(1)
    space = tune.shipped_space().subset(TUNE_KNOBS)
    monitor.reset_roofline_ledger()
    monitor.reset_memory_ledger()

    def trial(config, steps, entry):
        cast, layout, opt, guard, make_step = elastic_gpt_engine(
            amp, gpt, q8, guard_mod, params, cfg, opt_level=config["opt_level"],
            remat=None if config["remat_policy"] == "none" else config["remat_policy"],
            prefetch=config["prefetch"])
        with mesh:
            step = make_step(mesh, 1)
            box = {"state": opt.init(cast)}
            box["gstate"] = guard.init(box["state"])
            del cast

            def one(state, gstate, tok, tgt):
                box["state"], box["gstate"], row = step(state, gstate, (tok, tgt))
                return row["loss"]

            def go():
                return one(box["state"], box["gstate"], tok, tgt)

            go()  # warm-up: the first step allocates, the second settles
            go()
            monitor.measure_costs(one, box["state"], box["gstate"], tok, tgt, entry=entry)
            monitor.measure_memory(one, box["state"], box["gstate"], tok, tgt, entry=entry)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                go()
            end.record()
            end.synchronize()
        del box, step, opt, guard
        torch.cuda.empty_cache()
        return start.elapsed_time(end) / 1e3

    key = tune.tuning_key(params)
    path = f"{tmp}/tune-manifest.json"
    t0 = time.perf_counter()
    res = tune.tune(trial, space, key, manifest=path, max_trials=TUNE_TRIALS,
                    steps_per_trial=TUNE_STEPS, iters=TUNE_ITERS)
    search_s = time.perf_counter() - t0
    for rec in res.records:
        line("tune_trial", entry=rec.entry, config=json.dumps(rec.config),
             ms_per_step=None if rec.cost_s is None else 1e3 * rec.cost_s,
             steps=rec.steps, peak_temp_bytes=rec.evidence.get("peak_temp_bytes"),
             bound=rec.evidence.get("bound"), pruned=rec.pruned, card=f"'{card}'")
    again = tune.tune(trial, space, key, manifest=path, max_trials=TUNE_TRIALS)
    if res.trials != TUNE_TRIALS or res.cache_hit or not again.cache_hit \
            or again.trials != 0 or again.config != res.config:
        raise AssertionError(f"tune_card: {res.trials} trials, then hit "
                             f"{again.cache_hit} with {again.trials} trials")
    # the constructors resolve the manifest's entry; explicit keywords win
    fn = lambda p, t: gpt.forward(p, t, cfg)  # noqa: E731
    m = amp.initialize(fn, params, None, tuned=True, tuning_manifest=path)
    z3 = ZeRO3FusedAdam(lr=LR, tuned=True, tuning_key=key, tuning_manifest=path)
    explicit = (amp.initialize(fn, params, None, "O5", tuned=True,
                               tuning_manifest=path).policy.opt_level,
                ZeRO3FusedAdam(lr=LR, prefetch=0, tuned=True, tuning_key=key,
                               tuning_manifest=path).prefetch)
    reset_warn_once(("tune.resolve", "amp.initialize"))
    reset_warn_once(("tune.resolve", "zero3"))
    seen = []

    class Capture(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Capture()
    logging.getLogger("beforeholiday_tpu_torch").addHandler(handler)
    try:
        missing = f"{tmp}/missing.json"
        miss = [amp.initialize(fn, params, None, tuned=True,
                               tuning_manifest=missing).policy.opt_level
                for _ in range(2)]
        miss += [ZeRO3FusedAdam(lr=LR, tuned=True, tuning_key=key,
                                tuning_manifest=missing).prefetch for _ in range(2)]
    finally:
        logging.getLogger("beforeholiday_tpu_torch").removeHandler(handler)
    warned = len([s for s in seen if "no manifest entry" in s])
    ok = (m.policy.opt_level == res.config["opt_level"]
          and z3.prefetch == res.config["prefetch"] and explicit == ("O5", 0)
          and miss == ["O5", "O5", 1, 1] and warned == 2)
    if not ok:
        raise AssertionError(f"tune_card: resolved {m.policy.opt_level}/{z3.prefetch} "
                             f"for {res.config}, explicit {explicit}, miss {miss}, "
                             f"{warned} warnings")
    resolved = f"amp:{m.policy.opt_level},zero3_prefetch:{z3.prefetch}"
    mesh.destroy()
    del m, z3, params
    torch.cuda.empty_cache()
    line("tune_card", winner=json.dumps(res.config),
         ms_per_step=None if res.cost_s is None else 1e3 * res.cost_s,
         trials=res.trials, search_s=search_s, key=key.digest,
         chip=f"'{key.chip[0]}'", second_run="cache_hit,0_trials",
         resolved=resolved,
         explicit_wins=True, miss="O5,prefetch_1,warned_once_a_site", card=f"'{card}'")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from beforeholiday_tpu_torch import _build, amp, infer, optimizers
    from beforeholiday_tpu_torch.contrib import xentropy as xent
    from beforeholiday_tpu_torch.ops._autocast import cast_floats
    from beforeholiday_tpu_torch.ops import attention as attn
    from beforeholiday_tpu_torch.ops import multi_tensor as mt
    from beforeholiday_tpu_torch.ops import normalization as norm
    from beforeholiday_tpu_torch.ops import quantized as q8
    from beforeholiday_tpu_torch.ops import softmax as sm
    from beforeholiday_tpu_torch.examples.imagenet import main_amp
    from beforeholiday_tpu_torch.examples.serve import driver
    from beforeholiday_tpu_torch.models import resnet
    from beforeholiday_tpu_torch.ops.arena import make_spec, tree_flatten
    from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
    from beforeholiday_tpu_torch.testing import bert, gpt
    from beforeholiday_tpu_torch.transformer import context_parallel as cpar

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    line("device", name=f"'{name}'", count=count, smi=f"'{card}'",
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = _build.build()
    line("build", seconds=time.perf_counter() - t0, libraries=",".join(sorted(libs)))
    PHASE_SECONDS["build"] = time.perf_counter() - t0

    cfg = gpt.GPTConfig(**MODEL)
    params = gpt.init(cfg, gen(0), device="cuda")
    specs = o5_specs(params)
    n_bf16 = specs[torch.bfloat16].padded_total
    n_fp32 = specs[torch.float32].padded_total
    bcfg = bert.BertConfig(**BERT)
    bparams = bert.init(bcfg, gen(1), device="cuda")
    bert_spec = o5_specs(bparams)[torch.bfloat16]
    rcfg = resnet.resnet50()
    rweights = resnet.init(rcfg, gen(2), device="cuda")
    rspecs = o5_specs(rweights[0])
    o0_spec = make_spec(tree_flatten(rweights[0])[0])
    kernels_t0 = time.perf_counter()
    rows = {"layer_norm_fwd": k1_phase(norm), "flash_fwd": k2_phase(attn),
            "paged_decode": paged_phase(attn, infer.kvcache),
            "layer_norm_bwd": k3_phase(norm), "flash_bwd": k4_phase(attn),
            "unscale": k5_phase(mt, n_bf16, n_fp32, rspecs[torch.bfloat16].padded_total),
            "adam": k6_phase(mt, n_bf16, n_fp32),
            "l2norm": k9_phase(mt, bert_spec.padded_total),
            "lamb_stage1": k7_phase(mt, bert_spec.padded_total),
            "scaled_update": k8_phase(mt, make_spec, bert_spec),
            "sgd": k10_phase(mt, {
                "resnet_o5": (rspecs[torch.bfloat16], torch.bfloat16),
                "resnet_o5_fp32": (rspecs[torch.float32], torch.float32),
                "resnet_o0": (o0_spec, None)}),
            "softmax_fwd": k11_phase(sm), "softmax_bwd": k12_phase(sm),
            "dropout_mask": k13_phase(attn),
            "xent_fwd": k14_phase(xent), "xent_bwd": k15_phase(xent),
            "axpby": k16_phase(mt, rspecs), "adagrad": k17_phase(mt, o0_spec),
            "novograd": k18_phase(mt, make_spec, o0_spec)}
    # slice 16: K2's paged mode over bf16 and fp16 pools
    rows["paged_decode"].update(paged_16bit_phase(attn, infer.kvcache))
    torch.cuda.empty_cache()
    # slice 13: K2/K4 in fp16 (amp O1/O2), K10 on fp16 params (O3), and
    # the launch floor beside them
    fwd16, bwd16 = k2_k4_fp16_phase(attn)
    rows["flash_fwd"].update(fwd16)
    rows["flash_bwd"].update(bwd16)
    rows["sgd"].update(k10_half_phase(mt, o0_spec))
    launch_floor, launch_floor_cuda = launch_floor_phase()
    torch.cuda.empty_cache()
    # slice 14: the fp8 tier's parts at the flagship's block GEMM shapes
    o6_gemm_phase(q8)
    torch.cuda.empty_cache()
    xent_function_phase(xent)
    flash_dropout_laws_phase(attn)
    flash_dropout_rung_phase(attn)
    torch.cuda.empty_cache()
    PHASE_SECONDS["kernels"] = time.perf_counter() - kernels_t0

    with phase("engine"):
        engine_phase(infer, gpt, cast_floats, params, cfg, attn)
        torch.cuda.empty_cache()
    with phase("serving"):
        eng, serve_launches, fp32_streams = serving_phase(infer, params, cfg, norm,
                                                          attn, card)
        # the profile reads half the mix (A29's time budget)
        profile_phase(infer, eng, cfg, n_requests=N_REQUESTS // 2)
        del eng
        torch.cuda.empty_cache()
    with phase("decode_profile"):
        decode_profile_phase(infer, params, cfg)
        torch.cuda.empty_cache()
    # slice 14: the flagship engine on e4m3 pages
    with phase("serving_e4m3"):
        serve_e4m3_launches, e4m3_decode_launches = serving_e4m3_phase(
            infer, params, cfg, attn, norm, card)
        torch.cuda.empty_cache()
    # slice 16: bf16 and fp16 pages, the prefix cache, disaggregation and
    # the open-loop driver
    with phase("pages16"):
        pages16_parity_phase(infer, params, cfg, attn)
        serve_16bit_launches = serving_16bit_phases(infer, params, cfg, norm, attn,
                                                    card, fp32_streams)
    with phase("prefix_serving"):
        prefix_serving_phase(infer, driver, params, cfg)
    with phase("disagg_serving"):
        disagg_serving_phase(infer, params, cfg)
    with phase("serve_driver"), tempfile.TemporaryDirectory() as tmp:
        serve_driver_phase(infer, driver, params, cfg, tmp)
    torch.cuda.empty_cache()

    counters = launch_counters(norm, attn, mt, sm, xent)
    gpt_trainer = lambda **kw: make_gpt_trainer(amp, gpt, FusedAdam, params,
                                                cfg, **kw)
    batch = gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60),
                                device="cuda")
    # Adam's first step moves each weight by lr * g / (|g| + eps): the paths
    # can part by 2 lr where a gradient flips sign
    step_parity_phase("step_parity", gpt_trainer, batch, 2 * LR + 1e-6,
                      "2 lr: a gradient sign flip")
    skip_phase("skip_step", gpt_trainer, gpt.synthetic_batch(
        cfg, PARITY_BATCH, generator=gen(61), device="cuda"))
    m, _, step = gpt_trainer()
    batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70), device="cuda")
    launches = {"train": training_phase(
        "training", "train_profile", step, batch, counters,
        STEP_LAUNCHES["gpt"], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
        **lm_work(m, batch))}
    del m, step
    torch.cuda.empty_cache()

    # GPT with unfused attention: materialized scores, K11/K12
    ucfg = dataclasses.replace(cfg, use_flash_attention=False)
    unfused_trainer = lambda **kw: make_gpt_trainer(amp, gpt, FusedAdam, params,
                                                    ucfg, **kw)
    step_parity_phase("gpt_unfused_step_parity", unfused_trainer,
                      gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60),
                                          device="cuda"),
                      2 * LR + 1e-6, "2 lr: a gradient sign flip")
    bf16_params = cast_floats(params, torch.bfloat16)

    def gpt_forward(flash, b):
        c = dataclasses.replace(cfg, use_flash_attention=flash)
        logits = gpt.forward(bf16_params, b[0], c)
        return logits, gpt._cross_entropy(logits, b[1])

    unfused_vs_flash_phase("gpt_unfused_vs_flash", gpt_forward, batch)
    del bf16_params
    m, _, step = unfused_trainer()
    launches["gpt_unfused"] = training_phase(
        "gpt_unfused_training", "gpt_unfused_profile", step, batch, counters,
        STEP_LAUNCHES["gpt_unfused"], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
        attention="unfused", **lm_work(m, batch))
    del m, step, batch, params
    torch.cuda.empty_cache()
    mark("gpt_o5_and_unfused")

    bert_trainer = lambda **kw: make_bert_trainer(amp, bert, FusedLAMB, bparams,
                                                  bcfg, **kw)
    # LAMB's first step moves each weight by its tensor's trust ratio times
    # u = g / (|g| + eps) + decay * p, about lr per element (lr * ||p|| /
    # ||u||); a gradient sign flip parts the paths by twice that, and the
    # ratio itself varies a little with ||u||
    step_parity_phase("bert_step_parity", bert_trainer,
                      bert_batch(bert, bcfg, PARITY_BATCH, 62, BERT_PARITY_LENS),
                      3 * BERT_LR, "3 lr: a sign flip moves 2 lr times the trust ratio")
    skip_phase("bert_skip_step", bert_trainer,
               bert_batch(bert, bcfg, PARITY_BATCH, 63, BERT_PARITY_LENS))
    m, _, step = bert_trainer()
    batch = bert_batch(bert, bcfg, BERT_BATCH, 71)
    launches["bert"] = training_phase(
        "bert_training", "bert_profile", step, batch, counters,
        STEP_LAUNCHES["bert"], BERT_GROUPS, card, seq_len=bcfg.seq_len,
        **lm_work(m, batch))
    del m, step
    torch.cuda.empty_cache()

    # BERT with unfused attention: the key-padding mask built on the card
    # from the lengths, K11/K12
    ubcfg = dataclasses.replace(bcfg, use_flash_attention=False)
    unfused_bert = lambda **kw: make_bert_trainer(amp, bert, FusedLAMB, bparams,
                                                  ubcfg, **kw)
    step_parity_phase("bert_unfused_step_parity", unfused_bert,
                      bert_batch(bert, bcfg, PARITY_BATCH, 62, BERT_PARITY_LENS),
                      3 * BERT_LR, "3 lr: a sign flip moves 2 lr times the trust ratio")
    bf16_bparams = cast_floats(bparams, torch.bfloat16)

    def bert_forward(flash, b):
        c = dataclasses.replace(bcfg, use_flash_attention=flash)
        mlm, nsp = bert.forward(bf16_bparams, b[0], c, seq_lens=b[4])
        return mlm, bert.pretrain_loss(bf16_bparams, *b[:4], c, seq_lens=b[4])

    ragged = np.random.default_rng(64).integers(1, bcfg.seq_len + 1, 16)
    unfused_vs_flash_phase("bert_unfused_vs_flash", bert_forward,
                           bert_batch(bert, bcfg, 16, 64, ragged.tolist()))
    del bf16_bparams
    m, _, step = unfused_bert()
    launches["bert_unfused"] = training_phase(
        "bert_unfused_training", "bert_unfused_profile", step, batch, counters,
        STEP_LAUNCHES["bert_unfused"], BERT_GROUPS, card, seq_len=bcfg.seq_len,
        attention="unfused", **lm_work(m, batch))
    del m, step
    torch.cuda.empty_cache()
    mark("bert_and_unfused")

    # dropout 0.1/0.1 with a per-step key, flash and unfused: the parity
    # step at batch 2 (one key, so the kernels and the plain path draw the
    # same masks), the skip step, flash against unfused on one key, and the
    # timed run
    dcfg = dataclasses.replace(cfg, **DROPOUT)
    dbcfg = dataclasses.replace(bcfg, **DROPOUT)
    params = gpt.init(cfg, gen(0), device="cuda")
    gpt_batch = gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70),
                                    device="cuda")
    bert_train_batch = bert_batch(bert, bcfg, BERT_BATCH, 71)
    dropout_steps = (
        ("gpt_dropout", "gpt", dcfg, True), ("gpt_unfused_dropout", "gpt", dcfg, False),
        ("bert_dropout", "bert", dbcfg, True),
        ("bert_unfused_dropout", "bert", dbcfg, False))
    for label, model, mcfg, flash in dropout_steps:
        mcfg = dataclasses.replace(mcfg, use_flash_attention=flash)
        if model == "gpt":
            trainer = (lambda mcfg=mcfg, **kw: make_gpt_trainer(
                amp, gpt, FusedAdam, params, mcfg, **kw))
            parity = [gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(s_),
                                          device="cuda") for s_ in (60, 61)]
            tol, why = 2 * LR + 1e-6, "2 lr: a gradient sign flip"
            batch, groups = gpt_batch, TRAIN_GROUPS
        else:
            trainer = (lambda mcfg=mcfg, **kw: make_bert_trainer(
                amp, bert, FusedLAMB, bparams, mcfg, **kw))
            parity = [bert_batch(bert, bcfg, PARITY_BATCH, s_, BERT_PARITY_LENS)
                      for s_ in (62, 63)]
            tol, why = 3 * BERT_LR, "3 lr: a sign flip moves 2 lr times the trust ratio"
            batch, groups = bert_train_batch, BERT_GROUPS
        step_parity_phase(f"{label}_step_parity", trainer, parity[0], tol, why)
        skip_phase(f"{label}_skip_step", trainer, parity[1])
        if flash:
            dropout_flash_vs_unfused_phase(f"{model}_dropout_unfused_vs_flash",
                                           gpt, bert, params, bparams, mcfg, model,
                                           bcfg)
        m, _, step = trainer()
        launches[label] = training_phase(
            f"{label}_training", f"{label}_profile", step, batch, counters,
            STEP_LAUNCHES[label], groups, card, seq_len=mcfg.seq_len,
            attention="flash" if flash else "unfused",
            dropout=f"{mcfg.dropout_rate}/{mcfg.attention_dropout}",
            **lm_work(m, batch))
        del m, step
        torch.cuda.empty_cache()
    mark("dropout_steps")

    # the fused label-smoothing cross entropy as the loss of the flash GPT
    # and BERT steps, passed in as a user script passes its loss: the parity
    # step, the skip step, BERT-xent against the pretrain_loss step, and the
    # timed run with K14 and K15 counted
    gpt_xent = (lambda **kw: make_gpt_trainer(amp, gpt, FusedAdam, params, cfg,
                                              loss=gpt_xent_loss(xent), **kw))
    step_parity_phase("gpt_xent_step_parity", gpt_xent, xent_batch(
        gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60), device="cuda")),
        2 * LR + 1e-6, "2 lr: a gradient sign flip")
    skip_phase("gpt_xent_skip_step", gpt_xent, xent_batch(
        gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(61), device="cuda")))
    m, _, step = gpt_xent()
    batch = xent_batch(gpt_batch)
    launches["gpt_xent"] = training_phase(
        "gpt_xent_training", "gpt_xent_profile", step, batch, counters,
        STEP_LAUNCHES["gpt_xent"], TRAIN_GROUPS, card, seq_len=cfg.seq_len,
        loss_fn=f"'softmax_cross_entropy_loss smoothing {XENT_SMOOTHING} "
                f"padding_idx 0'", padded_targets=int((batch[1] == 0).sum()),
        **lm_work(m, batch))
    del m, step, batch
    torch.cuda.empty_cache()
    bert_xent = (lambda **kw: make_bert_trainer(
        amp, bert, FusedLAMB, bparams, bcfg,
        loss=bert_xent_loss(xent, bert.mask_token_id(bcfg)), **kw))
    lamb_tol, lamb_why = 3 * BERT_LR, "3 lr: a sign flip moves 2 lr times the trust ratio"
    parity = bert_batch(bert, bcfg, PARITY_BATCH, 62, BERT_PARITY_LENS)
    step_parity_phase("bert_xent_step_parity", bert_xent, parity, lamb_tol, lamb_why)
    # at smoothing 0 the objective is pretrain_loss's: both steps on the
    # kernels, the same forward, two losses (the gradients 1.7e-7 apart in
    # relative L2 on an H100 80GB HBM3 at 700 W; the masters still part by
    # 2 lr where a gradient near 0 flips sign)
    step_parity_phase("bert_xent_vs_pretrain_loss", bert_xent, parity, lamb_tol,
                      lamb_why, ref=bert_trainer, ref_name="pretrain_loss",
                      loss_tol=1e-5, grad_tol=1e-4)
    skip_phase("bert_xent_skip_step", bert_xent,
               bert_batch(bert, bcfg, PARITY_BATCH, 63, BERT_PARITY_LENS))
    m, _, step = bert_xent()
    launches["bert_xent"] = training_phase(
        "bert_xent_training", "bert_xent_profile", step, bert_train_batch,
        counters, STEP_LAUNCHES["bert_xent"], BERT_GROUPS, card,
        seq_len=bcfg.seq_len,
        loss_fn="'softmax_cross_entropy_loss smoothing 0.0 padding_idx [MASK]'",
        **lm_work(m, bert_train_batch))
    del m, step, params, gpt_batch, bert_train_batch, parity
    torch.cuda.empty_cache()
    mark("xent_steps")

    launches.update(gpt_amp_phases(amp, gpt, FusedAdam, cfg, counters, card))
    mark("gpt_amp")
    # slice 14: the flagship GPT at amp O6 (the fp8 tier)
    from beforeholiday_tpu_torch import guard as guard_mod
    launches["gpt_o6"] = gpt_o6_phases(amp, gpt, FusedAdam, guard_mod, q8, cfg,
                                       counters, card)
    launches["serving_e4m3"] = serve_e4m3_launches
    launches["serving_e4m3_decode"] = e4m3_decode_launches
    launches.update(serve_16bit_launches)
    mark("gpt_o6")

    resnet_step_parity_phase(main_amp, FusedSGD, tree_flatten, rcfg, rweights)
    resnet_skip_phase(main_amp, rcfg, rweights)
    flops_per_image = resnet_flops_per_image(resnet, rcfg, rweights)
    n_params = o0_spec.total
    # O0's convolutions run in fp32 here (cudnn.allow_tf32 is off above), so
    # its MFU is taken against the fp32 peak
    for key, label, level, peak in (
            ("resnet_o5", "resnet", "O5", PEAK_BF16),
            ("resnet_o0", "resnet_o0", "O0", PEAK_FLOPS[torch.float32])):
        tr = resnet_trainer(main_amp, rcfg, rweights, level, RESNET_BATCH)
        launches[key] = resnet_training_phase(
            f"{label}_training", f"{label}_profile", tr, trainer_step(tr),
            counters, STEP_LAUNCHES[key], flops_per_image, peak, n_params,
            card, opt_level=level)
        del tr
        torch.cuda.empty_cache()
    mark("resnet")

    # slice 13: ResNet-50 at amp O2 (the North star's recipe: fp16 arenas,
    # BN fp32, the dynamic scale), O1 and O4 (autocast over fp32 storage,
    # the list path) and O3 (fp16 storage without masters: K10 on fp16
    # params); then the DCGAN example at O2
    launches.update(resnet_amp_phases(main_amp, FusedSGD, tree_flatten, rcfg,
                                      rweights, counters, flops_per_image,
                                      n_params, card))
    from beforeholiday_tpu_torch.examples.dcgan import main_amp as dcgan
    dcgan_parity_phase(dcgan, amp)
    dcgan_phase(dcgan, counters, card)
    torch.cuda.empty_cache()
    mark("resnet_amp_and_dcgan")

    # slice 8: the O5 FusedSGD trainer accumulating two micro-batches (K16),
    # and the list path with FusedAdagrad (K17), FusedNovoGrad (K18),
    # FusedLARS and LARC(FusedSGD) (K10 after their per-tensor terms)
    paths = resnet_paths(optimizers)
    for label, (_, micro) in paths.items():
        def make(batch, impl=None, **kw):
            return resnet_path(paths, label, amp, main_amp, mt, rcfg, rweights,
                               batch, impl, **kw)

        resnet_path_parity_phase(label, make, micro, rcfg)
        resnet_path_skip_phase(label, make, micro, rcfg)
        tr, step = make(RESNET_BATCH)
        launches[label] = resnet_training_phase(
            f"{label}_training", f"{label}_profile", tr, step, counters,
            STEP_LAUNCHES[label], flops_per_image, PEAK_BF16, n_params, card,
            opt_level="O5", micro_batches=micro,
            optimizer=f"'{type(tr.amp_model.optimizer.inner).__name__}'")
        del tr, step
        torch.cuda.empty_cache()
    mark("resnet_paths")

    # slice 11: data parallel over torch.distributed (NCCL at world 1 on the
    # card; two gloo ranks on CUDA tensors for the two-rank check)
    import torch.distributed as dist
    from beforeholiday_tpu_torch import guard as guard_mod, parallel
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import bucketing
    from beforeholiday_tpu_torch.testing import faults

    with tempfile.TemporaryDirectory() as tmp:
        init_nccl(tmp)
        try:
            spread = ddp_world1_parity_phase(main_amp, bucketing, comms, rcfg,
                                             rweights)
            ddp_two_rank_card_phase(main_amp, rcfg, rweights, tmp, spread)
            ddp_guard_phase(main_amp, amp, guard_mod, faults, parallel, rcfg,
                            rweights)
            launches.update(ddp_training_phases(
                main_amp, amp, guard_mod, faults, parallel, comms, rcfg, rweights,
                counters, flops_per_image, n_params, card))
        finally:
            dist.destroy_process_group()
    # the same K10 launches as the one-device O5 row, counted on this path
    rows["sgd"]["ddp_resnet"] = rows["sgd"]["resnet_o5"]
    launches["serving"] = serve_launches
    mark("ddp")

    # slice 15: tensor + pipeline parallel (BASELINE config 5). The one-device
    # O5 steps the TP x PP steps are held against run first, while the GPT
    # is the dense one; then NCCL at world 1 for the layers and the O5 step
    # over TP x PP, and two gloo ranks on the one card for TP 2
    params = gpt.init(cfg, gen(0), device="cuda")
    tp_batches = [gpt.synthetic_batch(cfg, PARITY_BATCH, generator=gen(60),
                                      device="cuda"),
                  gpt.synthetic_batch(cfg, TRAIN_BATCH, generator=gen(70),
                                      device="cuda")]
    tp_refs = dense_reference_steps(amp, gpt, FusedAdam, params, cfg, tp_batches)
    # slice 17: the one-device dropout step the TP 2 dropout runs are held to
    tp_drop_ref = dense_reference_steps(amp, gpt, FusedAdam, params,
                                        dataclasses.replace(cfg, **DROPOUT),
                                        tp_batches[1:])[0]
    dense_layout = o5_layout(params)
    n_shard = o5_specs(gpt.shard_params(params, cfg, 0, 2))[torch.bfloat16].padded_total
    with tempfile.TemporaryDirectory() as tmp:
        init_nccl(tmp)
        try:
            tp_layers_world1_phase(norm, xent)
            launches.update(gpt_tp_pp_world1_phase(
                amp, gpt, FusedAdam, cfg, counters, card, params, tp_refs, tp_batches))
            mark("tp_pp")
            # slice 17 at world 1: a context group of one, the collective
            # matmul, BERT's TP forward
            cp_world1_phase(attn, cpar)
            collective_matmul_world1_phase()
            bert_tp_world1_phase(bert, bcfg)
            mark("transformer_world1")
            # slice 18: the 1F1B engine with its stage under remat "full"
            launches.update(remat_1f1b_world1_phase(
                amp, gpt, FusedAdam, cfg, counters, card, params, tp_batches[1]))
            mark("remat_1f1b")
        finally:
            dist.destroy_process_group()
        del params, tp_batches
        torch.cuda.empty_cache()
        launches.update(gpt_tp2_card_phase(gpt, cfg, dense_layout,
                                           {False: tp_refs[1], True: tp_drop_ref}, tmp))
    del tp_refs, tp_drop_ref
    for kname, r in tp_kernel_rows(norm, attn, mt, n_shard).items():
        rows[kname].update(r)
    mark("tp_pp")

    # slice 17: K2, K4 and K13 at a TP 2 rank's place, and ring attention
    # at long context, a context group emulated rank by rank on the card
    for rows_ in (rank_place_phase(attn), ring_phase(attn, cpar)):
        for kname, r in rows_.items():
            rows[kname].update(r)
    mark("transformer_slice17")

    # slice 18: the remat policies on the flagship GPT (and BERT under
    # save_boundaries) with the training monitor, memory and roofline
    # ledgers on the step; the ImageNet trainer's profile and flight dump
    with phase("remat_monitor"):
        launches["bert_remat_save_boundaries"] = remat_monitor_phase(
            amp, gpt, bert, FusedAdam, FusedLAMB, cfg, bcfg, counters, card)
    with phase("imagenet_monitor"), tempfile.TemporaryDirectory() as tmp:
        imagenet_monitor_phase(main_amp, tmp)
        torch.cuda.empty_cache()

    # slice 20: ZeRO-2 and ZeRO-3 at world 1 over NCCL (parity, skips, the
    # timed runs), then two gloo ranks on the one card; K6, K7 and K8 at
    # the world-2 shards
    from beforeholiday_tpu_torch.optimizers.distributed_fused import _packed_layout

    params = gpt.init(cfg, gen(0), device="cuda")
    with phase("zero_world1"), tempfile.TemporaryDirectory() as tmp:
        init_nccl(tmp)
        try:
            one_rank = zero_world1_parity(amp, gpt, bert, comms, bucketing, params,
                                          bparams, cfg, bcfg)
            launches.update(zero_training_phases(amp, gpt, bert, comms, params,
                                                 bparams, cfg, bcfg, counters, card))
        finally:
            dist.destroy_process_group()
    zero_specs = [_packed_layout(o5_layout(p_)).spec for p_ in (params, bparams)]
    del params
    torch.cuda.empty_cache()
    with phase("zero_two_rank_card"), tempfile.TemporaryDirectory() as tmp:
        zero_launches = zero_two_rank_card_phase(one_rank, tmp)
    with phase("zero_kernel_rows"):
        k6 = {"adam": sum(v.get("adam", 0) for v in zero_launches.values())}
        for kname, r in zero_kernel_rows(mt, *zero_specs, k6).items():
            rows[kname].update(r)
        torch.cuda.empty_cache()

    # slice 21: the two-level engines at world 1 on a 1 x 1 carve over NCCL
    # and as four gloo ranks on the card (a 2 x 2 carve); the optimizer in
    # the backward on the flagship GPT and ResNet-50 (K6's and K10's views
    # mode), and those modes' kernel rows
    params = gpt.init(cfg, gen(0), device="cuda")
    gpt_pieces = bucket_pieces(o5_layout(params), torch.bfloat16)
    resnet_pieces = bucket_pieces(o5_layout(rweights[0]), torch.bfloat16)
    with phase("multislice_world1"), tempfile.TemporaryDirectory() as tmp:
        init_nccl(tmp)
        try:
            launches.update(multislice_world1_phase(amp, gpt, FusedAdam, comms, params,
                                                    cfg, counters, card))
        finally:
            dist.destroy_process_group()
    with phase("step_in_backward"), tempfile.TemporaryDirectory() as tmp:
        init_nccl(tmp)
        try:
            launches.update(step_in_backward_phases(
                amp, gpt, main_amp, FusedAdam, params, cfg, rcfg, rweights, counters,
                flops_per_image, n_params, card))
        finally:
            dist.destroy_process_group()
    del params
    torch.cuda.empty_cache()
    with phase("multislice_card"), tempfile.TemporaryDirectory() as tmp:
        multislice_card_phase(one_rank, tmp)
    del one_rank
    with phase("views_kernel_rows"):
        rows.update(views_kernel_rows(mt, gpt_pieces, resnet_pieces, launches))
        torch.cuda.empty_cache()

    # slice 22: Mixture-of-Experts. moe_layer against dense_oracle at the
    # flagship's width; the MoE GPT's O5 step on the kernels against the
    # plain path (2 layers) and its timed, profiled run (8 layers, batch 16);
    # the moe_gpt example as four gloo ranks on the card
    from beforeholiday_tpu_torch import monitor, moe
    with phase("moe_layer_card"):
        moe_layer_card_phase(moe)
        torch.cuda.empty_cache()
    with phase("moe_gpt_step_parity"):
        moe_gpt_step_parity_phase(amp, gpt, FusedAdam)
    with phase("moe_gpt_training"):
        launches["moe_gpt"] = moe_gpt_training_phase(amp, gpt, FusedAdam, monitor, cfg,
                                                     counters, card)
    with phase("moe_ep_card"), tempfile.TemporaryDirectory() as tmp:
        moe_ep_card_phase(tmp)

    # slice 23: elastic training and the autotuner on the flagship's ZeRO-3
    # step. NCCL at world 1 for the async checkpoints and the tuner; the
    # SIGKILL drill in spawned children; two gloo ranks for the resizes. The
    # generations live in temporary directories the phases delete
    from beforeholiday_tpu_torch import elastic as etr, tune
    with tempfile.TemporaryDirectory() as tmp:
        init_nccl(tmp)
        try:
            with phase("elastic_ckpt_card"):
                reference = elastic_ckpt_card_phase(etr, amp, gpt, q8, guard_mod, cfg,
                                                    counters, card, tmp)
            with phase("tune_card"):
                tune_card_phase(amp, gpt, q8, guard_mod, tune, monitor, cfg, card, tmp)
        finally:
            dist.destroy_process_group()
    with phase("elastic_kill_card"), tempfile.TemporaryDirectory() as tmp:
        elastic_kill_card_phase(etr, faults, reference, card, tmp)
    with phase("elastic_resize_card"), tempfile.TemporaryDirectory() as tmp:
        elastic_resize_card_phase(card, tmp)

    kernels = []
    for kname, route, source, replaces in KERNEL_ROWS:
        for shape, (tag, f) in rows[kname].items():
            # launches: the run of the path that gives the kernel this shape
            # (the serving run, or the GPT, BERT or ResNet training run, with
            # flash or unfused attention), the run a row names, or the count
            # a row carries
            path = f.get("path", shape if shape in launches else "serving")
            kernels.append(dict(
                name=f"{kname}[{shape}: {tag}]", route=route, source=source,
                replaces=replaces,
                launches=f["launches"] if "launches" in f else launches[path][kname],
                max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
                bound_ms=f["bound_ms"], bound_by=f["bound_by"],
                library_ms=f["library_ms"]))
    line("total", seconds=time.perf_counter() - t_start)
    print("phase_seconds: " + json.dumps(PHASE_SECONDS), flush=True)
    print(json.dumps({"kernels": kernels, "launch_floor_ms": launch_floor,
                      "launch_floor_cuda_ms": launch_floor_cuda}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
