#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``beforeholiday_tpu_torch``) on one
NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA source compiled by nvcc (in parallel) plus the Triton
   compile of K1, from the sources in the checkout;
3. K1 (LayerNorm forward, Triton) against its plain version at the engine's
   and the training step's shapes, timed beside its bound and
   ``F.layer_norm``;
4. K2 (flash-attention forward, CUDA C++) against its plain version at the
   prefill, decode, GPT and BERT training shapes, timed beside its bound and
   ``F.scaled_dot_product_attention``;
5. K3-K12 (LayerNorm backward, unscale, fused Adam, global sum of squares,
   LAMB stage 1, the trust-ratio update, fused SGD and the scaled masked
   softmax forward and backward, Triton; flash attention backward, CUDA
   C++) against their plain versions at the training shapes and at awkward
   ones (for K11/K12: sk not a power of two, sq not a multiple of 128, sk =
   16384, fp32 and fp16, fully masked rows), each timed beside its bound
   and a library call: the same function where one PyTorch call computes
   it, else the same traffic;
6. engine parity: the full-width bf16 GPT engine on the kernels against the
   same engine on the plain path, and paged decode against the contiguous
   forward;
7. serving: seeded requests through ``ContinuousBatcher.run()``, with bucket
   padding and preemption, the kernels' launch counts reset just before and
   read just after; then the same mix again under ``torch.profiler`` for the
   device time by layer and the device's idle share;
8. GPT step parity: one full-width amp O5 arena-native FusedAdam step at
   batch 2 on the kernels against the same step on the plain path;
9. GPT skip step: an overflowing step leaves the state bitwise unchanged and
   halves the dynamic loss scale;
10. GPT training: the flagship (``bench.py`` ``make_gpt_rung``) at batch 16
    on one fixed batch, 2 warm-up and 10 timed steps with the launch counts
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
13. ResNet-50 (``bench.py`` ``make_resnet_rung``, the ``examples/imagenet``
    trainer with FusedSGD): one full-width O5 step at batch 2 on K5/K10
    against the plain path, an inf-weighted step that must change nothing,
    and the O5 and O0 trainers at batch 128 on one fixed batch (10 timed
    steps with the launch counts held, then 3 profiled ones), MFU from the
    convolutions' and ``fc``'s shapes;
14. the ``kernels`` JSON line, the card line, and the final ``ok`` line.

``F.layer_norm``, ``F.scaled_dot_product_attention``, their backwards,
``torch._amp_foreach_non_finite_check_and_unscale_``,
``torch._fused_adamw_``, ``torch.linalg.vector_norm``,
``torch._fused_sgd_``, ``torch.softmax`` and
``torch._softmax_backward_data`` are timed here only, as yardsticks
(``library_ms``); the port never calls them. No single PyTorch call
computes LAMB, so K7 and K8 have none; the library softmax applies no scale
and no mask, so K11's and K12's measure the same traffic, not the same
function.
"""

import dataclasses
import json
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s for bf16 tensor cores and fp32 outside them
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 2, 10, 3
# BERT-Large + FusedLAMB (bench.py make_bert_rung, bert_large_8layer_b128:
# bert_large(seq_len=128, n_layers=8, dtype=bf16), FusedLAMB(lr=1e-3,
# weight_decay=0.01), batch 128, no dropout)
BERT = dict(vocab_size=30522, seq_len=128, d_model=1024, n_heads=16,
            n_layers=8, dtype=torch.bfloat16)
BERT_BATCH = 128
BERT_LR = 1e-3
BERT_PARITY_LENS = (128, 77)
# kernel launches per training step, by wrapper. GPT: 2 LayerNorms per layer
# plus the final one, one attention per layer, one unscale and one Adam pass
# per arena (bf16 and fp32). BERT: the embedding LayerNorm, 2 per layer and
# the MLM head's, one attention per layer, and per arena one unscale, one
# K9 call (the global grad norm), one K7 and one K8 pass; a K9 call is two
# launches of its Triton kernels (partials, then the fixed-order sum) and
# counts once, as K3's two do
# ResNet-50 (bench.py make_resnet_rung): one unscale and one SGD pass per
# arena at O5 (bf16 convs and fc, fp32 BN); at O0 one fp32 bucket, so one
# of each on the list path. Unfused attention: one softmax forward and one
# backward per layer in place of the flash pair
_NO_LAUNCH = {"layer_norm_fwd": 0, "layer_norm_bwd": 0, "flash_fwd": 0,
              "flash_bwd": 0, "unscale": 0, "adam": 0, "l2norm": 0,
              "lamb_stage1": 0, "scaled_update": 0, "sgd": 0,
              "softmax_fwd": 0, "softmax_bwd": 0}
_GPT_STEP = {"layer_norm_fwd": 17, "layer_norm_bwd": 17, "unscale": 2,
             "adam": 2}
_BERT_STEP = {"layer_norm_fwd": 18, "layer_norm_bwd": 18, "unscale": 2,
              "l2norm": 2, "lamb_stage1": 2, "scaled_update": 2}
_FLASH = {"flash_fwd": 8, "flash_bwd": 8}
_UNFUSED = {"softmax_fwd": 8, "softmax_bwd": 8}
STEP_LAUNCHES = {
    "gpt": {**_NO_LAUNCH, **_GPT_STEP, **_FLASH},
    "bert": {**_NO_LAUNCH, **_BERT_STEP, **_FLASH},
    "gpt_unfused": {**_NO_LAUNCH, **_GPT_STEP, **_UNFUSED},
    "bert_unfused": {**_NO_LAUNCH, **_BERT_STEP, **_UNFUSED},
    "resnet_o5": {**_NO_LAUNCH, "unscale": 2, "sgd": 2},
    "resnet_o0": {**_NO_LAUNCH, "unscale": 1, "sgd": 1},
}
PEAK_BF16 = 989e12
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


def line(phase, **fields):
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def time_ms(fn, iters=20):
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


def bound_ms(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, ref, tol):
    torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"{name}: {m}")
    return max_err(got, ref)


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
    """Check K1 everywhere, time it at the engine's two shapes."""
    g = gen(1)
    checks = [  # rows, hidden, in dtype, rms, out dtype
        (16384, 1024, torch.bfloat16, False, torch.bfloat16),
        (8192, 1024, torch.bfloat16, False, torch.bfloat16),
        (32, 1024, torch.bfloat16, False, torch.bfloat16),
        (8192, 1024, torch.float32, False, torch.float32),
        (8192, 1024, torch.float32, True, torch.float32),
        (77, 1000, torch.float32, False, torch.float32),
        (64, 1000, torch.bfloat16, True, torch.float32),
    ]
    rows_out = {}
    for rows, hidden, dt, rms, out_dt in checks:
        x = (torch.randn(rows, hidden, generator=g, device="cuda") * 2 + .5).to(dt)
        # the training step's LayerNorms keep fp32 gamma/beta (amp O5)
        pdt = torch.float32 if rows == 16384 else dt
        w = (1 + .1 * torch.randn(hidden, generator=g, device="cuda")).to(pdt)
        b = None if rms else (.1 * torch.randn(hidden, generator=g, device="cuda")).to(pdt)
        args = (x, w, b, 1e-5, rms, out_dt)
        got = norm.ln_fwd_kernel(*args)
        ref = norm.ln_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = f"{rows}x{hidden} {str(dt)[6:]}{' rms' if rms else ''}->{str(out_dt)[6:]}"
        err = check_close(f"K1 {tag}", got, ref,
                          BF16_TOL if out_dt == torch.bfloat16 else FP32_TOL)
        fields = dict(max_abs_err=err)
        if dt == torch.bfloat16 and hidden == 1024 and not rms:
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


def k2_flops_bytes(q, k, lens, causal):
    BH, Sq, D = q.shape
    lens = lens.clamp(0, k.shape[1]).long().cpu()
    if causal:
        rows = torch.arange(Sq)
        pairs = int(torch.minimum(lens[:, None], rows[None, :] + 1).sum())
    else:
        pairs = int(lens.sum()) * Sq
    es = q.element_size()
    nbytes = (2 * q.numel() * es + BH * Sq * 4 + BH * 4
              + 2 * int(lens.sum()) * D * es)
    return 4 * pairs * D, nbytes


def k2_phase(attn):
    checks = [  # BH, Sq, Sk, D, causal, dtype
        (256, 1024, 1024, 64, True, torch.bfloat16),
        (128, 1024, 1024, 64, True, torch.bfloat16),
        (512, 1, 1024, 64, False, torch.bfloat16),
        (2048, 128, 128, 64, False, torch.bfloat16),  # BERT, ragged lens
        (128, 1024, 1024, 64, True, torch.float32),
        (512, 1, 1024, 64, False, torch.float32),
        (8, 70, 70, 48, True, torch.float32),
        (8, 33, 200, 128, False, torch.float32),
        (8, 70, 70, 48, True, torch.bfloat16),
        (8, 5, 5, 80, True, torch.bfloat16),
    ]
    rng = np.random.default_rng(2)
    rows_out = {}
    for i, (BH, Sq, Sk, D, causal, dt) in enumerate(checks):
        g = gen(10 + i)
        q, k, v = (torch.randn(BH, s, D, generator=g, device="cuda").to(dt)
                   for s in (Sq, Sk, Sk))
        lens_np = rng.integers(0, Sk + 1, BH)
        lens_np[:2] = (0, Sk)  # a fully masked row and a full one
        if BH == 256:
            lens_np[:] = Sk  # training: every sequence full
        lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
        args = (q, k, v, lens, causal, D ** -0.5)
        o, lse = attn.flash_fwd_kernel(*args)
        ro, rlse = attn.flash_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = f"BH{BH} Sq{Sq} Sk{Sk} D{D}{' causal' if causal else ''} {str(dt)[6:]}"
        if BH != 256 and not (torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)):
            raise AssertionError(f"K2 {tag}: a lens-0 row is not exactly 0")
        err = check_close(f"K2 {tag}", o, ro,
                          BF16_TOL if dt == torch.bfloat16 else FP32_TOL)
        check_close(f"K2 lse {tag}", lse, rlse, dict(rtol=1e-5, atol=1e-4))
        fields = dict(max_abs_err=err)
        if dt == torch.bfloat16 and BH >= 128:
            flops, nbytes = k2_flops_bytes(q, k, lens, causal)
            bms, by = bound_ms(nbytes, flops, dt)
            kj = torch.arange(Sk, device="cuda")
            keep = kj[None, None, :] < lens[:, None, None]
            if causal:
                keep = keep & (kj[None, :] <= torch.arange(Sq, device="cuda")[:, None])
            fields.update(
                ms=time_ms(lambda: attn.flash_fwd_kernel(*args)),
                plain_ms=time_ms(lambda: attn.flash_fwd_torch(*args), iters=5),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep, scale=D ** -0.5)),
                bound_ms=bms, bound_by=by)
            rows_out[{256: "train", 2048: "bert"}.get(
                BH, "prefill" if causal else "decode")] = (tag, fields)
        line("K2", shape=tag, **fields)
    return rows_out


# ---------------------------------------------------------------- K3-K6


def grad_ms(fn, inputs, grad_out):
    """Device time of the backward alone: ``fn`` runs once, then its graph
    is replayed for the gradients of ``inputs``."""
    out = fn()
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad_out,
                                               retain_graph=True))


def k3_phase(norm):
    """LayerNorm backward: the training shape (O5 mix) and awkward ones."""
    g = gen(21)
    checks = [  # rows, hidden, x/dy dtype, w dtype, rms, bias
        (16384, 1024, torch.bfloat16, torch.float32, False, True),
        (16384, 1024, torch.float32, torch.float32, False, True),
        (77, 1000, torch.float32, torch.float32, False, True),
        (77, 1000, torch.float32, torch.float32, True, False),
        (64, 1000, torch.bfloat16, torch.float32, True, False),
        (5, 48, torch.bfloat16, torch.bfloat16, False, True),
    ]
    rows_out = {}
    for rows, hidden, dt, wdt, rms, bias in checks:
        x = (torch.randn(rows, hidden, generator=g, device="cuda") * 2 + .5).to(dt)
        dy = torch.randn(rows, hidden, generator=g, device="cuda").to(dt)
        w = (1 + .1 * torch.randn(hidden, generator=g, device="cuda")).to(wdt)
        args = (x, w, dy, 1e-5, rms)
        dx, dw, db = norm.ln_bwd_kernel(*args, bias)
        rdx, rdw, rdb = norm.ln_bwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"{rows}x{hidden} {str(dt)[6:]}/w {str(wdt)[6:]}"
               f"{' rms' if rms else ''}{'' if bias else ' no-bias'}")
        err = check_close(f"K3 dx {tag}", dx, rdx,
                          BF16_TOL if dt == torch.bfloat16 else FP32_TOL)
        # dgamma/dbeta: fp32 sums over every row in another order
        err_w = check_close(f"K3 dw {tag}", dw.float(), rdw,
                            dict(rtol=1e-4, atol=1e-3 if wdt == torch.float32 else 0.05))
        if bias:
            check_close(f"K3 db {tag}", db.float(), rdb,
                        dict(rtol=1e-4, atol=1e-3 if wdt == torch.float32 else 0.05))
        fields = dict(max_abs_err=err, dw_max_abs_err=err_w)
        if rows == 16384 and dt == torch.bfloat16:
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
    checks = [  # BH, Sq, Sk, D, causal, dtype, dlse
        (256, 1024, 1024, 64, True, torch.bfloat16, False),
        (2048, 128, 128, 64, False, torch.bfloat16, False),  # BERT, ragged
        (8, 70, 70, 48, True, torch.bfloat16, True),
        (8, 100, 100, 80, True, torch.bfloat16, False),
        (8, 64, 200, 128, False, torch.bfloat16, True),
        (16, 256, 256, 64, True, torch.float32, False),
        (8, 70, 70, 48, True, torch.float32, True),
        (8, 100, 100, 80, False, torch.float32, True),
        (8, 33, 70, 128, False, torch.float32, False),
    ]
    rng = np.random.default_rng(22)
    rows_out = {}
    for i, (BH, Sq, Sk, D, causal, dt, with_dlse) in enumerate(checks):
        g = gen(30 + i)
        q, k, v = (torch.randn(BH, s, D, generator=g, device="cuda").to(dt)
                   for s in (Sq, Sk, Sk))
        lens_np = (np.full(BH, Sk) if BH == 256 else rng.integers(0, Sk + 1, BH))
        if BH != 256:
            lens_np[:2] = (0, Sk)  # a fully masked row and a full one
        lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
        scale = D ** -0.5
        o, lse = attn.flash_fwd_torch(q, k, v, lens, causal, scale)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dt)
        dlse = (torch.randn(lse.shape, generator=g, device="cuda")
                if with_dlse else None)
        args = (q, k, v, o, do, lse, dlse, lens, causal, scale)
        got = attn.flash_bwd_kernel(*args)
        ref = attn.flash_bwd_torch(*args)
        torch.cuda.synchronize()
        tag = (f"BH{BH} Sq{Sq} Sk{Sk} D{D}{' causal' if causal else ''} "
               f"{str(dt)[6:]}{' dlse' if with_dlse else ''}")
        if BH != 256 and not all(torch.all(t[0] == 0) for t in got):
            raise AssertionError(f"K4 {tag}: a lens-0 row is not exactly 0")
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K4 {name} {tag}: non-finite")
            # bf16: the tensor-core kernel rounds p and ds to bf16 for its
            # products (as the TPU kernel does), the plain version keeps fp32
            tol = (dict(rtol=2e-2, atol=2e-2 * float(b.float().abs().max()))
                   if dt == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4))
            errs.append(check_close(f"K4 {name} {tag}", a, b, tol))
        fields = dict(max_abs_err=max(errs))
        if BH in (256, 2048):
            flops, nbytes = k4_flops_bytes(q, k, lens, causal)
            bms, by = bound_ms(nbytes, flops, dt)
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
                        ql, kl, vl, attn_mask=keep, is_causal=causal),
                    (ql, kl, vl), do.reshape(B, H, Sq, D)),
                bound_ms=bms, bound_by=by)
            rows_out["train" if BH == 256 else "bert"] = (tag, fields)
        line("K4", shape=tag, **fields)
    return rows_out


def o5_specs(params):
    """The ``ArenaSpec`` of each arena of ``params`` under amp O5, by dtype."""
    from beforeholiday_tpu_torch.amp.frontend import _cast_params, opt_levels
    from beforeholiday_tpu_torch.ops.arena import PackedParams

    layout = PackedParams.pack(_cast_params(params, opt_levels["O5"], None)).layout
    return dict(zip(layout.dtypes, layout.specs))


def k5_phase(mt, n_bf16, n_fp32):
    """Unscale with the non-finite flag: the flagship's two gradient arenas,
    inf and NaN placed in them, and an output that overflows."""
    g = gen(40)
    rows_out = {}
    checks = [  # n, dtype, poison
        (n_bf16, torch.bfloat16, None),
        (n_fp32, torch.float32, None),
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
        if n == n_bf16 and poison is None:
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
            rows_out["train"] = (tag, fields)
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


# ---------------------------------------------------------------- engine


def engine_phase(infer, gpt, cast_floats, params, cfg):
    """The full-width bf16 engine on K1/K2 against its plain path, and paged
    decode against the contiguous forward."""
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
        logits = {i: torch.from_numpy(e.decode_logits(feed, lens, tables))
                  for i, e in engines.items()}
        got, ref = logits["kernel"], logits["torch"]
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
         prompts=len(prompts))


# --------------------------------------------------------------- serving


def serving_requests(infer, cfg):
    """The seeded request mix: prompts of 64-768 tokens, 32-128 new ones."""
    rng = np.random.default_rng(4)
    lens = zip(rng.integers(64, 769, N_REQUESTS), rng.integers(32, 129, N_REQUESTS))
    return [infer.Request(rid=i,
                          prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                          max_new_tokens=int(m))
            for i, (n, m) in enumerate(lens)]


def serving_phase(infer, params, cfg, norm, attn, card):
    ecfg = infer.EngineConfig(**{**ENGINE, "num_pages": SERVE_PAGES})
    eng = infer.InferenceEngine(params, cfg, ecfg)
    reqs = serving_requests(infer, cfg)
    bat = infer.ContinuousBatcher(eng)
    for r in reqs:
        bat.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norm.ln_fwd_kernel.launches = 0
    attn.flash_fwd_kernel.launches = 0
    t0 = time.perf_counter()
    fin = bat.run(max_steps=10000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"layer_norm_fwd": norm.ln_fwd_kernel.launches,
                "flash_fwd": attn.flash_fwd_kernel.launches}
    calls = eng.call_counts
    steps = calls["prefill"] + calls["decode"]
    expect = {"layer_norm_fwd": (2 * cfg.n_layers + 1) * steps,
              "flash_fwd": cfg.n_layers * steps}
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
        if n <= 0 or n != expect[name]:
            raise AssertionError(f"{name}: {n} launches, engine calls imply "
                                 f"{expect[name]}")
    tokens = sum(len(r.out) for r in fin)
    line("serving", requests=len(fin), generated_tokens=tokens,
         prompt_tokens=sum(len(r.prompt) for r in reqs),
         prefill_calls=calls["prefill"], decode_calls=calls["decode"],
         preemptions=preempt, tokens_per_s=tokens / wall, wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         signatures=eng.compiled_signatures, card=f"'{card}'")
    return eng, launches


# kernel-name fragments -> the layer of the serving path they belong to
KERNEL_GROUPS = (("K1 layer_norm_fwd", ("_ln_fwd",)),
                 ("K2 flash_fwd", ("flash_fwd_",)),
                 ("gemm", ("gemm", "sm90_", "cutlass", "xmma", "cublas", "nvjet")),
                 ("gather/scatter", ("index", "gather", "scatter")))


def profile_phase(infer, eng, cfg):
    """The same request mix again under torch.profiler: device time by layer
    and the device's idle share over the run (the timed run above is not
    profiled, so its wall time carries no profiler cost)."""
    bat = infer.ContinuousBatcher(eng)
    for r in serving_requests(infer, cfg):
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
        line("profile", device_time="not measured (no CUDA events in the trace)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print("profile: " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "by_layer_ms": groups,
        "top_kernels_ms": {k[:90]: v for k, v in top}}), flush=True)


# -------------------------------------------------------------- training


def make_gpt_trainer(amp, gpt, fused_adam, params, cfg, impl=None,
                     loss_scale=None, loss_weight=None):
    """The flagship step as ``bench.py`` ``make_gpt_rung`` builds it: amp O5,
    arena-native PackedParams, FusedAdam(lr=1e-4). ``impl="torch"`` puts
    every op on its plain version; ``loss_weight`` multiplies the loss."""
    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl)
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params,
                       fused_adam(lr=LR, impl=impl), "O5", arena_native=True,
                       loss_scale=loss_scale)

    def loss_fn(p, tok, tgt):
        loss = gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply)
        return loss if loss_weight is None else loss * loss_weight

    return m, *scaled_step(amp, m, loss_fn, impl)


def make_bert_trainer(amp, bert, fused_lamb, params, cfg, impl=None,
                      loss_scale=None, loss_weight=None):
    """The BERT step as ``bench.py`` ``make_bert_rung`` builds it: amp O5,
    arena-native PackedParams, FusedLAMB(lr=1e-3, weight_decay=0.01), the
    MLM + NSP pretraining loss; here under the amp loss scaler (K5)."""
    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl)
    m = amp.initialize(lambda p, t: bert.forward(p, t, cfg), params,
                       fused_lamb(lr=BERT_LR, weight_decay=0.01, impl=impl),
                       "O5", arena_native=True, loss_scale=loss_scale)

    def loss_fn(p, tok, tgt, mask, nsp, lens):
        loss = bert.pretrain_loss(p.unpack(), tok, tgt, mask, nsp, cfg,
                                  seq_lens=lens)
        return loss if loss_weight is None else loss * loss_weight

    return m, *scaled_step(amp, m, loss_fn, impl)


def scaled_step(amp, m, loss_fn, impl):
    """``(state, step)``: ``step(*batch)`` runs one scaled forward and
    backward and one optimizer step, in place on ``m.params`` and ``state``."""
    svag = amp.scaled_value_and_grad(loss_fn, m.scaler, impl=impl)
    state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init()}

    def step(*batch):
        loss, g, fi, state["scaler"] = svag(m.params, state["scaler"], *batch)
        m.params, state["opt"] = m.optimizer.step(m.params, g, state["opt"],
                                                  found_inf=fi)
        return loss, g, fi

    return state, step


def snapshot(m, state):
    """Copies of everything a step may change."""
    inner = state["opt"]["inner"]
    return ([a.clone() for a in m.params.arenas],
            [a.clone() for a in state["opt"]["master"]],
            [{k: v.clone() for k, v in b.items()} for b in inner])


def step_parity_phase(label, trainer, batch, master_tol, why):
    """One full-width step at batch 2 on the kernels and on the plain path
    from the same weights and batch. ``master_tol`` bounds how far the two
    paths' masters may part (``why`` says why)."""
    res = {}
    for impl in (None, "torch"):
        m, state, step = trainer(impl=impl)
        loss, g, fi = step(*batch)
        torch.cuda.synchronize()
        if bool(fi):
            raise AssertionError(f"{label} ({impl}): found_inf set")
        model, masters, _ = snapshot(m, state)
        for arena, master in zip(model, masters):
            if not torch.equal(arena, master.to(arena.dtype)):
                raise AssertionError(
                    f"{label} ({impl}): model arena != masters.to(dtype)")
        res[impl] = (loss.item(), [a.clone() for a in g.arenas], masters)
        del m, state, step, g
        torch.cuda.empty_cache()
    (lk, gk, mk), (lp, gp, mp) = res[None], res["torch"]
    loss_err = abs(lk - lp) / abs(lp)
    if not (np.isfinite(lk) and loss_err < 5e-3):
        raise AssertionError(f"{label}: loss {lk} vs plain {lp}")
    grad_rel = [float((a - b).norm() / b.norm()) for a, b in zip(gk, gp)]
    if max(grad_rel) > 0.05:
        raise AssertionError(f"{label}: grad arenas differ, rel L2 {grad_rel}")
    master_err = max(max_err(a, b) for a, b in zip(mk, mp))
    if master_err > master_tol:
        raise AssertionError(f"{label}: masters differ by {master_err} "
                             f"> {master_tol} ({why})")
    flips = sum(int(((a - b).abs() > master_tol / 2).sum()) for a, b in zip(mk, mp))
    line(label, batch=PARITY_BATCH, loss=lk, plain_loss=lp,
         loss_rel_err=loss_err, grad_rel_l2=max(grad_rel),
         grad_max_abs_err=max(max_err(a, b) for a, b in zip(gk, gp)),
         master_max_abs_err=master_err, master_tol=master_tol,
         master_sign_flips=flips, model_arena_is_master_cast="bitwise")


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
    same = (all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
            and all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
            and all(torch.equal(a[k], b[k]) for a, b in zip(before[2], after[2])
                    for k in a))
    if not same:
        raise AssertionError(f"{label}: the state changed")
    scale1 = state["scaler"]["scale"].item()
    if scale1 != scale0 / 2:
        raise AssertionError(f"{label}: scale {scale0} -> {scale1}")
    line(label, found_inf=True, state="bitwise unchanged",
         scale_before=scale0, scale_after=scale1,
         step_count=int(after[2][0]["step"]))
    del m, state, step
    torch.cuda.empty_cache()


def launch_counters(norm, attn, mt, sm):
    return {"layer_norm_fwd": norm.ln_fwd_kernel,
            "layer_norm_bwd": norm.ln_bwd_kernel,
            "flash_fwd": attn.flash_fwd_kernel,
            "flash_bwd": attn.flash_bwd_kernel,
            "unscale": mt.scale_kernel, "adam": mt.adam_kernel,
            "l2norm": mt.l2norm_sq_kernel, "lamb_stage1": mt.lamb_stage1_kernel,
            "scaled_update": mt.scaled_update_kernel, "sgd": mt.sgd_kernel,
            "softmax_fwd": sm.softmax_fwd_kernel,
            "softmax_bwd": sm.softmax_bwd_kernel}


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


def training_phase(label, profile_label, step, batch, counters, expect,
                   groups, card, *, unit, units, flops, peak, **fields):
    """2 warm-up and TIMED_STEPS timed steps on one fixed batch, the launch
    counts reset just before the timed steps and read just after, under
    ``set_sync_debug_mode("warn")``; then PROFILE_STEPS steps under
    torch.profiler. ``units`` (tokens or images) and ``flops`` are one
    step's work, ``peak`` the FLOP/s the MFU is taken against; ``fields``
    are printed as they are. Returns the timed steps' launch counts."""
    for _ in range(WARMUP_STEPS):
        step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    events, losses, flags, syncs, port_syncs = [], [], [], {}, []

    def record_sync(message, category, filename, lineno, file=None, line=None):
        # where the sync came from: the warning's site, and the innermost
        # frame of this repository that led to it
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
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record_sync
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss, _, fi = step(*batch)
            b.record()
            events.append((a, b))
            losses.append(loss)
            flags.append(fi)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, per_step in expect.items():
        if launches[k] != per_step * TIMED_STEPS:
            raise AssertionError(f"{label} {k}: {launches[k]} launches in "
                                 f"{TIMED_STEPS} steps, the model implies "
                                 f"{per_step} per step")
    if port_syncs:
        raise AssertionError(f"{label}: the port's code synchronized the host: "
                             f"{port_syncs}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    first, last = losses[0].item(), losses[-1].item()
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f"{label}: loss {first} -> {last}")
    med = float(np.median(step_ms))
    line(label, steps=TIMED_STEPS, batch=batch[0].shape[0], **fields,
         **{f"{unit}_per_step": units}, median_step_ms=med,
         min_step_ms=min(step_ms),
         **{f"{unit}_per_s": units * TIMED_STEPS / wall},
         model_flops_per_step=flops, mfu=flops / (med / 1e3) / peak,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         first_loss=first, last_loss=last,
         skipped_steps=int(torch.stack(flags).sum()),
         host_syncs=sum(syncs.values()), sync_sites=json.dumps(syncs),
         launches_per_step=json.dumps(
             {k: v // TIMED_STEPS for k, v in launches.items()}),
         card=f"'{card}'")
    train_profile(profile_label, step, batch, groups)
    return launches


def lm_work(m, batch):
    """One language-model step's work: its tokens, and 6 N FLOPs per token
    against the bf16 peak."""
    tokens = batch[0].numel()
    n_params = sum(spec.total for spec in m.params.layout.specs)
    return dict(unit="tokens", units=tokens, flops=6.0 * n_params * tokens,
                peak=PEAK_BF16, params=n_params)


def device_ms_by_group(prof, groups):
    """Device time per kernel name (device events only: an op's row repeats
    its kernels' time), grouped by name fragments."""
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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
TRAIN_GROUPS = (("K1 layer_norm_fwd", ("_ln_fwd",)),
                ("K3 layer_norm_bwd", ("_ln_bwd",)),
                ("K2 flash_fwd", ("flash_fwd_",)),
                ("K4 flash_bwd", ("flash_bwd_",)),
                ("K5 unscale", ("_scale_flag",)),
                ("K6 adam", ("_adam",)),
                ("K11 softmax_fwd", ("_softmax_fwd",)),
                ("K12 softmax_bwd", ("_softmax_bwd",)),
                ("gemm", GEMM_FRAGMENTS))
# LAMB's per-tensor norms of p and u are plain torch.dot calls (cuBLAS dot
# and its reduction), listed before the GEMM fragments they share "cublas"
# with
BERT_GROUPS = (("K1 layer_norm_fwd", ("_ln_fwd",)),
               ("K3 layer_norm_bwd", ("_ln_bwd",)),
               ("K2 flash_fwd", ("flash_fwd_",)),
               ("K4 flash_bwd", ("flash_bwd_",)),
               ("K5 unscale", ("_scale_flag",)),
               ("K9 l2norm", ("_sumsq",)),
               ("K7 lamb_stage1", ("_lamb1",)),
               ("K8 scaled_update", ("_scaled_update",)),
               ("K11 softmax_fwd", ("_softmax_fwd",)),
               ("K12 softmax_bwd", ("_softmax_bwd",)),
               ("per-tensor norms", ("dot_kernel", "reduce_1Block")),
               ("gemm", GEMM_FRAGMENTS))


def train_profile(label, step, batch, groups):
    """PROFILE_STEPS more steps under torch.profiler: device time by layer
    (per step) and the device's idle share over the window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, by_group = device_ms_by_group(prof, groups)
    busy = sum(by_name.values())
    if busy == 0:
        line(label, device_time="not measured (no CUDA events in the trace)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    per = 1.0 / PROFILE_STEPS
    print(f"{label}: " + json.dumps({
        "steps": PROFILE_STEPS, "wall_ms_per_step": wall_ms * per,
        "device_busy_ms_per_step": busy * per, "idle_share": 1.0 - busy / wall_ms,
        "by_layer_ms_per_step": {k: v * per for k, v in by_group.items()},
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
    """Copies of the arena-native state a step may change: model arenas,
    masters, momentum buffers and step counts."""
    inner = tr.opt_state["inner"]
    return ([a.clone() for a in tr.params.arenas],
            [a.clone() for a in tr.opt_state["master"]],
            [b["momentum_buffer"].clone() for b in inner],
            [int(b["step"]) for b in inner])


def resnet_step_parity_phase(main_amp, fused_sgd, tree_flatten, cfg, weights):
    """One full-width O5 step at batch 2 on K5 and K10 against the same step
    with both on their plain versions, from the same weights and batch. The
    convolutions (cuDNN) and BatchNorm (plain torch) are the same on both
    paths; cuDNN's weight gradients may sum in another order from run to
    run, so the gradients are held to a relative L2 bound and the masters
    and momentum to what those gradient differences move: one SGD step from
    the same masters moves the masters by lr·g and seeds the momentum with
    g + decay·p."""
    images, labels = resnet_batch(cfg, PARITY_BATCH, 64)
    res = {}
    for impl in (None, "torch"):
        grads = []

        class RecordingSGD(fused_sgd):
            """FusedSGD that keeps a copy of each gradient arena it is given."""

            def step_flat(self, flat_params, flat_grads, state, **kw):
                grads.append(flat_grads.clone())
                return super().step_flat(flat_params, flat_grads, state, **kw)

        opt = RecordingSGD(RESNET_LR, 0.9, weight_decay=RESNET_WD, impl=impl)
        tr = resnet_trainer(main_amp, cfg, weights, "O5", PARITY_BATCH,
                            fused_optimizer=opt, impl=impl)
        met = tr.step(images, labels, RESNET_LR)
        torch.cuda.synchronize()
        if bool(met["found_inf"]):
            raise AssertionError(f"resnet_step_parity ({impl}): found_inf set")
        model, masters, moms, steps = resnet_state(tr)
        for arena, master in zip(model, masters):
            if not torch.equal(arena, master.to(arena.dtype)):
                raise AssertionError(
                    f"resnet_step_parity ({impl}): model arena != masters.to(dtype)")
        if steps != [1, 1]:
            raise AssertionError(f"resnet_step_parity ({impl}): step counts {steps}")
        res[impl] = (met["loss"].item(), grads, masters, moms,
                     [t.clone() for t in tree_flatten(tr.bn_state)[0]])
        del tr, opt
        torch.cuda.empty_cache()
    (lk, gk, mk, bk, sk), (lp, gp, mp, bp, sp) = res[None], res["torch"]
    loss_err = abs(lk - lp) / abs(lp)
    if not (np.isfinite(lk) and loss_err < 1e-5):
        raise AssertionError(f"resnet_step_parity: loss {lk} vs plain {lp}")
    grad_rel = [float((a - b).norm() / b.norm()) for a, b in zip(gk, gp)]
    if max(grad_rel) > 0.05:
        raise AssertionError(f"resnet_step_parity: grad arenas differ, rel L2 {grad_rel}")
    worst = {}
    for name, got, ref, coef in (("master", mk, mp, RESNET_LR), ("momentum", bk, bp, 1.0)):
        for a, b, ga, gb in zip(got, ref, gk, gp):
            dg = max_err(ga, gb)
            # what the gradients' difference moves, plus an ulp of the value
            tol = coef * dg + 2 ** -22 * float(b.abs().max())
            err = max_err(a, b)
            if err > tol:
                raise AssertionError(f"resnet_step_parity: {name} differs by "
                                     f"{err} > {tol} (grads differ by {dg})")
            worst[name] = max(worst.get(name, 0.0), err)
    bn_err = max(check_close("resnet_step_parity BN state", a, b,
                             dict(rtol=1e-5, atol=1e-6)) for a, b in zip(sk, sp))
    line("resnet_step_parity", batch=PARITY_BATCH, image=RESNET_IMAGE, loss=lk,
         plain_loss=lp, loss_rel_err=loss_err, grad_rel_l2=max(grad_rel),
         grad_max_abs_err=max(max_err(a, b) for a, b in zip(gk, gp)),
         master_max_abs_err=worst["master"],
         momentum_max_abs_err=worst["momentum"], bn_state_max_abs_err=bn_err,
         model_arena_is_master_cast="bitwise")


def resnet_skip_phase(main_amp, cfg, weights):
    """An O5 step whose loss is weighted by inf (the trainer's static loss
    scale set to inf: bf16 gradients cannot overflow from a finite scale
    here, as the GPT skip step explains): model arenas, masters, momentum
    and step counts stay bitwise unchanged."""
    tr = resnet_trainer(main_amp, cfg, weights, "O5", PARITY_BATCH,
                        loss_scale=float("inf"))
    before = resnet_state(tr)
    met = tr.step(*resnet_batch(cfg, PARITY_BATCH, 65), RESNET_LR)
    torch.cuda.synchronize()
    after = resnet_state(tr)
    if not bool(met["found_inf"]):
        raise AssertionError("resnet_skip_step: found_inf not set")
    same = all(torch.equal(a, b) for xs, ys in zip(before[:3], after[:3])
               for a, b in zip(xs, ys))
    if not same or after[3] != [0, 0]:
        raise AssertionError(f"resnet_skip_step: the state changed (steps {after[3]})")
    line("resnet_skip_step", found_inf=True, state="bitwise unchanged",
         step_count=after[3][0])
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
RESNET_GROUPS = (("K10 sgd", ("_sgd",)),
                 ("K5 unscale", ("_scale_flag",)),
                 ("copies and casts", ("copy",)),
                 ("convs and fc", ("conv", "cudnn", "implicit", "fprop", "dgrad",
                                   "wgrad", "nhwc", *GEMM_FRAGMENTS)),
                 ("elementwise and reductions (BN, ReLU, residual, loss)",
                  ("elementwise", "reduce")))


def resnet_training_phase(label, profile_label, main_amp, cfg, weights,
                          opt_level, counters, expect, flops_per_image, peak,
                          n_params, card):
    """The trainer at batch 128 on one fixed batch (``training_phase``)."""
    tr = resnet_trainer(main_amp, cfg, weights, opt_level, RESNET_BATCH)

    def step(images, labels):
        met = tr.step(images, labels, RESNET_LR)
        return met["loss"], None, met["found_inf"]

    launches = training_phase(
        label, profile_label, step, resnet_batch(cfg, RESNET_BATCH, 72),
        counters, expect, RESNET_GROUPS, card, unit="images",
        units=RESNET_BATCH, flops=RESNET_BATCH * flops_per_image, peak=peak,
        opt_level=opt_level, image=RESNET_IMAGE, params=n_params,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    del tr
    torch.cuda.empty_cache()
    return launches


# (kernel key, route, source, the TPU kernel it replaces)
KERNEL_ROWS = (
    ("layer_norm_fwd", "triton", "beforeholiday_tpu_torch/ops/normalization.py",
     "beforeholiday_tpu/ops/normalization.py:55"),
    ("flash_fwd", "cuda", "beforeholiday_tpu_torch/csrc/flash_fwd.cu",
     "beforeholiday_tpu/ops/attention.py:152"),
    ("layer_norm_bwd", "triton", "beforeholiday_tpu_torch/ops/normalization.py",
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
)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from beforeholiday_tpu_torch import _build, amp, infer
    from beforeholiday_tpu_torch.ops._autocast import cast_floats
    from beforeholiday_tpu_torch.ops import attention as attn
    from beforeholiday_tpu_torch.ops import multi_tensor as mt
    from beforeholiday_tpu_torch.ops import normalization as norm
    from beforeholiday_tpu_torch.ops import softmax as sm
    from beforeholiday_tpu_torch.examples.imagenet import main_amp
    from beforeholiday_tpu_torch.models import resnet
    from beforeholiday_tpu_torch.ops.arena import make_spec, tree_flatten
    from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
    from beforeholiday_tpu_torch.testing import bert, gpt

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
    t_nvcc = time.perf_counter() - t0
    x = torch.zeros(8, 1024, device="cuda", dtype=torch.bfloat16)
    norm.ln_fwd_kernel(x, x[0], x[0], 1e-5, False, torch.bfloat16)
    torch.cuda.synchronize()
    line("build", seconds=time.perf_counter() - t0, nvcc_seconds=t_nvcc,
         libraries=",".join(sorted(libs)))

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
    rows = {"layer_norm_fwd": k1_phase(norm), "flash_fwd": k2_phase(attn),
            "layer_norm_bwd": k3_phase(norm), "flash_bwd": k4_phase(attn),
            "unscale": k5_phase(mt, n_bf16, n_fp32),
            "adam": k6_phase(mt, n_bf16, n_fp32),
            "l2norm": k9_phase(mt, bert_spec.padded_total),
            "lamb_stage1": k7_phase(mt, bert_spec.padded_total),
            "scaled_update": k8_phase(mt, make_spec, bert_spec),
            "sgd": k10_phase(mt, {
                "resnet_o5": (rspecs[torch.bfloat16], torch.bfloat16),
                "resnet_o5_fp32": (rspecs[torch.float32], torch.float32),
                "resnet_o0": (o0_spec, None)}),
            "softmax_fwd": k11_phase(sm), "softmax_bwd": k12_phase(sm)}
    torch.cuda.empty_cache()

    engine_phase(infer, gpt, cast_floats, params, cfg)
    torch.cuda.empty_cache()
    eng, serve_launches = serving_phase(infer, params, cfg, norm, attn, card)
    profile_phase(infer, eng, cfg)
    del eng
    torch.cuda.empty_cache()

    counters = launch_counters(norm, attn, mt, sm)
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

    resnet_step_parity_phase(main_amp, FusedSGD, tree_flatten, rcfg, rweights)
    resnet_skip_phase(main_amp, rcfg, rweights)
    flops_per_image = resnet_flops_per_image(resnet, rcfg, rweights)
    n_params = o0_spec.total
    launches["resnet_o5"] = resnet_training_phase(
        "resnet_training", "resnet_profile", main_amp, rcfg, rweights, "O5",
        counters, STEP_LAUNCHES["resnet_o5"], flops_per_image, PEAK_BF16,
        n_params, card)
    # O0's convolutions run in fp32 here (cudnn.allow_tf32 is off above), so
    # its MFU is taken against the fp32 peak
    launches["resnet_o0"] = resnet_training_phase(
        "resnet_o0_training", "resnet_o0_profile", main_amp, rcfg, rweights,
        "O0", counters, STEP_LAUNCHES["resnet_o0"], flops_per_image,
        PEAK_FLOPS[torch.float32], n_params, card)
    launches["serving"] = serve_launches

    kernels = []
    for kname, route, source, replaces in KERNEL_ROWS:
        for shape, (tag, f) in rows[kname].items():
            # launches: the run of the path that gives the kernel this shape
            # (the serving run, or the GPT, BERT or ResNet training run, with
            # flash or unfused attention)
            path = shape if shape in launches else "serving"
            kernels.append(dict(
                name=f"{kname}[{shape}: {tag}]", route=route, source=source,
                replaces=replaces, launches=launches[path][kname],
                max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
                bound_ms=f["bound_ms"], bound_by=f["bound_by"],
                library_ms=f["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
