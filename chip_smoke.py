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
   shapes, timed beside its bound and ``F.layer_norm``;
4. K2 (flash-attention forward, CUDA C++) against its plain version at the
   prefill and decode shapes, timed beside its bound and
   ``F.scaled_dot_product_attention``;
5. engine parity: the full-width bf16 GPT engine on the kernels against the
   same engine on the plain path, and paged decode against the contiguous
   forward;
6. serving: seeded requests through ``ContinuousBatcher.run()``, with bucket
   padding and preemption, the kernels' launch counts reset just before and
   read just after; then the same mix again under ``torch.profiler`` for the
   device time by layer and the device's idle share;
7. the ``kernels`` JSON line, the card line, and the final ``ok`` line.

``F.layer_norm`` and ``F.scaled_dot_product_attention`` are timed here only,
as yardsticks (``library_ms``); the port never calls them.
"""

import json
import subprocess
import sys
import time

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

# tolerances (PERF.md explains each)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
FP32_TOL = dict(rtol=1e-5, atol=2e-5)
LOGIT_TOL = 0.1


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


# ------------------------------------------------------------------- K1


def k1_phase(norm):
    """Check K1 everywhere, time it at the engine's two shapes."""
    g = gen(1)
    checks = [  # rows, hidden, in dtype, rms, out dtype
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
        w = (1 + .1 * torch.randn(hidden, generator=g, device="cuda")).to(dt)
        b = None if rms else (.1 * torch.randn(hidden, generator=g, device="cuda")).to(dt)
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
            fields.update(
                ms=time_ms(lambda: norm.ln_fwd_kernel(*args)),
                plain_ms=time_ms(lambda: norm.ln_fwd_torch(*args)),
                library_ms=time_ms(lambda: F.layer_norm(x, (hidden,), w, b, 1e-5)),
                bound_ms=bms, bound_by=by)
            rows_out["prefill" if rows > 32 else "decode"] = (tag, fields)
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
        (128, 1024, 1024, 64, True, torch.bfloat16),
        (512, 1, 1024, 64, False, torch.bfloat16),
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
        lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
        args = (q, k, v, lens, causal, D ** -0.5)
        o, lse = attn.flash_fwd_kernel(*args)
        ro, rlse = attn.flash_fwd_torch(*args)
        torch.cuda.synchronize()
        tag = f"BH{BH} Sq{Sq} Sk{Sk} D{D}{' causal' if causal else ''} {str(dt)[6:]}"
        if not (torch.all(o[0] == 0) and torch.all(lse[0] == -1e30)):
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
            rows_out["prefill" if causal else "decode"] = (tag, fields)
        line("K2", shape=tag, **fields)
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
                 ("gemm", ("gemm", "sm90_", "cutlass", "xmma", "cublas")),
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
    by_name = {}  # device kernels only: an op's row repeats its kernels' time
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if busy == 0:
        line("profile", device_time="not measured (no CUDA events in the trace)")
        return
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in by_name.items():
        g = next((g for g, frags in KERNEL_GROUPS
                  if any(f in key for f in frags)), "other")
        groups[g] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print("profile: " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "by_layer_ms": groups,
        "top_kernels_ms": {k[:90]: v for k, v in top}}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from beforeholiday_tpu_torch import _build, infer
    from beforeholiday_tpu_torch.ops._autocast import cast_floats
    from beforeholiday_tpu_torch.ops import attention as attn
    from beforeholiday_tpu_torch.ops import normalization as norm
    from beforeholiday_tpu_torch.testing import gpt

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

    k1 = k1_phase(norm)
    k2 = k2_phase(attn)

    cfg = gpt.GPTConfig(**MODEL)
    params = gpt.init(cfg, gen(0), device="cuda")
    engine_phase(infer, gpt, cast_floats, params, cfg)
    torch.cuda.empty_cache()
    eng, launches = serving_phase(infer, params, cfg, norm, attn, card)
    profile_phase(infer, eng, cfg)

    kernels = []
    for kname, route, source, replaces, rows in (
        ("layer_norm_fwd", "triton", "beforeholiday_tpu_torch/ops/normalization.py",
         "beforeholiday_tpu/ops/normalization.py:55", k1),
        ("flash_fwd", "cuda", "beforeholiday_tpu_torch/csrc/flash_fwd.cu",
         "beforeholiday_tpu/ops/attention.py:152", k2),
    ):
        for shape in ("prefill", "decode"):
            tag, f = rows[shape]
            kernels.append(dict(
                name=f"{kname}[{shape}: {tag}]", route=route, source=source,
                replaces=replaces, launches=launches[kname],
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
