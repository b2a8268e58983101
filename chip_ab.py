#!/usr/bin/env python3
"""Time one checkout of the PyTorch/CUDA port against another on one NVIDIA
GPU: K2 and K4 (flash attention forward and backward) at the GPT and BERT
training shapes, without dropout and at the GPT shape with it, K3
(LayerNorm backward) at the training shape, K13 (the dropout keep mask) at
the dropout steps' four shapes, and the flagship GPT and BERT-Large O5
training steps at full width (the shapes, batches and optimizers of
``chip_smoke.py``), with no dropout, so that any two checkouts of the port
run the same work.

Run from the root of a checkout, once for each package root to compare, in
turns within one session on one card (A, B, B, A)::

    python3 chip_ab.py --root PARENT_CHECKOUT
    python3 chip_ab.py --root .

Each run imports ``beforeholiday_tpu_torch`` from ``--root`` only, builds
its kernels there, and prints one JSON line: the root, the card's name and
power limit, the kernels' median CUDA-event times (L2 flushed before each
call) and the steps' median CUDA-event step times over 10 steps after 2
warm-up steps. With ``--sass`` it also prints K13's instruction mix: the
SASS of the loop that hashes a thread's patch (``cuobjdump -sass`` on the
built library), counted by opcode and by pipe, per element; with
``--ptxas NAME ...`` the registers, spills and shared memory that ``nvcc
-Xptxas -v`` reports for each kernel of ``csrc/NAME.cu``. With ``--decode``
it times the serving engine instead, and nothing else: ``chip_smoke.py``'s
``decode_profile`` (the flagship GPT's decode step at the largest decode
bucket, 32 sequences of about 500 cached tokens: wall ms, tokens/s, device
busy ms and idle share, device ms by layer and by page op: gathers, casts,
copies, scatters), its serving mix through ``ContinuousBatcher.run()``
(tokens/s, then the same mix under torch.profiler), and K2 at the engine's
decode shape at three length patterns and in paged mode, each kernel's own
device time beside the call's. It exits non-zero without a CUDA device.
"""

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

# SASS opcodes by the pipe that issues them on Hopper: integer multiplies on
# the FMA-heavy pipe, logic, compares, selects and shifts on the ALU pipe
FMA_OPS = ("IMAD",)
ALU_OPS = ("LOP3", "ISETP", "SEL", "IADD3", "SHF", "PRMT", "LEA", "IABS",
           "VIMNMX", "PLOP3")
# elements a K13 thread writes in one trip of its loop: a 2 x 16 patch
K13_PATCH = 32


def k13_sass_mix(lib_path):
    """K13's hashing loop in the SASS of ``lib_path``: the backward branch
    whose body holds the 16-byte stores, its opcodes counted, and the
    instructions per element on the FMA and ALU pipes."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", sass)]
    loops = []  # (target, branch) of each backward branch
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            loops.append((int(t.group(1), 16), addr))
    for lo, hi in loops:
        body = [op for addr, op, _ in ins if lo <= addr <= hi]
        if "STG.E.128" in body:
            ops = collections.Counter(body)
            per = lambda names: sum(n for op, n in ops.items()
                                    if op.split(".")[0] in names) / K13_PATCH
            return {"opcodes": dict(ops.most_common()),
                    "fma_per_element": per(FMA_OPS), "alu_per_element": per(ALU_OPS),
                    "all_per_element": len(body) / K13_PATCH}
    raise RuntimeError("no loop with 16-byte stores in K13's SASS")


def ptxas_usage(build, name):
    """``nvcc -Xptxas -v`` on ``csrc/<name>.cu`` with the package's flags:
    each kernel's registers, spill bytes and shared memory, by mangled
    name."""
    out = build.BUILD_DIR / f"ptxas-{name}.so"
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(out), str(build.sources()[name])],
                         check=True, capture_output=True, text=True).stderr
    usage, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            usage.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", ln)
        if m and fn:
            usage.setdefault(fn, {})["registers"] = int(m.group(1))
            usage[fn]["static_smem"] = int(m.group(2) or 0)
    return usage


def chip_smoke_module():
    """chip_smoke.py beside this script (not one under ``--root``)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_kernel_split(torch, np, attn, cs):
    """K2 at the engine's decode shape (BH 512, Sq 1, Sk 1024, D 64, bf16)
    at three length patterns (uniform 0..1024 as chip_smoke.py's decode row,
    all 1024, all 32), and the paged mode at chip_smoke.py's PAGED bucket,
    its own lengths and all 32, the latter with and without the host-known
    bound the engine passes (kv_max 32): cs.time_ms's median and each
    kernel's device time under the profiler, the L2 flushed the same way
    before each call."""
    g = cs.gen(12)
    q, k, v = (torch.randn(512, s, 64, generator=g, device="cuda").bfloat16()
               for s in (1, 1024, 1024))
    ragged = np.random.default_rng(2).integers(0, 1025, 512)
    ragged[:2] = (0, 1024)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def kernels_us(fn, n=10):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        return {e.key.split("<")[0].split("::")[-1]: e.self_device_time_total / n
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "flash" in e.key}

    out = {}
    for name, lens in (("ragged", ragged), ("full", np.full(512, 1024)),
                       ("32", np.full(512, 32))):
        a = (q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda"), False, 0.125)
        fn = lambda: attn.flash_fwd_kernel(*a)
        out[name] = {"ms": cs.time_ms(fn), "kernels_us": kernels_us(fn)}
    if hasattr(attn, "_paged_decode_kernel"):
        q, kp, vp, table, lens = cs.paged_inputs(20)
        hs = (cs.PAGED["H"], cs.PAGED["D"] ** -0.5)
        short = torch.full_like(lens, 32)
        for name, pa, kw in (("paged", (q, kp, vp, table, lens, *hs), {}),
                             ("paged_32", (q, kp, vp, table, short, *hs), {}),
                             ("paged_32_kv_max", (q, kp, vp, table, short, *hs),
                              {"kv_max": 32})):
            fn = lambda: attn._paged_decode_kernel(*pa, **kw)
            out[name] = {"ms": cs.time_ms(fn), "kernels_us": kernels_us(fn)}
    return out


def decode_ab(torch, infer, gpt):
    """The serving engine of the package under test: chip_smoke.py's decode
    step profile and its serving mix, timed, then profiled; and K2's decode
    kernels (decode_kernel_split)."""
    import time

    import numpy as np

    from beforeholiday_tpu_torch.ops import attention as attn

    cs = chip_smoke_module()
    cfg = gpt.GPTConfig(**cs.MODEL)
    params = gpt.init(cfg, cs.gen(0), device="cuda")
    out = {"decode": cs.decode_profile(infer, params, cfg)}
    torch.cuda.empty_cache()
    ecfg = infer.EngineConfig(**{**cs.ENGINE, "num_pages": cs.SERVE_PAGES})
    eng = infer.InferenceEngine(params, cfg, ecfg)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for profiled in (False, True):
        bat = infer.ContinuousBatcher(eng)
        for r in cs.serving_requests(infer, cfg):
            bat.submit(r)
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=acts) if profiled else None
        if prof:
            prof.__enter__()
        t0 = time.perf_counter()
        fin = bat.run(max_steps=10000)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        if prof is None:
            tokens = sum(len(r.out) for r in fin)
            out["serving"] = {"tokens": tokens, "wall_ms": wall_ms,
                              "tokens_per_s": tokens / wall_ms * 1e3,
                              "calls": eng.call_counts}
            continue
        prof.__exit__(None, None, None)
        by_name, groups = cs.device_ms_by_group(prof, cs.KERNEL_GROUPS)
        busy = sum(by_name.values())
        out["serving_profile"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "by_layer_ms": groups,
            "page_ops_ms": cs.op_groups_ms(prof, cs.PAGE_OPS)}
    del eng
    torch.cuda.empty_cache()
    out["k2_decode"] = decode_kernel_split(torch, np, attn, cs)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose beforeholiday_tpu_torch to time")
    ap.add_argument("--sass", action="store_true",
                    help="also print K13's instruction mix")
    ap.add_argument("--ptxas", nargs="*", default=[], metavar="NAME",
                    help="also print ptxas's resource use for csrc/NAME.cu")
    ap.add_argument("--decode", action="store_true",
                    help="time the serving engine's decode step and serving "
                         "mix only")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    from beforeholiday_tpu_torch import _build, amp
    from beforeholiday_tpu_torch.ops import attention as attn
    from beforeholiday_tpu_torch.ops import normalization as norm
    from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from beforeholiday_tpu_torch.testing import bert, gpt

    if not attn.__file__.startswith(root):
        raise RuntimeError(f"imported {attn.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.build(["flash_fwd"] if args.decode else None)
    if args.decode:
        from beforeholiday_tpu_torch import infer

        print(json.dumps({"root": args.root, "card": card,
                          **decode_ab(torch, infer, gpt)}), flush=True)
        return 0
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    out = {"root": args.root, "card": card}
    for name, BH, S, causal in (("gpt", 256, 1024, True), ("bert", 2048, 128, False)):
        g = gen(1)
        q, k, v, do = (torch.randn(BH, S, 64, generator=g, device="cuda").bfloat16()
                       for _ in range(4))
        lens = torch.full((BH,), S, dtype=torch.int32, device="cuda")
        o, lse = attn.flash_fwd_kernel(q, k, v, lens, causal, 0.125)
        out[f"k2_{name}_ms"] = time_ms(
            lambda: attn.flash_fwd_kernel(q, k, v, lens, causal, 0.125))
        out[f"k4_{name}_ms"] = time_ms(
            lambda: attn.flash_bwd_kernel(q, k, v, o, do, lse, None, lens, causal,
                                          0.125))
        if causal:  # with dropout: the hash inside the products
            key = torch.tensor([1234, 5678], dtype=torch.int64, device="cuda")
            od, lsed = attn.flash_fwd_kernel(q, k, v, lens, causal, 0.125, 0.1, key)
            out[f"k2_{name}_dropout_ms"] = time_ms(
                lambda: attn.flash_fwd_kernel(q, k, v, lens, causal, 0.125, 0.1, key))
            out[f"k4_{name}_dropout_ms"] = time_ms(
                lambda: attn.flash_bwd_kernel(q, k, v, od, do, lsed, None, lens, causal,
                                              0.125, 0.1, key))
            del od, lsed
        del q, k, v, do, o, lse

    g = gen(2)
    x = (torch.randn(16384, 1024, generator=g, device="cuda") * 2 + 0.5).bfloat16()
    dy = torch.randn(16384, 1024, generator=g, device="cuda").bfloat16()
    w = 1 + 0.1 * torch.randn(1024, generator=g, device="cuda")
    out["k3_train_ms"] = time_ms(lambda: norm.ln_bwd_kernel(x, w, dy, 1e-5, False, True))
    del x, dy, w
    key = torch.tensor([1234, 5678], dtype=torch.int64, device="cuda")
    for name, shape in (("gpt_probs", (256, 1024, 1024)),
                        ("gpt_hidden", (16, 1024, 1024)),
                        ("bert_hidden", (128, 128, 1024)),
                        ("bert_probs", (2048, 128, 128))):
        out[f"k13_{name}_ms"] = time_ms(
            lambda: attn.dropout_keep_mask_kernel(key, shape, 0.1))
    if args.sass:
        out["k13_sass"] = k13_sass_mix(_build.lib_path("dropout_mask"))
    for name in args.ptxas:
        out[f"ptxas_{name}"] = ptxas_usage(_build, name)
    torch.cuda.empty_cache()

    def steps_ms(m, loss_fn, batch):
        svag = amp.scaled_value_and_grad(loss_fn, m.scaler)
        state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init()}

        def step():
            loss, g, fi, state["scaler"] = svag(m.params, state["scaler"], *batch)
            m.params, state["opt"] = m.optimizer.step(m.params, g, state["opt"],
                                                      found_inf=fi)

        for _ in range(2):
            step()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in times]))

    cfg = gpt.GPTConfig(vocab_size=32000, seq_len=1024, d_model=1024, n_heads=16,
                        n_layers=8, dtype=torch.bfloat16)
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg),
                       gpt.init(cfg, gen(0), device="cuda"), FusedAdam(lr=1e-4),
                       "O5", arena_native=True)
    batch = gpt.synthetic_batch(cfg, 16, generator=gen(70), device="cuda")
    out["gpt_step_ms"] = steps_ms(
        m, lambda p, a, b: gpt.loss_fn(p, a, b, cfg, forward_fn=m.apply), batch)
    del m, batch
    torch.cuda.empty_cache()

    bcfg = bert.BertConfig(vocab_size=30522, seq_len=128, d_model=1024, n_heads=16,
                           n_layers=8, dtype=torch.bfloat16)
    m = amp.initialize(lambda p, t: bert.forward(p, t, bcfg),
                       bert.init(bcfg, gen(1), device="cuda"),
                       FusedLAMB(lr=1e-3, weight_decay=0.01), "O5", arena_native=True)
    tok, tgt, mask, nsp = bert.synthetic_batch(bcfg, 128, generator=gen(71),
                                               device="cuda")
    out["bert_step_ms"] = steps_ms(
        m, lambda p, a, b, c, d: bert.pretrain_loss(p.unpack(), a, b, c, d, bcfg),
        (tok, tgt, mask, nsp))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
