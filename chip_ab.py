#!/usr/bin/env python3
"""Time one checkout of the PyTorch/CUDA port against another on one NVIDIA
GPU: K2 and K4 (flash attention forward and backward, no dropout) at the GPT
and BERT training shapes, and the flagship GPT and BERT-Large O5 training
steps at full width (the shapes, batches and optimizers of
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
warm-up steps. It exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose beforeholiday_tpu_torch to time")
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
    from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB
    from beforeholiday_tpu_torch.testing import bert, gpt

    if not attn.__file__.startswith(root):
        raise RuntimeError(f"imported {attn.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.build()
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
        del q, k, v, do, o, lse

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
