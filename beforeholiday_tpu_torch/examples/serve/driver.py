"""Async open-loop serving driver — counterpart of ``examples/serve/driver.py``:
the request-queue front end for the continuous batcher, with the crash
flight recorder wired in.

Two coroutines share one event loop:

* the **producer** replays an open-loop arrival trace (requests become
  visible at their arrival times, independent of completion — the load model
  serving benchmarks use, as opposed to closed-loop think-time clients);
* the **scheduler loop** runs ``ContinuousBatcher.step()`` whenever there is
  admitted or admissible work, yielding to the event loop between steps so
  arrivals interleave with decoding.

The flight recorder rides the loop: every scheduler step records a snapshot
row (active/waiting/free-page/token counters — host ints the batcher already
owns), and the loop runs inside ``with FlightRecorder(...)`` with the
excepthook armed, so a request loop that dies leaves ``flight.json`` holding
the last N scheduler states.

Run it (on the card; ``--device cpu`` on the CPU)::

    python -m beforeholiday_tpu_torch.examples.serve.driver --requests 24 --rate 20
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from beforeholiday_tpu_torch import monitor
from beforeholiday_tpu_torch.infer import (
    ContinuousBatcher,
    EngineConfig,
    InferenceEngine,
    Request,
    ServingTelemetry,
)
from beforeholiday_tpu_torch.monitor import FlightRecorder
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.testing import gpt


def synthetic_trace(
    n_requests: int,
    rate_hz: float,
    *,
    seed: int = 0,
    prompt_range=(6, 24),
    new_tokens_range=(4, 28),
    vocab: int = 512,
    shared_prefix_tokens: int = 0,
    prefix_families: int = 4,
) -> List[Request]:
    """Poisson arrivals with uniform prompt/generation lengths (arrival times
    are offsets from trace start), drawn from ``np.random.RandomState(seed)``
    in the reference's order, so one seed gives the reference's trace.

    ``shared_prefix_tokens > 0`` switches to a PREFIX-HEAVY workload: the
    trace draws ``prefix_families`` fixed prompt prefixes of that length
    (system prompts / few-shot preambles), and each request samples its
    family Zipf-style (probability ∝ 1/rank) before appending its own
    uniform-random tail from ``prompt_range``."""
    rng = np.random.RandomState(seed)
    families = [
        list(rng.randint(1, vocab, shared_prefix_tokens))
        for _ in range(prefix_families if shared_prefix_tokens > 0 else 0)
    ]
    if families:
        weights = 1.0 / np.arange(1, len(families) + 1)
        weights /= weights.sum()
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_hz))
        tail = list(rng.randint(1, vocab, rng.randint(*prompt_range)))
        prefix = (
            families[int(rng.choice(len(families), p=weights))]
            if families else []
        )
        out.append(
            Request(
                rid=i,
                prompt=[int(x) for x in prefix + tail],
                max_new_tokens=int(rng.randint(*new_tokens_range)),
                arrival=t,
            )
        )
    return out


async def _producer(batcher: ContinuousBatcher, trace: Sequence[Request],
                    base: float) -> None:
    """Submit each request at its arrival time (absolute = base + offset)."""
    for req in trace:
        delay = base + req.arrival - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        req.arrival = time.perf_counter()  # rebase to the live clock
        batcher.submit(req)


async def _scheduler_loop(
    batcher: ContinuousBatcher,
    producer_task: "asyncio.Task",
    recorder: Optional[FlightRecorder],
    fail_after_steps: Optional[int] = None,
) -> None:
    step = 0
    while not producer_task.done() or not batcher.idle:
        if batcher.idle:
            await asyncio.sleep(0.001)  # nothing admissible yet
            continue
        batcher.step()
        step += 1
        if recorder is not None:
            recorder.record(step, {
                "active": len(batcher.active),
                "waiting": len(batcher.waiting),
                "finished": len(batcher.finished),
                "free_pages": batcher.allocator.available,
                "tokens_out": sum(len(r.out) for r in batcher.finished)
                + sum(len(r.out) for r in batcher.active),
            })
        if fail_after_steps is not None and step >= fail_after_steps:
            raise RuntimeError(
                f"injected request-loop failure at step {step}"
            )
        await asyncio.sleep(0)  # let arrivals in between decode steps
    await producer_task


def serve(
    trace: Sequence[Request],
    engine: InferenceEngine,
    *,
    flight_path: str = "flight.json",
    flight_capacity: int = 64,
    fail_after_steps: Optional[int] = None,
    telemetry: Optional[ServingTelemetry] = None,
    prefix_cache: bool = False,
) -> List[Request]:
    """Replay an open-loop trace through the continuous batcher; returns the
    finished requests. Any exception in the request loop dumps the flight
    recorder to ``flight_path`` before propagating. Pass a
    :class:`ServingTelemetry` to collect per-request lifecycle records and
    latency histograms (its SLO policy, if any, dumps through the same
    flight recorder on breach). ``prefix_cache=True`` turns on radix
    prefix caching (shared prompt prefixes alias shared KV pages)."""
    batcher = ContinuousBatcher(
        engine, telemetry=telemetry, prefix_cache=prefix_cache
    )
    recorder = FlightRecorder(
        flight_capacity, path=flight_path, auto_dump_on_rollback=False
    )

    async def _main():
        base = time.perf_counter()
        producer = asyncio.get_running_loop().create_task(
            _producer(batcher, trace, base)
        )
        try:
            await _scheduler_loop(
                batcher, producer, recorder, fail_after_steps
            )
        finally:
            producer.cancel()

    # context manager + armed excepthook: a raising request loop writes the
    # black box on the way out
    with recorder:
        asyncio.run(_main())
    return batcher.finished


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=20.0, help="arrivals/sec")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flight-path", default="flight.json")
    ap.add_argument("--fail-after-steps", type=int, default=None,
                    help="inject a request-loop crash (flight-dump demo)")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="prefix-heavy workload: length of the shared "
                         "prompt prefix each family reuses (0 = off)")
    ap.add_argument("--prefix-families", type=int, default=4,
                    help="number of Zipf-sampled shared-prefix families")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve with radix prefix caching on")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = gpt.GPTConfig()
    params = gpt.init(cfg, torch.Generator(device).manual_seed(args.seed),
                      device=device)
    engine = InferenceEngine(
        params, cfg,
        EngineConfig(max_seq_len=64, page_size=8, num_pages=49,
                     batch_buckets=(4, 8), prefill_seq_buckets=(32, 64)),
        device=device,
    )
    trace = synthetic_trace(
        args.requests, args.rate, seed=args.seed,
        shared_prefix_tokens=args.shared_prefix_tokens,
        prefix_families=args.prefix_families,
    )
    telemetry = ServingTelemetry()
    finished = serve(
        trace, engine,
        flight_path=args.flight_path,
        fail_after_steps=args.fail_after_steps,
        telemetry=telemetry,
        prefix_cache=args.prefix_cache,
    )
    # histogram-backed report: p50/p99 carry the analytic error bound
    # instead of a raw-list sort, and throughput/goodput come pre-rolled
    report = telemetry.serving_report()
    stats = {
        "requests": len(finished),
        "tokens": report["tokens_delivered"],
        "tokens_per_s": report["tokens_per_s"],
        "goodput_tokens_per_s": report["goodput_tokens_per_s"],
        "ttft_p99_ms": report["ttft_p99_ms"],
        "p50_ms": report["e2e_p50_ms"],
        "p99_ms": report["e2e_p99_ms"],
        "preemptions": report["preemptions"],
        "prefix_hit_rate": report["prefix_hit_rate"],
        "compile_counts": monitor.compile_counts(),
    }
    print(stats)
    return stats


if __name__ == "__main__":
    main()
