"""Port parity: serving telemetry and the monitors under it — ``Histogram``,
``TraceRecorder``/``timeline``, ``ServingTelemetry`` (records, report, SLO
burn rate), ``FlightRecorder``, the compile counters, and the open-loop
driver's ``synthetic_trace`` — held against the JAX package on the CPU.

Both packages run the same calls with the same numbers on a fake clock: the
histogram counts are bitwise equal and so the quantiles; the trace events
equal except their timestamps; the serving reports, per-request records and
SLO dumps equal; the flight dumps carry the same keys. Every test that arms
the flight recorder's hooks disarms them (or uses the context manager), so
no worker process keeps them.
"""

import importlib.util
import itertools
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beforeholiday_tpu import infer as jinfer
from beforeholiday_tpu import monitor as jmon
from beforeholiday_tpu.testing import gpt as jgpt
from beforeholiday_tpu_torch import infer as tinfer
from beforeholiday_tpu_torch import monitor as tmon
from beforeholiday_tpu_torch.examples.serve import driver as tdriver
from beforeholiday_tpu_torch.testing import gpt as tgpt

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=64, seq_len=64, d_model=32, n_heads=2, n_layers=2)
PACKAGES = {"jax": (jinfer, jmon), "torch": (tinfer, tmon)}
_PREFIX = itertools.count()


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_driver", REPO / "examples" / "serve" / "driver.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeClock:
    """A clock that advances ``dt`` at every reading: both packages' batchers
    read it at the same points, so they see the same times."""

    def __init__(self, dt=0.01):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


# ------------------------------------------------------------------ histogram


GEOMETRIES = [dict(lo=1e-6, decades=9, bins_per_decade=8),
              dict(lo=1e-5, decades=8, bins_per_decade=20),
              dict(lo=1e-3, decades=3, bins_per_decade=10)]


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_histogram_counts_and_quantiles_match_jax(geo):
    """Host updates (out-of-range samples included): counts bitwise, every
    quantile equal, the summary and error bound equal; merge is bitwise
    bucket addition in both."""
    rng = np.random.RandomState(7)
    a = rng.lognormal(mean=-4.0, sigma=1.5, size=5_000)
    b = np.concatenate([rng.lognormal(-2.0, 2.0, 3_000), [1e-9, 5e2, 7e3]])
    hists = {}
    for name, (_, mon) in PACKAGES.items():
        ha, hb = mon.Histogram(**geo), mon.Histogram(**geo)
        ha.update(a)
        hb.update(b)
        assert ha.merge(hb) is ha
        hists[name] = ha
    t, j = hists["torch"], hists["jax"]
    np.testing.assert_array_equal(t.counts(), j.counts())
    assert t.count == j.count == a.size + b.size
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q)
    assert t.summary() == j.summary() and t.geometry == j.geometry
    assert t.quantile_error_bound == j.quantile_error_bound


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_bucketize_on_cpu_tensors_matches_jax(geo):
    """The device path on a CPU tensor: the count vector JAX's jitted
    ``bucketize`` returns, int32, no sample dropped, and folded in it equals
    the host path."""
    rng = np.random.RandomState(3)
    data = rng.lognormal(-4.0, 1.2, 4_096).astype(np.float32)
    # the edges and the out-of-range: both packages compare in fp32, so at
    # lo itself (fp32 lo is not fp64 lo) they part from the host path alike
    edges = np.array([0.0, 1e-12, 1e6, geo["lo"]], np.float32)
    for x in (data, np.concatenate([data, edges])):
        got = tmon.Histogram(**geo).bucketize(torch.from_numpy(x))
        ref = np.asarray(jax.jit(jmon.Histogram(**geo).bucketize)(jnp.asarray(x)))
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), ref)
        assert int(got.sum()) == x.size
    h = tmon.Histogram(**geo).add_counts(
        tmon.Histogram(**geo).bucketize(torch.from_numpy(data)).numpy())
    np.testing.assert_array_equal(h.counts(),
                                  tmon.Histogram(**geo).update(data).counts())


def test_histogram_errors_match_jax():
    for _, mon in PACKAGES.values():
        h = mon.Histogram(bins_per_decade=20)
        assert np.isnan(h.quantile(0.5))
        with pytest.raises(ValueError, match="geometry mismatch"):
            h.merge(mon.Histogram(bins_per_decade=40))
        with pytest.raises(TypeError):
            h.merge([1, 2, 3])
        with pytest.raises(ValueError, match="slots"):
            h.add_counts(np.zeros(3, np.int64))
        with pytest.raises(ValueError):
            mon.Histogram(lo=0.0)


# --------------------------------------------------------------- the timeline


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _nan_safe(x):
    """Plain values with NaN made comparable (an empty histogram's quantile
    is NaN in both packages)."""
    return json.loads(json.dumps(x), parse_constant=lambda c: c)


def test_trace_recorder_events_match_jax(tmp_path):
    """Spans, instants, counters (one series and several) on two ranks,
    nested timelines restoring the outer recorder, and the export's order:
    every event equal but its timestamp."""
    out = {}
    for name, (_, mon) in PACKAGES.items():
        rec = mon.TraceRecorder(process_name="serve")
        with mon.timeline(str(tmp_path / f"{name}.json"), recorder=rec) as r:
            assert mon.active_recorder() is rec and r is rec
            with rec.span("step", args={"n": 1}):
                rec.instant("mark", rank=3, args={"x": 2})
                rec.counter("pages_free", 7)
                rec.counter("mix", {"a": 1, "b": 2.5}, rank=3)
            with mon.timeline(recorder=mon.TraceRecorder(process_name="x")) as inner:
                assert mon.active_recorder() is inner
                inner.instant("inner")
            assert mon.active_recorder() is rec
        assert mon.active_recorder() is None
        exported = json.loads((tmp_path / f"{name}.json").read_text())
        out[name] = (_strip_ts(rec.events()), _strip_ts(exported["traceEvents"]),
                     exported["displayTimeUnit"], _strip_ts(inner.events()))
    assert out["torch"] == out["jax"]
    assert tmon.TraceRecorder()._process_name == "beforeholiday_tpu_torch"


# ------------------------------------------------------- ServingTelemetry


@pytest.fixture(scope="module")
def engines():
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tgpt.GPTConfig(**TINY)
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(max_seq_len=32, page_size=4, num_pages=11, batch_buckets=(2, 4),
              prefill_seq_buckets=(8, 16, 32))
    je = jinfer.InferenceEngine(jparams, jcfg, jinfer.EngineConfig(
        **kw, entry_prefix=f"torch_telemetry_{next(_PREFIX)}"))
    # one entry prefix: the engines' host spans carry it
    te = tinfer.InferenceEngine(tparams, tcfg, tinfer.EngineConfig(
        **kw, entry_prefix=je.cfg.entry_prefix), device="cpu")
    return {"jax": je, "torch": te}


SHARED = [7, 7, 3, 9, 1, 2, 4, 8]


def _mix(mod):
    """Shared-prefix and plain prompts arriving over time: prefix hits,
    decode-extend, preemption on the 10-page pool."""
    reqs = []
    for i in range(8):
        prompt = (SHARED if i % 2 else [3 + i, 1, 4]) + [(5 * i + j) % 60
                                                        for j in range(i % 3)]
        reqs.append(mod.Request(rid=i, prompt=list(prompt),
                                max_new_tokens=3 + (7 * i) % 9,
                                arrival=0.0 if i < 3 else 0.02 * i))
    return reqs


def test_serving_report_matches_jax(engines):
    """The same mix through each package's batcher with telemetry and the
    prefix cache on a fake clock, inside a timeline: the reports, the
    per-request records and the histograms equal; the trace's request and
    counter tracks equal except their timestamps."""
    out = {}
    for name, (infer, mon) in PACKAGES.items():
        eng = engines[name]
        eng.reset_cache()
        tel = infer.ServingTelemetry()
        with mon.timeline(recorder=mon.TraceRecorder(process_name="serve")) as rec:
            bat = infer.ContinuousBatcher(eng, now_fn=FakeClock(),
                                          telemetry=tel, prefix_cache=True)
            for r in _mix(infer):
                bat.submit(r)
            fin = bat.run(max_steps=500)
        out[name] = dict(
            report=tel.serving_report(),
            records={rid: rec_.as_dict() for rid, rec_ in tel.records.items()},
            counts={k: h.counts().tolist() for k, h in tel.histograms().items()},
            events=_strip_ts(rec.events()),
            streams={r.rid: r.out for r in fin})
    t, j = out["torch"], out["jax"]
    assert _nan_safe(t["report"]) == _nan_safe(j["report"])
    assert t["records"] == j["records"] and t["counts"] == j["counts"]
    assert t["events"] == j["events"] and t["streams"] == j["streams"]
    rep = t["report"]
    assert rep["finished"] == 8 and rep["prefix_hits"] > 0
    assert rep["preemptions"] > 0 and rep["prefix_hit_tokens"] > 0
    assert rep["tokens_delivered"] == sum(len(s) for s in t["streams"].values())


def _burn(infer, tel, n, ttft_s, t0=0.0, dt=0.2):
    """n requests whose TTFT is ``ttft_s``, spread dt apart (the JAX test's
    feed)."""
    for i in range(n):
        t = t0 + i * dt
        r = infer.Request(rid=100 + i, prompt=[1, 2], max_new_tokens=1, arrival=t)
        tel.on_enqueue(r, t)
        r.first_token_time = t + ttft_s
        tel.on_admit([r], t + ttft_s, prefill_s=ttft_s)
        r.out = [1]
        tel.on_retire([r], t + ttft_s)


@pytest.mark.parametrize("ttft_s, breach", [(0.05, True), (0.005, False)])
def test_slo_breach_dumps_flight_once_as_jax(tmp_path, ttft_s, breach):
    """The burn-rate rule on both windows: a breach dumps the active flight
    recorder once (latched), with the offending records and the burn rates
    the JAX package writes; a met target stays quiet."""
    out = {}
    for name, (infer, mon) in PACKAGES.items():
        policy = infer.SLOPolicy(ttft_ms=10.0, objective=0.5, short_window_s=1.0,
                                 long_window_s=4.0, burn_threshold=1.5, min_events=4)
        tel = infer.ServingTelemetry(slo=policy)
        fr = mon.FlightRecorder(16, path=str(tmp_path / f"{name}.json"),
                                auto_dump_on_rollback=False)
        with fr:
            _burn(infer, tel, 10, ttft_s)
            _burn(infer, tel, 10, ttft_s, t0=3.0)
        assert len(fr.dumps) == int(breach)
        payload = json.loads(pathlib.Path(fr.dumps[0]).read_text()) if breach else {}
        snaps = [{k: v for k, v in s.items() if k != "counters"}
                 for s in payload.get("snapshots", [])]
        out[name] = _nan_safe((tel.breached, tel.serving_report(),
                               payload.get("reason"), sorted(payload), snaps))
    assert out["torch"] == out["jax"]
    if breach:
        assert out["torch"][2] == "slo_breach:ttft_ms"
        assert out["torch"][4][-1]["extra"]["requests"]


# --------------------------------------------------------- FlightRecorder


def test_flight_dump_keys_match_jax(tmp_path):
    """A manual dump after recorded rows, a noted checkpoint and a rollback
    trip: the same keys, reason, ring and trajectory as JAX's; the rollback
    trip dumps by itself once."""
    out = {}
    for name, (_, mon) in PACKAGES.items():
        fr = mon.FlightRecorder(3, path=str(tmp_path / f"{name}_auto.json"))
        fr.note_checkpoint(6, "/ckpt/gen_6")
        for step in range(5):
            fr.record(step, {"loss_scale": 2.0 ** step, "rollbacks_total": float(step >= 3),
                             "last_skip_reason": 1})
        assert len(fr) == 3 and len(fr.dumps) == 1  # the trip at step 3
        path = fr.dump(str(tmp_path / f"{name}.json"), reason="manual")
        payload = json.loads(pathlib.Path(path).read_text())
        auto = json.loads(pathlib.Path(fr.dumps[0]).read_text())
        keys = sorted(payload)
        for p in (payload, auto):
            p.pop("created_unix")
            p["last_checkpoint"].pop("noted_unix")
            for s in p["snapshots"]:
                s.pop("counters")
        out[name] = (keys, payload["reason"], payload["snapshots"],
                     payload["loss_scale_trajectory"], payload["last_health"],
                     payload["last_checkpoint"], auto["reason"], auto["snapshots"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == sorted([
        "reason", "created_unix", "capacity", "last_checkpoint", "n_snapshots",
        "snapshots", "loss_scale_trajectory", "last_health", "dispatch_summary",
        "comms_summary", "compile_summary", "probe_failures"])


def test_flight_context_manager_and_crash_hook(tmp_path):
    """The context manager installs the recorder as active and arms the
    excepthook, dumps on a raising block and restores both; arm/disarm
    restore ``sys.excepthook``; ``attach`` chains a logger's callback."""
    hook = sys.excepthook
    fr = tmon.FlightRecorder(4, path=str(tmp_path / "crash.json"))
    with pytest.raises(RuntimeError):
        with fr:
            assert tmon.active_flight_recorder() is fr and sys.excepthook is not hook
            fr.record(0, {"x": 1})
            raise RuntimeError("boom")
    assert tmon.active_flight_recorder() is None and sys.excepthook is hook
    assert json.loads((tmp_path / "crash.json").read_text())["reason"] == \
        "exception:RuntimeError"
    fr.arm_crash_dump().arm_crash_dump()  # idempotent
    try:
        assert sys.excepthook is not hook
    finally:
        fr.disarm_crash_dump()
    assert sys.excepthook is hook

    class Logger:
        callback = None

    seen, log = [], Logger()
    log.callback = lambda step, row: seen.append(step)
    fr.attach(log)
    log.callback(9, {"y": 2})
    assert seen == [9] and fr.snapshots()[-1]["metrics"] == {"y": 2}


def test_flight_preemption_dump_then_signal_death(tmp_path):
    """Armed in a child process that SIGTERMs itself: the ring is dumped
    with the preemption reason and the last checkpoint, then the signal is
    re-delivered, so the process dies a signal death (the JAX package's
    elastic test, without its graceful consumer). In process, arm and disarm
    restore SIGUSR1's disposition."""
    dump = tmp_path / "preempt.json"
    script = (
        "import os, signal\n"
        "from beforeholiday_tpu_torch.monitor.flight import FlightRecorder\n"
        f"rec = FlightRecorder(capacity=8, path={str(dump)!r})\n"
        "rec.note_checkpoint(6, '/ckpt/gen_6')\n"
        "rec.arm_preemption_dump()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "raise SystemExit('unreachable')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGTERM, proc.stderr
    payload = json.loads(dump.read_text())
    assert payload["reason"] == "preemption:SIGTERM"
    assert payload["last_checkpoint"]["generation"] == 6
    prev = signal.getsignal(signal.SIGUSR1)
    fr = tmon.FlightRecorder(2, path=str(tmp_path / "unused.json"))
    fr.arm_preemption_dump(signal.SIGUSR1)
    try:
        assert signal.getsignal(signal.SIGUSR1) is not prev
        fr.arm_preemption_dump(signal.SIGUSR1)  # idempotent
    finally:
        fr.disarm_preemption_dump()
    assert signal.getsignal(signal.SIGUSR1) is prev
    fr.disarm_preemption_dump()  # a no-op when not armed


# ----------------------------------------------------- compile counters


def test_compile_counters_match_jax():
    """One entry's calls through each package's gate (two engines' worth of
    wrappers in the port, one registry entry in JAX): the same counts and
    summary; a scoped reset clears one entry and re-arms its strict gate."""
    name = f"torch_counter_{next(_PREFIX)}"
    jmon.reset_compile_counts(name)
    jg = jmon.track_compiles(name, strict=True, max_signatures=2)(lambda x: x)
    tg = [tmon.track_compiles(name, strict=True, max_signatures=2)(lambda x: x)
          for _ in range(2)]
    for n in (2, 3, 2):
        jg(jnp.zeros(n))
    tg[0](torch.zeros(2))
    tg[0](torch.zeros(3))
    tg[1](torch.zeros(2))
    assert tmon.compile_counts()[name] == jmon.compile_counts()[name] == {
        "signatures": 2, "calls": 3}
    row = lambda rows: next(r for r in rows if r["entry"] == name)
    assert row(tmon.compile_summary()) == row(jmon.compile_summary())
    with pytest.raises(tmon.BucketGateError):
        tg[0](torch.zeros(4))
    tmon.reset_compile_counts(name)
    jmon.reset_compile_counts(name)
    assert name not in tmon.compile_counts() and name not in jmon.compile_counts()
    tg[0](torch.zeros(4))  # a fresh budget
    assert tmon.compile_counts()[name] == {"signatures": 1, "calls": 1}


# ----------------------------------------------------- the open-loop driver


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("prefix", [0, 32])
def test_synthetic_trace_matches_jax(seed, prefix):
    jdrv = _jax_driver()
    kw = dict(seed=seed, shared_prefix_tokens=prefix, prefix_families=3)
    got = tdriver.synthetic_trace(20, 50.0, **kw)
    ref = jdrv.synthetic_trace(20, 50.0, **kw)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival) for r in got] == \
        [(r.rid, [int(x) for x in r.prompt], r.max_new_tokens, r.arrival)
         for r in ref]
    if prefix:
        assert len({tuple(r.prompt[:prefix]) for r in got}) <= 3


def test_driver_serve_on_cpu_and_crash_dump(engines, tmp_path):
    """``serve()`` on the CPU engine with telemetry and the prefix cache:
    every request finishes, the histograms fill and no flight file is
    written; with ``fail_after_steps`` the loop raises and the dump it
    wrote holds the JAX schema's keys and the scheduler rows, and the
    excepthook is restored."""
    hook = sys.excepthook
    eng = engines["torch"]
    eng.reset_cache()
    trace = tdriver.synthetic_trace(6, 500.0, seed=1, vocab=64,
                                    prompt_range=(2, 8), new_tokens_range=(2, 6),
                                    shared_prefix_tokens=8, prefix_families=2)
    tel = tinfer.ServingTelemetry()
    path = tmp_path / "flight.json"
    fin = tdriver.serve(trace, eng, flight_path=str(path), telemetry=tel,
                        prefix_cache=True)
    rep = tel.serving_report()
    assert len(fin) == 6 and not path.exists()
    assert rep["tokens_delivered"] == sum(len(r.out) for r in fin)
    assert tel.ttft.count == tel.e2e.count == 6 and np.isfinite(rep["e2e_p99_ms"])
    eng.reset_cache()
    trace = tdriver.synthetic_trace(6, 500.0, seed=1, vocab=64,
                                    prompt_range=(2, 8), new_tokens_range=(2, 6))
    with pytest.raises(RuntimeError, match="injected"):
        tdriver.serve(trace, eng, flight_path=str(path), fail_after_steps=2)
    payload = json.loads(path.read_text())
    assert payload["reason"] == "exception:RuntimeError"
    assert payload["n_snapshots"] == 2
    assert set(payload["snapshots"][-1]["metrics"]) == {
        "active", "waiting", "finished", "free_pages", "tokens_out"}
    assert tmon.active_flight_recorder() is None and sys.excepthook is hook
