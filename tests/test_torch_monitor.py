"""Port parity: the training-side monitor (``beforeholiday_tpu_torch.monitor``)
against the JAX package's on the same observations and timelines, mirroring
``tests/test_monitor.py`` and ``tests/test_remat.py``'s ledger classes.

* ``TrainMonitor``: update, pack, state dict and ``global_norm`` (the arena
  path on K9's plain version) against JAX's; ``aggregate`` and ``rank_skew``
  at W 2 (gloo) against JAX's under ``shard_map``.
* ``MetricsLogger``: the rows of one monitored training loop equal JAX's,
  one copy per logged step, the writers, the callback, the overflow-streak
  warning, and ``FlightRecorder.attach``.
* ``overlap_report``, ``straggler_report`` and ``goodput_report`` equal to
  JAX's on one hand-built timeline.
* the roofline: the unfused tiny GPT's forward and backward products equal
  JAX's ``dot_general`` count exactly; the flash path books K2/K4's closed
  forms (without them the attention would silently count 0); the summary
  arithmetic equals JAX's for the same FLOPs, bytes and seconds; the H100
  spec.
* the memory ledger's records, the dispatch counters, spans, ``Timers`` and
  the profiler trace.
"""

import functools
import json
import logging
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))

import _torch_world as tw  # noqa: E402

from beforeholiday_tpu import monitor as jmon  # noqa: E402
from beforeholiday_tpu.testing import gpt as jgpt  # noqa: E402
from beforeholiday_tpu_torch import monitor as tmon  # noqa: E402
from beforeholiday_tpu_torch import utils as tutils  # noqa: E402
from beforeholiday_tpu_torch.monitor import export as texport  # noqa: E402
from beforeholiday_tpu_torch.ops import fused_layer_norm  # noqa: E402
from beforeholiday_tpu_torch.ops.arena import PackedParams  # noqa: E402
from beforeholiday_tpu_torch.testing import gpt as tgpt  # noqa: E402
from beforeholiday_tpu_torch.utils.logging import reset_warn_once  # noqa: E402

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_warn_once()
    for mod in (tmon, jmon):
        mod.reset_roofline_ledger()
        mod.reset_memory_ledger()
    tmon.reset_dispatch_counters()
    yield
    for mod in (tmon, jmon):
        mod.reset_roofline_ledger()
        mod.reset_memory_ledger()


def _obs(seed):
    rng = np.random.RandomState(seed)
    g = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    p = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    p2 = {k: v - 0.01 * g[k] for k, v in p.items()}
    return dict(loss=np.float32(rng.rand() * 4), grads=g, params=p, new_params=p2,
                scale=np.float32(2.0 ** rng.randint(0, 16)),
                health={"consecutive_overflows": np.int32(seed % 3),
                        "skipped_total": np.int32(seed), "rollbacks_total": np.int32(1),
                        "last_skip_reason": np.int32(2),
                        "bn_shift_dominated": np.int32(0)},
                moe={"moe_aux_loss": np.float32(0.25), "moe_z_loss": np.float32(0.5),
                     "moe_drop_fraction": np.float32(0.125)})


def _update(mon, m, o, to):
    return mon.update(m, loss=to(o["loss"]), grads={k: to(v) for k, v in o["grads"].items()},
                      params={k: to(v) for k, v in o["params"].items()},
                      new_params={k: to(v) for k, v in o["new_params"].items()},
                      scaler_state={"scale": to(o["scale"])},
                      health={k: to(v) for k, v in o["health"].items()},
                      moe={k: to(v) for k, v in o["moe"].items()})


def _jax_and_port(n=3, decay=0.9):
    jm, tm = jmon.TrainMonitor(ema_decay=decay), tmon.TrainMonitor(ema_decay=decay)
    a, b = jm.init(), tm.init(device="cpu")
    for i in range(n):
        o = _obs(i)
        a = _update(jm, a, o, jnp.asarray)
        b = _update(tm, b, o, lambda v: torch.from_numpy(np.array(v)))
    return jm, a, tm, b


# ------------------------------------------------------------ TrainMonitor


class TestTrainMonitor:
    def test_update_and_pack_match_jax(self):
        jm, a, tm, b = _jax_and_port()
        assert tm.keys == jm.keys
        got, want = tm.pack(b).numpy(), np.asarray(jm.pack(a))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert all(b[k].dtype == torch.int32 for k, dt, _ in tm._SPEC
                   if dt == torch.int32)

    def test_ema_seeds_then_decays_as_jax(self):
        jm, tm = jmon.TrainMonitor(ema_decay=0.9), tmon.TrainMonitor(ema_decay=0.9)
        a, b = jm.init(), tm.init(device="cpu")
        for v in (10.0, 20.0, 5.0):
            a = jm.update(a, loss=jnp.float32(v))
            b = tm.update(b, loss=torch.tensor(v))
            np.testing.assert_allclose(float(b["loss_ema"]), float(a["loss_ema"]),
                                       rtol=1e-7)
        assert float(tm.update(tm.init(device="cpu"), loss=torch.tensor(10.0))[
            "loss_ema"]) == 10.0

    def test_state_dict_and_unpack_match_jax(self):
        jm, a, tm, b = _jax_and_port()
        got, want = tm.state_dict(b), jm.state_dict(a)
        assert list(got) == list(want)
        for k in want:
            assert type(got[k]) is type(want[k]), k
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        row = tm.unpack_host(tm.pack(b).numpy())
        assert row["steps"] == 3 and isinstance(row["steps"], int)
        back = tm.load_state_dict(got, device="cpu")
        assert all(torch.equal(back[k], b[k]) or k in ("loss", "loss_ema")
                   for k in tm.keys)
        drift = tm.load_state_dict({"loss": 9.0, "not_a_metric": 123}, device="cpu")
        assert float(drift["loss"]) == 9.0 and int(drift["steps"]) == 0

    def test_global_norm_on_an_arena_matches_the_tree_and_jax(self):
        o = _obs(4)
        tree = {k: torch.from_numpy(v) for k, v in o["grads"].items()}
        packed = PackedParams.pack(tree)
        want = float(jmon.global_norm(jax.tree.map(jnp.asarray, o["grads"])))
        np.testing.assert_allclose(float(tmon.global_norm(packed)), want, rtol=RTOL)
        np.testing.assert_allclose(float(tmon.global_norm(tree)), want, rtol=RTOL)
        np.testing.assert_allclose(float(tmon.global_norm(packed.arenas[0])), want,
                                   rtol=RTOL)
        assert float(tmon.global_norm({})) == 0.0
        # the arena path is K9's op on the CPU: its plain version
        assert tmon.dispatch_counters()[("l2norm", "cpu", "float32")]["jnp"] == 2

    def test_update_on_packed_params_matches_the_tree(self):
        o = _obs(5)
        tm = tmon.TrainMonitor()

        def packed(d):
            return PackedParams.pack({k: torch.from_numpy(v) for k, v in d.items()})

        a = tm.update(tm.init(device="cpu"), grads=packed(o["grads"]),
                      params=packed(o["params"]), new_params=packed(o["new_params"]))
        b = tm.update(tm.init(device="cpu"),
                      grads={k: torch.from_numpy(v) for k, v in o["grads"].items()},
                      params={k: torch.from_numpy(v) for k, v in o["params"].items()},
                      new_params={k: torch.from_numpy(v)
                                  for k, v in o["new_params"].items()})
        np.testing.assert_allclose(tm.pack(a).numpy(), tm.pack(b).numpy(), rtol=RTOL)

    def test_init_needs_a_card_unless_asked_for_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            tmon.TrainMonitor().init()
        with pytest.raises(RuntimeError):
            tmon.Timers()


def test_aggregate_and_rank_skew_match_jax(tmp_path, devices8):
    """W 2 over gloo: sum / max / min per key against JAX's psum / pmax /
    pmin under shard_map; rank_skew through the comms ledger."""
    W = 2
    rng = np.random.RandomState(1)
    losses = (rng.rand(W) * 5).astype(np.float32)
    gvals = rng.rand(W, 4).astype(np.float32)
    skips = np.array([3, 1], np.int32)
    durs = np.array([2.0, 5.0], np.float32)
    res = tw.run_world(tw.monitor_scenario, W, tmp_path, losses, gvals, skips, durs)
    mon = jmon.TrainMonitor()
    mesh = Mesh(np.asarray(devices8[:W]), ("data",))

    def run(loss, g, skip, d):
        m = mon.update(mon.init(), loss=loss[0], grads={"g": g[0]},
                       scaler_state={"scale": 2.0 ** skip[0].astype(jnp.float32)},
                       health={"skipped_total": skip[0]})
        return mon.pack(mon.aggregate(m, "data")), jmon.rank_skew(d[0], "data")

    f = functools.partial(jax.shard_map, check_vma=False)(
        run, mesh=mesh, in_specs=(P("data"),) * 4, out_specs=(P(), P()))
    want, skew = jax.jit(f)(jnp.asarray(losses), jnp.asarray(gvals), jnp.asarray(skips),
                            jnp.asarray(durs))
    for packed, tskew, records in res:
        np.testing.assert_allclose(packed, np.asarray(want), rtol=RTOL)
        for k, v in skew.items():
            np.testing.assert_allclose(tskew[k], np.asarray(v), rtol=RTOL, err_msg=k)
        assert sorted(r["kind"] for r in records
                      if r["site"] == "monitor.rank_skew") == ["pmax", "pmin", "psum"]
    row = mon.unpack_host(res[0][0])
    assert row["skipped_total"] == 3 and row["loss_scale"] == 2.0
    np.testing.assert_allclose(row["loss"], losses.mean(), rtol=1e-6)


# ------------------------------------------------------------ MetricsLogger


class _CountingLogger(tmon.MetricsLogger):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fetches = 0

    def _fetch(self, packed):
        self.fetches += 1
        return super()._fetch(packed)


def _jax_rows(every, n_steps):
    """``tests/test_monitor.py``'s monitored loop, JAX's logger."""
    mon = jmon.TrainMonitor()
    lg = jmon.MetricsLogger(mon, every=every, warn_overflow_streak=0)

    @jax.jit
    def step(p, m, x):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((x @ p["w"]) ** 2))(p)
        p2 = jax.tree.map(lambda a, b: a - 0.1 * b, p, g)
        m = mon.update(m, loss=loss, grads=g, params=p, new_params=p2)
        return p2, m, mon.pack(m)

    p, m = {"w": jnp.ones((3, 3), jnp.float32) * 0.5}, mon.init()
    x = jnp.ones((2, 3), jnp.float32)
    rows = []
    for i in range(1, n_steps + 1):
        p, m, packed = step(p, m, x)
        row = lg.log(packed, step=i)
        if row is not None:
            rows.append(row)
    return rows


def _port_rows(lg, mon, n_steps):
    """The same loop on the port: the packed vector is the step's only
    monitor output, the logger its only reader."""
    w = torch.full((3, 3), 0.5)
    m = mon.init(device="cpu")
    x = torch.ones(2, 3)
    rows = []
    for i in range(1, n_steps + 1):
        p = w.clone().requires_grad_()
        loss = ((x @ p) ** 2).mean()
        (g,) = torch.autograd.grad(loss, p)
        w = (p - 0.1 * g).detach()
        m = mon.update(m, loss=loss.detach(), grads={"w": g}, params={"w": p.detach()},
                       new_params={"w": w})
        row = lg.log(mon.pack(m), step=i)
        if row is not None:
            rows.append(row)
    return rows


def _assert_rows(got, want):
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k in w:
            assert type(g[k]) is type(w[k]), k
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


class TestMetricsLogger:
    def test_one_copy_per_logged_step_and_rows_match_jax(self):
        mon = tmon.TrainMonitor()
        lg = _CountingLogger(mon, every=2, warn_overflow_streak=0)
        rows = _port_rows(lg, mon, 10)
        assert lg.fetches == 5
        assert [r["step"] for r in rows] == [2, 4, 6, 8, 10]
        _assert_rows(rows, _jax_rows(2, 10))

    def test_every_step_cadence_is_one_copy_each(self):
        mon = tmon.TrainMonitor()
        lg = _CountingLogger(mon, every=1, warn_overflow_streak=0)
        rows = _port_rows(lg, mon, 4)
        assert lg.fetches == 4 and rows[-1]["loss"] < rows[0]["loss"]
        _assert_rows(rows, _jax_rows(1, 4))

    def test_jsonl_and_csv_writers_match_jax(self, tmp_path):
        for fmt in ("jsonl", "csv"):
            texts = {}
            for name, mod, to in (("jax", jmon, jnp.float32),
                                  ("torch", tmon, torch.tensor)):
                mon = mod.TrainMonitor()
                path = tmp_path / f"{name}.{fmt}"
                m = mon.init() if mod is jmon else mon.init(device="cpu")
                with mod.MetricsLogger(mon, path=str(path), fmt=fmt) as lg:
                    for i in (1, 2):
                        m = mon.update(m, loss=to(1.5 * i))
                        lg.drain(m, step=i)
                texts[name] = path.read_text()
            assert texts["torch"] == texts["jax"], fmt
        row = json.loads((tmp_path / "torch.jsonl").read_text().splitlines()[0])
        assert row["step"] == 1 and row["loss"] == 1.5

    def test_callback_and_dict_or_packed(self):
        mon = tmon.TrainMonitor()
        seen = []
        lg = tmon.MetricsLogger(mon, callback=lambda step, row: seen.append((step, row)))
        m = mon.update(mon.init(device="cpu"), loss=torch.tensor(2.0))
        assert lg.drain(m, step=7)["loss"] == 2.0
        assert lg.drain(mon.pack(m), step=8)["loss"] == 2.0
        assert [s for s, _ in seen] == [7, 8] and seen[0][1]["steps"] == 1

    def test_histograms_land_as_quantile_columns(self):
        mon = tmon.TrainMonitor()
        h = tmon.Histogram()
        h.update(np.array([1e-3, 2e-3, 4e-3]))
        row = tmon.MetricsLogger(mon).drain({**mon.init(device="cpu"), "ttft": h}, 1)
        assert row["ttft_p50"] == h.quantile(0.5)

    def test_overflow_streak_warns_once_per_incident(self):
        mon = tmon.TrainMonitor()
        lg = tmon.MetricsLogger(mon, warn_overflow_streak=3)
        records = []

        class _Capture(logging.Handler):
            def emit(self, record):
                records.append(record)

        h = _Capture()
        texport.logger.addHandler(h)
        try:
            for streak, step in ((3, 1), (4, 2), (0, 3), (5, 4)):
                m = mon.update(mon.init(device="cpu"),
                               health={"consecutive_overflows": torch.tensor(streak)})
                lg.drain(m, step=step)
            warns = [r for r in records if r.levelno == logging.WARNING]
            assert len(warns) == 2 and "overflow streak" in warns[0].getMessage()
        finally:
            texport.logger.removeHandler(h)

    def test_flight_recorder_attach_chains_the_rows(self, tmp_path):
        mon = tmon.TrainMonitor()
        seen = []
        lg = tmon.MetricsLogger(mon, every=2, callback=lambda s, r: seen.append(s))
        fr = tmon.FlightRecorder(4, path=str(tmp_path / "f.json")).attach(lg)
        _port_rows(lg, mon, 6)
        assert seen == [2, 4, 6]
        assert [s["step"] for s in fr.snapshots()] == [2, 4, 6]
        dump = json.loads(open(fr.dump()).read())
        assert dump["loss_scale_trajectory"] == [0.0, 0.0, 0.0]


# ------------------------------------------------------------ the timeline


def _timeline():
    """Two ranks, a step span each with compute and comms spans (one
    overlapping), checkpoint, drain and compile spans, and an unclosed
    span (dropped)."""
    def be(name, pid, tid, s, e):
        return [{"ph": "B", "name": name, "pid": pid, "tid": tid, "ts": s},
                {"ph": "E", "pid": pid, "tid": tid, "ts": e}]

    ev = []
    for pid, scale in ((0, 1.0), (1, 1.5)):
        ev += [{"ph": "B", "name": "step", "pid": pid, "tid": 0, "ts": 0.0}]
        ev += be("fwd", pid, 0, 10.0, 60.0 * scale)
        ev += be("psum:ddp.grads", pid, 1, 40.0, 90.0 * scale)
        ev += be("ckpt:wait", pid, 0, 95.0, 99.0)
        ev += [{"ph": "E", "pid": pid, "tid": 0, "ts": 100.0 * scale}]
    ev += be("elastic:drain", 0, 0, 120.0, 130.0)
    ev += be("compile:gpt", 0, 0, 130.0, 135.5)
    ev += be("step", 0, 0, 140.0, 180.0)
    ev += [{"ph": "B", "name": "never_closed", "pid": 0, "tid": 0, "ts": 190.0}]
    ev += [{"ph": "i", "name": "memory:x", "pid": 0, "tid": 0, "ts": 200.0}]
    return ev


def test_overlap_straggler_and_goodput_reports_match_jax():
    ev = _timeline()
    assert tmon.span_intervals(ev) == jmon.span_intervals(ev)
    assert tmon.overlap_report(ev) == jmon.overlap_report(ev)
    assert tmon.straggler_report(ev) == jmon.straggler_report(ev)
    got = tmon.goodput_report(ev, compile_counts={"a": {"signatures": 2}},
                              ckpt={"exposed_s": 0.5})
    assert got == jmon.goodput_report(ev, compile_counts={"a": {"signatures": 2}},
                                      ckpt={"exposed_s": 0.5})
    assert got["wall_us"] == sum(got[f"{c}_us"] for c in (
        "productive", "checkpoint", "drain", "restore", "hang", "reshard", "compile",
        "other"))
    for name in ("ckpt:wait", "elastic:hang", "compile:x", "step", "other"):
        assert tmon.classify_span(name) == jmon.classify_span(name)


def test_spans_land_on_the_timeline():
    with tmon.timeline() as rec:
        with tmon.span("step"):
            with tmon.span("fwd"):
                pass
        with tmon.span("off", enabled=False):
            pass
    names = [iv["name"] for iv in tmon.span_intervals(rec.events())]
    assert sorted(names) == ["fwd", "step"]


# ------------------------------------------------------------ the roofline


TINY = dict(vocab_size=257, seq_len=32, d_model=64, n_heads=2, n_layers=2)
_DOTS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


def _port_costs(flash):
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    jp = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tok, tgt = jgpt.synthetic_batch(jax.random.PRNGKey(1), jcfg, 2)
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.requires_grad_()) for k, v in tp.items()}
    cfg = tgpt.GPTConfig(**TINY, use_flash_attention=flash)
    t1, t2 = torch.from_numpy(np.array(tok)).long(), torch.from_numpy(np.array(tgt)).long()
    costs = tmon.estimate_costs(lambda: tgpt.loss_fn(leaves, t1, t2, cfg).backward())
    return costs, (jp, tok, tgt)


def test_unfused_gpt_products_equal_jax_dot_general_exactly():
    costs, (jp, tok, tgt) = _port_costs(False)
    jcfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32, use_flash_attention=False)
    want = jmon.estimate_costs(jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, tok, tgt, jcfg))), jp)["by_primitive"]["dot_general"]
    got = sum(v for k, v in costs["by_primitive"].items() if k in _DOTS)
    assert got == want and costs["method"] == "flop_counter"
    assert costs["flops"] == got  # nothing else counts on the unfused path


def test_flash_path_books_k2_k4_closed_forms():
    """Without the kernels' closed forms the flash attention would count 0:
    K2 books 4 BH S S D, K4 8 BH S S D, halved (causal), per layer, and the
    flash step is the unfused step less its full-square attention products
    plus these."""
    flash, _ = _port_costs(True)
    unfused, _ = _port_costs(False)
    BH, S, D, L = 2 * TINY["n_heads"], TINY["seq_len"], TINY["d_model"] // TINY["n_heads"], 2
    fwd, bwd = 4 * BH * S * S * D // 2 * L, 8 * BH * S * S * D // 2 * L
    prim = flash["by_primitive"]
    assert prim["beforeholiday.flash_fwd"] == fwd and prim["beforeholiday.flash_bwd"] == bwd
    assert flash["flops"] == unfused["flops"] - 12 * BH * S * S * D * L + fwd + bwd


def test_half_gemm_with_an_fp32_result_counts_2mnk():
    """``ops/dense.py``'s card GEMM (bf16 x bf16 -> fp32, the ``.dtype``
    overloads of mm and addmm) counts 2 M N K, on meta tensors here."""
    a = torch.empty(16, 8, dtype=torch.bfloat16, device="meta")
    b = torch.empty(8, 4, dtype=torch.bfloat16, device="meta")
    bias = torch.empty(4, dtype=torch.float32, device="meta")
    costs = tmon.estimate_costs(lambda: (
        torch.mm(a, b, out_dtype=torch.float32),
        torch.addmm(bias, a, b, out_dtype=torch.float32)))
    assert costs["by_primitive"] == {"aten.mm": 2 * 16 * 8 * 4, "aten.addmm": 2 * 16 * 8 * 4}


def test_summary_and_report_arithmetic_match_jax():
    spec = dict(name="test_chip", peak_tflops=100.0, hbm_gbs=1000.0, fp8_peak_tflops=250.0)
    rows = {}
    for name, mod in (("jax", jmon), ("torch", tmon)):
        mod.register_chip_spec(**spec)
        mod.record_wall_time("step", 0.5, steps=2, flops=4e12, fp8_flops=1e12,
                             bytes_accessed=3e10, comms_seconds=0.1)
        mod.record_wall_time("mem", 0.2, flops=1e9, bytes_accessed=1e11)
        mod.record_wall_time("wire", 1.0, flops=1e9, comms_seconds=0.8)
        rows[name] = (mod.roofline_summary(chip="test_chip"),
                      {k: v for k, v in mod.perf_report(chip="test_chip", events=[])
                       .items() if k.endswith(("_mfu", "_bw_util"))})
    assert rows["torch"] == rows["jax"]
    assert {r["entry"]: r["bound"] for r in rows["torch"][0]} == {
        "mem": "memory", "step": "compute", "wire": "comms"}


def test_track_costs_counts_once_per_signature_and_joins_spans():
    calls = []

    @tmon.track_costs("tiny_mm")
    def step(x, w):
        calls.append(1)
        return x @ w

    x, w = torch.ones(4, 8), torch.ones(8, 2)
    step(x, w)
    step(x, w)
    step(torch.ones(6, 8), w)
    rec = tmon.roofline_records()["tiny_mm"]
    assert rec["calls"] == 3 and len(calls) == 3
    assert [s["flops"] for s in rec["signatures"]] == [2 * 4 * 8 * 2, 2 * 6 * 8 * 2]
    assert rec["signatures"][0]["bytes_accessed"] == 4 * (32 + 16 + 8)
    ev = [{"ph": "B", "name": "tiny_mm", "pid": 0, "tid": 0, "ts": 0.0},
          {"ph": "E", "pid": 0, "tid": 0, "ts": 2000.0}]
    assert tmon.join_spans(ev) == 1
    row = tmon.roofline_summary(chip="cpu_proxy")[0]
    assert row["seconds_per_step"] == 2e-3 and row["method"] == "flop_counter"
    assert row["mfu"] == 2 * 6 * 8 * 2 / 2e-3 / 0.2e12
    assert "tiny_mm_mfu" in tmon.perf_report(chip="cpu_proxy", events=ev)


def test_h100_spec_is_the_card_default(monkeypatch):
    spec = tmon.get_chip_spec("NVIDIA H100 80GB HBM3")
    assert (spec.peak_tflops, spec.hbm_gbs, spec.fp8_peak) == (989.0, 3350.0, 1979.0)
    from beforeholiday_tpu_torch.monitor import roofline

    assert roofline._resolve_chip(None).name == "cpu_proxy"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: spec.name)
    assert roofline._resolve_chip(None) is spec
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Some Other Card")
    with pytest.raises(KeyError, match="register_chip_spec"):
        roofline._resolve_chip(None)


# ------------------------------------------------------------ memory ledger


def test_memory_ledger_records_rollup_and_reset():
    w = torch.randn(8, 8, requires_grad=True)

    @tmon.track_memory("t_step")
    def step(x):
        (x @ w).square().sum().backward()
        return x

    x = torch.randn(4, 8)
    assert step(x) is x
    step(x)
    rec = tmon.memory_records()["t_step"]
    assert rec["calls"] == 2 and len(rec["signatures"]) == 1
    stats = rec["signatures"][0]
    # x saved by the product (w's gradient), the product by the square
    assert stats["temp_bytes"] == 4 * (32 + 32)
    assert stats["argument_bytes"] == stats["output_bytes"] == stats["alias_bytes"] == 128
    assert stats["method"] == "saved_tensors"
    row = tmon.memory_summary()[0]
    assert row["entry"] == "t_step" and row["peak_temp_bytes"] == stats["temp_bytes"]
    for key in ("argument_bytes", "output_bytes", "alias_bytes", "generated_code_bytes"):
        assert key in row
    once = tmon.measure_memory(lambda y: y + 1, x, entry="t_once")
    assert tmon.memory_records()["t_once"] == {"calls": 0, "signatures": [once]}
    tmon.reset_memory_ledger()
    assert tmon.memory_records() == {}


# ------------------------------------------------------ counters and spans


def test_dispatch_counters_count_each_choice():
    x, wgt = torch.randn(3, 8), torch.ones(8)
    for _ in range(3):
        fused_layer_norm(x, wgt)
    fused_layer_norm(x.double(), wgt.double(), impl="torch")
    got = tmon.dispatch_counters()
    assert got[("layer_norm", "cpu", "float32")] == {"pallas": 0, "jnp": 3, "probes": 0}
    assert got[("layer_norm", "cpu", "float64")]["jnp"] == 1
    row = next(r for r in tmon.dispatch_summary() if r["op"] == "layer_norm")
    assert row == {"op": "layer_norm", "keys": 2, "pallas": 0, "jnp": 4, "probes": 0,
                   "degraded_keys": 0, "pallas_ratio": 0.0}
    recs = [r for r in tmon.dispatch_records() if r["op"] == "layer_norm"]
    assert len(recs) == 2 and not any(r["degraded"] for r in recs)
    tmon.reset_counters()
    assert tmon.dispatch_counters() == {}


def test_utils_shims_and_timers():
    from beforeholiday_tpu_torch.utils import profiling, timers

    assert tutils.Timers is timers.Timers is tmon.Timers
    assert profiling.trace is tmon.trace and profiling.span is tmon.span
    t = tmon.Timers(device="cpu")
    t("fwd").start()
    time.sleep(0.01)
    t("fwd").stop()
    assert t("fwd").elapsed(reset=False) >= 0.009
    msg = t.log(["fwd"])
    assert msg.startswith("time (ms) | fwd: ") and t("fwd").elapsed() == 0.0
    with pytest.raises(AssertionError):
        t.log(["never"])


def test_trace_writes_a_profiler_trace(tmp_path):
    with tmon.trace(str(tmp_path)):
        with tmon.span("traced_region"):
            torch.ones(4) @ torch.ones(4)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "traced_region" in names
    with tmon.trace(None):
        pass
