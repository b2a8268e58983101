"""Port parity: ``ElasticTrainer`` (``beforeholiday_tpu_torch/elastic``)
across ranks, in spawned gloo worlds of 4 and 2
(``tests/_torch_elastic_world.py``), against its own uninterrupted runs and
against the JAX package's ``ElasticTrainer`` over host devices.

On the example's model (D 64, 4 layers, 16 rows; ``elastic_training``):

* preemption 4 -> 2, the tripwire (a step whose replicated loss diverges
  on one rank is discarded, 4 -> 2), a hang (``hang_rank`` silences rank
  3's beats while it keeps stepping, 4 -> 2), grow 2 -> 4 (the ranks that
  left rejoin), ``hosts=2`` with a torn host (the restore falls back a
  generation), and the ``min_world`` / ``_validate_resize_target``
  refusals; one multi-fault schedule (preempt, tripwire, grow, torn host,
  hang) in one run;
* every continued trajectory bitwise the same world's uninterrupted run
  resharded from the same generation (a lineage replay on every rank);
* the preemption and grow schedules against JAX's ``ElasticTrainer`` on the
  JAX example's engine: losses and the final arena at JAX's ZeRO bounds
  (rtol 1e-4, atol 1e-5), the same events;
* JAX's generation restored by the port at world 2 bitwise JAX's
  ``reshard_state``, and the port's generation read back by JAX's
  ``zero3.load_shard_files`` and ``ElasticTrainer.restore``, bitwise;
* the event agreement and the snapshot's bytes on the comms ledger.

In a world of 2: guard and scaler state (scale, health, the O6 amax
history) through a reshard to 1, and the 2-layer GPT at amp O5 on
``ZeRO3FusedAdam`` through a preemption 2 -> 1, bitwise its replay. And the
ported example itself at a small size.
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import _torch_elastic_world as ew  # noqa: E402
import _torch_world as tw  # noqa: E402

from beforeholiday_tpu.elastic import ElasticTrainer as JElasticTrainer  # noqa: E402
from beforeholiday_tpu.optimizers import zero3 as jzero3  # noqa: E402
from beforeholiday_tpu.testing import faults as jfaults  # noqa: E402
from beforeholiday_tpu.testing import gpt as jgpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # JAX's own ZeRO bounds


def _jax_example():
    path = os.path.join(ROOT, "examples", "simple", "distributed", "elastic_training.py")
    spec = importlib.util.spec_from_file_location("jax_elastic_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(directory, steps, preemption=None, **kw):
    """JAX's ElasticTrainer on the JAX example's engine over 4 host devices."""
    ex = _jax_example()
    params, layout, opt, make_step = ex.build_engine()
    with JElasticTrainer(opt, layout, make_step, directory=directory,
                         checkpoint_every=2, devices=jax.devices()[:4], **kw) as tr:
        tr.init(params, world=4)
        tr.run(steps, ex.batch_fn, preemption=preemption)
        return dict(losses=[r["loss"] for r in tr.history],
                    events=[(e.reason, e.at_step, e.old_world, e.new_world,
                             e.resumed_from) for e in tr.events],
                    master=np.asarray(tr.state["master"]), world=tr.world)


def _events(rec):
    return [(e["reason"], e["at_step"], e["old_world"], e["new_world"],
             e["resumed_from"]) for e in rec["events"]]


def _arena(results, name):
    """The final arena: the masters of the final world's ranks, in order."""
    return np.concatenate([r[name]["master"] for r in results
                           if r[name]["master"] is not None])


@pytest.fixture(scope="module")
def jax_gen(tmp_path_factory):
    """A JAX-written generation: 6 steps at world 4, generations at 4 and 6."""
    d = str(tmp_path_factory.mktemp("jax_gen"))
    _jax_run(d, 6)
    return d


@pytest.fixture(scope="module")
def drills(tmp_path_factory, jax_gen):
    return tw.run_world(ew.drills_scenario, 4, tmp_path_factory.mktemp("drills"),
                        str(tmp_path_factory.mktemp("drills_out")), jax_gen,
                        timeout=400)


def test_preemption_drill_bitwise_and_against_jax(drills, tmp_path):
    rec = drills[0]["preemption"]
    assert _events(rec) == [("preemption", 7, 4, 2, 6)]
    assert rec["lineage"] == [(0, 4), (6, 2)] and rec["final_world"] == 2
    assert [r["step"] for r in rec["history"] if r["world"] == 2] == [7, 8, 9, 10]
    assert rec["replay"] == [True, True]  # both survivors, bitwise
    assert [r["preemption"]["master"] is None for r in drills] == [False, False, True,
                                                                   True]
    ref = _jax_run(str(tmp_path), 10, jfaults.preempt_after(8, surviving_world=2))
    assert _events(rec) == ref["events"]
    np.testing.assert_allclose([r["loss"] for r in rec["history"]], ref["losses"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_arena(drills, "preemption"), ref["master"],
                               rtol=RTOL, atol=ATOL)


def test_grow_back_bitwise_and_against_jax(drills, tmp_path):
    rec = drills[0]["grow"]
    assert _events(rec) == [("preemption", 2, 4, 2, 2), ("grow", 4, 2, 4, 4)]
    assert rec["final_world"] == 4 and rec["replay"] == [True] * 4
    ref = _jax_run(str(tmp_path), 12, jfaults.preempt_after(3, surviving_world=2),
                   grow_when_available=True, capacity_probe=lambda: 4)
    assert _events(rec) == ref["events"]
    np.testing.assert_allclose([r["loss"] for r in rec["history"]], ref["losses"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_arena(drills, "grow"), ref["master"],
                               rtol=RTOL, atol=ATOL)


def test_tripwire_discards_the_poisoned_step(drills):
    rec = drills[0]["tripwire"]
    assert _events(rec) == [("tripwire", 3, 4, 2, 2)]
    assert {r["world"] for r in rec["history"] if r["step"] == 4} == {2}
    assert rec["replay"] == [True, True]


def test_hang_resizes_the_silent_rank_out(drills):
    rec = drills[0]["hang"]
    (reason, at, old, new, resumed), = _events(rec)
    assert (reason, old, new) == ("hang", 4, 2)
    assert at >= 3 and resumed <= at and resumed % 2 == 0
    assert drills[3]["hang"]["master"] is None  # the silent rank left
    assert rec["replay"] == [True, True]
    assert [e["stall_s"] > 0 for e in rec["events"]] == [True]


def test_torn_host_falls_back_a_generation(drills):
    rec = drills[0]["torn_host"]
    assert drills[0]["torn_host"]["torn_gen"] == 6
    assert _events(rec) == [("preemption", 7, 4, 2, 4)]  # 6 lost host 1
    assert rec["replay"] == [True, True]


def test_refusals(drills):
    out = drills[0]["refusals"]
    assert out["min_world"].startswith("RuntimeError") and "below min_world" in out["min_world"]
    assert "does not divide the device count 4" in out["divide"]
    assert "equals the current world" in out["same"]
    assert "grow_when_available is off" in out["grow_off"]
    assert "call init() or restore() before run()" in out["run_before_init"]
    # ranks beyond a world of 2 came back retired and raised nothing
    assert drills[3]["refusals"]["grow_off"] == "retired"


def test_generations_cross_packages(drills, jax_gen):
    manifest, shards = jzero3.load_shard_files(os.path.join(jax_gen, "gen_00000006"))
    want = jzero3.reshard_state(shards, manifest, 2)
    for r in (0, 1):
        got = drills[r]["jax_restore"]
        assert got["resumed"] == 6
        assert np.array_equal(got["master"], want[r]["master"])
        assert np.array_equal(got["exp_avg_sq"], want[r]["exp_avg_sq"])
    assert drills[2]["jax_restore"]["master"] is None
    written = os.path.join(drills[0]["jax_restore"]["written"], "gen_00000006")
    back_manifest, back = jzero3.load_shard_files(written)
    assert back_manifest["world"] == 2 and back_manifest["step"] == 6
    for r in (0, 1):
        for k in ("master", "exp_avg", "exp_avg_sq", "step"):
            assert np.array_equal(back[r][k], want[r][k]) and back[r][k].dtype == want[r][k].dtype
    ex = _jax_example()
    params, layout, opt, make_step = ex.build_engine()
    with JElasticTrainer(opt, layout, make_step,
                         directory=drills[0]["jax_restore"]["written"],
                         devices=jax.devices()[:4]) as tr:
        assert tr.restore(world=2) == 6
        assert np.array_equal(np.asarray(tr.state["master"]),
                              np.concatenate([w["master"] for w in want]))


def test_agreement_and_snapshot_are_booked(drills):
    rows = drills[0]["comms"]
    events = [r for r in rows if r["site"] == "elastic.events"]
    assert {r["kind"] for r in events} == {"pmax"} and sum(r["calls"] for r in events) >= 10
    snap = [r for r in rows if r["site"] == "ckpt.snapshot"]
    assert {(r["kind"], r["tier"]) for r in snap} == {("d2h", "host")}
    s = drills[0]["ckpt"]
    assert s["generations"] >= 5 and s["bytes"] > 0
    assert {r["phase"] for r in s["phases"]} >= {"submit", "serialize", "write", "wait"}


@pytest.fixture(scope="module")
def multifault(tmp_path_factory):
    return tw.run_world(ew.multifault_scenario, 4, tmp_path_factory.mktemp("mf"),
                        str(tmp_path_factory.mktemp("mf_out")), timeout=400)


def test_multifault_schedule_bitwise(multifault):
    rec = multifault[0]
    ev = _events(rec)
    assert [e[0] for e in ev] == ["preemption", "tripwire", "grow", "preemption", "hang"]
    assert ev[:4] == [("preemption", 2, 4, 2, 2), ("tripwire", 6, 2, 1, 6),
                      ("grow", 8, 1, 4, 8), ("preemption", 13, 4, 2, 10)]
    assert ev[4][2:4] == (2, 1) and ev[4][1] >= 16
    assert rec["torn_gen"] == 12 and rec["final_world"] == 1
    assert rec["replay"] == [True]
    assert max(r["step"] for r in rec["history"]) == 56


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    params = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0),
                                                jgpt.GPTConfig(**ew.GPT)))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, ew.GPT["vocab_size"], (ew.GPT_BATCH, ew.GPT["seq_len"]))
    return tw.run_world(ew.pair_scenario, 2, tmp_path_factory.mktemp("pair"),
                        str(tmp_path_factory.mktemp("pair_out")), params,
                        tok.astype(np.int32), np.roll(tok, -1, -1).astype(np.int32),
                        timeout=300)


def test_guard_state_survives_reshard(pair):
    g = pair[0]["guard"]
    before, after, cont = g["before"], g["after"], g["cont"]
    assert g["resumed"] == 6
    # two halvings from 2**8, two consecutive skips (JAX's test's numbers)
    assert before["loss_scale"] == 2.0**6
    assert before["health"]["consecutive_overflows"] == 2
    assert before["health"]["skipped_total"] == 2
    assert before["health"]["last_skip_reason"] == 1  # SKIP_GRAD_OVERFLOW
    assert np.any(np.asarray(before["amax_history"]) > 0)
    assert after["loss_scale"] == before["loss_scale"]
    assert after["health"] == before["health"]
    np.testing.assert_array_equal(np.asarray(after["amax_history"]),
                                  np.asarray(before["amax_history"]))
    assert cont["loss_scale"] == before["loss_scale"]
    assert cont["health"]["consecutive_overflows"] == 0
    assert cont["health"]["skipped_total"] == 2
    assert pair[1]["guard"]["after"] is None  # rank 1 left at world 1


def test_gpt_o5_elastic_bitwise(pair):
    rec = pair[0]["gpt"]
    assert _events(rec) == [("preemption", 3, 2, 1, 2)]
    assert rec["replay"] == [True]
    losses = [r["loss"] for r in rec["history"]]
    assert all(np.isfinite(losses)) and len(losses) == 7


def test_example_runs_at_small_size(capfd):
    from beforeholiday_tpu_torch.examples.simple.distributed import elastic_training

    res = elastic_training.main(["--device", "cpu", "--world", "2", "--steps", "6",
                                 "--preempt-at-step", "4", "--resume-world", "1"])
    assert res["bitwise_losses"] and res["bitwise_master"]
    assert res["lineage"] == [(0, 2), (2, 1)] and res["final_world"] == 1
    assert [dataclasses.astuple(e) if not isinstance(e, dict) else
            (e["reason"], e["old_world"], e["new_world"], e["resumed_from"])
            for e in res["events"]] == [("preemption", 2, 1, 2)]
    assert "verified: the survived run (final world 1) is bitwise identical" in \
        capfd.readouterr().out
