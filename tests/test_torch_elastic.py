"""Port parity: the elastic building blocks
(``beforeholiday_tpu_torch/elastic``: ``checkpoint``, ``signals``,
``watchdog``; ``testing/faults.py``) against the JAX package's, in one
process. The trainer across ranks is ``tests/test_torch_elastic_world.py``.

* checkpoint atomicity: every file lands through the rename seam with the
  manifest last (the same landing order as JAX's manager); a writer dying
  mid-save leaves the previous generation loadable, and the failure surfaces
  on ``wait`` naming the generation; a torn host demotes its generation;
* the per-rank write (two managers, ranks 0 and 1, writing one generation
  from their own shards): the files bitwise the single writer's, JAX's
  ``load_shard_files`` reads them, host manifests with ``hosts=2``, a
  re-write of a stale generation of the same step;
* ``prune``/``keep``, validation, an idempotent ``close``, ``extra`` with
  tensor and array leaves, and the generation being the state at
  ``submit`` (a later in-place update does not reach it);
* ``PreemptionNotice`` with real signal delivery, its disposition restored,
  and composed with the flight recorder's ``arm_preemption_dump`` in both
  orders (one dump, no re-delivery);
* ``HangWatchdog``: suppressors, a single silent rank, silence across the
  whole world, world 1, the state round trip;
* the fault injectors.

Each against JAX's behaviour on the same inputs: the same ``ckpt_summary``
keys and sides, the same ``list_generations``, the same ``watchdog_records``
rows (rank, last step, timeout).
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from beforeholiday_tpu.elastic import checkpoint as jckpt
from beforeholiday_tpu.elastic import watchdog as jwatchdog
from beforeholiday_tpu.optimizers import zero3 as jzero3
from beforeholiday_tpu.testing import faults as jfaults
from beforeholiday_tpu_torch.elastic import (
    CheckpointManager,
    HangWatchdog,
    PreemptionNotice,
    RankHangError,
    ckpt_summary,
    latest_generation,
    list_generations,
    reset_ckpt_ledger,
    reset_watchdog_ledger,
    watchdog_records,
)
from beforeholiday_tpu_torch.elastic import checkpoint as ckpt
from beforeholiday_tpu_torch.elastic import watchdog as pwatchdog
from beforeholiday_tpu_torch.optimizers import zero3
from beforeholiday_tpu_torch.testing import faults


def _manifest(pkg, world=2, hosts=1):
    layout = pkg.layout_of({"w": np.zeros((8, 8), np.float32)})
    return pkg.shard_manifest(layout, world, hosts=hosts)


def _arena(manifest, seed=0, step=7):
    n = manifest["world"] * manifest["shard_len"]
    rng = np.random.RandomState(seed)
    out = {k: rng.randn(n).astype(np.float32) for k in manifest["state_keys"]}
    out["step"] = np.int32(step)
    return out


def _rank_state(arena, manifest, rank):
    sl = manifest["shard_len"]
    out = {k: torch.from_numpy(arena[k][rank * sl:(rank + 1) * sl].copy())
           for k in manifest["state_keys"]}
    out["step"] = torch.tensor(int(arena["step"]), dtype=torch.int32)
    return out


def _write_both(d, manifest_of, steps, **kw):
    """The same generations through the port's and JAX's managers (single
    writer, numpy state), each into its own directory."""
    for pkg_ckpt, pkg_zero3, sub in ((ckpt, zero3, "port"), (jckpt, jzero3, "jax")):
        m = manifest_of(pkg_zero3)
        with pkg_ckpt.CheckpointManager(os.path.join(d, sub), m, **kw) as mgr:
            for s in steps:
                mgr.submit(s, _arena(m, seed=s))
                mgr.wait()
    return os.path.join(d, "port"), os.path.join(d, "jax")


def _scan(directory, pkg=ckpt):
    return [(s, os.path.basename(p), dur) for s, p, dur in pkg.list_generations(directory)]


# ---- atomicity ----------------------------------------------------------


def test_manifest_lands_last_through_the_rename_seam(tmp_path, monkeypatch):
    landed = {}
    for pkg_ckpt, pkg_zero3, sub in ((ckpt, zero3, "port"), (jckpt, jzero3, "jax")):
        real, rows = pkg_zero3._rename, []

        def recording(src, dst, real=real, rows=rows):
            rows.append(os.path.basename(dst))
            real(src, dst)

        monkeypatch.setattr(pkg_zero3, "_rename", recording)
        m = _manifest(pkg_zero3, world=2)
        with pkg_ckpt.CheckpointManager(str(tmp_path / sub), m) as mgr:
            mgr.submit(3, _arena(m))
            mgr.wait()
        landed[sub] = rows
    assert landed["port"] == landed["jax"] == [
        "shard_00000.npz", "shard_00001.npz", "manifest.json"]
    back, shards = jzero3.load_shard_files(str(tmp_path / "port" / "gen_00000003"))
    np.testing.assert_array_equal(np.concatenate([s["master"] for s in shards]),
                                  _arena(_manifest(zero3))["master"])


def test_torn_save_keeps_previous_generation(tmp_path, monkeypatch):
    m = _manifest(zero3, world=2)
    d = str(tmp_path)
    with CheckpointManager(d, m) as mgr:
        mgr.submit(2, _arena(m, seed=2))
        mgr.wait()
        real, calls = zero3._rename, {"n": 0}

        def dying(src, dst):
            calls["n"] += 1
            if calls["n"] > 1:
                raise RuntimeError("simulated writer death mid-save")
            real(src, dst)

        monkeypatch.setattr(zero3, "_rename", dying)
        mgr.submit(4, _arena(m, seed=4))
        with pytest.raises(RuntimeError, match="gen_00000004") as info:
            mgr.wait()
        assert "writer death" in str(info.value.__cause__)
        monkeypatch.setattr(zero3, "_rename", real)
    assert _scan(d) == _scan(d, jckpt) == [(2, "gen_00000002", True),
                                           (4, "gen_00000004", False)]
    step, path = latest_generation(d)
    assert step == 2 == jckpt.latest_generation(d)[0]
    back, shards = zero3.load_shard_files(path)
    np.testing.assert_array_equal(shards[1]["exp_avg"],
                                  _arena(m, seed=2)["exp_avg"][m["shard_len"]:])


def test_sigkill_mid_save_subprocess(tmp_path):
    """A child process SIGKILLed between two file landings of generation 4
    (no cleanup): generation 2 stays durable and loads."""
    d = str(tmp_path)
    script = f"""
import os, signal
import numpy as np
from beforeholiday_tpu_torch.elastic import CheckpointManager
from beforeholiday_tpu_torch.optimizers import zero3
m = zero3.shard_manifest(zero3.layout_of({{"w": np.zeros((8, 8), np.float32)}}), 2)
n = 2 * m["shard_len"]
def state(tag):
    out = {{k: np.full((n,), tag, np.float32) for k in m["state_keys"]}}
    out["step"] = np.int32(tag)
    return out
with CheckpointManager({d!r}, m) as mgr:
    mgr.submit(2, state(2.0)); mgr.wait()
    real, calls = zero3._rename, {{"n": 0}}
    def killing(src, dst):
        calls["n"] += 1
        if calls["n"] > 1:
            os.kill(os.getpid(), signal.SIGKILL)
        real(src, dst)
    zero3._rename = killing
    mgr.submit(4, state(4.0)); mgr.wait()
"""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert latest_generation(d)[0] == 2
    manifest, back = jzero3.load_shard_files(latest_generation(d)[1])
    assert manifest["step"] == 2 and float(back[1]["master"][0]) == 2.0
    assert _scan(d) == _scan(d, jckpt)


def test_torn_host_demotes_generation(tmp_path):
    dp, dj = _write_both(str(tmp_path), lambda z: _manifest(z, world=4, hosts=2),
                         (2, 5))
    for d in (dp, dj):
        for h in (0, 1):
            assert os.path.isfile(zero3.host_manifest_path(
                ckpt.generation_dir(d, 5), h))
    removed = faults.tear_host_generation(ckpt.generation_dir(dp, 5), 1)
    jfaults.tear_host_generation(jckpt.generation_dir(dj, 5), 1)
    assert not os.path.exists(removed)
    assert _scan(dp) == _scan(dj) == _scan(dp, jckpt) == [
        (2, "gen_00000002", True), (5, "gen_00000005", False)]
    assert latest_generation(dp)[0] == 2
    with pytest.raises(FileNotFoundError, match="torn"):
        zero3.load_shard_files(ckpt.generation_dir(dp, 5))
    with pytest.raises(FileNotFoundError, match="already torn"):
        faults.tear_host_generation(ckpt.generation_dir(dp, 5), 1)
    with pytest.raises(FileNotFoundError, match="single-host"):
        d1, _ = _write_both(str(tmp_path / "one"), lambda z: _manifest(z), (1,))
        faults.tear_host_generation(ckpt.generation_dir(d1, 1), 0)


# ---- the per-rank write ---------------------------------------------------


def _per_rank_generation(d, m, arena, step, token="t0", hosts=None):
    """Ranks 0 and 1 of a world of 2 (two managers, one process) each
    submit their own shard of ``arena`` for ``step``; both wait."""
    mgrs = [CheckpointManager(d, m, rank=r, token=token, hosts=hosts)
            for r in range(m["world"])]
    try:
        for r, mgr in enumerate(mgrs):
            mgr.submit(step, _rank_state(arena, m, r))
        errors = []

        def wait(mgr):
            try:
                mgr.wait()
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=wait, args=(mgr,)) for mgr in mgrs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        return [mgr.last_durable for mgr in mgrs]
    finally:
        for mgr in mgrs:
            mgr.close()


@pytest.mark.parametrize("hosts", [None, 2])
def test_per_rank_write_is_the_single_writers(tmp_path, hosts):
    world = 2
    m = _manifest(zero3, world=world)
    arena = _arena(m, seed=3, step=11)
    single = str(tmp_path / "single")
    with CheckpointManager(single, m, hosts=hosts) as mgr:
        mgr.submit(6, arena)
        mgr.wait()
    ranked = str(tmp_path / "ranked")
    durable = _per_rank_generation(ranked, m, arena, 6, hosts=hosts)
    gen = ckpt.generation_dir(ranked, 6)
    assert durable == [(6, gen)] * world
    assert _scan(ranked) == _scan(single) == [(6, "gen_00000006", True)]
    assert sorted(os.listdir(gen)) == sorted(os.listdir(ckpt.generation_dir(single, 6)))
    a, sa = jzero3.load_shard_files(gen)
    b, sb = jzero3.load_shard_files(ckpt.generation_dir(single, 6))
    assert a == b
    for x, y in zip(sa, sb):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == y[k].dtype
    # a stale generation of the same step, re-written by a new world
    arena2 = _arena(m, seed=4, step=12)
    _per_rank_generation(ranked, m, arena2, 6, token="t1", hosts=hosts)
    _, s2 = zero3.load_shard_files(gen)
    np.testing.assert_array_equal(np.concatenate([s["master"] for s in s2]),
                                  arena2["master"])
    assert not [f for f in os.listdir(gen) if f.startswith(".written")]


def test_per_rank_peer_timeout_names_generation(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "PEER_TIMEOUT_S", 0.2)
    m = _manifest(zero3, world=2)
    with CheckpointManager(str(tmp_path), m, rank=0, token="t") as mgr:
        mgr.submit(3, _rank_state(_arena(m), m, 0))
        with pytest.raises(RuntimeError, match="gen_00000003") as info:
            mgr.wait()
    assert isinstance(info.value.__cause__, TimeoutError)
    assert "shard_00001" not in os.listdir(ckpt.generation_dir(str(tmp_path), 3))
    assert latest_generation(str(tmp_path)) is None


# ---- the manager ------------------------------------------------------------


def test_submit_wait_summary_and_extra(tmp_path):
    reset_ckpt_ledger()
    jckpt.reset_ckpt_ledger()
    m = _manifest(zero3, world=2)
    arena = _arena(m, step=7)
    hist = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    extra = {"guard": {"loss_scale": 256.0, "amax_history": hist,
                       "health": {"skipped_total": np.int64(1)}}}
    state = {k: torch.from_numpy(v.copy()) if k != "step" else torch.tensor(7, dtype=torch.int32)
             for k, v in arena.items()}
    with CheckpointManager(str(tmp_path), m) as mgr:
        gen = mgr.submit(3, state, extra=extra)
        state["master"].add_(1.0)  # in place after submit: not in the generation
        mgr.wait()
        assert mgr.last_durable == (3, gen)
    back, shards = zero3.load_shard_files(gen)
    assert back["step"] == 3
    assert back["extra"]["guard"]["amax_history"] == hist.tolist()
    assert back["extra"]["guard"]["health"] == {"skipped_total": 1}
    np.testing.assert_array_equal(np.concatenate([s["master"] for s in shards]),
                                  arena["master"])
    jm = _manifest(jzero3, world=2)
    with jckpt.CheckpointManager(str(tmp_path / "jax"), jm) as mgr:
        mgr.submit(3, _arena(jm, step=7))
        mgr.wait()
    ours, ref = ckpt_summary(), jckpt.ckpt_summary()
    assert ours.keys() == ref.keys()
    assert [(r["phase"], r["side"], r["calls"]) for r in ours["phases"]] == \
        [(r["phase"], r["side"], r["calls"]) for r in ref["phases"]]
    assert ours["generations"] == ref["generations"] == 1
    assert ours["bytes"] == ref["bytes"]


def test_prune_keeps_last_k_durable(tmp_path):
    dp, dj = _write_both(str(tmp_path), lambda z: _manifest(z), (1, 2, 3, 4), keep=2)
    assert _scan(dp) == _scan(dj) == [(3, "gen_00000003", True),
                                      (4, "gen_00000004", True)]
    torn = ckpt.generation_dir(dp, 9)
    os.makedirs(torn)
    with open(os.path.join(torn, "shard_00000.npz"), "wb") as f:
        f.write(b"torn")
    assert latest_generation(dp)[0] == 4 == jckpt.latest_generation(dp)[0]


def test_writer_error_surfaces_and_close_is_clean(tmp_path):
    m = _manifest(zero3, world=2)
    bad = _arena(m)
    bad["master"] = np.zeros((2 * m["shard_len"] + 3,), np.float32)
    mgr = CheckpointManager(str(tmp_path), m)
    mgr.submit(1, bad)
    with pytest.raises(RuntimeError, match="writer thread failed writing "
                                           "generation gen_00000001"):
        mgr.wait()
    mgr.close()
    mgr.close()
    with pytest.raises(RuntimeError, match="closed"):
        mgr.submit(2, _arena(m))


def test_validation(tmp_path):
    m = _manifest(zero3, world=2)
    shared = [({"queue_depth": 0}, "queue_depth"), ({"keep": 0}, "keep"),
              ({"hosts": 0}, "hosts")]
    for kw, match in shared:
        for mgr_cls, z in ((CheckpointManager, zero3), (jckpt.CheckpointManager, jzero3)):
            with pytest.raises(ValueError, match=match):
                mgr_cls(str(tmp_path), _manifest(z, world=2), **kw)
    for mgr_cls, z in ((CheckpointManager, zero3), (jckpt.CheckpointManager, jzero3)):
        with pytest.raises(ValueError, match="manifest format"):
            mgr_cls(str(tmp_path), {"format": "bogus"})
        with pytest.raises(ValueError, match="divide"):
            mgr_cls(str(tmp_path), _manifest(z, world=4), hosts=3)
    # the per-rank writer's own checks
    with pytest.raises(ValueError, match="rank 2 out of range"):
        CheckpointManager(str(tmp_path), m, rank=2, token="t")
    with pytest.raises(ValueError, match="token"):
        CheckpointManager(str(tmp_path), m, rank=1)


def test_queue_depth_bounds_generations_in_flight(tmp_path, monkeypatch):
    """With the writer held, the third submit at ``queue_depth=2`` waits for
    a free buffer set (booked ``backpressure``)."""
    reset_ckpt_ledger()
    m = _manifest(zero3, world=1)
    gate = threading.Event()
    real = zero3.save_shard_files

    def held(*a, **k):
        gate.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(zero3, "save_shard_files", held)
    with CheckpointManager(str(tmp_path), m, queue_depth=2) as mgr:
        mgr.submit(1, _arena(m, seed=1))
        mgr.submit(2, _arena(m, seed=2))
        done = threading.Event()
        threading.Thread(target=lambda: (mgr.submit(3, _arena(m, seed=3)),
                                         done.set())).start()
        assert not done.wait(0.3)
        gate.set()
        assert done.wait(30)
        mgr.wait()
    phases = {r["phase"]: r["calls"] for r in ckpt_summary()["phases"]}
    assert phases["backpressure"] == 1 and phases["submit"] == 3
    assert [s for s, _, d in list_generations(str(tmp_path)) if d] == [2, 3]


# ---- preemption notices ---------------------------------------------------------


def test_preemption_notice_real_signal():
    prev = signal.getsignal(signal.SIGUSR1)
    with PreemptionNotice() as notice:
        assert notice.drain and notice.signums == (signal.SIGTERM, signal.SIGUSR1)
        notice.tick()  # quiet: nothing raised
        os.kill(os.getpid(), signal.SIGUSR1)
        assert notice.triggered
        with pytest.raises(faults.SimulatedPreemption, match="SIGUSR1") as info:
            notice.tick()
        assert info.value.drain and info.value.surviving_world is None
        assert not notice.triggered
    assert signal.getsignal(signal.SIGUSR1) == prev
    shrink = PreemptionNotice([signal.SIGUSR2], surviving_world=2)
    assert not shrink.drain
    with pytest.raises(ValueError, match="at least one"):
        PreemptionNotice([])


@pytest.mark.parametrize("recorder_last", [False, True])
def test_notice_composes_with_flight_dump(tmp_path, recorder_last):
    from beforeholiday_tpu_torch.monitor.flight import FlightRecorder

    prev = signal.getsignal(signal.SIGUSR1)
    path = str(tmp_path / "flight.json")
    with FlightRecorder(capacity=4, path=path) as rec:
        rec.note_checkpoint(6, "gen_00000006")
        notice = PreemptionNotice([signal.SIGUSR1])
        if recorder_last:
            notice.install()
            rec.arm_preemption_dump(signal.SIGUSR1)
        else:
            rec.arm_preemption_dump(signal.SIGUSR1)
            notice.install()
        os.kill(os.getpid(), signal.SIGUSR1)  # the process survives
        with pytest.raises(faults.SimulatedPreemption):
            notice.tick()
        assert rec.dumps == [path]
        import json

        with open(path) as f:
            dump = json.load(f)
        assert dump["reason"] == "preemption:SIGUSR1"
        assert dump["last_checkpoint"]["generation"] == 6
        rec.disarm_preemption_dump()
        notice.uninstall()
    signal.signal(signal.SIGUSR1, prev)


# ---- the hang watchdog ---------------------------------------------------------


def _drill(mod, faults_mod):
    """One silent rank of three: beats for every rank each 20 ms, rank 1
    suppressed from step 2; returns (the raised error's rank, records)."""
    mod.reset_watchdog_ledger()
    wd = mod.HangWatchdog(3, hang_timeout_s=0.15, poll_interval_s=0.01)
    sup = faults_mod.hang_rank(wd, 1, after_step=2)
    raised = None
    with wd:
        for step in range(1, 60):
            wd.beat_all(step)
            time.sleep(0.02)
            try:
                wd.check()
            except mod.RankHangError as e:
                raised = e
                break
    wd.remove_suppressor(sup)
    return raised, [(r["rank"], r["last_step"], r["timeout_s"])
                    for r in mod.watchdog_records()]


def test_watchdog_single_silent_rank_as_jax():
    ours, rows = _drill(pwatchdog, faults)
    ref, jrows = _drill(jwatchdog, jfaults)
    assert isinstance(ours, RankHangError)
    assert (ours.rank, ours.last_step) == (ref.rank, ref.last_step) == (1, 1)
    assert rows == jrows == [(1, 1, 0.15)]
    assert [(r["rank"], r["last_step"]) for r in watchdog_records()] == [(1, 1)]


def test_watchdog_whole_world_silence_and_world_one():
    reset_watchdog_ledger()
    for world in (3, 1):
        with HangWatchdog(world, hang_timeout_s=0.05, poll_interval_s=0.01) as wd:
            wd.beat_all(1)
            time.sleep(0.2)  # nobody beats: a stalled coordinator, not a hang
            wd.check()
            assert wd.hung_ranks == []
    assert watchdog_records() == []


def test_watchdog_suppressors_state_and_validation():
    wd = HangWatchdog(2, hang_timeout_s=5.0)
    sup = faults.hang_rank(wd, 0, after_step=3)
    assert wd.beat_all(2) == 2 and wd.beat_all(3) == 1
    assert wd.beat(0, 4) is False
    wd.remove_suppressor(sup)
    assert wd.beat(0, 5) is True
    sd = wd.state_dict()
    assert sd == {"world": 2, "last_step": [5, 3], "hang_timeout_s": 5.0}
    jwd = jwatchdog.HangWatchdog(2, hang_timeout_s=5.0)
    jwd.load_state_dict(sd)
    assert jwd.state_dict() == sd
    other = HangWatchdog(4)
    other.load_state_dict(sd)
    # the steps and world load; the timeout stays the watchdog's own, as in JAX
    assert other.world == 2 and other.state_dict()["last_step"] == [5, 3]
    jother = jwatchdog.HangWatchdog(4)
    jother.load_state_dict(sd)
    assert other.state_dict() == jother.state_dict()
    wd.reset(3)
    assert wd.world == 3 and wd.state_dict()["last_step"] == [-1] * 3
    with pytest.raises(ValueError, match="ranks"):
        wd.load_state_dict({"world": 3, "last_step": [1]})
    for bad, match in (((0,), "world"), ((2,), "hang_timeout_s")):
        with pytest.raises(ValueError, match=match):
            HangWatchdog(*bad, **({"hang_timeout_s": 0} if match != "world" else {}))
    with pytest.raises(ValueError, match="out of range"):
        wd.beat(3, 1)
    with pytest.raises(ValueError, match="out of range"):
        faults.hang_rank(wd, 5)
    with pytest.raises(ValueError, match="after_step"):
        faults.hang_rank(wd, 0, after_step=-1)


# ---- fault injectors -------------------------------------------------------


def test_preempt_after_fires_exactly_once():
    tick = faults.preempt_after(3, surviving_world=2)
    tick(), tick()
    with pytest.raises(faults.SimulatedPreemption) as info:
        tick()
    assert info.value.surviving_world == 2 and not info.value.drain
    tick(), tick()
    with pytest.raises(ValueError, match="n_steps"):
        faults.preempt_after(0)


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGTERM])
def test_kill_rank_reaps_signal_death(sig):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    assert faults.kill_rank(proc, sig=sig) == -sig


def test_trainer_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """``ElasticTrainer(device=None)`` raises without a card, before anything
    else; the CPU is used only when asked for."""
    from beforeholiday_tpu_torch.elastic import ElasticTrainer
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layout = zero3.layout_of({"w": torch.zeros(8, 8)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(ZeRO3FusedAdam(), layout, lambda mesh, w: None,
                       directory=str(tmp_path))
    with pytest.raises(RuntimeError, match="torch.distributed is not initialized"):
        ElasticTrainer(ZeRO3FusedAdam(), layout, lambda mesh, w: None,
                       directory=str(tmp_path), device="cpu")
