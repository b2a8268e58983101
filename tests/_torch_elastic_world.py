"""Rank scenarios for ``tests/test_torch_elastic_world.py``: the port's
``ElasticTrainer`` in spawned gloo worlds (``_torch_world.run_world``).

Each scenario runs on every rank and returns plain values: the events, the
history, this rank's final master shard, and, for each drill, whether its
continued trajectory is bitwise an uninterrupted run resharded from the
same generation (the lineage replay of :func:`_replay`). The children load
torch and the port only, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

D, LAYERS, ROWS = 64, 4, 16  # the example's model
GPT = dict(vocab_size=128, seq_len=32, d_model=64, n_heads=4, n_layers=2)
GPT_BATCH, GPT_LR = 4, 1e-3


def _engine(trip_at=None, trip_calls=None):
    """The example's engine; with ``trip_at`` the ``trip_at``-th step
    attempt corrupts the replicated loss on rank 0 only, which
    ``check_replicated_consistency`` flags (the tripwire)."""
    from beforeholiday_tpu_torch.examples.simple.distributed import elastic_training as ex

    params, layout, opt, make_step = ex.build_engine("cpu")
    if trip_at is None:
        return params, layout, opt, make_step
    from beforeholiday_tpu_torch.parallel import check_replicated_consistency

    def make_tripped(mesh, world):
        inner = make_step(mesh, world)

        def step(state, gstate, batch):
            trip_calls["n"] += 1
            state, gstate, row = inner(state, gstate, batch)
            seen = row["loss"]
            if trip_calls["n"] == trip_at and mesh.axis_index("data") == 0:
                seen = seen + 1.0
            row["mismatch"] = check_replicated_consistency(
                {"loss": seen}, "data", site="elastic.tripwire")
            return state, gstate, row

        return step

    return params, layout, opt, make_tripped


def _batch():
    from beforeholiday_tpu_torch.examples.simple.distributed import elastic_training as ex

    return ex.batch_fn("cpu")


def _trainer(opt, layout, make_step, directory, **kw):
    from beforeholiday_tpu_torch.elastic import ElasticTrainer

    return ElasticTrainer(opt, layout, make_step, directory=directory, device="cpu", **kw)


def _master(tr):
    return None if tr.retired else tr.state["master"].numpy().copy()


def _record(rank, tr):
    """Rank 0's history and events, the same on every rank."""
    rec = [tr.history, [dataclasses.asdict(e) for e in tr.events], tr.world]
    dist.broadcast_object_list(rec, src=0)
    return {"history": rec[0], "events": rec[1], "final_world": rec[2]}


def _lineage(events, world):
    lineage = [(0, world)]
    for ev in events:
        if ev["reason"] == "preemption_drain":
            continue
        r = ev["resumed_from"]
        lineage = [e for e in lineage if e[0] < r] + [(r, ev["new_world"])]
    return lineage


def _replay(engine, directory, lineage, steps, master, losses, batch):
    """A fault-free reference over the same lineage (run to each boundary,
    checkpoint synchronously, reshard to the segment's world) on every
    process; True where it matches ``losses`` and this rank's ``master``
    bitwise (None on a rank outside the final world)."""
    params, layout, opt, make_step = engine
    with _trainer(opt, layout, make_step, directory, checkpoint_every=0,
                  grow_when_available=True) as ref:
        ref.init(params, world=lineage[0][1])
        for start, w in lineage[1:]:
            if start > ref.global_step:
                ref.run(start - ref.global_step, batch)
            if not ref.retired:
                ref.checkpoint_now(wait=True)
            ref.restore(world=w)
        rows = ref.run(steps - ref.global_step, batch)
        if ref.retired:
            verdict = None
        else:
            verdict = bool([r["loss"] for r in rows] == losses
                           and np.array_equal(master, ref.state["master"].numpy()))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, verdict)
    return [v for v in out if v is not None]


def _tail(record, steps):
    lineage = _lineage(record["events"], 4)
    rows = {}
    for r in record["history"]:
        rows[r["step"]] = r
    return lineage, [rows[s]["loss"] for s in range(lineage[-1][0] + 1, steps + 1)]


def _drill(rank, base, name, steps, world=4, rejoin=None, tear=None,
           capacity=None, **kw):
    """One drill on the example's model and its lineage replay. ``rejoin``:
    the world a retired rank rejoins once (a grow); ``tear``: ``(step,
    host)``, at ``batch_fn(step)`` every rank drains and rank 0 takes that
    host's manifest from the newest generation; ``capacity``: ``(start,
    stop, ranks)``, the capacity probe's answer for steps in ``[start,
    stop)`` (outside it, the current world)."""
    from beforeholiday_tpu_torch.elastic import latest_generation
    from beforeholiday_tpu_torch.testing import faults

    d = os.path.join(base, name)
    preemption = kw.pop("preemption", None)
    trip_at = kw.pop("trip_at", None)
    hang = kw.pop("hang", None)
    engine = _engine(trip_at, {"n": 0})
    params, layout, opt, make_step = engine
    plain = _batch()
    box = {}

    def batch(step):
        if hang is not None:
            time.sleep(0.03)  # wall-clock for the watchdog to see silence
        if tear is not None and step == tear[0] and not box.get("torn"):
            box["torn"] = True
            box["tr"]._manager.wait()
            if rank == 0:
                gen = latest_generation(f"{d}/live")[1]
                faults.tear_host_generation(gen, tear[1])
                box["torn_gen"] = int(os.path.basename(gen)[4:])
        return plain(step)

    if hang is not None:
        from beforeholiday_tpu_torch.elastic import HangWatchdog

        wd = HangWatchdog(world, hang_timeout_s=0.25, poll_interval_s=0.02)
        faults.hang_rank(wd, hang[0], after_step=hang[1])
        kw["watchdog"] = wd.start()
    if capacity is not None:
        kw["grow_when_available"] = True
        kw["capacity_probe"] = lambda: (
            capacity[2] if capacity[0] <= box["tr"].global_step < capacity[1]
            else box["tr"].world)
    with _trainer(opt, layout, make_step, f"{d}/live", **kw) as tr:
        box["tr"] = tr
        tr.init(params, world=world)
        tr.run(steps, batch, preemption=preemption)
        if tr.retired and rejoin is not None:
            tr.restore(world=rejoin)
            tr.run(steps - tr.global_step, batch)
        master = _master(tr)
    if hang is not None:
        kw["watchdog"].stop()
    rec = _record(rank, tr)
    lineage, losses = _tail(rec, steps)
    rec["lineage"] = lineage
    rec["replay"] = _replay(_engine(), f"{d}/ref", lineage, steps, master, losses,
                            plain)
    rec["master"] = master
    rec["torn_gen"] = box.get("torn_gen")
    return rec


def _refusals(rank, base):
    """Resize targets the trainer refuses, each in a fresh trainer: below
    ``min_world``, not dividing the rank count, the current world, and a
    grow with ``grow_when_available`` off."""
    from beforeholiday_tpu_torch.testing import faults

    out = {}
    cases = {"min_world": (dict(min_world=4), 4, faults.preempt_after(2, surviving_world=2)),
             "divide": ({}, 4, faults.preempt_after(2, surviving_world=3)),
             "same": ({}, 4, faults.preempt_after(2, surviving_world=4)),
             "grow_off": ({}, 2, faults.preempt_after(2, surviving_world=4))}
    for name, (kw, world, tick) in cases.items():
        params, layout, opt, make_step = _engine()
        with _trainer(opt, layout, make_step, os.path.join(base, f"refuse_{name}"),
                      checkpoint_every=1, **kw) as tr:
            tr.init(params, world=world)
            try:
                tr.run(4, _batch(), preemption=tick)
                out[name] = None if not tr.retired else "retired"
            except (RuntimeError, ValueError) as e:
                out[name] = f"{type(e).__name__}: {e}"
    params, layout, opt, make_step = _engine()
    with _trainer(opt, layout, make_step, os.path.join(base, "norun")) as tr:
        try:
            tr.run(1, _batch())
        except RuntimeError as e:
            out["run_before_init"] = str(e)
    return out


def drills_scenario(rank, world, base, jax_dir):
    """The drills of a world of 4 (see the test module's docstring)."""
    from beforeholiday_tpu_torch.elastic import ckpt_summary, reset_ckpt_ledger
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.testing import faults

    out = {}
    comms.reset_comms_ledger()
    reset_ckpt_ledger()
    out["preemption"] = _drill(rank, base, "preemption", 10, checkpoint_every=2,
                               preemption=faults.preempt_after(8, surviving_world=2))
    out["ckpt"] = ckpt_summary()
    out["comms"] = [r for r in comms.comms_records()
                    if r["site"] in ("elastic.events", "ckpt.snapshot")]
    out["tripwire"] = _drill(rank, base, "tripwire", 6, checkpoint_every=2, trip_at=4)
    out["hang"] = _drill(rank, base, "hang", 40, checkpoint_every=2, hang=(3, 3))
    out["grow"] = _drill(rank, base, "grow", 12, checkpoint_every=2, rejoin=4,
                         preemption=faults.preempt_after(3, surviving_world=2),
                         capacity=(0, 100, 4))
    out["torn_host"] = _drill(rank, base, "torn_host", 10, checkpoint_every=2, keep=3,
                              hosts=2, tear=(6, 1),
                              preemption=faults.preempt_after(8, surviving_world=2))
    out["refusals"] = _refusals(rank, base)
    out["jax_restore"] = _jax_generation(rank, base, jax_dir)
    return out


def _jax_generation(rank, base, jax_dir):
    """The JAX package's newest generation in ``jax_dir`` restored at world
    2 (this rank's shard), then written back at world 2 by the port."""
    params, layout, opt, make_step = _engine()
    with _trainer(opt, layout, make_step, os.path.join(base, "from_jax")) as tr:
        tr.init(params, world=4)
        resumed = tr.restore(world=2, directory=jax_dir)
        shard = _master(tr)
        moments = None if tr.retired else tr.state["exp_avg_sq"].numpy().copy()
        if not tr.retired:
            tr.checkpoint_now(wait=True)
    return {"resumed": resumed, "master": shard, "exp_avg_sq": moments,
            "written": os.path.join(base, "from_jax")}


def multifault_scenario(rank, world, base):
    """Preemption, tripwire, grow, a torn host under a preemption, and a
    hang, in one run of a world of 4, bitwise its lineage replay.

    Ticks (one a loop iteration): the preemption 4 -> 2 on tick 3 (from
    generation 2); the tripwire on the 7th step call (2 -> 1, from 6); the
    grow 1 -> 4 at step 8's boundary (ranks 1-3 rejoin); at the batch for
    step 13 generation 12 loses host 1, so the preemption on tick 16 (4 ->
    2) falls back to generation 10; rank 1 goes silent from step 16 (2 ->
    1). The capacity probe offers 4 ranks for steps 8 and 9 only."""
    from beforeholiday_tpu_torch.testing import faults

    ticks = {"n": 0}

    def preemption():
        ticks["n"] += 1
        if ticks["n"] in (3, 16):
            raise faults.SimulatedPreemption("drill", surviving_world=2)

    return _drill(rank, base, "multifault", 56, checkpoint_every=2, keep=4, hosts=2,
                  trip_at=7, hang=(1, 16), tear=(12, 1), preemption=preemption,
                  capacity=(8, 10, 4), rejoin=4 if rank else None)


def guard_scenario(rank, world, base):
    """Scale, health and the O6 amax history through a reshard (world 2 ->
    1): two overflowing steps, a synchronous generation, the restore."""
    from beforeholiday_tpu_torch.amp.scaler import LossScaler
    from beforeholiday_tpu_torch.guard import StepGuard
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.ops.quantized import amax_of_tree

    params, layout, opt, _ = _engine()
    guard = StepGuard(LossScaler(init_scale=2.0**8, quantized=True, amax_history_len=4),
                      check_params=True)

    def make_step(mesh, w):
        r = mesh.axis_index("data")

        def step(state, gstate, batch):
            x, poison = batch
            xb = x[r * (ROWS // w):(r + 1) * (ROWS // w)]
            master = state["master"].detach().requires_grad_(True)

            def loss_fn(m):
                p = opt.gather_params(m, layout)
                h = xb
                for k in sorted(p):
                    h = torch.tanh(h @ p[k])
                return torch.sum(h)

            local = loss_fn(master)
            local.backward()
            g = master.grad + (float("nan") if poison else 0.0)
            verdict = guard.check_grads(local, g)
            verdict["amax"] = (comms.pmax(amax_of_tree(state["master"]), "data",
                                          site="t.amax"),
                               comms.pmax(amax_of_tree(g), "data", site="t.amax"))
            verdict["grad_overflow"] = comms.pmax(
                verdict["grad_overflow"].to(torch.int32), "data", site="t.flag") > 0
            state, gstate = guard.apply_sharded_update(opt, state, g, gstate, verdict)
            return state, gstate, {"loss": comms.psum(local.detach(), "data",
                                                      site="t.loss")}

        return step

    plain = _batch()

    def batch(step):
        return plain(step), step in (4, 5)

    d = os.path.join(base, "guard")
    with _trainer(opt, layout, make_step, d, guard=guard, checkpoint_every=0) as tr:
        tr.init(params, world=2)
        tr.run(6, batch)
        before = guard.state_dict(tr.gstate)
        tr.checkpoint_now(wait=True)
    with _trainer(opt, layout, make_step, d, guard=guard, checkpoint_every=0) as tr1:
        resumed = tr1.restore(world=1)
        after = None if tr1.retired else guard.state_dict(tr1.gstate)
        tr1.run(1, batch)
        cont = None if tr1.retired else guard.state_dict(tr1.gstate)
    return {"before": before, "after": after, "cont": cont, "resumed": resumed}


def gpt_scenario(rank, world, base, np_params, tokens, targets):
    """The 2-layer GPT at amp O5 on ``ZeRO3FusedAdam`` under the elastic
    loop at world 2: a preemption to world 1 on tick 4, bitwise its lineage
    replay."""
    from beforeholiday_tpu_torch import amp
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, zero3
    from beforeholiday_tpu_torch.testing import faults, gpt

    cfg = gpt.GPTConfig(**GPT, dtype=torch.bfloat16)
    params = gpt.params_from_numpy(np_params, device="cpu")
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params, None, "O5")
    cast = m.params
    layout = zero3.layout_of(cast)
    opt = ZeRO3FusedAdam(lr=GPT_LR, prefetch=1, param_residency="keep")

    def make_step(mesh, w):
        from beforeholiday_tpu_torch.monitor import comms

        r = mesh.axis_index("data")
        b = tokens.shape[0] // w

        def loss_fn(master, tok, tgt):
            p = opt.gather_params(master, layout)
            p = {**p, "blocks": {k: v.unbind(0) for k, v in p["blocks"].items()}}
            return gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply)

        def step(state, gstate, batch):
            tok, tgt = batch
            master = state["master"].detach().requires_grad_(True)
            loss = loss_fn(master, tok[r * b:(r + 1) * b], tgt[r * b:(r + 1) * b])
            loss.backward()
            state = opt.step(master.grad, state)
            total = comms.psum(loss.detach(), "data", site="t.loss") / w
            return state, gstate, {"loss": total}

        return step

    tok, tgt = torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()

    def batch(step):
        shift = step % tokens.shape[0]
        return torch.roll(tok, shift, 0), torch.roll(tgt, shift, 0)

    engine = (cast, layout, opt, make_step)
    d = os.path.join(base, "gpt")
    with _trainer(opt, layout, make_step, f"{d}/live", checkpoint_every=2) as tr:
        tr.init(cast, world=2)
        tr.run(6, batch, preemption=faults.preempt_after(4, surviving_world=1))
        master = _master(tr)
    rec = _record(rank, tr)
    lineage = _lineage(rec["events"], 2)
    rows = {r["step"]: r for r in rec["history"]}
    losses = [rows[s]["loss"] for s in range(lineage[-1][0] + 1, 7)]
    rec["lineage"] = lineage
    rec["replay"] = _replay(engine, f"{d}/ref", lineage, 6, master, losses, batch)
    return rec


def pair_scenario(rank, world, base, np_params, tokens, targets):
    """:func:`guard_scenario` and :func:`gpt_scenario` in one world of 2."""
    return {"guard": guard_scenario(rank, world, base),
            "gpt": gpt_scenario(rank, world, base, np_params, tokens, targets)}
