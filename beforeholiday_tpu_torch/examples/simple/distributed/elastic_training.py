"""Elastic ZeRO-3 training — survive a preemption mid-run, resume smaller.
Counterpart of ``examples/simple/distributed/elastic_training.py``.

``zero3_fully_sharded.py`` ends with the save-and-reshard round trip; this
script wires that mechanism into a LIVE loop via
``beforeholiday_tpu_torch.elastic``:

* an async ``CheckpointManager`` snapshots each rank's shard triplet every
  ``--checkpoint-every`` committed steps — the device-to-host copy runs on
  a side stream behind the step, the atomic writes (temporary file, fsync,
  rename, the manifest stamped last by rank 0) on a background thread, and
  every stall the training thread DOES eat is booked to the ``ckpt``
  ledger;
* at ``--preempt-at-step`` a ``SimulatedPreemption`` fires naming
  ``--resume-world`` survivors: the ranks agree on it, drain in-flight
  generations, reload the last DURABLE one, reshard the arena bitwise onto
  a mesh the survivors carve among themselves, roll ``global_step`` back,
  and replay forward; the other ranks leave the loop;
* ``--grow-back-at-step`` models returned capacity: the survivors grow back
  to the whole world at the next checkpoint boundary, and the ranks that
  left rejoin by restoring at that world;
* the script then proves the headline guarantee: an INDEPENDENT
  uninterrupted run, resharded from the same generation, matches the
  survived run loss by loss and arena-bitwise.

Ranks are processes: gloo on the CPU, or NCCL with one rank a card::

    python -m beforeholiday_tpu_torch.examples.simple.distributed.elastic_training --device cpu --preempt-at-step 8 --resume-world 2
"""

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

D, LAYERS, ROWS = 64, 4, 16  # width, depth, global batch rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=12,
                   help="committed steps to train (replays after the resize "
                        "count toward the same target)")
    p.add_argument("--preempt-at-step", type=int, default=8,
                   help="step attempt on which the simulated preemption notice "
                        "fires (0 = never)")
    p.add_argument("--resume-world", type=int, default=2,
                   help="world size that survives the preemption")
    p.add_argument("--checkpoint-every", type=int, default=2,
                   help="submit an async generation every N committed steps")
    p.add_argument("--grow-back-at-step", type=int, default=0,
                   help="committed step at which the capacity probe reports "
                        "the whole world available again; the survivors grow "
                        "back at the next checkpoint boundary (0 = never)")
    p.add_argument("--world", type=int, default=None,
                   help="ranks (default: 4 on the CPU, every card on the GPU)")
    p.add_argument("--device", default=None,
                   help="cpu for gloo ranks on the CPU; the card by default")
    return p.parse_args(argv)


def build_engine(device):
    """(params, layout, opt, make_step) — the pieces ElasticTrainer wants.

    ``make_step(mesh, world)`` returns ``step(state, gstate, batch) ->
    (state, gstate, row)``; the trainer rebuilds it on every resize, so the
    same factory serves the full and the survivor world. The step takes its
    rank's rows of the global batch."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, zero3

    rng = np.random.RandomState(0)
    params = {f"w{i}": torch.from_numpy((rng.randn(D, D) / np.sqrt(D))
                                        .astype(np.float32)).to(device)
              for i in range(LAYERS)}
    layout = zero3.layout_of(params)
    opt = ZeRO3FusedAdam(lr=1e-2, weight_decay=0.01, prefetch=1,
                         param_residency="keep")

    def make_step(mesh, world):
        rank = mesh.axis_index("data")

        def loss_fn(master, xb):
            p = opt.gather_params(master, layout)
            h = xb
            for i in range(LAYERS):
                h = torch.tanh(h @ p[f"w{i}"])
            return torch.sum(h)

        def step(state, gstate, batch):
            rows = batch.shape[0] // world
            xb = batch[rank * rows:(rank + 1) * rows]
            master = state["master"].detach().requires_grad_(True)
            loss = opt.wrap_residency(loss_fn)(master, xb)
            loss.backward()
            state = opt.step(master.grad, state)  # already this rank's shard
            total = comms.psum(loss.detach(), "data", site="example.loss")
            return state, gstate, {"loss": total}

        return step

    return params, layout, opt, make_step


def batch_fn(device):
    """Global batch keyed on the step — a replay after reload sees identical
    data, which is what keeps the continued trajectory bitwise."""
    def batch(step: int):
        rng = np.random.RandomState(10_000 + int(step))
        return torch.from_numpy(rng.randn(ROWS, D).astype(np.float32)).to(device)

    return batch


def lineage_of(events, world):
    """The final trajectory's lineage ``[(start step, world), ...]``: each
    event rolls back to ``resumed_from`` and replays, erasing any earlier
    segment that started at or past it."""
    lineage = [(0, world)]
    for ev in events:
        if ev.reason == "preemption_drain":
            continue
        r = ev.resumed_from
        lineage = [e for e in lineage if e[0] < r] + [(r, ev.new_world)]
    return lineage


def run(rank, world, store, args, out):
    """One rank: the drill, then the uninterrupted reference; rank 0 writes
    the result."""
    from beforeholiday_tpu_torch.elastic import (
        ElasticTrainer,
        ckpt_summary,
        reset_ckpt_ledger,
    )
    from beforeholiday_tpu_torch.ops._dispatch import resolve_device
    from beforeholiday_tpu_torch.testing.faults import preempt_after

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                device_id=torch.device("cuda", rank))
    else:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
    try:
        params, layout, opt, make_step = build_engine(device)
        batch = batch_fn(device)
        reset_ckpt_ledger()
        preemption = (preempt_after(args.preempt_at_step,
                                    surviving_world=args.resume_world)
                      if args.preempt_at_step else None)
        box = {}

        def capacity_probe():
            # the scheduler: after the preemption only --resume-world ranks
            # exist, until --grow-back-at-step brings the whole world back
            tr = box.get("tr")
            if tr is not None and tr.global_step >= args.grow_back_at_step:
                return world
            return args.resume_world

        grow = bool(args.grow_back_at_step)
        with ElasticTrainer(opt, layout, make_step, directory=f"{out}/live",
                            checkpoint_every=args.checkpoint_every,
                            grow_when_available=grow,
                            capacity_probe=capacity_probe if grow else None,
                            device=device) as tr:
            box["tr"] = tr
            tr.init(params, world=world)
            tr.run(args.steps, batch, preemption=preemption)
            if tr.retired and grow:
                # returned capacity: rejoin the survivors at their grow
                tr.restore(world=world)
                tr.run(args.steps - tr.global_step, batch)
            survived = None if tr.retired else tr.state["master"].cpu().numpy()
            history, events, final_world = tr.history, tr.events, tr.world
        # rank 0 lived through every event: its record is the run's
        record = [history, events, final_world]
        dist.broadcast_object_list(record, src=0)
        history, events, final_world = record
        lineage = lineage_of(events, world)
        final_rows = {}
        for r in history:  # last occurrence wins (replays)
            final_rows[r["step"]] = r
        tail = [final_rows[s] for s in range(lineage[-1][0] + 1, args.steps + 1)]
        result = dict(events=[dataclasses.asdict(ev) for ev in events], lineage=lineage,
                      losses=[r["loss"] for r in tail], final_world=final_world,
                      history=history, ckpt=ckpt_summary())
        if rank == 0:
            for ev in events:
                print(f"resize ({ev.reason}) at step {ev.at_step}: world "
                      f"{ev.old_world} -> {ev.new_world}, resumed from generation "
                      f"{ev.resumed_from}")
            for row in history:
                print(f"  step {row['step']:3d}  world {row['world']}  "
                      f"loss {row['loss']:+.6f}")
            s = result["ckpt"]
            hf = s["hidden_fraction"]
            print(f"ckpt ledger (rank 0): {s['generations']} generation(s), exposed "
                  f"{s['exposed_s'] * 1e3:.1f} ms, background "
                  f"{s['background_s'] * 1e3:.1f} ms"
                  + (f", hidden fraction {hf:.2f}" if hf is not None else ""))
        if len(lineage) > 1:
            # the guarantee: a fault-free reference replaying the same
            # lineage (run to each boundary, checkpoint synchronously,
            # reshard to the segment's world) matches the survived run
            with ElasticTrainer(opt, layout, make_step, directory=f"{out}/ref",
                                checkpoint_every=0, grow_when_available=True,
                                device=device) as ref:
                ref.init(params, world=lineage[0][1])
                ref_rows = []
                for start, w in lineage[1:]:
                    if start > ref.global_step:
                        ref.run(start - ref.global_step, batch)
                    if not ref.retired:
                        ref.checkpoint_now(wait=True)
                    ref.restore(world=w)
                if not ref.retired:
                    ref_rows = ref.run(args.steps - ref.global_step, batch)
                    same_master = bool(np.array_equal(
                        survived, ref.state["master"].cpu().numpy()))
                    same_losses = [r["loss"] for r in ref_rows] == result["losses"]
                else:
                    same_master = same_losses = None
            verdicts = [None] * world
            dist.all_gather_object(verdicts, (same_losses, same_master))
            live = [v for v in verdicts if v[0] is not None]
            result["bitwise_losses"] = all(v[0] for v in live)
            result["bitwise_master"] = all(v[1] for v in live)
            if rank == 0:
                assert result["bitwise_losses"], \
                    "survived trajectory diverged from the uninterrupted reference"
                assert result["bitwise_master"], "survived master arena diverged"
                print(f"verified: the survived run (final world {final_world}) is "
                      "bitwise identical to a fault-free replay of the same lineage")
        if rank == 0:
            torch.save(result, os.path.join(out, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """Runs the world; returns rank 0's result (``events``, ``lineage``,
    ``losses``, ``history``, ``ckpt``, and with a resize
    ``bitwise_losses`` / ``bitwise_master``)."""
    args = parse_args(argv)
    on_cpu = args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    world = args.world or (4 if on_cpu else torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(world, os.path.join(tmp, "store"), args, tmp),
                 nprocs=world, join=True)
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)


if __name__ == "__main__":
    main()
