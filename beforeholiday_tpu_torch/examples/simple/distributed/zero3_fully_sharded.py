"""ZeRO-3 fully sharded training in ~150 lines: the params live only as
shards. Counterpart of ``examples/simple/distributed/zero3_fully_sharded.py``.

Each rank holds 1/world of the flat fp32 master arena (``ZeRO3FusedAdam``)
and materializes the params for each step:

* the forward calls ``gather_params``, a bucketed all-gather of the shard
  (``--prefetch`` bounds the gathers in flight);
* the backward never builds a full gradient: the gather's backward
  reduce-scatters the cotangents straight into this rank's fp32 shard;
* ``--residency regather`` runs the gather again in the backward instead of
  keeping the gathered params alive (FSDP's ``reshard_after_forward``);
* the optimizer state (master and Adam moments) is three shard-sized arrays.

It ends with the sharded checkpoint's round trip: one ``.npz`` a rank and a
layout manifest, then the world's checkpoint resharded to half the world
and the re-sliced arena checked bit for bit.

Run on the CPU as spawned gloo ranks, or on the card over NCCL (one rank a
card)::

    python -m beforeholiday_tpu_torch.examples.simple.distributed.zero3_fully_sharded --device cpu --world 2
    python -m beforeholiday_tpu_torch.examples.simple.distributed.zero3_fully_sharded
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N, D, LAYERS = 32, 256, 8  # per-rank batch, width, depth


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--bucket-bytes", type=int, default=256 * 1024,
                   help="gather/scatter bucket size (one all-gather a bucket "
                        "of the shard)")
    p.add_argument("--prefetch", type=int, default=1,
                   help="how many bucket gathers may run ahead of their "
                        "consumers (0 = the blocking whole-arena gather)")
    p.add_argument("--residency", choices=("regather", "keep"), default="regather",
                   help="regather: run the gather again in the backward instead "
                        "of keeping the gathered params")
    p.add_argument("--device", default=None,
                   help="cpu for gloo ranks on the CPU; the card by default")
    p.add_argument("--world", type=int, default=None,
                   help="ranks (default: 2 on the CPU, every card on the GPU)")
    return p.parse_args(argv)


def run(rank, world, store, args, out):
    """One rank: trains, then (rank 0) checks the resharded checkpoint."""
    from beforeholiday_tpu_torch.ops._dispatch import resolve_device
    from beforeholiday_tpu_torch.optimizers import ZeRO3FusedAdam, zero3

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world, device_id=torch.device("cuda", rank))
    else:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
    try:
        rng = np.random.RandomState(0)
        params = {f"w{i}": torch.from_numpy(
            (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)).to(device)
            for i in range(LAYERS)}
        layout = zero3.layout_of(params)
        x = torch.from_numpy(rng.randn(world * N, D).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.randn(world * N, D).astype(np.float32)).to(device)
        xb, yb = x[rank * N: (rank + 1) * N], y[rank * N: (rank + 1) * N]

        opt = ZeRO3FusedAdam(lr=1e-3, weight_decay=0.01,
                             bucket_bytes=args.bucket_bytes, prefetch=args.prefetch,
                             param_residency=args.residency)

        def apply(p, h):
            for i in range(LAYERS):
                h = torch.tanh(h @ p[f"w{i}"])
            return h

        def loss_fn(master_shard):
            p = opt.gather_params(master_shard, layout)
            return torch.mean((apply(p, xb) - yb) ** 2)

        # under "regather" the gathered params are not saved: the backward
        # gathers again instead of holding a second model-sized copy
        loss_fn = opt.wrap_residency(loss_fn)
        state = opt.init(params)
        shard = state["master"].shape[0]
        if rank == 0:
            print(f"world={world}  arena={layout.spec.padded_total}  "
                  f"shard={shard}  per-rank state bytes={3 * shard * 4}")
        for _ in range(args.steps):
            master = state["master"].detach().requires_grad_(True)
            loss = loss_fn(master)
            loss.backward()
            state = opt.step(master.grad, state)  # already this rank's shard
        total = loss.detach().reshape(1).clone()
        dist.all_reduce(total)
        final = float(total) / world

        # ---- sharded checkpoint and a restore at another world size -------
        local = opt.state_dict(layout, state, gather_on_root=False)
        stacked = {}
        for key in ("master", "exp_avg", "exp_avg_sq"):
            g = torch.empty(world * shard, device=device)
            dist.all_gather_into_tensor(g, local[key])
            stacked[key] = g.cpu().numpy().reshape(world, shard)
        stacked["step"] = local["step"].cpu().numpy()
        result = dict(loss=final, shard=shard)
        if rank == 0:
            print("final loss =", final)
            manifest = zero3.shard_manifest(layout, world)
            with tempfile.TemporaryDirectory() as ckpt:
                zero3.save_shard_files(ckpt, zero3.shards_from_stacked(stacked, world),
                                       manifest)
                mf, shards = zero3.load_shard_files(ckpt)
                new_world = max(world // 2, 1)
                resharded = zero3.reshard_state(shards, mf, new_world)
                for key in mf["state_keys"]:
                    orig = stacked[key].reshape(-1)[: mf["arena_len"]]
                    back = np.concatenate([r[key] for r in resharded])[: mf["arena_len"]]
                    assert np.array_equal(orig, back), key
            print(f"saved {world} shards, resharded to {new_world}: the arena "
                  "round-trips bitwise")
            result["resharded_to"] = new_world
        if out is not None:
            torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """Runs the world; returns rank 0's result (``loss``, ``shard``,
    ``resharded_to``)."""
    args = parse_args(argv)
    on_cpu = args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    world = args.world or (2 if on_cpu else torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        mp.spawn(run, args=(world, store, args, tmp), nprocs=world, join=True)
        return torch.load(os.path.join(tmp, "rank0.pt"))


if __name__ == "__main__":
    main()
