"""Expert-parallel Mixture-of-Experts GPT on the ``make_moe_mesh`` carve —
counterpart of ``examples/simple/distributed/moe_gpt.py``.

A small GPT with every second block's MLP replaced by a GShard/Switch MoE
layer (``GPTConfig(moe_every=2)``), trained data-parallel x expert-parallel:
each rank is one (data, expert) coordinate of the carve and routes its own
token group; the stacked expert tree is sharded along its expert dim over
the ``expert`` group, and the dispatch and combine exchanges go through the
ledgered, differentiable ``all_to_all``. The router's scalars (load-balance
loss, z-loss, capacity-drop fraction) ride ``TrainMonitor``'s packed vector,
read on the host only at the logging steps.

The gradient reduction gives the gradient of the mean of every group's
loss. A replicated leaf's gradient on a rank is its own group's, so it is
averaged over the (data, expert) group. An expert shard's gradient on a rank
already sums the contributions of the ``ep`` groups of its data row (the
combine's backward brings their cotangents home to the expert), so it is
averaged over ``data`` only and divided by ``ep``. (The JAX example averages
every leaf over (data, expert), which gives the experts of different expert
ranks one another's updates.)

Ranks are processes: gloo on the CPU, or on one card (NCCL cannot put two
ranks on one GPU), NCCL with one rank a card when there are enough cards::

    python -m beforeholiday_tpu_torch.examples.simple.distributed.moe_gpt --device cpu
    python -m beforeholiday_tpu_torch.examples.simple.distributed.moe_gpt --expert-parallel 2

Knobs as the JAX example's: ``--experts``, ``--top-k``, ``--capacity-factor``,
``--expert-parallel`` (the rest of ``--world`` is data parallel), ``--steps``
and ``--batch`` (sequences a routing group).
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the JAX example's model
EXAMPLE_MODEL = dict(vocab_size=256, seq_len=64, d_model=64, n_heads=4, n_layers=4,
                     use_flash_attention=False, moe_every=2)
LR = 3e-4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experts", type=int, default=4)
    p.add_argument("--top-k", type=int, default=2, choices=(1, 2))
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--expert-parallel", type=int, default=4,
                   help="ranks on the expert axis (must divide both --world "
                        "and --experts)")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=4,
                   help="sequences per routing group (per mesh coordinate)")
    p.add_argument("--world", type=int, default=4, help="ranks")
    p.add_argument("--device", default=None,
                   help="cpu for gloo ranks on the CPU; the card by default")
    return p.parse_args(argv)


def spec_from_args(args) -> dict:
    """What :func:`train` takes: the model, the carve and the run."""
    if args.world % args.expert_parallel:
        raise ValueError(f"--expert-parallel {args.expert_parallel} must divide "
                         f"--world {args.world}")
    return dict(model=dict(EXAMPLE_MODEL, moe_experts=args.experts,
                           moe_top_k=args.top_k,
                           moe_capacity_factor=args.capacity_factor),
                dp=args.world // args.expert_parallel, ep=args.expert_parallel,
                steps=args.steps, batch=args.batch, lr=LR, log_every=20,
                device=args.device)


def model_config(spec, expert_axis=None):
    from beforeholiday_tpu_torch.testing import gpt

    return gpt.GPTConfig(**spec["model"], moe_expert_axis=expert_axis)


def initial_params(spec, device):
    """The model's fp32 parameters: ``spec["params"]`` (numpy, e.g. the JAX
    package's) when given, else drawn from seed 0."""
    from beforeholiday_tpu_torch.testing import gpt

    if spec.get("params") is not None:
        return gpt.params_from_numpy(spec["params"], device=device)
    return gpt.init(model_config(spec), torch.Generator().manual_seed(0),
                    device=device)


def batches(spec, device):
    """One fixed batch of ``dp * ep * batch`` sequences, memorized: the loss
    falling shows the sharded experts and the replicated router both train.
    ``spec["tokens"]`` (numpy) when given, else drawn from seed 1."""
    from beforeholiday_tpu_torch.testing import gpt

    if spec.get("tokens") is not None:
        tok = torch.from_numpy(np.array(spec["tokens"])).long().to(device)
        return tok, torch.roll(tok, -1, dims=-1)
    return gpt.synthetic_batch(model_config(spec), spec["dp"] * spec["ep"] * spec["batch"],
                               generator=torch.Generator().manual_seed(1),
                               device=device)


def expert_shard(params, ep, e_rank):
    """``params`` with the stacked experts ``(G, E, ...)`` cut to expert
    rank ``e_rank``'s ``E / ep`` experts."""
    experts = params["moe"]["experts"]
    n = next(iter(experts.values())).shape[1] // ep
    cut = {k: v[:, e_rank * n:(e_rank + 1) * n].clone() for k, v in experts.items()}
    return {**params, "moe": {**params["moe"], "experts": cut}}


def reduce_gradients(grads, group_axes):
    """The mean of every group's loss: replicated leaves averaged over the
    (data, expert) group; the expert shard averaged over ``data`` (when the
    carve has one) and divided by ``ep``."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_paths, tree_unflatten
    from beforeholiday_tpu_torch.parallel.bucketing import static_axis_size
    from beforeholiday_tpu_torch.parallel.parallel_state import DATA_AXIS

    leaves, treedef = tree_flatten(grads)
    is_expert = ["experts" in path for path in tree_paths(grads)]
    rep = [g for g, e in zip(leaves, is_expert) if not e]
    exp = [g for g, e in zip(leaves, is_expert) if e]
    groups = static_axis_size(group_axes)
    rep = [g / groups for g in comms.psum(rep, group_axes, site="moe_gpt.grads")]
    if DATA_AXIS in group_axes:
        exp = comms.psum(exp, DATA_AXIS, site="moe_gpt.expert_grads")
    # a sum over dp ranks of sums over ep groups: / (dp * ep)
    exp = [g / groups for g in exp]
    it_rep, it_exp = iter(rep), iter(exp)
    return tree_unflatten(treedef, [next(it_exp) if e else next(it_rep)
                                    for e in is_expert])


def train(spec):
    """One rank's run in an initialized ``torch.distributed`` world of
    ``dp * ep`` ranks: carve the mesh, shard the experts, take
    ``spec["steps"]`` steps. Returns this rank's losses, its reduced
    gradients of the first step and its final parameters (numpy; the expert
    shard its own), the metrics of the logged steps and the ``moe``
    subsystem's ledger rows."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.monitor.metrics import TrainMonitor
    from beforeholiday_tpu_torch.ops._dispatch import resolve_device
    from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_unflatten
    from beforeholiday_tpu_torch.optimizers import FusedAdam
    from beforeholiday_tpu_torch.parallel.parallel_state import (
        DATA_AXIS,
        EXPERT_AXIS,
        make_moe_mesh,
    )
    from beforeholiday_tpu_torch.testing import gpt

    device = resolve_device(spec["device"])
    dp, ep = spec["dp"], spec["ep"]
    mesh = make_moe_mesh(data=dp, expert=ep)
    try:
        with mesh:
            group_axes = tuple(a for a in (DATA_AXIS, EXPERT_AXIS)
                               if a in mesh.axis_names)
            expert_axis = EXPERT_AXIS if EXPERT_AXIS in mesh.axis_names else None
            cfg = model_config(spec, expert_axis)
            g_rank = mesh.axis_index(group_axes)
            e_rank = mesh.axis_index(EXPERT_AXIS) if expert_axis else 0
            params = expert_shard(initial_params(spec, device), ep, e_rank)
            tok, tgt = batches(spec, device)
            b = spec["batch"]
            tok, tgt = tok[g_rank * b:(g_rank + 1) * b], tgt[g_rank * b:(g_rank + 1) * b]
            opt = FusedAdam(lr=spec["lr"])
            state = opt.init(params)
            mon = TrainMonitor()
            comms.reset_comms_ledger()
            losses, logged, first_grads = [], [], None
            for t in range(spec["steps"]):
                leaves, treedef = tree_flatten(params)
                leaves = [x.detach().requires_grad_(True) for x in leaves]
                loss, aux = gpt.loss_and_aux(tree_unflatten(treedef, leaves), tok, tgt, cfg)
                loss.backward()
                grads = reduce_gradients(tree_unflatten(treedef, [x.grad for x in leaves]),
                                         group_axes)
                if t == 0:
                    first_grads = [x.cpu().numpy().copy() for x in tree_flatten(grads)[0]]
                params, state = opt.step(tree_unflatten(treedef, [x.detach() for x in leaves]),
                                         grads, state)
                losses.append(loss.detach())
                if t % spec["log_every"] == 0 or t == spec["steps"] - 1:
                    m = mon.update(mon.init(device=device), loss=loss.detach(),
                                   moe={k: v.detach() for k, v in aux.items()})
                    logged.append((t, mon.unpack_host(mon.pack(m).cpu())))
            ledger = [r for r in comms.comms_records() if r["site"].startswith("moe.")]
            return dict(losses=[float(x) for x in torch.stack(losses).cpu()],
                        first_grads=first_grads,
                        params=[x.cpu().numpy() for x in tree_flatten(params)[0]],
                        metrics=logged, ledger=ledger, group=g_rank, expert_rank=e_rank)
    finally:
        mesh.destroy()


def reference_steps(spec):
    """The one-process reference: every group's loss with all experts local
    (``moe_expert_axis=None``), averaged over the groups, one backward, the
    same Adam. Returns the mean losses, the first step's gradients and the
    final parameters (numpy, the whole expert stack)."""
    from beforeholiday_tpu_torch.ops._dispatch import resolve_device
    from beforeholiday_tpu_torch.ops.arena import tree_flatten, tree_unflatten
    from beforeholiday_tpu_torch.optimizers import FusedAdam
    from beforeholiday_tpu_torch.testing import gpt

    device = resolve_device(spec["device"])
    cfg = model_config(spec)
    params = initial_params(spec, device)
    tok, tgt = batches(spec, device)
    groups, b = spec["dp"] * spec["ep"], spec["batch"]
    opt = FusedAdam(lr=spec["lr"])
    state = opt.init(params)
    losses, first_grads = [], None
    for t in range(spec["steps"]):
        leaves, treedef = tree_flatten(params)
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        p = tree_unflatten(treedef, leaves)
        loss = sum(gpt.loss_and_aux(p, tok[g * b:(g + 1) * b], tgt[g * b:(g + 1) * b],
                                    cfg)[0] for g in range(groups)) / groups
        loss.backward()
        if t == 0:
            first_grads = [x.grad.cpu().numpy().copy() for x in leaves]
        params, state = opt.step(tree_unflatten(treedef, [x.detach() for x in leaves]),
                                 tree_unflatten(treedef, [x.grad for x in leaves]), state)
        losses.append(loss.detach())
    return dict(losses=[float(x) for x in torch.stack(losses).cpu()],
                first_grads=first_grads,
                params=[x.cpu().numpy() for x in tree_flatten(params)[0]])


def run_rank(rank, world, store, spec, out):
    """A spawned rank: join the world (gloo, or NCCL with a card a rank),
    :func:`train`, print rank 0's log, save the result under ``out``."""
    if spec.get("backend") == "nccl":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=world, device_id=torch.device("cuda", rank))
    else:
        if spec["device"] != "cpu":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
    try:
        res = train(spec)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for t, m in res["metrics"]:
            print(f"step {t:3d}  loss {m['loss']:.4f}  aux {m['moe_aux_loss']:.4f}  "
                  f"z {m['moe_z_loss']:.4f}  drop {m['moe_drop_fraction']:.3f}")
        calls = sum(r["calls"] for r in res["ledger"])
        nbytes = sum(r["bytes"] for r in res["ledger"])
        sites = sorted({r["site"] for r in res["ledger"]})
        print(f"moe a2a traffic: {calls} calls, {nbytes} bytes over {len(sites)} "
              f"sites ({', '.join(sites)})")
    if out is not None:
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def main(argv=None):
    """Runs the world; returns every rank's result (see :func:`train`)."""
    args = parse_args(argv)
    spec = spec_from_args(args)
    world = args.world
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu")
        spec["backend"] = "nccl" if torch.cuda.device_count() >= world else "gloo"
        spec["device"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run_rank, args=(world, os.path.join(tmp, "store"), spec, tmp),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


if __name__ == "__main__":
    main()
