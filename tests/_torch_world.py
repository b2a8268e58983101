"""Spawned ``torch.distributed`` worlds for the port's CPU parity tests.

:func:`run_world` starts ``world`` processes, joins them into a gloo world
through a ``FileStore`` in the test's ``tmp_path`` (no TCP port, so xdist
workers never collide), runs one of this module's scenario functions on
every rank and returns each rank's result. Every world is joined under its
own timeout; on expiry its processes are killed and the test fails, so a
hang costs one test, not the suite's clock. A spawn costs seconds, so each
test file batches its cases into as few worlds as it can.

This module imports torch and the port only: the children never load JAX.
The scenarios return numpy arrays and plain Python values.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
import uuid

import multiprocessing as mp
import numpy as np
import torch
import torch.distributed as dist


def run_world(fn, world: int, tmp_path, *args, timeout: float = 300.0):
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank in
    its own process of one gloo world."""
    ctx = mp.get_context("spawn")
    base = os.path.join(str(tmp_path), f"world_{uuid.uuid4().hex[:8]}")
    os.makedirs(base)
    store = os.path.join(base, "store")
    procs = [ctx.Process(target=_entry,
                         args=(fn.__name__, rank, world, store, base, args),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    if any(p.is_alive() for p in procs):
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        raise AssertionError(f"{fn.__name__}: world of {world} did not finish in "
                             f"{timeout} s; its processes were killed")
    results, errors = [], []
    for rank, p in enumerate(procs):
        path = os.path.join(base, f"rank{rank}.pkl")
        if p.exitcode != 0 or not os.path.exists(path):
            err = os.path.join(base, f"rank{rank}.err")
            errors.append(f"rank {rank} exit {p.exitcode}:\n" + (
                open(err).read() if os.path.exists(err) else "(no traceback)"))
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    if errors:
        raise AssertionError(f"{fn.__name__} failed:\n" + "\n".join(errors))
    return results


def _entry(name, rank, world, store, base, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            out = globals()[name](rank, world, *args)
        finally:
            from beforeholiday_tpu_torch.parallel import parallel_state

            parallel_state.destroy_model_parallel()
            dist.destroy_process_group()
        with open(os.path.join(base, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(base, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return t


def _tensor(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------ comms


def comms_scenario(rank, world, xs):
    """Every wrapper of ``monitor.comms`` on this rank's rows of ``xs``
    (fp32, shape (world, 2 * world, 3)); the ledger after all of them."""
    from beforeholiday_tpu_torch.monitor import comms

    comms.reset_comms_ledger()
    x = _tensor(xs[rank])
    out = {
        "psum": comms.psum(x, "data", site="t.psum"),
        "psum_bf16": comms.psum(x.bfloat16(), "data", site="t.psum"),
        "pmax": comms.pmax(x, "data", site="t.pmax"),
        "pmin": comms.pmin(x, "data", site="t.pmin"),
        "all_gather": comms.all_gather(x, "data", site="t.all_gather"),
        "all_gather_tiled": comms.all_gather(x, "data", site="t.all_gather",
                                             tiled=True),
        "psum_scatter": comms.psum_scatter(x, "data", site="t.psum_scatter",
                                           tiled=True),
        "all_to_all": comms.all_to_all(x[:world], "data", 0, 0,
                                       site="t.all_to_all"),
    }
    pair = comms.psum([x, 2 * x[0]], "data", site="t.variadic")
    out["variadic"] = [_np(t) for t in pair]
    with comms.ledger_scope("outer"):
        res, work = comms.psum(x, "data", site="t.async", async_op=True)
        work.wait()
    out["async"] = res
    out["groups"] = comms.psum(x, "data", site="t.groups",
                               axis_index_groups=[[i for i in range(world) if i % 2 == j]
                                                  for j in range(2)])
    out = {k: (v if isinstance(v, list) else _np(v)) for k, v in out.items()}
    return out, comms.comms_records(), comms.comms_summary()


def trainer_ledger_scenario(rank, world, weights, level, kw, images, labels):
    """The ledger of one distributed ImageNet trainer step (tiny ResNet)."""
    from beforeholiday_tpu_torch.examples.imagenet import main_amp
    from beforeholiday_tpu_torch.models import resnet
    from beforeholiday_tpu_torch.monitor import comms

    tr = _trainer(main_amp, resnet, weights, level, kw)
    comms.reset_comms_ledger()
    with torch.backends.mkldnn.flags(enabled=False):
        tr.step(*tr.shard_batch(images, labels), 0.05)
    return comms.comms_records()


# --------------------------------------------------------------------- DDP


def _grads_tree(spec, rank):
    """This rank's grad tree from ``spec``: name -> (stacked numpy, dtype
    name)."""
    return {k: _tensor(a[rank], getattr(torch, dt)) for k, (a, dt) in spec.items()}


REDUCE_KNOBS = {
    "average": {},
    "sum": dict(gradient_average=False),
    "predivide": dict(gradient_predivide_factor=2.0),
    "fp32": dict(allreduce_always_fp32=True),
    "bucketed": dict(bucket_bytes=256),
    "compressed": dict(compress=True),
    "compressed_bucketed": dict(compress=True, bucket_bytes=256),
}


def reduce_scenario(rank, world, spec, arena_np):
    """``reduce_gradients`` with each knob on a grad tree and on a
    PackedParams of gradient arenas; plus the consistency tripwire."""
    from beforeholiday_tpu_torch.ops.arena import PackedParams
    from beforeholiday_tpu_torch.parallel import distributed, parallel_state

    tree = _grads_tree(spec, rank)
    packed = PackedParams.pack({"a": _tensor(arena_np[rank][0]),
                                "b": _tensor(arena_np[rank][1]).bfloat16()})
    out = {}
    for name, kw in REDUCE_KNOBS.items():
        red = distributed.reduce_gradients(tree, **kw)
        out[name] = {k: (_np(v), str(v.dtype)) for k, v in red.items()}
        pk = distributed.reduce_gradients(packed, **kw)
        out[f"packed_{name}"] = [_np(a) for a in pk.arenas]
    # the tripwire: this rank's grads differ from the others' by design, so
    # it fires; the same grads on every rank pass
    same = {k: _tensor(a[0], getattr(torch, dt)) for k, (a, dt) in spec.items()}
    _, mism = distributed.reduce_gradients(tree, check_consistency=True)
    _, ok = distributed.reduce_gradients(same, check_consistency=True)
    out["tripwire"] = (bool(mism), bool(ok))
    parallel_state.destroy_model_parallel()
    return out


def overlap_scenario(rank, world, w_np, xs_np):
    """Backward-time hooks against the post-backward sweep on a small
    two-layer model: the tree form (identity Function, per top-level group)
    and the packed form (post-accumulate hooks on the grad arena), each
    unbucketed, bucketed and compressed. Returns each pair's gradients."""
    from beforeholiday_tpu_torch.amp.frontend import differentiate
    from beforeholiday_tpu_torch.ops.arena import PackedParams
    from beforeholiday_tpu_torch.parallel import DistributedDataParallel

    x = _tensor(xs_np[rank])

    def params():
        return {"l1": {"w": _tensor(w_np[0])}, "l2": {"w": _tensor(w_np[1]),
                                                      "b": _tensor(w_np[2])}}

    def loss_fn(p):
        if isinstance(p, PackedParams):
            p = p.unpack()
        h = torch.tanh(x @ p["l1"]["w"])
        return ((h @ p["l2"]["w"] + p["l2"]["b"]) ** 2).mean()

    _, local = differentiate(lambda q: (loss_fn(q), None), params())
    out = {"local": [_np(local["l1"]["w"]), _np(local["l2"]["b"]),
                     _np(local["l2"]["w"])]}
    for name, kw in (("plain", {}), ("bucketed", dict(bucket_bytes=512)),
                     ("compressed", dict(compress=True, bucket_bytes=512))):
        for packed in (False, True):
            got = []
            for overlap_backward in (False, True):
                ddp = DistributedDataParallel(overlap_backward=overlap_backward, **kw)
                p = PackedParams.pack(params()) if packed else params()
                _, g = ddp.value_and_grad(loss_fn)(p)
                got.append([_np(a) for a in (g.arenas if packed else
                                             [g["l1"]["w"], g["l2"]["b"], g["l2"]["w"]])])
            out[(name, packed)] = got
    # the hooks on the packed argument a loss function receives from amp's
    # step (grads born flat)
    p = PackedParams.pack(params())
    ddp = DistributedDataParallel(overlap_backward=True, bucket_bytes=512)
    _, g = differentiate(lambda q: (loss_fn(ddp.hook(q)), None), p)
    out["amp_packed"] = [_np(a) for a in g.arenas]
    return out


def sync_bn_scenario(rank, world, x_np, dy_np, scale_np, bias_np, groups):
    """Cross-device SyncBN on this rank's slice of the batch, forward and
    backward (x, scale, bias), with and without ``axis_index_groups``."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel.sync_batch_norm import (
        BatchNormParams,
        BatchNormState,
        sync_batch_norm,
    )

    out = {}
    for name, g in (("all", None), ("groups", groups)):
        comms.reset_comms_ledger()
        x = _tensor(x_np[rank]).requires_grad_(True)
        scale = _tensor(scale_np).requires_grad_(True)
        bias = _tensor(bias_np).requires_grad_(True)
        state = BatchNormState(torch.zeros(x.shape[1]), torch.ones(x.shape[1]))
        y, new = sync_batch_norm(x, BatchNormParams(scale, bias), state,
                                    axis_name="data", axis_index_groups=g,
                                    fuse_relu=True)
        y.backward(_tensor(dy_np[rank]))
        out[name] = dict(y=_np(y), dx=_np(x.grad), dscale=_np(scale.grad),
                         dbias=_np(bias.grad), mean=_np(new.running_mean),
                         var=_np(new.running_var),
                         ledger=comms.comms_records())
    return out


def _trainer(main_amp, resnet, weights, level, kw):
    params, bn_state = weights
    return main_amp.build_trainer(
        cfg=resnet.tiny_test_config(), opt_level=level, global_batch=16,
        num_classes=10, params=resnet.params_from_numpy(params, device="cpu"),
        bn_state=resnet.state_from_numpy(bn_state, device="cpu"), device="cpu",
        distributed=True, **kw)


def trainer_scenario(rank, world, weights, runs, batches):
    """The tiny-ResNet ImageNet trainer, distributed: for each ``(level,
    kw)`` of ``runs``, three steps on the global ``batches``; the losses,
    metrics and final state of each run."""
    from beforeholiday_tpu_torch.examples.imagenet import main_amp
    from beforeholiday_tpu_torch.models import resnet
    from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten

    out = []
    with torch.backends.mkldnn.flags(enabled=False):
        for level, kw in runs:
            tr = _trainer(main_amp, resnet, weights, level, kw)
            metrics = []
            for images, labels in batches:
                m = tr.step(*tr.shard_batch(images, labels), 0.05)
                metrics.append({k: float(v) for k, v in m.items()})
            params = (tr.params.arenas if isinstance(tr.params, PackedParams)
                      else tree_flatten(tr.params)[0])
            out.append(dict(metrics=metrics, params=[_np(a) for a in params],
                            bn=[_np(a) for a in tree_flatten(tr.bn_state)[0]],
                            eval=float(tr.evaluate(*tr.shard_batch(
                                *batches[0]))["loss"])))
    return out


# ---------------------------------------------------------- parallel state


def parallel_state_scenario(rank, world, configs):
    """For each ``(tp, pp, cp, vpp, split)``: this rank's ranks, world sizes,
    group members, stage predicates and neighbours; the error paths."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    out = []
    for tp, pp, cp, vpp, split in configs:
        ps.initialize_model_parallel(
            tp, pp, context_parallel_size=cp,
            virtual_pipeline_model_parallel_size=vpp,
            pipeline_model_parallel_split_rank=split)
        r = {
            "ranks": (ps.get_tensor_model_parallel_rank(),
                      ps.get_pipeline_model_parallel_rank(),
                      ps.get_data_parallel_rank(), ps.get_context_parallel_rank()),
            "sizes": (ps.get_tensor_model_parallel_world_size(),
                      ps.get_pipeline_model_parallel_world_size(),
                      ps.get_data_parallel_world_size(),
                      ps.get_context_parallel_world_size()),
            "members": {a: ps.get_state().group_ranks[a]
                        for a in ps.MESH_AXIS_NAMES},
            "first": ps.is_pipeline_first_stage(),
            "last": ps.is_pipeline_last_stage(),
            "before": ps.is_pipeline_stage_before_split(),
            "after": ps.is_pipeline_stage_after_split(),
            "next": ps.get_pipeline_model_parallel_next_rank(),
            "prev": ps.get_pipeline_model_parallel_prev_rank(),
            "info": ps.get_rank_info(),
            "grid": ps.get_rank_grid().tolist(),
            # a collective over each axis: the sum of the global ranks of
            # the group's members
            "sums": {a: int(comms.psum(torch.tensor([float(rank)]), a,
                                       site="t.axis")[0])
                     for a in ps.MESH_AXIS_NAMES},
        }
        if vpp is not None:
            ps.set_virtual_pipeline_model_parallel_rank(vpp - 1)
            r["first_last_vchunk"] = (ps.is_pipeline_first_stage(),
                                      ps.is_pipeline_last_stage())
        out.append(r)
    errors = []
    for kw in (dict(tensor_model_parallel_size=3),
               dict(virtual_pipeline_model_parallel_size=2)):
        try:
            ps.initialize_model_parallel(**kw)
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    ps.destroy_model_parallel()
    return out, errors, ps.model_parallel_is_initialized(), ps.get_rank_info()


def batch_scenario(rank, world, calls):
    """Several scenarios in one world: ``calls`` is a list of ``(name,
    args)``; returns their results in order."""
    return [globals()[name](rank, world, *args) for name, args in calls]
