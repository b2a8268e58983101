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

import dataclasses
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


# --------------------------------------------------- tensor parallelism

# the mappings by name: (function, extra args)
def _mappings():
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp

    return {
        "copy": lambda x: tp.copy_to_tensor_model_parallel_region(x),
        "reduce": lambda x: tp.reduce_from_tensor_model_parallel_region(x),
        "scatter": lambda x: tp.scatter_to_tensor_model_parallel_region(x),
        "gather": lambda x: tp.gather_from_tensor_model_parallel_region(x),
        "sp_scatter": lambda x: tp.scatter_to_sequence_parallel_region(x),
        "sp_gather": lambda x: tp.gather_from_sequence_parallel_region(x),
        "sp_gather_split": lambda x: tp.gather_from_sequence_parallel_region(
            x, "tensor", False),
        "sp_reduce_scatter": lambda x: tp.reduce_scatter_to_sequence_parallel_region(x),
    }


def _vjp(fn, primals, cotangent, dtype=None):
    """``(out, [d primal])`` of ``fn`` at numpy ``primals`` (float ones
    differentiated; ints passed as int64) pulled back from ``cotangent``."""
    ps = []
    for p in primals:
        t = _tensor(p)
        if t.is_floating_point():
            t = (t if dtype is None else t.to(dtype)).requires_grad_(True)
        else:
            t = t.long()
        ps.append(t)
    out = fn(*ps)
    diff = [p for p in ps if p.requires_grad]
    grads = torch.autograd.grad(out, diff, _tensor(cotangent, out.dtype),
                                allow_unused=True)
    return _np(out), [None if g is None else _np(g) for g in grads]


def tp_layer_cases(W, r):
    """The layer cases at tensor world ``W`` for tensor rank ``r``: name ->
    a function of the case's numpy arrays (the same names as the JAX side
    in tests/test_torch_tensor_parallel.py)."""
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp

    def col(gather=False, sp=False):
        return lambda x, w, b: tp.column_parallel_linear(
            x, w, b, gather_output=gather, sequence_parallel=sp)

    def row(parallel=True, sp=False):
        return lambda x, w, b: tp.row_parallel_linear(
            x, w, b, input_is_parallel=parallel, sequence_parallel=sp)

    def ce(s, save):
        return lambda logits, tgt, V: tp.vocab_parallel_cross_entropy(
            logits, tgt, V, s, save_softmax=save)

    return {"col": col(), "col_gather": col(gather=True), "col_sp": col(sp=True),
            "row": row(), "row_scatter": row(parallel=False), "row_sp": row(sp=True),
            "ce": ce}


def tp_scenario(rank, world, sizes, data):
    """For each tensor world W of ``sizes`` (groups of W consecutive ranks),
    with this rank's tensor rank r: every mapping's output and input
    gradient on ``data[W]["maps"][name]`` = (X, dY) rows r; the layers'
    outputs and gradients on ``data[W]["layers"]``; the SP LayerNorm's
    parameter gradients; GradScaler and reduce_found_inf with one rank's
    overflow; broadcast_data; the memory buffers."""
    from beforeholiday_tpu_torch.amp.scaler import LossScaler
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import GradScaler, reduce_found_inf
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp
    from beforeholiday_tpu_torch.transformer.layers import sp_fused_layer_norm

    out = {}
    for W in sizes:
        ps.initialize_model_parallel(W)
        r = ps.get_tensor_model_parallel_rank()
        res = out[W] = {}
        for name, fn in _mappings().items():
            X, dY = data[W]["maps"][name]
            res[name] = _vjp(fn, [X[r]], dY[r])
        # chunked gathers and reduce-scatters (a 64-byte budget: several
        # chunks each) are the single collectives, bitwise
        prev = tp.set_collective_chunk_bytes(64)
        chunked = {}
        for name, fn in _mappings().items():
            X, dY = data[W]["maps"][name]
            out_c, (dx_c,) = _vjp(fn, [X[r]], dY[r])
            chunked[name] = bool(np.array_equal(out_c, res[name][0])
                                 and np.array_equal(dx_c, res[name][1][0]))
        res["chunked_bitwise"] = chunked
        res["chunk_budget"] = (tp.set_collective_chunk_bytes(prev),
                               tp.collective_chunk_bytes())
        for name, (dt, args, dy) in data[W]["layers"].items():
            kind = name.split(":")[0]
            dtype = getattr(torch, dt)
            if kind == "embed":
                tok, table = args
                fn = lambda t, w: tp.vocab_parallel_embedding(t, w, vocab_size=table.shape[1] * W)  # noqa: E731
                res[name] = _vjp(fn, [tok, table[r]], dy[r], dtype)
            elif kind.startswith("ce"):
                _, s, save = kind.split("_")
                logits, tgt = args
                f = tp_layer_cases(W, r)["ce"](float(s), save == "save")
                res[name] = _vjp(lambda x, t: f(x, t, logits.shape[-1] * W),
                                 [logits[r], tgt], dy[r], dtype)
            else:
                x, w, b = args
                res[name] = _vjp(tp_layer_cases(W, r)[kind], [x[r], w[r], b[r]],
                                 dy[r], dtype)
        # the SP LayerNorm: each rank normalizes its sequence shard, and the
        # parameter gradients come back whole
        x, s, b, dy = data[W]["sp_ln"]
        res["sp_ln"] = _vjp(lambda x_, s_, b_: sp_fused_layer_norm(
            x_, s_, b_, sequence_parallel=True), [x[r], s, b], dy[r])
        # global rank 1's overflow reaches every rank of its tensor (and
        # pipe) group, and no other
        res["found_inf"] = bool(reduce_found_inf(torch.tensor(rank == 1)))
        scaler = GradScaler()
        st = LossScaler().init(device="cpu")
        g = {"a": torch.full((3,), float("inf") if rank == 1 else 1.0)}
        _, found = scaler.unscale(g, st)
        res["scaler_found_inf"] = bool(found)
        # broadcast_data: force takes tensor rank 0's values
        batch = {"text": torch.full((2, 3), r, dtype=torch.int64),
                 "mask": torch.full((2,), float(r))}
        forced = tp.broadcast_data(["text", "mask"], batch, force=True)
        res["broadcast"] = {k: _np(v) for k, v in forced.items()}
        res["broadcast_same"] = tp.broadcast_data(["text"], batch, torch.int64)["text"] is batch["text"]
    # errors: a missing key, a wrong dtype
    errs = []
    for args in ((["x"], {}), (["text"], {"text": torch.zeros(2)}, torch.int64)):
        try:
            tp.broadcast_data(*args)
            errs.append(None)
        except (KeyError, TypeError) as e:
            errs.append(type(e).__name__)
    # the memory buffers: views of one flat tensor
    buf = tp.MemoryBuffer(12, torch.float32, device="cpu")
    v = buf.get((2, 3), 4)
    v.fill_(7.0)
    ring = tp.RingMemBuffer(2, 4, device="cpu")
    order = [id(ring.get_next_buffer()) for _ in range(3)]
    try:
        buf.get((4, 4), 0)
        over = None
    except ValueError as e:
        over = str(e)
    buf_state = dict(data=_np(buf.data), cycle=(order[0] == order[2] != order[1]),
                     over=over)
    buf.zero()
    buf_state["zeroed"] = bool((buf.data == 0).all())
    ps.destroy_model_parallel()
    return out, errs, buf_state


# ----------------------------------------------------- pipeline parallelism


def _toy_stage(sp, x):
    """The JAX tests' toy stage: one dense + tanh-GELU block with a residual."""
    return torch.nn.functional.gelu(x @ sp["w"] + sp["b"], approximate="tanh") + x


def _toy_loss(y, tgt):
    return ((y - tgt) ** 2).mean()


def _toy_ce(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def pp_scenario(rank, world, cases):
    """Each case ``(name, tp, pp, kw)``: this rank's (loss, grads) from the
    port's schedule named by ``kw["schedule"]`` over a (tp, pp) layout of
    the world, on the toy stage stack ``kw["stacked"]`` (this rank's pipe
    stage, or V chunks for the interleaved schedule), and the schedule's
    report. Also the p2p rings and the error paths."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import pipeline_parallel as pp
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp
    from beforeholiday_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p,
    )

    def tp_stage(sp, x):
        h = tp.column_parallel_linear(x, sp["w"], sp["b"], gather_output=True)
        return torch.nn.functional.gelu(h, approximate="tanh") + x

    out = {}
    for name, tsize, psize, kw in cases:
        ps.initialize_model_parallel(tsize, psize)
        s, tr = ps.get_pipeline_model_parallel_rank(), ps.get_tensor_model_parallel_rank()
        stacked = {k: _tensor(v) for k, v in kw["stacked"].items()}
        inputs, targets = _tensor(kw["inputs"]), _tensor(kw["targets"])
        if inputs.dtype == torch.int32:
            inputs, targets = inputs.long(), targets.long()
        V = kw.get("V")
        extra = {}
        if "embed" in kw:
            extra = dict(embed_fn=lambda ep, t: ep[t], embed_params=_tensor(kw["embed"]),
                         head_fn=lambda hp, h: h @ hp["w"] + hp["b"],
                         head_params={k: _tensor(v) for k, v in kw["head"].items()},
                         tensor_shape=kw["tensor_shape"], dtype=torch.float32)
        loss_fn = _toy_ce if "embed" in kw else _toy_loss
        if V is not None:
            chunks = {k: v[s * V:(s + 1) * V] for k, v in stacked.items()}
            loss, g = pp.forward_backward_pipelining_with_interleaving(
                _toy_stage, loss_fn, chunks, inputs, targets,
                virtual_pipeline_model_parallel_size=V, **extra)
        else:
            sp = {k: v[s] for k, v in stacked.items()}
            stage = _toy_stage
            if tsize > 1:
                half = sp["w"].shape[1] // tsize
                sp = {"w": sp["w"][:, tr * half:(tr + 1) * half],
                      "b": sp["b"][tr * half:(tr + 1) * half]}
                stage = tp_stage
            loss, g = pp.forward_backward_pipelining_without_interleaving(
                stage, loss_fn, sp, inputs, targets, **extra)
        if isinstance(g, pp.PipelineGrads):
            g = dict(stage=g.stage, embed=g.embed, head=g.head)
        out[name] = (float(loss), _np_tree(g), pp.last_schedule_report())
    # the rings at S = 4: rank r receives rank r-1's value forward and rank
    # r+1's backward
    ps.initialize_model_parallel(1, 4)
    mine = torch.full((2,), float(rank))
    fwd, bwd = p2p.send_forward_recv_backward(mine, 10 + mine)
    out["rings"] = (_np(fwd), _np(bwd), _np(p2p.send_forward_recv_forward(mine)))
    errors = []
    x = torch.zeros(3, 2, 8)
    sp = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
    calls = [
        lambda: pp.forward_backward_pipelining_with_interleaving(
            _toy_stage, _toy_loss, {k: v[None].repeat(2, *([1] * v.ndim))
                                    for k, v in sp.items()},
            x, x, virtual_pipeline_model_parallel_size=2),
        lambda: pp.forward_backward_pipelining_without_interleaving(
            _toy_stage, _toy_loss, sp, x, x[:2]),
        lambda: pp.forward_backward_pipelining_without_interleaving(
            _toy_stage, _toy_loss, sp, x, x, overlap_p2p=True),
        lambda: pp.forward_backward_pipelining_without_interleaving(
            _toy_stage, _toy_loss, sp, x, x, remat_policy="full"),
        lambda: pp.forward_backward_pipelining_encoder_decoder(),
    ]
    for call in calls:
        try:
            call()
            errors.append(None)
        except (ValueError, NotImplementedError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    ps.destroy_model_parallel()
    return out, errors


def _np_tree(tree):
    from beforeholiday_tpu_torch.ops.arena import tree_map

    return None if tree is None else tree_map(_np, tree)


# ------------------------------------------------------ the GPT over TP x PP


def gpt_tp_pp_o5(amp, gpt, fused_adam, shard, cfg, lr, M, schedule="1f1b",
                 impl=None, loss_scale=None, device="cpu"):
    """The flagship GPT's amp O5 step over this rank's (tensor, pipe) shard,
    as a Megatron user script builds it from the port's public functions:
    ``amp.initialize(..., "O5", arena_native=True)`` on the shard,
    FusedAdam on its arenas, the batch split into M microbatches through
    ``forward_backward_no_pipelining`` (``schedule="none"``) or the 1F1B
    engine (embed on the first stage, head on the last; the tied
    embedding's embed and head gradients, both pipe-all-reduced, summed),
    the loss scaled by the dynamic scale, the gradients unscaled by K5 and
    the overflow flag reduced over the tensor and pipe groups. Returns
    ``(m, state, step)``; ``step(tokens, targets)`` returns ``(loss, fp32
    grads, found_inf)``."""
    from beforeholiday_tpu_torch.parallel import parallel_state
    from beforeholiday_tpu_torch.transformer import pipeline_parallel as pp
    from beforeholiday_tpu_torch.transformer import reduce_found_inf
    from beforeholiday_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy,
    )

    cfg = dataclasses.replace(cfg, attention_impl=impl, norm_impl=impl)
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), shard,
                       fused_adam(lr=lr, impl=impl), "O5", arena_native=True,
                       loss_scale=loss_scale)
    state = {"opt": m.optimizer.init(m.params), "scaler": m.scaler.init(device=device)}

    def step(tokens, targets):
        B, S = tokens.shape
        toks, tgts = tokens.reshape(M, B // M, S), targets.reshape(M, B // M, S)
        tree = m.params.unpack()  # views of the arenas
        blocks = {"blocks": {k: v.unbind(0) for k, v in tree["blocks"].items()}}
        rest = {k: v for k, v in tree.items() if k != "blocks"}
        scale = state["scaler"]["scale"]

        def loss_fn(logits, tgt):
            return m.scaler.scale_loss(vocab_parallel_cross_entropy(
                logits, tgt, cfg.vocab_size).mean(), state["scaler"])

        if schedule == "none":
            loss, g = pp.forward_backward_no_pipelining(
                lambda p, t: gpt.forward(p, t, cfg), loss_fn, {**blocks, **rest},
                toks, tgts)
        else:
            tp = parallel_state.get_tensor_model_parallel_world_size()
            shape = ((S // tp, B // M, cfg.d_model) if cfg.sequence_parallel
                     else (B // M, S, cfg.d_model))
            loss, pg = pp.forward_backward_pipelining_without_interleaving(
                lambda sp, x: gpt.blocks(sp, x, cfg), loss_fn, blocks, toks, tgts,
                embed_fn=lambda ep, t: gpt.embed(ep, t, cfg),
                embed_params={k: rest[k] for k in ("tok_embed", "pos_embed")},
                head_fn=lambda hp, h: gpt.head(hp, h, cfg),
                head_params={k: rest[k] for k in ("tok_embed", "lnf_scale", "lnf_bias")},
                tensor_shape=shape, dtype=cfg.dtype)
            g = {**pg.stage, "pos_embed": pg.embed["pos_embed"],
                 "tok_embed": pg.embed["tok_embed"] + pg.head["tok_embed"],
                 "lnf_scale": pg.head["lnf_scale"], "lnf_bias": pg.head["lnf_bias"]}
        grads = m.params.zeros_like()
        views = grads.unpack()
        for k, v in g.items():
            if k == "blocks":
                for name, per_layer in v.items():
                    for i, gi in enumerate(per_layer):
                        views["blocks"][name][i].copy_(gi)
            else:
                views[k].copy_(v)
        grads, found = m.scaler.unscale(grads, state["scaler"], impl=impl)
        found = reduce_found_inf(found)
        state["scaler"] = m.scaler.update(state["scaler"], found)
        m.params, state["opt"] = m.optimizer.step(m.params, grads, state["opt"],
                                                  found_inf=found)
        return loss / scale, grads, found

    return m, state, step


def gpt_tp_scenario(rank, world, cfg_kw, np_params, tokens, targets, o5_runs):
    """(a) at tensor world 1 (model parallelism initialized, tp = 1): the
    TP forward against the dense forward, fp32 and bf16, sequence parallel
    off and on; (b) at tp = 2: the fp32 loss and this rank's shard of the
    gradients, sequence parallel off and on; (c) for each ``(label, tp, pp,
    sp, M, steps, lr)`` of ``o5_runs``: the O5 step over TP x PP, each
    step's loss, flag, this rank's grads and masters (trees), and whether
    the replicated leaves are bitwise equal across the tensor group."""
    from beforeholiday_tpu_torch import amp
    from beforeholiday_tpu_torch.ops._autocast import cast_floats
    from beforeholiday_tpu_torch.optimizers import FusedAdam
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.testing import gpt

    params = gpt.params_from_numpy(np_params, device="cpu")
    tok, tgt = _tensor(tokens).long(), _tensor(targets).long()
    out = {}
    # (a) world 1: bitwise the dense forward
    for dt in ("float32", "bfloat16"):
        p = cast_floats(params, getattr(torch, dt))
        dense = gpt.forward(p, tok, gpt.GPTConfig(**cfg_kw, dtype=getattr(torch, dt)))
        for sp in (False, True):
            ps.initialize_model_parallel(1)
            cfg = gpt.GPTConfig(**cfg_kw, dtype=getattr(torch, dt), sequence_parallel=sp)
            got = gpt.forward(p, tok, cfg)
            ps.destroy_model_parallel()
            out[("world1", dt, sp)] = bool(torch.equal(got, dense))
    # (b) tp = 2, fp32 loss and grads
    ps.initialize_model_parallel(2)
    tr = ps.get_tensor_model_parallel_rank()
    for sp in (False, True):
        cfg = gpt.GPTConfig(**cfg_kw, sequence_parallel=sp)
        shard = gpt.shard_params(params, cfg, tr, 2)
        leaves, treedef = _flatten(shard)
        leaves = [x.requires_grad_(True) for x in leaves]
        loss = gpt.loss_fn(_unflatten(treedef, leaves), tok, tgt, cfg)
        grads = torch.autograd.grad(loss, leaves)
        out[("tp2", sp)] = (float(loss), _np_tree(_unflatten(treedef, list(grads))))
    ps.destroy_model_parallel()
    # (c) the O5 step over TP x PP
    for label, tsize, psize, sp, M, steps, lr in o5_runs:
        ps.initialize_model_parallel(tsize, psize)
        tr, pr = ps.get_tensor_model_parallel_rank(), ps.get_pipeline_model_parallel_rank()
        cfg = gpt.GPTConfig(**cfg_kw, dtype=torch.bfloat16, sequence_parallel=sp)
        shard = gpt.shard_params(params, cfg, tr, tsize, pr, psize)
        m, state, step = gpt_tp_pp_o5(amp, gpt, FusedAdam, shard, cfg, lr, M)
        runs = []
        for _ in range(steps):
            loss, g, fi = step(tok, tgt)
            masters = m.params.replace_arenas(state["opt"]["master"]).unpack()
            runs.append(dict(loss=float(loss), found_inf=bool(fi),
                             grads=_np_tree(g.unpack()), masters=_np_tree(masters),
                             replicated=_replicated_equal(m.params.unpack(), tsize)))
        out[label] = runs
        ps.destroy_model_parallel()
    return out


def _flatten(tree):
    from beforeholiday_tpu_torch.ops.arena import tree_flatten

    return tree_flatten(tree)


def _unflatten(treedef, leaves):
    from beforeholiday_tpu_torch.ops.arena import tree_unflatten

    return tree_unflatten(treedef, leaves)


REPLICATED = ("pos_embed", "lnf_scale", "lnf_bias")
REPLICATED_BLOCKS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "bo", "bo2")


def _replicated_equal(tree, tsize):
    """Whether every replicated leaf is bitwise equal across the tensor
    group (a gather of each to every rank)."""
    from beforeholiday_tpu_torch.monitor import comms

    leaves = ([tree[k] for k in REPLICATED]
              + [tree["blocks"][k] for k in REPLICATED_BLOCKS])
    same = True
    for leaf in leaves:
        every = comms.all_gather(leaf.float(), "tensor", site="t.check")
        same &= all(torch.equal(every[0], every[i]) for i in range(tsize))
    return same


def tp_pp_ledger_scenario(rank, world, stacked, embed, head, tokens, labels):
    """The ledger of one TP 2 x PP 2 step of the toy stack (1F1B, a
    column-parallel stage with its output gathered, embed and head stages)
    and the step's tick count."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import pipeline_parallel as pp
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp

    ps.initialize_model_parallel(2, 2)
    s, tr = ps.get_pipeline_model_parallel_rank(), ps.get_tensor_model_parallel_rank()
    half = stacked["w"].shape[-1] // 2
    sp = {"w": _tensor(stacked["w"][s][:, tr * half:(tr + 1) * half]),
          "b": _tensor(stacked["b"][s][tr * half:(tr + 1) * half])}

    def stage(p, x):
        h = tp.column_parallel_linear(x, p["w"], p["b"], gather_output=True)
        return torch.nn.functional.gelu(h, approximate="tanh") + x

    tok = _tensor(tokens).long()
    comms.reset_comms_ledger()
    pp.forward_backward_pipelining_without_interleaving(
        stage, _toy_ce, sp, tok, _tensor(labels).long(),
        embed_fn=lambda ep, t: ep[t], embed_params=_tensor(embed),
        head_fn=lambda hp, h: h @ hp["w"] + hp["b"],
        head_params={k: _tensor(v) for k, v in head.items()},
        tensor_shape=(tok.shape[1], stacked["w"].shape[-1]), dtype=torch.float32)
    records = comms.comms_records()
    ps.destroy_model_parallel()
    return records, pp.last_schedule_report()["total_ticks"]
