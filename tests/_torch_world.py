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

import contextlib
import dataclasses
import importlib
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
    its own process of one gloo world (``fn`` a function of this module or
    of another module beside it)."""
    ctx = mp.get_context("spawn")
    base = os.path.join(str(tmp_path), f"world_{uuid.uuid4().hex[:8]}")
    os.makedirs(base)
    store = os.path.join(base, "store")
    name = f"{fn.__module__}:{fn.__name__}"
    procs = [ctx.Process(target=_entry,
                         args=(name, rank, world, store, base, args),
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
            module, fn = name.split(":")
            out = getattr(importlib.import_module(module), fn)(rank, world, *args)
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


def _t5_stage(sp, h, mem, is_decoder):
    """``tests/test_pipeline_parallel.py``'s toy encoder/decoder stage."""
    base = torch.nn.functional.gelu(h @ sp["w"] + sp["b"], approximate="tanh") + h
    return base + is_decoder * torch.tanh(mem @ sp["wm"])


def _encdec_case(pp, kw, s):
    """The encoder-decoder schedule on the T5 toy of ``kw``."""
    t = {k: _tensor(v) if not isinstance(v, dict) else
         {kk: _tensor(vv) for kk, vv in v.items()} for k, v in kw.items()
         if k not in ("encdec", "tensor_shape")}
    loss, g = pp.forward_backward_pipelining_encoder_decoder(
        _t5_stage, _toy_loss, {k: v[s] for k, v in t["stacked"].items()},
        t["enc_in"], t["dec_in"], t["targets"], split_rank=kw["encdec"],
        enc_embed_fn=lambda ep, x: x @ ep["we"], enc_embed_params=t["ee"],
        dec_embed_fn=lambda ep, x: x @ ep["we"], dec_embed_params=t["de"],
        head_fn=lambda hp, h: h @ hp["wh"], head_params=t["hp"],
        tensor_shape=kw["tensor_shape"], dtype=torch.float32)
    return loss, dict(stage=g.stage, enc_embed=g.enc_embed, dec_embed=g.dec_embed,
                      head=g.head)


def pp_scenario(rank, world, cases):
    """Each case ``(name, tp, pp, kw)``: this rank's (loss, grads) from the
    port's schedule over a (tp, pp) layout of the world, on the toy stage
    stack ``kw["stacked"]`` (this rank's pipe stage, or V chunks for the
    interleaved schedule; ``kw["overlap"]``: the double-buffered engine;
    ``kw["encdec"]``: the encoder-decoder schedule at that split rank, on
    the T5 toy; ``kw["remat"]``: the stage's remat policy), and the
    schedule's report. Also the p2p rings and the error paths."""
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
        if "encdec" in kw:
            loss, g = _encdec_case(pp, kw, s)
            out[name] = (float(loss), _np_tree(g), pp.last_schedule_report())
            continue
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
        extra["overlap_p2p"] = kw.get("overlap", False)
        extra["remat_policy"] = kw.get("remat")
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
            _toy_stage, _toy_loss, sp, x, x[:2], overlap_p2p=True),
        lambda: pp.forward_backward_pipelining_without_interleaving(
            _toy_stage, _toy_loss, sp, x, x, remat_policy="no_such_policy"),
        lambda: pp.forward_backward_pipelining_encoder_decoder(
            _t5_stage, _toy_loss, sp, x, x, x),
        lambda: pp.forward_backward_pipelining_encoder_decoder(
            _t5_stage, _toy_loss, sp, x, x, x, split_rank=4),
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
                 impl=None, loss_scale=None, device="cpu", dropout_key=None):
    """The flagship GPT's amp O5 step over this rank's (tensor, pipe) shard,
    as a Megatron user script builds it from the port's public functions:
    ``amp.initialize(..., "O5", arena_native=True)`` on the shard,
    FusedAdam on its arenas, the batch split into M microbatches through
    ``forward_backward_no_pipelining`` (``schedule="none"``) or the 1F1B
    engine (embed on the first stage, head on the last; the tied
    embedding's embed and head gradients, both pipe-all-reduced, summed),
    the loss scaled by the dynamic scale, the gradients unscaled by K5 and
    the overflow flag reduced over the tensor and pipe groups. With
    ``dropout_key`` (``schedule="none"`` only) the forward trains with
    dropout. Returns ``(m, state, step)``; ``step(tokens, targets)`` returns
    ``(loss, fp32 grads, found_inf)``."""
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
            if not parallel_state.model_parallel_is_initialized():
                return m.scaler.scale_loss(gpt._cross_entropy(logits, tgt),
                                           state["scaler"])
            return m.scaler.scale_loss(vocab_parallel_cross_entropy(
                logits, tgt, cfg.vocab_size).mean(), state["scaler"])

        if schedule == "none":
            loss, g = pp.forward_backward_no_pipelining(
                lambda p, t: gpt.forward(p, t, cfg, dropout_key=dropout_key),
                loss_fn, {**blocks, **rest}, toks, tgts)
        else:
            if dropout_key is not None:
                raise ValueError("dropout here runs without pipelining only")
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
        if parallel_state.model_parallel_is_initialized():
            found = reduce_found_inf(found)
        state["scaler"] = m.scaler.update(state["scaler"], found)
        m.params, state["opt"] = m.optimizer.step(m.params, grads, state["opt"],
                                                  found_inf=found)
        return loss / scale, grads, found

    return m, state, step


@contextlib.contextmanager
def recording_masks(record):
    """Append ``(key, shape, rate, place, mask)`` to ``record`` for every
    keep mask the plain paths draw (flash attention's plain versions and
    ``dropout`` on the CPU), as numpy."""
    from beforeholiday_tpu_torch.ops import attention

    draw = attention.dropout_keep_mask_torch

    def recorded(key, shape, rate, place=None):
        mask = draw(key, shape, rate, place)
        record.append((key.numpy().copy(), tuple(shape), rate,
                       None if place is None else tuple(place), mask.numpy().copy()))
        return mask

    attention.dropout_keep_mask_torch = recorded
    try:
        yield record
    finally:
        attention.dropout_keep_mask_torch = draw


@contextlib.contextmanager
def same_layer_keys(on):
    """With ``on``, every GPT layer draws from the one key (JAX's layer scan
    traces its body once, so its layers read the same site masks)."""
    from beforeholiday_tpu_torch.testing import _model_utils

    split = _model_utils.split
    if on:
        _model_utils.split = lambda key, n: key.expand(n, 2)
    try:
        yield
    finally:
        _model_utils.split = split


def gpt_o5_dropout_steps(cfg, shard, tok, tgt, key, steps, lr, M=1):
    """``steps`` amp O5 steps with dropout under ``key`` on this rank's
    shard (the dense model when model parallelism is not initialized):
    each step's loss, grads and masters, and the masks the first step drew."""
    from beforeholiday_tpu_torch import amp
    from beforeholiday_tpu_torch.optimizers import FusedAdam
    from beforeholiday_tpu_torch.testing import gpt

    m, state, step = gpt_tp_pp_o5(amp, gpt, FusedAdam, shard, cfg, lr, M,
                                  schedule="none", dropout_key=key)
    runs = []
    for i in range(steps):
        with recording_masks([]) as masks:
            loss, g, fi = step(tok, tgt)
        masters = m.params.replace_arenas(state["opt"]["master"]).unpack()
        runs.append(dict(loss=float(loss), found_inf=bool(fi),
                         grads=_np_tree(g.unpack()), masters=_np_tree(masters),
                         masks=masks if i == 0 else None))
    return runs


def dropout_keys_scenario(rank, world, seed):
    """The per-rank keys and masks: at tensor size ``world``, this rank's
    ``model_parallel_seed`` and its masks over ones (128,) at rate 0.5 with
    and without ``tp_distinct``; at data size ``world``, its
    ``data_parallel_seed``."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer.tensor_parallel import random as trandom

    key = trandom.make_key(seed, device="cpu")
    ones = torch.ones(128)
    ps.initialize_model_parallel(world)
    out = {"mp_seed": _np(trandom.model_parallel_seed(key)),
           "distinct": _np(trandom.dropout(key, ones, 0.5, tp_distinct=True) != 0),
           "shared": _np(trandom.dropout(key, ones, 0.5) != 0)}
    ps.initialize_model_parallel(1)
    out["dp_seed"] = _np(trandom.data_parallel_seed(key))
    ps.destroy_model_parallel()
    return out


def gpt_tp_scenario(rank, world, cfg_kw, np_params, tokens, targets, o5_runs,
                    dropout_runs=()):
    """(a) at tensor world 1 (model parallelism initialized, tp = 1): the
    TP forward against the dense forward, fp32 and bf16, sequence parallel
    off and on; (b) at tp = 2: the fp32 loss and this rank's shard of the
    gradients, sequence parallel off and on; (c) for each ``(label, tp, pp,
    sp, M, steps, lr)`` of ``o5_runs``: the O5 step over TP x PP, each
    step's loss, flag, this rank's grads and masters (trees), and whether
    the replicated leaves are bitwise equal across the tensor group; (d)
    for each ``(label, tp, sp, seed, same_keys, steps, lr, rates)`` of
    ``dropout_runs``: :func:`gpt_o5_dropout_steps` at that tensor size (0:
    the dense model) under the key of ``seed``, at the dropout rates of the
    dict ``rates``."""
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
    # (d) the O5 step with dropout over TP
    from beforeholiday_tpu_torch.transformer.tensor_parallel.random import make_key

    for label, tsize, sp, seed, same_keys, steps, lr, rates in dropout_runs:
        cfg = gpt.GPTConfig(**cfg_kw, **rates, dtype=torch.bfloat16,
                            sequence_parallel=sp)
        shard = params
        if tsize:  # else the dense model
            ps.initialize_model_parallel(tsize)
            shard = gpt.shard_params(params, cfg, ps.get_tensor_model_parallel_rank(),
                                     tsize)
        with same_layer_keys(same_keys):
            out[label] = gpt_o5_dropout_steps(cfg, shard, tok, tgt,
                                              make_key(seed, device="cpu"), steps, lr)
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


# ------------------------------------------------------ context parallelism


def cp_scenario(rank, world, cases):
    """Each case ``(name, cp, causal, dtype, path, q, k, v, w)`` (the whole
    ``(B, H, S, D)`` numpy tensors): over a context group of ``cp`` ranks,
    this rank's slice of the ring attention output and of the gradients of
    ``sum(out * w)``, by the flash hops (``path="flash"``, K2/K4's plain
    versions) or the online-softmax hops; and the ledger of each case."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import context_parallel as cpar

    out = {}
    for name, cp, causal, dtype, path, *arrays in cases:
        ps.initialize_model_parallel(1, 1, context_parallel_size=cp)
        r = ps.get_context_parallel_rank()
        Sl = arrays[0].shape[2] // cp
        q, k, v, w = (_tensor(a[:, :, r * Sl:(r + 1) * Sl], getattr(torch, dtype))
                      for a in arrays)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        comms.reset_comms_ledger()
        if path == "flash":
            o = cpar._ring_attention_flash(q, k, v, causal=causal, scale=0.3,
                                           axis_name="context", impl="torch")
        else:
            o = cpar.ring_attention(q, k, v, causal=causal, scale=0.3,
                                    axis_name="context", impl="torch")
        grads = torch.autograd.grad((o.float() * w.float()).sum(), (q, k, v))
        out[name] = (_np(o), [_np(g) for g in grads], str(o.dtype),
                     comms.comms_records())
        ps.destroy_model_parallel()
    return out


# ------------------------------------------------------ collective matmul


def collective_matmul_scenario(rank, world, cases):
    """Each case ``(name, tp, x, w, b, dy, dtype)`` (whole numpy operands:
    x sequence-sharded on dim 0, w and b column-sharded, dy the output's
    cotangent, sharded on its last dim): the sequence-parallel
    ``column_parallel_linear`` with the collective matmul on and off, this
    rank's y, dx, dw, db for each, and the ledger of the collective run;
    also the module knob driving ``collective_matmul=None``."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.transformer import tensor_parallel as tp

    out = {}
    for name, tsize, x, w, b, dy, dtype in cases:
        ps.initialize_model_parallel(tsize)
        r = ps.get_tensor_model_parallel_rank()
        dt = getattr(torch, dtype)
        s, n = x.shape[0] // tsize, w.shape[1] // tsize
        xs = _tensor(x[r * s:(r + 1) * s], dt)
        ws = _tensor(w[:, r * n:(r + 1) * n], dt)
        bs = None if b is None else _tensor(b[r * n:(r + 1) * n], dt)
        dys = _tensor(dy[..., r * n:(r + 1) * n], dt)
        runs = {}
        for collective in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (xs, ws, bs) if t is not None]
            comms.reset_comms_ledger()
            y = tp.column_parallel_linear(leaves[0], leaves[1],
                                          leaves[2] if bs is not None else None,
                                          sequence_parallel=True,
                                          collective_matmul=collective)
            grads = torch.autograd.grad(y, leaves, dys)
            runs[collective] = ([_np(y)] + [_np(g) for g in grads],
                                comms.comms_records())
        out[name] = runs
        ps.destroy_model_parallel()
    ps.initialize_model_parallel(world)
    xs, ws = torch.ones(2, 4), torch.ones(4, 2)
    knob = []
    for enabled in (False, True):
        prev = tp.set_collective_matmul(enabled)
        comms.reset_comms_ledger()
        tp.column_parallel_linear(xs, ws, sequence_parallel=True)
        knob.append((prev, tp.collective_matmul_enabled(),
                     sorted({r["site"] for r in comms.comms_records()})))
    tp.set_collective_matmul(False)
    out["knob"] = knob
    ps.destroy_model_parallel()
    return out


# ------------------------------------------------------- BERT over TP


def bert_o5_lamb_steps(cfg, shard, batch, steps, lr):
    """``steps`` amp O5 arena-native FusedLAMB steps of ``pretrain_loss`` on
    this rank's shard (the dense model when model parallelism is not
    initialized; under TP, ``FusedLAMB(tensor_sharded=...)`` and the
    overflow flag reduced over the tensor group): each step's loss, grads
    and masters."""
    from beforeholiday_tpu_torch import amp
    from beforeholiday_tpu_torch.optimizers import FusedLAMB
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.testing import bert
    from beforeholiday_tpu_torch.transformer import reduce_found_inf

    tp = ps.model_parallel_is_initialized()
    opt = FusedLAMB(lr=lr, weight_decay=0.01,
                    tensor_sharded=bert.tensor_sharded(cfg) if tp else None)
    m = amp.initialize(lambda p, t: bert.forward(p, t, cfg), shard, opt, "O5",
                       arena_native=True)
    tok, tgt, mask, nsp, lens = batch

    def loss_fn(pk):
        return bert.pretrain_loss(pk.unpack(), tok, tgt, mask, nsp, cfg, seq_lens=lens)

    svag = amp.scaled_value_and_grad(loss_fn, m.scaler)
    o, s = m.optimizer.init(m.params), m.scaler.init(device="cpu")
    runs = []
    for _ in range(steps):
        loss, g, fi, s = svag(m.params, s)
        if tp:
            fi = reduce_found_inf(fi)
        m.params, o = m.optimizer.step(m.params, g, o, found_inf=fi)
        masters = m.params.replace_arenas(o["master"]).unpack()
        runs.append(dict(loss=float(loss), found_inf=bool(fi), grads=_np_tree(g.unpack()),
                         masters=_np_tree(masters)))
    return runs


def bert_lamb_fp32_step(params, grads, lamb_kw):
    """One fp32 ``FusedLAMB(**lamb_kw)`` step from ``params`` and ``grads``
    (this rank's shards under TP, with ``tensor_sharded`` from the BERT's
    specs), by the arena-native path (``MasterWeights`` over
    ``PackedParams``) and by the list path (``FusedLAMB.step`` on the
    trees): ``{"packed": masters, "list": params}`` as numpy trees."""
    from beforeholiday_tpu_torch.ops.arena import PackedParams
    from beforeholiday_tpu_torch.optimizers import FusedLAMB, MasterWeights

    opt = FusedLAMB(**lamb_kw)
    mw = MasterWeights(opt)
    model = PackedParams.pack(params)
    state = mw.init(model)
    model, state = mw.step(model, model.replace_arenas(PackedParams.pack(grads).arenas),
                           state)
    new_params, _ = opt.step(params, grads, opt.init(params))
    return {"packed": _np_tree(model.replace_arenas(state["master"]).unpack()),
            "list": _np_tree(new_params)}


def bert_tp_scenario(rank, world, cfg_kw, np_params, batch, o5_runs,
                     np_grads=None, lamb_kw=None):
    """(a) at tensor world 1: the TP forward against the dense forward, fp32
    and bf16, sequence parallel off and on; (b) at tp = 2, fp32: the loss
    and this rank's shard of the gradients of ``pretrain_loss``, sequence
    parallel off and on; (c) for each ``(label, tp (0: dense), sp, steps,
    lr)`` of ``o5_runs``: :func:`bert_o5_lamb_steps`; (d) with ``np_grads``:
    :func:`bert_lamb_fp32_step` on the dense tree and at tp = 2 on this
    rank's shards, ``tensor_sharded`` from the BERT's specs there."""
    from beforeholiday_tpu_torch.ops._autocast import cast_floats
    from beforeholiday_tpu_torch.parallel import parallel_state as ps
    from beforeholiday_tpu_torch.testing import bert

    params = bert.params_from_numpy(np_params, device="cpu")
    tok, tgt, mask, nsp, lens = batch
    batch = (_tensor(tok).long(), _tensor(tgt).long(), _tensor(mask),
             _tensor(nsp).long(), _tensor(lens))
    tok_t, lens_t = batch[0], batch[4]
    out = {}
    for dt in ("float32", "bfloat16"):
        p = cast_floats(params, getattr(torch, dt))
        dense = bert.forward(p, tok_t, bert.BertConfig(**cfg_kw, dtype=getattr(torch, dt)),
                             seq_lens=lens_t)
        for sp in (False, True):
            ps.initialize_model_parallel(1)
            cfg = bert.BertConfig(**cfg_kw, dtype=getattr(torch, dt), sequence_parallel=sp)
            got = bert.forward(p, tok_t, cfg, seq_lens=lens_t)
            ps.destroy_model_parallel()
            out[("world1", dt, sp)] = all(torch.equal(a, b) for a, b in zip(got, dense))
    ps.initialize_model_parallel(2)
    tr = ps.get_tensor_model_parallel_rank()
    for sp in (False, True):
        cfg = bert.BertConfig(**cfg_kw, sequence_parallel=sp)
        leaves, treedef = _flatten(bert.shard_params(params, cfg, tr, 2))
        leaves = [x.requires_grad_(True) for x in leaves]
        loss = bert.pretrain_loss(_unflatten(treedef, leaves), *batch[:4], cfg,
                                  seq_lens=lens_t)
        grads = torch.autograd.grad(loss, leaves)
        out[("tp2", sp)] = (float(loss), _np_tree(_unflatten(treedef, list(grads))))
    ps.destroy_model_parallel()
    for label, tsize, sp, steps, lr in o5_runs:
        cfg = bert.BertConfig(**cfg_kw, dtype=torch.bfloat16, sequence_parallel=sp)
        shard = params
        if tsize:
            ps.initialize_model_parallel(tsize)
            shard = bert.shard_params(params, cfg, ps.get_tensor_model_parallel_rank(),
                                      tsize)
        out[label] = bert_o5_lamb_steps(cfg, shard, batch, steps, lr)
        ps.destroy_model_parallel()
    if np_grads is not None:
        cfg = bert.BertConfig(**cfg_kw)
        grads = bert.params_from_numpy(np_grads, device="cpu")
        out[("lamb_fp32", 1)] = bert_lamb_fp32_step(params, grads, lamb_kw)
        ps.initialize_model_parallel(2)
        tr = ps.get_tensor_model_parallel_rank()
        out[("lamb_fp32", 2)] = bert_lamb_fp32_step(
            bert.shard_params(params, cfg, tr, 2), bert.shard_params(grads, cfg, tr, 2),
            dict(lamb_kw, tensor_sharded=bert.tensor_sharded(cfg)))
        ps.destroy_model_parallel()
    return out


# ------------------------------------------------------------ the monitor


def monitor_scenario(rank, world, losses, gvals, skips, durations):
    """``TrainMonitor.aggregate`` over the data group of this rank's
    metrics (its loss, grads, scale 2**skip and skip count), packed; and
    ``rank_skew`` of its duration with the comms ledger's records."""
    from beforeholiday_tpu_torch import monitor
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    ps.initialize_model_parallel(1)
    monitor.reset_comms_ledger()
    mon = monitor.TrainMonitor()
    m = mon.update(mon.init(device="cpu"), loss=torch.tensor(float(losses[rank])),
                   grads={"g": _tensor(gvals[rank])},
                   scaler_state={"scale": torch.tensor(2.0 ** float(skips[rank]))},
                   health={"skipped_total": torch.tensor(int(skips[rank]))})
    packed = _np(mon.pack(mon.aggregate(m, "data")))
    skew = {k: _np(v) for k, v in
            monitor.rank_skew(torch.tensor(float(durations[rank])), "data").items()}
    return packed, skew, monitor.comms_records()


# ------------------------------------------------------------------- ZeRO


def _ttree(np_tree, dtype=None):
    """A dict of numpy arrays as CPU tensors (``dtype`` casts)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in np_tree.items()}
    return out if dtype is None else {k: v.to(dtype) for k, v in out.items()}


def _nptree(tree):
    return {k: _np(v) for k, v in tree.items()}


def _rank_grads(g_np, rank):
    """This rank's row of a dict of rank-stacked (W, ...) arrays."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank])) for k, v in g_np.items()}


def _zero_records(prefix):
    from beforeholiday_tpu_torch.monitor import comms

    return sorted((r["site"], r["kind"], r["dtype"], r["calls"], r["bytes"],
                   r["logical_bytes"])
                  for r in comms.comms_records() if r["site"].startswith(prefix))


def _zero_opt(kind, kw):
    from beforeholiday_tpu_torch.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
        ZeRO3FusedAdam,
    )

    return {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB,
            "zero3": ZeRO3FusedAdam}[kind](**kw)


def _zero2_case(rank, world, case):
    """One ZeRO-2 case on this rank (see :func:`zero_scenario`)."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import bucketing

    kind = case["kind"]
    if kind == "scatter":
        x = torch.from_numpy(case["x"][rank])
        got = bucketing.bucketed_psum_scatter(
            x, "data", site="t.scatter", bucket_bytes=case["bucket_bytes"],
            compress=case["compress"], concat=case["concat"])
        return [_np(p) for p in got] if isinstance(got, list) else _np(got)
    if kind == "gather":
        s = torch.from_numpy(case["x"][rank])
        wire = getattr(torch, case.get("wire", "float32"))
        return _np(bucketing.bucketed_all_gather(
            s.to(wire), "data", site="t.gather", bucket_bytes=case["bucket_bytes"],
            logical_dtype=None if wire == torch.float32 else torch.float32).float())
    opt = _zero_opt(kind, case["kw"])
    p = _ttree(case["params"], getattr(torch, case.get("dtype", "float32")))
    state = opt.init(p)
    comms.reset_comms_ledger()
    out = {"steps": []}
    for i, g_np in enumerate(case["grads"]):
        p, state = opt.step(p, _rank_grads(g_np, rank), state)
        if i == 0:
            out["records"] = _zero_records(opt._site_prefix + ".")
        out["steps"].append(int(state["step"]))
        if case.get("resume_at") == i + 1:
            # save, rebuild the state from the checkpoint, go on from it
            sd = opt.state_dict(p, state)
            out["gathered"] = {k: (_nptree(v) if isinstance(v, dict) else _np(v))
                               for k, v in sd.items()}
            out["local"] = {k: _np(v) for k, v in
                            opt.state_dict(p, state, gather_on_root=False).items()}
            state = opt.load_state_dict(p, sd)
    out["params"] = _nptree(p)
    out["dtypes"] = {k: str(v.dtype) for k, v in p.items()}
    out["master"] = _nptree(opt.state_dict(p, state)["master"])
    return out


def zero_scenario(rank, world, cases):
    """ZeRO-2 cases for ``tests/test_torch_zero.py``, one world: each case
    a dict with ``kind`` ("scatter", "gather": the bucketed collectives on
    this rank's row of ``x``; "adam", "lamb": the optimizer from ``kw`` on
    ``params`` for the rank-stacked ``grads`` of each step, with the first
    step's ``zero2.*`` ledger and, at ``resume_at``, a state-dict round
    trip)."""
    return {name: _zero2_case(rank, world, case) for name, case in cases.items()}


def _vdot_loss(tree, grads):
    """Linear loss: each leaf's cotangent is exactly its ``grads`` entry."""
    return sum(torch.sum(tree[k].float() * g) for k, g in grads.items())


def _zero3_steps(opt, params, g_seq, rank, steps=None):
    from beforeholiday_tpu_torch.optimizers import zero3

    layout = zero3.layout_of(params)
    state = opt.init(params)
    for g_np in g_seq:
        grads = _rank_grads(g_np, rank)
        master = state["master"].detach().requires_grad_(True)
        opt.wrap_residency(lambda m: _vdot_loss(opt.gather_params(m, layout), grads))(
            master).backward()
        state = opt.step(master.grad, state)
        if steps is not None:
            steps.append(int(state["step"]))
    return layout, state


def _zero3_case(rank, world, case):
    """One ZeRO-3 case on this rank (see :func:`zero3_scenario`)."""
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.optimizers import DistributedFusedAdam, zero3

    kind = case["kind"]
    if kind == "gpt":
        return zero_gpt_o5_scenario(rank, world, *case["args"])
    params = _ttree(case["params"], getattr(torch, case.get("dtype", "float32")))
    if kind == "z3":
        comms.reset_comms_ledger()
        opt = _zero_opt("zero3", case["kw"])
        steps = []
        layout, state = _zero3_steps(opt, params, case["grads"], rank, steps)
        calls = {r[0]: r[3] for r in _zero_records("zero3.")}
        p = opt.gather_params(state["master"], layout)
        # the gathered state dict loads back to this rank's shards, bitwise
        back = opt.load_state_dict(layout, opt.state_dict(layout, state))
        roundtrip = all(torch.equal(back[k], state[k]) for k in state)
        out = dict(params=_nptree(p), master=_np(state["master"]), steps=steps,
                   roundtrip_bitwise=roundtrip,
                   calls=calls, exp_avg=_np(state["exp_avg"]),
                   local={k: _np(v) for k, v in
                          opt.state_dict(layout, state, gather_on_root=False).items()},
                   gathered=_nptree(opt.state_dict(layout, state)["master"]))
        if case.get("z2"):
            z2 = DistributedFusedAdam(**case["z2"])
            p2, s2 = params, z2.init(params)
            for g_np in case["grads"]:
                p2, s2 = z2.step(p2, _rank_grads(g_np, rank), s2)
            out["z2_params"], out["z2_master"] = _nptree(p2), _np(s2["master"])
        return out
    if kind == "refuse":
        opt = _zero_opt("zero3", case["kw"])
        state = opt.init(params)
        try:
            opt.step(_rank_grads(case["grads"][0], rank), state)
        except ValueError as e:
            return str(e)
        return None
    if kind == "load":
        # a checkpoint's shards for this world (one dict a rank) into fresh
        # state; then one more step from it
        opt = _zero_opt("zero3", case["kw"])
        layout = zero3.layout_of(params)
        state = opt.load_state_dict(layout, case["shards"][rank])
        gathered = _nptree(opt.state_dict(layout, state)["master"])
        grads = _rank_grads(case["grads"][0], rank)
        master = state["master"].detach().requires_grad_(True)
        _vdot_loss(opt.gather_params(master, layout), grads).backward()
        state2 = opt.step(master.grad, state)
        return dict(gathered=gathered, master=_np(state2["master"]),
                    step=int(state2["step"]))
    if kind == "guard":
        from beforeholiday_tpu_torch import guard as guard_mod
        from beforeholiday_tpu_torch.amp.scaler import LossScaler

        opt = _zero_opt("zero3", case["kw"])
        layout = zero3.layout_of(params)
        state = opt.init(params)
        g = guard_mod.StepGuard(LossScaler(**case["scaler"]), **case["guard"])
        gstate = g.init(state, device="cpu")
        for g_np, bad in zip(case["grads"], case["bad"]):
            grads = _rank_grads(g_np, rank)
            master = state["master"].detach().requires_grad_(True)
            _vdot_loss(opt.gather_params(master, layout), grads).backward()
            verdict = {"grad_overflow": torch.tensor(bool(bad)),
                       "loss_nonfinite": torch.tensor(False)}
            state, gstate = g.apply_sharded_update(opt, state, master.grad, gstate,
                                                   verdict)
        return dict(master=_nptree(opt.state_dict(layout, state)["master"]),
                    step=int(state["step"]), scale=float(gstate["scaler"]["scale"]),
                    health={k: int(v) for k, v in gstate["health"].items()})
    raise ValueError(kind)


def zero3_scenario(rank, world, cases):
    """ZeRO-3 cases for ``tests/test_torch_zero3.py``, one world: "z3" (the
    steps of the linear loss, with ``z2`` the ZeRO-2 run beside them),
    "refuse" (a step on an unscattered grad tree), "load" (a checkpoint's
    shards into fresh state, then a step), "guard" (guarded steps with the
    ``bad`` verdicts), "gpt" (:func:`zero_gpt_o5_scenario`)."""
    return {name: _zero3_case(rank, world, case) for name, case in cases.items()}


def zero_gpt_o5_scenario(rank, world, cfg_kw, np_params, tokens, targets, steps, lr):
    """The GPT's amp O5 step with ZeRO-2 (``DistributedFusedAdam`` on the
    arena-native params, the grads through ``scaled_value_and_grad``) and
    with ZeRO-3 (``ZeRO3FusedAdam``, prefetch 1, "keep" and "regather") on
    this rank's slice of the batch, as a user script builds them: each
    ZeRO-2 step's loss, this rank's grads and the gathered masters; whether
    each ZeRO-3 run's first step gave ZeRO-2's masters and model, bitwise."""
    from beforeholiday_tpu_torch import amp
    from beforeholiday_tpu_torch.ops.arena import tree_map
    from beforeholiday_tpu_torch.optimizers import (
        DistributedFusedAdam,
        ZeRO3FusedAdam,
        zero3,
    )
    from beforeholiday_tpu_torch.testing import gpt

    cfg = gpt.GPTConfig(**cfg_kw, dtype=torch.bfloat16)
    params = gpt.params_from_numpy(np_params, device="cpu")
    B = tokens.shape[0] // world
    tok = _tensor(tokens[rank * B:(rank + 1) * B]).long()
    tgt = _tensor(targets[rank * B:(rank + 1) * B]).long()
    m = amp.initialize(lambda p, t: gpt.forward(p, t, cfg), params, None, "O5",
                       arena_native=True)
    svag = amp.scaled_value_and_grad(
        lambda p, t, y: gpt.loss_fn(p, t, y, cfg, forward_fn=m.apply), m.scaler)
    opt = DistributedFusedAdam(lr=lr)
    cast = tree_map(lambda t: t.detach().clone(), m.params.unpack())  # bf16 kept
    state, sstate = opt.init(m.params), m.scaler.init(device="cpu")
    out = {"steps": []}
    for i in range(steps):
        loss, g, fi, sstate = svag(m.params, sstate, tok, tgt)
        m.params, state = opt.step(m.params, g, state, found_inf=fi)
        out["steps"].append(dict(
            loss=float(loss), found_inf=bool(fi), grads=_np_tree(g.unpack()),
            masters=_np_tree(opt.state_dict(m.params, state)["master"])))
        if i == 0:
            z2_model = _np_tree(m.params.unpack())
    # ZeRO-3's first step against ZeRO-2's
    for residency in ("keep", "regather"):
        z3 = ZeRO3FusedAdam(lr=lr, prefetch=1, param_residency=residency)
        layout = zero3.layout_of(cast)
        st = z3.init(cast)

        def loss3(master):
            p = z3.gather_params(master, layout)
            p = {**p, "blocks": {k: v.unbind(0) for k, v in p["blocks"].items()}}
            return gpt.loss_fn(p, tok, tgt, cfg, forward_fn=m.apply)

        master = st["master"].detach().requires_grad_(True)
        z3.wrap_residency(loss3)(master).backward()
        st = z3.step(master.grad, st)
        got = _np_tree(z3.state_dict(layout, st)["master"])
        model = _np_tree(z3.gather_params(st["master"], layout))
        same = all(np.array_equal(a, b) for a, b in zip(
            _flatten(got)[0], _flatten(out["steps"][0]["masters"])[0]))
        same_model = all(np.array_equal(a, b) for a, b in zip(
            _flatten(model)[0], _flatten(z2_model)[0]))
        out[f"zero3_{residency}_bitwise"] = bool(same and same_model)
    return out


# ------------------------------------------------------------ two-level DP


def _ms_flat_rank(mesh):
    return mesh.axis_index(("slice", "intra"))


def _ms_distinct(tree, r):
    """Each rank's own copy of a tree: ``x * (1 + 0.125 * flat rank)``, as
    the JAX tests make per-rank data inside ``shard_map``."""
    c = 1.0 + 0.125 * r
    return {k: v * c for k, v in tree.items()}


def _ms_tier_bytes(subsystem):
    from beforeholiday_tpu_torch.monitor import comms

    row = next((r for r in comms.comms_summary() if r["subsystem"] == subsystem),
               {"by_tier": {}})
    return {t: dict(v) for t, v in row["by_tier"].items()}


def _ms_vdot(params, grads):
    return sum(torch.sum(params[k] * grads[k]) for k in grads)


def _multislice_case(rank, world, mesh, case):
    """One case of :func:`multislice_scenario` on this rank."""
    from beforeholiday_tpu_torch import parallel
    from beforeholiday_tpu_torch.amp.frontend import differentiate
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.ops.arena import PackedParams
    from beforeholiday_tpu_torch.optimizers import DistributedFusedAdam, ZeRO3FusedAdam, zero3
    from beforeholiday_tpu_torch.parallel import bucketing, distributed, overlap

    AX = ("slice", "intra")
    r = _ms_flat_rank(mesh)
    kind = case["kind"]
    if kind == "reduce":
        g = _ms_distinct(_ttree(case["grads"]), r)
        out = {}
        for bb in case["bucket_bytes"]:
            flat = distributed.reduce_gradients(g, axis_name=AX, bucket_bytes=bb)
            hier = distributed.reduce_gradients(g, axis_name=AX, bucket_bytes=bb,
                                                hierarchical=True)
            out[bb] = (_nptree(flat), _nptree(hier))
        return out
    if kind == "packed_reduce":
        # the arena path of reduce_gradients on the packed grads
        g = PackedParams.pack(_ms_distinct(_ttree(case["grads"]), r))
        flat = distributed.reduce_gradients(g, axis_name=AX, bucket_bytes=case["bb"])
        hier = distributed.reduce_gradients(g, axis_name=AX, bucket_bytes=case["bb"],
                                            hierarchical=True)
        return ([_np(a) for a in flat.arenas], [_np(a) for a in hier.arenas])
    if kind == "overlap":
        p, g = _ttree(case["params"]), _ms_distinct(_ttree(case["grads"]), r)
        res = {}
        for name, kw in (("flat", {}), ("hier", dict(hierarchical=True,
                                                      overlap_backward=True))):
            ddp = distributed.DistributedDataParallel(axis_name=AX,
                                                      bucket_bytes=case["bb"], **kw)
            _, grads = ddp.value_and_grad(lambda pp: _ms_vdot(pp, g))(p)
            res[name] = _nptree(grads)
        # the arena hooks: grads born flat, each bucket's three legs issued
        # as its leaves land, finished in the engine's callback
        packed = PackedParams.pack(p)
        for name, hier in (("arena_flat", False), ("arena_hier", True)):
            def objective(pp, hier=hier):
                pp = overlap.reduction_hook(pp, axis_name=AX, bucket_bytes=case["bb"],
                                            hierarchical=hier)
                loss = _ms_vdot(pp.unpack(), g)
                return loss, loss
            _, grads = differentiate(objective, packed)
            res[name] = _nptree(grads.unpack())
        return res
    if kind == "zero2":
        p, g = _ttree(case["params"]), _ms_distinct(_ttree(case["grads"]), r)
        res = {}
        for name, kw in (("flat", {}), ("hier", dict(hierarchical=True))):
            opt = DistributedFusedAdam(lr=1e-2, weight_decay=0.02, axis_name=AX,
                                       bucket_bytes=case["bb"], **kw)
            pp, state = p, opt.init(p)
            for _ in range(2):
                pp, state = opt.step(pp, g, state)
            res[name] = dict(params=_nptree(pp), master=_np(state["master"]),
                             full=_nptree(opt.state_dict(pp, state)["master"]))
        # ZeRO-3 hierarchical, both residencies, against the above
        layout = zero3.layout_of(p)
        for residency in ("keep", "regather"):
            comms.reset_comms_ledger()
            z3 = ZeRO3FusedAdam(lr=1e-2, weight_decay=0.02, axis_name=AX,
                                bucket_bytes=case["bb"], hierarchical=True,
                                prefetch=1, param_residency=residency)
            state = z3.init(p)
            for _ in range(2):
                master = state["master"].detach().requires_grad_(True)
                z3.wrap_residency(lambda m: _ms_vdot(z3.gather_params(m, layout), g))(
                    master).backward()
                state = z3.step(master.grad, state)
            calls = {k: v["calls"] for k, v in _ms_tier_bytes("zero3").items()}
            res[f"z3_{residency}"] = dict(
                params=_nptree(z3.gather_params(state["master"], layout)),
                master=_np(state["master"]), calls=calls)
        return res
    if kind == "compress":
        x = _tensor(case["x"]) * (1.0 + 0.125 * r)
        exact = bucketing.bucketed_psum(x, AX, site="tms.exact", bucket_bytes=1024)
        sum_abs = bucketing.bucketed_psum(x.abs(), AX, site="tms.abs",
                                          bucket_bytes=1024)
        out = {}
        for ci, cd in case["combos"]:
            comp = bucketing.hierarchical_psum(x, AX, site="tms.comp", bucket_bytes=1024,
                                               compress_intra=ci, compress_dcn=cd)
            bound = bucketing.hierarchical_compression_error_bound(
                sum_abs, compress_intra=ci, compress_dcn=cd)
            out[(ci, cd)] = (_np(comp), _np(exact), _np(bound))
        return out
    if kind == "ledger":
        x = torch.zeros(case["n"])
        out = {}
        for name, fn in (
                ("flat", lambda a: bucketing.bucketed_psum(a, AX, site="tms.x",
                                                           bucket_bytes=case["bb"])),
                ("hier", lambda a: bucketing.hierarchical_psum(
                    a, AX, site="tms.x", bucket_bytes=case["bb"])),
                ("hier_cdcn", lambda a: bucketing.hierarchical_psum(
                    a, AX, site="tms.x", bucket_bytes=case["bb"], compress_dcn=True)),
                ("flat_rs", lambda a: bucketing.bucketed_psum_scatter(
                    a, AX, site="tms.x", bucket_bytes=case["bb"])),
                ("hier_rs", lambda a: bucketing.hierarchical_psum_scatter(
                    a, AX, site="tms.x", bucket_bytes=case["bb"])),
                ("flat_ag", lambda a: bucketing.bucketed_all_gather(
                    a[: a.shape[0] // world], AX, site="tms.x",
                    bucket_bytes=case["bb"])),
                ("hier_ag", lambda a: bucketing.hierarchical_all_gather(
                    a[: a.shape[0] // world], AX, site="tms.x",
                    bucket_bytes=case["bb"]))):
            comms.reset_comms_ledger()
            fn(x)
            out[name] = _ms_tier_bytes("tms")
        return out
    if kind == "tripwire":
        g = _ttree(case["grads"])
        out = {}
        for name, bad_rank in (("clean", None), ("perturbed", case["bad_rank"])):
            gg = {k: (v + 0.5 if r == bad_rank else v) for k, v in g.items()}
            _, mm = distributed.reduce_gradients(gg, axis_name=AX, hierarchical=True,
                                                 bucket_bytes=case["bb"],
                                                 check_consistency=True)
            out[name] = bool(mm)
        return out
    if kind == "collectives":
        # the ledger's collectives of the flat and the hierarchical reduce,
        # reduce-scatter and gather (a degenerate carve must emit the flat's)
        x = _tensor(case["x"]) * (1.0 + 0.125 * r)
        out = {}
        for name, fn in (
                ("psum", lambda hier: (bucketing.hierarchical_psum if hier else
                                       bucketing.bucketed_psum)(
                    x, AX, site="tms.c", bucket_bytes=1024)),
                ("psum_scatter", lambda hier: (
                    bucketing.hierarchical_psum_scatter if hier
                    else bucketing.bucketed_psum_scatter)(
                    x, AX, site="tms.c", bucket_bytes=1024)),
                ("all_gather", lambda hier: (
                    bucketing.hierarchical_all_gather if hier
                    else bucketing.bucketed_all_gather)(
                    x[: x.shape[0] // world], AX, site="tms.c", bucket_bytes=1024))):
            for hier in (False, True):
                comms.reset_comms_ledger()
                val = fn(hier)
                kinds = {}
                for rec in comms.comms_records():
                    kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + rec["calls"]
                out[(name, hier)] = (kinds, _np(val))
        return out
    if kind == "dcn_knob":
        x = _tensor(case["x"]) * (1.0 + 0.125 * r)
        out = {"flat": _np(bucketing.bucketed_psum(x, AX, site="tdcn.flat",
                                                   bucket_bytes=1024))}
        for dcn in case["dcn_bytes"]:
            comms.reset_comms_ledger()
            out[dcn] = (_np(bucketing.hierarchical_psum(
                x, AX, site="tdcn.hier", bucket_bytes=1024, bucket_bytes_dcn=dcn)),
                _ms_tier_bytes("tdcn").get("dcn"))
        comms.reset_comms_ledger()
        bucketing.hierarchical_psum(torch.zeros(1000), AX, site="tdf.follow",
                                    bucket_bytes=1024)
        out["follow"] = _ms_tier_bytes("tdf").get("dcn")
        pol = bucketing.BucketedReduce(axis_name=AX, hierarchical=True,
                                       bucket_bytes=1024, bucket_bytes_dcn=1 << 20)
        out["policy"] = _np(pol.psum(_tensor(case["x"][:300]), site="tdp.psum"))
        return out
    if kind == "mesh":
        groups = parallel.parallel_state.get_groups(AX)
        return dict(flat_rank=r, index=mesh.index, shape=mesh.shape,
                    sizes=[torch.distributed.get_world_size(g) for g in groups],
                    static=bucketing.static_axis_size(AX),
                    joint_rank=torch.distributed.get_rank(
                        parallel.parallel_state.get_group(AX)))
    raise ValueError(kind)


def multislice_scenario(rank, world, n_slices, slice_size, cases):
    """Two-level cases for ``tests/test_torch_multislice.py``: one
    ``make_two_level_mesh(n_slices, slice_size)`` over the world, entered,
    each case of ``cases`` on it (see :func:`_multislice_case`); then the
    mesh carvers' checks."""
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    mesh = ps.make_two_level_mesh(n_slices, slice_size)
    with mesh:
        out = {name: _multislice_case(rank, world, mesh, case)
               for name, case in cases.items()}
    errors = {}
    for name, call in (("zero_slices", lambda: ps.make_two_level_mesh(0)),
                       ("indivisible", lambda: ps.make_two_level_mesh(3)),
                       ("too_big", lambda: ps.make_two_level_mesh(world, 2))):
        try:
            call()
            errors[name] = None
        except (ValueError, RuntimeError) as e:
            errors[name] = type(e).__name__
    moe = ps.make_moe_mesh(data=min(world, 2), expert=max(world // 2, 1))
    ones = ps.make_moe_mesh()
    carved = ps.carve_data_mesh(max(world // 2, 1))
    with carved:
        if carved.index is not None:
            from beforeholiday_tpu_torch.monitor import comms

            s = comms.psum(torch.ones(1), "data", site="t.carved")
            carved_sum = float(s)
        else:
            carved_sum = None
    try:
        ps.carve_data_mesh(world + 1)
        errors["carve_too_big"] = None
    except ValueError:
        errors["carve_too_big"] = "ValueError"
    out["carvers"] = dict(errors=errors, moe_axes=moe.axis_names,
                          moe_shape=moe.shape, moe_index=moe.index,
                          ones_axes=ones.axis_names, ones_shape=ones.shape,
                          carved_index=carved.index, carved_sum=carved_sum)
    for m in (mesh, moe, ones, carved):
        m.destroy()
    return out


# ---------------------------------------------------- optimizer-in-backward


def _oib_loss(leaves, x, tgt):
    h = x
    for i in range(len(leaves) // 2):
        h = torch.tanh(h @ leaves[2 * i] + leaves[2 * i + 1])
    return torch.mean((h - tgt) ** 2)


def step_in_backward_scenario(rank, world, leaves_np, x_np, tgt_np, opts):
    """``tests/test_torch_step_in_backward.py``'s data-parallel step: the
    arena of ``leaves_np``, this rank's rows of ``x_np``/``tgt_np``; for each
    optimizer of ``opts`` (name -> (kind, kwargs)) the hooked backward plus
    ``step_in_backward``, the post-backward ``reduce_gradients`` plus the
    view-path ``step_flat``, and the same grads packed into an arena plus
    the arena ``step_flat``."""
    from beforeholiday_tpu_torch.ops.arena import flatten, unflatten
    from beforeholiday_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
    from beforeholiday_tpu_torch.parallel import distributed, overlap

    leaves = [_tensor(a) for a in leaves_np]
    x, tgt = _tensor(x_np[rank: rank + 1]), _tensor(tgt_np[rank: rank + 1])
    make = {"adam": FusedAdam, "sgd": FusedSGD, "lamb": FusedLAMB}

    def grads(flat, spec, hooked):
        lv = [v.detach().requires_grad_(True) for v in unflatten(flat, spec)]
        use = overlap.hook_tree(list(lv), tag="oib", axis_name="data") if hooked else lv
        return list(torch.autograd.grad(_oib_loss(use, x, tgt), lv))

    out = {}
    for name, (kind, kw) in opts.items():
        res = {}
        for path in ("hooked", "phased", "arena"):
            flat, spec = flatten(leaves)
            opt = make[kind](**kw)
            state = opt.init_flat(flat)
            try:
                if path == "hooked":
                    flat, state, flag = opt.step_in_backward(
                        flat, grads(flat, spec, True), state, spec=spec)
                    res["flag"] = bool(flag)
                else:
                    g = distributed.reduce_gradients(grads(flat, spec, False),
                                                     axis_name="data")
                    if path == "arena":
                        g = flatten(g)[0]
                    flat, state = opt.step_flat(flat, g, state, spec=spec)
            except NotImplementedError as e:
                res[path] = str(e)
                continue
            res[path] = dict(flat=_np(flat), state={k: _np(v) for k, v in state.items()})
        out[name] = res
    return out


# -------------------------------------------------------- mixture of experts


def _moe_grads(layer, x, w, params):
    """``layer``'s output and aux, and the gradients of ``sum(y^2) + aux + z``
    w.r.t. (x, the router, the experts)."""
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    y, aux = layer(x, w, params)
    (y.float().square().sum() + aux["moe_aux_loss"] + aux["moe_z_loss"]).backward()
    return dict(y=_np(y), aux={k: float(v) for k, v in aux.items()}, dx=_np(x.grad),
                dw=_np(w.grad), dp={k: _np(v.grad) for k, v in params.items()})


def _moe_ledger():
    from beforeholiday_tpu_torch.monitor import comms

    return [r for r in comms.comms_records() if r["site"].startswith("moe.")]


def _moe_case(rank, world, case):
    """One case of :func:`moe_scenario` on this rank."""
    from beforeholiday_tpu_torch import moe
    from beforeholiday_tpu_torch.monitor import comms
    from beforeholiday_tpu_torch.parallel import parallel_state as ps

    kind = case["kind"]
    if kind == "a2a":
        # the differentiable tiled exchange and its inverse, forward and
        # backward, on this rank's block
        mesh = ps.make_moe_mesh(expert=world)
        out = {}
        with mesh:
            for name, (s, c) in (("fwd", (0, 1)), ("inv", (1, 0))):
                x = _tensor(case["x"][name][rank]).requires_grad_(True)
                comms.reset_comms_ledger()
                y = comms.all_to_all_differentiable(x, "expert", s, c, site="t.a2a")
                y.backward(_tensor(case["ct"][name][rank]))
                out[name] = (_np(y), _np(x.grad), comms.comms_records())
        mesh.destroy()
        return out
    cfg = moe.MoEConfig(**case["cfg"])
    w = _tensor(case["w"])
    full = {k: _tensor(v) for k, v in case["params"].items()}
    T = case["T"]
    if kind in ("ep", "ep_tp"):
        ep, tp = case["ep"], case.get("tp", 1)
        mesh = ps.make_moe_mesh(expert=ep, tensor=tp)
        with mesh:
            e = mesh.axis_index("expert")
            t = mesh.axis_index("tensor") if tp > 1 else 0
            n = cfg.n_experts // ep
            local = {k: v[e * n:(e + 1) * n] for k, v in full.items()}
            if tp > 1:
                f = full["wi"].shape[-1] // tp
                cut = slice(t * f, (t + 1) * f)
                local = {"wi": local["wi"][:, :, cut], "bi": local["bi"][:, cut],
                         "wo": local["wo"][:, cut, :], "bo": local["bo"]}
            x = _tensor(case["x"][e * T:(e + 1) * T])
            C = cfg.capacity(T)
            comms.reset_comms_ledger()
            dist_res = _moe_grads(lambda xx, ww, pp: moe.moe_layer(
                xx, ww, pp, cfg, expert_axis="expert", capacity=C,
                tensor_axis="tensor" if tp > 1 else None), x, w, local)
            dist_res["ledger"] = _moe_ledger()
        mesh.destroy()
        # the same group with every expert here, as one process computes it
        here = _moe_grads(lambda xx, ww, pp: moe.moe_layer(
            xx, ww, pp, cfg, capacity=C, emulate_tensor=tp), x, w, full)
        return dict(dist=dist_res, local=here, expert_rank=e, tensor_rank=t)
    if kind == "hier":
        mesh = ps.make_two_level_mesh(2, world // 2)
        ax = ("slice", "intra")
        with mesh:
            r = mesh.axis_index(ax)
            n = cfg.n_experts // world
            local = {k: v[r * n:(r + 1) * n] for k, v in full.items()}
            x = _tensor(case["x"][r * T:(r + 1) * T])
            C = cfg.capacity(T)
            out = {"group": r}
            for name, hier in (("joint", False), ("hier", True)):
                comms.reset_comms_ledger()
                out[name] = _moe_grads(lambda xx, ww, pp: moe.moe_layer(
                    xx, ww, pp, cfg, expert_axis=ax, capacity=C, hierarchical=hier),
                    x, w, local)
                out[name]["ledger"] = _moe_ledger()
        mesh.destroy()
        return out
    raise ValueError(kind)


def moe_example_case(rank, world, spec):
    """The ported ``moe_gpt`` example's :func:`train` on this rank."""
    from beforeholiday_tpu_torch.examples.simple.distributed import moe_gpt

    return moe_gpt.train(dict(spec, device="cpu"))


def moe_scenario(rank, world, cases):
    """``tests/test_torch_moe_parallel.py``'s cases in one world: each of
    ``cases`` (name -> case) on its own mesh (see :func:`_moe_case`; the
    example's carves through :func:`moe_example_case`)."""
    return {name: (moe_example_case(rank, world, case["spec"])
                   if case["kind"] == "example" else _moe_case(rank, world, case))
            for name, case in cases.items()}
