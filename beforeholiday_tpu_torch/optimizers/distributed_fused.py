"""ZeRO-2 sharded fused optimizers — counterpart of
``beforeholiday_tpu/optimizers/distributed_fused.py`` (Apex's
``DistributedFusedAdam`` and ``DistributedFusedLAMB``).

The params flatten into one fp32 arena padded so that every data-parallel
rank owns an equal, TILE-aligned shard::

    g_shard = reduce_scatter(grad_arena) / world    (bucketed, async works)
    state   = {master, m, v} fp32, shard-sized      (1/world of the memory)
    update  = K6 (Adam) or K7-K9 (LAMB) on the shard, in place
    params  = all_gather(master_shard) cast to each leaf's dtype

As the JAX module: the grads are each rank's local, unreduced ones; the
step scales the reduced shard by ``grad_scale`` (K5, which also gives the
shard's non-finite flag, in that order: reduce-scatter first, then scale),
one ``pmax`` makes the flag global, and a flagged step leaves masters,
moments and the step count bitwise as they were. Every collective goes
through ``monitor.comms`` under the ``zero2.*`` sites (``zero3.*`` for the
ZeRO-3 subclass), issued ``async_op`` and waited in stream order, so the
host never waits on the card.

Two things differ from the JAX module, both forced by eager PyTorch. The
state is updated IN PLACE (the port's optimizers all do; the returned state
holds the same tensors). And the arena's order follows what ``init`` was
given: a tree is flattened in tree order, as JAX does it; a
``PackedParams`` (``amp.initialize(..., arena_native=True)``) keeps its
packed order, arena after arena, so the born-flat gradient arenas of the
same layout become the reduce-scatter operand with one cast copy each and
no per-leaf flatten, and the gathered params land straight in the model
arenas. The checkpoints (:meth:`_DistributedFused.state_dict`) are trees
shaped like the params either way.

``hierarchical=True`` (a ``(slice, intra)`` ``axis_name``, inside the
two-level mesh) reduce-scatters the gradients and all-gathers the params
through the two-level engines (``bucketing.hierarchical_psum_scatter``,
``hierarchical_all_gather``): only 1/slice_size of the arena crosses DCN
each way, shard ownership is the flat path's, and uncompressed the step is
bitwise the flat step over the same spec wherever each tier's sum is.
``compress_intra``/``compress_dcn`` compress each tier (``None`` takes
``compress``); any tier compression puts ``wire_dtype`` on both gather
legs, the masters staying fp32. ``tuned=True`` resolves the knobs from the
tuning manifest as ``tune.resolve_trainer_knobs`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.ops import multi_tensor as mt
from beforeholiday_tpu_torch.ops._dispatch import resolve_impl
from beforeholiday_tpu_torch.ops.arena import (
    TILE,
    ArenaShard,
    ArenaSpec,
    PackedLayout,
    PackedParams,
    make_spec,
    tree_flatten,
    tree_unflatten,
    unflatten,
)
from beforeholiday_tpu_torch.parallel import bucketing
from beforeholiday_tpu_torch.parallel.parallel_state import (
    DATA_AXIS,
    get_group,
    hierarchical_axes,
)
from beforeholiday_tpu_torch.tune import UNSET, resolve_trainer_knobs

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB"]

def _shard_len(total_padded: int, world: int) -> int:
    """Per-rank arena shard, TILE-aligned so the kernels' blocks tile it."""
    per = -(-total_padded // world)
    return -(-per // TILE) * TILE


def _pad_to(flat: torch.Tensor, n: int) -> torch.Tensor:
    if flat.shape[0] == n:
        return flat
    return torch.cat([flat, flat.new_zeros(n - flat.shape[0])])


@dataclasses.dataclass(frozen=True)
class ZeroLayout:
    """How a params object maps onto the sharded fp32 arena: the arena's
    tensors in arena order (``spec``), each one's leaf index in tree order
    (``order``), the tree's definition, the leaf dtypes in tree order, and
    the packed layout when the params came as a ``PackedParams``."""

    spec: ArenaSpec
    order: Tuple[int, ...]
    treedef: Any
    dtypes: Tuple[torch.dtype, ...]
    packed: Optional[PackedLayout] = None

    @property
    def bases(self) -> Tuple[int, ...]:
        """Packed layouts: each arena's first element in the ZeRO arena."""
        out, off = [], 0
        for spec in self.packed.specs:
            out.append(off)
            off += spec.total
        return tuple(out)


@functools.lru_cache(maxsize=64)
def _packed_layout(packed: PackedLayout) -> ZeroLayout:
    order = tuple(i for idx in packed.indices for i in idx)
    shapes = [s for spec in packed.specs for s in spec.shapes]
    dtypes: List[Any] = [None] * packed.n_leaves
    for dt, idx in zip(packed.dtypes, packed.indices):
        for i in idx:
            dtypes[i] = dt
    return ZeroLayout(make_spec(shapes), order, packed.treedef, tuple(dtypes),
                      packed)


def layout_of_params(params) -> ZeroLayout:
    """The :class:`ZeroLayout` of a params tree (tree order) or of a
    ``PackedParams`` (packed order)."""
    if isinstance(params, PackedParams):
        return _packed_layout(params.layout)
    leaves, treedef = tree_flatten(params)
    return ZeroLayout(make_spec(leaves), tuple(range(len(leaves))), treedef,
                      tuple(leaf.dtype for leaf in leaves))


class _DistributedFused:
    """Shared arena and collective machinery for the sharded optimizers."""

    # comms-ledger site prefix; ``comms_summary`` rolls sites up by it
    _site_prefix = "zero2"

    def __init__(self, *, axis_name: Any = DATA_AXIS, grad_average: bool = True,
                 bucket_bytes: Any = UNSET, compress: Any = UNSET,
                 wire_dtype: Any = torch.bfloat16, overlap_backward: Any = UNSET,
                 hierarchical: Any = UNSET, compress_intra: Optional[bool] = None,
                 compress_dcn: Optional[bool] = None, tuned: bool = False,
                 tuning_key: Any = None, tuning_manifest: Any = None):
        knobs = resolve_trainer_knobs(
            self._site_prefix,
            {"bucket_bytes": None, "compress": False, "overlap_backward": False,
             "hierarchical": False},
            {"bucket_bytes": bucket_bytes, "compress": compress,
             "overlap_backward": overlap_backward, "hierarchical": hierarchical},
            tuned=tuned, tuning_key=tuning_key, manifest=tuning_manifest,
            context={"two_level": hierarchical_axes(axis_name) is not None})
        if knobs["hierarchical"] and hierarchical_axes(axis_name) is None:
            raise ValueError(
                "hierarchical=True needs a (slice, intra) axis spec; got "
                f"{axis_name!r}")
        self.axis_name = axis_name
        self.grad_average = grad_average
        self.bucket_bytes = knobs["bucket_bytes"]
        self.compress = bool(knobs["compress"])
        self.wire_dtype = wire_dtype
        self.overlap_backward = bool(knobs["overlap_backward"])
        self.hierarchical = bool(knobs["hierarchical"])
        self.compress_intra = compress_intra
        self.compress_dcn = compress_dcn

    def _tier_compress(self) -> Tuple[bool, bool]:
        """``(compress_intra, compress_dcn)``, each ``compress`` when unset."""
        ci = self.compress if self.compress_intra is None else self.compress_intra
        cd = self.compress if self.compress_dcn is None else self.compress_dcn
        return bool(ci), bool(cd)

    # ---- geometry ----------------------------------------------------------

    def _world(self) -> int:
        return bucketing.static_axis_size(self.axis_name)

    def _rank(self) -> int:
        return dist.get_rank(get_group(self.axis_name))

    def _shard(self, spec: ArenaSpec) -> int:
        return _shard_len(spec.padded_total, self._world())

    def _full_arena(self, params, lay: ZeroLayout) -> torch.Tensor:
        """``params`` (a tree or a PackedParams of ``lay``) as the fp32
        ``(shard * world,)`` arena in ``lay``'s order, padding zero."""
        shard = self._shard(lay.spec)
        world = self._world()
        if isinstance(params, PackedParams) and lay.packed is not None \
                and params.layout == lay.packed:
            device = params.arenas[0].device
            flat = torch.empty(shard * world, dtype=torch.float32, device=device)
            for arena, spec, base in zip(params.arenas, lay.packed.specs, lay.bases):
                # one cast copy an arena: the born-flat arena is the operand
                flat[base: base + spec.total].copy_(arena[: spec.total])
            flat[lay.spec.total:].zero_()
            return flat
        if isinstance(params, PackedParams):
            if len(params.arenas) == 1 and params.layout.indices[0] == tuple(
                    range(params.layout.n_leaves)) \
                    and params.layout.specs[0].shapes == lay.spec.shapes:
                return _pad_to(params.arenas[0].float(), shard * world)
            params = params.unpack()
        leaves = tree_flatten(params)[0]
        device = leaves[0].device
        flat = torch.zeros(shard * world, dtype=torch.float32, device=device)
        for j, (off, shape) in enumerate(zip(lay.spec.offsets, lay.spec.shapes)):
            flat[off: off + math.prod(shape)].copy_(leaves[lay.order[j]].reshape(-1))
        return flat

    def _shard_of(self, params, lay: ZeroLayout) -> torch.Tensor:
        """THIS rank's fp32 shard of ``params`` (a new tensor)."""
        shard = self._shard(lay.spec)
        rank = self._rank()
        return self._full_arena(params, lay)[rank * shard: (rank + 1) * shard].clone()

    def _tree_of_arena(self, full: torch.Tensor, lay: ZeroLayout, dtypes=None):
        """The tree, shaped like the params, of views of ``full`` (copies
        where ``dtypes``, one per leaf in tree order, casts)."""
        pieces = unflatten(full, lay.spec)
        leaves: List[Any] = [None] * len(lay.order)
        for j, i in enumerate(lay.order):
            leaves[i] = pieces[j] if dtypes is None else pieces[j].to(dtypes[i])
        return tree_unflatten(lay.treedef, leaves)

    def _gather_full(self, shard_arr: torch.Tensor) -> torch.Tensor:
        """All-gather a state shard back into the full arena."""
        full, work = comms.all_gather(shard_arr, self.axis_name,
                                      site=f"{self._site_prefix}.gather_state",
                                      axis=0, tiled=True, async_op=True)
        work.wait()
        return full

    # ---- state -------------------------------------------------------------

    def init(self, params):
        """This rank's fp32 state shard: the masters (from ``params``, a
        tree or a PackedParams) and zero moments, and a device step count."""
        lay = layout_of_params(params)
        master = self._shard_of(params, lay)
        state = {"master": master,
                 "step": torch.zeros((), dtype=torch.int32, device=master.device)}
        for key in self._state_keys():
            state[key] = torch.zeros_like(master)
        return state

    def _reduce_scatter_grads(self, grads, lay: ZeroLayout, *, concat=True):
        """This rank's fp32 grad shard (or its per-bucket pieces), the sum
        over ranks divided by the world when ``grad_average``."""
        gflat = self._full_arena(grads, lay)
        site = f"{self._site_prefix}.reduce_scatter_grads"
        world = self._world()
        if self.hierarchical:
            ci, cd = self._tier_compress()
            # the legs of each bucket wait on each other: the pieces come
            # back reduced, as entries with nothing left to wait on
            entries = [(piece, bucketing._DONE, True)
                       for piece in bucketing.hierarchical_psum_scatter(
                           gflat, hierarchical_axes(self.axis_name), site=site,
                           bucket_bytes=self.bucket_bytes, compress_intra=ci,
                           compress_dcn=cd, wire_dtype=self.wire_dtype,
                           concat=False)]
        else:
            entries = bucketing.issue_psum_scatter(
                gflat, self.axis_name, site=site, bucket_bytes=self.bucket_bytes,
                compress=self.compress, wire_dtype=self.wire_dtype)
        if not concat:
            return entries
        pieces = [bucketing.finish_bucket(e, torch.float32) for e in entries]
        g = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        if self.grad_average and world > 1:
            g = g / world
        return g

    def _scaled(self, g: torch.Tensor, grad_scale):
        """``(g * grad_scale, local non-finite flag)`` in one K5 pass."""
        impl = resolve_impl(getattr(self, "impl", None), g, op="multi_tensor_scale")
        fn = mt.scale_kernel if impl == "kernel" else mt.scale_torch
        return fn(g, grad_scale, torch.float32)

    def _global_found_inf(self, local_bad, found_inf):
        flag = local_bad.reshape(()) != 0
        if found_inf is not None:
            flag = flag | (torch.as_tensor(found_inf).to(flag.device).reshape(()) != 0)
        return comms.pmax(flag.float(), self.axis_name,
                          site=f"{self._site_prefix}.found_inf") != 0

    def _gather_params(self, master_shard, params, lay: ZeroLayout):
        """The updated params from the master shard: a PackedParams' arenas
        are written in place (and ``params`` returned); a tree comes back as
        a new tree of the leaves' dtypes."""
        if self.hierarchical:
            # each rank ships only its shard over the slice (DCN) tier; any
            # tier compression puts wire_dtype on both legs
            wire, logical = master_shard, None
            if any(self._tier_compress()):
                wire, logical = master_shard.to(self.wire_dtype), master_shard.dtype
            full = bucketing.hierarchical_all_gather(
                wire, hierarchical_axes(self.axis_name),
                site=f"{self._site_prefix}.gather_params",
                bucket_bytes=self.bucket_bytes, logical_dtype=logical)
        elif self.bucket_bytes is None and not self.compress:
            full = self._gather_full(master_shard)
        else:
            wire, logical = master_shard, None
            if self.compress:
                # the masters stay fp32: the wire rounding reaches only the
                # model copy, as MasterWeights' low-precision params
                wire, logical = master_shard.to(self.wire_dtype), master_shard.dtype
            full = bucketing.bucketed_all_gather(
                wire, self.axis_name, site=f"{self._site_prefix}.gather_params",
                bucket_bytes=self.bucket_bytes, logical_dtype=logical)
        if isinstance(params, PackedParams) and lay.packed is not None \
                and params.layout == lay.packed:
            for arena, spec, base in zip(params.arenas, lay.packed.specs, lay.bases):
                arena[: spec.total].copy_(full[base: base + spec.total])
            return params
        return self._tree_of_arena(full, lay, lay.dtypes)

    def _split(self, t: torch.Tensor):
        """``t`` (a shard) cut into the overlap path's bucket slices."""
        slices = bucketing.bucket_slices(t.shape[0], 4 * self._world(),
                                         self.bucket_bytes)
        return [t[o: o + n] for o, n in slices]

    # ---- checkpointing (ref: distributed_fused_adam.py state_dict with
    # gather_on_root, load_state_dict) -------------------------------------

    def state_dict(self, params, state, *, gather_on_root: bool = True):
        """Checkpointable state. ``gather_on_root=True`` all-gathers each
        state shard into full fp32 trees shaped like ``params`` (the same on
        every rank); ``False`` returns this rank's shard as it is."""
        if not gather_on_root:
            return dict(state)
        lay = layout_of_params(params)
        out = {"step": state["step"]}
        for key in ("master",) + self._state_keys():
            out[key] = self._tree_of_arena(self._gather_full(state[key]), lay,
                                           (torch.float32,) * len(lay.order))
        return out

    def load_state_dict(self, params, state_dict):
        """Inverse of ``state_dict(gather_on_root=True)``: the full trees
        re-sharded onto this rank."""
        lay = layout_of_params(params)
        state = {"step": torch.as_tensor(state_dict["step"]).to(torch.int32)}
        for key in ("master",) + self._state_keys():
            tree_lay = layout_of_params(state_dict[key])
            if tree_lay.spec.shapes != tuple(lay.spec.shapes[lay.order.index(i)]
                                             for i in range(len(lay.order))):
                raise ValueError(f"state_dict[{key!r}] is not shaped like the params")
            state[key] = self._shard_of(state_dict[key], lay)
        state["step"] = state["step"].to(state["master"].device)
        return state


class DistributedFusedAdam(_DistributedFused):
    """ZeRO-2 AdamW on K6 (ref: apex/contrib/optimizers/distributed_fused_adam.py)::

        opt = DistributedFusedAdam(lr=1e-4)
        state = opt.init(params)            # a tree or a PackedParams
        params, state = opt.step(params, grads, state, found_inf=fi)

    ``grads`` are this rank's local grads (a tree, or a PackedParams of the
    params' layout). ``overlap_backward`` reduce-scatters bucket by bucket
    and runs K5 and K6 on each bucket's slice as it lands: bitwise the
    phased step."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, *, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 axis_name: Any = DATA_AXIS, grad_average: bool = True,
                 bucket_bytes: Any = UNSET, compress: Any = UNSET,
                 wire_dtype: Any = torch.bfloat16, overlap_backward: Any = UNSET,
                 hierarchical: Any = UNSET, compress_intra: Optional[bool] = None,
                 compress_dcn: Optional[bool] = None, impl: Optional[str] = None,
                 tuned: bool = False, tuning_key: Any = None,
                 tuning_manifest: Any = None):
        super().__init__(
            axis_name=axis_name, grad_average=grad_average,
            bucket_bytes=bucket_bytes, compress=compress, wire_dtype=wire_dtype,
            overlap_backward=overlap_backward, hierarchical=hierarchical,
            compress_intra=compress_intra, compress_dcn=compress_dcn,
            tuned=tuned, tuning_key=tuning_key, tuning_manifest=tuning_manifest)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.impl = impl

    def _state_keys(self):
        return ("exp_avg", "exp_avg_sq")

    def _adam(self, g, master, m, v, step_no, flag, lr):
        mt.adam_flat(g, master, m, v, lr=lr, beta1=self.betas[0],
                     beta2=self.betas[1], eps=self.eps, step=step_no,
                     adam_w_mode=self.adam_w_mode,
                     bias_correction=self.bias_correction,
                     weight_decay=self.weight_decay, found_inf=flag,
                     impl=self.impl)

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0,
             lr=None):
        lr = self.lr if lr is None else lr
        lay = layout_of_params(params)
        if self.overlap_backward:
            return self._step_overlap(params, grads, state, lay=lay,
                                      found_inf=found_inf, grad_scale=grad_scale,
                                      lr=lr)
        g, local_bad = self._scaled(self._reduce_scatter_grads(grads, lay),
                                    grad_scale)
        flag = self._global_found_inf(local_bad, found_inf)
        step_no = torch.where(flag, state["step"], state["step"] + 1)
        self._adam(g, state["master"], state["exp_avg"], state["exp_avg_sq"],
                   step_no, flag, lr)
        new_params = self._gather_params(state["master"], params, lay)
        return new_params, {**state, "step": step_no}

    def _step_overlap(self, params, grads, state, *, lay, found_inf, grad_scale, lr):
        """Reduce-scatter-then-update per bucket: every bucket's
        reduce-scatter is issued first; each is scaled (K5, its flag) as it
        lands; the flags fold into ONE pmax (a single overflowing bucket
        still skips the whole step on every rank); then K6 runs on each
        bucket's slice of the master and moment shards. Bitwise the phased
        step: K5 and K6 are elementwise, so slicing commutes with them."""
        world = self._world()
        chunks, bad = [], None
        for entry in self._reduce_scatter_grads(grads, lay, concat=False):
            c = bucketing.finish_bucket(entry, torch.float32)
            if self.grad_average and world > 1:
                c = c / world
            c, b = self._scaled(c, grad_scale)
            chunks.append(c)
            bad = b if bad is None else bad | b
        flag = self._global_found_inf(bad, found_inf)
        step_no = torch.where(flag, state["step"], state["step"] + 1)
        masters = self._split(state["master"])
        ms = self._split(state["exp_avg"])
        vs = self._split(state["exp_avg_sq"])
        assert len(masters) == len(chunks)
        for c, p, m, v in zip(chunks, masters, ms, vs):
            self._adam(c, p, m, v, step_no, flag, lr)
        new_params = self._gather_params(state["master"], params, lay)
        return new_params, {**state, "step": step_no}


class DistributedFusedLAMB(_DistributedFused):
    """ZeRO-sharded LAMB on K5, K7, K8 and K9 (ref:
    apex/contrib/optimizers/distributed_fused_lamb.py). The clip norm is the
    sum over ranks of each shard's sum of squares (K9; its fixed summation
    order is not ``jnp.sum``'s); the trust ratios' per-tensor norms are the
    shard's per-tensor partial sums (one dot product per piece of a tensor
    the shard holds) summed over the data group, indexed by the global
    tensor ids, and K8 runs on the shard's own tables."""

    def __init__(self, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, *, weight_decay: float = 0.01,
                 bias_correction: bool = True, grad_averaging: bool = True,
                 adam_w_mode: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, axis_name: Any = DATA_AXIS,
                 grad_average: bool = True, bucket_bytes: Optional[int] = None,
                 compress: bool = False, wire_dtype: Any = torch.bfloat16,
                 overlap_backward: bool = False, hierarchical: bool = False,
                 compress_intra: Optional[bool] = None,
                 compress_dcn: Optional[bool] = None, impl: Optional[str] = None):
        if overlap_backward:
            # the trust ratios need per-tensor norms over the whole shard
            # before any slice can update: a whole-shard barrier
            raise NotImplementedError(
                "DistributedFusedLAMB does not support overlap_backward: the "
                "sharded-norm reduction is a whole-shard barrier; use "
                "DistributedFusedAdam or the phased LAMB step")
        super().__init__(
            axis_name=axis_name, grad_average=grad_average,
            bucket_bytes=bucket_bytes, compress=compress, wire_dtype=wire_dtype,
            hierarchical=hierarchical, compress_intra=compress_intra,
            compress_dcn=compress_dcn)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.grad_averaging = grad_averaging
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.impl = impl

    def _state_keys(self):
        return ("exp_avg", "exp_avg_sq")

    def step(self, params, grads, state, *, found_inf=None, grad_scale=1.0,
             lr=None):
        lr = self.lr if lr is None else lr
        lay = layout_of_params(params)
        seg = ArenaShard(lay.spec, self._rank(), self._shard(lay.spec))
        g, local_bad = self._scaled(self._reduce_scatter_grads(grads, lay),
                                    grad_scale)
        flag = self._global_found_inf(local_bad, found_inf)
        step_no = torch.where(flag, state["step"], state["step"] + 1)
        # the global grad norm for clipping (ref: fused_lamb's l2norm)
        sq, _ = mt.l2norm_sq(g, impl=self.impl)
        gnorm = torch.sqrt(comms.psum(sq, self.axis_name, site="zero2.lamb_gnorm"))
        mt.lamb_flat(
            g, state["master"], state["exp_avg"], state["exp_avg_sq"], lay.spec,
            lr=lr, beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            step=step_no, bias_correction=self.bias_correction,
            weight_decay=self.weight_decay, grad_averaging=self.grad_averaging,
            mode=1 if self.adam_w_mode else 0, global_grad_norm=gnorm,
            max_grad_norm=self.max_grad_norm, use_nvlamb=self.use_nvlamb,
            found_inf=flag, impl=self.impl,
            _sharded_norms=(seg, lay.spec.num_tensors, self.axis_name))
        new_params = self._gather_params(state["master"], params, lay)
        return new_params, {**state, "step": step_no}
