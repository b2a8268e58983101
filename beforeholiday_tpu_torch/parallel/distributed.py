"""Data-parallel gradient reduction — counterpart of
``beforeholiday_tpu/parallel/distributed.py`` (``reduce_gradients``,
``Reducer``, ``DistributedDataParallel``).

The JAX package reduces with ``psum`` inside ``shard_map``; here each rank
is a process and the reduction is ``torch.distributed`` over the group the
``axis_name`` names (``parallel_state.get_group``: the ``WORLD`` group
until model parallelism is initialized), NCCL on the card and gloo on the
CPU. The reference's knobs keep their meaning:

* ``gradient_average``          — divide by the world size after the reduce;
* ``gradient_predivide_factor`` — divide by f before, world / f after;
* ``allreduce_always_fp32``     — reduce in fp32, cast back;
* ``bucket_bytes`` / ``compress`` — ``parallel.bucketing``'s bucketed and
  wire-compressed all-reduces (a :class:`PackedParams` gradient reduces
  its flat arenas directly, any other tree goes through
  ``bucketed_tree_psum``);
* ``overlap_backward`` — ``parallel.overlap``'s backward-time hooks.

Every collective is issued ``async_op=True`` and waited before its result
is read; on NCCL that wait is a stream wait, so a reduction adds no host
sync. At world size 1 the collectives are issued all the same.

``hierarchical=True`` (a ``(slice, intra)`` ``axis_name``, the axes of
``parallel_state.make_two_level_mesh``, inside ``with mesh:``) reduces each
bucket with ``bucketing.hierarchical_psum``: the DCN tier carries
1/slice_size of the flat bytes, and uncompressed the result is bitwise the
flat bucketed reduce over the same spec wherever each tier's sum is (see
``bucketing``). ``compress_intra``/``compress_dcn`` compress each tier
(``None`` takes ``compress``), within
``bucketing.hierarchical_compression_error_bound``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.monitor.spans import span
from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten, tree_map
from beforeholiday_tpu_torch.parallel import overlap
from beforeholiday_tpu_torch.parallel.parallel_state import (
    DATA_AXIS,
    get_group,
    hierarchical_axes,
)
from beforeholiday_tpu_torch.tune import UNSET, resolve_trainer_knobs

def _check_hierarchical(hierarchical, axis_name):
    if hierarchical and hierarchical_axes(axis_name) is None:
        raise ValueError(
            f"hierarchical=True needs a (slice, intra) axis spec; got {axis_name!r}")


def _grad_fingerprint(grads: Any) -> torch.Tensor:
    """Per-leaf fp32 (sum, sum of squares), concatenated: identical local
    grads give identical fingerprints."""
    leaves = (list(grads.arenas) if isinstance(grads, PackedParams)
              else tree_flatten(grads)[0])
    parts = []
    for g in leaves:
        g32 = g.float()
        parts.append(torch.stack([g32.sum(), (g32 * g32).sum()]))
    if not parts:
        return torch.zeros(2)
    return torch.cat(parts)


def check_replicated_consistency(tree: Any, axis_name: Any = DATA_AXIS, *,
                                 site: str = "ddp.consistency") -> torch.Tensor:
    """Device bool, the same on every rank: True when any rank's
    fingerprint of ``tree`` disagrees across the group or holds a
    non-finite value. For values replicated by construction, a disagreement
    is silent local corruption. One pmax and one pmin of a
    (2 * n_leaves,) vector and one pmax of the flag; never raises."""
    fp = _grad_fingerprint(tree)
    hi = comms.pmax(fp, axis_name, site=site)
    lo = comms.pmin(fp, axis_name, site=site)
    local_bad = (hi != lo).any() | (~torch.isfinite(fp)).any()
    return comms.pmax(local_bad.to(torch.int32), axis_name, site=site) > 0


def reduce_gradients(
    grads: Any,
    *,
    axis_name: Any = DATA_AXIS,
    gradient_average: bool = True,
    gradient_predivide_factor: Optional[float] = None,
    allreduce_always_fp32: bool = False,
    check_consistency: bool = False,
    bucket_bytes: Optional[int] = None,
    compress: bool = False,
    wire_dtype: Any = torch.bfloat16,
    hierarchical: bool = False,
    compress_intra: Optional[bool] = None,
    compress_dcn: Optional[bool] = None,
) -> Any:
    """All-reduce a gradient tree (or a :class:`PackedParams` of gradient
    arenas) over ``axis_name`` with the reference's scaling options.
    Returns new tensors; with ``check_consistency`` it returns ``(reduced,
    mismatch)``, ``mismatch`` as :func:`check_replicated_consistency` of
    the pre-reduce grads.

    Default (``bucket_bytes=None, compress=False``): one all-reduce per
    leaf (per arena). ``bucket_bytes`` splits each arena into ~that many
    bytes a collective (bitwise equal to the default); ``compress=True``
    puts ``wire_dtype`` on the wire with fp32 accumulation, within
    ``bucketing.compression_error_bound``. ``hierarchical=True`` reduces
    through the two-level engine (see the module docstring)."""
    _check_hierarchical(hierarchical, axis_name)
    ci = compress if compress_intra is None else compress_intra
    cd = compress if compress_dcn is None else compress_dcn
    with span("ddp_reduce_gradients"):
        mismatch = None
        if check_consistency:
            mismatch = check_replicated_consistency(
                grads, axis_name, site="ddp.grad_fingerprint")
        bucketed = bucket_bytes is not None or compress or hierarchical
        site = "ddp.bucketed_reduce" if bucketed else "ddp.reduce_gradients"
        reduced = overlap._reduce_cotangent(
            grads, axis_name=axis_name, site=site,
            gradient_average=gradient_average,
            gradient_predivide_factor=gradient_predivide_factor,
            allreduce_always_fp32=allreduce_always_fp32,
            bucket_bytes=bucket_bytes, compress=compress, wire_dtype=wire_dtype,
            hierarchical=bool(hierarchical), compress_intra=bool(ci),
            compress_dcn=bool(cd))
        if check_consistency:
            return reduced, mismatch
        return reduced


class Reducer:
    """Manual all-reduce helper: :meth:`reduce` when the caller chooses,
    :meth:`broadcast_params` to make every rank's params rank 0's."""

    def __init__(self, axis_name: Any = DATA_AXIS, *,
                 bucket_bytes: Optional[int] = None, compress: bool = False,
                 wire_dtype: Any = torch.bfloat16, hierarchical: bool = False,
                 compress_intra: Optional[bool] = None,
                 compress_dcn: Optional[bool] = None):
        _check_hierarchical(hierarchical, axis_name)
        self.axis_name = axis_name
        self.bucket_bytes = bucket_bytes
        self.compress = compress
        self.wire_dtype = wire_dtype
        self.hierarchical = hierarchical
        self.compress_intra = compress_intra
        self.compress_dcn = compress_dcn

    def _tier_knobs(self):
        return dict(hierarchical=self.hierarchical,
                    compress_intra=self.compress_intra,
                    compress_dcn=self.compress_dcn)

    def hook(self, tree: Any, *, tag: str = "reducer") -> Any:
        """Backward-time variant of :meth:`reduce` (``overlap.hook_tree``
        with this reducer's knobs)."""
        return overlap.hook_tree(tree, tag=tag, axis_name=self.axis_name,
                                 bucket_bytes=self.bucket_bytes,
                                 compress=self.compress,
                                 wire_dtype=self.wire_dtype, **self._tier_knobs())

    def broadcast_params(self, params: Any) -> Any:
        """Every rank gets rank 0's params, as a masked psum (every rank but
        the group's first contributes zeros), which is exact whether the
        ranks have diverged or not. Returns new tensors."""
        with span("ddp_broadcast_params"):
            is_src = torch.distributed.get_rank(get_group(self.axis_name)) == 0

            def bcast(p):
                src = p if is_src else torch.zeros_like(p)
                return comms.psum(src, self.axis_name, site="ddp.broadcast_params")

            if isinstance(params, PackedParams):
                return params.replace_arenas([bcast(a) for a in params.arenas])
            return tree_map(bcast, params)

    def reduce(self, tree: Any, average: bool = True) -> Any:
        return reduce_gradients(tree, axis_name=self.axis_name,
                                gradient_average=average,
                                bucket_bytes=self.bucket_bytes,
                                compress=self.compress,
                                wire_dtype=self.wire_dtype, **self._tier_knobs())


class DistributedDataParallel:
    """Functional DDP: a loss function becomes a data-parallel
    ``value_and_grad``, or :meth:`reduce` / :meth:`hook` plug into
    ``amp.scaled_value_and_grad``. Grads come back identical on every
    rank. The knobs left :data:`~beforeholiday_tpu_torch.tune.UNSET` take
    the shipped defaults; ``tuned=True`` overlays the tuning manifest's
    entry for ``tuning_key`` (``tune.resolve_trainer_knobs``: explicit
    kwargs win, a miss warns once and keeps the defaults)."""

    def __init__(self, *, axis_name: Any = DATA_AXIS,
                 gradient_average: bool = True,
                 gradient_predivide_factor: Optional[float] = None,
                 allreduce_always_fp32: bool = False,
                 bucket_bytes: Any = UNSET, compress: Any = UNSET,
                 wire_dtype: Any = torch.bfloat16,
                 overlap_backward: Any = UNSET, hierarchical: Any = UNSET,
                 compress_intra: Optional[bool] = None,
                 compress_dcn: Optional[bool] = None, tuned: bool = False,
                 tuning_key: Any = None, tuning_manifest: Any = None):
        knobs = resolve_trainer_knobs(
            "ddp",
            {"bucket_bytes": None, "compress": False,
             "overlap_backward": False, "hierarchical": False},
            {"bucket_bytes": bucket_bytes, "compress": compress,
             "overlap_backward": overlap_backward, "hierarchical": hierarchical},
            tuned=tuned, tuning_key=tuning_key, manifest=tuning_manifest,
            context={"two_level": hierarchical_axes(axis_name) is not None})
        _check_hierarchical(knobs["hierarchical"], axis_name)
        self.axis_name = axis_name
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.bucket_bytes = knobs["bucket_bytes"]
        self.compress = knobs["compress"]
        self.wire_dtype = wire_dtype
        self.overlap_backward = knobs["overlap_backward"]
        self.hierarchical = knobs["hierarchical"]
        self.compress_intra = compress_intra
        self.compress_dcn = compress_dcn

    def _knobs(self):
        return dict(axis_name=self.axis_name,
                    gradient_average=self.gradient_average,
                    gradient_predivide_factor=self.gradient_predivide_factor,
                    allreduce_always_fp32=self.allreduce_always_fp32,
                    bucket_bytes=self.bucket_bytes, compress=self.compress,
                    wire_dtype=self.wire_dtype, hierarchical=self.hierarchical,
                    compress_intra=self.compress_intra,
                    compress_dcn=self.compress_dcn)

    def reduce(self, grads: Any) -> Any:
        return reduce_gradients(grads, **self._knobs())

    def hook(self, tree: Any, *, tag: str = "ddp") -> Any:
        """Backward-time reduction boundary with this DDP's knobs: the
        grads of ``tree`` come back reduced, the collectives issued inside
        the backward (see ``parallel.overlap``)."""
        return overlap.hook_tree(tree, tag=tag, **self._knobs())

    def value_and_grad(self, loss_fn: Callable, *, has_aux: bool = False
                       ) -> Callable:
        """``f(params, *args) -> (out, grads)``, ``out`` the loss (or
        ``(loss, aux)``), the grads reduced: by the hooks inside the
        backward with ``overlap_backward``, else by :meth:`reduce` after
        it."""
        from beforeholiday_tpu_torch.amp.frontend import detach_tree, differentiate

        def wrapped(params, *args, **kw):
            def objective(p):
                if self.overlap_backward:
                    p = self.hook(p)
                res = loss_fn(p, *args, **kw)
                return (res[0] if has_aux else res), res

            out, grads = differentiate(objective, params)
            if not self.overlap_backward:
                grads = self.reduce(grads)
            return detach_tree(out), grads

        return wrapped
