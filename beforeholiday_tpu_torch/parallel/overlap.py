"""Backward-time gradient reduction — counterpart of
``beforeholiday_tpu/parallel/overlap.py`` (``_reduce_cotangent``,
``reduction_hook``, ``hook_tree``).

The reference's DDP launches each bucket's all-reduce the moment the
bucket's gradients exist, under the rest of the backward. The JAX package
does it with a ``custom_vjp`` identity whose backward reduces the
cotangent; the port has two forms of the same boundary:

* a params tree: :func:`reduction_hook` is an identity
  ``torch.autograd.Function`` over the group's leaves whose backward
  reduces their cotangents with exactly ``reduce_gradients``' op sequence
  (so the hooked backward is bitwise equal to the post-backward sweep,
  uncompressed);
* the gradient-accumulating leaves of a :class:`PackedParams`
  (``PackedParams.grad_leaves``, grads born flat): post-accumulate hooks on
  the leaves count each bucket's leaves as they land and issue the
  bucket's all-reduce, ``async_op=True`` and in place on the gradient
  arena, as soon as its last leaf has landed. A callback queued on the
  autograd engine waits the handles at the end of the backward (a stream
  wait on NCCL, no host sync), issues any bucket no leaf completed (the
  arena's padding), and applies the post-division, so the grads are
  reduced when ``backward()`` returns, before K5 reads them.

Every collective books on the ledger under ``site="ddp.overlap_hook:<tag>"``.
``per_bucket_found_inf`` and ``fold_found_inf`` (the optimizer-in-backward
path) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.autograd import Variable

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.monitor.spans import span
from beforeholiday_tpu_torch.ops.arena import (
    PackedParams,
    tree_flatten,
    tree_unflatten,
)
from beforeholiday_tpu_torch.parallel import bucketing
from beforeholiday_tpu_torch.parallel.parallel_state import (
    DATA_AXIS,
    hierarchical_axes,
)

__all__ = ["hook_tree", "reduction_hook"]

_TWO_LEVEL = ("hierarchical=True needs the two-level engines, which come with "
              "ZeRO and the multi-slice mesh")


def _scalers(axis_name, gradient_average, gradient_predivide_factor,
             allreduce_always_fp32):
    """``reduce_gradients``' pre- and post-scaling, as two functions."""
    world = bucketing.static_axis_size(axis_name)

    def pre(g):
        if allreduce_always_fp32:
            g = g.float()
        if gradient_predivide_factor is not None:
            g = g / gradient_predivide_factor
        return g

    def post(g, orig_dtype):
        if gradient_average:
            if gradient_predivide_factor is not None:
                g = g / (world / gradient_predivide_factor)
            else:
                g = g / world
        if allreduce_always_fp32:
            g = g.to(orig_dtype)
        return g

    return pre, post


def _reduce_cotangent(ct: Any, *, axis_name: Any, site: str,
                      gradient_average: bool,
                      gradient_predivide_factor: Optional[float],
                      allreduce_always_fp32: bool, bucket_bytes: Optional[int],
                      compress: bool, wire_dtype: Any,
                      hierarchical: bool = False, **_tier_knobs) -> Any:
    """The body of ``distributed.reduce_gradients`` without the tripwire:
    pre-scale, reduce (one psum per leaf, per arena, bucketed or
    compressed), post-scale."""
    if hierarchical:
        raise NotImplementedError(_TWO_LEVEL)
    pre, post = _scalers(axis_name, gradient_average, gradient_predivide_factor,
                         allreduce_always_fp32)
    bucketed = bucket_bytes is not None or compress
    if isinstance(ct, PackedParams):
        leaves, rebuild = list(ct.arenas), ct.replace_arenas
    else:
        leaves, treedef = tree_flatten(ct)
        rebuild = lambda new: tree_unflatten(treedef, new)  # noqa: E731
    if not bucketed:
        # one collective per leaf (a PackedParams' leaves are its arenas),
        # all issued before the first is waited
        pending = [comms.psum(pre(g), axis_name, site=site, async_op=True)
                   for g in leaves]
        for _, work in pending:
            work.wait()
        return rebuild([post(r, g.dtype) for (r, _), g in zip(pending, leaves)])
    if isinstance(ct, PackedParams):
        return rebuild([
            post(bucketing.bucketed_psum(pre(a), axis_name, site=site,
                                         bucket_bytes=bucket_bytes,
                                         compress=compress,
                                         wire_dtype=wire_dtype), a.dtype)
            for a in leaves])
    red = bucketing.bucketed_tree_psum(
        [pre(g) for g in leaves], axis_name, site=site,
        bucket_bytes=bucket_bytes, compress=compress, wire_dtype=wire_dtype)
    return rebuild([post(r, g.dtype) for r, g in zip(red, leaves)])


class _ReduceInBackward(torch.autograd.Function):
    """Identity on a group's leaves; the backward reduces their
    cotangents."""

    @staticmethod
    def forward(ctx, knobs, *leaves):
        ctx.knobs = knobs
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *cts):
        knobs = dict(ctx.knobs)
        tag = knobs.pop("tag")
        with span(f"ddp_overlap_hook:{tag}"):
            red = _reduce_cotangent(list(cts), site=f"ddp.overlap_hook:{tag}",
                                    **knobs)
        return (None, *red)


class _ArenaHooks:
    """Post-accumulate hooks over a ``grad_leaves`` PackedParams: each
    bucket of each gradient arena is reduced in place as soon as every leaf
    overlapping it has landed (see the module docstring)."""

    def __init__(self, packed, knobs):
        self.knobs = dict(knobs)
        self.tag = self.knobs.pop("tag")
        if self.knobs.pop("hierarchical", False):
            raise NotImplementedError(_TWO_LEVEL)
        self.grads = packed.grads
        k = self.knobs
        self.pre, self.post = _scalers(k["axis_name"], k["gradient_average"],
                                       k["gradient_predivide_factor"],
                                       k["allreduce_always_fp32"])
        self.buckets = []  # (arena, offset, length)
        for b, a in enumerate(self.grads.arenas):
            for off, ln in bucketing.bucket_slices(
                    a.numel(), a.element_size(), k["bucket_bytes"]):
                self.buckets.append((b, off, ln))
        self.waiting = [0] * len(self.buckets)
        for b, off, n, leaf in packed.pieces:
            mine = [i for i, (bb, o, ln) in enumerate(self.buckets)
                    if bb == b and o < off + n and off < o + ln]
            for i in mine:
                self.waiting[i] += 1
            leaf.register_post_accumulate_grad_hook(
                lambda _leaf, mine=mine: self._landed(mine))
        self.issued = [None] * len(self.buckets)
        self.queued = False

    def _issue(self, i):
        b, off, ln = self.buckets[i]
        view = self.grads.arenas[b][off: off + ln]
        k = self.knobs
        self.issued[i] = (view, *bucketing.issue_bucket(
            self.pre(view), k["axis_name"], site=f"ddp.overlap_hook:{self.tag}",
            compress=k["compress"], wire_dtype=k["wire_dtype"]))

    def _landed(self, mine):
        if not self.queued:
            self.queued = True
            Variable._execution_engine.queue_callback(self._finish)
        for i in mine:
            self.waiting[i] -= 1
            if self.waiting[i] == 0:
                self._issue(i)

    def _finish(self):
        with span(f"ddp_overlap_hook:{self.tag}"):
            for i, done in enumerate(self.issued):
                if done is None:
                    self._issue(i)
            for view, result, work in self.issued:
                if work is not None:
                    work.wait()
                view.copy_(self.post(result, view.dtype))


def reduction_hook(tree: Any, *, axis_name: Any = DATA_AXIS, tag: str = "grads",
                   gradient_average: bool = True,
                   gradient_predivide_factor: Optional[float] = None,
                   allreduce_always_fp32: bool = False,
                   bucket_bytes: Optional[int] = None, compress: bool = False,
                   wire_dtype: Any = torch.bfloat16, hierarchical: bool = False,
                   compress_intra: Optional[bool] = None,
                   compress_dcn: Optional[bool] = None) -> Any:
    """Identity on ``tree`` whose gradients come back reduced over
    ``axis_name``, the collectives issued inside the backward. ``tree``: a
    params tree (the identity Function), or the packed argument a loss
    function receives from ``amp.scaled_value_and_grad`` at a
    :class:`PackedParams` (the arena hooks; it is returned as is). The
    scaling knobs are ``reduce_gradients``'."""
    if hierarchical or hierarchical_axes(axis_name) is not None:
        raise NotImplementedError(_TWO_LEVEL)
    knobs = dict(axis_name=axis_name, tag=tag,
                 gradient_average=bool(gradient_average),
                 gradient_predivide_factor=gradient_predivide_factor,
                 allreduce_always_fp32=bool(allreduce_always_fp32),
                 bucket_bytes=bucket_bytes, compress=bool(compress),
                 wire_dtype=wire_dtype, hierarchical=False)
    if isinstance(tree, PackedParams):
        if getattr(tree, "grads", None) is None:
            raise ValueError(
                "a PackedParams is hooked through the packed argument that "
                "amp.scaled_value_and_grad hands the loss function "
                "(PackedParams.grad_leaves)")
        _ArenaHooks(tree, knobs)
        return tree
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, list(_ReduceInBackward.apply(knobs, *leaves)))


def hook_tree(tree: Any, *, tag: str = "params", **knobs: Any) -> Any:
    """Hook each top-level group of ``tree`` under its own tag: a dict per
    key (``tag.key``), a list or tuple per index (``tag.0``, ...), anything
    else (a PackedParams, a namedtuple) as one group. ``knobs`` go to
    :func:`reduction_hook`."""
    if type(tree) is dict:
        return {k: reduction_hook(v, tag=f"{tag}.{k}", **knobs)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(reduction_hook(v, tag=f"{tag}.{i}", **knobs)
                          for i, v in enumerate(tree))
    return reduction_hook(tree, tag=tag, **knobs)
