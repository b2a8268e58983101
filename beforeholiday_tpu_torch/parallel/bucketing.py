"""Bucketed and wire-compressed all-reduces over flat gradient arenas —
counterpart of the flat part of ``beforeholiday_tpu/parallel/bucketing.py``.

A flat arena is reduced as independent ~``bucket_bytes`` collectives, each
issued ``async_op=True`` and waited before the result is read (on NCCL the
wait is a stream wait: the host does not block). The JAX module's three
guarantees hold:

* **Static geometry.** Bucket offsets and lengths are host ints from the
  arena's length and the group's size; nothing branches on a device value.
* **fp32 accumulation under compression.** ``compress=True`` casts each
  bucket to the wire dtype once, exchanges rank-major rows with
  ``all_to_all_single`` (a reduce-scatter in disguise), sums the received
  rows in fp32, and shares the sums with one more wire cast and an
  ``all_gather_into_tensor``. The elementwise error against the exact fp32
  reduce is within :func:`compression_error_bound`.
* **Ledger-visible.** Every collective goes through ``monitor.comms``, so
  per-site ``calls`` count buckets and ``bytes`` the wire payload.

Uncompressed bucketing is bitwise equal to one collective per arena. ZeRO's
bucketed reduce-scatter and all-gather (:func:`bucketed_psum_scatter`,
:func:`bucketed_all_gather`) bucket along the shard columns of the
rank-major ``(world, shard)`` view, so each rank's result stays one
contiguous shard; the compressed reduce-scatter is an ``all_to_all`` of
wire-dtype rows and a local fp32 sum in rank order. The chunked gather and
reduce-scatter of the sequence-parallel mappings are ported too.

The two-level section (:func:`hierarchical_psum`,
:func:`hierarchical_psum_scatter`, :func:`hierarchical_all_gather`) is the
multi-slice decomposition over a ``(slice, intra)`` spec (the axes of a
``parallel_state.make_two_level_mesh`` mesh): intra-slice reduce-scatter,
inter-slice all-reduce on the 1/slice_size chunk, intra-slice all-gather,
each leg issued ``async_op`` and waited before the next reads it. The JAX
module's two contracts hold. On a two-level spec the flat uncompressed
reduce is spelled as chained per-axis sums, intra tier first, so the
hierarchical path is bitwise the flat one wherever each tier's sum is
(a tier of two ranks always: a two-term float sum commutes; a wider tier
sums in the library's order). And collectives over the slice axis book as
``"dcn"`` on the ledger, so ``comms_summary()``'s ``by_tier`` shows the
DCN bytes at 1/slice_size of the flat reduce's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.ops.arena import LANES
from beforeholiday_tpu_torch.parallel.parallel_state import (
    DATA_AXIS,
    get_group,
    hierarchical_axes,
)

__all__ = [
    "BucketedReduce",
    "DEFAULT_BUCKET_BYTES",
    "bucket_slices",
    "bucketed_all_gather",
    "bucketed_psum",
    "bucketed_psum_scatter",
    "bucketed_tree_psum",
    "chunked_all_gather",
    "chunked_reduce_scatter",
    "compression_error_bound",
    "hierarchical_all_gather",
    "hierarchical_compression_error_bound",
    "hierarchical_psum",
    "hierarchical_psum_scatter",
    "n_buckets",
    "partition_leaves",
    "static_axis_size",
    "wire_eps",
]

# ~4 MiB: large enough that a collective's launch cost amortizes, small
# enough that several buckets are in flight while the backward computes
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024

# unit roundoff of the supported wire dtypes (2^-(mantissa bits + 1))
_WIRE_EPS = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}

def wire_eps(wire_dtype: Any) -> float:
    """Unit roundoff of a supported wire dtype (bf16: 2^-8, fp16: 2^-11)."""
    try:
        return _WIRE_EPS[wire_dtype]
    except KeyError:
        raise ValueError(
            f"unsupported wire dtype {wire_dtype!r}; use bfloat16 or float16"
        ) from None


def compression_error_bound(sum_abs, wire_dtype: Any = torch.bfloat16):
    """Elementwise bound on ``|compressed_reduce - exact_reduce|`` given
    ``sum_abs``, the cross-rank sum of ``|x|``: one wire rounding of each
    rank's input and one of the fp32 sum, ``2 * wire_eps * sum_abs``."""
    return 2.0 * wire_eps(wire_dtype) * sum_abs


def hierarchical_compression_error_bound(sum_abs, *, compress_intra: bool = False,
                                         compress_dcn: bool = False,
                                         wire_dtype: Any = torch.bfloat16):
    """Composed elementwise bound on ``|hierarchical_reduce - exact|`` with
    per-tier compression: each compressed tier costs the flat all-reduce's
    ``2 * wire_eps`` relative to ``sum_abs`` (the sum of ``|x|`` over the
    whole slice x intra world), and the tiers compose multiplicatively:
    ``((1 + 2e)^k - 1) * sum_abs`` for ``k`` compressed tiers; 0 when
    neither compresses (that path is bitwise)."""
    eps = wire_eps(wire_dtype)
    factor = 1.0
    if compress_intra:
        factor *= 1.0 + 2.0 * eps
    if compress_dcn:
        factor *= 1.0 + 2.0 * eps
    return (factor - 1.0) * sum_abs


def static_axis_size(axis_name: Any) -> int:
    """The size of the group ``axis_name`` names, as a host int; a sequence
    of axes (the two-level ``(slice, intra)`` spec) gives the product, the
    flat world."""
    if isinstance(axis_name, (tuple, list)):
        size = 1
        for ax in axis_name:
            size *= static_axis_size(ax)
        return size
    return dist.get_world_size(get_group(axis_name))


@functools.lru_cache(maxsize=4096)
def bucket_slices(n: int, itemsize: int,
                  bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                  align: int = LANES) -> Tuple[Tuple[int, int], ...]:
    """Static (offset, length) pairs covering ``[0, n)`` in ~``bucket_bytes``
    steps, offsets multiples of ``align``; only the last bucket may be
    ragged. ``bucket_bytes=None`` means one bucket."""
    if n <= 0:
        raise ValueError(f"cannot bucket an empty payload (n={n})")
    if bucket_bytes is None:
        return ((0, n),)
    per = max(int(bucket_bytes) // int(itemsize), 1)
    per = max(per - per % align, align)
    return tuple((off, min(per, n - off)) for off in range(0, n, per))


def n_buckets(n_elements: int, itemsize: int,
              bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES) -> int:
    """How many buckets a payload splits into."""
    return len(bucket_slices(n_elements, itemsize, bucket_bytes))


def _compressed_allreduce(x: torch.Tensor, axis_name, *, site: str, wire_dtype):
    """Two-shot compressed all-reduce of a 1-D bucket with fp32
    accumulation; returns fp32. Phase 1 is a reduce-scatter spelled as an
    all-to-all over a rank-major (world, chunk) view, so each rank sums its
    chunk itself in fp32; phase 2 shares the sums with one more wire cast.
    The two collectives are waited in stream order (no host sync on
    NCCL)."""
    world = static_axis_size(axis_name)
    n = x.shape[0]
    chunk = -(-n // world)
    pad = chunk * world - n
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    wire = xp.reshape(world, chunk).to(wire_dtype)
    recv = comms.all_to_all(wire, axis_name, 0, 0, site=site,
                            logical=comms.logical(wire.shape, x.dtype))
    acc = recv.float().sum(0)
    back = comms.all_gather(acc.to(wire_dtype), axis_name, tiled=True,
                            site=site,
                            logical=comms.logical(acc.shape, torch.float32))
    out = back.float()
    return out[:n] if pad else out


def issue_bucket(piece: torch.Tensor, axis_name, *, site: str, compress: bool,
                 wire_dtype):
    """Start one bucket's reduction; returns ``(result, work)``: ``work``
    (None for the compressed form, which runs in stream order) must be
    waited before ``result`` is read. Uncompressed, ``piece`` is reduced in
    place; on a two-level spec by the chained per-axis sums."""
    if compress:
        return _compressed_allreduce(piece, axis_name, site=site,
                                     wire_dtype=wire_dtype).to(piece.dtype), None
    axes = hierarchical_axes(axis_name)
    if axes is not None:
        # the chained flat spelling: every tier but the last in stream order
        sized = _sized_axes(axes)
        if not sized:
            return piece, None
        for ax, _ in sized[:-1]:
            comms.psum(piece, ax, site=site, async_op=True, inplace=True)[1].wait()
        axis_name = sized[-1][0]
    return comms.psum(piece, axis_name, site=site, async_op=True, inplace=True)


# ------------------------------------------------- two-level (slice x intra)
# The multi-slice decomposition: intra-slice reduce-scatter -> inter-slice
# (DCN) all-reduce on 1/slice_size of the data -> intra-slice all-gather.
# Two contracts make the flat and hierarchical paths comparable (the JAX
# module's): on a two-level spec the flat uncompressed reduce is spelled as
# chained per-axis sums (intra tier first, then slice), the order the
# hierarchical path computes in, so the two are bitwise equal wherever each
# tier's own sum is; and collectives over the slice axis book as "dcn".


class _Done:
    """The work of a result already in stream order: nothing to wait on."""

    def wait(self):
        return True


_DONE = _Done()


def _sized_axes(axes: Tuple[str, str]) -> Tuple[Tuple[str, int], ...]:
    """``(axis, size)`` for the non-degenerate axes of a two-level spec,
    fast tier first (the reduction order); size-1 axes drop out, so a
    degenerate carve (slice_size 1 or one slice) issues exactly the flat
    path's collectives."""
    slice_axis, intra_axis = axes
    out = []
    for ax in (intra_axis, slice_axis):
        size = static_axis_size(ax)
        if size > 1:
            out.append((ax, size))
    return tuple(out)


def _chained_psum(x, axes: Tuple[str, str], *, site: str):
    """The deterministic flat all-reduce over a two-level spec: the fast
    tier, then the slow one, each waited in stream order. ``x`` is a tensor
    or a list of same-dtype tensors (JAX's variadic form); the result is
    new either way."""
    sized = _sized_axes(axes)
    if not sized:
        return [t.clone() for t in x] if isinstance(x, (list, tuple)) else x.clone()
    for ax, _ in sized:
        x, work = comms.psum(x, ax, site=site, async_op=True)
        work.wait()
    return x


def _flat_rank(axes) -> int:
    """This rank's flat index over a two-level spec (``slice * slice_size
    + intra``): its rank in the mesh's joint group."""
    return dist.get_rank(get_group(tuple(axes)))


def _landed(entry) -> torch.Tensor:
    """Wait on an issued leg and return what it left this rank: the reduced
    piece as it is, or the compressed form's received rows summed in fp32."""
    recv, work, summed = entry
    work.wait()
    return recv if summed else recv.float().sum(0)


def _scatter_leg(piece, intra_axis, intra, *, site, compress, wire_dtype):
    """Leg 1 of one two-level bucket: the intra-slice reduce-scatter of
    ``piece`` (padded to a multiple of the tier), issued. Returns ``(entry,
    pad)``; :func:`_landed` gives the reduced 1/intra chunk."""
    ln = piece.shape[0]
    chunk = -(-ln // intra)
    pad = chunk * intra - ln
    xp = torch.nn.functional.pad(piece, (0, pad)) if pad else piece
    if compress:
        wire = xp.reshape(intra, chunk).to(wire_dtype)
        recv, work = comms.all_to_all(wire, intra_axis, 0, 0, site=site,
                                      logical=comms.logical(wire.shape, piece.dtype),
                                      async_op=True)
        return (recv, work, False), pad
    red, work = comms.psum_scatter(xp, intra_axis, scatter_dimension=0, tiled=True,
                                   site=site, async_op=True)
    return (red, work, True), pad


def _dcn_leg(red, slice_axis, *, site, compress, wire_dtype):
    """Leg 2: the inter-slice all-reduce of a chunk, ``(result, work)``
    (in place on ``red`` uncompressed)."""
    if compress:
        return _compressed_allreduce(red, slice_axis, site=site,
                                     wire_dtype=wire_dtype), _DONE
    return comms.psum(red, slice_axis, site=site, async_op=True, inplace=True)


def _gather_leg(red, intra_axis, *, site, compress, wire_dtype):
    """Leg 3: the intra-slice all-gather of a reduced chunk, ``(full,
    work)``; compressed, the chunk rides the wire in ``wire_dtype``."""
    if compress:
        return comms.all_gather(red.to(wire_dtype), intra_axis, axis=0, tiled=True,
                                site=site, logical=comms.logical(red.shape,
                                                                 torch.float32),
                                async_op=True)
    return comms.all_gather(red, intra_axis, axis=0, tiled=True, site=site,
                            async_op=True)


class TwoLevelBucket:
    """One bucket's two-level all-reduce, its three dependent legs issued
    one at a time: the constructor issues the intra-slice reduce-scatter,
    :meth:`start_dcn` waits on it and issues the inter-slice all-reduce of
    the chunk (or takes the chunk reduced elsewhere, ``reduced``),
    :meth:`start_gather` waits on that and issues the intra-slice
    all-gather, and :meth:`result` returns the reduced bucket in the
    piece's dtype, running whatever leg is left. The backward-time hooks
    issue leg 1 as a bucket's gradients land and call :meth:`result` in the
    autograd engine's callback, so the host waits only there (gloo); on
    NCCL each wait is a stream wait."""

    def __init__(self, piece, axes, *, site, compress_intra=False,
                 compress_dcn=False, wire_dtype=torch.bfloat16):
        self.slice_axis, self.intra_axis = axes
        self.n, self.dtype, self.site = piece.shape[0], piece.dtype, site
        self.ci, self.cd, self.wire = compress_intra, compress_dcn, wire_dtype
        intra = static_axis_size(self.intra_axis)
        self.entry, self.pad = _scatter_leg(piece, self.intra_axis, intra, site=site,
                                            compress=compress_intra,
                                            wire_dtype=wire_dtype)
        self.red = self.gathered = None

    def landed(self) -> torch.Tensor:
        """Leg 1's reduced 1/intra chunk (waited)."""
        return _landed(self.entry)

    def start_dcn(self, reduced=None):
        if reduced is None:
            self.red = _dcn_leg(self.landed(), self.slice_axis, site=self.site,
                                compress=self.cd, wire_dtype=self.wire)
        else:
            self.red = (reduced, _DONE)

    def start_gather(self):
        if self.red is None:
            self.start_dcn()
        red, work = self.red
        work.wait()
        self.gathered = _gather_leg(red, self.intra_axis, site=self.site,
                                    compress=self.ci, wire_dtype=self.wire)

    def result(self) -> torch.Tensor:
        if self.gathered is None:
            self.start_gather()
        g, work = self.gathered
        work.wait()
        out = g.to(self.dtype) if (self.ci or self.cd) else g
        return out[: self.n] if self.pad else out


def hierarchical_psum(flat: torch.Tensor, axes: Tuple[str, str], *, site: str,
                      bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                      bucket_bytes_dcn: Optional[int] = None,
                      compress_intra: bool = False, compress_dcn: bool = False,
                      wire_dtype: Any = torch.bfloat16) -> torch.Tensor:
    """Two-level all-reduce of a flat arena: per bucket
    (:class:`TwoLevelBucket`), intra-slice reduce-scatter, inter-slice
    all-reduce of the 1/slice_size chunk, intra-slice all-gather; only the
    chunk crosses DCN. Each leg of every bucket is issued before the next
    leg of any. Uncompressed it is bitwise the flat chained reduce (see the
    section comment); ``compress_intra`` puts the reduce-scatter and
    all-gather legs on the wire in ``wire_dtype``, ``compress_dcn`` the
    inter-slice leg, with fp32 accumulation on every tier, within
    :func:`hierarchical_compression_error_bound`. A degenerate carve falls
    back to the single-tier bucketed path with that tier's knobs.
    ``bucket_bytes_dcn`` re-buckets the reduced chunks of all buckets for
    the DCN leg (fewer, bigger collectives on the slow tier); the reduce is
    elementwise, so only the ledger's DCN call count moves. Returns a new
    tensor."""
    if flat.ndim != 1:
        raise ValueError(f"hierarchical_psum wants a flat arena, got {tuple(flat.shape)}")
    slice_axis, intra_axis = axes
    sized = _sized_axes(axes)
    if len(sized) < 2:
        if not sized:
            return flat.clone()
        ax, _ = sized[0]
        on_dcn = ax == slice_axis
        return bucketed_psum(
            flat, ax, site=site,
            bucket_bytes=(bucket_bytes_dcn if on_dcn and bucket_bytes_dcn is not None
                          else bucket_bytes),
            compress=compress_dcn if on_dcn else compress_intra,
            wire_dtype=wire_dtype)
    buckets = [TwoLevelBucket(flat[off: off + ln], axes, site=site,
                              compress_intra=compress_intra,
                              compress_dcn=compress_dcn, wire_dtype=wire_dtype)
               for off, ln in bucket_slices(flat.shape[0], flat.element_size(),
                                            bucket_bytes)]
    if bucket_bytes_dcn is None:
        for b in buckets:
            b.start_dcn()
    else:
        reds = [b.landed() for b in buckets]
        cat = reds[0] if len(reds) == 1 else torch.cat(reds)
        issued = []
        for doff, dln in bucket_slices(cat.shape[0], cat.element_size(),
                                       bucket_bytes_dcn):
            view = cat[doff: doff + dln]
            issued.append((view, *_dcn_leg(view, slice_axis, site=site,
                                           compress=compress_dcn,
                                           wire_dtype=wire_dtype)))
        for view, res, work in issued:
            work.wait()
            if res is not view:
                view.copy_(res)
        o = 0
        for b, r in zip(buckets, reds):
            b.start_dcn(reduced=cat[o: o + r.shape[0]])
            o += r.shape[0]
    for b in buckets:
        b.start_gather()
    pieces = [b.result() for b in buckets]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def hierarchical_psum_scatter(flat: torch.Tensor, axes: Tuple[str, str], *,
                              site: str,
                              bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                              compress_intra: bool = False,
                              compress_dcn: bool = False,
                              wire_dtype: Any = torch.bfloat16,
                              concat: bool = True):
    """Two-level reduce-scatter of a ``(world * shard,)`` arena into this
    rank's ``(shard,)`` piece, the flat path's ownership (rank ``slice *
    slice_size + intra`` owns shard ``r``). Per shard-column bucket: the
    rank-major view reordered intra-major, reduce-scattered over the intra
    tier (each intra rank keeps the per-slice partials of its part of the
    column), then the 1/slice_size remainder reduce-scattered over DCN.
    Bucketing and ``concat=False`` are :func:`bucketed_psum_scatter`'s."""
    world = static_axis_size(axes)
    total = flat.shape[0]
    if flat.ndim != 1 or total % world:
        raise ValueError(
            f"hierarchical_psum_scatter wants a flat arena divisible by the "
            f"world size, got shape {tuple(flat.shape)} over world={world}")
    slice_axis, intra_axis = axes
    sized = _sized_axes(axes)
    if len(sized) < 2:
        if not sized:
            return flat.clone() if concat else [flat.clone()]
        ax, _ = sized[0]
        return bucketed_psum_scatter(
            flat, ax, site=site, bucket_bytes=bucket_bytes,
            compress=compress_dcn if ax == slice_axis else compress_intra,
            wire_dtype=wire_dtype, concat=concat)
    n_slices = static_axis_size(slice_axis)
    intra = static_axis_size(intra_axis)
    shard = total // world
    mat = flat.view(world, shard)
    slices = bucket_slices(shard, flat.element_size() * world, bucket_bytes)
    leg1 = []
    for off, ln in slices:
        # (world, ln) rank-major -> (intra, n_slices, ln): intra rank i's
        # chunk stacks the rows of ranks s * intra + i for every slice s, so
        # the DCN leg lands each rank exactly its flat-path shard
        im = mat[:, off: off + ln].reshape(n_slices, intra, ln).transpose(0, 1)
        if compress_intra:
            wire = im.reshape(intra, n_slices * ln).to(wire_dtype)
            leg1.append((*comms.all_to_all(
                wire, intra_axis, 0, 0, site=site,
                logical=comms.logical(wire.shape, flat.dtype), async_op=True), False))
        else:
            leg1.append((*comms.psum_scatter(
                im.reshape(intra * n_slices * ln), intra_axis, scatter_dimension=0,
                tiled=True, site=site, async_op=True), True))
    leg2 = []
    for (_, ln), entry in zip(slices, leg1):
        red = _landed(entry)
        if compress_dcn:
            wire = red.reshape(n_slices, ln).to(wire_dtype)
            leg2.append((*comms.all_to_all(
                wire, slice_axis, 0, 0, site=site,
                logical=comms.logical(wire.shape, flat.dtype), async_op=True), False))
        else:
            leg2.append((*comms.psum_scatter(red, slice_axis, scatter_dimension=0,
                                             tiled=True, site=site, async_op=True),
                         True))
    pieces = []
    for entry in leg2:
        piece = _landed(entry)
        pieces.append(piece.to(flat.dtype) if (compress_intra or compress_dcn)
                      else piece)
    if not concat:
        return pieces
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def hierarchical_all_gather(shard: torch.Tensor, axes: Tuple[str, str], *,
                            site: str,
                            bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                            logical_dtype: Any = None) -> torch.Tensor:
    """Two-level all-gather of every rank's ``(shard,)`` into the rank-major
    ``(world * shard,)`` arena: over the slice (DCN) tier first, so each
    rank ships only its own shard across the slow link, then over the intra
    tier, un-interleaved back to slice-major order. Bitwise the flat gather
    (gathers move data and add nothing)."""
    world = static_axis_size(axes)
    if shard.ndim != 1:
        raise ValueError(
            f"hierarchical_all_gather wants a flat shard, got {tuple(shard.shape)}")
    slice_axis, intra_axis = axes
    sized = _sized_axes(axes)
    if len(sized) < 2:
        if not sized:
            return shard.clone()
        return bucketed_all_gather(shard, sized[0][0], site=site,
                                   bucket_bytes=bucket_bytes,
                                   logical_dtype=logical_dtype)
    n_slices = static_axis_size(slice_axis)
    intra = static_axis_size(intra_axis)
    n = shard.shape[0]
    slices = bucket_slices(n, shard.element_size(), bucket_bytes)

    def logical(t):
        return None if logical_dtype is None else comms.logical(t.shape, logical_dtype)

    leg1 = []
    for off, ln in slices:
        piece = shard[off: off + ln]
        leg1.append(comms.all_gather(piece, slice_axis, axis=0, tiled=True, site=site,
                                     logical=logical(piece), async_op=True))
    leg2 = []
    for ga, work in leg1:
        work.wait()
        leg2.append(comms.all_gather(ga, intra_axis, axis=0, tiled=True, site=site,
                                     logical=logical(ga), async_op=True))
    out = torch.empty(world, n, dtype=shard.dtype, device=shard.device)
    for (off, ln), (gb, work) in zip(slices, leg2):
        work.wait()
        # (intra, n_slices, ln) -> the slice-major (world, ln) rank order
        out[:, off: off + ln].copy_(
            gb.view(intra, n_slices, ln).transpose(0, 1).reshape(world, ln))
    return out.view(world * n)


def bucketed_psum(flat: torch.Tensor, axis_name: Any, *, site: str,
                  bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                  compress: bool = False, wire_dtype: Any = torch.bfloat16,
                  inplace: bool = False) -> torch.Tensor:
    """All-reduce a flat (1-D) arena as independent per-bucket collectives,
    all issued before the first is waited. Uncompressed buckets are
    bitwise equal to one collective over the arena. ``compress=True`` puts
    each bucket on the wire in ``wire_dtype`` with fp32 accumulation and
    returns in the input dtype. ``inplace`` reduces ``flat`` itself. On a
    two-level ``(slice, intra)`` spec the uncompressed reduce is the
    chained per-axis sum, bucket by bucket: the full payload on both tiers,
    the flat baseline :func:`hierarchical_psum` is bitwise equal to."""
    if flat.ndim != 1:
        raise ValueError(f"bucketed_psum wants a flat arena, got {tuple(flat.shape)}")
    out = flat if inplace else flat.clone()
    pending = []
    for off, ln in bucket_slices(out.shape[0], out.element_size(), bucket_bytes):
        view = out[off: off + ln]
        pending.append((view, *issue_bucket(view, axis_name, site=site,
                                            compress=compress,
                                            wire_dtype=wire_dtype)))
    for view, result, work in pending:
        if work is not None:
            work.wait()
        if result is not view:
            view.copy_(result)
    return out


def issue_psum_scatter(flat: torch.Tensor, axis_name: Any, *, site: str,
                       bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                       compress: bool = False,
                       wire_dtype: Any = torch.bfloat16) -> List[Tuple]:
    """Issue every bucket's reduce-scatter of a ``(world * shard,)`` arena
    (``async_op``, none waited): ``[(received, work, summed)]`` in shard
    order, the geometry ``bucket_slices(shard, itemsize * world,
    bucket_bytes)``. Pass each entry to :func:`finish_bucket` for the
    bucket's piece of this rank's shard; a consumer of one bucket waits on
    that bucket's work only. On a two-level spec the uncompressed bucket is
    the chained all-reduce (done in stream order) and this rank's slice of
    it."""
    world = static_axis_size(axis_name)
    total = flat.shape[0]
    if flat.ndim != 1 or total % world:
        raise ValueError(
            f"bucketed_psum_scatter wants a flat arena divisible by the axis "
            f"size, got shape {tuple(flat.shape)} over world={world}")
    axes = hierarchical_axes(axis_name)
    if not compress and bucket_bytes is None and axes is None:
        piece, work = comms.psum_scatter(flat, axis_name, scatter_dimension=0,
                                         tiled=True, site=site, async_op=True)
        return [(piece, work, True)]
    shard = total // world
    mat = flat.view(world, shard)
    rank = _flat_rank(axes) if axes is not None and not compress else None
    out = []
    # a shard column costs world * itemsize wire bytes: budget per column
    for off, ln in bucket_slices(shard, flat.element_size() * world, bucket_bytes):
        col = mat[:, off: off + ln]
        if compress:
            wire = col.to(wire_dtype)
            recv, work = comms.all_to_all(
                wire, axis_name, 0, 0, site=site,
                logical=comms.logical(wire.shape, flat.dtype), async_op=True)
            out.append((recv, work, False))
        elif axes is not None:
            full = _chained_psum(col.reshape(world * ln), axes, site=site)
            out.append((full[rank * ln: (rank + 1) * ln], _DONE, True))
        else:
            piece, work = comms.psum_scatter(
                col.reshape(world * ln), axis_name, scatter_dimension=0,
                tiled=True, site=site, async_op=True)
            out.append((piece, work, True))
    return out


def finish_bucket(entry, dtype: torch.dtype) -> torch.Tensor:
    """Wait on one issued bucket (:func:`issue_psum_scatter`) and return its
    piece of this rank's shard in ``dtype``: the reduced piece as it is, or
    the compressed form's received rows summed in fp32 in rank order."""
    recv, work, summed = entry
    work.wait()
    if summed:
        return recv
    acc = recv[0].float()
    for row in recv[1:]:
        acc = acc + row.float()
    return acc.to(dtype)


def bucketed_psum_scatter(flat: torch.Tensor, axis_name: Any, *, site: str,
                          bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                          compress: bool = False,
                          wire_dtype: Any = torch.bfloat16,
                          concat: bool = True):
    """Reduce-scatter a ``(world * shard,)`` arena into this rank's
    ``(shard,)`` piece, as independent per-bucket collectives along the shard
    columns of the rank-major ``(world, shard)`` view, all issued before the
    first is waited. Uncompressed it is bitwise one reduce-scatter of the
    arena. ``compress`` puts each bucket on the wire in ``wire_dtype`` (one
    ``all_to_all``) and sums the received rows in fp32 in rank order; the
    result is in ``flat``'s dtype, within ``wire_eps * sum |x|`` of the
    exact reduce. ``concat=False`` returns the per-bucket pieces in shard
    order. On a two-level spec the uncompressed form is the chained
    all-reduce and a local slice: the full-payload flat baseline
    :func:`hierarchical_psum_scatter` is bitwise equal to."""
    pieces = [finish_bucket(e, flat.dtype) for e in issue_psum_scatter(
        flat, axis_name, site=site, bucket_bytes=bucket_bytes,
        compress=compress, wire_dtype=wire_dtype)]
    if not concat:
        return pieces
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def bucketed_all_gather(shard: torch.Tensor, axis_name: Any, *, site: str,
                        bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                        logical_dtype: Any = None) -> torch.Tensor:
    """All-gather every rank's ``(shard,)`` into the rank-major ``(world *
    shard,)`` arena as independent per-bucket gathers, all issued before the
    first is waited; concatenating the buckets along the chunk axis of their
    ``(world, ln)`` views restores rank-major order, bitwise one gather. The
    caller owns any wire cast: ``logical_dtype`` tells the ledger the
    uncompressed cost. A two-level spec gathers over the mesh's joint
    group."""
    if shard.ndim != 1:
        raise ValueError(
            f"bucketed_all_gather wants a flat shard, got {tuple(shard.shape)}")
    world = static_axis_size(axis_name)
    n = shard.shape[0]
    slices = bucket_slices(n, shard.element_size(), bucket_bytes)

    def logical(t):
        return None if logical_dtype is None else comms.logical(t.shape, logical_dtype)

    if len(slices) == 1:
        full, work = comms.all_gather(shard, axis_name, axis=0, tiled=True,
                                      site=site, logical=logical(shard),
                                      async_op=True)
        work.wait()
        return full
    issued = []
    for off, ln in slices:
        piece = shard[off: off + ln]
        issued.append(comms.all_gather(piece, axis_name, axis=0, tiled=True,
                                       site=site, logical=logical(piece),
                                       async_op=True))
    out = torch.empty(world, n, dtype=shard.dtype, device=shard.device)
    for (off, ln), (g, work) in zip(slices, issued):
        work.wait()
        out[:, off: off + ln].copy_(g.view(world, ln))
    return out.view(world * n)


def chunked_all_gather(x: torch.Tensor, axis_name: Any, *, site: str,
                       dim: int = 0,
                       chunk_bytes: int = DEFAULT_BUCKET_BYTES) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim``, issued as independent chunks of
    ~``chunk_bytes``: bitwise the single gather (the sequence-parallel
    mappings' chunked form)."""
    world = static_axis_size(axis_name)
    dim = dim % x.ndim
    n = x.shape[dim]
    row_bytes = (x.numel() // n) * x.element_size()
    slices = bucket_slices(n, row_bytes, chunk_bytes, align=1)
    if len(slices) == 1:
        return comms.all_gather(x, axis_name, site=site, axis=dim, tiled=True)
    parts = []
    for off, ln in slices:
        g = comms.all_gather(x.narrow(dim, off, ln), axis_name, site=site,
                             axis=dim, tiled=True)
        parts.append(g.reshape(*g.shape[:dim], world, ln, *g.shape[dim + 1:]))
    cat = torch.cat(parts, dim=dim + 1)
    return cat.reshape(*cat.shape[:dim], world * n, *cat.shape[dim + 2:])


def chunked_reduce_scatter(x: torch.Tensor, axis_name: Any, *, site: str,
                           dim: int = 0,
                           chunk_bytes: int = DEFAULT_BUCKET_BYTES) -> torch.Tensor:
    """Tiled ``psum_scatter`` along ``dim``, issued as independent chunks of
    ~``chunk_bytes``: bitwise the single reduce-scatter."""
    world = static_axis_size(axis_name)
    dim = dim % x.ndim
    total = x.shape[dim]
    if total % world:
        raise ValueError(f"scatter dim {dim} (size {total}) not divisible by "
                         f"world={world}")
    n = total // world
    row_bytes = (x.numel() // total) * x.element_size() * world
    slices = bucket_slices(n, row_bytes, chunk_bytes, align=1)
    if len(slices) == 1:
        return comms.psum_scatter(x, axis_name, site=site, scatter_dimension=dim,
                                  tiled=True)
    x2 = x.reshape(*x.shape[:dim], world, n, *x.shape[dim + 1:])
    parts = []
    for off, ln in slices:
        piece = x2.narrow(dim + 1, off, ln)
        flat = piece.reshape(*piece.shape[:dim], world * ln, *piece.shape[dim + 2:])
        parts.append(comms.psum_scatter(flat, axis_name, site=site,
                                        scatter_dimension=dim, tiled=True))
    return torch.cat(parts, dim=dim)


def partition_leaves(leaves: Sequence[torch.Tensor],
                     bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES
                     ) -> List[List[int]]:
    """Greedy dtype-uniform partition of leaf indices into byte-budgeted
    groups, as the JAX module does it (a leaf over the budget gets its own
    group; order within a dtype kept). ``bucket_bytes=None``: one group per
    dtype."""
    name = lambda i: str(leaves[i].dtype).replace("torch.", "")  # noqa: E731
    order = sorted(range(len(leaves)), key=name)
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes, cur_dt = 0, None
    for i in order:
        dt = leaves[i].dtype
        nb = leaves[i].numel() * leaves[i].element_size()
        if cur and (dt != cur_dt or (bucket_bytes is not None
                                     and cur_bytes + nb > bucket_bytes)):
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dt = dt
    if cur:
        groups.append(cur)
    return groups


def bucketed_tree_psum(leaves: Sequence[torch.Tensor], axis_name: Any, *,
                       site: str,
                       bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                       bucket_bytes_dcn: Optional[int] = None,
                       compress: bool = False, wire_dtype: Any = torch.bfloat16,
                       hierarchical: bool = False, compress_intra: bool = False,
                       compress_dcn: bool = False) -> List[torch.Tensor]:
    """All-reduce a leaf list group by group (:func:`partition_leaves`);
    returns the reduced leaves in the original order and dtypes. Each group
    is ONE collective over its concatenated leaves; non-float groups always
    go uncompressed. On a two-level spec the uncompressed groups reduce by
    the chained per-axis sum (the flat spelling); ``hierarchical=True``
    sends each float group through :func:`hierarchical_psum` instead, with
    the per-tier knobs."""
    axes = hierarchical_axes(axis_name)
    if hierarchical and axes is None:
        raise ValueError(
            f"hierarchical=True needs a (slice, intra) axis spec; got {axis_name!r}")
    out: List[Any] = [None] * len(leaves)
    pending = []
    for group in partition_leaves(leaves, bucket_bytes):
        sub = [leaves[i] for i in group]
        if (compress or hierarchical) and sub[0].is_floating_point():
            flat = torch.cat([x.reshape(-1) for x in sub])
            if hierarchical:
                red = hierarchical_psum(flat, axes, site=site, bucket_bytes=None,
                                        bucket_bytes_dcn=bucket_bytes_dcn,
                                        compress_intra=compress_intra,
                                        compress_dcn=compress_dcn,
                                        wire_dtype=wire_dtype)
            else:
                red = _compressed_allreduce(flat, axis_name, site=site,
                                            wire_dtype=wire_dtype)
            off = 0
            for i, x in zip(group, sub):
                out[i] = red[off: off + x.numel()].view(x.shape).to(x.dtype)
                off += x.numel()
        elif axes is not None:
            for i, r in zip(group, _chained_psum(sub, axes, site=site)):
                out[i] = r
        else:
            red, work = comms.psum(sub, axis_name, site=site, async_op=True)
            pending.append(work)
            for i, r in zip(group, red):
                out[i] = r
    for work in pending:
        work.wait()
    return out


@dataclasses.dataclass(frozen=True)
class BucketedReduce:
    """Bundled bucketing policy, the knob object DDP and ZeRO carry.
    ``bucket_bytes=None``: one collective per arena; ``compress=True``:
    wire-dtype compression with fp32 accumulation. ``hierarchical=True``
    (a ``(slice, intra)`` ``axis_name``) sends reduces through the
    two-level engines, ``compress_intra``/``compress_dcn`` compressing each
    tier (``None`` takes ``compress``) and ``bucket_bytes_dcn`` sizing the
    DCN leg's collectives apart from the intra tier's."""

    axis_name: Any = DATA_AXIS
    bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES
    bucket_bytes_dcn: Optional[int] = None
    compress: bool = False
    wire_dtype: Any = torch.bfloat16
    hierarchical: bool = False
    compress_intra: Optional[bool] = None
    compress_dcn: Optional[bool] = None

    def __post_init__(self):
        if self.hierarchical and hierarchical_axes(self.axis_name) is None:
            raise ValueError(
                "hierarchical=True needs a (slice, intra) axis spec; got "
                f"{self.axis_name!r}")
        if self.bucket_bytes_dcn is not None and not self.hierarchical:
            raise ValueError(
                "bucket_bytes_dcn is a two-level knob; set hierarchical=True")

    def _tier_compress(self) -> Tuple[bool, bool]:
        ci = self.compress if self.compress_intra is None else self.compress_intra
        cd = self.compress if self.compress_dcn is None else self.compress_dcn
        return bool(ci), bool(cd)

    def psum(self, flat, *, site: str = "bucketed.psum"):
        if self.hierarchical:
            ci, cd = self._tier_compress()
            return hierarchical_psum(flat, hierarchical_axes(self.axis_name), site=site,
                                     bucket_bytes=self.bucket_bytes,
                                     bucket_bytes_dcn=self.bucket_bytes_dcn,
                                     compress_intra=ci, compress_dcn=cd,
                                     wire_dtype=self.wire_dtype)
        return bucketed_psum(flat, self.axis_name, site=site,
                             bucket_bytes=self.bucket_bytes,
                             compress=self.compress, wire_dtype=self.wire_dtype)

    def tree_psum(self, leaves, *, site: str = "bucketed.tree_psum"):
        ci, cd = self._tier_compress()
        return bucketed_tree_psum(leaves, self.axis_name, site=site,
                                  bucket_bytes=self.bucket_bytes,
                                  bucket_bytes_dcn=self.bucket_bytes_dcn,
                                  compress=self.compress,
                                  wire_dtype=self.wire_dtype,
                                  hierarchical=self.hierarchical,
                                  compress_intra=ci, compress_dcn=cd)

    def psum_scatter(self, flat, *, site: str = "bucketed.psum_scatter"):
        if self.hierarchical:
            ci, cd = self._tier_compress()
            return hierarchical_psum_scatter(
                flat, hierarchical_axes(self.axis_name), site=site,
                bucket_bytes=self.bucket_bytes, compress_intra=ci,
                compress_dcn=cd, wire_dtype=self.wire_dtype)
        return bucketed_psum_scatter(flat, self.axis_name, site=site,
                                     bucket_bytes=self.bucket_bytes,
                                     compress=self.compress,
                                     wire_dtype=self.wire_dtype)

    def all_gather(self, shard, *, site: str = "bucketed.all_gather",
                   logical_dtype: Any = None):
        if self.hierarchical:
            return hierarchical_all_gather(
                shard, hierarchical_axes(self.axis_name), site=site,
                bucket_bytes=self.bucket_bytes, logical_dtype=logical_dtype)
        return bucketed_all_gather(shard, self.axis_name, site=site,
                                   bucket_bytes=self.bucket_bytes,
                                   logical_dtype=logical_dtype)

    def n_buckets(self, n_elements: int, itemsize: int) -> int:
        return n_buckets(n_elements, itemsize, self.bucket_bytes)
