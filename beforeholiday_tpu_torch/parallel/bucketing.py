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

Uncompressed bucketing is bitwise equal to one collective per arena. The
two-level (slice x intra) engines and the bucketed scatter/gather family
(ZeRO's) are not ported yet and raise; the chunked gather and
reduce-scatter of the sequence-parallel mappings are.
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
    "bucketed_psum",
    "bucketed_tree_psum",
    "chunked_all_gather",
    "chunked_reduce_scatter",
    "compression_error_bound",
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

_TWO_LEVEL = ("the two-level (slice, intra) engines, which come with ZeRO and "
              "the multi-slice mesh")


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


def static_axis_size(axis_name: Any) -> int:
    """The size of the group ``axis_name`` names, as a host int."""
    if hierarchical_axes(axis_name) is not None:
        raise NotImplementedError(f"a two-level axis spec needs {_TWO_LEVEL}")
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
    place."""
    if compress:
        return _compressed_allreduce(piece, axis_name, site=site,
                                     wire_dtype=wire_dtype).to(piece.dtype), None
    return comms.psum(piece, axis_name, site=site, async_op=True, inplace=True)


def bucketed_psum(flat: torch.Tensor, axis_name: Any, *, site: str,
                  bucket_bytes: Optional[int] = DEFAULT_BUCKET_BYTES,
                  compress: bool = False, wire_dtype: Any = torch.bfloat16,
                  inplace: bool = False) -> torch.Tensor:
    """All-reduce a flat (1-D) arena as independent per-bucket collectives,
    all issued before the first is waited. Uncompressed buckets are
    bitwise equal to one collective over the arena. ``compress=True`` puts
    each bucket on the wire in ``wire_dtype`` with fp32 accumulation and
    returns in the input dtype. ``inplace`` reduces ``flat`` itself."""
    if flat.ndim != 1:
        raise ValueError(f"bucketed_psum wants a flat arena, got {tuple(flat.shape)}")
    if hierarchical_axes(axis_name) is not None:
        raise NotImplementedError(f"a two-level axis spec needs {_TWO_LEVEL}")
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
                       compress: bool = False, wire_dtype: Any = torch.bfloat16,
                       hierarchical: bool = False, **_tier_knobs
                       ) -> List[torch.Tensor]:
    """All-reduce a leaf list group by group (:func:`partition_leaves`);
    returns the reduced leaves in the original order and dtypes. Each group
    is ONE collective over its concatenated leaves; non-float groups always
    go uncompressed."""
    if hierarchical or hierarchical_axes(axis_name) is not None:
        raise NotImplementedError(f"hierarchical reduction needs {_TWO_LEVEL}")
    out: List[Any] = [None] * len(leaves)
    pending = []
    for group in partition_leaves(leaves, bucket_bytes):
        sub = [leaves[i] for i in group]
        if compress and sub[0].is_floating_point():
            flat = torch.cat([x.reshape(-1) for x in sub])
            red = _compressed_allreduce(flat, axis_name, site=site,
                                        wire_dtype=wire_dtype)
            off = 0
            for i, x in zip(group, sub):
                out[i] = red[off: off + x.numel()].view(x.shape).to(x.dtype)
                off += x.numel()
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
    """Bundled bucketing policy, the knob object DDP carries.
    ``bucket_bytes=None``: one collective per arena; ``compress=True``:
    wire-dtype compression with fp32 accumulation. ``hierarchical`` and the
    per-tier knobs need the two-level engines, which are not ported yet."""

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
        if self.hierarchical:
            raise NotImplementedError(f"hierarchical=True needs {_TWO_LEVEL}")

    def psum(self, flat, *, site: str = "bucketed.psum"):
        return bucketed_psum(flat, self.axis_name, site=site,
                             bucket_bytes=self.bucket_bytes,
                             compress=self.compress, wire_dtype=self.wire_dtype)

    def tree_psum(self, leaves, *, site: str = "bucketed.tree_psum"):
        return bucketed_tree_psum(leaves, self.axis_name, site=site,
                                  bucket_bytes=self.bucket_bytes,
                                  compress=self.compress,
                                  wire_dtype=self.wire_dtype)

    def psum_scatter(self, flat, *, site: str = "bucketed.psum_scatter"):
        raise NotImplementedError(
            "the bucketed reduce-scatter (ZeRO's) is not ported yet")

    def all_gather(self, shard, *, site: str = "bucketed.all_gather",
                   logical_dtype: Any = None):
        raise NotImplementedError(
            "the bucketed all-gather (ZeRO's) is not ported yet")

    def n_buckets(self, n_elements: int, itemsize: int) -> int:
        return n_buckets(n_elements, itemsize, self.bucket_bytes)
