"""Mergeable streaming histograms with a fixed log-spaced bucket geometry —
counterpart of ``beforeholiday_tpu/monitor/histo.py``.

The serving telemetry (TTFT, inter-token gaps, e2e) needs quantiles that
(a) never hold raw samples, (b) merge across ranks and processes by plain
addition, and (c) carry an *analytic* error bound, so a gate on p99 means
something. A log-spaced geometry gives all three:

* Buckets are ``[lo * b**(i/k), lo * b**((i+1)/k))`` for base ``b`` (10 here)
  and ``k`` bins per decade. The geometry is a pure function of
  ``(lo, decades, bins_per_decade)``: two histograms built with the same
  knobs have identical edges, so merging is integer bucket-count addition
  (bitwise-exact, order-independent, associative).
* A quantile estimate is the *upper edge* of the bucket holding the rank-th
  sample; the true sample lies in the same bucket, so the relative
  overestimate is at most ``quantile_error_bound = b**(1/k) - 1``.
* ``update`` is the host path (numpy); ``bucketize`` the device path: a
  tensor of samples on any device mapped to a count vector on that device
  (``torch.searchsorted`` into the fp32 edges, then ``index_add_`` into
  fixed zeros, so the output's size never depends on the data and nothing
  is read back to the host). Fold the fetched vector in with
  ``add_counts``.

Out-of-range samples are not dropped: values below ``lo`` land in an
underflow bucket (reported as ``lo``), values at or above the top edge in an
overflow bucket (reported as the top edge). The error bound applies to
in-range samples only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Histogram"]


class Histogram:
    """Fixed-geometry log-spaced histogram (see module docstring).

    Counts live on the host as int64; ``update`` is the host path,
    ``bucketize`` the device path (returns a count vector to fold in later
    with ``add_counts``).
    """

    __slots__ = ("lo", "decades", "bins_per_decade", "_edges", "_counts",
                 "_device_edges")

    def __init__(self, *, lo: float = 1e-6, decades: int = 9,
                 bins_per_decade: int = 20):
        if lo <= 0.0:
            raise ValueError(f"lo must be positive, got {lo}")
        if decades < 1 or bins_per_decade < 1:
            raise ValueError("decades and bins_per_decade must be >= 1")
        self.lo = float(lo)
        self.decades = int(decades)
        self.bins_per_decade = int(bins_per_decade)
        n_bins = self.decades * self.bins_per_decade
        # Edges computed from integer exponents (not cumulative products) so
        # every process with the same knobs gets bitwise-identical edges.
        exponents = np.arange(n_bins + 1, dtype=np.float64)
        self._edges = self.lo * np.power(
            10.0, exponents / self.bins_per_decade
        )
        # Slot 0 = underflow, 1..n_bins = bins, n_bins+1 = overflow. This is
        # exactly the index np.searchsorted(edges, v, side="right") yields.
        self._counts = np.zeros(n_bins + 2, dtype=np.int64)
        self._device_edges: Dict[Any, Any] = {}  # device -> fp32 edges tensor

    # ------------------------------------------------------------ geometry

    @property
    def geometry(self) -> Dict[str, Any]:
        return {
            "lo": self.lo,
            "decades": self.decades,
            "bins_per_decade": self.bins_per_decade,
        }

    @property
    def quantile_error_bound(self) -> float:
        """Max relative error of ``quantile`` for in-range samples:
        ``10**(1/bins_per_decade) - 1`` (the per-bucket growth ratio minus
        one; the estimate is the bucket's upper edge, the sample is inside
        the bucket)."""
        return 10.0 ** (1.0 / self.bins_per_decade) - 1.0

    @property
    def n_bins(self) -> int:
        return self.decades * self.bins_per_decade

    @property
    def count(self) -> int:
        total = self._counts.sum()
        return int(total)

    def counts(self) -> np.ndarray:
        """Copy of the count vector (underflow, bins..., overflow)."""
        return self._counts.copy()

    # ------------------------------------------------------------ host path

    def update(self, values: Any) -> "Histogram":
        """Fold host samples in (scalar or array-like). Returns self."""
        vals = np.asarray(values, dtype=np.float64).reshape(-1)
        if vals.size == 0:
            return self
        idx = np.searchsorted(self._edges, vals, side="right")
        self._counts += np.bincount(idx, minlength=self._counts.size).astype(
            np.int64
        )
        return self

    def add_counts(self, counts: Any) -> "Histogram":
        """Fold a count vector in (e.g. the output of ``bucketize`` after
        the caller's own device→host fetch). Returns self."""
        arr = np.asarray(counts, dtype=np.int64).reshape(-1)
        if arr.size != self._counts.size:
            raise ValueError(
                f"count vector has {arr.size} slots, geometry expects "
                f"{self._counts.size}"
            )
        self._counts += arr
        return self

    def merge(self, other: "Histogram") -> "Histogram":
        """Merge another histogram of identical geometry into this one by
        bucket-count addition (bitwise-exact). Returns self."""
        if not isinstance(other, Histogram):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if self.geometry != other.geometry:
            raise ValueError(
                f"geometry mismatch: {self.geometry} vs {other.geometry}"
            )
        self._counts += other._counts
        return self

    # ---------------------------------------------------------- device path

    def bucketize(self, values: Any):
        """Device path: map samples (a tensor on any device, or array-like)
        to an int32 count vector of shape ``(n_bins + 2,)`` on the samples'
        device, the bins the host path's ``np.searchsorted(side="right")``
        picks, compared in fp32. No host readback, no data-dependent output
        size. Fold the fetched result in with ``add_counts``."""
        import torch

        flat = torch.as_tensor(values).reshape(-1).to(torch.float32)
        edges = self._device_edges.get(flat.device)
        if edges is None:
            edges = torch.as_tensor(self._edges, dtype=torch.float32).to(flat.device)
            self._device_edges[flat.device] = edges
        idx = torch.searchsorted(edges, flat, right=True)
        counts = torch.zeros(self._counts.size, dtype=torch.int32,
                             device=flat.device)
        return counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))

    # ------------------------------------------------------------ quantiles

    def quantile(self, q: float) -> float:
        """Upper-edge quantile estimate. Rank convention matches a host sort
        oracle: rank = 0 for q<=0 else ``min(n-1, ceil(q*n)-1)``; relative
        error vs ``sorted(samples)[rank]`` is at most
        ``quantile_error_bound`` for in-range samples."""
        n = self.count
        if n == 0:
            return float("nan")
        if q <= 0.0:
            rank = 0
        else:
            rank = min(n - 1, int(np.ceil(q * n)) - 1)
        cum = np.cumsum(self._counts)
        slot = int(np.searchsorted(cum, rank + 1, side="left"))
        # Upper edge of the slot: underflow reports lo (edge 0); slot j in
        # 1..n_bins reports edges[j]; overflow clamps to the top edge.
        edge_idx = min(max(slot, 0), self._edges.size - 1)
        edge = self._edges[edge_idx]
        return float(edge)

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "quantile_error_bound": self.quantile_error_bound,
        }

    # ---------------------------------------------------------------- misc

    def reset(self) -> None:
        self._counts[:] = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Histogram(lo={self.lo}, decades={self.decades}, "
            f"bins_per_decade={self.bins_per_decade}, count={self.count})"
        )
