"""Observability — only the serving path's signature gate is ported so far."""

from beforeholiday_tpu_torch.monitor.compile import (  # noqa: F401
    BucketGateError,
    track_compiles,
)

__all__ = ["BucketGateError", "track_compiles"]
