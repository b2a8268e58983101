"""Observability — counterpart of ``beforeholiday_tpu/monitor``, in part:
the serving path's signature gate (``compile``), trace spans (``spans``)
and the collective-traffic ledger (``comms``)."""

from beforeholiday_tpu_torch.monitor import comms, spans  # noqa: F401
from beforeholiday_tpu_torch.monitor.comms import (  # noqa: F401
    comms_records,
    comms_summary,
    ledger_scope,
    reset_comms_ledger,
)
from beforeholiday_tpu_torch.monitor.compile import (  # noqa: F401
    BucketGateError,
    track_compiles,
)
from beforeholiday_tpu_torch.monitor.spans import annotate, span  # noqa: F401

__all__ = ["BucketGateError", "annotate", "comms", "comms_records",
           "comms_summary", "ledger_scope", "reset_comms_ledger", "span",
           "spans", "track_compiles"]
