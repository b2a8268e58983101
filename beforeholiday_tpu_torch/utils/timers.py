"""Back-compat shim — the wall-clock timers live in
:mod:`beforeholiday_tpu_torch.monitor.spans`; this module re-exports the JAX
package's ``utils/timers.py`` surface."""

from __future__ import annotations

from beforeholiday_tpu_torch.monitor.spans import Timers, _Timer  # noqa: F401

__all__ = ["Timers"]
