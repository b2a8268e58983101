"""Guardrails — counterpart of ``beforeholiday_tpu/guard``: the device-side
step guard (:class:`StepGuard`). ``guard/dispatch.py`` (probe a kernel,
then degrade to the plain path) has no counterpart: the port's wrappers
launch their kernel or raise. Fault injectors live in
:mod:`beforeholiday_tpu_torch.testing.faults`."""

from beforeholiday_tpu_torch.guard.step import (  # noqa: F401
    SKIP_GRAD_OVERFLOW,
    SKIP_LOSS_NONFINITE,
    SKIP_NONE,
    SKIP_PARAM_NONFINITE,
    SKIP_REASON_NAMES,
    SKIP_ROLLBACK,
    StepGuard,
    health_summary,
)

__all__ = ["SKIP_GRAD_OVERFLOW", "SKIP_LOSS_NONFINITE", "SKIP_NONE",
           "SKIP_PARAM_NONFINITE", "SKIP_REASON_NAMES", "SKIP_ROLLBACK",
           "StepGuard", "health_summary"]
