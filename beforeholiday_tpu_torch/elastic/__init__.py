"""Elastic training — counterpart of ``beforeholiday_tpu/elastic``: async
shard checkpoints, live resharding, preemption survival.

Training jobs get preempted, lose hosts, and resume at different world
sizes. This package composes the port's mechanisms — ZeRO-3 per-rank shard
checkpoints with bitwise resharding, StepGuard health state, the
replication tripwire, and the flight recorder — into a survivable loop:

* :class:`~beforeholiday_tpu_torch.elastic.checkpoint.CheckpointManager` —
  async generation checkpoints (a side-stream device-to-host copy into
  pinned buffers that the next in-place optimizer step waits for, a
  background writer with atomic writes, bounded in-flight generations),
  every stall booked to the ``ckpt`` ledger (:func:`ckpt_summary`); each
  rank writes its own shard and rank 0 stamps the manifest last; with
  ``hosts=N`` each host stamps a host manifest and a generation is durable
  only when ALL hosts stamped.
* :class:`~beforeholiday_tpu_torch.elastic.trainer.ElasticTrainer` — the
  loop (one process a rank) that treats a tripwire mismatch, a simulated
  or signal-delivered preemption, or a watchdog-flagged hang as a resize
  event the ranks agree on: drain, reload the last durable manifest,
  ``reshard_state`` to the surviving world on a freshly carved mesh,
  continue bitwise. Shrink AND grow.
* :class:`~beforeholiday_tpu_torch.elastic.signals.PreemptionNotice` — a
  SIGTERM/SIGUSR1 handler sets a host flag the loop polls once per step;
  composes with the flight recorder's ``arm_preemption_dump`` (dump first,
  then graceful drain).
* :class:`~beforeholiday_tpu_torch.elastic.watchdog.HangWatchdog` —
  liveness for the rank that hangs rather than dies.

A rank that is SIGKILLed takes the process group with it: the drill
(``chip_smoke.py``'s ``elastic_kill_card``) relaunches a fresh world that
calls ``ElasticTrainer.restore(world=...)``. Tests:
``tests/test_torch_elastic.py`` and ``tests/test_torch_elastic_world.py``.
"""

from beforeholiday_tpu_torch.elastic.checkpoint import (
    CheckpointManager,
    ckpt_records,
    ckpt_summary,
    generation_dir,
    latest_generation,
    list_generations,
    reset_ckpt_ledger,
)
from beforeholiday_tpu_torch.elastic.signals import PreemptionNotice
from beforeholiday_tpu_torch.elastic.trainer import (
    ElasticTrainer,
    ResizeEvent,
    guard_state_specs,
    zero3_state_specs,
)
from beforeholiday_tpu_torch.elastic.watchdog import (
    HangWatchdog,
    RankHangError,
    reset_watchdog_ledger,
    watchdog_records,
)

__all__ = [
    "CheckpointManager",
    "ElasticTrainer",
    "HangWatchdog",
    "PreemptionNotice",
    "RankHangError",
    "ResizeEvent",
    "ckpt_records",
    "ckpt_summary",
    "guard_state_specs",
    "latest_generation",
    "list_generations",
    "reset_ckpt_ledger",
    "reset_watchdog_ledger",
    "watchdog_records",
    "zero3_state_specs",
]
