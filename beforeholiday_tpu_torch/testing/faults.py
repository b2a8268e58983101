"""Deterministic, seedable fault injectors — counterpart of
``beforeholiday_tpu/testing/faults.py`` for the guard and DDP paths.

* :func:`poison_grads`       — NaN/Inf ``n`` leaves of a grad tree (the
  overflow the guard must catch). The leaves are picked with Python's
  ``random.Random(seed)`` over the same candidate list as the JAX injector,
  and element 0 of each is poisoned, so both packages poison the same
  elements of the same leaves (a :class:`PackedParams` is one leaf per
  arena, as in JAX);
* :func:`perturb_rank_grads` — corrupt ONE rank's grads (the silent
  divergence ``check_replicated_consistency`` must flag);
* :func:`preempt_after`      — raise :class:`SimulatedPreemption` on the n-th
  tick;
* :func:`kill_rank`          — SIGKILL/SIGTERM a subprocess rank.

``force_probe_failure`` has no counterpart (the port has no probe);
``hang_rank`` and ``tear_host_generation`` need ``elastic/``, which is not
ported yet.
"""

from __future__ import annotations

import random
import signal
from typing import Any, Callable, Optional

import torch

from beforeholiday_tpu_torch.ops.arena import PackedParams, tree_flatten, tree_unflatten


class SimulatedPreemption(RuntimeError):
    """In-process stand-in for a preemption notice or a lost rank.
    ``surviving_world`` names the world that remains, ``drain=True`` marks a
    graceful notice."""

    def __init__(self, message: str = "simulated preemption", *,
                 surviving_world: Optional[int] = None, drain: bool = False):
        super().__init__(message)
        self.surviving_world = surviving_world
        self.drain = bool(drain)


def _flatten(grads):
    if isinstance(grads, PackedParams):
        return list(grads.arenas), grads.replace_arenas
    leaves, treedef = tree_flatten(grads)
    return leaves, lambda new: tree_unflatten(treedef, new)


def poison_grads(grads: Any, *, n: int = 1, value: float = float("nan"),
                 seed: int = 0, whole_leaf: bool = False) -> Any:
    """``grads`` with ``n`` floating leaves poisoned by ``value``: element
    0 of each (``whole_leaf``: every element). Returns new tensors; the
    input is not modified. Plugs into ``reduce_grads``."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    leaves, rebuild = _flatten(grads)
    candidates = [i for i, t in enumerate(leaves)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not candidates:
        raise ValueError("no inexact leaves to poison")
    picks = random.Random(seed).sample(candidates, min(n, len(candidates)))
    leaves = list(leaves)
    for i in picks:
        if whole_leaf:
            leaves[i] = torch.full_like(leaves[i], value)
        else:
            leaves[i] = leaves[i].clone()
            leaves[i].view(-1)[0] = value
    return rebuild(leaves)


def perturb_rank_grads(grads: Any, axis_name: Any = "data", rank: int = 0, *,
                       eps: float = 1e-3, value: Optional[float] = None) -> Any:
    """Corrupt the floating grads of the process at index ``rank`` of the
    ``axis_name`` group: add ``eps`` (a silent divergence), or overwrite
    with ``value``. Other ranks get their grads back untouched."""
    import torch.distributed as dist

    from beforeholiday_tpu_torch.parallel import parallel_state

    me = dist.get_rank(parallel_state.get_group(axis_name))
    leaves, rebuild = _flatten(grads)
    if me != rank:
        return grads
    out = []
    for g in leaves:
        if isinstance(g, torch.Tensor) and g.is_floating_point():
            g = torch.full_like(g, value) if value is not None else g + eps
        out.append(g)
    return rebuild(out)


def preempt_after(n_steps: int, *, surviving_world: Optional[int] = None
                  ) -> Callable[[], None]:
    """A ``tick()`` whose ``n_steps``-th call raises
    :class:`SimulatedPreemption` (once)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    calls = {"n": 0}

    def tick() -> None:
        calls["n"] += 1
        if calls["n"] == n_steps:
            raise SimulatedPreemption(
                f"simulated preemption on tick {n_steps}",
                surviving_world=surviving_world)

    return tick


def kill_rank(proc, *, sig: int = signal.SIGKILL, timeout: float = 30.0) -> int:
    """Deliver ``sig`` to a subprocess rank (a ``subprocess.Popen``) and
    reap it; returns its exit code (minus the signal number on POSIX)."""
    proc.send_signal(sig)
    return proc.wait(timeout=timeout)
