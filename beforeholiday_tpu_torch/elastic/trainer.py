"""ElasticTrainer — counterpart of ``beforeholiday_tpu/elastic/trainer.py``:
the loop that turns the shipped mechanisms into survivable training: async
shard checkpoints behind the step, failure detection, and live resharding to
the surviving world size.

Composition, not new physics:

* ZeRO-3 shard state and bitwise resharding (``optimizers.zero3``);
* StepGuard skip/rollback on the shard triplet
  (``guard.StepGuard.apply_sharded_update``);
* the replication tripwire (``parallel.check_replicated_consistency``), a
  ``mismatch`` flag in the step's row;
* fault injectors (``testing.faults.preempt_after``, ``hang_rank``);
* the async :class:`~beforeholiday_tpu_torch.elastic.checkpoint.CheckpointManager`.

One process a rank. Every process of the ``torch.distributed`` world runs
the same trainer; the live world is the first ``world`` of its ``ranks``, a
1-D data mesh (``carve_data_mesh``), and each live rank runs the loop on its
own shard (``ZeRO3FusedAdam.init`` gives it). Creating a process group is
collective over every process, and a rank that left a world takes no
further part, so the constructor carves, on every process at once, the
mesh of every world a resize may reach (each divisor of the rank count);
a resize then only switches meshes. A RESIZE EVENT (tripwire mismatch,
``SimulatedPreemption``, a preemption notice, a flagged hang) is handled as:

1. agree — before each step the ranks take one small ``pmax`` of their
   event flags over the group (booked ``elastic.events``), so a notice or a
   hang flag that reached one rank one step early makes every rank act at
   the same step; the tripwire needs no exchange, its flag is the same on
   every rank by construction;
2. drain — ``CheckpointManager.wait()`` makes every submitted generation
   durable;
3. reload — ``latest_generation`` finds the last durable manifest, and the
   ranks agree on its step over the new group;
4. reshard — ``zero3.reshard_state`` re-slices the arena bitwise and each
   rank keeps its own slice;
5. recarve — the surviving ranks switch to the new world's mesh and build
   a fresh step; ranks beyond the new world leave :meth:`run` with the
   event (``retired``) and take no further part;
6. continue — ``global_step`` rolls back to the checkpointed step and the
   loop replays forward, bitwise the uninterrupted run at the new world
   from the same generation.

Grow-back (``grow_when_available``): at a checkpoint boundary the live
ranks agree on the ``capacity_probe`` (its minimum) and resize up from the
generation just submitted; the returning processes call
:meth:`restore` with the new world at the same time (they meet the
survivors in the new world's first collective and reload the generation
the survivors agree on).

A rank that really dies (SIGKILL) takes the process group with it: recover
by launching a fresh world at the surviving size and calling
``restore(world=...)`` in it, as the SIGKILL drill does.

The user supplies ``make_step(mesh, world) -> step`` with ``step(state,
gstate, batch) -> (state, gstate, row)``: ``state`` is this rank's ZeRO-3
shard dict, ``batch`` the GLOBAL batch (the step takes its rank's part,
``mesh.axis_index``), ``row`` a dict of values replicated over the ranks
with ``"loss"`` and optionally ``"mismatch"`` (nonzero trips the tripwire:
the step's state is DISCARDED and the trainer reloads the last durable
generation). ``gstate`` is the StepGuard state (None without a guard) and
rides the generation manifest via ``StepGuard.state_dict`` in ``extra``.
The loop reads the row once per step, as the examples do, between steps.

``ElasticTrainer(device=None)`` runs on the card and raises without one;
``device="cpu"`` runs the plain path over gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from beforeholiday_tpu_torch.elastic import checkpoint as ckpt
from beforeholiday_tpu_torch.elastic.watchdog import RankHangError
from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.monitor.trace import active_recorder
from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.ops.arena import tree_map
from beforeholiday_tpu_torch.optimizers import zero3
from beforeholiday_tpu_torch.parallel.parallel_state import DATA_AXIS, carve_data_mesh
from beforeholiday_tpu_torch.testing.faults import SimulatedPreemption
from beforeholiday_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "ElasticTrainer",
    "ResizeEvent",
    "guard_state_specs",
    "zero3_state_specs",
]

# the per-step event flags the ranks agree on
_PREEMPT, _DRAIN, _SURVIVING, _HANG = range(4)


def _span(name: str):
    """Book ``name`` on the active timeline recorder (no-op otherwise) —
    the goodput classifier's raw material (``monitor.goodput``): ``step``
    around productive work, ``elastic:drain`` / ``elastic:restore`` /
    ``elastic:reshard`` / ``elastic:hang`` around the resize machinery."""
    rec = active_recorder()
    if rec is None:
        return contextlib.nullcontext()
    return rec.span(name)


def zero3_state_specs(axis_name: str = DATA_AXIS) -> Dict[str, tuple]:
    """How the ZeRO-3 state dict is laid out over the mesh, as the axes each
    entry is sharded over (a JAX ``PartitionSpec``'s tuple): the flat arenas
    shard on ``axis_name``, the step counter is replicated."""
    return {"master": (axis_name,), "exp_avg": (axis_name,),
            "exp_avg_sq": (axis_name,), "step": ()}


def guard_state_specs(guard, axis_name: str = DATA_AXIS):
    """The same for a gstate from ``guard.init(<zero3 state>)``: scaler and
    health leaves are replicated; the rollback snapshot, when armed, IS the
    shard triplet and shards like it."""
    from beforeholiday_tpu_torch.guard.step import _HEALTH_KEYS

    specs: Dict[str, Any] = {
        "scaler": {k: () for k in guard.scaler.init(device="cpu")},
        "health": {k: () for k in _HEALTH_KEYS},
    }
    if guard.rollback_after:
        specs["snapshot"] = zero3_state_specs(axis_name)
    return specs


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """One elastic resize (or graceful drain), as it happened."""

    reason: str          # "preemption" | "tripwire" | "hang" | "grow" |
                         # "manual" | "preemption_drain"
    at_step: int         # global step when the event fired
    old_world: int
    new_world: int
    resumed_from: int    # generation step the trainer reloaded
    stall_s: float = 0.0  # wall time the loop spent on drain+reload+reshard


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


class ElasticTrainer:
    """Survivable ZeRO-3 training loop with async generation checkpoints.

    Parameters
    ----------
    opt: a ``ZeRO3FusedAdam`` (its shard state is what gets checkpointed).
    layout: ``zero3.layout_of(params)`` — topology-independent, reused
        across resizes.
    make_step: ``(mesh, world) -> step`` factory; rebuilt on every resize.
    directory: checkpoint root, shared by every rank (generations land in
        ``gen_<step>``).
    guard: optional ``StepGuard`` — its state rides the manifest ``extra``.
    checkpoint_every: submit a generation every N committed steps (0 off).
    ranks: the global ranks the trainer may carve worlds from, in order
        (default every rank of the default group).
    survivor_policy: world -> surviving world when an event does not name
        one (default halve).
    min_world: resizing below this raises instead of limping on.
    hosts: multi-host checkpoint partition — each host's ranks write their
        shards and a host manifest; a resized world keeps the largest
        compatible partition (``zero3.effective_hosts``).
    notice: a :class:`~beforeholiday_tpu_torch.elastic.signals.PreemptionNotice`
        (installed by the caller) polled once per step.
    watchdog: a :class:`~beforeholiday_tpu_torch.elastic.watchdog.HangWatchdog`
        — the loop beats for every rank after each committed step and polls
        :meth:`~HangWatchdog.check`; a flagged hang resizes like a
        tripwire. Heartbeat state rides the manifest ``extra``.
    capacity_probe: ``() -> available rank count``, polled at checkpoint
        boundaries when ``grow_when_available`` is on.
    grow_when_available: enable grow-back (and permit resize targets above
        the current world).
    device: where the state lives (default the card; ``"cpu"`` for the
        plain path over gloo).
    """

    def __init__(
        self,
        opt,
        layout,
        make_step: Callable[[Any, int], Callable],
        *,
        directory: str,
        guard=None,
        checkpoint_every: int = 5,
        queue_depth: int = 2,
        keep: int = 2,
        ranks: Optional[Sequence[int]] = None,
        axis_name: str = DATA_AXIS,
        min_world: int = 1,
        survivor_policy: Optional[Callable[[int], int]] = None,
        hosts: int = 1,
        notice=None,
        watchdog=None,
        capacity_probe: Optional[Callable[[], int]] = None,
        grow_when_available: bool = False,
        device=None,
    ):
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "dist.init_process_group before ElasticTrainer")
        self.opt = opt
        self.layout = layout
        self.make_step = make_step
        self.directory = directory
        self.guard = guard
        self.checkpoint_every = int(checkpoint_every)
        self.queue_depth = int(queue_depth)
        self.keep = int(keep)
        self.axis_name = axis_name
        self.min_world = int(min_world)
        self.survivor_policy = survivor_policy or (lambda w: w // 2)
        self.hosts = int(hosts)
        self.notice = notice
        self.watchdog = watchdog
        self.capacity_probe = capacity_probe
        self.grow_when_available = bool(grow_when_available)
        self._ranks = np.asarray(
            range(dist.get_world_size()) if ranks is None else list(ranks),
            dtype=np.int64).ravel()
        n = int(self._ranks.size)
        # every world a resize may reach, carved now on every process
        self._meshes = {w: carve_data_mesh(w, ranks=self._ranks,
                                           axis_name=axis_name)
                        for w in range(1, n + 1) if n % w == 0}
        self.world: Optional[int] = None
        self.mesh = None
        self.retired = False
        self.global_step = 0
        self.events: List[ResizeEvent] = []
        self.history: List[Dict[str, Any]] = []
        self._state = None
        self._gstate = None
        self._step_fn = None
        self._manager: Optional[ckpt.CheckpointManager] = None

    @property
    def state(self):
        """This rank's live ZeRO-3 shard state (None once retired)."""
        return self._state

    @property
    def gstate(self):
        """Live StepGuard state (None without a guard)."""
        return self._gstate

    # ------------------------------------------------------------- lifecycle
    def init(self, params, *, world: Optional[int] = None) -> None:
        """Fresh start: enter the world's mesh, take this rank's shard of
        ``opt.init(params)``, seed the guard state from the shard triplet
        (the rollback snapshot is shard-sized). Every process calls it; the
        ones beyond ``world`` come back retired."""
        self._install_world(world or len(self._ranks))
        self.global_step = 0
        if self.retired:
            return
        params = tree_map(lambda t: t.to(self.device), params)
        with self.mesh:
            self._state = self.opt.init(params)
        self._gstate = (self.guard.init(self._state, device=self.device)
                        if self.guard is not None else None)

    def restore(self, *, world: int, directory: Optional[str] = None) -> int:
        """Resume from the last DURABLE generation at ``world`` ranks: switch
        to that world's mesh, agree on the generation, load it, ``reshard_state`` (bitwise) and
        keep this rank's slice, rebuild the step, and reload guard and
        scaler state from the manifest ``extra``. Returns the generation
        step resumed from (``global_step`` is rolled back to it). A fresh
        world after a lost rank, and a process that returns for a grow,
        call this."""
        src = directory or self.directory
        gen = ckpt.latest_generation(src)
        if gen is None:
            raise FileNotFoundError(f"no durable checkpoint generation under {src!r}")
        self._install_world(world)
        if self.retired:
            self.global_step = gen[0]
            return self.global_step
        # the ranks may have scanned at different moments of a grow: the
        # newest any of them saw is durable for all
        step = self._agree([gen[0]])[0]
        manifest, shards = zero3.load_shard_files(ckpt.generation_dir(src, step))
        mine = zero3.reshard_state(shards, manifest, world)[self._index]
        with self.mesh:
            state = self.opt.load_state_dict(self.layout, mine)
        self._state = {k: v.to(self.device, copy=True) for k, v in state.items()}
        extra = manifest.get("extra") or {}
        if self.guard is not None:
            sd = extra.get("guard")
            if sd is None:
                self._gstate = self.guard.init(self._state, device=self.device)
            else:
                self._gstate = self.guard.load_state_dict(
                    sd, params=self._state if self.guard.rollback_after else None,
                    device=self.device)
        if self.watchdog is not None:
            hb = extra.get("heartbeats")
            if hb is not None and int(hb.get("world", -1)) == world:
                # same topology: restore last-heard steps (the clocks re-arm
                # now); a resharded world keeps the fresh ledger
                self.watchdog.load_state_dict(hb)
        self.global_step = int(manifest.get("step", step))
        return self.global_step

    def close(self) -> None:
        if self._manager is not None:
            self._manager.close()
            self._manager = None

    def __enter__(self) -> "ElasticTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- the loop
    def run(self, n_steps: int, batch_fn: Callable[[int], Any], *,
            preemption: Optional[Callable[[], None]] = None
            ) -> List[Dict[str, Any]]:
        """Advance ``n_steps`` COMMITTED steps past the current
        ``global_step``, surviving resize events along the way (replayed
        steps after a reload count toward the same target).

        ``batch_fn(global_step)`` returns the GLOBAL batch — key it on the
        step so a replay after reload sees identical data. ``preemption``
        is an injector called once per step (``faults.preempt_after``); its
        ``SimulatedPreemption`` becomes a resize event (or, with ``drain``,
        a graceful drain: the generation made durable and a clean return).
        A rank the resize leaves out returns at once (``retired``). Returns
        the history rows appended by this call (``{"step", "world",
        "loss"}``)."""
        appended = len(self.history)
        if self.retired:
            return []
        if self._step_fn is None:
            raise RuntimeError("call init() or restore() before run()")
        target = self.global_step + int(n_steps)
        while self.global_step < target:
            flags = self._poll(preemption)
            if flags[_PREEMPT] and flags[_DRAIN]:
                # graceful notice: this process is going away — make the
                # state durable and hand control back
                t0 = time.perf_counter()
                with _span("elastic:drain"):
                    self.checkpoint_now(wait=True)
                self.events.append(ResizeEvent(
                    reason="preemption_drain", at_step=self.global_step,
                    old_world=self.world, new_world=self.world,
                    resumed_from=self.global_step,
                    stall_s=time.perf_counter() - t0))
                logger.warning("graceful drain at step %d: generation durable, "
                               "returning", self.global_step)
                return self.history[appended:]
            if flags[_PREEMPT]:
                surviving = flags[_SURVIVING] or self.survivor_policy(self.world)
                self._resize(surviving, reason="preemption")
            elif flags[_HANG]:
                # a silent rank is a lost rank that never said so
                logger.warning("hang watchdog fired at step %d; resharding",
                               self.global_step)
                self._resize(self.survivor_policy(self.world), reason="hang")
            else:
                with self.mesh, _span("step"):
                    batch = batch_fn(self.global_step)
                    new_state, new_gstate, row = self._step_fn(
                        self._state, self._gstate, batch)
                    fetched = {k: _host(v) for k, v in row.items()}
                mism = fetched.get("mismatch")
                if mism is not None and bool(np.any(mism)):
                    # a replicated-by-construction value diverged across
                    # ranks: the step's output is poisoned — reload
                    logger.warning("consistency tripwire fired at step %d; "
                                   "resharding", self.global_step)
                    self._resize(self.survivor_policy(self.world), reason="tripwire")
                else:
                    self._commit(new_state, new_gstate, fetched)
            if self.retired:
                break
        return self.history[appended:]

    def _commit(self, new_state, new_gstate, fetched) -> None:
        self._state, self._gstate = new_state, new_gstate
        self.global_step += 1
        if self.watchdog is not None:
            # every rank stepped (the step's collectives completed);
            # injected hangs suppress individual beats
            self.watchdog.beat_all(self.global_step)
        self.history.append({"step": self.global_step, "world": self.world,
                             "loss": float(fetched["loss"])})
        if (self._manager is not None and self.checkpoint_every
                and self.global_step % self.checkpoint_every == 0):
            self._submit_checkpoint()
            self._maybe_grow()

    def checkpoint_now(self, *, wait: bool = False) -> str:
        """Submit a generation for the current state immediately; with
        ``wait=True`` block until it is durable."""
        path = self._submit_checkpoint()
        if wait:
            self._manager.wait()
        return path

    # ------------------------------------------------------------- internals
    @property
    def _index(self) -> int:
        return self.mesh.axis_index(self.axis_name)

    def _agree(self, values: List[int]) -> List[int]:
        """The element-wise max of ``values`` over the live ranks."""
        if self.world == 1:
            return [int(v) for v in values]
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        with self.mesh:
            return comms.pmax(t, self.axis_name, site="elastic.events").tolist()

    def _poll(self, preemption) -> List[int]:
        """This rank's event flags for the coming step, agreed over the live
        ranks: ``[preempt, drain, surviving world (0 = policy), hang]``."""
        flags = [0, 0, 0, 0]
        try:
            if preemption is not None:
                preemption()
            if self.notice is not None:
                self.notice.tick()
            if self.watchdog is not None:
                self.watchdog.check()
        except SimulatedPreemption as e:
            flags[_PREEMPT], flags[_DRAIN] = 1, int(e.drain)
            flags[_SURVIVING] = int(e.surviving_world or 0)
        except RankHangError as e:
            logger.warning("rank %d flagged silent (%s)", e.rank, e)
            flags[_HANG] = 1
        return self._agree(flags)

    def _submit_checkpoint(self) -> str:
        extra: Dict[str, Any] = {}
        if self.guard is not None:
            extra["guard"] = self.guard.state_dict(self._gstate)
        if self.watchdog is not None:
            extra["heartbeats"] = self.watchdog.state_dict()
        return self._manager.submit(self.global_step, self._state,
                                    extra=extra or None)

    def _maybe_grow(self) -> None:
        """Checkpoint-boundary grow-back: when the live ranks agree the
        capacity probe has room for a larger valid world, resize UP from the
        generation just submitted (no committed step is lost)."""
        if not (self.grow_when_available and self.capacity_probe):
            return
        cap = -self._agree([-int(self.capacity_probe())])[0]  # the minimum
        target = self._grow_target(cap)
        if target is None:
            return
        logger.warning("capacity probe reports %d ranks available at step %d; "
                       "growing %d -> %d", cap, self.global_step, self.world, target)
        self._resize(target, reason="grow")

    def _grow_target(self, capacity: int) -> Optional[int]:
        """Largest world > the current one that divides the rank count and
        fits ``capacity`` (None when capacity allows no growth)."""
        n = int(self._ranks.size)
        for w in range(min(capacity, n), self.world, -1):
            if n % w == 0:
                return w
        return None

    def _validate_resize_target(self, new_world: int, *, reason: str) -> None:
        """A survivor policy (or event payload) naming a bad world fails
        loudly."""
        n = int(self._ranks.size)
        if new_world < 1:
            raise ValueError(f"resize target must be >= 1, got {new_world} "
                             f"(reason={reason!r})")
        if n % new_world:
            raise ValueError(
                f"resize target {new_world} does not divide the device count "
                f"{n} — the ZeRO-3 arena reshards only onto worlds that tile "
                f"the slice (reason={reason!r})")
        if new_world == self.world:
            raise ValueError(
                f"resize target {new_world} equals the current world "
                f"(reason={reason!r}) — a resize must change the world; "
                "grow-back reclaims returned capacity at checkpoint boundaries "
                "instead of re-resizing in place")
        if new_world > self.world and not (self.grow_when_available
                                           or reason == "manual"):
            raise ValueError(
                f"resize target {new_world} grows past the current world "
                f"{self.world} but grow_when_available is off (reason={reason!r})")

    def _resize(self, new_world: int, *, reason: str) -> None:
        new_world = int(new_world)
        self._validate_resize_target(new_world, reason=reason)
        if new_world < max(1, self.min_world):
            raise RuntimeError(f"resize to world={new_world} is below min_world="
                               f"{self.min_world}; cannot continue")
        old_world, at = self.world, self.global_step
        t0 = time.perf_counter()
        outer = "elastic:hang" if reason == "hang" else "elastic:reshard"
        with _span(outer):
            if self._manager is not None:
                with _span("elastic:drain"):
                    self._manager.wait()
            with _span("elastic:restore"):
                resumed = self.restore(world=new_world)
        self.events.append(ResizeEvent(
            reason=reason, at_step=at, old_world=old_world, new_world=new_world,
            resumed_from=resumed, stall_s=time.perf_counter() - t0))
        logger.warning("elastic resize (%s) at step %d: world %d -> %d, resumed "
                       "from generation %d%s", reason, at, old_world, new_world,
                       resumed, "; this rank retires" if self.retired else "")

    def _install_world(self, world: int) -> None:
        if self._manager is not None:
            self._manager.close()
            self._manager = None
        if world not in self._meshes:
            raise ValueError(f"world {world} does not divide the {self._ranks.size} "
                             "rank(s) the trainer carves from")
        self.world = int(world)
        if dist.get_rank() not in self._ranks[:world]:
            # left out of the new world: no group, no step, no checkpoint
            self.retired = True
            self.mesh, self._step_fn = None, None
            self._state = self._gstate = None
            return
        self.retired = False
        self.mesh = self._meshes[self.world]
        self._step_fn = self.make_step(self.mesh, self.world)
        manifest = zero3.shard_manifest(
            self.layout, self.world,
            hosts=zero3.effective_hosts(self.world, self.hosts))
        # names this world's writes in a generation directory: fresh for
        # every carve, the same on every rank
        token = self._agree([random.SystemRandom().getrandbits(62)])[0]
        self._manager = ckpt.CheckpointManager(
            self.directory, manifest, queue_depth=self.queue_depth, keep=self.keep,
            rank=self._index, token=f"{token:016x}")
        if self.watchdog is not None:
            # fresh beat clocks for the new world — a resize must not
            # inherit the silence window that triggered it
            self.watchdog.reset(self.world)
