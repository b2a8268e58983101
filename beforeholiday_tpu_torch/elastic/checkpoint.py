"""Async overlapped ZeRO-3 shard checkpointing — counterpart of
``beforeholiday_tpu/elastic/checkpoint.py``: generations behind the step.

A synchronous checkpoint (``zero3.save_shard_files`` between steps) exposes
the whole device-to-host copy, serialization and write on the training
thread. This module hides it:

* :meth:`CheckpointManager.submit` starts the device-to-host copy of the
  state on a side stream, into pinned host buffers reused across
  generations (``queue_depth`` sets), and enqueues the generation; the
  training thread returns once the copies are enqueued. The state is
  updated in place by the next optimizer step (K6 in shard mode), so the
  copy's event is registered with :func:`zero3.fence_update`: that step
  waits for it on the device, and the forward and backward before it
  overlap the copy;
* a background writer thread waits on the copy's event, then writes the
  files through the crash-safe ``zero3`` path (temporary file, fsync and an
  atomic rename per file, ``manifest.json`` stamped LAST — a generation
  directory is durable IFF its manifest exists);
* admission is BOUNDED: ``queue_depth`` generations may be in flight (one
  host buffer set each); the next ``submit`` waits for a free set —
  honest backpressure instead of unbounded host memory.

Two ways to hand over the state:

* the whole arena (``(world * shard_len,)`` per key, numpy or tensors), as
  the JAX manager takes it: one writer writes every rank's shard and the
  manifest (``rank=None``);
* this rank's shard (``(shard_len,)`` per key) with ``rank=`` and a
  ``token`` the ranks agreed on (what :class:`ElasticTrainer` does: each
  rank is a process). Each rank's writer removes the generation's stale
  stamps, writes its own ``shard_<rank>.npz`` and a marker; with ``hosts >
  1`` the first rank of each host stamps its host manifest once its ranks'
  markers are there; rank 0 stamps ``manifest.json`` once every marker (and
  every host manifest) is there, and the other ranks wait for it. The
  writer threads coordinate through the file system only: no collective
  runs off the training thread. The files are the JAX package's, so a
  generation either package writes restores in the other.

Every stall is booked to the module's ``ckpt`` ledger:

* training-thread phases (``submit``, ``backpressure``, ``wait``) are
  EXPOSED — the step loop was blocked for that long;
* writer-thread phases (``serialize``, ``write``) are BACKGROUND. A rank's
  ``write`` includes its wait for its peers' files;
* :func:`ckpt_summary` reports ``hidden_s = max(0, background_s -
  exposed_s)`` (a conservative lower bound) and ``hidden_fraction``. Under
  ``monitor.timeline()`` each phase also lands as a ``ckpt:<phase>`` span
  (writer phases on their own thread row).

The copy's payload is booked to the comms ledger (kind ``d2h``, site
``ckpt.snapshot``, tier ``host``).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from beforeholiday_tpu_torch.optimizers import zero3
from beforeholiday_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "CheckpointManager",
    "ckpt_records",
    "ckpt_summary",
    "generation_dir",
    "latest_generation",
    "list_generations",
    "reset_ckpt_ledger",
]

_GEN_PREFIX = "gen_"

# training-thread phases: the step loop was blocked while these ran (the
# writer thread's "serialize" and "write" ran beside the steps)
_EXPOSED_PHASES = ("submit", "backpressure", "wait")

_LOCK = threading.Lock()
_LEDGER: Dict[str, Dict[str, float]] = {}
_COUNTS = {"generations": 0, "bytes": 0}

# how often a rank's writer looks for its peers' files, and how long it
# waits for them before it fails the generation
_POLL_S = 0.002
PEER_TIMEOUT_S = 600.0


@contextlib.contextmanager
def _phase(name: str):
    """Time one ledger phase; mirror it as a ``ckpt:<name>`` span on the
    active timeline recorder."""
    from beforeholiday_tpu_torch.monitor.trace import active_recorder

    rec = active_recorder()
    if rec is not None:
        rec.begin(f"ckpt:{name}")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rec is not None:
            rec.end()
        with _LOCK:
            row = _LEDGER.setdefault(name, {"calls": 0, "seconds": 0.0})
            row["calls"] += 1
            row["seconds"] += dt


def reset_ckpt_ledger() -> None:
    """Zero the process-global ckpt ledger."""
    with _LOCK:
        _LEDGER.clear()
        _COUNTS["generations"] = 0
        _COUNTS["bytes"] = 0


def ckpt_records() -> List[Dict[str, Any]]:
    """Per-phase snapshot: ``{"phase", "side", "calls", "seconds"}`` rows;
    ``side`` is "exposed" (training thread blocked) or "background"."""
    with _LOCK:
        items = sorted((k, dict(v)) for k, v in _LEDGER.items())
    return [{"phase": k,
             "side": "exposed" if k in _EXPOSED_PHASES else "background",
             "calls": int(v["calls"]), "seconds": float(v["seconds"])}
            for k, v in items]


def ckpt_summary() -> Dict[str, Any]:
    """Hidden-vs-exposed rollup of the ckpt ledger: ``exposed_s`` (submit +
    backpressure + wait), ``background_s`` (serialize + write), ``hidden_s
    = max(0, background_s - exposed_s)``, ``hidden_fraction`` (None with no
    background work), and the ``generations`` and ``bytes`` this process
    wrote."""
    rows = ckpt_records()
    exposed_s = sum(r["seconds"] for r in rows if r["side"] == "exposed")
    background_s = sum(r["seconds"] for r in rows if r["side"] == "background")
    hidden_s = max(0.0, background_s - exposed_s)
    with _LOCK:
        gens, nbytes = _COUNTS["generations"], _COUNTS["bytes"]
    return {
        "phases": rows,
        "exposed_s": exposed_s,
        "background_s": background_s,
        "hidden_s": hidden_s,
        "hidden_fraction": hidden_s / background_s if background_s > 0 else None,
        "generations": gens,
        "bytes": nbytes,
    }


# ---------------------------------------------------------- generation scan


def generation_dir(directory: str, step: int) -> str:
    """``<directory>/gen_<step:08d>`` — one subdirectory per generation."""
    return os.path.join(directory, f"{_GEN_PREFIX}{step:08d}")


def _manifest_path(path: str) -> str:
    return os.path.join(path, zero3._MANIFEST_NAME)


def _generation_durable(path: str) -> bool:
    """The top-level manifest exists, parses, and every host manifest it
    declares exists too."""
    try:
        with open(_manifest_path(path)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    hosts = zero3.manifest_hosts(manifest)
    return hosts <= 1 or all(
        os.path.isfile(zero3.host_manifest_path(path, h)) for h in range(hosts))


def list_generations(directory: str) -> List[Tuple[int, str, bool]]:
    """All ``gen_*`` entries as ``(step, path, durable)`` sorted by step. A
    torn generation (no manifest, or a declared host manifest missing)
    scans as non-durable and is never offered for restore."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        if not name.startswith(_GEN_PREFIX):
            continue
        try:
            step = int(name[len(_GEN_PREFIX):])
        except ValueError:
            continue
        path = os.path.join(directory, name)
        if os.path.isdir(path):
            out.append((step, path, _generation_durable(path)))
    out.sort(key=lambda t: t[0])
    return out


def latest_generation(directory: str) -> Optional[Tuple[int, str]]:
    """Newest DURABLE generation ``(step, path)`` in ``directory`` (None when
    none exists): a resume after a hard kill lands on the previous complete
    checkpoint."""
    durable = [(s, p) for s, p, d in list_generations(directory) if d]
    return durable[-1] if durable else None


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def _clear_generation(path: str) -> None:
    """Remove a generation directory manifest-FIRST, so a crash mid-clear
    leaves a non-durable state rather than a torn one with a manifest."""
    _remove(_manifest_path(path))
    shutil.rmtree(path, ignore_errors=True)


def _jsonable(obj):
    """A state_dict-style tree in JSON types: tensor and array leaves (the
    fp8 amax history in ``guard.state_dict``) become nested lists."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if hasattr(obj, "tolist"):
        return np.asarray(obj).tolist()
    return obj


def _numpy(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ------------------------------------------------------------------ manager


class CheckpointManager:
    """Async generation writer for the ZeRO-3 shard state.

    Parameters
    ----------
    directory: checkpoint root; each generation lands in ``gen_<step>``.
    manifest: base layout manifest (``zero3.shard_manifest(layout, world)``)
        — per-generation copies gain ``step`` and optional ``extra``.
    queue_depth: generations allowed in flight (one pinned host buffer set
        each) before ``submit`` blocks (backpressure; booked).
    keep: durable generations retained; older ones are pruned after each
        new generation lands (by the single writer, or rank 0).
    hosts: multi-host write partition — each host's ranks write their
        shards, then a host manifest (two-level durability). ``None`` keeps
        what the manifest declares. Must divide the manifest's world.
    rank: this process's rank in the manifest's world when each rank writes
        its own shard; ``None`` makes this manager the single writer of the
        whole arena.
    token: a string every rank of the world passes alike (fresh for each
        world), naming this world's writes in the generation directory, so
        that a rank never mistakes a killed world's files for its peers'.
        Needed with ``rank`` when the world is larger than 1.
    """

    def __init__(self, directory: str, manifest: Dict[str, Any], *,
                 queue_depth: int = 2, keep: int = 2,
                 hosts: Optional[int] = None, rank: Optional[int] = None,
                 token: Optional[str] = None):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if manifest.get("format") != zero3._MANIFEST_FORMAT:
            raise ValueError(
                f"manifest format {manifest.get('format')!r} is not "
                f"{zero3._MANIFEST_FORMAT!r} — build it with zero3.shard_manifest")
        self.directory = directory
        self.keep = int(keep)
        self.world = int(manifest["world"])
        self.shard_len = int(manifest["shard_len"])
        self._manifest = dict(manifest)
        if hosts is not None:
            if hosts < 1:
                raise ValueError(f"hosts must be >= 1, got {hosts}")
            if self.world % hosts:
                raise ValueError(
                    f"hosts={hosts} must divide world={self.world} (contiguous "
                    "rank partition; pick zero3.effective_hosts(world, hosts) "
                    "after a resize)")
            self._manifest["hosts"] = int(hosts)
            self._manifest.setdefault("manifest_version", 2)
        self.hosts = zero3.manifest_hosts(self._manifest)
        if rank is not None:
            if not 0 <= rank < self.world:
                raise ValueError(f"rank {rank} out of range for world {self.world}")
            if self.world > 1 and not token:
                raise ValueError("a per-rank writer in a world larger than 1 "
                                 "needs the token its peers pass alike")
        self.rank = rank
        self._token = str(token or "solo")
        self._state_keys = tuple(manifest["state_keys"])
        self._queue: "queue.Queue" = queue.Queue()
        # one host buffer set a generation in flight: a free set is the
        # admission ticket, the writer returns it once the files are written
        self._free: "queue.Queue" = queue.Queue()
        for slot in range(int(queue_depth)):
            self._free.put(slot)
        self._buffers: Dict[int, Dict[str, torch.Tensor]] = {}
        self._stream = None
        self._seq = 0
        # (exception, generation step) — surfaced on the NEXT submit/wait,
        # naming the generation that failed to land
        self._error: Optional[Tuple[BaseException, int]] = None
        self._last_durable: Optional[Tuple[int, str]] = None
        self._lock = threading.Lock()
        self._closed = False
        os.makedirs(directory, exist_ok=True)
        self._thread = threading.Thread(target=self._worker_loop,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------- training thread
    def submit(self, step: int, state: Dict[str, Any], *,
               extra: Optional[Dict[str, Any]] = None) -> str:
        """Enqueue generation ``step`` from the live state (``state_keys``
        plus ``step``: the whole arena, or this rank's shard with ``rank``).
        Tensors on the card are copied on a side stream into pinned host
        buffers, and the next ``ZeRO3FusedAdam.step`` on them waits for the
        copy; other values are copied here. Blocks only when
        ``queue_depth`` generations are already in flight (booked
        ``backpressure``). ``extra`` is stamped into the generation's
        manifest (tensor and array leaves become nested lists). Returns the
        generation directory path."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        try:
            slot = self._free.get_nowait()
        except queue.Empty:
            with _phase("backpressure"):
                slot = self._free.get()
        try:
            with _phase("submit"):
                leaves, event = self._snapshot(slot, state)
                self._book_d2h(leaves)
        except BaseException:
            self._free.put(slot)
            raise
        self._seq += 1
        self._queue.put((int(step), slot, leaves, event, extra, self._seq))
        return generation_dir(self.directory, int(step))

    def _buffer(self, slot: int, key: str, v: torch.Tensor) -> torch.Tensor:
        bufs = self._buffers.setdefault(slot, {})
        buf = bufs.get(key)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
            bufs[key] = buf
        return buf

    def _snapshot(self, slot: int, state: Dict[str, Any]):
        """This generation's host copy of the state: ``(leaves, event)``,
        ``event`` the side stream's CUDA event after the copies (None when
        nothing lives on the card)."""
        keys = list(self._state_keys) + ["step"]
        cuda = [k for k in keys
                if isinstance(state[k], torch.Tensor) and state[k].is_cuda]
        leaves: Dict[str, Any] = {}
        for k in keys:
            v = state[k]
            if k in cuda:
                continue
            if isinstance(v, torch.Tensor):
                leaves[k] = self._buffer(slot, k, v.detach()).copy_(v.detach())
            else:
                leaves[k] = np.array(v, copy=True)
        if not cuda:
            return leaves, None
        device = state[cuda[0]].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for k in cuda:
                v = state[k].detach()
                v.record_stream(self._stream)
                leaves[k] = self._buffer(slot, k, v).copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the in-place update of the next step waits for the copy
        zero3.fence_update([state[k] for k in cuda if k != "step"], done)
        return leaves, done

    def wait(self) -> None:
        """Drain: block until every submitted generation is durable (booked
        ``wait``), then re-raise any writer error. The elastic trainer calls
        this before a resize so the newest submitted generation is eligible
        for restore."""
        with _phase("wait"):
            self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain and stop the writer thread. Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            with _phase("wait"):
                self._queue.join()
        finally:
            self._queue.put(None)
            self._thread.join(timeout=60.0)
        self._raise_pending()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def last_durable(self) -> Optional[Tuple[int, str]]:
        """``(step, path)`` of the newest generation THIS manager saw land
        (None before the first); ``latest_generation`` scans the directory
        instead, surviving process death."""
        with self._lock:
            return self._last_durable

    def _raise_pending(self) -> None:
        with self._lock:
            pending, self._error = self._error, None
        if pending is not None:
            err, step = pending
            gen = generation_dir(self.directory, step)
            raise RuntimeError(
                f"checkpoint writer thread failed writing generation "
                f"{os.path.basename(gen)} (step {step}); that generation is "
                "not durable — the training loop must not keep running on the "
                "assumption its state is; the previous durable generation is "
                "still restorable") from err

    def _book_d2h(self, leaves: Dict[str, Any]) -> None:
        """Book the snapshot's device-to-host payload on the comms ledger
        (site ``ckpt.snapshot``, tier ``host``)."""
        from beforeholiday_tpu_torch.monitor import comms

        comms.record("d2h", "host", [torch.as_tensor(v) for v in leaves.values()],
                     site="ckpt.snapshot", tier="host")

    # --------------------------------------------------------- writer thread
    def _worker_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            try:
                self._write_generation(*item)
            except BaseException as e:  # noqa: BLE001 — surfaced on submit/wait
                logger.exception("checkpoint generation write failed (step %d)",
                                 item[0])
                with self._lock:
                    if self._error is None:
                        self._error = (e, item[0])
            finally:
                self._free.put(item[1])
                self._queue.task_done()

    def _write_generation(self, step: int, slot: int, leaves: Dict[str, Any],
                          event, extra: Optional[Dict[str, Any]], seq: int) -> None:
        with _phase("serialize"):
            if event is not None:
                event.synchronize()  # the side stream's copy has landed
            host = {k: _numpy(v) for k, v in leaves.items()}
            if self.rank is None:
                stacked = {k: host[k].reshape(self.world, self.shard_len)
                           for k in self._state_keys}
                stacked["step"] = host["step"]
                shards = zero3.shards_from_stacked(stacked, self.world)
        manifest = dict(self._manifest)
        manifest["step"] = int(step)
        if extra is not None:
            manifest["extra"] = _jsonable(extra)
        gen = generation_dir(self.directory, int(step))
        with _phase("write"):
            if self.rank is None:
                if os.path.isdir(gen):
                    # superseding a stale generation of the same step
                    _clear_generation(gen)
                zero3.save_shard_files(gen, shards, manifest)
            else:
                self._write_rank(gen, host, manifest, f"{self._token}.{seq}")
        with _LOCK:
            _COUNTS["generations"] += 1
            _COUNTS["bytes"] += sum(int(a.nbytes) for a in host.values())
        with self._lock:
            self._last_durable = (int(step), gen)
        from beforeholiday_tpu_torch.monitor.flight import active_flight_recorder

        rec = active_flight_recorder()
        if rec is not None:
            rec.note_checkpoint(int(step), gen)
        if self.rank is None or self.rank == 0:
            self._prune()

    # ---- the per-rank write: peers meet in the file system ----------------

    def _marker(self, gen: str, rank: int, tag: str) -> str:
        return os.path.join(gen, f".written.{tag}.{rank:05d}")

    def _await(self, paths: List[str], gen: str, what: str) -> None:
        deadline = time.monotonic() + PEER_TIMEOUT_S
        while True:
            missing = [p for p in paths if not os.path.exists(p)]
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"generation {os.path.basename(gen)}: {what} did not land "
                    f"within {PEER_TIMEOUT_S} s; missing "
                    f"{[os.path.basename(p) for p in missing]}")
            time.sleep(_POLL_S)

    def _write_rank(self, gen: str, host: Dict[str, np.ndarray],
                    manifest: Dict[str, Any], tag: str) -> None:
        rank, world, hosts = self.rank, self.world, self.hosts
        os.makedirs(gen, exist_ok=True)
        my_host = rank // (world // hosts)
        # a stale generation of this step (a replay after a reload, a drain
        # at a step just checkpointed) loses its stamps before any shard of
        # ours replaces one, so it is never durable over a mix of files
        _remove(_manifest_path(gen))
        if hosts > 1:
            _remove(zero3.host_manifest_path(gen, my_host))
        zero3._save_rank_shard(gen, rank, host, manifest)
        with open(self._marker(gen, rank, tag), "w"):
            pass
        if hosts > 1:
            ranks = zero3.host_rank_range(world, hosts, my_host)
            if rank == ranks[0]:
                self._await([self._marker(gen, r, tag) for r in ranks], gen,
                            f"host {my_host}'s shards")
                host_manifest = {
                    "format": zero3._MANIFEST_FORMAT,
                    "manifest_version": manifest.get("manifest_version", 2),
                    "host": my_host, "hosts": hosts, "world": world,
                    "ranks": list(ranks),
                }
                zero3._atomic_write(
                    zero3.host_manifest_path(gen, my_host),
                    lambda f: f.write(json.dumps(host_manifest, indent=1)
                                      .encode("utf-8")))
        if rank == 0:
            markers = [self._marker(gen, r, tag) for r in range(world)]
            self._await(markers, gen, "the ranks' shards")
            if hosts > 1:
                self._await([zero3.host_manifest_path(gen, h) for h in range(hosts)],
                            gen, "the host manifests")
            zero3._atomic_write(
                _manifest_path(gen),
                lambda f: f.write(json.dumps(manifest, indent=1).encode("utf-8")))
            for m in markers:
                _remove(m)
        else:
            # rank 0 stamps only after every rank's marker, and each rank
            # removed the stale stamp before its marker: this one is new
            self._await([_manifest_path(gen)], gen, "rank 0's manifest")

    def _prune(self) -> None:
        """Drop durable generations beyond ``keep`` (oldest first), and torn
        generations older than the newest durable one."""
        gens = list_generations(self.directory)
        durable = [(s, p) for s, p, d in gens if d]
        for _, p in durable[:-self.keep] if len(durable) > self.keep else []:
            _clear_generation(p)
        if durable:
            newest = durable[-1][0]
            for s, p, d in gens:
                if not d and s < newest:
                    _clear_generation(p)
