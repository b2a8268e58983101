"""Persisted tuning manifest — counterpart of
``beforeholiday_tpu/tune/manifest.py``: ``tune-manifest-v1`` JSON keyed by
signature, the same schema, so either package reads the other's file (the
keys are each package's own digests, see ``tune.signature``).

The search is bounded but not free — a tuned config must survive the
process that found it. The manifest is a single JSON document::

    {
      "schema": "tune-manifest-v1",
      "entries": {
        "<digest>": {
          "config": {"opt_level": "O0", ...},
          "signature": {... TuningKey.describe() ...},
          "best_cost_s": 0.0123,
          "trials": 6
        }
      }
    }

Writes are atomic (temp file + ``os.replace`` in the target directory, the
same manifest-last durability idiom as ``elastic.checkpoint``) so a reader
never observes a torn manifest; a corrupt or wrong-schema file degrades to
an empty manifest rather than poisoning every tuned constructor.

This file owns the autotuner's only file I/O: ``load`` and ``save``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

__all__ = ["SCHEMA", "TuningManifest", "default_path"]

SCHEMA = "tune-manifest-v1"
ENV_VAR = "BEFOREHOLIDAY_TUNE_MANIFEST"


def default_path() -> str:
    """``$BEFOREHOLIDAY_TUNE_MANIFEST`` or the per-user cache location."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "beforeholiday_tpu_torch",
        "tune-manifest.json",
    )


def _digest_of(key: Any) -> str:
    if isinstance(key, str):
        return key
    digest = getattr(key, "digest", None)
    if digest is None:
        raise TypeError(
            f"manifest keys are TuningKey or digest strings, got {type(key)}"
        )
    return digest


class TuningManifest:
    """Load/lookup/store interface over one manifest file."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else default_path()
        self._entries: Optional[Dict[str, Dict[str, Any]]] = None

    # ---------------------------------------------------------------- host I/O
    def load(self) -> Dict[str, Dict[str, Any]]:
        """Read the manifest from disk (sanctioned host read). Missing,
        corrupt, or wrong-schema files all yield an empty manifest — a bad
        cache must never break construction."""
        entries: Dict[str, Dict[str, Any]] = {}
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            self._entries = entries
            return entries
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
            self._entries = entries
            return entries
        raw = doc.get("entries")
        if isinstance(raw, dict):
            for digest, row in raw.items():
                if not isinstance(row, dict):
                    continue
                if not isinstance(row.get("config"), dict):
                    continue
                clean = dict(row)
                if clean.get("best_cost_s") is not None:
                    clean["best_cost_s"] = float(clean["best_cost_s"])
                if clean.get("trials") is not None:
                    clean["trials"] = int(clean["trials"])
                entries[str(digest)] = clean
        self._entries = entries
        return entries

    def save(self) -> None:
        """Atomically write the manifest (sanctioned host write): serialize
        into a temp file in the TARGET directory, fsync, then ``os.replace``
        — a crash mid-write leaves the previous manifest intact."""
        entries = self.entries()
        doc = {"schema": SCHEMA, "entries": entries}
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=".tune-manifest.", suffix=".tmp", dir=directory
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------- dict view
    def entries(self) -> Dict[str, Dict[str, Any]]:
        if self._entries is None:
            self.load()
        return self._entries

    def __len__(self) -> int:
        return len(self.entries())

    def lookup(self, key: Any) -> Optional[Dict[str, Any]]:
        """The stored entry for ``key`` (a TuningKey or digest string), or
        None. Returns a copy — callers cannot mutate the cache in place."""
        row = self.entries().get(_digest_of(key))
        if row is None:
            return None
        out = dict(row)
        out["config"] = dict(row["config"])
        return out

    def store(
        self,
        key: Any,
        config: Dict[str, Any],
        *,
        cost_s: Optional[float] = None,
        trials: Optional[int] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Record ``config`` as the tuned result for ``key`` and persist."""
        row: Dict[str, Any] = {"config": dict(config)}
        describe = getattr(key, "describe", None)
        if callable(describe):
            row["signature"] = describe()
        if cost_s is not None:
            row["best_cost_s"] = float(cost_s)
        if trials is not None:
            row["trials"] = int(trials)
        if extra:
            row.update(extra)
        self.entries()[_digest_of(key)] = row
        self.save()
        return dict(row)
