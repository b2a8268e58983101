"""Rank-annotated logging — counterpart of ``beforeholiday_tpu/utils/logging.py``.

Every record carries the process's place in the job: its
``torch.distributed`` rank over the world size (``p0/1`` outside a process
group), and the (data, tensor, pipe, context) sizes of the parallel layout
when ``parallel.parallel_state`` holds one, as the reference's
``RankInfoFormatter`` prefixes its rank tuple (apex/__init__.py:27-39).
Verbosity comes from ``BEFOREHOLIDAY_TPU_LOG_LEVEL`` (default WARNING).
:func:`warn_once` rate-limits warnings by key (the metrics logger's
overflow-streak warning).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Hashable, Optional

__all__ = ["get_logger", "reset_warn_once", "warn_once"]

_LOG_ENV = "BEFOREHOLIDAY_TPU_LOG_LEVEL"


class _ProcessInfoFormatter(logging.Formatter):
    """Prefixes records with the process rank and the (dp, tp, pp, cp)
    layout sizes."""

    _layout_cache = (None, "")  # (ParallelState identity, formatted string)

    def format(self, record):
        proc, nprocs = 0, 1
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                proc, nprocs = dist.get_rank(), dist.get_world_size()
        except Exception:
            pass
        layout = ""
        try:
            from beforeholiday_tpu_torch.parallel import parallel_state as ps

            if ps.model_parallel_is_initialized():
                st = ps.get_state()
                cached_st, cached = self._layout_cache
                if cached_st is st:
                    layout = cached
                else:
                    # ASCII separators: the record must survive ASCII-encoded
                    # handlers on bare-locale hosts
                    layout = (
                        f" dp{st.data_parallel_size}xtp{st.tensor_model_parallel_size}"
                        f"xpp{st.pipeline_model_parallel_size}"
                        f"xcp{st.context_parallel_size}"
                    )
                    self._layout_cache = (st, layout)
        except Exception:
            pass
        record.rankinfo = f"p{proc}/{nprocs}{layout}"
        return super().format(record)


def get_logger(name: str = "beforeholiday_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            _ProcessInfoFormatter(
                "%(asctime)s [%(rankinfo)s] %(levelname)s %(name)s: %(message)s"
            )
        )
        logger.addHandler(handler)
        level = os.environ.get(_LOG_ENV, "WARNING").upper()
        if not isinstance(logging.getLevelName(level), int):  # unknown name → str
            level = "WARNING"  # an unrecognized value must not break import
        logger.setLevel(level)
        logger.propagate = False
    return logger


# keyed rate limiting for warnings that fire from per-step code paths: the
# first emission per key goes through, repeats are swallowed (process-global)
_WARNED: set = set()
_WARNED_LOCK = threading.Lock()


def warn_once(key: Hashable, msg: str, *args,
              logger: Optional[logging.Logger] = None,
              level: int = logging.WARNING) -> bool:
    """Log ``msg % args`` at ``level`` the first time ``key`` is seen;
    swallow repeats. Returns True iff the record was emitted."""
    with _WARNED_LOCK:
        if key in _WARNED:
            return False
        _WARNED.add(key)
    (logger if logger is not None else get_logger()).log(level, msg, *args)
    return True


def reset_warn_once(key: Optional[Hashable] = None) -> None:
    """Forget one key (or all, when ``key`` is None) so it may warn again."""
    with _WARNED_LOCK:
        if key is None:
            _WARNED.clear()
        else:
            _WARNED.discard(key)
