"""Worker-side raw-data store: the part of the JAX package's
``rpc/worker_plan.py`` that a single server uses.

``RawStore`` is the keyed host store of per-step raw data
(``TransferHostRawData``'s raw-key, multi and tuple forms) with a blocking
get (the reference's kRecv wait); ``StepAbortedError`` wakes its waiters
when a step is aborted. The fleet's ``WorkerPlan``, ``StageModuleRuntime``
and pull tickets belong to ``DispatchPlan`` (ROADMAP item 16).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional


class StepAbortedError(RuntimeError):
    """Raised out of a blocking recv when the master aborts the step
    (a peer worker died mid-step and this worker's inputs will never
    arrive)."""


class RawStore:
    """Keyed host store with blocking get (the kRecv wait)."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self._cv = threading.Condition()
        self._aborted = False

    def put(self, key: str, value: Any) -> None:
        with self._cv:
            self._data[key] = value
            self._cv.notify_all()

    def get(self, key: str, timeout: float = 60.0) -> Any:
        """Non-destructive blocking read: the forward AND its remat backward
        both re-read stage inputs, so values live until the step's cleanup."""
        deadline = time.time() + timeout
        with self._cv:
            while key not in self._data:
                if self._aborted:
                    raise StepAbortedError(
                        f"step aborted while waiting for {key!r}")
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"raw data {key!r} never arrived")
                self._cv.wait(remaining)
            return self._data[key]

    def abort(self) -> None:
        """Wake every blocked get with StepAbortedError (master-initiated
        cancellation: a peer died, this step cannot complete)."""
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def reset_abort(self) -> None:
        with self._cv:
            self._aborted = False

    def clear_step(self, step: int) -> None:
        suffix = f":{step}"
        prefix = f"batch:{step}:"
        with self._cv:
            for k in [k for k in self._data
                      if k.endswith(suffix) or k.startswith(prefix)]:
                del self._data[k]

    @staticmethod
    def _key_step(key: str) -> Optional[int]:
        """The step index a store key belongs to: ``batch:{step}:{m}:{gi}``
        or ``t{send_id}:{step}``; None for unrecognized keys."""
        try:
            if key.startswith("batch:"):
                return int(key.split(":")[1])
            return int(key.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            return None

    def clear_older(self, step: int) -> None:
        """Drop every key from steps < ``step``. Abandoned-step leftovers
        (kept for the master's transient-fault retry) are bounded by this:
        once the fleet moves past a step, its data is gone."""
        with self._cv:
            for k in [k for k in self._data
                      if (s := self._key_step(k)) is not None and s < step]:
                del self._data[k]

    def clear(self) -> None:
        with self._cv:
            self._data.clear()
