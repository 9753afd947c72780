"""Runtime-assisted lockdep: instrumented lock factories (a copy of the
JAX package's ``analysis/lockdep_runtime.py``, for the serving engine and
supervisor; the static analyzer is not ported yet).

The static analyzer (the JAX package's ``analysis.lockdep``) derives a
lock-order graph from source; this module confirms or retires those
edges with ground truth. Hot-path lock sites construct their primitives
through :func:`make_lock` / :func:`make_rlock` / :func:`make_condition`
(the static analyzer recognizes these factories as lock constructors and
uses the given name as the lock id). With ``TEPDIST_LOCKDEP`` unset the
factories return plain :mod:`threading` primitives — zero overhead, no
wrapper in the way. With ``TEPDIST_LOCKDEP=1`` they return tracked
wrappers that maintain a per-thread held-lock stack and record every
observed acquisition-order edge ``(outer_name, inner_name)`` into a
process-global set (surfaced via :func:`edges` and the
``lockdep_runtime_edges`` counter), so a tier-1 run doubles as a
dynamic lock-order census.

The knob is read from ``os.environ`` at construction time (not
``ServiceEnv``) so tests can flip it with ``monkeypatch.setenv`` without
resetting the singleton.
"""

from __future__ import annotations

import os
import threading
from typing import List, Set, Tuple

_tls = threading.local()
_edges_lock = threading.Lock()
_edges: Set[Tuple[str, str]] = set()


def _enabled() -> bool:
    return os.environ.get("TEPDIST_LOCKDEP", "").strip().lower() in (
        "1", "true", "yes", "on")


def _held_stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _record_acquire(name: str) -> None:
    st = _held_stack()
    if st:
        edge = (st[-1], name)
        with _edges_lock:
            fresh = edge not in _edges
            if fresh:
                _edges.add(edge)
        if fresh:
            # Counter touches the registry lock; never under _edges_lock.
            from tepdist_tpu_torch.telemetry import metrics
            metrics().counter("lockdep_runtime_edges").inc()
    st.append(name)


def _record_release(name: str) -> None:
    st = _held_stack()
    # Release may be out of stack order (rare but legal); drop the
    # newest matching entry.
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            return


def edges() -> Set[Tuple[str, str]]:
    """All (outer, inner) acquisition-order edges observed so far."""
    with _edges_lock:
        return set(_edges)


def reset_edges() -> None:
    with _edges_lock:
        _edges.clear()


class _TrackedLock:
    """Wraps Lock/RLock: records order edges on acquire. Condition
    wrappers delegate here for their internal lock."""

    def __init__(self, name: str, inner):
        self._name = name
        self._inner = inner

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _record_acquire(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        _record_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()


class _TrackedCondition:
    """Wraps Condition; wait() releases/re-acquires the lock, so the
    held stack is kept in sync across the wait."""

    def __init__(self, name: str, inner: threading.Condition):
        self._name = name
        self._inner = inner

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, *a, **kw) -> bool:
        got = self._inner.acquire(*a, **kw)
        if got:
            _record_acquire(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        _record_release(self._name)

    def __enter__(self):
        self._inner.__enter__()
        _record_acquire(self._name)
        return self

    def __exit__(self, *exc):
        _record_release(self._name)
        return self._inner.__exit__(*exc)

    def wait(self, timeout=None):
        _record_release(self._name)
        try:
            return self._inner.wait(timeout)
        finally:
            _record_acquire(self._name)

    def wait_for(self, predicate, timeout=None):
        _record_release(self._name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _record_acquire(self._name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def make_lock(name: str):
    """A named Lock; tracked when ``TEPDIST_LOCKDEP=1``."""
    inner = threading.Lock()
    return _TrackedLock(name, inner) if _enabled() else inner


def make_rlock(name: str):
    """A named RLock; tracked when ``TEPDIST_LOCKDEP=1``."""
    inner = threading.RLock()
    return _TrackedLock(name, inner) if _enabled() else inner


def make_condition(name: str):
    """A named Condition; tracked when ``TEPDIST_LOCKDEP=1``."""
    inner = threading.Condition()
    return _TrackedCondition(name, inner) if _enabled() else inner


def confirms(static_edges) -> List[Tuple[str, str]]:
    """Which statically-derived (outer, inner) edges were actually
    observed at runtime — the confirm-or-retire report."""
    observed = edges()
    return sorted(e for e in static_edges if tuple(e) in observed)
