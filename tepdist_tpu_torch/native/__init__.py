"""Native (C++) scheduler core, built on demand and bound with ctypes: the
port of ``tepdist_tpu/native/__init__.py``.

``scheduler.cc`` is the JAX package's source, copied unchanged. It is host
code: the discrete-event simulation loop of ``TaskScheduler``. At first use
it is compiled with ``g++`` into ``tepdist_tpu_torch/_build/`` (git-ignored)
as ``libtepdist_torch_sched.so``, a library name of its own, so a process
that also loads the JAX package's ``libtepdist_sched.so`` keeps the two
apart. The Python simulation in ``runtime/task_scheduler.py`` is a
verified-equal host path (the tests assert identical schedules), used when
no compiler is present or a DAG is too small to amortize the call.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "libtepdist_torch_sched.so")
_SRC = os.path.join(_DIR, "scheduler.cc")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            # Per-process tmp name: concurrent processes must not compile
            # onto the same file (the lock above is per-process only).
            tmp = f"{_SO}.tmp.{os.getpid()}"
            try:
                os.makedirs(BUILD_DIR, exist_ok=True)
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
            except Exception as e:  # noqa: BLE001 — the Python simulation
                log.warning("native scheduler build failed: %s", e)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.tepdist_schedule.restype = ctypes.c_int
            # (n, kind, duration, occupancy, stage, micro, rank,
            # dev_offsets, dev_ids, child_offsets, child_ids, n_parents,
            # window, order, start, finish)
            vp = ctypes.c_void_p
            lib.tepdist_schedule.argtypes = (
                [ctypes.c_int32] + [vp] * 11 + [ctypes.c_int32] + [vp] * 3)
            _lib = lib
        except OSError as e:
            log.warning("native scheduler load failed: %s", e)
            _build_failed = True
            return None
        return _lib


KIND_FWD, KIND_BWD, KIND_OTHER = 0, 1, 2


def schedule_native(
    kind: Sequence[int],
    duration: Sequence[float],
    occupancy: Sequence[float],
    stage: Sequence[int],
    micro: Sequence[int],
    device_groups: Sequence[Sequence[int]],
    children: Sequence[Sequence[int]],
    n_parents: Sequence[int],
    window: int,
    rank: Optional[Sequence[int]] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Run the C++ simulation; returns (order, start, finish), or None if
    the native library is unavailable.

    ``rank``: per-task priority ranks (lower starts first among startable
    tasks; ties by id), the schedule POLICY computed by the Python layer
    (``task_scheduler._ranks``) so the standard and interleaved 1F1B
    candidates share one simulator. Defaults to the standard 1F1B policy
    (micro * 2 + (0 if bwd else 1))."""
    lib = _load()
    if lib is None:
        return None
    n = len(kind)
    i32 = np.int32

    def csr(groups):
        offsets = np.zeros(n + 1, i32)
        flat: List[int] = []
        for i, g in enumerate(groups):
            flat.extend(g)
            offsets[i + 1] = len(flat)
        return offsets, np.asarray(flat, i32)

    dev_off, dev_ids = csr(device_groups)
    ch_off, ch_ids = csr(children)
    kind_a = np.asarray(kind, i32)
    dur_a = np.asarray(duration, np.float64)
    occ_a = np.asarray(occupancy, np.float64)
    stage_a = np.asarray(stage, i32)
    micro_a = np.asarray(micro, i32)
    if rank is None:
        rank_a = (np.maximum(micro_a, 0).astype(np.int64) * 2
                  + (kind_a != KIND_BWD).astype(np.int64))
    else:
        rank_a = np.asarray(rank, np.int64)
    np_a = np.asarray(n_parents, i32)
    order = np.zeros(n, i32)
    start = np.zeros(n, np.float64)
    finish = np.zeros(n, np.float64)

    def p(arr):
        return arr.ctypes.data_as(ctypes.c_void_p)

    rc = lib.tepdist_schedule(
        ctypes.c_int32(n), p(kind_a), p(dur_a), p(occ_a), p(stage_a),
        p(micro_a),
        p(rank_a), p(dev_off), p(dev_ids), p(ch_off), p(ch_ids), p(np_a),
        ctypes.c_int32(window), p(order), p(start), p(finish))
    if rc != 0:
        raise RuntimeError("native schedule: deadlock (DAG cycle)")
    return order, start, finish


def native_available() -> bool:
    return _load() is not None


def library_path() -> str:
    """Where the built library lives (``tepdist_tpu_torch/_build/``)."""
    return _SO
