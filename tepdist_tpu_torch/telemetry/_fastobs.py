"""Build-on-demand loader for the native telemetry write-path cores.

Compile this package's own ``_fastobs.c`` with the system compiler on
first use into ``tepdist_tpu_torch/_build/`` (git-ignored), load the shared
object as ``_tepdist_torch_fastobs`` (a name of its own, so that a process
which also loads the JAX package's rings keeps two distinct extensions
with their own static state), and fall back to the pure-Python ring
implementations in ledger.py / trace.py — which remain fully correct,
just slower — when no compiler or headers are available.  ``TEPDIST_NO_FASTOBS=1`` forces the
fallback (used by tests to cover both paths, and as an operator escape
hatch)."""

from __future__ import annotations

import importlib.machinery
import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading
from typing import Any, Optional

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_fastobs.c")
_MODULE = "_tepdist_torch_fastobs"
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, _MODULE + ".so")
_lock = threading.Lock()
_mod: Optional[Any] = None
_failed = False


def load() -> Optional[Any]:
    """The compiled module, or None (with a one-time warning) on any
    build/load failure."""
    global _mod, _failed
    with _lock:
        if _mod is not None:
            return _mod
        if _failed:
            return None
        if os.environ.get("TEPDIST_NO_FASTOBS"):
            _failed = True
            return None
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            # Per-process tmp name: concurrent importing processes must
            # not compile onto the same file (the lock is per-process).
            tmp = f"{_SO}.tmp.{os.getpid()}"
            try:
                os.makedirs(BUILD_DIR, exist_ok=True)
                inc = sysconfig.get_paths()["include"]
                subprocess.run(
                    ["gcc", "-O2", "-shared", "-fPIC", f"-I{inc}",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
            except Exception as e:  # noqa: BLE001 — fallback to Python
                log.warning("fastobs build failed (pure-Python rings): %s", e)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                _failed = True
                return None
        try:
            loader = importlib.machinery.ExtensionFileLoader(
                _MODULE, _SO)
            spec = importlib.util.spec_from_file_location(
                _MODULE, _SO, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _mod = mod
        except Exception as e:  # noqa: BLE001
            log.warning("fastobs load failed (pure-Python rings): %s", e)
            _failed = True
            return None
        return _mod


def available() -> bool:
    return load() is not None
