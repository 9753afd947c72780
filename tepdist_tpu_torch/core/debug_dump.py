"""Shared DEBUG-dump helper: one place for the dump directory policy.

All planner/runtime observability artifacts (planned-jaxpr text, ILP
models, exploration candidate tables — reference: ServiceEnv::debug-gated
dumps, ILPModel::ExportToString, auto_parallel.cc:309-311) land in
``$TEPDIST_DUMP_DIR`` (default ``tepdist_dump`` under the process's temporary
directory, ``$TMPDIR`` where it is set). A copy of the JAX package's
``core/debug_dump.py``."""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

log = logging.getLogger(__name__)


def dump_dir() -> str:
    return os.environ.get("TEPDIST_DUMP_DIR",
                          os.path.join(tempfile.gettempdir(), "tepdist_dump"))


def write_dump(name: str, text: str) -> Optional[str]:
    """Write ``text`` under the dump dir; returns the path, or None on
    filesystem refusal (dump failures must never break planning)."""
    path = os.path.join(dump_dir(), name)
    try:
        os.makedirs(dump_dir(), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    except OSError as e:
        log.warning("debug dump %s failed: %s", name, e)
        return None
    log.info("debug dump written: %s", path)
    return path
