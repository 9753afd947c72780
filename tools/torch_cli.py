"""What the port's read-only tools share: ``main(argv)`` returns what it
printed.

Each ``tools/torch_<name>.py`` keeps the JAX tool's flags and output, and
its ``main(argv=None)`` returns ``{"rc": exit code, "text": what it
printed on stdout, ...}`` (plus the tool's own data), so a caller (a
test, ``chip_smoke.py``) reads the same lines a user sees. Run as a
script, a tool exits with ``rc``.
"""

from __future__ import annotations

import contextlib
import io
import sys
from typing import Any, Callable, Dict


class _Tee(io.TextIOBase):
    """Writes to the real stream and keeps a copy."""

    def __init__(self, stream, copy: io.StringIO):
        self._stream, self._copy = stream, copy

    def write(self, s: str) -> int:
        self._copy.write(s)
        return self._stream.write(s)

    def flush(self) -> None:
        self._stream.flush()


def tee_main(body: Callable[..., Any], argv=None) -> Dict[str, Any]:
    """``body(argv)`` with stdout copied; it returns an exit code, or an
    exit code and a dict of data to return beside it."""
    copy = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, copy)):
        got = body(argv)
    rc, data = got if isinstance(got, tuple) else (got, {})
    return {"rc": int(rc or 0), "text": copy.getvalue(), **data}
