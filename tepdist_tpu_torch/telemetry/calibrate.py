"""Cost-model calibration: fit evaluator/scheduler constants to a trace.

Reference parity: NONE — the reference ships hand-tuned V100 constants
(parallel/evaluator.h:52-56) and never checks them against an execution.
This module closes that loop: given the fidelity join (predicted task
timeline vs measured spans, telemetry/fidelity.py), fit the handful of
constants the schedule simulator and plan evaluator actually price with:

* ``task_overhead_us`` — the per-task HOST dispatch floor
  (``TaskScheduler.task_time``; the round-5 probe measured ~31 ms/step of
  Python serde/RPC cycles the default model prices at ~0).
* ``compute_scale`` / ``hbm_scale`` — multipliers on
  ``PerfUtils.compute_time`` / ``hbm_time`` (effective-vs-peak FLOPs and
  memory bandwidth).
* ``transfer_bytes_per_s`` — measured point-to-point payload bandwidth
  (prices SEND/RECV via ``PerfUtils.ppermute_cost``).
* ``ar_bytes_per_s`` — measured ring all-reduce bandwidth (prices AR and
  the other collectives via ``PerfUtils._bw``).

The fit is deliberately simple and robust: the host floor is read off the
cheapest measured tasks (a low percentile of all durations — the
cheapest tasks are almost pure dispatch), then each scale/bandwidth is a
per-kind least-squares slope through the origin on the floor-subtracted
residuals. Profiles persist as JSON and load through the
``TEPDIST_CALIB_PROFILE`` knob; ``PerfUtils``/``TaskScheduler`` consult
``active_profile()`` so the argmin and the schedule windows use measured
constants instead of defaults.

A profile is topology-specific (it encodes THIS fleet's dispatch floor
and wire bandwidth) — regenerate with ``tools/fidelity_report.py
--save-profile`` after changing worker count, transport, or hardware.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from typing import Any, Dict, Iterable, List, Optional

log = logging.getLogger(__name__)

# Kinds priced by each fitted constant (span cat == TaskType.value).
COMPUTE_KINDS = ("compute",)
TRANSFER_KINDS = ("send", "recv")
AR_KINDS = ("ar",)
HBM_KINDS = ("ga", "ga_init", "apply")


@dataclasses.dataclass
class CalibrationProfile:
    """Fitted cost constants. A negative/zero field means "not fitted —
    keep the default model for that term"."""

    task_overhead_us: float = 0.0
    compute_scale: float = -1.0
    hbm_scale: float = -1.0
    transfer_bytes_per_s: float = -1.0
    ar_bytes_per_s: float = -1.0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1,
                          sort_keys=True)

    def save(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})


# -- active-profile resolution ---------------------------------------------
#
# Resolved once and cached: PerfUtils hot paths (the DP/ILP pricing loops)
# call active_profile() per cost term, so it must be an attribute load,
# not an env lookup + file stat. ``set_active``/``clear_active`` are the
# test/tool hooks; ``invalidate`` forces re-reading TEPDIST_CALIB_PROFILE.

_UNSET = object()
_lock = threading.Lock()
_override: Any = _UNSET          # set_active() wins over the env knob
_resolved: Any = _UNSET          # cached env-driven resolution


def set_active(profile: Optional[CalibrationProfile]) -> None:
    """Force the active profile (``None`` = force UNcalibrated), ignoring
    the env knob until ``clear_active()``."""
    global _override
    with _lock:
        _override = profile


def clear_active() -> None:
    """Return to env-driven (TEPDIST_CALIB_PROFILE) resolution."""
    global _override
    with _lock:
        _override = _UNSET


def invalidate() -> None:
    """Drop the cached env resolution (call after changing the knob)."""
    global _resolved
    with _lock:
        _resolved = _UNSET


def active_profile() -> Optional[CalibrationProfile]:
    """The profile cost models should price with right now (or None)."""
    ov = _override
    if ov is not _UNSET:
        return ov
    res = _resolved
    if res is _UNSET:
        res = _resolve_env()
    return res


def _resolve_env() -> Optional[CalibrationProfile]:
    global _resolved
    with _lock:
        if _resolved is not _UNSET:
            return _resolved
        from tepdist_tpu_torch.core.service_env import ServiceEnv
        path = ServiceEnv.get().tepdist_calib_profile
        prof: Optional[CalibrationProfile] = None
        if path:
            try:
                prof = CalibrationProfile.load(path)
                log.info("loaded calibration profile %s: %s", path,
                         prof.to_json().replace("\n", " "))
            except (OSError, ValueError, TypeError, KeyError) as e:
                log.warning("TEPDIST_CALIB_PROFILE=%s unreadable (%r); "
                            "using default cost model", path, e)
        _resolved = prof
        return prof


# -- fitting ----------------------------------------------------------------

def _percentile(sorted_vals: List[float], q: float) -> float:
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _slope(xs: List[float], ys: List[float]) -> float:
    """Least-squares slope through the origin (y ~= k*x); -1 if
    unfittable (no rows, or degenerate/negative slope)."""
    sxx = sum(x * x for x in xs)
    if sxx <= 0.0:
        return -1.0
    k = sum(x * y for x, y in zip(xs, ys)) / sxx
    return k if k > 0.0 else -1.0


def fit_profile(matched: Iterable[Dict[str, Any]],
                base_overhead_us: float = 0.0) -> CalibrationProfile:
    """Fit a profile from fidelity-join rows.

    Each row needs ``kind``, predicted ``dur_us`` (the UNcalibrated
    simulator's task_time, which includes ``base_overhead_us`` of host
    floor), ``measured_us``, and — for transfer/AR rows — ``bytes`` and
    ``devices``. Rows from several steps are fine; the fit is per-task,
    not per-step.
    """
    rows = [r for r in matched
            if r.get("measured_us") is not None and r["measured_us"] > 0]
    if not rows:
        return CalibrationProfile(meta={"n_rows": 0})

    meas_s = sorted(r["measured_us"] * 1e-6 for r in rows)
    # Host floor: the cheapest tasks are ~pure dispatch. p10 (not min)
    # rides above scheduling-jitter outliers on the fast side.
    oh_s = _percentile(meas_s, 0.10)

    def dev_pred_s(r: Dict[str, Any]) -> float:
        # Predicted DEVICE time: strip the base host floor the
        # uncalibrated task_time already included.
        return max(r["dur_us"] - base_overhead_us, 1e-3) * 1e-6

    def resid_s(r: Dict[str, Any]) -> float:
        return max(r["measured_us"] * 1e-6 - oh_s, 0.0)

    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_kind.setdefault(str(r.get("kind", "misc")), []).append(r)

    def kind_rows(kinds) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for k in kinds:
            out.extend(by_kind.get(k, ()))
        return out

    comp = kind_rows(COMPUTE_KINDS)
    compute_scale = _slope([dev_pred_s(r) for r in comp],
                           [resid_s(r) for r in comp])

    hbm = kind_rows(HBM_KINDS)
    hbm_scale = _slope([dev_pred_s(r) for r in hbm],
                       [resid_s(r) for r in hbm])

    xfer = [r for r in kind_rows(TRANSFER_KINDS)
            if (r.get("bytes") or 0) > 0]
    inv_bw = _slope([float(r["bytes"]) for r in xfer],
                    [resid_s(r) for r in xfer])
    transfer_bps = 1.0 / inv_bw if inv_bw > 0 else -1.0

    ar = [r for r in kind_rows(AR_KINDS) if (r.get("bytes") or 0) > 0]

    def ring_term(r: Dict[str, Any]) -> float:
        n = max(len(r.get("devices") or ()), 2)
        return 2.0 * float(r["bytes"]) * (n - 1) / n

    inv_ar = _slope([ring_term(r) for r in ar], [resid_s(r) for r in ar])
    ar_bps = 1.0 / inv_ar if inv_ar > 0 else -1.0

    return CalibrationProfile(
        task_overhead_us=oh_s * 1e6,
        compute_scale=compute_scale,
        hbm_scale=hbm_scale,
        transfer_bytes_per_s=transfer_bps,
        ar_bytes_per_s=ar_bps,
        meta={
            "n_rows": len(rows),
            "rows_per_kind": {k: len(v)
                              for k, v in sorted(by_kind.items())},
            "base_overhead_us": base_overhead_us,
            "measured_p10_us": oh_s * 1e6,
            "measured_p50_us": _percentile(meas_s, 0.50) * 1e6,
        },
    )
