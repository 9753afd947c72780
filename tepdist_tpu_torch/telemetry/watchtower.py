"""Watchtower: continuous fleet monitor over the telemetry delta stream.

Reference parity: NONE (deliberate surplus — ISSUE 17). Every instrument
shipped before this module is pull-based and post-hoc: you learn what
happened after the run, from a snapshot or a dump. The watchtower turns
the PR 16 ring cursors into a LIVE signal plane — the substrate ROADMAP's
elastic-autoscaling and multi-tenant items consume:

* **Delta stream** — ``GetTelemetryDelta`` (rpc/protocol.py) carries
  cursor-based incremental reads of the ledger/flight/trace rings
  (``.delta(state)`` on each instrument): the client passes its last-seen
  per-ring cursors, the server returns only new records plus EXACT drop
  counters. Polls cost O(new records), not O(ring capacity), and consume
  nothing — snapshots and the final trace dump still see everything.
* **Straggler / anomaly detection** — per-worker rolling step-time and
  RTT digests scored with the same robust statistics as tools/perf_gate
  (median + MAD bands). A worker is a straggler when its rolling median
  sits above the other workers' median plus ``max(3 * 1.4826 * MAD,
  floor)`` for ``persist_polls`` consecutive polls — a one-poll GC pause
  never pages. Fleet-shape changes (a worker stops answering, or
  reappears) raise their own event.
* **Training-health sentinels** — ``TrainingSentinel.observe(step,
  loss)`` runs inside the existing GA step at negligible cost (the loss
  is already on-host): a NaN/Inf watchdog and a windowed MAD-banded
  loss-spike detector, each raising a typed ``HealthAlert``. Advisory by
  default; ``TEPDIST_WATCH_HALT=nan`` makes the NaN watchdog halting —
  the executor fences the fleet through the existing AbortStep path and
  raises ``WatchHalt``.
* **SLO burn-rate engine** — declarative targets from ``slo.toml``
  (stdlib-only subset parser; this interpreter predates tomllib) over
  step-time percentiles, per-class serve TTFT/token tails, and error
  rates, with classic multi-window burn-rate alerting: the alert fires
  only when the error budget is burning faster than ``burn_threshold``
  over EVERY configured window (short window = fast detection, long
  window = flap suppression).

Alerts publish to a process-wide board (``active_alerts()``): they ride
``GetTelemetry``/``GetTelemetryDelta`` responses, the merged-trace
``alerts`` metadata (tools/trace_summary.py prints them), Prometheus
gauges (``watch_alert:<kind>``, ``slo_burn:<name>`` via the existing
``to_prometheus``), and the ``tools/watch.py`` live dashboard.

Overhead posture: the sentinel is a few float compares per step; the
poller thread does one delta RPC per worker per interval. Both are gated
by tools/obs_overhead.py ``watch_overhead_pct`` <= 1% on the two-worker
fleet step (perf_gate DEFAULT_KEYS watchlist, null-calibrated).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from tepdist_tpu_torch.telemetry.metrics import _quantile, metrics

# Ledger record kinds as they appear in delta payloads (ledger._K_*).
_K_HANDLER = 5
_K_WINDOW = 7

# The execute verbs whose worker-side handler records carry a step tag —
# their durations ARE the per-worker step time in the delta stream.
EXEC_VERBS = ("ExecuteStepSlice", "ExecuteRemotePlan", "ExecutePlan")


# -- robust statistics (perf_gate's machinery, importable) ------------------

def median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def mad_band(xs: List[float], floor: float = 0.0, k: float = 3.0) -> float:
    """Noise band over a sample: ``max(k * 1.4826 * MAD, floor)`` — the
    same shape tools/perf_gate.py draws around its rolling baselines."""
    if not xs:
        return floor
    med = median(xs)
    mad = median([abs(x - med) for x in xs])
    return max(k * 1.4826 * mad, floor)


# -- typed alerts -----------------------------------------------------------

#: Alert kinds (the "typed" in typed HealthAlert — consumers dispatch on
#: these, tests and scripts/watch_smoke.sh grep for them by name).
KIND_STRAGGLER = "straggler"
KIND_NAN = "nan"
KIND_LOSS_SPIKE = "loss_spike"
KIND_SLO_BURN = "slo_burn"
KIND_FLEET_SHAPE = "fleet_shape"
KIND_MIGRATION = "migration"
KIND_CONTROL_PLANE = "control_plane"


@dataclasses.dataclass
class HealthAlert:
    """One typed alert. ``key`` dedups repeats: a persistent condition
    updates ``last_us``/``count`` on its single board entry instead of
    flooding the board."""

    kind: str
    detail: str
    severity: str = "warn"          # warn | page
    worker: Optional[int] = None
    name: Optional[str] = None      # sub-identity (e.g. SLO target)
    value: Optional[float] = None
    threshold: Optional[float] = None
    step: Optional[int] = None
    first_us: int = 0
    last_us: int = 0
    count: int = 1

    @property
    def key(self) -> str:
        w = "" if self.worker is None else f":{self.worker}"
        n = "" if self.name is None else f":{self.name}"
        return f"{self.kind}{w}{n}"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d


class WatchHalt(RuntimeError):
    """Raised through the training loop when a halting sentinel trips
    (``TEPDIST_WATCH_HALT``). Carries the alert; the executor fences the
    fleet via AbortStep before letting this propagate."""

    def __init__(self, alert: HealthAlert):
        super().__init__(f"watchtower halt: {alert.kind} — {alert.detail}")
        self.alert = alert


class AlertBoard:
    """Process-wide active-alert registry. Publishing also mirrors the
    state into Prometheus-ready gauges (``watch_alert:<kind>``), so
    ``to_prometheus`` exports the live alert plane with no new code."""

    def __init__(self):
        self._lock = threading.Lock()
        self._alerts: Dict[str, HealthAlert] = {}

    def publish(self, alert: HealthAlert) -> HealthAlert:
        now = int(time.time() * 1e6)
        with self._lock:
            cur = self._alerts.get(alert.key)
            if cur is None:
                alert.first_us = alert.first_us or now
                alert.last_us = now
                self._alerts[alert.key] = cur = alert
            else:
                cur.last_us = now
                cur.count += 1
                cur.detail = alert.detail
                cur.value = alert.value
                cur.threshold = alert.threshold
                if alert.step is not None:
                    cur.step = alert.step
                if alert.severity == "page":
                    cur.severity = "page"
        m = metrics()
        m.gauge(f"watch_alert:{alert.kind}").set(1.0)
        m.gauge("watch_alerts_active").set(float(len(self._alerts)))
        return cur

    def resolve(self, key: str) -> None:
        with self._lock:
            a = self._alerts.pop(key, None)
        if a is not None:
            m = metrics()
            with self._lock:
                still = any(x.kind == a.kind for x in self._alerts.values())
            if not still:
                m.gauge(f"watch_alert:{a.kind}").set(0.0)
            m.gauge("watch_alerts_active").set(float(len(self._alerts)))

    def active(self) -> List[HealthAlert]:
        with self._lock:
            return sorted(self._alerts.values(),
                          key=lambda a: (a.severity != "page", a.key))

    def clear(self) -> None:
        with self._lock:
            self._alerts.clear()
        metrics().gauge("watch_alerts_active").set(0.0)


_BOARD = AlertBoard()


def board() -> AlertBoard:
    return _BOARD


def active_alerts() -> List[Dict[str, Any]]:
    """JSON-safe active alerts — what GetTelemetry(Delta) responses and
    the merged-trace ``alerts`` metadata carry."""
    return [a.to_dict() for a in _BOARD.active()]


# -- live-migration alert lifecycle (ISSUE 18) -------------------------------
#
# The elastic executor brackets each live plan migration with
# migration_started / migration_completed. The started alert is keyed by
# migration id (dedup on the board, watch_alert:migration gauge via the
# board's publish path); a daemon Timer escalates it to a "stalled" page
# if the stall budget elapses before completion; completion updates the
# detail and resolves the key (gauge back to 0). The LATEST migration id
# stays readable via migration_context() so the StragglerScorer's
# fleet_shape alerts can reference which migration reshaped the fleet.

_MIGRATION_CTX: Optional[str] = None
_MIGRATION_TIMERS: Dict[str, threading.Timer] = {}


def set_migration_context(mig_id: Optional[str]) -> None:
    global _MIGRATION_CTX
    _MIGRATION_CTX = mig_id


def migration_context() -> Optional[str]:
    return _MIGRATION_CTX


def migration_started(mig_id: str, detail: str = "",
                      driver: Optional[str] = None,
                      budget_ms: Optional[float] = None) -> HealthAlert:
    set_migration_context(mig_id)
    d = f"migration {mig_id} started"
    if driver:
        d += f" (driver {driver})"
    if detail:
        d += f": {detail}"
    alert = HealthAlert(kind=KIND_MIGRATION, name=mig_id, detail=d)
    out = _BOARD.publish(alert)
    metrics().counter("migrations_started").inc()
    if budget_ms:
        t = threading.Timer(budget_ms / 1e3, _migration_stalled,
                            args=(mig_id, budget_ms))
        t.daemon = True
        _MIGRATION_TIMERS[mig_id] = t
        t.start()
    return out


def _migration_stalled(mig_id: str, budget_ms: float) -> None:
    _BOARD.publish(HealthAlert(
        kind=KIND_MIGRATION, name=mig_id, severity="page",
        threshold=budget_ms,
        detail=(f"migration {mig_id} STALLED: still running past the "
                f"{budget_ms:.0f} ms stall budget")))
    metrics().counter("migrations_stalled").inc()


def migration_completed(mig_id: str, stall_ms: Optional[float] = None,
                        failed: bool = False,
                        detail: str = "") -> None:
    t = _MIGRATION_TIMERS.pop(mig_id, None)
    if t is not None:
        t.cancel()
    if failed:
        # Left ACTIVE (page): the executor is falling to the checkpoint
        # rollback rung — the operator should see why.
        _BOARD.publish(HealthAlert(
            kind=KIND_MIGRATION, name=mig_id, severity="page",
            detail=(f"migration {mig_id} FAILED"
                    + (f": {detail}" if detail else ""))))
        metrics().counter("migrations_failed").inc()
        return
    _BOARD.publish(HealthAlert(
        kind=KIND_MIGRATION, name=mig_id, value=stall_ms,
        detail=(f"migration {mig_id} completed"
                + (f" in {stall_ms:.0f} ms" if stall_ms is not None
                   else ""))))
    _BOARD.resolve(f"{KIND_MIGRATION}:{mig_id}")


# -- control-plane alerts (ISSUE 20) ----------------------------------------


def control_plane_alert(detail: str, wal_dir: str = "",
                        severity: str = "page") -> HealthAlert:
    """Publish a ``control_plane`` alert: the master's durable journal
    stopped journaling (write/fsync failure, lagging group commit). A
    silent WAL failure would turn the next master takeover into a
    checkpoint rollback, so this pages by default."""
    alert = HealthAlert(kind=KIND_CONTROL_PLANE, severity=severity,
                        name=wal_dir or None, detail=detail)
    out = _BOARD.publish(alert)
    metrics().counter("control_plane_alerts").inc()
    return out


# -- training-health sentinels ----------------------------------------------

class TrainingSentinel:
    """Loss-stream watchdog, called from the GA step with the on-host
    loss. Cost when healthy: one isfinite + a deque append + (past
    ``min_n``) one median/MAD over a <= ``window``-point deque."""

    def __init__(self, window: int = 16, min_n: int = 5,
                 spike_k: float = 4.0, spike_floor_frac: float = 0.5,
                 halt: str = "", board_: Optional[AlertBoard] = None):
        self.window = int(window)
        self.min_n = int(min_n)
        self.spike_k = float(spike_k)
        self.spike_floor_frac = float(spike_floor_frac)
        self.halt = (halt or "").strip().lower()
        self._board = board_ or _BOARD
        self._losses: Deque[float] = deque(maxlen=self.window)

    def observe(self, step: int, loss: float) -> Optional[HealthAlert]:
        """Returns the alert raised by this observation (already
        published to the board), or None. Raises ``WatchHalt`` when the
        halt knob covers the alert kind."""
        loss = float(loss)
        if not math.isfinite(loss):
            alert = HealthAlert(
                kind=KIND_NAN, severity="page", step=int(step),
                value=loss,
                detail=f"non-finite loss ({loss!r}) at step {step}")
            self._board.publish(alert)
            if self.halt in ("nan", "all", "1", "true"):
                raise WatchHalt(alert)
            return alert
        alert = None
        xs = list(self._losses)
        if len(xs) >= self.min_n:
            med = median(xs)
            band = mad_band(xs, floor=self.spike_floor_frac * abs(med),
                            k=self.spike_k)
            if loss > med + band:
                alert = HealthAlert(
                    kind=KIND_LOSS_SPIKE, step=int(step), value=loss,
                    threshold=med + band,
                    detail=(f"loss {loss:.4g} above window median "
                            f"{med:.4g} + band {band:.4g} at step {step}"))
                self._board.publish(alert)
        # A spike does NOT enter the baseline window: a divergence that
        # ratchets upward must keep alerting against the healthy
        # baseline, not normalize itself away.
        if alert is None:
            self._losses.append(loss)
        return alert


# -- straggler / anomaly scoring --------------------------------------------

class StragglerScorer:
    """Per-worker rolling digests with leave-one-out MAD-banded outlier
    scoring. A worker is an outlier on a signal when its rolling median
    exceeds the OTHER workers' pooled median plus ``max(3 * 1.4826 *
    MAD(others), abs_floor, rel_floor * others_median)`` — leave-one-out
    keeps the test sharp on two-worker fleets, where a pooled band would
    absorb the straggler's own samples. ``persist_polls`` consecutive
    outlier evaluations promote the condition to a straggler alert."""

    def __init__(self, signals: Tuple[str, ...] = ("step_ms", "rtt_ms"),
                 depth: int = 32, persist_polls: int = 2,
                 abs_floor_ms: float = 5.0, rel_floor: float = 0.5,
                 board_: Optional[AlertBoard] = None):
        self.signals = tuple(signals)
        self.depth = int(depth)
        self.persist_polls = int(persist_polls)
        self.abs_floor_ms = float(abs_floor_ms)
        self.rel_floor = float(rel_floor)
        self._board = board_ or _BOARD
        self._digests: Dict[Tuple[int, str], Deque[float]] = {}
        self._streak: Dict[Tuple[int, str], int] = {}
        self._known: set = set()

    def add(self, worker: int, signal: str, value: float) -> None:
        key = (int(worker), signal)
        d = self._digests.get(key)
        if d is None:
            d = self._digests[key] = deque(maxlen=self.depth)
        d.append(float(value))

    def workers(self) -> List[int]:
        return sorted({w for w, _ in self._digests})

    def digest(self, worker: int, signal: str) -> List[float]:
        return list(self._digests.get((int(worker), signal), ()))

    def score(self, worker: int, signal: str
              ) -> Optional[Dict[str, float]]:
        """One worker vs the rest on one signal: ``{"median", "others",
        "band", "over"}`` — ``over`` > 0 means outlier this evaluation."""
        mine = self.digest(worker, signal)
        others: List[float] = []
        for (w, s), d in self._digests.items():
            if s == signal and w != worker:
                others.extend(d)
        if not mine or not others:
            return None
        my_med = median(mine)
        oth_med = median(others)
        band = mad_band(others, floor=max(self.abs_floor_ms,
                                          self.rel_floor * abs(oth_med)))
        return {"median": my_med, "others": oth_med, "band": band,
                "over": my_med - (oth_med + band)}

    def evaluate(self) -> List[HealthAlert]:
        """Run after each poll: update streaks, publish straggler alerts
        for workers past ``persist_polls``, resolve recovered ones, and
        raise a fleet-shape event when the responding-worker set
        changes."""
        alerts: List[HealthAlert] = []
        workers = self.workers()
        for w in workers:
            outlier_on = None
            score = None
            for sig in self.signals:
                s = self.score(w, sig)
                if s is not None and s["over"] > 0:
                    outlier_on, score = sig, s
                    break
            key = (w, "_outlier")
            if outlier_on is not None:
                streak = self._streak.get(key, 0) + 1
                self._streak[key] = streak
                metrics().gauge(f"watch_straggler_score:{w}").set(
                    round(score["over"], 3))
                if streak >= self.persist_polls:
                    alert = HealthAlert(
                        kind=KIND_STRAGGLER, worker=w,
                        value=round(score["median"], 3),
                        threshold=round(score["others"] + score["band"],
                                        3),
                        detail=(f"worker {w} {outlier_on} median "
                                f"{score['median']:.1f} ms vs fleet "
                                f"{score['others']:.1f} + "
                                f"{score['band']:.1f} ms band "
                                f"({streak} consecutive polls)"))
                    alerts.append(self._board.publish(alert))
            else:
                self._streak[key] = 0
                metrics().gauge(f"watch_straggler_score:{w}").set(0.0)
                self._board.resolve(f"{KIND_STRAGGLER}:{w}")
        known = set(workers)
        if self._known and known != self._known:
            gone = sorted(self._known - known)
            new = sorted(known - self._known)
            detail = (f"fleet shape changed: -{gone} +{new}"
                      if gone else f"fleet shape changed: +{new}")
            # Fleet-shape events name the migration that reshaped the
            # fleet (when one ran) so the two alert streams join.
            ctx = migration_context()
            if ctx:
                detail += f" (migration {ctx})"
            alert = HealthAlert(
                kind=KIND_FLEET_SHAPE, severity="page" if gone else "warn",
                detail=detail)
            alerts.append(self._board.publish(alert))
        self._known = known
        return alerts


# -- SLO engine -------------------------------------------------------------

def _parse_toml_value(raw: str) -> Any:
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        return [_parse_toml_value(p) for p in inner.split(",")] \
            if inner else []
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    try:
        return int(raw)
    except ValueError:
        return float(raw)


def parse_slo_toml(text: str) -> Dict[str, Dict[str, Any]]:
    """Minimal TOML-subset reader for slo.toml — ``[slo.<name>]`` tables
    of scalar / flat-array values (this interpreter predates stdlib
    tomllib; no third-party dep is taken for a 20-line grammar)."""
    out: Dict[str, Dict[str, Any]] = {}
    section: Optional[Dict[str, Any]] = None
    for ln in text.splitlines():
        ln = ln.split("#", 1)[0].strip()
        if not ln:
            continue
        if ln.startswith("[") and ln.endswith("]"):
            name = ln[1:-1].strip()
            if name.startswith("slo."):
                section = out.setdefault(name[4:], {})
            else:
                section = None      # foreign tables are ignored
            continue
        if section is None or "=" not in ln:
            continue
        k, _, v = ln.partition("=")
        try:
            section[k.strip()] = _parse_toml_value(v)
        except ValueError:
            continue                # unparseable line: skip, don't wedge
    return out


@dataclasses.dataclass
class SloTarget:
    """One declarative objective. ``metric`` names a histogram in the
    metrics registry (``slo_class`` appends the per-class suffix the
    serving plane records, e.g. ``serve_ttft_ms:interactive``) or the
    special ``error_rate`` (counter-delta ratio of ``bad_counters`` over
    ``total_counters``). A poll is BAD when ``stat`` over the rolling
    samples exceeds ``target``; the error budget allows ``budget``
    fraction of bad polls, and the alert fires when the budget burns
    faster than ``burn_threshold`` on EVERY window in ``windows_s``."""

    name: str
    metric: str
    target: float
    stat: str = "p95"
    slo_class: str = ""
    budget: float = 0.05
    windows_s: Tuple[float, ...] = (30.0, 300.0)
    burn_threshold: float = 2.0
    min_samples: int = 3
    bad_counters: Tuple[str, ...] = ()
    total_counters: Tuple[str, ...] = ()

    @property
    def metric_key(self) -> str:
        return f"{self.metric}:{self.slo_class}" if self.slo_class \
            else self.metric


def load_slo_targets(path: str) -> List[SloTarget]:
    with open(path) as f:
        tables = parse_slo_toml(f.read())
    targets = []
    for name, t in tables.items():
        kw: Dict[str, Any] = {"name": name,
                              "metric": str(t.get("metric", name)),
                              "target": float(t.get("target", 0.0))}
        for k_toml, k_py, conv in (
                ("stat", "stat", str), ("class", "slo_class", str),
                ("budget", "budget", float),
                ("burn_threshold", "burn_threshold", float),
                ("min_samples", "min_samples", int)):
            if k_toml in t:
                kw[k_py] = conv(t[k_toml])
        if "windows_s" in t:
            kw["windows_s"] = tuple(float(w) for w in t["windows_s"])
        for k in ("bad_counters", "total_counters"):
            if k in t:
                kw[k] = tuple(str(x) for x in t[k])
        targets.append(SloTarget(**kw))
    return targets


class SLOEngine:
    """Multi-window burn-rate evaluation over declarative targets.

    Each ``observe()`` appends one (timestamp, bad) sample per target;
    ``evaluate()`` computes, per window W, ``burn = bad_fraction(W) /
    budget`` and alerts when every window's burn clears
    ``burn_threshold``. Sub-``budget`` noise therefore never alerts,
    a short transient trips only the short window, and a sustained
    breach trips both within one long-window fill."""

    def __init__(self, targets: List[SloTarget],
                 board_: Optional[AlertBoard] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.targets = list(targets)
        self._board = board_ or _BOARD
        self._clock = clock
        self._samples: Dict[str, Deque[Tuple[float, bool]]] = {
            t.name: deque() for t in self.targets}
        self._values: Dict[str, Deque[Tuple[float, float]]] = {
            t.name: deque() for t in self.targets}
        self._counter_prev: Dict[str, Dict[str, float]] = {}

    def feed(self, metric: str, values: List[float],
             now: Optional[float] = None) -> None:
        """Raw per-poll observations (e.g. step wall times from the
        delta stream) for targets whose metric matches — fresher than
        cumulative histogram reservoirs."""
        if not values:
            return
        now = self._clock() if now is None else now
        for t in self.targets:
            if t.metric_key != metric:
                continue
            dq = self._values[t.name]
            for v in values:
                dq.append((now, float(v)))
            horizon = now - max(t.windows_s)
            while dq and dq[0][0] < horizon:
                dq.popleft()

    def _current(self, t: SloTarget, snapshot: Dict[str, Any],
                 now: float) -> Optional[float]:
        if t.metric == "error_rate":
            counters = (snapshot or {}).get("counters") or {}
            cur = {k: float(counters.get(k, 0))
                   for k in t.bad_counters + t.total_counters}
            prev = self._counter_prev.get(t.name, {})
            self._counter_prev[t.name] = cur
            if not prev:
                return None
            bad = sum(max(cur[k] - prev.get(k, 0), 0)
                      for k in t.bad_counters)
            total = sum(max(cur[k] - prev.get(k, 0), 0)
                        for k in t.total_counters)
            total += bad if not t.total_counters else 0
            return bad / total if total > 0 else None
        dq = self._values[t.name]
        if dq:
            horizon = now - max(t.windows_s)
            vals = sorted(v for ts, v in dq if ts >= horizon)
            if vals:
                q = {"p50": 0.50, "p95": 0.95, "p99": 0.99}.get(t.stat)
                if q is None:
                    return vals[-1]
                return _quantile(vals, q)
        h = ((snapshot or {}).get("histograms") or {}).get(t.metric_key)
        if h and h.get("count"):
            return h.get(t.stat)
        return None

    def observe(self, snapshot: Dict[str, Any],
                now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        for t in self.targets:
            cur = self._current(t, snapshot, now)
            if cur is None:
                continue
            dq = self._samples[t.name]
            dq.append((now, cur > t.target))
            horizon = now - max(t.windows_s)
            while dq and dq[0][0] < horizon:
                dq.popleft()
            metrics().gauge(f"slo_current:{t.name}").set(round(cur, 4))

    def burn_rates(self, now: Optional[float] = None
                   ) -> Dict[str, Dict[float, Optional[float]]]:
        now = self._clock() if now is None else now
        out: Dict[str, Dict[float, Optional[float]]] = {}
        for t in self.targets:
            dq = self._samples[t.name]
            rates: Dict[float, Optional[float]] = {}
            for w in t.windows_s:
                xs = [bad for ts, bad in dq if ts >= now - w]
                if len(xs) < t.min_samples:
                    rates[w] = None
                else:
                    rates[w] = (sum(xs) / len(xs)) / t.budget \
                        if t.budget > 0 else float("inf")
            out[t.name] = rates
        return out

    def evaluate(self, now: Optional[float] = None) -> List[HealthAlert]:
        now = self._clock() if now is None else now
        alerts: List[HealthAlert] = []
        for t in self.targets:
            rates = self.burn_rates(now)[t.name]
            known = [r for r in rates.values() if r is not None]
            burning = (len(known) == len(rates) and known
                       and all(r >= t.burn_threshold for r in known))
            worst = max(known) if known else 0.0
            metrics().gauge(f"slo_burn:{t.name}").set(round(worst, 3))
            if burning:
                alert = HealthAlert(
                    kind=KIND_SLO_BURN, severity="page", name=t.name,
                    value=round(worst, 3), threshold=t.burn_threshold,
                    detail=(f"SLO '{t.name}' ({t.metric_key} {t.stat} "
                            f"<= {t.target}) burning error budget at "
                            + "/".join(f"{rates[w]:.1f}x@{int(w)}s"
                                       for w in t.windows_s)))
                alerts.append(self._board.publish(alert))
            else:
                self._board.resolve(f"{KIND_SLO_BURN}:{t.name}")
        return alerts


# -- the poller -------------------------------------------------------------

class Watchtower:
    """Master-side continuous monitor: polls every worker's
    ``GetTelemetryDelta``, maintains rolling per-worker state, and runs
    the scorer + SLO engine after each poll. Works over in-proc and gRPC
    transports alike (the verb rides the normal retry stack).

    ``clients`` is the master's per-worker client list (index == task
    index, rpc/client.py). The training loop can also feed signals
    directly (``observe_step``/``sentinel.observe``) — the RPC stream
    and the direct feed meet in the same digests."""

    def __init__(self, clients: Optional[List[Any]] = None,
                 interval_s: float = 2.0,
                 slo_path: Optional[str] = None,
                 persist_polls: int = 2,
                 halt: str = "",
                 board_: Optional[AlertBoard] = None):
        self._board = board_ or _BOARD
        self.clients = list(clients or [])
        self.interval_s = max(float(interval_s), 0.05)
        self.sentinel = TrainingSentinel(halt=halt, board_=self._board)
        self.scorer = StragglerScorer(persist_polls=persist_polls,
                                      board_=self._board)
        targets: List[SloTarget] = []
        if slo_path:
            try:
                targets = load_slo_targets(slo_path)
            except OSError:
                targets = []
        self.slo = SLOEngine(targets, board_=self._board)
        self.polls = 0
        self._cursors: Dict[int, Any] = {}      # per-worker RPC cursors
        # Heartbeats taken in per gauge: the count of its histogram.
        self._heartbeats: Dict[str, int] = {}
        self._worker_state: Dict[int, Dict[str, Any]] = {}
        self._step_ms: Deque[float] = deque(maxlen=256)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- direct feeds (training loop) -----------------------------------
    def observe_step(self, step: int, wall_ms: float,
                     per_worker_ms: Optional[Dict[int, float]] = None
                     ) -> None:
        """Called by the executor once per finished GA step with the
        master step wall and (when available) per-worker dispatch
        walls. Cheap: deque appends only; scoring happens per poll."""
        self._step_ms.append(float(wall_ms))
        self.slo.feed("step_time_ms", [float(wall_ms)])
        for w, ms in (per_worker_ms or {}).items():
            self.scorer.add(int(w), "step_ms", float(ms))

    # -- polling --------------------------------------------------------
    def skip_history(self) -> None:
        """Start every worker's delta cursor at the end of what its rings
        hold now, so the next poll reads only records written after this
        call. The rings are process-wide: without it a monitor's first
        poll takes in every record since they were last cleared, those
        of earlier fleets and of steps taken before it attached."""
        for ti, client in enumerate(self.clients):
            try:
                resp = client.get_telemetry_delta(
                    cursors=self._cursors.get(ti))
            except Exception:  # noqa: BLE001 — the first poll reports it
                continue
            self._cursors[ti] = resp.get("cursors")
        self._new_heartbeats(metrics().snapshot())

    def _new_heartbeats(self, snap: Dict[str, Any]
                        ) -> List[Tuple[int, float]]:
        """(worker, rtt ms) of each ``heartbeat_rtt_ms:<ti>`` gauge set
        since the last call: a gauge holds the LAST heartbeat of any
        fleet in the process, so it is taken only when its histogram's
        count moved (each heartbeat observes both), once."""
        out = []
        hists = snap.get("histograms") or {}
        for name, g in (snap.get("gauges") or {}).items():
            if not name.startswith("heartbeat_rtt_ms:") or g is None:
                continue
            n = int((hists.get(name) or {}).get("count") or 0)
            if n == self._heartbeats.get(name, 0):
                continue
            self._heartbeats[name] = n
            try:
                out.append((int(name.split(":", 1)[1]), float(g)))
            except ValueError:
                pass
        return out

    def poll_once(self) -> Dict[str, Any]:
        """One monitor pass: delta-poll every worker, update digests,
        evaluate the scorer and SLO engine. Returns the status dict the
        dashboard renders."""
        for ti, client in enumerate(self.clients):
            st = self._worker_state.setdefault(
                ti, {"alive": True, "records": 0, "dropped": 0,
                     "rtt_ms": None, "last_step": None})
            t0 = time.monotonic()
            try:
                resp = client.get_telemetry_delta(
                    cursors=self._cursors.get(ti))
            except Exception as e:  # noqa: BLE001 — any transport fail
                st["alive"] = False
                st["error"] = type(e).__name__
                continue
            rtt_ms = (time.monotonic() - t0) * 1e3
            st["alive"] = True
            st.pop("error", None)
            st["rtt_ms"] = round(rtt_ms, 3)
            self._cursors[ti] = resp.get("cursors")
            self.scorer.add(ti, "rtt_ms", rtt_ms)
            led = resp.get("ledger") or {}
            recs = led.get("records") or ()
            st["records"] += len(recs)
            st["dropped"] += int(led.get("dropped") or 0) \
                + int((resp.get("flight") or {}).get("dropped") or 0)
            for kind, verb, step, _t0, dur_us, _a, _b in recs:
                if kind == _K_HANDLER and verb in EXEC_VERBS \
                        and step >= 0:
                    self.scorer.add(ti, "step_ms", dur_us / 1e3)
                    st["last_step"] = max(st["last_step"] or 0, step)
                elif kind == _K_WINDOW:
                    self.slo.feed("step_time_ms", [dur_us / 1e3])
        # Master-side per-worker signals recorded between polls
        # (heartbeat gauges land here even when the poller cannot see
        # worker rings, e.g. before the first fleet step).
        snap = metrics().snapshot()
        for ti, rtt_ms in self._new_heartbeats(snap):
            self.scorer.add(ti, "rtt_ms", rtt_ms)
        self.polls += 1
        self.scorer.evaluate()
        self.slo.observe(snap)
        self.slo.evaluate()
        return self.status()

    def status(self) -> Dict[str, Any]:
        """The dashboard's data: per-worker table rows, recent step
        sparkline samples, burn rates, active alerts."""
        with self._lock:
            step_ms = list(self._step_ms)
        workers = {}
        for ti in sorted(set(self._worker_state)
                         | set(self.scorer.workers())):
            st = dict(self._worker_state.get(ti, {}))
            for sig in ("step_ms", "rtt_ms"):
                d = self.scorer.digest(ti, sig)
                if d:
                    st[f"{sig}_med"] = round(median(d), 3)
                s = self.scorer.score(ti, sig)
                if s is not None:
                    st[f"{sig}_over"] = round(s["over"], 3)
            workers[ti] = st
        return {
            "polls": self.polls,
            "workers": workers,
            "step_ms": step_ms[-64:],
            "burn_rates": {
                name: {str(int(w)): (None if r is None else round(r, 2))
                       for w, r in rates.items()}
                for name, rates in self.slo.burn_rates().items()},
            "alerts": active_alerts(),
        }

    # -- poller thread ---------------------------------------------------
    def start(self) -> "Watchtower":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="watchtower", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the monitor never kills
                pass           # the run it monitors

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


# -- process-global active watchtower ---------------------------------------

_ACTIVE: Optional[Watchtower] = None
_ACTIVE_LOCK = threading.Lock()


def set_active(wt: Optional[Watchtower]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = wt


def get_active() -> Optional[Watchtower]:
    return _ACTIVE


def observe_step(step: int, wall_ms: float,
                 per_worker_ms: Optional[Dict[int, float]] = None) -> None:
    """Module-level fast path for the executor: no-op without an active
    watchtower (one load + one branch)."""
    wt = _ACTIVE
    if wt is not None:
        wt.observe_step(step, wall_ms, per_worker_ms)
