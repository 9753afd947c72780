"""Always-on observability cost harness of the port: the counterpart of
``tools/obs_overhead.py``, with its flags, gates and output.

Measures the enabled-path cost of the port's telemetry instruments and
gates them as the reference does:

    ledger_overhead_pct        <= 2.0  (% of the two-worker fleet step)
    trace_enabled_ns_per_span  <= 600  (ns per recorded span)
    flight_overhead_pct        <= 2.0  (% of a serving burst)
    watch_overhead_pct         <= 1.0  (% of the two-worker fleet step)
    wal_overhead_pct           <= 1.0  (% of the two-worker fleet step)

plus an ungated informational line for the metrics registry hot paths
(counter inc / histogram observe).

Methodology (the reference's): a naive A/B cannot resolve tens of
microseconds of instrument cost inside a multi-threaded millisecond-scale
workload on a drifting host — an OFF-vs-OFF null experiment shows
"overhead" of the same magnitude as a real ON run. So every
percent-of-workload metric runs three measurements on one warm fixture:

    1. null calibration  — paired OFF/OFF windows; the median absolute
       pair delta is the host's A/B noise floor for that workload,
    2. paired A/B        — OFF/ON pairs in ABBA order (drift cancels),
    3. per-op accounting — record volumes counted from the instrument's
       own drain, times per-op costs measured in tight in-situ loops.

The reported value is the A/B median when it clears the noise floor,
else the per-op accounting total; both always ride along, with the
chosen methodology stamped. Nanosecond-scale metrics (trace span,
metrics hot paths) are tight single-threaded loops.

The fleet and serving fixtures run on ``--device`` (the card unless
``--device cpu``); the instruments themselves are host code, so every
number is host time, and a number taken on the card's machine belongs
beside that card's name and power limit. The tool keeps its own copies of
``bench.py``'s ``bench_trace_overhead`` and ``bench_ledger_overhead``
(``measure_trace``, ``measure_ledger``), with no baseline file: the port
has no bench history yet, so ``vs_baseline`` is null with a note. ``main(argv)`` returns the records
beside what it printed (``tools/torch_cli.py``).

Usage:
    python tools/torch_obs_overhead.py                # table
    python tools/torch_obs_overhead.py --json         # records to stdout
    python tools/torch_obs_overhead.py --out FILE     # {"extra": [...]}
    python tools/torch_obs_overhead.py --check        # exit 1 on any RED
    python tools/torch_obs_overhead.py --skip-flight  # fleet+trace+metrics
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

# The repository (the package) and this directory (the sibling tools).
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


# Above this window dispersion the run carries no regression verdict.
SPREAD_VERDICT_LIMIT = 0.10


def _host_canary_ms() -> float:
    """Median time of a fixed CPU workload (pure numpy): the
    host-speed reference the throughput verdicts are conditioned on."""
    import numpy as np

    a = np.random.default_rng(0).standard_normal((384, 384),
                                                 dtype=np.float32)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        b = a
        for _ in range(12):
            b = b @ a
            b *= 1.0 / np.abs(b).max()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3


def _verdict_fields(spread: float) -> dict:
    """The reference's dispersion fields, with no baseline: the port has
    no bench history yet (its benchmark comes later), so ``vs_baseline``
    is withheld with a note, never a ratio against another machine's
    numbers."""
    return {"spread": round(spread, 4),
            "host_canary_ms": round(_host_canary_ms(), 2),
            "vs_baseline": None,
            "verdict_note": "no port baseline: no regression verdict"}


def _ab_unreadable(ab_median: float, noise_floor: float, ab_pcts,
                   off_walls, accounted_pct=None, budget_pct=None):
    """Why a paired A/B median carries no verdict, or None when it does:
    below the null-calibrated floor; OFF windows spread past
    SPREAD_VERDICT_LIMIT (a loaded host: on one, three pairs of
    +/-20% jitter can all land above a two-pair floor by chance); or
    pairs on both sides of zero. Given ``budget_pct``, the spread refuses
    an A/B only while the per-op accounting lies far below the budget
    (a tenth of it or less): the line then reports the accounting, with
    the refused A/B median beside it."""
    off_spread = ((max(off_walls) - min(off_walls))
                  / statistics.median(off_walls) if off_walls else 0.0)
    spread_refuses = off_spread > SPREAD_VERDICT_LIMIT and (
        budget_pct is None or accounted_pct <= 0.1 * budget_pct)
    if ab_median <= noise_floor:
        return "below host noise floor"
    if spread_refuses:
        return (f"{ab_median:.2f}% refused: window spread "
                f"{off_spread:.1%} > {SPREAD_VERDICT_LIMIT:.0%}, loaded "
                f"host")
    if min(ab_pcts) <= 0.0:
        return "pairs straddle zero"
    return None


def measure_trace() -> dict:
    """Telemetry sanity line: the span() fast path must be a no-op when
    tracing is disabled (telemetry/trace.py contract — instrumented hot
    paths pay one branch, zero allocation). Measures both modes against a
    swapped-in private tracer so the numbers neither pollute nor drain
    the process ring buffer; the singleton identity is asserted outright,
    so a regression fails the line instead of shading the number."""
    from tepdist_tpu_torch.telemetry import _NULL_SPAN
    from tepdist_tpu_torch.telemetry import trace as _trace

    n = 20000
    prev = _trace.tracer()
    tmp = _trace.Tracer(capacity=n, enabled=False)
    _trace._TRACER = tmp
    try:
        assert _trace.span("bench", cat="bench") is _NULL_SPAN, \
            "disabled span() must return the shared no-op singleton"
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with _trace.span("bench", cat="bench"):
                pass
        disabled_ns = (time.perf_counter_ns() - t0) / n

        tmp.enabled = True
        # Min of repeated loops: on a tight loop, host noise is strictly
        # additive (deschedules, frequency dips only ever ADD time), so
        # the minimum is the estimator of the true per-span cost — and
        # unlike the median it is stable across processes on a loaded
        # host, which the perf-gate history band depends on.  The gated
        # budget is <= 600 ns/span.
        reps = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with _trace.span("bench", cat="bench"):
                    pass
            reps.append((time.perf_counter_ns() - t0) / n)
            tmp.clear()
        enabled_ns = min(reps)
    finally:
        _trace._TRACER = prev
    return {
        "metric": "trace_overhead",
        "value": round(disabled_ns, 1),
        "unit": "ns/span disabled",
        "trace_enabled_ns_per_span": round(enabled_ns, 1),
        "enabled_ns_per_span": round(enabled_ns, 1),
        "native_core": tmp._core is not None,
        "gate_below_600ns": bool(enabled_ns <= 600.0),
        "noop_fast_path": True,
    }


def measure_ledger(ab_pairs: int = 5, null_pairs: int = 3,
                   window_steps: int = 10, warmup: int = 6,
                   device: str = "cuda") -> dict:
    """RPC-ledger + flight-recorder cost on the two-worker in-proc fleet
    fixture, measured with the noise-guarded methodology.

    The naive A/B (one OFF run, one ON run, compare mins) cannot resolve
    a ~30 us effect on a ~4 ms multi-threaded step on a drifting host: an
    OFF-vs-OFF null experiment on this class of machine shows the same
    magnitude of "overhead" as a real ON run.  So the bench measures
    three things on ONE warm session and decides which is trustworthy:

    1. NULL CALIBRATION — ``null_pairs`` interleaved OFF/OFF window pairs
       (min-of-steps per window, alternating order).  The median absolute
       pair delta is the host's A/B noise floor for this workload.
    2. A/B — ``ab_pairs`` interleaved OFF/ON pairs, same estimator.
    3. PER-OP ACCOUNTING — record/scope volumes counted from a drained
       enabled step, times per-op in-situ costs measured in a tight loop
       (the full hook pattern: clocks + the bound native record call, and
       the full scope/hint context lifecycle).

    ``value`` is the A/B median when it clears the measured noise floor
    (a quiet host measures directly), else the per-op accounting total
    (a noisy host reports the physically attributable cost rather than a
    random draw from its own jitter).  Both are always reported, with the
    methodology stamped.  The acceptance bound is <= 2% of step time;
    disabled stays the ``active() is None`` branch-only fast path
    (``disabled_noop`` asserts it)."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.telemetry import flight
    from tepdist_tpu_torch.telemetry import ledger
    from torch_ledger_report import _model

    loss_fn, params, x, y = _model(device)

    telemetry.trace.configure(enabled=False)
    led = ledger.ledger()

    prog = plan_pipeline(loss_fn, 2, 2, params, x, y)
    cluster, _serv = make_inproc_cluster(2, [resolve_device(device)])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    try:
        sess.load_variables(params)
        for _ in range(warmup):
            sess.step(x, y)

        def window_ms(on: bool) -> float:
            ledger.configure(enabled=on)
            flight.configure(enabled=on)
            best = float("inf")
            for _ in range(window_steps):
                t0 = time.perf_counter()
                sess.step(x, y)
                best = min(best, time.perf_counter() - t0)
            led.clear()
            return best * 1e3

        # 1. Null calibration: both windows OFF — any nonzero delta is
        # host noise, and its magnitude is the floor below which a real
        # A/B delta is unreadable.
        null_pcts = []
        for p in range(null_pairs):
            a = window_ms(False)
            b = window_ms(False)
            null_pcts.append((b - a) / a * 100.0 if a else 0.0)
        noise_floor = statistics.median(abs(v) for v in null_pcts)

        ledger.configure(enabled=False)
        noop = ledger.active() is None

        # 2. Paired A/B, ABBA order so secular drift cancels per pair.
        ab_pcts = []
        off_mins = []
        for p in range(ab_pairs):
            if p % 2 == 0:
                off = window_ms(False)
                on = window_ms(True)
            else:
                on = window_ms(True)
                off = window_ms(False)
            off_mins.append(off)
            ab_pcts.append((on - off) / off * 100.0 if off else 0.0)
        ab_median = statistics.median(ab_pcts)
        off_ms = statistics.median(off_mins)

        # 3. Per-op accounting: volumes from one drained enabled window,
        # costs from tight in-situ loops.
        ledger.configure(enabled=True)
        led.clear()
        acct_steps = 4
        for _ in range(acct_steps):
            sess.step(x, y)
        recs, _cats, _lost, _names = led._drain()
        led.clear()
        kind_count = [0] * 8
        for r in recs:
            kind_count[r[0]] += 1
        # Wire hooks (PACK/UNPACK/ENCODE/DECODE/RETRY) each cost two
        # clock reads plus one bound record call; CALL/HANDLER/WINDOW
        # records come from scope objects whose lifecycle includes their
        # exit record.  Step hints leave no record — sites fire about
        # once per dispatch RPC, costed at the measured hint lifecycle.
        wire_per_step = sum(kind_count[i] for i in (0, 1, 2, 3, 6)) \
            / acct_steps
        scopes_per_step = sum(kind_count[i] for i in (4, 5, 7)) / acct_steps
        calls_per_step = kind_count[4] / acct_steps

        # Min-of-reps per-op costs: on a tight loop, host noise is
        # strictly additive, so the minimum is the estimator of the
        # true cost and is stable across processes on a loaded host.
        n = 5000
        def _min_ns(body):
            reps = []
            for _ in range(4):
                t0 = time.perf_counter_ns()
                body(n)
                reps.append((time.perf_counter_ns() - t0) / n)
            return min(reps)

        def _hook(m):
            for _ in range(m):
                ta = time.monotonic_ns()
                tb = time.monotonic_ns()
                led.record_pack(64, 256, ta, tb)

        def _scope(m):
            for _ in range(m):
                with ledger.client_scope("bench:acct"):
                    pass

        def _hint(m):
            for _ in range(m):
                with ledger.step_hint(3):
                    pass

        hook_ns = _min_ns(_hook)
        scope_ns = _min_ns(_scope)
        hint_ns = _min_ns(_hint)
        led.clear()

        accounted_us = (wire_per_step * hook_ns + scopes_per_step * scope_ns
                        + calls_per_step * hint_ns) / 1e3
        # Denominator: the floor across all OFF windows (each already
        # min-of-steps) — the same additive-noise argument as the
        # per-op loops, keeping the ratio stable run to run.
        off_floor_ms = min(off_mins) if off_mins else 0.0
        accounted_pct = accounted_us / (off_floor_ms * 1e3) * 100.0 \
            if off_floor_ms else 0.0

        off_spread = ((max(off_mins) - min(off_mins)) / off_ms
                      if off_ms else 0.0)
    finally:
        sess.close()
        close_inproc_cluster(cluster)
        ledger.configure(enabled=False)
        flight.configure(enabled=True)   # flight defaults ON

    # The A/B median is trustworthy only when it clears the
    # null-calibrated floor AND the pairs are internally coherent: a
    # single pair of the wrong sign, or the OFF-window spread guard
    # firing, is direct evidence that noise operates at the same scale
    # as the claimed effect — fall back to per-op accounting.
    ab_unreadable = _ab_unreadable(ab_median, noise_floor, ab_pcts,
                                   off_mins)
    pct = max(accounted_pct if ab_unreadable else ab_median, 0.0)
    methodology = ("ab_paired_windows" if ab_unreadable is None
                   else f"per_op_accounting (A/B {ab_unreadable})")
    return {
        "metric": "ledger_overhead_pct",
        "value": round(pct, 2),
        "unit": "% of fleet step (ledger+flight enabled vs off)",
        "methodology": methodology,
        "fleet_step_off_ms": round(off_ms, 3),
        "ab_median_pct": round(ab_median, 2),
        "ab_pair_pcts": [round(v, 2) for v in ab_pcts],
        "noise_floor_pct": round(noise_floor, 2),
        "accounted_pct": round(accounted_pct, 3),
        "accounted_us_per_step": round(accounted_us, 1),
        "wire_records_per_step": round(wire_per_step, 1),
        "scope_records_per_step": round(scopes_per_step, 1),
        "per_record_hook_ns": round(hook_ns, 1),
        "per_scope_ns": round(scope_ns, 1),
        "per_hint_ns": round(hint_ns, 1),
        "disabled_noop": noop,
        "gate_below_2pct": bool(pct <= 2.0),
        **_verdict_fields(off_spread),
    }




def measure_flight(ab_pairs: int = 5, null_pairs: int = 3,
                   n_requests: int = 8, device: str = "cuda") -> dict:
    """Flight-recorder cost on a serving burst — the only workload that
    actually records flight events (the training path records none).
    Same adaptive estimator as the ledger line, with its pair counts: on
    a host whose bursts swing by 10% or more, three pairs can all land
    above a two-pair floor by chance (a 12.77% reading against 0.73%
    accounted on a CPU host)."""
    import numpy as np

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.serving import ServingEngine
    from tepdist_tpu_torch.telemetry import flight

    cfg = gpt2.CONFIGS["test"]
    params = gpt2.init_params(cfg, 0, device=device)
    eng = ServingEngine(params, cfg, slots=4, max_len=32,
                        max_queue=n_requests + 1, name="obs",
                        device=device)
    rng = np.random.RandomState(0)
    rec = flight.recorder()
    seq = [0]

    def burst_ms(on: bool) -> float:
        flight.configure(enabled=on)
        tag = f"b{seq[0]}"
        seq[0] += 1
        for i in range(n_requests):
            t = int(rng.randint(3, 13))
            m = int(rng.randint(2, 8))
            eng.submit(f"{tag}-{i}",
                       rng.randint(0, cfg.vocab_size,
                                   size=t).astype(np.int32),
                       max_new_tokens=m)
        t0 = time.perf_counter()
        eng.run_until_idle()
        ms = (time.perf_counter() - t0) * 1e3
        rec.clear()
        return ms

    try:
        burst_ms(False)               # warmup absorbs compiles
        burst_ms(True)

        null_pcts = []
        for _ in range(null_pairs):
            a = burst_ms(False)
            b = burst_ms(False)
            null_pcts.append((b - a) / a * 100.0 if a else 0.0)
        noise_floor = statistics.median(abs(v) for v in null_pcts)

        ab_pcts = []
        off_walls = []
        for p in range(ab_pairs):
            if p % 2 == 0:
                off = burst_ms(False)
                on = burst_ms(True)
            else:
                on = burst_ms(True)
                off = burst_ms(False)
            off_walls.append(off)
            ab_pcts.append((on - off) / off * 100.0 if off else 0.0)
        ab_median = statistics.median(ab_pcts)
        off_ms = statistics.median(off_walls)

        # Accounting: events per burst from the recorder's own snapshot,
        # per-event cost from a tight loop on the real record() path.
        flight.configure(enabled=True)
        burst_start = time.perf_counter()
        tag = f"acct{seq[0]}"
        seq[0] += 1
        for i in range(n_requests):
            t = int(rng.randint(3, 13))
            m = int(rng.randint(2, 8))
            eng.submit(f"{tag}-{i}",
                       rng.randint(0, cfg.vocab_size,
                                   size=t).astype(np.int32),
                       max_new_tokens=m)
        eng.run_until_idle()
        acct_ms = (time.perf_counter() - burst_start) * 1e3
        snap = rec.snapshot()
        events = len(snap["events"]) + snap["dropped"] + snap["sampled_out"]
        rec.clear()

        # Min-of-reps per-event cost (additive-noise argument: the
        # minimum of a tight loop is the true cost), and the floor
        # across OFF bursts as denominator — both choices keep the
        # ratio stable run to run on a loaded host.
        n = 5000
        reps = []
        for _ in range(4):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                flight.record("obs-cal", "decode", tok=7)
            reps.append((time.perf_counter_ns() - t0) / n)
            rec.clear()
        per_event_ns = min(reps)

        off_floor_ms = min(off_walls) if off_walls else acct_ms
        accounted_pct = (events * per_event_ns / 1e6) / off_floor_ms \
            * 100.0 if off_floor_ms else 0.0
    finally:
        flight.configure(enabled=True)   # default ON

    # Same coherence rule as measure_ledger: the A/B
    # median is only readable when it clears the null floor, the OFF
    # bursts agree within SPREAD_VERDICT_LIMIT while the accounting is
    # far below the budget, AND no pair lands on the wrong side of zero
    # — one inverted pair means noise operates at the scale of the
    # claimed effect.
    ab_unreadable = _ab_unreadable(ab_median, noise_floor, ab_pcts,
                                   off_walls, accounted_pct, 2.0)
    pct = max(accounted_pct if ab_unreadable else ab_median, 0.0)
    methodology = ("ab_paired_bursts" if ab_unreadable is None
                   else f"per_op_accounting (A/B {ab_unreadable})")
    return {
        "metric": "flight_overhead_pct",
        "value": round(pct, 2),
        "unit": "% of serving burst (flight enabled vs off)",
        "methodology": methodology,
        "burst_off_ms": round(off_ms, 1),
        "ab_median_pct": round(ab_median, 2),
        "ab_pair_pcts": [round(v, 2) for v in ab_pcts],
        "noise_floor_pct": round(noise_floor, 2),
        "accounted_pct": round(accounted_pct, 3),
        "events_per_burst": events,
        "per_event_ns": round(per_event_ns, 1),
        "gate_below_2pct": bool(pct <= 2.0),
    }


def measure_watch(ab_pairs: int = 5, null_pairs: int = 3,
                  steps: int = 4, device: str = "cuda") -> dict:
    """Watchtower cost on the two-worker fleet step: sentinel observe +
    step feed + a poller thread delta-polling both workers at an
    aggressively short interval (50 ms — far hotter than the 2 s
    default, so the gate bounds a worst case). OFF = no active
    watchtower (the observe_step hook is one load + one branch); ON =
    active watchtower with the poller running. Same null-calibrated
    ABBA estimator and pair counts as the flight line."""
    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.telemetry import watchtower
    from torch_ledger_report import _model

    loss_fn, params, x, y = _model(device)
    prog = plan_pipeline(loss_fn, 2, 2, params, x, y)
    cluster, _servicers = make_inproc_cluster(2, [resolve_device(device)])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    try:
        sess.load_variables(params)
        for _ in range(2):
            sess.step(x, y)          # warmup absorbs compiles

        def window_ms(on: bool) -> float:
            wt = None
            if on:
                wt = watchtower.Watchtower(
                    clients=[sess.clients[ti]
                             for ti in sorted(sess.clients)],
                    interval_s=0.05)
                watchtower.set_active(wt)
                wt.start()
            try:
                t0 = time.perf_counter()
                for _ in range(steps):
                    sess.step(x, y)
                return (time.perf_counter() - t0) * 1e3
            finally:
                if wt is not None:
                    wt.stop()
                    watchtower.set_active(None)

        window_ms(True)              # warm the poll path too

        null_pcts = []
        for _ in range(null_pairs):
            a = window_ms(False)
            b = window_ms(False)
            null_pcts.append((b - a) / a * 100.0 if a else 0.0)
        noise_floor = statistics.median(abs(v) for v in null_pcts)

        ab_pcts = []
        off_walls = []
        for p in range(ab_pairs):
            if p % 2 == 0:
                off = window_ms(False)
                on = window_ms(True)
            else:
                on = window_ms(True)
                off = window_ms(False)
            off_walls.append(off)
            ab_pcts.append((on - off) / off * 100.0 if off else 0.0)
        ab_median = statistics.median(ab_pcts)
        off_ms = statistics.median(off_walls)

        # Accounting: the poller runs off the step's critical path (its
        # own thread, GIL-interleaved); the only on-path cost is the
        # per-step feed (histogram observes + deque appends + sentinel
        # compares). Measure that with the real hook in a tight loop.
        wt = watchtower.Watchtower(clients=[])
        watchtower.set_active(wt)
        n = 2000
        reps = []
        for _ in range(4):
            t0 = time.perf_counter_ns()
            for i in range(n):
                watchtower.observe_step(i, 12.5, {0: 6.0, 1: 6.2})
                wt.sentinel.observe(i, 1.0)
            reps.append((time.perf_counter_ns() - t0) / n)
        watchtower.set_active(None)
        per_step_ns = min(reps)
        off_floor_ms = min(off_walls) if off_walls else 1.0
        accounted_pct = (steps * per_step_ns / 1e6) / off_floor_ms \
            * 100.0 if off_floor_ms else 0.0
    finally:
        sess.close()
        close_inproc_cluster(cluster)

    # measure_flight's coherence rule.
    ab_unreadable = _ab_unreadable(ab_median, noise_floor, ab_pcts,
                                   off_walls, accounted_pct, 1.0)
    pct = max(accounted_pct if ab_unreadable else ab_median, 0.0)
    methodology = ("ab_paired_windows" if ab_unreadable is None
                   else f"per_op_accounting (A/B {ab_unreadable})")
    return {
        "metric": "watch_overhead_pct",
        "value": round(pct, 2),
        "unit": "% of two-worker fleet step (watchtower on vs off)",
        "methodology": methodology,
        "window_off_ms": round(off_ms, 1),
        "ab_median_pct": round(ab_median, 2),
        "ab_pair_pcts": [round(v, 2) for v in ab_pcts],
        "noise_floor_pct": round(noise_floor, 2),
        "accounted_pct": round(accounted_pct, 3),
        "per_step_ns": round(per_step_ns, 1),
        "gate_below_1pct": bool(pct <= 1.0),
    }


def measure_wal(ab_pairs: int = 5, null_pairs: int = 3,
                steps: int = 10, device: str = "cuda") -> dict:
    """Control-plane WAL cost on the two-worker fleet step: each step
    appends a commit-watermark record through the group-commit thread
    (fsync rides OFF the step critical path; the step only pays encode +
    enqueue). OFF = no WAL attached; ON = session journaling to a fresh
    WAL dir with the default fsync policy. The GATED value is the
    physical per-record accounting (see the estimator note below); the
    null-calibrated ABBA pairs ride along in the record as an
    informational cross-check."""
    import itertools
    import shutil
    import tempfile

    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime import controlplane
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from torch_ledger_report import _model

    loss_fn, params, x, y = _model(device)
    prog = plan_pipeline(loss_fn, 2, 2, params, x, y)
    cluster, _servicers = make_inproc_cluster(2, [resolve_device(device)])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    tmp = tempfile.mkdtemp(prefix="tepdist-walbench-")
    tag = itertools.count()
    try:
        sess.load_variables(params)
        for _ in range(2):
            sess.step(x, y)          # warmup absorbs compiles

        # ONE session for every window: ON attaches a fresh journal to
        # the running session (exactly the step-path hook a journaling
        # master pays — encode + CRC + group-commit enqueue), OFF
        # detaches it. Rebuilding the fleet per window would swamp the
        # signal with construction noise.
        def window_ms(on: bool) -> float:
            wal = None
            if on:
                wal = controlplane.ControlPlaneWAL(
                    os.path.join(tmp, f"wal-{next(tag)}"),
                    on_error=sess._wal_error)
                sess._wal = wal
            try:
                t0 = time.perf_counter()
                for _ in range(steps):
                    sess.step(x, y)
                return (time.perf_counter() - t0) * 1e3
            finally:
                if wal is not None:
                    sess._wal = None
                    wal.close()

        window_ms(True)              # warm the journal path too

        null_pcts = []
        for _ in range(null_pairs):
            a = window_ms(False)
            b = window_ms(False)
            null_pcts.append((b - a) / a * 100.0 if a else 0.0)
        noise_floor = statistics.median(abs(v) for v in null_pcts)

        ab_pcts = []
        off_walls = []
        for p in range(ab_pairs):
            if p % 2 == 0:
                off = window_ms(False)
                on = window_ms(True)
            else:
                on = window_ms(True)
                off = window_ms(False)
            off_walls.append(off)
            ab_pcts.append((on - off) / off * 100.0 if off else 0.0)
        ab_median = statistics.median(ab_pcts)
        off_ms = statistics.median(off_walls)

        # Accounting: the only on-path cost is append() — JSON encode +
        # CRC + enqueue to the group-commit thread. Measure it directly.
        cal_dir = os.path.join(tmp, "wal-cal")
        wal = controlplane.ControlPlaneWAL(cal_dir)
        n = 2000
        reps = []
        for r in range(4):
            t0 = time.perf_counter_ns()
            for i in range(n):
                controlplane.log_step(wal, r * n + i)
            reps.append((time.perf_counter_ns() - t0) / n)
        wal.close()
        per_record_ns = min(reps)
        off_floor_ms = min(off_walls) if off_walls else 1.0
        accounted_pct = (steps * per_record_ns / 1e6) / off_floor_ms \
            * 100.0 if off_floor_ms else 0.0
    finally:
        sess.close()
        close_inproc_cluster(cluster)
        shutil.rmtree(tmp, ignore_errors=True)

    # GATE ON THE ACCOUNTING, unlike the sibling A/B lines: the ON
    # windows carry a background fsync thread, so disk-latency bursts
    # leak one-sided multi-percent noise into the pair deltas (observed
    # swings of +/-30% against a ~0.1% true cost) — at that SNR the A/B
    # cannot resolve the journal and only flaps the gate. The accounting
    # is not a weaker check here: it drives 2000 live append()s against
    # the running group-commit writer, so the one regression class the
    # gate exists to catch — the append path turning synchronous /
    # fsync-bound — shows up as a ~1000x jump in per_record_ns and trips
    # it directly. The A/B stays in the record as a cross-check; it is
    # only worth a look when its MIN pair clears the null floor.
    ab_min = min(ab_pcts)
    pct = max(accounted_pct, 0.0)
    methodology = "per_op_accounting (A/B informational: fsync-burst " \
        "noise swamps pair deltas)"
    return {
        "metric": "wal_overhead_pct",
        "value": round(pct, 2),
        "ab_min_pct": round(ab_min, 2),
        "unit": "% of two-worker fleet step (WAL on vs off)",
        "methodology": methodology,
        "window_off_ms": round(off_ms, 1),
        "ab_median_pct": round(ab_median, 2),
        "ab_pair_pcts": [round(v, 2) for v in ab_pcts],
        "noise_floor_pct": round(noise_floor, 2),
        "accounted_pct": round(accounted_pct, 3),
        "per_record_ns": round(per_record_ns, 1),
        "gate_below_1pct": bool(pct <= 1.0),
    }


def measure_metrics() -> dict:
    """Metrics registry hot paths: counter inc and histogram observe.
    Informational (no watchlist gate) — these sit on the same serving
    hot paths the flight gate already bounds end-to-end."""
    from tepdist_tpu_torch.telemetry.metrics import metrics

    reg = metrics()
    n = 50000
    c = reg.counter("obs_overhead_cal")
    reps = []
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            c.inc()
        reps.append((time.perf_counter_ns() - t0) / n)
    counter_ns = statistics.median(reps)

    h = reg.histogram("obs_overhead_cal_ms")
    reps = []
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            h.observe(1.25)
        reps.append((time.perf_counter_ns() - t0) / n)
    histogram_ns = statistics.median(reps)

    return {
        "metric": "metrics_hot_ns",
        "value": round(histogram_ns, 1),
        "unit": "ns/observe",
        "counter_inc_ns": round(counter_ns, 1),
        "histogram_observe_ns": round(histogram_ns, 1),
    }


GATES = (
    ("ledger_overhead_pct", "gate_below_2pct"),
    ("trace_overhead", "gate_below_600ns"),
    ("flight_overhead_pct", "gate_below_2pct"),
    # The watchtower budget is tighter than the instruments': a MONITOR
    # that costs more than 1% of what it monitors is part of the problem.
    ("watch_overhead_pct", "gate_below_1pct"),
    # Same 1% budget for the control-plane journal: crash safety must be
    # invisible on the step path (fsync rides the group-commit thread).
    ("wal_overhead_pct", "gate_below_1pct"),
)


def main(argv=None) -> dict:
    """``{"rc", "text", "records"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser(
        "obs_overhead", description="always-on telemetry cost harness")
    ap.add_argument("--json", action="store_true",
                    help="print records as JSON lines")
    ap.add_argument("--out", help="write {'extra': [...]} JSON "
                                  "(perf_gate --extra compatible)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any overhead gate is RED")
    ap.add_argument("--skip-trace", action="store_true",
                    help="skip the tracer span-cost measurement")
    ap.add_argument("--skip-ledger", action="store_true",
                    help="skip the fleet-step ledger measurement")
    ap.add_argument("--skip-flight", action="store_true",
                    help="skip the serving-burst flight measurement")
    ap.add_argument("--skip-watch", action="store_true",
                    help="skip the fleet-step watchtower measurement")
    ap.add_argument("--skip-wal", action="store_true",
                    help="skip the fleet-step control-plane WAL "
                         "measurement")
    ap.add_argument("--device", default="cuda",
                    help="the fixtures' device (cuda or cpu)")
    args = ap.parse_args(argv)

    records = []
    if not args.skip_trace:
        records.append(measure_trace())
    if not args.skip_ledger:
        records.append(measure_ledger(device=args.device))
    if not args.skip_flight:
        records.append(measure_flight(device=args.device))
    if not args.skip_watch:
        records.append(measure_watch(device=args.device))
    if not args.skip_wal:
        records.append(measure_wal(device=args.device))
    records.append(measure_metrics())

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"extra": records}, f, indent=1)

    failures = []
    by_metric = {r.get("metric"): r for r in records}
    for metric, gate_key in GATES:
        r = by_metric.get(metric)
        if r is None:
            continue
        if not r.get(gate_key, False):
            failures.append(f"{metric}: {gate_key} is RED "
                            f"(value {r.get('value')})")

    if args.json:
        for r in records:
            print(json.dumps(r))
    else:
        print("always-on observability cost")
        print("-" * 60)
        for r in records:
            gate = ""
            for metric, gate_key in GATES:
                if r.get("metric") == metric:
                    gate = " GREEN" if r.get(gate_key) else " RED"
            meth = r.get("methodology")
            meth_s = f"  [{meth}]" if meth else ""
            print(f"{r.get('metric'):28s} {r.get('value')} "
                  f"{r.get('unit', '')}{gate}{meth_s}")
        key_fields = ("ab_median_pct", "noise_floor_pct", "accounted_pct",
                      "trace_enabled_ns_per_span")
        for r in records:
            parts = [f"{k}={r[k]}" for k in key_fields if k in r]
            if parts:
                print(f"    {r.get('metric')}: {', '.join(parts)}")

    if failures:
        for f_ in failures:
            print(f"OVERHEAD GATE: {f_}", file=sys.stderr)
        return (1 if args.check else 0), {"records": records}
    if args.check:
        print("overhead gates: all GREEN")
    return 0, {"records": records}


if __name__ == "__main__":
    sys.exit(main()["rc"])
