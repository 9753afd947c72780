"""Render serving flight-recorder waterfalls of the port: the counterpart
of ``tools/request_trace.py``, with its flags and output, over
``tepdist_tpu_torch/telemetry/flight.py``.

A request's life is scattered across processes — client submit, RPC
placement, engine queue/admit/prefill/decode, supervisor restart replay,
poll delivery. The flight recorder captures each hop as a tagged event;
this tool turns a merged event list into the per-request story:

* text waterfall — one request per block, one line per event with
  relative-ms offset, source process, engine generation, and args. A
  request that survived an engine restart shows its replay under the new
  ``gen`` with exactly one ``finish``/``deliver``.
* Perfetto export (``--perfetto OUT``) — every event as a thin slice on
  a per-process track plus ``s``/``t``/``f`` flow arrows chaining each
  request's events ACROSS process tracks.

Input modes:

* ``--trace FILE`` — a merged trace from ``session.dump_trace()`` /
  ``ServeClient.dump_trace()``; events ride in ``metadata.flight``.
* ``--flight FILE`` — a raw snapshot (``{"events": [...]}`` or a bare
  list).
* ``--demo`` — run a supervised GPT-2 ``test`` engine live on
  ``--device`` (the card unless ``--device cpu``), inject an
  ``engine_crash`` at step 2, and render the survivors' waterfalls.

``main(argv)`` returns the events beside what it printed
(``tools/torch_cli.py``).

Run: python tools/torch_request_trace.py --demo --device cpu [--rid r1
     --perfetto /tmp/f.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tepdist_tpu_torch.telemetry import flight  # noqa: E402


def load_events(args) -> List[Dict[str, Any]]:
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
        evs = (trace.get("metadata") or {}).get("flight")
        if not evs:
            raise SystemExit(f"{args.trace}: no flight metadata — re-dump "
                             "with TEPDIST_FLIGHT=1")
        return evs
    if args.flight:
        with open(args.flight) as f:
            payload = json.load(f)
        return payload.get("events", payload) if isinstance(payload, dict) \
            else payload
    return run_demo(args.device)


def run_demo(device: str = "cuda") -> List[Dict[str, Any]]:
    """Supervised engine + injected crash at step 2: three requests ride
    across both engine incarnations."""
    import numpy as np

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.serving import ServingSupervisor

    cfg = gpt2.CONFIGS["test"]
    params = gpt2.init_params(cfg, 0, device=device)
    flight.configure(enabled=True)
    flight.recorder().clear()
    sup = ServingSupervisor(params, cfg, slots=2, max_len=32,
                            device=device)
    rng = np.random.RandomState(0)
    for i in range(3):
        sup.submit(f"r{i}",
                   rng.randint(1, cfg.vocab_size, size=5).astype(np.int32),
                   max_new_tokens=6)
    faults.configure("engine_crash:step=2")
    try:
        sup.run_until_idle()
    finally:
        faults.reset()
    sup.poll()
    return flight.recorder().snapshot()["events"]


def _fmt_args(e: Dict[str, Any]) -> str:
    a = dict(e.get("args") or {})
    gen = a.pop("gen", None)
    body = " ".join(f"{k}={v}" for k, v in sorted(a.items()))
    return (f"gen={gen} " if gen is not None else "") + body


def print_waterfall(events: List[Dict[str, Any]],
                    rid: Optional[str] = None) -> None:
    groups = flight.by_request(events)
    rids = [rid] if rid else sorted(groups)
    for r in rids:
        evs = groups.get(r)
        if not evs:
            print(f"{r}: no events")
            continue
        t0 = evs[0].get("ts", 0)
        gens = sorted({(e.get("args") or {}).get("gen")
                       for e in evs
                       if (e.get("args") or {}).get("gen") is not None})
        head = f"request {r} — {len(evs)} events"
        if gens:
            head += f", engine gen(s) {gens}"
        print(head)
        for e in evs:
            dt = (e.get("ts", 0) - t0) / 1e3
            proc = e.get("proc", "local")
            print(f"  +{dt:9.3f} ms  {proc:<10} {e.get('ev', '?'):<14} "
                  f"{_fmt_args(e)}")
        print()


def to_perfetto(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Flight events as thin slices on per-process tracks + per-request
    flow arrows (`s`/`t`/`f` chains) hopping across the tracks."""
    procs: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []

    def pid_for(proc: str) -> int:
        if proc not in procs:
            procs[proc] = len(procs)
            out.append({"name": "process_name", "ph": "M",
                        "pid": procs[proc], "tid": 0,
                        "args": {"name": f"flight:{proc}"}})
        return procs[proc]

    flow_id = 0
    for r, evs in sorted(flight.by_request(events).items()):
        flow_id += 1
        for i, e in enumerate(evs):
            pid = pid_for(str(e.get("proc", "local")))
            ts = float(e.get("ts", 0))
            name = e.get("ev", "?")
            args = dict(e.get("args") or {})
            args["rid"] = r
            # Thin slice so the flow arrow has something to bind to.
            out.append({"name": name, "cat": "flight", "ph": "X",
                        "ts": ts, "dur": 30.0, "pid": pid, "tid": 0,
                        "args": args})
            if len(evs) > 1:
                ph = "s" if i == 0 else ("f" if i == len(evs) - 1 else "t")
                flow = {"name": r, "cat": "flight", "ph": ph,
                        "id": flow_id, "ts": ts, "pid": pid, "tid": 0}
                if ph == "f":
                    flow["bp"] = "e"
                out.append(flow)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "events"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("request_trace")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None,
                     help="merged trace JSON (metadata.flight)")
    src.add_argument("--flight", default=None,
                     help="raw flight snapshot / event-list JSON")
    src.add_argument("--demo", action="store_true",
                     help="live demo: supervised engine + injected crash")
    ap.add_argument("--rid", default=None, help="only this request")
    ap.add_argument("--perfetto", default=None, metavar="OUT",
                    help="also write the flow-arrow Perfetto trace here")
    ap.add_argument("--json", action="store_true",
                    help="dump the (grouped) events as JSON instead")
    ap.add_argument("--device", default="cuda",
                    help="demo: the engine's device (cuda or cpu)")
    args = ap.parse_args(argv)

    events = load_events(args)
    if args.rid:
        events = [e for e in events if e.get("rid") in (args.rid, "*")]

    if args.json:
        print(json.dumps(flight.by_request(events), indent=1))
    else:
        print_waterfall(events, rid=args.rid)

    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump(to_perfetto(events), f, separators=(",", ":"))
        print(f"perfetto flow trace: {args.perfetto}")
    return 0, {"events": events}


if __name__ == "__main__":
    sys.exit(main()["rc"])
