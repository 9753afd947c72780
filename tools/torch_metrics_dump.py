"""Scrape the port's fleet metrics without Perfetto: GetTelemetry -> text.
The counterpart of ``tools/metrics_dump.py``, with its flags and output,
over ``tepdist_tpu_torch/telemetry/export.py``.

Pulls the metrics snapshot (counters / gauges / histograms with
reservoir p50/p95/p99) from each worker address via the ``GetTelemetry``
verb, folds them into one fleet view (``MetricsRegistry.merge``), and
prints either JSON or the Prometheus text exposition format
(``--prometheus``). An ``inproc:<port>`` address reaches a servicer in
this process (no ``grpcio`` needed); a ``host:port`` one opens a gRPC
channel. It moves no tensors: no device. ``main(argv)`` returns the merged
registry beside what it printed (``tools/torch_cli.py``).

Run: python tools/torch_metrics_dump.py ADDR [ADDR...] [--prometheus]
     [--clear]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "metrics"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("metrics_dump")
    ap.add_argument("addrs", nargs="+",
                    help="worker addresses (host:port or inproc:<port>)")
    ap.add_argument("--prometheus", action="store_true",
                    help="Prometheus text format instead of JSON")
    ap.add_argument("--clear", action="store_true",
                    help="drain each worker's span ring while pulling")
    args = ap.parse_args(argv)

    from tepdist_tpu_torch.rpc.client import TepdistClient
    from tepdist_tpu_torch.telemetry.export import to_prometheus
    from tepdist_tpu_torch.telemetry.metrics import MetricsRegistry

    snaps = []
    dropped = {}
    for addr in args.addrs:
        try:
            h = TepdistClient(addr).get_telemetry(clear=args.clear)
        except Exception as e:  # noqa: BLE001 — report and continue
            print(f"{addr}: GetTelemetry failed: {e!r}", file=sys.stderr)
            continue
        if h.get("metrics"):
            snaps.append(h["metrics"])
        if h.get("spans_dropped"):
            dropped[str(h.get("task_index", addr))] = h["spans_dropped"]
    if not snaps:
        print("no metrics pulled", file=sys.stderr)
        return 1, {"metrics": None}
    merged = MetricsRegistry.merge(snaps)
    if dropped:
        merged.setdefault("counters", {})["spans_dropped"] = sum(
            dropped.values())
    if args.prometheus:
        sys.stdout.write(to_prometheus(merged))
    else:
        print(json.dumps(merged, indent=1))
    return 0, {"metrics": merged}


if __name__ == "__main__":
    sys.exit(main()["rc"])
