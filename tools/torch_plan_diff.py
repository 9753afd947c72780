"""Diff two ExplorationReports of the port: winner flips, named drivers,
cost deltas. The counterpart of ``tools/plan_diff.py``, with its flags and
output, over ``tepdist_tpu_torch/telemetry/observatory.py``.

Given two reports (before/after a code change, across calibration
profiles, or across device counts) it flags winner flips and names what
drove each: a cost term (``compute_s``/``coll_s``/``bubble_s``, via the
largest mover of the new-vs-old winner gap between the two runs),
``memory_feasible`` (a feasibility verdict changed), or
``candidate_set_change`` (a winner only exists in one report).

Exit-code contract:

* ``--check``       exit 1 on ANY winner flip (identical runs diff empty);
* ``--expect-flip`` exit 1 unless a flip WITH a named driver was found
  (proves the detector actually fires on a seeded perturbation).

It reads JSON only: no device. ``main(argv)`` returns the diff beside what
it printed (``tools/torch_cli.py``).

Run:
    python tools/torch_plan_diff.py old.json new.json
    python tools/torch_plan_diff.py old.json new.json --check
    python tools/torch_plan_diff.py base.json perturbed.json --expect-flip
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def load_report(path: str) -> Optional[Dict[str, Any]]:
    """A bare report JSON or a merged trace carrying one in metadata."""
    with open(path) as f:
        doc = json.load(f)
    if "candidates" in doc and "version" in doc:
        return doc
    return (doc.get("metadata") or {}).get("exploration")


def print_diff(d: Dict[str, Any], top: int = 8) -> None:
    print(f"old winner: {d.get('old_winner')}")
    print(f"new winner: {d.get('new_winner')}")
    if d.get("candidates_added"):
        print(f"candidates added:   {d['candidates_added']}")
    if d.get("candidates_removed"):
        print(f"candidates removed: {d['candidates_removed']}")
    deltas = [r for r in d.get("cost_deltas") or []
              if r["delta_total_s"]]
    if deltas:
        print(f"largest cost deltas (of {len(deltas)} changed):")
        for r in deltas[:top]:
            print(f"  {r['kind']:>8} {r['config']:<34} "
                  f"{r['delta_total_s']:+.3e}s "
                  f"(rank {r['old_rank']} -> {r['new_rank']})")
    else:
        print("cost deltas: none (identical candidate costs)")
    if d.get("flip"):
        print(f"WINNER FLIP — driver: {d.get('driver')}")
        if d.get("movers_s"):
            print("  per-term movers of the new-vs-old winner gap:")
            for t, v in d["movers_s"].items():
                print(f"    {t:<12} {v:+.3e}s")
        print(f"  {d.get('detail')}")
    else:
        print("no winner flip")


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "diff"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("plan_diff")
    ap.add_argument("old", help="baseline ExplorationReport JSON "
                               "(or trace with metadata.exploration)")
    ap.add_argument("new", help="candidate ExplorationReport JSON")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any winner flip")
    ap.add_argument("--expect-flip", action="store_true",
                    help="exit 1 unless a flip with a named driver "
                         "was detected (detector self-test)")
    ap.add_argument("--top", type=int, default=8,
                    help="cost-delta rows to print")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from tepdist_tpu_torch.telemetry import observatory

    old = load_report(args.old)
    new = load_report(args.new)
    for path, rep in ((args.old, old), (args.new, new)):
        if rep is None:
            print(f"{path}: not an ExplorationReport (and no "
                  "metadata.exploration)", file=sys.stderr)
            return 2

    d = observatory.diff_reports(old, new)

    if args.json:
        print(json.dumps(d, indent=1, default=str))
    else:
        print_diff(d, top=args.top)

    if args.check and d.get("flip"):
        print(f"plan_diff check FAILED: winner flip "
              f"{d.get('old_winner')} -> {d.get('new_winner')} "
              f"(driver: {d.get('driver')})", file=sys.stderr)
        return 1, {"diff": d}
    if args.expect_flip and not (d.get("flip") and d.get("driver")):
        print("plan_diff --expect-flip FAILED: no named winner flip "
              "detected", file=sys.stderr)
        return 1, {"diff": d}
    if args.check:
        print("plan_diff check OK (no winner flip)")
    if args.expect_flip:
        print(f"plan_diff --expect-flip OK (driver: {d.get('driver')})")
    return 0, {"diff": d}


if __name__ == "__main__":
    sys.exit(main()["rc"])
