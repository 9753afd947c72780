#!/usr/bin/env python
"""Concurrency lockdep CLI for the PyTorch port
(``tepdist_tpu_torch/analysis/lockdep.py``).

    python tools/torch_lockdep.py           # report: locks, edges, findings
    python tools/torch_lockdep.py --check   # gate: fail on un-allowlisted
    python tools/torch_lockdep.py --confirm edges.json

``--check`` exits 1 if any finding is not justified in
``tepdist_tpu_torch/analysis/lockdep_allow.toml`` (and 2 if an allowlist
entry no longer matches anything — stale entries must be deleted, not
hoarded). ``--confirm`` reads runtime edges (a JSON list of
``[outer, inner]`` pairs, as ``lockdep_runtime.edges()`` records them
under ``TEPDIST_LOCKDEP=1``) and reports which static edges they
confirm, which they contradict (an observed inverse), and which observed
edges the static graph misses; it exits 1 on a contradiction.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tepdist_tpu_torch.analysis.lockdep import (  # noqa: E402
    analyze,
    is_allowed,
    load_allowlist,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWLIST = os.path.join(ROOT, "tepdist_tpu_torch", "analysis",
                         "lockdep_allow.toml")


def confirm(static, observed):
    """(confirmed, contradicted, unseen) edge lists: observed edges the
    static graph has, observed edges whose inverse it has (and not the
    edge itself), and observed edges it lacks altogether."""
    static = set(static)
    confirmed = sorted(e for e in observed if e in static)
    contradicted = sorted(e for e in observed if e not in static
                          and (e[1], e[0]) in static)
    unseen = sorted(e for e in observed if e not in static
                    and (e[1], e[0]) not in static)
    return confirmed, contradicted, unseen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--allowlist", default=ALLOWLIST)
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on un-allowlisted findings "
                         "or stale allowlist entries")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--confirm", metavar="EDGES_JSON",
                    help="runtime edges to hold against the static graph")
    args = ap.parse_args()

    rep = analyze(args.root, package="tepdist_tpu_torch")
    allow = load_allowlist(args.allowlist)
    flagged = [f for f in rep.findings if not is_allowed(f, allow)]
    allowed = [f for f in rep.findings if is_allowed(f, allow)]
    stale = [e["key"] for e in allow
             if not any(fnmatch.fnmatchcase(f.key, e["key"])
                        for f in rep.findings)]
    edge_set = sorted(rep.static_edges())
    confirmed = contradicted = unseen = None
    if args.confirm:
        with open(args.confirm) as f:
            observed = {tuple(e) for e in json.load(f)}
        confirmed, contradicted, unseen = confirm(rep.static_edges(),
                                                  observed)

    if args.json:
        print(json.dumps({
            "files_scanned": rep.files_scanned,
            "locks": rep.locks,
            "edges": edge_set,
            "findings": [f.key for f in flagged],
            "allowed": [f.key for f in allowed],
            "stale_allowlist": stale,
            **({"confirmed": confirmed, "contradicted": contradicted,
                "unseen": unseen} if args.confirm else {}),
        }, indent=2))
    else:
        print(f"lockdep: scanned {rep.files_scanned} threading modules, "
              f"{len(rep.locks)} locks, {len(edge_set)} order edges")
        for a, b in edge_set:
            print(f"  order: {a} -> {b}")
        if allowed:
            print(f"{len(allowed)} allowlisted finding(s):")
            for f in allowed:
                print(f"  [allowed] {f.key}")
        if flagged:
            print(f"{len(flagged)} finding(s) NOT allowlisted:")
            for f in flagged:
                print(f"  [{f.kind}] {f.file}:{f.line} {f.func}: "
                      f"{f.message}")
                print(f"      key: {f.key}")
        else:
            print("no un-allowlisted findings")
        if stale:
            print(f"{len(stale)} STALE allowlist entr(ies) — the finding "
                  f"no longer exists; delete them:")
            for k in stale:
                print(f"  stale: {k}")
        if args.confirm:
            print(f"runtime edges: {len(confirmed)} confirmed, "
                  f"{len(contradicted)} contradicted, {len(unseen)} not "
                  f"in the static graph")
            for a, b in contradicted:
                print(f"  CONTRADICTED: observed {a} -> {b}, static "
                      f"graph has {b} -> {a}")
            for a, b in unseen:
                print(f"  unseen: {a} -> {b}")

    if contradicted:
        return 1
    if args.check:
        if flagged:
            return 1
        if stale:
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
