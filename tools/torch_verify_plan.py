#!/usr/bin/env python
"""Plan-verifier CLI of the port (``tepdist_tpu_torch/analysis/
plan_verify.py``): the counterpart of ``tools/verify_plan.py``, with its
flags and output.

    python tools/torch_verify_plan.py --device cpu          # the fixture
    python tools/torch_verify_plan.py --device cpu --check  # gate
    python tools/torch_verify_plan.py --stages 4 --micro 4 --devices 8

Builds the standard MLP pipeline fixture (the shape the fidelity report
and the tests use: 2 tanh layers a stage, 16 wide, 8 rows a micro
batch), plans it, builds the task DAG, schedules it, runs every static
check and prints the report. With ``--check`` it also plants one
corruption (an orphaned SEND) and fails unless the verifier rejects it:
a self-test that the gate gates. The fixture's tensors lie on
``--device`` (the card unless ``--device cpu``); the capture reads their
shapes only. ``report(prog, dag, schedule)`` verifies a pipeline built
elsewhere (``chip_smoke.py`` passes its own). ``main(argv)`` returns the
report beside what it printed (``tools/torch_cli.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_fixture(stages: int, micro: int, devices: int,
                  device: str = "cuda"):
    """Plan the MLP fixture: (prog, dag, schedule)."""
    import numpy as np
    import torch

    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.runtime.execution_plan import (
        build_pipeline_task_dag)
    from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler

    def loss_fn(params, x, y):
        h = x
        for w in params:
            h = torch.tanh(h @ w)
        return ((h - y) ** 2).mean()

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n_layer, width, batch = 2 * stages, 16, 8 * micro
    params = [torch.tensor(rng.standard_normal((width, width)) * 0.1,
                           dtype=torch.float32, device=dev)
              for _ in range(n_layer)]
    x = torch.tensor(rng.standard_normal((batch, width)),
                     dtype=torch.float32, device=dev)
    y = torch.tensor(rng.standard_normal((batch, width)),
                     dtype=torch.float32, device=dev)
    prog = plan_pipeline(loss_fn, stages, micro, params, x, y)
    per = max(1, devices // stages)
    stage_devices = [tuple(range(s * per, (s + 1) * per))
                     for s in range(stages)]
    dag, _maps = build_pipeline_task_dag(prog, stage_devices)
    schedule = TaskScheduler(dag, device_type=dev.type).schedule()
    return prog, dag, schedule


def report(prog, dag, schedule, where: str = "tools/torch_verify_plan.py"):
    """Verify one pipeline and print the report: the report, or None
    (with a FAIL line) when the verifier rejects the plan."""
    from tepdist_tpu_torch.analysis.plan_verify import (
        PlanVerificationError, verify_plan)

    try:
        rep = verify_plan(dag, schedule=schedule, prog=prog, where=where)
    except PlanVerificationError as e:
        print(f"FAIL: fixture plan rejected: {e}")
        return None
    print(rep.summary())
    for dev in sorted(rep.peak_bytes):
        print(f"  dev {dev}: peak {rep.peak_bytes[dev] / 1e6:.2f} MB "
              f"(limit {rep.hbm_limit_bytes / 1e9:.1f} GB)")
    return rep


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "report", "planted"}``: ``planted`` is the
    verifier's error on the planted SEND under ``--check``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the fixture's device (cuda or cpu)")
    ap.add_argument("--check", action="store_true",
                    help="also verify a planted corruption is rejected; "
                         "exit non-zero on any failure")
    args = ap.parse_args(argv)

    from tepdist_tpu_torch.analysis.plan_verify import (
        PlanVerificationError, verify_plan)

    prog, dag, schedule = build_fixture(args.stages, args.micro,
                                        args.devices, args.device)
    rep = report(prog, dag, schedule)
    if rep is None:
        return 1, {"report": None}
    out = {"report": rep}
    if args.check:
        # Self-test: plant an orphaned SEND and require rejection.
        _p2, dag2, sched2 = build_fixture(args.stages, args.micro,
                                          args.devices, args.device)
        from tepdist_tpu_torch.runtime.task_graph import TaskType
        send = next(n for n in dag2.nodes
                    if n.task_type == TaskType.SEND)
        recv = dag2.nodes[send.children[0]]
        send.children.remove(recv.id)
        recv.parents.remove(send.id)
        recv.input_specs.pop(0, None)
        try:
            verify_plan(dag2, order=sched2.order)
        except PlanVerificationError as e:
            out["planted"] = e
            if e.kind != "orphan_send" or send.id not in e.tasks:
                print(f"FAIL: planted orphan SEND misdiagnosed: {e}")
                return 1, out
            print(f"check: planted corruption rejected as expected "
                  f"({e})")
            return 0, out
        print("FAIL: planted orphan SEND was NOT rejected")
        return 1, out
    return 0, out


if __name__ == "__main__":
    sys.exit(main()["rc"])
