"""Launch the port's servers from a cluster config: the port of
``examples/launch_workers.py`` (reference: launch_worker.sh, jq over
config_*worker_template.json, CLUSTER_SPEC set, grpc_service_gpu started
per worker). Launches the local worker(s) of the config matching
``--task_index``, or every localhost worker.

Each worker is ``python -m tepdist_tpu_torch.rpc.server --port P
--task_index K --device D`` with ``CLUSTER_SPEC`` set to the config.
A port server owns one device, so a worker's ``device_ids`` map onto
``--device``: with ``--device cuda`` (the default) the worker takes card
``device_ids[0]`` (``cuda:<i>``), so the two workers of one host in a
config name different cards; with ``--device cpu`` every worker serves on
the CPU and ``device_ids`` name no device.

    python examples_torch/launch_workers.py \\
        --config examples_torch/config_1worker_template.json --device cpu
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..")))

import argparse
import json
import os
import subprocess
import sys

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--task_index", type=int, default=-1,
                        help="-1 = every localhost worker")
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def worker_device(device: str, worker: dict) -> str:
    """The ``--device`` of one worker (see the module docstring)."""
    if device != "cuda":
        return device
    ids = worker.get("device_ids") or [0]
    return f"cuda:{ids[0]}"


def launch(args):
    """Start the workers; returns their ``Popen`` objects."""
    with open(args.config) as f:
        spec = json.load(f)
    procs = []
    for w in spec["workers"]:
        if args.task_index >= 0 and w.get("task_index") != args.task_index:
            continue
        if args.task_index < 0 and w["ip"] not in ("127.0.0.1", "localhost"):
            continue
        env = dict(os.environ)
        env["CLUSTER_SPEC"] = json.dumps(spec)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tepdist_tpu_torch.rpc.server",
             "--port", str(w["port"]),
             "--task_index", str(w.get("task_index", 0)),
             "--device", worker_device(args.device, w)],
            env=env, cwd=common.ROOT))
        print(f"launched worker task_index={w.get('task_index')} "
              f"port={w['port']} pid={procs[-1].pid}", flush=True)
    return procs


def run(args, params=None, batch=None):
    """Launch and wait for the workers; returns their exit codes."""
    procs = launch(args)
    return [p.wait() for p in procs]


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
