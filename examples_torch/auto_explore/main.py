"""Fully automatic planning: no topology, the SERVICE decides. The port of
``examples/auto_explore/main.py``.

The defining TePDist behavior (reference: exploration mode inside
BuildExecutionPlan, service/parallel/auto_parallel.cc:236 invoked from
service_rt.cc:218-308): the client ships a loss and an optimizer spec
with NO mesh axes; the server enumerates SPMD meshes, sequence-parallel
meshes and pipeline stage cuts for its devices, prices them with the
Evaluator, builds the winner and returns the ranked candidate table.

The spawned server is ``python -m tepdist_tpu_torch.rpc.server`` on
``--device`` (the card unless ``--device cpu``): one device, so the
candidates are those of one device. ``--regime pipeline`` sets the cost
model's knobs of a DCN-bound, memory-tight cluster (``HBM_GB``,
``ICI_BANDWIDTH``, ``COMM_OVERLAP``) in the server's environment.

    python examples_torch/auto_explore/main.py --steps 5
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse
import signal

import torch

from examples_torch import common
from examples_torch.smoke_testing.simple import spawn_local_server

DEPTH, WIDTH, BATCH = 8, 512, 16
# The server's cost-model knobs by regime: 'pipeline' emulates a
# DCN-bound, memory-tight cluster.
REGIME_ENV = {"auto": {},
              "pipeline": {"HBM_GB": "0.01", "ICI_BANDWIDTH": "0.05",
                           "COMM_OVERLAP": "0.0"}}


def parse_args(argv=None):
    parser = argparse.ArgumentParser("auto_explore")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--regime", choices=["auto", "pipeline"],
                        default="auto",
                        help="'pipeline' sets cost-model knobs emulating a "
                             "DCN-bound memory-tight cluster so the stage "
                             "cut wins the exploration")
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def loss_fn(params, x, y):
    h = x
    for i in range(DEPTH):
        h = torch.relu(h @ params[f"w{i}"])
    return ((h - y) ** 2).mean()


def run(args, params=None, batch=None, address=None):
    """Explore on the server and train; ``params`` (``w0``..``w7``) and
    ``batch`` ((x, y)) default to seeded normal draws. ``address`` names a
    server the caller started (an ``inproc:`` servicer over a device
    list, say, whose environment the caller set for ``--regime``); by
    default a local server is spawned. Returns the summary, the
    candidates and the losses."""
    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.optim import optimizer_spec, sgd
    from tepdist_tpu_torch.rpc.client import TepdistClient

    proc = None
    if address is None:
        proc, port = spawn_local_server(args.device, REGIME_ENV[args.regime])
        address = f"127.0.0.1:{port}"
    if params is None:
        gen = torch.Generator().manual_seed(0)
        scale = (2.0 / WIDTH) ** 0.5
        params = {f"w{i}": torch.randn((WIDTH, WIDTH), generator=gen) * scale
                  for i in range(DEPTH)}
        batch = (torch.randn((BATCH, WIDTH), generator=gen),
                 torch.randn((BATCH, WIDTH), generator=gen))
    x, y = batch
    losses = []
    try:
        c = TepdistClient(address)
        c.wait_ready(60)
        c.close()
        sess = TepdistSession(address)   # NO mesh_axes
        summary = sess.compile_training(
            loss_fn, sgd(0.01), params, x, y,
            num_micro_batches=4,
            optimizer_spec=optimizer_spec("sgd", learning_rate=0.01))
        explored = summary.get("explored", {})
        print(f"winner: {explored.get('winner')}  "
              f"(plan kind: {summary.get('kind', 'spmd')}, "
              f"axes: {summary.get('axes')})", flush=True)
        print(f"{'kind':>9} {'config':<28} {'duration_s':>12} "
              f"{'mem_ok':>6}")
        for cand in explored.get("candidates", [])[:10]:
            mark = " <== winner" if cand["winner"] else ""
            print(f"{cand['kind']:>9} {cand['config']:<28} "
                  f"{cand['duration_s']:>12.4e} "
                  f"{str(cand['memory_feasible']):>6}{mark}")
        for i in range(args.steps):
            losses.append(sess.run(x, y))
            print(f"step {i}: loss = {losses[-1]:.6f}", flush=True)
        sess.close()
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
    return {"winner": explored.get("winner"),
            "kind": summary.get("kind", "spmd"), "axes": summary.get("axes"),
            "candidates": explored.get("candidates", []), "losses": losses}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
