"""Smoke test: a 1-hidden-layer MLP trained through the client/server path.

The port of ``examples/smoke_testing/simple.py`` (a loss printed each
step; the client needs no card, the server owns the devices). ``--local``
spawns ``python -m tepdist_tpu_torch.rpc.server`` on this machine (gRPC,
on ``--device``). Without it the script reaches a running server at
``SERVER_IP:SERVER_PORT`` (default ``127.0.0.1:2222``), as the reference's
client does. ``SERVER_IP=inproc`` names an in-process servicer that the
caller registered at ``inproc:SERVER_PORT`` (``rpc/inproc.py``): the
route on a card whose machine has no ``grpcio``.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse
import os
import signal
import subprocess
import sys

import torch

from examples_torch import common


def spawn_local_server(device: str, extra_env=None) -> tuple:
    """(process, port) of a port server on ``device`` at a free port."""
    port = common.free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tepdist_tpu_torch.rpc.server",
         "--port", str(port), "--device", device],
        env=dict(os.environ, **(extra_env or {})), cwd=common.ROOT)
    return proc, port


def server_address() -> str:
    return (f"{os.environ.get('SERVER_IP', '127.0.0.1')}:"
            f"{os.environ.get('SERVER_PORT', '2222')}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--local", action="store_true",
                        help="spawn a local server")
    parser.add_argument("--steps", type=int, default=10)
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def run(args, params=None, batch=None):
    """Train through the service; ``params`` (``w0``, ``w1``) and
    ``batch`` ((x, y)) default to the port's seeded init, a seeded normal
    x [256, 32] and y = 1. Returns the plan summary and the losses."""
    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.models import mlp
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.train import value_and_grad

    proc = None
    if args.local:
        proc, port = spawn_local_server(args.device)
        address = f"127.0.0.1:{port}"
    else:
        address = server_address()
    try:
        if params is None:
            params = mlp.init_mlp(seed=0, din=32, dh=64, dout=8,
                                  device="cpu")
        if batch is None:
            gen = torch.Generator().manual_seed(0)
            batch = (torch.randn((256, 32), generator=gen),
                     torch.ones((256, 8)))
        x, y = batch
        tx = sgd(0.1)
        grad_fn = value_and_grad(mlp.mlp_loss)

        def step(params, opt_state, x, y):
            loss, grads = grad_fn(params, x, y)
            return loss, params, tx.apply(params, grads, opt_state)

        sess = TepdistSession(address)
        sess.client.wait_ready(timeout=120)
        info = sess.client.ping()
        print(f"server: {info['n_devices']} {info['platform']} devices",
              flush=True)
        summary = sess.compile_train_step(step, params, tx.init(params),
                                          x, y)
        print(f"plan: {summary}", flush=True)
        losses = []
        for i in range(args.steps):
            losses.append(sess.run(x, y))
            print(f"step {i}: loss = {losses[-1]:.6f}", flush=True)
        sess.close()
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
    return {"server": info, "summary": summary, "losses": losses}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
