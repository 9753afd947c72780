"""Smoke test: a single attention block through the auto-parallel planner
(the port of ``examples/smoke_testing/attention.py``)."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse

import torch

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def run(args, params=None, batch=None):
    """Five SGD(0.1) steps on the planned gradient; ``params`` and
    ``batch`` default to the port's seeded init and x [8, 32, 64] normal (seed 0), y = 0. Returns the losses."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_map
    from tepdist_tpu_torch.models import mlp
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.train import value_and_grad

    dev = common.device_of(args.device)
    if params is None:
        params = mlp.init_attention(seed=0, d=64, heads=4, device=dev)
    if batch is None:
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((8, 32, 64), generator=gen).to(dev)
        batch = (x, torch.zeros_like(x))
    params = tree_map(lambda t: t.to(dev), params)
    x, y = (t.to(dev) for t in batch)
    losses = []
    with common.world(dev) as n:
        plan = auto_parallel(value_and_grad(mlp.attention_loss),
                             MeshTopology([("data", n)]), params, x, y)
        for i in range(5):
            loss, grads = plan.step(params, x, y)
            params = tree_map(lambda p, g: p - 0.1 * g.full_tensor(),
                              params, grads)
            losses.append(float(loss.full_tensor()))
            common.rank0_print(f"step {i}: loss = {losses[-1]:.6f}")
    return {"losses": losses}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
