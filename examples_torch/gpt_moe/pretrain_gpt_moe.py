"""GPT-MoE expert-parallel training: the port of
``examples/gpt_moe/pretrain_gpt_moe.py``: top-2 gated GShard-style MoE
whose dispatch and combine einsums become all-to-alls when the expert
dim is split over the ``expert`` mesh axis. The mesh is ``data x expert``
over the process group's ranks (``examples_torch/common.py``), the expert
weights pinned to the expert axis."""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="base-8e")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--expert_parallel", type=int, default=0,
                        help="devices on the expert axis (0 = all)")
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def run(args, params=None, batch=None):
    """Train as the JAX example does; ``params`` and ``batch`` (the
    tokens) default to the port's seeded init and fake batch. Returns the
    printed numbers."""
    from tepdist_tpu_torch.core.dist_spec import DimStrategy
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
    from tepdist_tpu_torch.models import gpt2, gpt_moe
    from tepdist_tpu_torch.optim import adamw
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.train import value_and_grad

    dev = common.device_of(args.device)
    cfg = gpt_moe.CONFIGS[args.config]
    if params is None:
        params = gpt_moe.init_params(cfg, seed=0, device=dev)
    params = tree_map(lambda t: t.to(dev), params)
    tokens = (gpt2.fake_batch(cfg.base, args.batch, args.seq, device=dev)
              if batch is None else batch.to(dev))
    tx = adamw(1e-4)
    opt_state = tx.init(params)
    grad_fn = value_and_grad(lambda p, t: gpt_moe.loss_fn(p, t, cfg))

    def train_step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens)
        return loss, params, tx.apply(params, grads, opt_state)

    with common.world(dev) as n:
        ep = args.expert_parallel or min(n, cfg.num_experts)
        dp = n // ep
        topo = MeshTopology([("data", dp), ("expert", ep)])
        # Annotate expert weights onto the expert axis (planner pins).
        annotations = {}
        for i, leaf in enumerate(tree_leaves(params)):
            if leaf.dim() == 3 and leaf.shape[0] == cfg.num_experts:
                annotations[i] = {"expert": DimStrategy.split_on(0, ep)}
        n_state = len(tree_leaves((params, opt_state)))
        plan = auto_parallel(train_step, topo, params, opt_state, tokens,
                             annotations=annotations,
                             state_alias={1 + k: k for k in range(n_state)})
        common.rank0_print(f"planned over {topo}; {len(annotations)} "
                           "expert weights pinned")

        def line(i, loss, dt):
            return f"step {i}: loss={loss:.4f} ({dt:.3f}s)"

        res = common.run_lowered(plan, (params, opt_state), [tokens],
                                 args.steps, dev, line)
    return {"topology": str(topo), "pinned": len(annotations), **res}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
