"""Llama-family auto-parallel training script: the port of
``examples/llama/train.py`` (model: ``tepdist_tpu_torch/models/llama.py``,
RMSNorm/SwiGLU/RoPE/GQA).

Plans over the process group's ranks like ``examples_torch/GPT2/main.py``.
``--attn flash`` runs the port's flash kernels (``tepdist::flash_fwd``,
``flash_dq``, ``flash_dkv``; their plain PyTorch versions on the CPU).

    python examples_torch/llama/train.py --config 1B --attn flash \\
        --batch 4 --seq 512 --steps 6
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse
import dataclasses
import time

import torch

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="test",
                        help="config name (test/1B/7B)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--attn", default="einsum",
                        choices=["einsum", "flash"])
    parser.add_argument("--mode", default="cost", choices=["cost", "rule"])
    parser.add_argument("--data", default="",
                        help="packed token file (default: random tokens)")
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def run(args, params=None, batch=None):
    """Train as the JAX example does; ``params`` and ``batch`` (the
    tokens) default to the port's seeded init and random tokens (seed 1).
    Returns the printed numbers."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
    from tepdist_tpu_torch.models import llama
    from tepdist_tpu_torch.optim import adamw
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.train import value_and_grad

    dev = common.device_of(args.device)
    cfg = dataclasses.replace(llama.CONFIGS[args.config], attn=args.attn)
    if params is None:
        params = llama.init_params(cfg, seed=0, device=dev)
    params = tree_map(lambda t: t.to(dev), params)
    n = sum(x.numel() for x in tree_leaves(params))
    common.rank0_print(f"llama {args.config}: {n/1e6:.0f}M params, "
                       f"attn={cfg.attn}")

    batches = None
    if args.data:
        from tepdist_tpu_torch.data import TokenDataset

        ds = TokenDataset(args.data)
        batches = (torch.from_numpy(b).to(dev) for b in
                   ds.batches(args.batch, args.seq, seed=0))
        tokens = next(batches)
    elif batch is None:
        tokens = llama.fake_batch(cfg, args.batch, args.seq, seed=1,
                                  device=dev)
    else:
        tokens = batch.to(dev)

    tx = adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)
    opt_state = tx.init(params)
    grad_fn = value_and_grad(lambda p, t: llama.loss_fn(p, t, cfg))

    def train_step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens)
        return loss, params, tx.apply(params, grads, opt_state)

    with common.world(dev) as n_ranks:
        topo = MeshTopology([("data", n_ranks)])
        n_state = len(tree_leaves((params, opt_state)))
        t0 = time.perf_counter()
        plan = auto_parallel(train_step, topo, params, opt_state, tokens,
                             mode=args.mode,
                             state_alias={1 + k: k for k in range(n_state)})
        plan.executable(dev.type)
        planned = time.perf_counter() - t0
        common.rank0_print(f"planned in {planned:.2f}s over {topo}")

        def line(i, loss, dt):
            return (f"step {i}: loss={loss:.4f} ({dt*1e3:.1f} ms, "
                    f"{args.batch*args.seq/dt:.0f} tok/s)")

        res = common.run_lowered(plan, (params, opt_state), [tokens],
                                 args.steps, dev, line, batches=batches)
    return {"config": args.config, "attn": cfg.attn, "n_params": n,
            "topology": str(topo), "planned_s": planned, **res}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
