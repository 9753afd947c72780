"""GPT-2 auto-parallel training script: the port of ``examples/GPT2/main.py``.

The {117M,345M,1.5B,175B}.json configs and the fake-input mode (the
reference's FAKE_INPUT) as in the JAX example. Three paths:

- the auto plan (default): ``auto_parallel`` of the whole training step
  over ``MeshTopology([("data", n)])``, ``n`` the ranks of the process
  group (``examples_torch/common.py``: one rank unless a launcher such as
  ``torchrun`` made more), lowered to DTensor and run by
  ``plan.executable()``;
- ``--num_stages S``: ``plan_pipeline`` and the 1F1B
  ``PipelineExecutable``, one stage a device (a card may hold several);
- ``--num_stages S --pipeline collective``: the collective pipeline
  (``ops/collective_pipeline.py``) over S stage devices, the device form
  (a card may repeat, as the port's device form allows).

The config's defaults are the JAX package's: einsum attention, bf16, no
remat, so this script launches no flash kernel. ``--data`` reads a packed
token file (``tepdist_tpu_torch.data.pack_token_file``).

    python examples_torch/GPT2/main.py --config examples_torch/GPT2/1.5B.json
    python examples_torch/GPT2/main.py --config test --batch 8 --seq 32 \\
        --steps 2 --num_stages 2 --num_micro_batches 2 --device cpu
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse
import json
import os
import time

import torch

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="117M",
                        help="config name or path to json")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=512)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--num_stages", type=int, default=0)
    parser.add_argument("--pipeline", choices=["taskgraph", "collective"],
                        default="taskgraph",
                        help="taskgraph: 1F1B multi-program runtime; "
                             "collective: one program over the stages")
    parser.add_argument("--num_micro_batches", type=int, default=1)
    parser.add_argument("--mode", default="cost", choices=["cost", "rule"])
    parser.add_argument("--data", default="",
                        help="path to a packed token file "
                             "(tepdist_tpu_torch.data.pack_token_file); "
                             "default is fake input")
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def load_config(name: str):
    from tepdist_tpu_torch.models import gpt2

    if os.path.exists(name):
        with open(name) as f:
            raw = json.load(f)
        return gpt2.GPT2Config(
            vocab_size=raw.get("n_vocab", 50257),
            n_ctx=raw.get("n_ctx", 1024),
            n_embd=raw["n_embd"],
            n_layer=raw["n_layer"],
            n_head=raw["n_head"],
        )
    return gpt2.CONFIGS[name]


def run(args, params=None, batch=None):
    """Train as the JAX example does; ``params`` (the model's tree) and
    ``batch`` (the first tokens) default to the port's seeded init and
    fake batch. Returns the printed numbers."""
    from tepdist_tpu_torch.core.tree import tree_map
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw
    from tepdist_tpu_torch.train import value_and_grad

    dev = common.device_of(args.device)
    cfg = load_config(args.config)
    common.rank0_print(f"GPT-2 {args.config}: "
                       f"~{gpt2.num_params(cfg)/1e6:.0f}M params")
    if params is None:
        params = gpt2.init_params(cfg, seed=0, device=dev)
    params = tree_map(lambda t: t.to(dev), params)
    batches = None
    if args.data:
        from tepdist_tpu_torch.data import TokenDataset

        dataset = TokenDataset(args.data)
        batches = (torch.from_numpy(b) for b in
                   dataset.batches(args.batch, args.seq, seed=0))
        tokens = next(batches)
        common.rank0_print(f"dataset: {len(dataset):,} tokens from "
                           f"{args.data}")
    elif batch is None:
        tokens = gpt2.fake_batch(cfg, args.batch, args.seq, device=dev)
    else:
        tokens = batch
    tokens = tokens.to(dev)
    tx = adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)
    out = {"config": args.config, "n_layer": cfg.n_layer}

    if args.num_stages > 1 and args.pipeline == "collective":
        S = args.num_stages
        devices = common.stage_devices(dev, S)
        embed, stacked = gpt2.shard_stacked_for_stages(params, cfg, devices)
        state = (embed, stacked)
        opt = tx.init(state)
        M = args.num_micro_batches if args.num_micro_batches > 0 else 2
        if args.batch % M:
            raise SystemExit(f"--batch {args.batch} not divisible by "
                             f"--num_micro_batches {M}")
        grad_fn = value_and_grad(lambda st, t: gpt2.pipelined_loss_fn(
            st[0], st[1], t, cfg, devices, M))

        def cstep(tokens):
            nonlocal opt
            loss, grads = grad_fn(state, tokens)
            opt = tx.apply(state, grads, opt)
            return float(loss)

        first = cstep(tokens)
        common.rank0_print(f"collective pipeline: S={S} M={M} "
                           f"compile+step0 loss={first:.4f}")
        losses, seconds = [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            if batches is not None:
                tokens = next(batches).to(dev)
            loss = cstep(tokens)
            dt = time.perf_counter() - t0
            losses.append(loss)
            seconds.append(dt)
            common.rank0_print(f"step {i}: loss={loss:.4f} "
                               f"({dt*1e3:.1f} ms)")
        out.update(num_stages=S, micro_batches=M, first_loss=first,
                   losses=losses, step_seconds=seconds)
        return out

    if args.num_stages > 1:
        from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
        from tepdist_tpu_torch.runtime.executor import PipelineExecutable

        prog = plan_pipeline(
            lambda p, t: gpt2.loss_fn(p, t, cfg),
            args.num_stages, max(args.num_micro_batches, 2), params, tokens)
        exe = PipelineExecutable(
            prog, devices=common.stage_devices(dev, args.num_stages),
            optimizer=tx)
        exe.load_variables(params)
        flops = prog.stage_flops()
        common.rank0_print(f"pipeline: stages={args.num_stages} "
                           f"flops={['%.2e' % f for f in flops]}")
        losses, seconds = [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            if batches is not None:
                tokens = next(batches).to(dev)
            loss = float(exe.step(tokens))
            dt = time.perf_counter() - t0
            losses.append(loss)
            seconds.append(dt)
            common.rank0_print(f"step {i}: loss={loss:.4f} "
                               f"({dt*1e3:.1f} ms)")
        out.update(num_stages=args.num_stages, stage_flops=flops,
                   losses=losses, step_seconds=seconds)
        return out

    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel

    opt_state = tx.init(params)
    grad_fn = value_and_grad(lambda p, t: gpt2.loss_fn(p, t, cfg))

    def train_step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens)
        return loss, params, tx.apply(params, grads, opt_state)

    with common.world(dev) as n:
        topo = MeshTopology([("data", n)])
        n_state = len(tree_leaves((params, opt_state)))
        t0 = time.perf_counter()
        plan = auto_parallel(train_step, topo, params, opt_state, tokens,
                             mode=args.mode,
                             state_alias={1 + k: k for k in range(n_state)})
        plan.executable(dev.type)
        planned = time.perf_counter() - t0
        common.rank0_print(f"planned in {planned:.2f}s over {topo}")
        prefetch = None
        if batches is not None:
            from tepdist_tpu_torch.data import DevicePrefetcher

            prefetch = DevicePrefetcher(batches, device=dev)

        def line(i, loss, dt):
            return (f"step {i}: loss={loss:.4f} ({dt*1e3:.1f} ms, "
                    f"{args.batch * args.seq / dt:.0f} tok/s)")

        res = common.run_lowered(plan, (params, opt_state), [tokens],
                                 args.steps, dev, line, batches=prefetch)
    out.update(topology=str(topo), planned_s=planned, **res)
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
