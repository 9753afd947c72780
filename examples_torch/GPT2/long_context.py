"""Long-context GPT-2 training with sequence parallelism: the port of
``examples/GPT2/long_context.py``.

The sequence axis is split over the ring's devices; attention runs as
ring attention (K/V blocks passed around the ring, online-softmax merge)
or Ulysses (head <-> sequence all-to-alls), each with the JAX example's
inner attention (einsum blocks for the ring, dense for Ulysses). The ring
is the one-process device-list form of ``ops/seq_comm.py``: every visible
card (the reference's ``Mesh(jax.devices(), ("seq",))``), the CPU once
with ``--device cpu``, or the list a caller passes to :func:`run`.
Ulysses needs the heads to divide over the ring: the ring is trimmed to
the largest size that divides them.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse
import time

import torch

from examples_torch import common


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="test")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--impl", choices=["ring", "ulysses"],
                        default="ring")
    common.add_device_arg(parser)
    return parser.parse_args(argv)


def run(args, params=None, batch=None, devices=None):
    """Train as the JAX example does; ``params`` and ``batch`` default to
    the port's seeded init and fake batch, ``devices`` (the ring) to every
    visible device. Returns the printed numbers."""
    from tepdist_tpu_torch.core.tree import tree_map
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops.ring_attention import ring_attention
    from tepdist_tpu_torch.ops.ulysses import ulysses_attention
    from tepdist_tpu_torch.optim import adamw
    from tepdist_tpu_torch.train import value_and_grad

    dev = common.device_of(args.device)
    cfg = gpt2.CONFIGS[args.config]
    if devices is None:
        devices = (common.stage_devices(dev, torch.cuda.device_count())
                   if dev.type == "cuda" else [dev])
    devices = list(devices)
    if args.impl == "ulysses":
        # Ulysses needs heads % ring == 0: use the largest valid divisor.
        n = len(devices)
        while cfg.n_head % n:
            n -= 1
        devices = devices[:n]
    print(f"sequence mesh: {len(devices)} devices, seq len {args.seq}",
          flush=True)

    if args.impl == "ring":
        def attn_impl(q, k, v):
            return ring_attention(q, k, v, devices, causal=True)
    else:
        def attn_impl(q, k, v):
            return ulysses_attention(q, k, v, devices, causal=True)

    if params is None:
        params = gpt2.init_params(cfg, seed=0, device=dev)
    params = tree_map(lambda t: t.to(dev), params)
    seq = min(args.seq, cfg.n_ctx)
    tokens = (gpt2.fake_batch(cfg, args.batch, seq, device=dev)
              if batch is None else batch.to(dev))
    tx = adamw(1e-4)
    opt = tx.init(params)
    grad_fn = value_and_grad(
        lambda p, t: gpt2.loss_fn(p, t, cfg, attn_impl=attn_impl))

    def step():
        nonlocal opt
        loss, grads = grad_fn(params, tokens)
        opt = tx.apply(params, grads, opt)
        return float(loss)

    first = step()
    print(f"compile + step 0: loss={first:.4f}", flush=True)
    losses, seconds = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        losses.append(step())
        seconds.append(time.perf_counter() - t0)
        print(f"step {i+1}: loss={losses[-1]:.4f} ({seconds[-1]:.3f}s)",
              flush=True)
    return {"seq_mesh": len(devices), "first_loss": first,
            "losses": losses, "step_seconds": seconds}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
