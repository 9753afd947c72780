#!/usr/bin/env python3
"""Witness that the third-step loss rise of the GPT-2 1.5B recipe comes
from ``adamw_bf16(1e-4)`` with no warmup, and not from the port.

From random weights, the recipe of ``bench.py`` (``attn="flash"``,
``remat=True``, ``loss_chunk=512``, ``adamw_bf16(1e-4)``, two micro
batches) lowers the loss on the second step and raises it on the third,
once the model is deep enough: Adam moves every weight by about lr on its
first steps, and across many layers those moves add up past the minimum.
This script runs the JAX package's ``plan_training`` and the port's on
the same weights and tokens, on the CPU, at GPT-2 1.5B's width (n_embd
1600, 25 heads, vocab 50257) with the depth, batch and sequence cut so a
CPU can run it, and prints both loss trajectories, at lr 1e-4 and at a
tenth of it, as one JSON line each:

    JAX_PLATFORMS=cpu python3 loss_rise_witness.py            # 24 layers
    JAX_PLATFORMS=cpu python3 loss_rise_witness.py --layers 12

It exits non-zero if any step moves the two runs' losses in opposite
directions (one rises where the other falls). It needs jax and torch (CPU
builds are enough), about 15 GB of memory and about 5 minutes at the
default size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def trajectories(layers: int, batch: int, seq: int, steps: int, lr: float):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu.optim import adamw_bf16 as jax_adamw_bf16
    from tepdist_tpu.train import plan_training as jax_plan_training
    from tepdist_tpu_torch import convert
    from tepdist_tpu_torch.models import gpt2 as tgpt2
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.train import plan_training

    recipe = dict(n_layer=layers, attn="flash", remat=True, loss_chunk=512)
    cfg_j = dataclasses.replace(jgpt2.CONFIGS["1.5B"], **recipe)
    cfg_t = dataclasses.replace(tgpt2.CONFIGS["1.5B"], **recipe)
    params = jgpt2.stacked_init_params(cfg_j, jax.random.PRNGKey(0))
    toks = jgpt2.fake_batch(cfg_j, batch, seq, seed=0)
    tparams = convert.to_torch(jax.device_get(params), device="cpu")
    ttoks = torch.tensor(np.asarray(toks))

    t0 = time.perf_counter()
    jplan = jax_plan_training(
        lambda p, t: jgpt2.loss_fn_stacked(p, t, cfg_j),
        jax_adamw_bf16(lr), params, toks, num_micro_batches=2,
        devices=jax.devices()[:1])
    jax_losses = [jplan.step(toks) for _ in range(steps)]
    jax_s = time.perf_counter() - t0
    del jplan, params
    t0 = time.perf_counter()
    tplan = plan_training(
        lambda p, t: tgpt2.loss_fn_stacked(p, t, cfg_t), adamw_bf16(lr),
        tparams, ttoks, num_micro_batches=2, device="cpu")
    port_losses = [tplan.step(ttoks) for _ in range(steps)]
    port_s = time.perf_counter() - t0
    return {"layers": layers, "n_embd": cfg_t.n_embd, "batch": batch,
            "seq": seq, "lr": lr, "dtype": str(jnp.dtype(cfg_j.dtype)),
            "jax_losses": [float(x) for x in jax_losses],
            "port_losses": port_losses, "jax_seconds": jax_s,
            "port_seconds": port_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    ok = True
    for lr in (1e-4, 1e-5):
        rec = trajectories(args.layers, args.batch, args.seq, args.steps, lr)
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(rec["port_losses"], rec["jax_losses"]))
        rec["max_rel_gap"] = gap
        rec["rises"] = {side: [b > a for a, b in zip(ls, ls[1:])]
                        for side, ls in (("jax", rec["jax_losses"]),
                                         ("port", rec["port_losses"]))}
        print(json.dumps(rec), flush=True)
        ok = ok and rec["rises"]["jax"] == rec["rises"]["port"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
