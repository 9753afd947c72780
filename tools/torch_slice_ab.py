#!/usr/bin/env python3
"""Times the port's GPT-2 1.5B training step in two trees, alternately.

Run on a machine with one NVIDIA H100, from the repository root:

    python3 tools/torch_slice_ab.py --tree parent=DIR --tree change=. \\
        [--order parent,change,change,parent] [--steps 8] \\
        [--recipe slice|pipeline]

Each entry of ``--order`` runs the named tree's ``tepdist_tpu_torch`` in a
fresh process, one after another, on chip_smoke.py's slice recipe (GPT-2
1.5B at full width and depth, flash attention, full remat, loss chunk 512,
batch 8 in 2 micro batches, seq 1024, ``adamw_bf16(1e-4)``): two warm-up
steps, then ``--steps`` timed steps, with the time Python's garbage collector
took during them. ``--recipe pipeline`` runs chip_smoke.py's pipeline
recipe instead: the same model at batch 48 x 1024 through
``plan_training(num_stages=4, num_micro_batches=8, devices=[cuda:0] *
4)``. A tree builds its own kernels on first use, before any timed step. In a tree whose flash forward is also the
``tepdist::flash_fwd`` custom op, the run also times the host cost of one
forward call through the op and through the wrapper directly, at a small
shape where the launch, not the kernel, sets the pace.

Prints the card's name and power limit, one JSON line per run, and last a
JSON summary: each tree's median step over all its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import dataclasses, gc, json, sys, time
import torch
from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.ops import flash_attention as fa
from tepdist_tpu_torch.optim import adamw_bf16
from tepdist_tpu_torch.train import plan_training

steps, recipe = int(sys.argv[1]), sys.argv[2]
torch.backends.cuda.matmul.allow_tf32 = False
cfg = dataclasses.replace(gpt2.CONFIGS["1.5B"], attn="flash", remat=True,
                          loss_chunk=512)
if recipe == "pipeline":
    params = gpt2.init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, 48, 1024, seed=0, device="cuda")
    plan = plan_training(lambda p, t: gpt2.loss_fn(p, t, cfg),
                         adamw_bf16(1e-4), params, tokens, num_stages=4,
                         num_micro_batches=8,
                         devices=[torch.device("cuda", 0)] * 4)
else:
    params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, 8, 1024, seed=0, device="cuda")
    plan = plan_training(lambda p, t: gpt2.loss_fn_stacked(p, t, cfg),
                         adamw_bf16(1e-4), params, tokens,
                         num_micro_batches=2)
for _ in range(2):
    plan.step(tokens)
# Time spent in Python's garbage collector during the timed steps.
gc_spans = []
gc.callbacks.append(lambda phase, info: gc_spans.append(
    (phase, info["generation"], time.perf_counter())))
seconds, losses = [], []
fa.reset_launch_counts()
for _ in range(steps):
    t0 = time.perf_counter()
    losses.append(plan.step(tokens))   # returns after a device sync
    seconds.append(time.perf_counter() - t0)
gc_s = sum(b[2] - a[2] for a, b in zip(gc_spans[::2], gc_spans[1::2]))
out = {"step_seconds": seconds, "losses": losses,
       "gc_seconds": gc_s, "gc_collections_by_generation": [
           sum(1 for p, g, _ in gc_spans if p == "start" and g == gen)
           for gen in range(3)],
       "launches_per_step": {k: v // steps
                             for k, v in fa.launch_counts.items()}}
if hasattr(fa, "FLASH_FWD_OP"):
    q, k, v = (torch.randn(1, 64, 64, device="cuda").bfloat16()
               for _ in range(3))

    def host_us(fn, *extra, n=2000):
        for _ in range(50):
            fn(q, k, v, True, 0.125, *extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(q, k, v, True, 0.125, *extra)
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    # A tree whose op carries the head count takes it after the scale.
    n_head = (1,) if len(fa.FLASH_FWD_OP._schema.arguments) > 5 else ()
    for _ in range(2):
        out["fwd_call_host_us"] = {
            "wrapper": host_us(fa.flash_fwd),
            "custom_op": host_us(fa.FLASH_FWD_OP, *n_head)}
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout holding tepdist_tpu_torch/")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--recipe", choices=("slice", "pipeline"),
                    default="slice")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    missing = [n for n in order if n not in trees]
    if missing:
        raise SystemExit(f"no --tree for {missing}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    medians = {}
    for i, name in enumerate(order):
        root = os.path.abspath(trees[name])
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.steps), args.recipe],
            cwd=root,
            env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{name} run {i} failed ({proc.returncode})")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(run=i, tree=name,
                   median_step_seconds=statistics.median(
                       rec["step_seconds"]))
        print(json.dumps(rec), flush=True)
        medians.setdefault(name, []).extend(rec["step_seconds"])
    print(json.dumps({"nvidia_smi": smi, "order": order,
                      "recipe": args.recipe,
                      "median_step_seconds": {
                          n: statistics.median(s)
                          for n, s in medians.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
