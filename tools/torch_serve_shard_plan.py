#!/usr/bin/env python3
"""The serving shard planner's host time by depth: the port's
``serving/fleet.plan_sharded_servable`` (the whole ``explore`` at
``n_devices=n_workers``, ``include_seq=False``, ``num_micro_batches=1``,
``pipeline_micro_options=(1,)``, ``entry_point="serve_shard"``: the
reference's arguments) for GPT-2 1.5B at full width (1600 wide, 25 heads,
vocab 50257, fp32, the serving phase's einsum attention) at each depth of
``--layers``, over ``--workers`` workers, on an example batch of 4 x 1024
(the loader's default) on the card.

    python3 tools/torch_serve_shard_plan.py [--layers 4,8,48] [--workers 2]

Each depth prints one JSON line (also appended to
``chiprun_out/torch_serve_shard_plan.jsonl``) after the card's name and
power limit: the planner's seconds, the explore phases' seconds, the
candidate count by kind, the chosen split, whether the fallback from a
non-executable global best fired, and the global best. The candidate
space is never narrowed. ``--device cpu --tiny`` rehearses it at a
64-wide size (a rehearsal, not a measurement).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "torch_serve_shard_plan.jsonl")


def emit(obj) -> None:
    line = json.dumps(obj, default=str)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def plan_at(n_layer: int, workers: int, device: str, tiny: bool) -> dict:
    import torch

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.serving.fleet import plan_sharded_servable
    from tepdist_tpu_torch.telemetry import metrics

    base = gpt2.CONFIGS["test" if tiny else "1.5B"]
    cfg = dataclasses.replace(base, n_layer=n_layer, dtype=torch.float32)
    params = gpt2.init_params(cfg, seed=0, device=device)
    before = metrics().counter("serve_shard_plan_fallback").value
    t0 = time.perf_counter()
    plan = plan_sharded_servable(cfg, params, workers)
    seconds = time.perf_counter() - t0
    kinds: dict = {}
    for c in plan["candidates"]:
        kinds[c["kind"]] = kinds.get(c["kind"], 0) + 1
    best = plan["candidates"][0]
    keep = ("kind", "num_stages", "num_micro_batches", "intra_tp",
            "placement", "comm_dtype", "zero")

    def row(c):
        out = {k: c.get(k) for k in keep if c.get(k) is not None}
        if "topology" in c:
            out["topology"] = str(c["topology"])
        out["predicted_step_seconds"] = c["cost"].total_duration
        return out

    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"tool": "torch_serve_shard_plan", "model": "GPT-2 1.5B"
            if not tiny else "GPT-2 test", "n_layer": n_layer,
            "n_embd": cfg.n_embd, "n_head": cfg.n_head,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "workers": workers, "example_batch": [4, cfg.n_ctx],
            "planner_seconds": seconds,
            "explore_phases": plan["explore_phases"],
            "candidates_by_kind": kinds,
            "chosen": {"num_stages": plan["num_stages"],
                       "intra_tp": plan["intra_tp"],
                       "placement": plan["placement"],
                       "rank": plan["candidates"].index(plan["chosen"])},
            "fallback": plan["fallback"],
            "fallback_counter": (metrics().counter(
                "serve_shard_plan_fallback").value - before),
            "global_best": row(best), "chosen_row": row(plan["chosen"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="4,8,48")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout else
              "nvidia-smi: no output", flush=True)
    for n in (int(x) for x in args.layers.split(",")):
        emit(plan_at(n, args.workers, args.device, args.tiny))
    return 0


if __name__ == "__main__":
    sys.exit(main())
