#!/usr/bin/env python3
"""Pipeline stages over several cards: the port's ``PipelineExecutable`` in
its process-group form, one process a card.

    python3 tools/torch_pipeline_dist.py [--ranks 4] [--layers 48]
                                         [--tp-layers 8] [--steps 4]
                                         [--cases dp,dp_zero,s4]

Every rank (NCCL over ``tcp://127.0.0.1``, a free port) builds the same
GPT-2 1.5B (full width, ``--layers`` deep; ``chip_smoke.py``'s recipe:
flash, full remat, ``loss_chunk=512``, ``adamw_bf16(1e-4)``, seed 0,
batch 48 x 1024, M = 8) and trains ``--steps`` steps through
``plan_training(num_stages=S, devices=[its card] * 4, ...)`` in each case:

- ``dp``: 2 stages x 2 intra-stage data replicas;
- ``dp_zero``: the same with ZeRO (``PipelineWinner(zero=True).build``);
- ``s4``: 4 stages, one card each (blocked);
- ``tp`` (named only): 2 stages x ``intra_stage_tp=2`` at
  ``--tp-layers`` deep, in fp32 against an fp32 reference at
  ``TP_LOSS_RTOL`` (each stage a DTensor program on its ``model``
  sub-mesh; its planner's ILP on a 24-layer stage would take the call's
  time). It failed across NCCL cards until the GPT-2 token lookup became
  ``F.embedding`` (ROADMAP C8, resolved).

A rank that raises prints its traceback and leaves at once: over NCCL its
peers would wait for it, and so would ``destroy_process_group``, which
hid the cause of a failure as a hang.

Each rank's losses (and their largest relative difference) are held to
a one-card reference of the same recipe and depth, run first by the
parent process on card 0 with no process group (``chip_smoke.py``'s
``pipeline`` phase: 4 stages over ``[cuda:0] * 4``), at
``PIPELINE_LOSS_RTOL``. For each case rank 0 prints
one JSON line as it finishes (also appended to
``chiprun_out/torch_pipeline_dist.jsonl``): the losses, the predicted
makespan and bubble for the 4 cards (``h100`` entry) beside the measured
step seconds, the peak memory of every rank, and, for ``s4``, each stage
boundary's hop alone (the activation a micro batch sends, CUDA events on
the receiver) in GB/s beside the 450 GB/s the scheduler prices. The
card's name and power limit come first. ``--device cpu --tiny`` runs it
on gloo ranks at a 64-wide 4-layer size with the kernels' plain
versions: a rehearsal, not a measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import socket
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "torch_pipeline_dist.jsonl")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


# The ``tp`` case runs in fp32 and is held to the loss tolerance of the
# gloo stage x TP test (``tests/test_torch_pipeline_dist.py``'s
# ``LOSS_RTOL``): across ranks the ``model`` axis sums each split matmul
# in another order, which bf16 would round far past it.
TP_LOSS_RTOL = 1e-5


def _config(args, layers, dtype=None):
    import torch

    from tepdist_tpu_torch.models import gpt2

    if args.tiny:
        return dataclasses.replace(
            gpt2.CONFIGS["test"], n_layer=4, attn="flash", remat=True,
            loss_chunk=64, dtype=torch.float32)
    cfg = dataclasses.replace(gpt2.CONFIGS["1.5B"], n_layer=layers,
                              attn="flash", remat=True, loss_chunk=512)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _batch(args, cfg, device):
    from tepdist_tpu_torch.models import gpt2

    rows, seq = (16, 32) if args.tiny else (48, 1024)
    return gpt2.fake_batch(cfg, rows, seq, seed=0, device=device)


def _train(args, cfg, device, devices, **kw):
    """(losses, step seconds, executable) of ``args.steps`` steps."""
    from tepdist_tpu_torch import train
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.exploration import PipelineWinner

    params = gpt2.init_params(cfg, seed=0, device=device)
    tokens = _batch(args, cfg, device)

    def loss_fn(p, t):
        return gpt2.loss_fn(p, t, cfg)

    if kw.pop("zero", False):
        exe = PipelineWinner(
            num_stages=kw["num_stages"], num_micro_batches=8, intra_tp=1,
            cost=None, candidates=[], loss_fn=loss_fn, params=params,
            example_batch=(tokens,), zero=True).build(
                adamw_bf16(1e-4), devices=devices)
        exe.load_variables(params)
        step = exe.step
    else:
        plan = train.plan_training(loss_fn, adamw_bf16(1e-4), params,
                                   tokens, num_micro_batches=8,
                                   devices=devices, device=device, **kw)
        exe, step = plan.executable, plan.step
    del params
    losses, seconds = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(step(tokens))
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, exe


def _hops(exe, device, cfg, args):
    """Each stage boundary's activation hop alone (s4: rank s -> s + 1),
    timed on the receiver: ms and GB/s a boundary."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    rows = (16 if args.tiny else 48) // 8
    shape = (rows, 32 if args.tiny else 1024, cfg.n_embd)
    x = torch.ones(shape, dtype=cfg.dtype, device=device)
    out = []
    for s in range(world - 1):
        dist.barrier()
        if rank not in (s, s + 1):
            continue
        times = []
        for it in range(13):
            if device.type == "cuda":
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                h0 = time.perf_counter()
            if rank == s:
                dist.send(x, s + 1)
            else:
                dist.recv(x, s)
            if device.type == "cuda":
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1)
            else:
                ms = (time.perf_counter() - h0) * 1e3
            if it >= 3:
                times.append(ms)
        if rank == s + 1:
            ms = sorted(times)[len(times) // 2]
            out.append({"boundary": f"{s}->{s + 1}", "bytes": x.nbytes,
                        "ms": ms, "gb_per_s": x.nbytes / ms / 1e6})
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    return [h for part in gathered for h in part]


def _cases(args):
    """(name, (depth, dtype), plan keywords) of the cases ``--cases``
    names; dtype None is the config's own (bf16)."""
    import torch

    cases = (("dp", (args.layers, None), dict(num_stages=2)),
             ("dp_zero", (args.layers, None), dict(num_stages=2, zero=True)),
             ("s4", (args.layers, None), dict(num_stages=4)),
             ("tp", (args.tp_layers, torch.float32),
              dict(num_stages=2, intra_stage_tp=2)))
    return [c for c in cases if c[0] in args.cases.split(",")]


def _worker(rank, world, port, args, refs):
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tepdist_tpu_torch.parallel.performance_utils import chip_spec

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    # A rank that fails leaves the others in a collective: give up after
    # 3 minutes rather than NCCL's 10.
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=3),
                            **({"device_id": device} if cuda else {}))
    try:
        failed = []
        for name, key, kw in _cases(args):
            cfg = _config(args, *key)
            rtol = TP_LOSS_RTOL if name == "tp" else cs.PIPELINE_LOSS_RTOL
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            losses, seconds, exe = _train(args, cfg, device,
                                          [device] * world, **kw)
            ref = refs[key]["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            ok = (all(math.isfinite(x) for x in losses)
                  and max(rel) <= rtol)
            hops = _hops(exe, device, cfg, args) if name == "s4" else None
            peak = (torch.cuda.max_memory_allocated(device) if cuda
                    else None)
            per_rank = [None] * world
            dist.all_gather_object(per_rank, {
                "losses": losses, "ok": ok, "coord": exe._coord,
                # Stage inputs the TP planner split over ``model``.
                "split": [sum(1 for p in specs
                              if type(p[-1]).__name__ == "Shard")
                          for specs in exe._tp_in_specs
                          if specs is not None],
                "max_loss_rel_diff": max(rel),
                "peak_bytes": peak, "step_seconds": seconds})
            if rank == 0:
                steady = seconds[1:] or seconds
                _emit({"tool": "torch_pipeline_dist", "case": name,
                       "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
                       "dtype": str(cfg.dtype),
                       "ranks": world, "device": args.device,
                       "num_stages": kw["num_stages"], "dp": exe.dp,
                       "tp": exe.tp, "zero": exe.zero,
                       "micro_batches": 8,
                       "predicted": {
                           "chip": chip_spec().name,
                           "makespan_s": exe.schedule.makespan,
                           "bubble_ratio": exe.schedule.bubble_ratio},
                       "measured_step_seconds_median":
                           sorted(steady)[len(steady) // 2],
                       "reference_losses": ref,
                       "reference_step_seconds":
                           refs[key]["step_seconds"],
                       "loss_rtol": rtol,
                       "per_rank": per_rank,
                       "hops": hops,
                       "hop_priced_gb_per_s": 450.0 if hops else None})
            if not all(r["ok"] for r in per_rank):
                failed.append(name)
            del exe
        if failed:
            raise SystemExit(f"torch_pipeline_dist: {failed} disagree with "
                             "the one-card reference")
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    finally:
        dist.destroy_process_group()


def _reference(args, key):
    """The one-process form on one card (no process group): 4 stages over
    ``[card 0] * 4``, the pipeline phase's form."""
    import torch

    device = torch.device("cuda", 0) if args.device == "cuda" else (
        torch.device("cpu"))
    losses, seconds, exe = _train(args, _config(args, *key), device,
                                  [device] * 4, num_stages=4)
    del exe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": seconds}


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--layers", type=int, default=48)
    p.add_argument("--tp-layers", type=int, default=8)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--cases", default="dp,dp_zero,s4",
                   help="a comma-separated subset of dp,dp_zero,s4,tp")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a 64-wide 4-layer model (a CPU rehearsal)")
    args = p.parse_args()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"torch_pipeline_dist: {args.ranks} cards needed, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        import chip_smoke as cs
        from tepdist_tpu_torch.ops import _build
        print(cs.nvidia_smi(), flush=True)
        _build.build(cs.KERNELS)
        torch.backends.cuda.matmul.allow_tf32 = False
    refs = {k: _reference(args, k) for k in {c[1] for c in _cases(args)}}
    mp.start_processes(_worker, args=(args.ranks, _free_port(), args, refs),
                       nprocs=args.ranks, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
