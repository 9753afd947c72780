#!/usr/bin/env python3
"""Pipeline stages over several cards: the port's ``PipelineExecutable`` in
its process-group form, one process a card.

    python3 tools/torch_pipeline_dist.py [--ranks 4] [--layers 48]
                                         [--tp-layers 8] [--steps 4]
                                         [--cases dp,dp_zero,s4]
    python3 tools/torch_pipeline_dist.py --cases servicer

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

``servicer`` (named only, and run alone) drives the service instead of
the executable: one ``TepdistServicer`` over ``cuda:0..3`` (its group
form: one NCCL rank a card, ``rpc/rank_group.py``) behind an ``inproc:``
address, and a ``TepdistSession`` in this process with no mesh axes, so
the servicer explores over its 4 ranks (stage x TP included) and builds
its winner. The recipe is ``chip_smoke.py``'s ``explore_tools`` phase
(GPT-2 1.5B width, ``EXPLORE_LAYERS`` deep, batch ``EXPLORE_BATCH`` x
1024, M = ``EXPLORE_MICRO``, ``adamw_bf16(1e-4)``, ``EXPLORE_STEPS``
steps). The same session first drives a servicer over ``[cuda:0] * 4``
(one process: no TP) in this process, the phase's own form, as the
reference. It prints the winner and its predicted ms beside the
runner-up's, the planner and ``compile_training`` seconds, the step
seconds beside the reference's, the losses held at
``SERVICER_LOSS_RTOL`` to the reference's, each rank's peak memory and
its launches of the three kernels (by shape), the milliseconds of one
more step's spans by category on each rank (and in the reference's
process), then each kernel at the
shape the stage ran against its plain version (``chip_smoke.py``'s
``_within``/``TOLERANCE``), with its time, bound, plain and library
times. It fails unless the losses agree and fall, each kernel was
launched (a stage without attention, the LM head's, launches none) and
the ranks of each stage group launched alike, and every kernel agrees.

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
# The ``servicer`` case runs the explore_tools recipe in bf16 and is held
# to the one-process run of the same recipe: a TP stage adds rounding
# points (each split matmul's partial sums are reduced in bf16) on top of
# the pipeline phases' GA order (PIPELINE_LOSS_RTOL, 2e-3), so allow five
# times that.
SERVICER_LOSS_RTOL = 1e-2


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


def _servicer_recipe(args):
    """(config, CPU params, CPU tokens, micro batches, steps, optimizer,
    spec) of the explore_tools recipe (``--tiny``: GPT-2 ``test`` with
    flash and full remat, batch 8 x 32)."""
    import torch

    import chip_smoke as cs
    from tepdist_tpu_torch.core.tree import tree_map
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw_bf16, optimizer_spec

    if args.tiny:
        cfg = dataclasses.replace(gpt2.CONFIGS["test"], attn="flash",
                                  remat=True)
        rows, seq = 8, 32
    else:
        cfg = cs._config(cs.EXPLORE_LAYERS)
        rows, seq = cs.EXPLORE_BATCH, cs.SEQ
    device = "cuda" if args.device == "cuda" else "cpu"
    params = tree_map(lambda v: v.cpu(), gpt2.init_params(
        cfg, seed=0, device=device))
    tokens = gpt2.fake_batch(cfg, rows, seq, seed=0, device=device).cpu()
    if device == "cuda":
        torch.cuda.empty_cache()
    return (cfg, params, tokens, cs.EXPLORE_MICRO, cs.EXPLORE_STEPS,
            adamw_bf16(1e-4), optimizer_spec("adamw_bf16",
                                             learning_rate=1e-4))


def _drive_servicer(servicer, address, recipe):
    """Compile and step the recipe through ``servicer``, then one traced
    step: (summary, compile seconds, losses, step seconds, per-rank stats
    or None, the traced step's seconds and spans by rank)."""
    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.rpc import inproc, rank_group

    cfg, params, tokens, micro, steps, opt, spec = recipe
    group = servicer.rank_group
    inproc.register_servicer(address, servicer)
    try:
        sess = TepdistSession(address)
        t0 = time.perf_counter()
        summary = sess.compile_training(
            lambda p, t: gpt2.loss_fn(p, t, cfg), opt, params, tokens,
            num_micro_batches=micro, optimizer_spec=spec)
        compile_s = time.perf_counter() - t0
        stats = None
        if group is not None:
            stats = {"after_compile": group.call_each(rank_group.rank_stats)}
            group.call_each(rank_group.reset_rank_stats)
        losses, seconds = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(sess.run(tokens))
            seconds.append(time.perf_counter() - t0)
        if group is not None:
            stats["steps"] = group.call_each(rank_group.rank_stats)
            group.call_each(rank_group.reset_rank_stats, True)
        else:
            rank_group.reset_rank_stats(True)
        # One more step, traced: where each rank's step time goes.
        t0 = time.perf_counter()
        sess.run(tokens)
        traced = {"seconds": time.perf_counter() - t0}
        if group is not None:
            traced["spans"] = [st["spans"] for st in
                               group.call_each(rank_group.rank_stats)]
            group.call_each(rank_group.reset_rank_stats)
        else:
            traced["spans"] = [rank_group.rank_stats()["spans"]]
            rank_group.reset_rank_stats()
        sess.close()
    finally:
        inproc.unregister_servicer(address)
    return summary, compile_s, losses, seconds, stats, traced


def _winner_rows(summary):
    """The winner's and the runner-up's candidate rows (predicted ms)."""
    rows = summary.get("explored", {}).get("candidates", [])
    won = next((r for r in rows if r["winner"]), None)
    runner = next((r for r in rows if not r["winner"]), None)
    return [None if r is None else
            {"kind": r["kind"], "config": r["config"],
             "predicted_ms": r["duration_s"] * 1e3,
             "memory_feasible": r["memory_feasible"]}
            for r in (won, runner)]


def _servicer_case(args) -> int:
    """The ``servicer`` case (module docstring): 0 when every check
    holds."""
    import gc
    import re

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    cuda = args.device == "cuda"
    recipe = _servicer_recipe(args)
    cfg = recipe[0]
    ServiceEnv.reset()
    # The reference: the one-process servicer of explore_tools.
    ref_devices = ([torch.device("cuda", 0)] * args.ranks if cuda
                   else ["cpu"])
    had_world = dist.is_initialized()
    ref = _drive_servicer(TepdistServicer(ref_devices),
                          "inproc:pd-servicer-ref", recipe)
    # A one-rank SPMD winner leaves its world in this process.
    if dist.is_initialized() and not had_world:
        dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    devices = ([torch.device("cuda", r) for r in range(args.ranks)] if cuda
               else ["cpu"] * args.ranks)
    t0 = time.perf_counter()
    servicer = TepdistServicer(devices)
    summary, compile_s, losses, seconds, stats, traced = _drive_servicer(
        servicer, "inproc:pd-servicer", recipe)
    drive_s = time.perf_counter() - t0
    alive = servicer.rank_group.alive()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref[2])]
    per_rank = [{"rank": r, "launches": st["launches"],
                 "shape_launches": st["shape_launches"],
                 "peak_bytes_steps": st["peak_bytes"],
                 "peak_bytes_compile": stats["after_compile"][r][
                     "peak_bytes"]}
                for r, st in enumerate(stats["steps"])]
    won, runner = _winner_rows(summary)
    ref_won, _ = _winner_rows(ref[0])
    line = {"tool": "torch_pipeline_dist", "case": "servicer",
            "device": args.device, "ranks": args.ranks,
            "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
            "dtype": str(cfg.dtype), "micro_batches": recipe[3],
            "batch": list(recipe[2].shape),
            "winner": won, "runner_up": runner,
            "summary": {k: summary.get(k) for k in (
                "kind", "axes", "num_stages", "num_micro_batches",
                "intra_tp", "placement", "interleave_groups")},
            "pipeline_form": summary.get("explored", {}).get(
                "pipeline_form"),
            "planner_seconds": summary.get("planner_seconds"),
            "compile_training_seconds": compile_s,
            "servicer_seconds": drive_s,
            "losses": losses, "step_seconds": seconds,
            "reference": {"devices": f"{ref_devices[0]} x "
                                     f"{len(ref_devices)} (one process)",
                          "winner": ref_won,
                          "planner_seconds": ref[0].get("planner_seconds"),
                          "compile_training_seconds": ref[1],
                          "losses": ref[2], "step_seconds": ref[3],
                          "traced_step": ref[5]},
            "traced_step": traced,
            "loss_rtol": SERVICER_LOSS_RTOL,
            "max_loss_rel_diff": max(rel),
            "per_rank": per_rank,
            "ranks_alive_after_close": alive}
    _emit(line)
    failed = []
    if not (all(math.isfinite(x) for x in losses)
            and max(rel) <= SERVICER_LOSS_RTOL and losses[-1] < losses[0]):
        failed.append(f"losses {losses} against {ref[2]}")
    if any(alive):
        failed.append(f"ranks alive after close: {alive}")
    if cuda:
        # A stage without attention (the LM head's) launches none; the
        # ranks of one stage group run one program and launch alike.
        counts = [st["launches"] for st in per_rank]
        per = args.ranks // (summary.get("num_stages") or 1)
        groups = [counts[g:g + per] for g in range(0, args.ranks, per)]
        if not (all(any(c.get(n) for c in counts) for n in cs.KERNELS)
                and all(c == grp[0] for grp in groups for c in grp)):
            failed.append(f"launches by rank {counts}: a kernel never "
                          "launched, or one stage group's ranks differ")
        # Each kernel at the shape rank 0's stage ran it most, against its
        # plain version.
        seen = per_rank[0]["shape_launches"]
        BH, T, D = (int(x) for x in re.findall(r"\d+", max(
            (k for k in seen if k.startswith("flash_fwd/")), key=seen.get)))
        H = cfg.n_head
        res = cs._case(B=BH // H, H=H, T=T, D=D, dtype=cfg.dtype,
                       causal=True, seed=700, time_it=True)
        _emit({"tool": "torch_pipeline_dist", "case": "servicer_kernels",
               "shape": {"B": BH // H, "H": H, "T": T, "D": D,
                         "dtype": str(cfg.dtype).replace("torch.", ""),
                         "causal": True},
               "tolerance": cs.TOLERANCE, "results": res})
        bad = [n for n, r in res.items() if not r["ok"]]
        if bad:
            failed.append(f"{bad} disagree with their plain versions")
    if failed:
        print("torch_pipeline_dist servicer: " + "; ".join(failed),
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--layers", type=int, default=48)
    p.add_argument("--tp-layers", type=int, default=8)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--cases", default="dp,dp_zero,s4",
                   help="a comma-separated subset of dp,dp_zero,s4,tp; or "
                        "servicer, alone")
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
    if args.cases == "servicer":
        return _servicer_case(args)
    refs = {k: _reference(args, k) for k in {c[1] for c in _cases(args)}}
    mp.start_processes(_worker, args=(args.ranks, _free_port(), args, refs),
                       nprocs=args.ranks, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
