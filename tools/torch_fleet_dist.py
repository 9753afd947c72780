#!/usr/bin/env python3
"""The port's service across several cards: the multi-host SPMD step and
the fleet pipeline.

    python3 tools/torch_fleet_dist.py [--ranks 4] [--modes multihost,fleet]
                                      [--mh-layers 4] [--steps 3]

``multihost``: ``--ranks`` processes in one NCCL world (``tcp://127.0.0.1``,
a free port), each rank bound to its card and holding one
``TepdistServicer`` behind an ``inproc:`` address (the card's machine has
no grpcio). Each process drives its own servicer through
``MultiHostSession([its address], mesh_axes=[("data", ranks)])`` in
lockstep: every rank enters the same verbs in the same order (the
multi-controller contract), so the DTensor step's collectives meet over
the world. The model is GPT-2 1.5B at full width and ``--mh-layers``
deep (flash, full remat, ``loss_chunk=512``, ``adamw_bf16(1e-4)``, seed 0),
batch 16 x 1024 with the token ids annotated split on ``data``; the depth
keeps the planner's cost search (on rank 0, then broadcast) within
``MH_SEARCH_BUDGET_S`` (ROADMAP C5: 72-84 s at 2-4 layers on the card's
host). Ranks must agree on plan handles and losses, the losses are held
to the one-card eager plan on the same global batch (run first by the
parent on card 0) at ``SPMD_STEP_LOSS_RTOL``, and no ``index_put`` may be
among the step's involuntary remats (ROADMAP C8).

``fleet``: ``DistributedPipelineSession`` over ``--ranks`` in-process
workers on ``cuda:0..ranks-1`` (one stage each, GPT-2 1.5B at full width
and depth, ``chip_smoke.py``'s pipeline recipe: batch 48 x 1024, M = 8),
activations worker to worker as RPC raw-data pushes, held to a one-card
``PipelineExecutable`` (4 stages over ``[cuda:0] * 4``) at
``PIPELINE_LOSS_RTOL``; then one hop alone through the raw-data path
(a stage boundary's activation from card 0's worker into card 1's store).

A rank that raises prints its traceback and exits at once. Every case
prints one JSON line (also appended to ``chiprun_out/torch_fleet_dist.jsonl``)
after the card's name and power limit. ``--device cpu --tiny`` rehearses
both modes on gloo ranks and CPU workers at a 64-wide size (a rehearsal,
not a measurement).
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
OUT = os.path.join(ROOT, "chiprun_out", "torch_fleet_dist.jsonl")

MH_BATCH, FLEET_BATCH, SEQ, FLEET_MICRO = 16, 48, 1024, 8
MH_SEARCH_BUDGET_S = 150.0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _config(args, layers):
    import torch

    from tepdist_tpu_torch.models import gpt2

    if args.tiny:
        return dataclasses.replace(
            gpt2.CONFIGS["test"], n_layer=4, attn="flash", remat=True,
            loss_chunk=64, dtype=torch.float32)
    return dataclasses.replace(gpt2.CONFIGS["1.5B"], n_layer=layers,
                               attn="flash", remat=True, loss_chunk=512)


def _shape(args, rows):
    return (8 if rows == MH_BATCH else 16, 32) if args.tiny else (rows, SEQ)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- multihost ---------------------------------------------------------------

def _mh_reference(args, device):
    """The one-card eager plan on the global batch."""
    from tepdist_tpu_torch import train
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw_bf16

    cfg = _config(args, args.mh_layers)
    params = gpt2.init_params(cfg, seed=0, device=device)
    tokens = gpt2.fake_batch(cfg, *_shape(args, MH_BATCH), seed=0,
                             device=device)
    plan = train.plan_training(lambda p, t: gpt2.loss_fn(p, t, cfg),
                               adamw_bf16(1e-4), params, tokens,
                               num_micro_batches=1, device=device)
    losses, seconds = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(plan.step(tokens))
        seconds.append(time.perf_counter() - t0)
    return {"losses": losses, "step_seconds": seconds}


def _remats(servicer, handle, tokens, n_state):
    """The step's involuntary remats (``parallel/lowering_check``) on the
    servicer's current state, nothing updated: the node names and their
    targets."""
    from tepdist_tpu_torch.parallel.lowering_check import involuntary_remats

    plan = servicer.plan_cache.resolve(handle)
    args = [plan.place(i, servicer.variables[i]) for i in range(n_state)]
    args.append(plan.place(n_state, tokens))
    names = involuntary_remats(plan.exe, args)
    targets = {n.name: str(n.target) for n in plan.exe.gm.graph.nodes
               if n.op == "call_function"} if hasattr(plan.exe, "gm") else {}
    return [{"node": n, "target": targets.get(n, "")} for n in names]


def _mh_worker(rank, world, port, args, ref):
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tepdist_tpu_torch.client.multihost import MultiHostSession
    from tepdist_tpu_torch.core.dist_spec import DimStrategy
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=5),
                            **({"device_id": device} if cuda else {}))
    try:
        servicer = TepdistServicer([device], task_index=rank)
        address = f"inproc:{9100 + rank}"
        inproc.register_servicer(address, servicer)
        cfg = _config(args, args.mh_layers)
        params = gpt2.init_params(cfg, seed=0, device=device)
        tokens = gpt2.fake_batch(cfg, *_shape(args, MH_BATCH), seed=0,
                                 device=device)
        opt = adamw_bf16(1e-4)
        n_state = len(tree_leaves((params, opt.init(params))))
        sess = MultiHostSession([address], mesh_axes=[("data", world)])
        t0 = time.perf_counter()
        summary = sess.compile_training(
            lambda p, t: gpt2.loss_fn(p, t, cfg), opt, params, tokens,
            annotations={n_state: {"data": DimStrategy(
                partition_dim=0, num_splits=world)}})
        compile_s = time.perf_counter() - t0
        del params
        losses, seconds = [], []
        fa.reset_launch_counts()
        for _ in range(args.steps):
            t0 = time.perf_counter()
            losses.append(sess.run(tokens))
            seconds.append(time.perf_counter() - t0)
        launches = dict(fa.launch_counts)
        remats = _remats(servicer, sess.handle, tokens, n_state)
        ref_l = ref["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_l)]
        rank_info = {"rank": rank, "handle": sess.handle, "losses": losses,
                     "max_loss_rel_diff": max(rel),
                     "step_seconds": seconds, "launches": launches,
                     "remats": remats,
                     "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                    if cuda else None)}
        per_rank = [None] * world
        dist.all_gather_object(per_rank, rank_info)
        index_put = [r for info in per_rank for r in info["remats"]
                     if "index_put" in r["target"]]
        agree = (len({i["handle"] for i in per_rank}) == 1
                 and len({tuple(i["losses"]) for i in per_rank}) == 1)
        ok = (agree and not index_put
              and all(math.isfinite(x) for x in losses)
              and max(rel) <= cs.SPMD_STEP_LOSS_RTOL
              and all(i["launches"].get("flash_fwd", 0) or not cuda
                      for i in per_rank))
        if rank == 0:
            steady = seconds[1:] or seconds
            _emit({"tool": "torch_fleet_dist", "mode": "multihost",
                   "ranks": world, "device": args.device,
                   "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
                   "batch": list(tokens.shape), "mesh": [["data", world]],
                   "summary": {k: summary.get(k) for k in
                               ("axes", "mode", "planner_seconds",
                                "graph_nodes")},
                   "planner_budget_s": MH_SEARCH_BUDGET_S,
                   "compile_seconds": compile_s,
                   "reference_losses": ref_l,
                   "reference_step_seconds": ref["step_seconds"],
                   "loss_rtol": cs.SPMD_STEP_LOSS_RTOL,
                   "ranks_agree": agree,
                   "index_put_remats": index_put,
                   "step_seconds_median": sorted(steady)[len(steady) // 2],
                   "tokens_per_s": (tokens.numel() * len(steady)
                                    / sum(steady)),
                   "per_rank": per_rank, "ok": ok})
        sess.close()
        if not ok:
            raise SystemExit("torch_fleet_dist: the multi-host step "
                             "disagrees (see the JSON line)")
        if summary.get("planner_seconds", 0) > MH_SEARCH_BUDGET_S:
            raise SystemExit("torch_fleet_dist: the planner took "
                             f"{summary['planner_seconds']} s, over its "
                             f"budget of {MH_SEARCH_BUDGET_S} s")
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    finally:
        dist.destroy_process_group()


# -- fleet -------------------------------------------------------------------

def _fleet(args, devices):
    import torch

    import chip_smoke as cs
    from tepdist_tpu_torch.core.tree import tree_map
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc import protocol
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.runtime.executor import PipelineExecutable

    S = len(devices)
    cfg = _config(args, 48)
    d0 = devices[0]
    tokens = gpt2.fake_batch(cfg, *_shape(args, FLEET_BATCH), seed=0,
                             device=d0)

    def loss(p, t):
        return gpt2.loss_fn(p, t, cfg)

    params = gpt2.init_params(cfg, seed=0, device=d0)
    prog = plan_pipeline(loss, S, FLEET_MICRO, params, tokens)
    # The one-card reference: the same cut over [card 0] * S.
    exe = PipelineExecutable(prog, devices=[d0] * S,
                             optimizer=adamw_bf16(1e-4))
    # A copy: on one device the executable updates the leaves it is
    # given in place.
    exe.load_variables(tree_map(lambda t: t.clone(), params))
    ref, ref_s = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        ref.append(exe.step(tokens))
        ref_s.append(time.perf_counter() - t0)
    del exe
    if d0.type == "cuda":
        torch.cuda.empty_cache()
    os.environ["TEPDIST_DEVICE_TRANSFER"] = "0"
    cluster, servicers = make_inproc_cluster(S, devices=[d0])
    for sv, dev in zip(servicers, devices):
        sv.devices, sv.device = [dev], dev
    t0 = time.perf_counter()
    sess = DistributedPipelineSession(prog, cluster,
                                      optimizer=adamw_bf16(1e-4))
    sess.load_variables(params)
    setup_s = time.perf_counter() - t0
    del params
    losses, seconds = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(sess.step(tokens))
        seconds.append(time.perf_counter() - t0)
    pushes = {sv.task_index: (sv.worker_plan.push_bytes,
                              sv.worker_plan.push_seconds)
              for sv in servicers}
    sess.close()
    # One hop alone through the raw-data path: card 0's worker pushes a
    # micro batch's stage activation into card 1's store (encode, the
    # in-process transport, decode onto card 1).
    rows = _shape(args, FLEET_BATCH)[0] // FLEET_MICRO
    x = torch.ones(rows, _shape(args, FLEET_BATCH)[1], cfg.n_embd,
                   dtype=cfg.dtype, device=d0)
    peer = servicers[1]
    times = []
    for it in range(13):
        _sync(d0)
        t0 = time.perf_counter()
        meta, blob = protocol.encode_literal(x)
        peer.TransferHostRawData(protocol.pack_frames(
            {"raw_key": f"hop:{it}", "literal": meta}, [blob]).join())
        val = peer.raw_store.get(f"hop:{it}")
        val = val.to(peer.device)
        _sync(peer.device)
        if it >= 3:
            times.append(time.perf_counter() - t0)
    hop_s = sorted(times)[len(times) // 2]
    close_inproc_cluster(cluster)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    ok = (all(math.isfinite(v) for v in losses)
          and max(rel) <= cs.PIPELINE_LOSS_RTOL)
    steady = seconds[1:] or seconds
    _emit({"tool": "torch_fleet_dist", "mode": "fleet", "workers": S,
           "devices": [str(d) for d in devices], "n_layer": cfg.n_layer,
           "n_embd": cfg.n_embd, "batch": list(tokens.shape),
           "micro_batches": FLEET_MICRO, "transport": "raw-data push",
           "setup_seconds": setup_s, "losses": losses,
           "reference_losses": ref, "reference_step_seconds": ref_s,
           "loss_rel_diff": rel, "loss_rtol": cs.PIPELINE_LOSS_RTOL,
           "bit_for_bit": losses == ref, "step_seconds": seconds,
           "step_seconds_median": sorted(steady)[len(steady) // 2],
           "push_bytes_and_seconds": pushes,
           "push_gb_per_s": {ti: (b / s / 1e9 if s else None)
                             for ti, (b, s) in pushes.items()},
           "hop_alone": {"bytes": x.nbytes, "ms": hop_s * 1e3,
                         "gb_per_s": x.nbytes / hop_s / 1e9},
           "ok": ok})
    if not ok:
        raise SystemExit("torch_fleet_dist: the fleet's losses differ from "
                         "the one-card reference")


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--modes", default="multihost,fleet")
    p.add_argument("--mh-layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a 64-wide model (a CPU rehearsal)")
    args = p.parse_args()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    modes = args.modes.split(",")
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"torch_fleet_dist: {args.ranks} cards needed, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        import chip_smoke as cs
        from tepdist_tpu_torch.ops import _build
        print(cs.nvidia_smi(), flush=True)
        _build.build(cs.KERNELS)
        torch.backends.cuda.matmul.allow_tf32 = False
        devices = [torch.device("cuda", r) for r in range(args.ranks)]
    else:
        devices = [torch.device("cpu")] * args.ranks
    if "fleet" in modes:
        _fleet(args, devices)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if "multihost" in modes:
        ref = _mh_reference(args, devices[0])
        if args.device == "cuda":
            torch.cuda.empty_cache()
        mp.start_processes(_mh_worker,
                           args=(args.ranks, _free_port(), args, ref),
                           nprocs=args.ranks, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
