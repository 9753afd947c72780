#!/usr/bin/env python3
"""Ring and Ulysses attention across cards: the port's sequence
parallelism in its process-group form, one process a card.

    python3 tools/torch_seq_ring.py [--ranks 4] [--tokens 16384]

Each rank (NCCL over ``tcp://127.0.0.1``, a free port) makes the same
seeded bf16 q, k, v, dO and dLSE of shape [1, 16, T, 128] (Llama 1B's
heads after the GQA repeat, causal), keeps its [1, 16, T/P, 128] block
and runs the flash ring and Ulysses over the group, forward and backward.
Every rank holds its block of o, LSE, dQ, dK and dV against one
whole-sequence call of the flash kernels on its own card, under
``chip_smoke.py``'s rule for the ``seq_kernels`` phase (SEQ_TOLERANCE).
Then each is timed with CUDA events, all ranks in step, and so is one
hop alone (the rank's K and V blocks shifted to its neighbour: the bytes
``ring_comm_cost`` prices a hop at), beside rank 0's times of the
whole-sequence call and of the one-process ring over ``[cuda:0] * P``
(the ``seq_kernels`` phase's form). Rank 0 prints one
JSON line, also written to ``chiprun_out/torch_seq_ring.json``, and the
card's name and power limit. ``--device cpu`` runs the same on gloo
ranks with the kernels' plain versions: a rehearsal, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _worker(rank, world, port, args, out):
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tepdist_tpu_torch.ops.ring_attention import _SeqAttn
    from tepdist_tpu_torch.ops.seq_comm import DeviceTransport, GroupTransport

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
                            **({"device_id": device} if cuda else {}))
    try:
        H, D, T = 16, 128, args.tokens
        scale = 1.0 / math.sqrt(D)
        q, k, v, do, dlse = cs.seq_inputs((1, H, T, D), device)
        Tl = T // world
        sl = slice(rank * Tl, (rank + 1) * Tl)
        ring = GroupTransport(dist.group.WORLD)

        def block(x):
            return x[:, :, sl].contiguous()

        ref, ref32 = ([block(t) for t in cs.whole_sequence(
            q, k, v, do, dlse, scale, x)]
            for x in (torch.bfloat16, torch.float32))

        def run(impl, dtype):
            leaves = [block(t).to(dtype).requires_grad_() for t in (q, k, v)]
            o, lse = _SeqAttn.apply(*leaves, ring, True, scale, H, impl,
                                    "flash")
            grads = torch.autograd.grad((o, lse), leaves,
                                        (block(do).to(dtype), block(dlse)))
            return [o.detach(), lse.detach(), *grads]

        res = {}
        for impl in ("ring", "ulysses"):
            got, got32 = run(impl, torch.bfloat16), run(impl, torch.float32)
            readings, ok = cs.seq_rule(got, got32, ref, ref32)
            leaves = [block(t).requires_grad_() for t in (q, k, v)]

            def fwd(impl=impl, leaves=leaves):
                return _SeqAttn.apply(*leaves, ring, True, scale, H, impl,
                                      "flash")

            o, lse = fwd()
            timer = cs.cuda_ms if cuda else _host_ms
            dist.barrier()
            f_ms = timer(fwd, iters=5, windows=3)
            dist.barrier()
            b_ms = timer(lambda: torch.autograd.grad(
                (o, lse), leaves, (block(do), block(dlse)),
                retain_graph=True), iters=5, windows=3)
            res[impl] = {"outputs": readings, "ok": ok,
                         "forward_ms": f_ms, "backward_ms": b_ms}
        # One hop of the ring alone: this rank's K and V blocks out to the
        # next rank and the previous rank's in, as the forward's shift
        # moves them.
        kv = [[block(k)], [block(v)]]
        hop_bytes = 2 * kv[0][0].numel() * kv[0][0].element_size()
        dist.barrier()
        hop_ms = timer(lambda: ring.shift_raw(kv), iters=5, windows=3)
        res["hop"] = {"bytes": hop_bytes, "ms": hop_ms,
                      "gb_per_s": hop_bytes / (hop_ms[0] * 1e-3) / 1e9}
        everyone = [None] * world
        dist.all_gather_object(everyone, res)
        if rank == 0:
            timer = cs.cuda_ms if cuda else _host_ms
            flat = [t.reshape(H, T, D).contiguous() for t in (q, k, v)]
            from tepdist_tpu_torch.ops import flash_attention as fa
            whole_ms = timer(lambda: fa.flash_fwd(*flat, True, scale),
                             iters=5, windows=3)
            one = DeviceTransport([device] * world)
            leaves = [t.requires_grad_() for t in (q, k, v)]

            def one_fwd():
                return _SeqAttn.apply(*leaves, one, True, scale, H, "ring",
                                      "flash")
            o, lse = one_fwd()
            out.update({"per_rank": everyone, "whole_forward_ms": whole_ms,
                        "one_process_ring_forward_ms": timer(
                            one_fwd, iters=5, windows=3),
                        "one_process_ring_backward_ms": timer(
                            lambda: torch.autograd.grad(
                                (o, lse), leaves, (do, dlse),
                                retain_graph=True), iters=5, windows=3)})
            if cuda:
                out["device"] = torch.cuda.get_device_name(0)
                out["nvidia_smi"] = cs.nvidia_smi()
    finally:
        dist.destroy_process_group()


def _host_ms(fn, iters=5, warmup=1, windows=3):
    import time

    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters, 0.0


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--tokens", type=int, default=16384)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"torch_seq_ring: {args.ranks} cards needed, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        import chip_smoke as cs
        from tepdist_tpu_torch.ops import _build
        _build.build(cs.KERNELS)
    out = mp.Manager().dict()
    mp.start_processes(_worker, args=(args.ranks, _free_port(), args, out),
                       nprocs=args.ranks, start_method="spawn")
    out = dict(out)
    line = json.dumps({"tool": "torch_seq_ring", "ranks": args.ranks,
                       "shape": f"[1, 16, {args.tokens}, 128] bf16 causal",
                       "device": args.device, **out})
    if "nvidia_smi" in out:
        print(out["nvidia_smi"])
    print(line)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_seq_ring.json"),
              "w") as f:
        f.write(line + "\n")
    bad = [i for i, r in enumerate(out.get("per_rank", []))
           for impl in ("ring", "ulysses") if not r[impl]["ok"]]
    return 1 if bad or "per_rank" not in out else 0


if __name__ == "__main__":
    sys.exit(main())
