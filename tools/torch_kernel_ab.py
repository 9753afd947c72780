#!/usr/bin/env python3
"""Times the bf16 flash-attention backward kernels of two or more trees,
alternately, beside PyTorch's one-call backward.

Run on a machine with one NVIDIA H100, from the repository root:

    python3 tools/torch_kernel_ab.py --tree parent=DIR --tree change=. \\
        [--order parent,change,change,parent] [--shapes plan,slice,remat,llama]

Each entry of ``--order`` runs the named tree's ``flash_dq`` and
``flash_dkv`` (``tepdist_tpu_torch.ops.flash_attention``) in a fresh
process, one after another, at the shapes of the main paths (bf16, causal,
[BH, T, D]): ``plan`` [48*25, 1024, 64] (bench.py's recipe at M = 1),
``slice`` [4*25, 1024, 64], ``remat`` [8*25, 1024, 64] and ``llama``
[4*16, 512, 128]. A tree builds its own kernels on first use, before any
timed call. Each kernel's time is the median over 5 windows of the mean of
20 back-to-back calls, by CUDA events, after 3 warm-up calls (chip_smoke.py's
``cuda_ms``); beside it, in the same process, the time of
``aten._scaled_dot_product_flash_attention_backward`` on the same inputs (dQ,
dK and dV in one call; a yardstick only), and each kernel's largest error
against its plain version under chip_smoke.py's tolerance.

Prints the card's name and power limit, one JSON line per run, and last a
JSON summary: for each tree and shape, the median over its runs of dQ,
dK/dV, their sum and the library call, with the sum's share of the bound
(chip_smoke.py's ``bound``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SHAPES = {  # name: (B, H, T, D)
    "plan": (48, 25, 1024, 64),
    "slice": (4, 25, 1024, 64),
    "remat": (8, 25, 1024, 64),
    "llama": (4, 16, 512, 128),
}

CHILD = r"""
import json, math, sys
import torch
from tepdist_tpu_torch.ops import flash_attention as fa

shapes = json.loads(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False


def cuda_ms(fn, iters=20, warmup=3, windows=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return times[windows // 2]


def within(got, ref, ref32):
    got, ref, ref32 = got.float(), ref.float(), ref32.float()
    scale = max(1.0, ref32.abs().max().item())
    lim = 2e-5 * scale + 1e-4 * ref32.abs() + 2 * (ref - ref32).abs()
    err = (got - ref).abs()
    return err.max().item(), bool(torch.all(err <= lim).item())


out = {}
for name, (B, H, T, D) in shapes.items():
    gen = torch.Generator(device="cuda").manual_seed(17)
    BH, scale = B * H, 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, True, scale)
    args32 = (*(x.float() for x in (q, k, v, do)), lse, delta, True, scale)
    rec = {}
    for kern in ("flash_dq", "flash_dkv"):
        got = getattr(fa, kern)(*args)
        ref = getattr(fa, kern + "_plain")(*args)
        ref32 = getattr(fa, kern + "_plain")(*args32)
        if kern == "flash_dq":
            got, ref, ref32 = (got,), (ref,), (ref32,)
        errs = [within(*t) for t in zip(got, ref, ref32)]
        del got, ref, ref32
        rec[kern] = {"ms": cuda_ms(lambda: getattr(fa, kern)(*args)),
                     "max_abs_err": max(e[0] for e in errs),
                     "ok": all(e[1] for e in errs)}
        torch.cuda.empty_cache()
    aten = torch.ops.aten
    q4, k4, v4, do4 = (x.view(B, H, T, D) for x in (q, k, v, do))
    (o4, lse4, cum_q, cum_k, max_q, max_k, seed, offset
     ) = aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, True, scale=scale)[:8]
    rec["library_ms"] = cuda_ms(
        lambda: aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o4, lse4, cum_q, cum_k, max_q, max_k, 0.0,
            True, seed, offset, scale=scale))
    out[name] = rec
    del q, k, v, do, o, lse, delta, args, args32
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout holding tepdist_tpu_torch/")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    missing = [n for n in order if n not in trees]
    if missing:
        raise SystemExit(f"no --tree for {missing}")
    shapes = {s: SHAPES[s] for s in args.shapes.split(",")}
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    runs = {}
    for i, name in enumerate(order):
        root = os.path.abspath(trees[name])
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, json.dumps(shapes)], cwd=root,
            env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{name} run {i} failed ({proc.returncode})")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "tree": name, "shapes": rec}),
              flush=True)
        runs.setdefault(name, []).append(rec)
    summary = {}
    for name, recs in runs.items():
        summary[name] = {}
        for shape, (B, H, T, D) in shapes.items():
            dq = statistics.median(r[shape]["flash_dq"]["ms"] for r in recs)
            dkv = statistics.median(r[shape]["flash_dkv"]["ms"]
                                    for r in recs)
            lib = statistics.median(r[shape]["library_ms"] for r in recs)
            bounds = [chip_smoke.bound(k, B * H, T, D, "bfloat16", True)[0]
                      for k in ("flash_dq", "flash_dkv")]
            summary[name][shape] = {
                "dq_ms": dq, "dkv_ms": dkv, "pair_ms": dq + dkv,
                "library_ms": lib, "pair_over_library": (dq + dkv) / lib,
                "pair_bound_ms": sum(bounds),
                "pair_share_of_bound": sum(bounds) / (dq + dkv),
                "all_ok": all(r[shape][k]["ok"] for r in recs
                              for k in ("flash_dq", "flash_dkv"))}
    print(json.dumps({"nvidia_smi": smi, "order": order,
                      "median": summary}), flush=True)
    bad = [(n, s) for n, per in summary.items() for s, r in per.items()
           if not r["all_ok"]]
    if bad:
        print(f"kernels outside the tolerance: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
