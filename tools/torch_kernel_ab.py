#!/usr/bin/env python3
"""Times the bf16 flash-attention kernels of two or more trees, alternately,
beside PyTorch's one-call forward and backward.

Run on a machine with one NVIDIA H100, from the repository root:

    python3 tools/torch_kernel_ab.py --tree parent=DIR --tree change=. \\
        [--order parent,change,change,parent] [--kernels fwd|bwd|all] \\
        [--shapes plan,slice,remat,llama,ring,ring_full,seq_hop,seq_hop_full]

Each entry of ``--order`` runs the named tree's kernels
(``tepdist_tpu_torch.ops.flash_attention``) in a fresh process, one after
another, at the shapes of the main paths (bf16, [BH, T, D]): ``plan``
[48*25, 1024, 64] (bench.py's recipe at M = 1), ``slice`` [4*25, 1024, 64],
``remat`` [8*25, 1024, 64], ``llama`` [4*16, 512, 128], all causal; the
ring's hop at Llama 1B heads, ``ring`` [16, 4096, 128] causal and
``ring_full`` non-causal; and the GPT-2 ring step's hop, ``seq_hop``
[4*25, 256, 64] causal and ``seq_hop_full``. ``--kernels fwd`` times
``flash_fwd``, ``bwd`` ``flash_dq`` and ``flash_dkv``, ``all`` the three. A
tree builds its kernels (one nvcc each, at once) before any timed call.
Each kernel's time is the median over 5 windows of the mean of 20
back-to-back calls, by CUDA events, after 3 warm-up calls (chip_smoke.py's
``cuda_ms``); beside it, in the same process, the time of the library call
on the same inputs (a yardstick only):
``aten._scaled_dot_product_flash_attention`` for the forward (O and LSE),
``aten._scaled_dot_product_flash_attention_backward`` for the backward (dQ,
dK and dV in one call). Each kernel's largest error against its plain
version is checked under chip_smoke.py's tolerance, and a second call on
the same inputs must give the same bits. Beside the forward's times stand
its and the library call's device time alone (torch.profiler's CUDA trace
of 20 calls), which a shape small enough for the host to set the pace of
back-to-back calls shows apart from it.

Prints the card's name and power limit, one JSON line per run (the first
run of a tree also carries its ptxas report: registers at launch and spill
bytes of each kernel), and last a JSON summary: for each tree and shape,
the median over its runs of each time, the forward's and the backward
pair's share of the bound (chip_smoke.py's ``bound``) and their ratio to
the library call. A run that fails or takes more than ``RUN_SECONDS`` is
reported and the others go on; the exit code is then 1, as for a kernel
outside the tolerance.
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

SHAPES = {  # name: (B, H, T, D, causal)
    "plan": (48, 25, 1024, 64, True),
    "slice": (4, 25, 1024, 64, True),
    "remat": (8, 25, 1024, 64, True),
    "llama": (4, 16, 512, 128, True),
    "ring": (1, 16, 4096, 128, True),
    "ring_full": (1, 16, 4096, 128, False),
    "seq_hop": (4, 25, 256, 64, True),
    "seq_hop_full": (4, 25, 256, 64, False),
}
# Seconds a run may take, its builds included: a kernel that hangs fails
# its run, not the whole comparison.
RUN_SECONDS = 600
KERNELS = {"fwd": ("flash_fwd",), "bwd": ("flash_dq", "flash_dkv"),
           "all": ("flash_fwd", "flash_dq", "flash_dkv")}

CHILD = r"""
import json, math, sys
import torch
from tepdist_tpu_torch.ops import _build
from tepdist_tpu_torch.ops import flash_attention as fa

shapes, kernels = json.loads(sys.argv[1]), json.loads(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(sorted({"flash_fwd", *kernels}))


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


def device_ms(fn, iters=20):
    # The device time of one call: the kernels' own time over iters calls,
    # read from torch.profiler's CUDA trace (None without one).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us else None


def within(got, ref, ref32):
    got, ref, ref32 = got.float(), ref.float(), ref32.float()
    scale = max(1.0, ref32.abs().max().item())
    lim = 2e-5 * scale + 1e-4 * ref32.abs() + 2 * (ref - ref32).abs()
    err = (got - ref).abs()
    return err.max().item(), bool(torch.all(err <= lim).item())


def check(kern, args, args32):
    got = getattr(fa, kern)(*args)
    again = getattr(fa, kern)(*args)
    ref = getattr(fa, kern + "_plain")(*args)
    ref32 = getattr(fa, kern + "_plain")(*args32)
    if kern == "flash_dq":
        got, again, ref, ref32 = (got,), (again,), (ref,), (ref32,)
    errs = [within(*t) for t in zip(got, ref, ref32)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return {"max_abs_err": max(e[0] for e in errs),
            "ok": all(e[1] for e in errs) and same, "deterministic": same}


out = {"ptxas_logs": {k: str(_build.library_path(k).with_suffix(".so.log"))
                      for k in kernels}}
for name, (B, H, T, D, causal) in shapes.items():
    gen = torch.Generator(device="cuda").manual_seed(17)
    BH, scale = B * H, 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    up = [x.float() for x in (q, k, v, do)]
    aten = torch.ops.aten
    q4, k4, v4, do4 = (x.view(B, H, T, D) for x in (q, k, v, do))
    rec = {}
    if "flash_fwd" in kernels:
        rec["flash_fwd"] = check("flash_fwd", (q, k, v, causal, scale),
                                 (*up[:3], causal, scale))
        torch.cuda.empty_cache()
        fwd = lambda: fa.flash_fwd(q, k, v, causal, scale)  # noqa: E731
        lib = lambda: aten._scaled_dot_product_flash_attention(  # noqa
            q4, k4, v4, 0.0, causal, scale=scale)
        rec["flash_fwd"]["ms"] = cuda_ms(fwd)
        rec["flash_fwd"]["library_ms"] = cuda_ms(lib)
        rec["flash_fwd"]["device_ms"] = device_ms(fwd)
        rec["flash_fwd"]["library_device_ms"] = device_ms(lib)
    bwd = [kern for kern in kernels if kern != "flash_fwd"]
    if bwd:
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        args = (q, k, v, do, lse, delta, causal, scale)
        args32 = (*up, lse, delta, causal, scale)
        for kern in bwd:
            rec[kern] = check(kern, args, args32)
            torch.cuda.empty_cache()
            rec[kern]["ms"] = cuda_ms(lambda: getattr(fa, kern)(*args))
        (o4, lse4, cum_q, cum_k, max_q, max_k, seed, offset
         ) = aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, causal, scale=scale)[:8]
        rec["library_ms"] = cuda_ms(
            lambda: aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, o4, lse4, cum_q, cum_k, max_q, max_k, 0.0,
                causal, seed, offset, scale=scale))
        del o, lse, delta, args, args32
    out[name] = rec
    del q, k, v, do, up, q4, k4, v4, do4
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


def _ptxas(logs: dict) -> dict:
    """chip_smoke.py's ptxas report of each kernel's build log."""
    out = {}
    for kern, path in logs.items():
        if os.path.exists(path):
            with open(path) as f:
                out[kern] = chip_smoke._ptxas_report(f.read())
    return out


def _summary(recs, shape, kernels):
    B, H, T, D, causal = SHAPES[shape]
    med = lambda f: statistics.median(f(r[shape]) for r in recs)  # noqa
    row = {}
    if "flash_fwd" in kernels:
        fwd, lib = med(lambda r: r["flash_fwd"]["ms"]), med(
            lambda r: r["flash_fwd"]["library_ms"])
        bound = chip_smoke.bound("flash_fwd", B * H, T, D, "bfloat16",
                                 causal)[0]
        dev = [r[shape]["flash_fwd"]["device_ms"] for r in recs]
        ldev = [r[shape]["flash_fwd"]["library_device_ms"] for r in recs]
        if None not in dev + ldev:
            row.update({"fwd_device_ms": statistics.median(dev),
                        "fwd_library_device_ms": statistics.median(ldev)})
        row.update({"fwd_ms": fwd, "fwd_library_ms": lib,
                    "fwd_over_library": fwd / lib, "fwd_bound_ms": bound,
                    "fwd_share_of_bound": bound / fwd})
    if "flash_dq" in kernels:
        dq, dkv = med(lambda r: r["flash_dq"]["ms"]), med(
            lambda r: r["flash_dkv"]["ms"])
        lib = med(lambda r: r["library_ms"])
        bounds = [chip_smoke.bound(k, B * H, T, D, "bfloat16", causal)[0]
                  for k in ("flash_dq", "flash_dkv")]
        row.update({"dq_ms": dq, "dkv_ms": dkv, "pair_ms": dq + dkv,
                    "library_ms": lib, "pair_over_library": (dq + dkv) / lib,
                    "pair_bound_ms": sum(bounds),
                    "pair_share_of_bound": sum(bounds) / (dq + dkv)})
    row["all_ok"] = all(r[shape][k]["ok"] for r in recs for k in kernels)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout holding tepdist_tpu_torch/")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--kernels", choices=sorted(KERNELS), default="all")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    missing = [n for n in order if n not in trees]
    if missing:
        raise SystemExit(f"no --tree for {missing}")
    kernels = KERNELS[args.kernels]
    shapes = {s: SHAPES[s] for s in args.shapes.split(",")}
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    runs, failed = {}, []
    for i, name in enumerate(order):
        root = os.path.abspath(trees[name])
        env = dict(os.environ, PYTHONPATH=root)
        try:
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, json.dumps(shapes),
                 json.dumps(kernels)], cwd=root, env=env,
                capture_output=True, text=True, timeout=RUN_SECONDS)
            rc, err = proc.returncode, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, err = "timeout", e.stderr or ""
            if isinstance(err, bytes):  # as Python may give it on a timeout
                err = err.decode(errors="replace")
        if rc:
            sys.stderr.write(err[-4000:])
            print(json.dumps({"run": i, "tree": name, "failed": rc}),
                  flush=True)
            failed.append((name, i))
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        line = {"run": i, "tree": name, "shapes": rec}
        if name not in runs:
            line["ptxas"] = _ptxas(rec.pop("ptxas_logs"))
        else:
            rec.pop("ptxas_logs")
        print(json.dumps(line), flush=True)
        runs.setdefault(name, []).append(rec)
    summary = {name: {s: _summary(recs, s, kernels) for s in shapes}
               for name, recs in runs.items()}
    print(json.dumps({"nvidia_smi": smi, "order": order,
                      "kernels": kernels, "median": summary}), flush=True)
    bad = [(n, s) for n, per in summary.items() for s, r in per.items()
           if not r["all_ok"]]
    if bad:
        print(f"kernels outside the tolerance: {bad}", file=sys.stderr)
    if failed:
        print(f"runs that failed: {failed}", file=sys.stderr)
    return 1 if bad or failed else 0


if __name__ == "__main__":
    sys.exit(main())
