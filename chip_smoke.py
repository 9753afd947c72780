#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tepdist_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path, the single-device GPT-2 1.5B training step
(``plan_training`` + ``plan.step``), on the card, in phases that each print
JSON lines:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile the three flash-attention kernels from ``csrc/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shape and at ragged fp32 and bf16 shapes, with times
   beside the roofline bound and PyTorch's own flash-attention forward and
   backward calls (a yardstick only: the port never calls them);
4. parity: a 2-layer model at full 1.5B width, loss and grads through the
   kernels against the plain versions;
5. slice: GPT-2 1.5B at full width and depth for 6 steps, with per-step
   launch counts of the kernels; the losses must be finite and the sixth
   below the first. A seventh step runs under ``torch.profiler``: device
   time by kernel, the device's busy share, and the flash kernels' time
   with their inputs cold (a measurement, not a check).

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Any failed check raises, so the script exits non-zero before that
line. It exits non-zero when no CUDA device is present or when run outside
the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

# Main-path recipe (bench.py's GPT-2 1.5B headline: attn="flash",
# remat=True, loss_chunk=512, seq 1024, adamw_bf16(1e-4)), with the batch
# and micro count cut from 48 / 16 to fit this script's time limit. Six
# steps: Adam at lr 1e-4 with no warmup overshoots on the third step from
# random weights, then falls again; the JAX package's plan_training does
# the same at this width from 24 layers on (loss_rise_witness.py).
BATCH, MICRO, SEQ, STEPS = 8, 2, 1024, 6
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on the
# CUDA cores (the kernels run no TF32), and HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# fp32 tolerance of a kernel against its plain version: both compute in
# fp32 but sum in another order (atol scaled by the output's magnitude).
FP32_ATOL, FP32_RTOL = 2e-5, 1e-4
TOLERANCE = ("|kernel - plain| <= 2e-5 * max(1, max|ref|) + 1e-4 * |ref| "
             "+ 2 * |plain - plain on fp32 inputs| elementwise")
# Model parity through the kernels vs through the plain versions at bf16:
# the runs differ only where an fp32 result rounds to the other side of a
# bf16 step (2**-8 relative), so hold the loss to 1e-3 relative and each
# gradient leaf to 2e-2 relative L2 (5 bf16 steps).
PARITY_LOSS_RTOL, PARITY_GRAD_RL2 = 1e-3, 2e-2

KERNELS = {
    "flash_fwd": ("tepdist_tpu_torch/csrc/flash_fwd.cu",
                  "tepdist_tpu/ops/pallas/flash_attention.py:29"),
    "flash_dq": ("tepdist_tpu_torch/csrc/flash_dq.cu",
                 "tepdist_tpu/ops/pallas/flash_attention.py:73"),
    "flash_dkv": ("tepdist_tpu_torch/csrc/flash_dkv.cu",
                  "tepdist_tpu/ops/pallas/flash_attention.py:110"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 5):
    """(median, spread): the median over ``windows`` of the mean device
    time of ``fn`` across ``iters`` back-to-back calls, by CUDA events, and
    the windows' (max - min) / median."""
    import torch

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
    median = times[windows // 2]
    return median, (times[-1] - times[0]) / median


def bound(name: str, BH: int, T: int, D: int, dtype: str, causal: bool):
    """(bound_ms, bound_by): the larger of the bytes each input read once
    and each output written once over HBM bandwidth, and the dots' FLOPs
    (2*BH*T^2*D each, halved under causal) over the peak for the type."""
    dots = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[name]
    flops = dots * 2.0 * BH * T * T * D * (0.5 if causal else 1.0)
    slab = BH * T * D * (2 if dtype == "bfloat16" else 4)
    row = BH * T * 4
    # fwd: q, k, v -> o, lse; dq: q, k, v, dO, lse, delta -> dq; dkv: the
    # same inputs -> dk, dv.
    nbytes = {"flash_fwd": 4 * slab + row,
              "flash_dq": 5 * slab + 2 * row,
              "flash_dkv": 6 * slab + 2 * row}[name]
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    from tepdist_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build(KERNELS)
    ptxas = {}
    for name in KERNELS:
        log = _build.library_path(name).with_suffix(".so.log")
        if log.exists():
            ptxas[name] = _ptxas_report(log.read_text())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": seconds, "ptxas": ptxas})


def _ptxas_report(log: str) -> dict:
    """{"<dtype>/D<d>": {"spill_store_bytes": n, "registers": n}} for each
    kernel instantiation in an ``nvcc -Xptxas -v`` log. The tensor-core
    kernels (``*_mma_kernel<D>``) take bf16 only, so they carry no type
    argument."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*kernelI"
                      r"(f|13__nv_bfloat16)?Li(\d+)E", line)
        if m:
            key = f"{'fp32' if m.group(1) == 'f' else 'bf16'}/D{m.group(2)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key:
            out[key] = {"spill_store_bytes": int(m.group(1))}
        m = re.search(r"Used (\d+) registers", line)
        if m and key in out:
            out[key]["registers"] = int(m.group(1))
    return out


def _within(got, ref, ref32):
    """(max abs error, max error over max(1, max|ref32|), within?) of
    |got - ref| <= atol * max(1, max|ref32|) + rtol*|ref32| + 2*|ref - ref32|
    elementwise.

    ``ref32`` is the plain version on fp32-upcast inputs. For fp32 operands
    it equals ``ref`` and the test is the fp32 tolerance. For bf16 operands
    both sides compute in fp32 and round once to bf16, so they can differ by
    one bf16 step where the fp32 value lies near a rounding midpoint; twice
    the plain version's own rounding gap there bounds that step."""
    import torch

    got, ref, ref32 = got.float(), ref.float(), ref32.float()
    scale = max(1.0, ref32.abs().max().item())
    lim = FP32_ATOL * scale + FP32_RTOL * ref32.abs() + 2 * (ref - ref32).abs()
    err = (got - ref).abs()
    return (err.max().item(), err.max().item() / scale,
            bool(torch.all(err <= lim).item()))


def _case(B, H, T, D, dtype, causal, seed, time_it, q_mul=1):
    import torch
    import torch.nn.functional as F

    from tepdist_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    BH = B * H

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rand(BH, T, D) for _ in range(4))
    q = q * q_mul  # a power of two: exact in bf16
    dlse = torch.randn(BH, T, generator=gen, device="cuda")
    scale = 1.0 / math.sqrt(D)
    up = [x.float() for x in (q, k, v, do)]

    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    o_32, lse_32 = fa.flash_fwd_plain(*up[:3], causal, scale)
    delta = ((do.float() * o_ref.float()).sum(-1) - dlse).contiguous()
    bwd_args = (q, k, v, do, lse_ref, delta, causal, scale)
    bwd_32 = (*up, lse_ref, delta, causal, scale)
    dq = fa.flash_dq(*bwd_args)
    dq_ref = fa.flash_dq_plain(*bwd_args)
    dq_32 = fa.flash_dq_plain(*bwd_32)
    dk, dv = fa.flash_dkv(*bwd_args)
    dk_ref, dv_ref = fa.flash_dkv_plain(*bwd_args)
    dk_32, dv_32 = fa.flash_dkv_plain(*bwd_32)
    torch.cuda.synchronize()

    checks = {"flash_fwd": [(o, o_ref, o_32), (lse, lse_ref, lse_32)],
              "flash_dq": [(dq, dq_ref, dq_32)],
              "flash_dkv": [(dk, dk_ref, dk_32), (dv, dv_ref, dv_32)]}
    dt = str(dtype).replace("torch.", "")
    out = {}
    for name, pairs in checks.items():
        errs = [_within(*p) for p in pairs]
        rec = {"max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "tolerance": TOLERANCE, "ok": all(e[2] for e in errs)}
        rec["bound_ms"], rec["bound_by"] = bound(name, BH, T, D, dt, causal)
        out[name] = rec
    if time_it:
        kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal, scale),
                "flash_dq": lambda: fa.flash_dq(*bwd_args),
                "flash_dkv": lambda: fa.flash_dkv(*bwd_args)}
        plain = {"flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, causal,
                                                         scale),
                 "flash_dq": lambda: fa.flash_dq_plain(*bwd_args),
                 "flash_dkv": lambda: fa.flash_dkv_plain(*bwd_args)}
        for name in KERNELS:
            out[name]["ms"], out[name]["ms_spread"] = cuda_ms(kern[name])
            out[name]["plain_ms"], out[name]["plain_ms_spread"] = cuda_ms(
                plain[name], iters=5)
        # Yardstick only: PyTorch's flash-attention forward (O and LSE from
        # q, k, v) and its backward, one call that computes dQ, dK and dV
        # together from (q, k, v, O, LSE, dO); its time stands for the
        # dQ and dK/dV pair. Called directly, so no autograd bookkeeping
        # runs on the host between launches.
        aten = torch.ops.aten
        q4, k4, v4, do4 = (x.view(B, H, T, D) for x in (q, k, v, do))
        lib_fwd = cuda_ms(
            lambda: aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, causal, scale=scale))
        (o4, lse4, cum_q, cum_k, max_q, max_k, seed_, offset
         ) = aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, causal, scale=scale)[:8]
        lib_bwd = cuda_ms(
            lambda: aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, o4, lse4, cum_q, cum_k, max_q, max_k, 0.0,
                causal, seed_, offset, scale=scale))
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in
                      (q4, k4, v4))
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        autograd_bwd = cuda_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), do4, retain_graph=True))
        fwd = out["flash_fwd"]
        fwd["library_ms"], fwd["library_ms_spread"] = lib_fwd
        for name in ("flash_dq", "flash_dkv"):
            out[name]["library_ms"], out[name]["library_ms_spread"] = lib_bwd
            out[name]["library_call"] = "dQ, dK and dV in one call"
            # SDPA's backward through autograd, read beside the direct call:
            # the gap is autograd's host work between launches.
            (out[name]["sdpa_autograd_backward_ms"],
             out[name]["sdpa_autograd_backward_ms_spread"]) = autograd_bwd
    return out


def phase_kernels():
    import torch

    mb = BATCH // MICRO
    cases = [
        ("main_path", dict(B=mb, H=25, T=SEQ, D=64, dtype=torch.bfloat16,
                           causal=True), True),
        ("ragged_causal", dict(B=2, H=4, T=100, D=16, dtype=torch.float32,
                               causal=True), False),
        ("ragged_full", dict(B=2, H=4, T=100, D=16, dtype=torch.float32,
                             causal=False), False),
        # The bf16 tensor-core path at a ragged edge.
        ("ragged_bf16_causal", dict(B=2, H=4, T=100, D=64,
                                    dtype=torch.bfloat16, causal=True),
         False),
        ("ragged_bf16_full", dict(B=2, H=4, T=257, D=128,
                                  dtype=torch.bfloat16, causal=False),
         False),
        # q times 8: the scores spread over about +-30, so the forward's
        # running max rises across key tiles and its rescaling by
        # exp(m - m_new) carries the result.
        ("large_bf16_causal", dict(B=2, H=4, T=300, D=64,
                                   dtype=torch.bfloat16, causal=True,
                                   q_mul=8), False),
    ]
    results = {}
    for i, (label, shape, time_it) in enumerate(cases):
        res = _case(**shape, seed=100 + i, time_it=time_it)
        shown = {k: (str(v).replace("torch.", "") if k == "dtype" else v)
                 for k, v in shape.items()}
        emit({"phase": "kernels", "case": label, "shape": shown,
              "results": res})
        bad = [n for n, r in res.items() if not r["ok"]]
        if bad:
            raise SystemExit(f"chip_smoke: {bad} disagree with their plain "
                             f"versions at {label}")
        results[label] = res
    return results["main_path"]


def _plain_attention(q, k, v):
    """Causal attention through the plain versions of all three kernels,
    with the same autograd structure as the port's ``_Flash`` (the parity
    reference)."""
    import torch

    from tepdist_tpu_torch.ops import flash_attention as fa

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.scale = scale
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            do = do.contiguous()
            delta = (do.float() * o.float()).sum(-1)
            args = (q, k, v, do, lse, delta, True, ctx.scale)
            dk, dv = fa.flash_dkv_plain(*args)
            return fa.flash_dq_plain(*args), dk, dv, None

    B, H, T, D = q.shape
    flat = [x.reshape(B * H, T, D).contiguous() for x in (q, k, v)]
    o = PlainFlash.apply(*flat, 1.0 / math.sqrt(D))
    return o.reshape(B, H, T, D)


def _config(n_layer: int):
    from tepdist_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.CONFIGS["1.5B"], n_layer=n_layer,
                               attn="flash", remat=True, loss_chunk=512)


def phase_parity():
    import torch

    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.models import gpt2

    cfg = _config(2)
    params = gpt2.stacked_init_params(cfg, seed=1, device="cuda")
    tokens = gpt2.fake_batch(cfg, BATCH // MICRO, SEQ, seed=2, device="cuda")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]

    def run(attn_impl):
        loss = gpt2.loss_fn_stacked(params, tokens, cfg, attn_impl)
        return loss.item(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = run(None)
    loss_p, grads_p = run(_plain_attention)
    rel = [((a.float() - b.float()).norm() /
            b.float().norm().clamp_min(1e-30)).item()
           for a, b in zip(grads_k, grads_p)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "parity", "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
          "tokens": list(tokens.shape), "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_rel_err": loss_rel,
          "grad_max_rel_l2": max(rel), "loss_rtol": PARITY_LOSS_RTOL,
          "grad_rel_l2_tol": PARITY_GRAD_RL2})
    if not (finite and math.isfinite(loss_k) and loss_rel <= PARITY_LOSS_RTOL
            and max(rel) <= PARITY_GRAD_RL2):
        raise SystemExit("chip_smoke: kernel and plain model runs disagree")


def phase_slice():
    import torch

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.train import plan_training

    cfg = _config(48)
    t0 = time.perf_counter()
    params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, BATCH, SEQ, seed=0, device="cuda")
    plan = plan_training(lambda p, t: gpt2.loss_fn_stacked(p, t, cfg),
                         adamw_bf16(1e-4), params, tokens,
                         num_micro_batches=MICRO)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    L, M = cfg.n_layer, MICRO
    want = {"flash_fwd": 2 * L * M, "flash_dq": L * M, "flash_dkv": L * M}
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, per_step = [], [], []
    fa.reset_launch_counts()
    for _ in range(STEPS):
        before = dict(fa.launch_counts)
        t0 = time.perf_counter()
        losses.append(plan.step(tokens))   # returns after a device sync
        seconds.append(time.perf_counter() - t0)
        per_step.append({n: fa.launch_counts[n] - before[n] for n in want})
    launches = dict(fa.launch_counts)
    tokens_per_step = BATCH * SEQ
    steady = seconds[1:]
    emit({"phase": "slice", "model": "GPT-2 1.5B",
          "n_params": gpt2.num_params(cfg), "n_layer": L,
          "n_embd": cfg.n_embd, "n_head": cfg.n_head, "seq": SEQ,
          "batch": BATCH, "micro_batches": M,
          "cut": "batch 48 -> 8 and micro batches 16 -> 2 (bench.py recipe)",
          "setup_seconds": setup_s, "losses": losses,
          "step_seconds": seconds,
          "tokens_per_s": tokens_per_step * len(steady) / sum(steady),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches_per_step": per_step, "expected_per_step": want})
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: loss did not fall {losses}")
    if any(step != want for step in per_step):
        raise SystemExit(f"chip_smoke: launches {per_step} != {want}")
    _profile_step(plan, tokens, sorted(steady)[len(steady) // 2])
    return launches


# Device-time groups of the profiled step, by kernel name (first match).
PROFILE_GROUPS = (
    ("flash attention", r"\btepdist::flash_"),
    ("matmul", r"gemm|nvjet|cutlass|xmma"),
    ("copy and cast", r"copy|Memcpy|Memset"),
    ("elementwise", r"elementwise"),
    ("reduction", r"reduce"),
)


def _is_device_activity(event) -> bool:
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind in ("kernel", "gpu_memcpy", "gpu_memset")
    return (str(event.device_type).endswith("CUDA")
            and not getattr(event, "is_user_annotation", False))


def _profile_step(plan, tokens, step_s: float) -> None:
    """One more step, after the checked ones, under ``torch.profiler``
    (CPU and CUDA activities): device time by kernel name (top 15) and by
    kind, the device's busy share of the profiled step (whose host work
    the profiler slows) and the device time over ``step_s``, the median
    unprofiled step, and the flash kernels' summed time with their inputs
    as the step leaves them (cold from the QKV matmul, where the kernels
    phase times them warm in L2). A measurement, not a check: a profiler
    that records no device time is reported and the run goes on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    label = "chip_smoke_step"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            plan.step(tokens)
    events = prof.events()
    window = next(e for e in events if e.name == label
                  and not _is_device_activity(e))
    w0, w1 = window.time_range.start, window.time_range.end
    spans, by_name = [], {}
    for e in events:
        if not _is_device_activity(e):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (t1 - t0) / 1e3
        rec[1] += 1
    if not spans:
        emit({"phase": "profile", "device_ms": None,
              "note": "the profiler recorded no device time; kernel times "
                      "stand only from the kernels phase (CUDA events)"})
        return
    busy_us, end = 0.0, w0
    for t0, t1 in sorted(spans):
        t0, t1 = max(t0, end), min(t1, w1)
        if t1 > t0:
            busy_us += t1 - t0
            end = t1
    flash = {}
    for name in KERNELS:
        hits = [rec for kname, rec in by_name.items()
                if re.search(rf"\b{name}_(mma_)?kernel\b", kname)]
        ms, n = sum(r[0] for r in hits), sum(r[1] for r in hits)
        flash[name] = {"ms": ms, "launches": n,
                       "mean_ms": ms / n if n else None}
    groups = {}
    for kname, (ms, n) in by_name.items():
        group = next((g for g, pattern in PROFILE_GROUPS
                      if re.search(pattern, kname)), "other")
        rec = groups.setdefault(group, {"ms": 0.0, "launches": 0})
        rec["ms"] += ms
        rec["launches"] += n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    device_ms = sum(r[0] for r in by_name.values())
    emit({"phase": "profile", "window_ms": (w1 - w0) / 1e3,
          "device_ms": device_ms,
          "device_busy_share": busy_us / (w1 - w0),
          "device_ms_over_median_step": device_ms / (step_s * 1e3),
          "flash_kernels": flash, "groups": groups,
          "top_kernels": [{"name": n[:160], "ms": r[0], "launches": r[1]}
                          for n, r in top]})


def main() -> int:
    try:
        import torch
        import tepdist_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: {e}; run from the repository root",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    phase_build()
    main_case = phase_kernels()
    phase_parity()
    launches = phase_slice()
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = main_case[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
