#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tepdist_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's paths on the card through the entry points a user
calls (``plan_training`` + ``plan.step``, ``plan.save``/``restore``,
``sampling.sample``), in phases that each print JSON lines:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile the three flash-attention kernels from ``csrc/``, and
   the host-side telemetry rings and task-scheduler core;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the GPT-2 path's shape [4*25, 1024, 64], at the Llama path's
   [4*16, 512, 128], at the remat phase's [8*25, 1024, 64] and at ragged
   fp32 and bf16 shapes (every bf16 head dim), with times beside
   the roofline bound and PyTorch's own flash-attention forward and
   backward calls (a yardstick only: the port never calls them); dQ and
   dK/dV run twice on the same inputs and must give the same bits;
4. parity: a 2-layer model at full 1.5B width, loss and grads through the
   kernels against the plain versions;
5. slice: GPT-2 1.5B at full width and depth for 6 steps, with per-step
   launch counts of the kernels; the losses must be finite and the sixth
   below the first. A seventh step runs under ``torch.profiler``: device
   time by kernel, the device's busy share, and the flash kernels' time
   with their inputs cold (a measurement, not a check);
5b. plan: the same model at bench.py's batch 48 x 1024, uncut, through
   ``plan_training`` with no micro count: the step is captured on fake
   tensors (the capture seconds; device memory before and after, which
   must be equal; the graph's nodes, its flash ops, 2L forward and L of
   each backward kernel, and its flops beside 8 N tokens), the sync-free
   analysis sizes M (fraction, peak estimate, budget), and 6 steps train
   at that M (sixth loss below the first, launches 2LM / LM / LM a step,
   peak memory beside the estimate and the card's memory); should the
   default budget's M not fit, the phase says so and sizes M again with
   HBM_GB set to the memory free beside the state. A seventh step is
   profiled as the slice's is. Then each kernel against its plain
   version at the plan's shape [48/M*25, 1024, 64];
5c. spmd_plan: the same model at full width (depth cut, SPMD_PLAN_CUT)
   planned for 8 devices on the host, device-free: ``explore_parallelism``
   (capture and search seconds, candidates per topology, the kinds left
   out, the winner with its predicted step and memory feasibility, the
   solver status per axis), then ``auto_parallel`` of the whole GA step
   on data=8, which must split the token input and q, k and v of every
   flash forward on dim 0;
5d. spmd_step: the plan phase's model, recipe, seed and batches through
   the lowering: ``plan_training(topology=data 1)`` on a one-rank NCCL
   world captures the whole GA step, plans it and runs it as an fx
   interpreter on DTensors, the kernels launched through their ops; 6
   steps with losses within SPMD_STEP_LOSS_RTOL of the eager plan's, the
   sixth below the first, every kernel launched; step seconds, peak
   memory and the involuntary-remat count;
5d2. rpc: the same recipe through the service: ``TepdistSession.
   compile_training`` (capture on fake tensors, the graph's nodes and
   bytes, encode and decode seconds, the state's literals' bytes and
   GB/s) -> ``BuildExecutionPlan`` (planner seconds) on a
   ``TepdistServicer`` holding the card, reached through ``inproc:`` ->
   6 ``ExecutePlan`` steps (seconds beside spmd_step's, the servicer's
   host time outside the lowered step, losses within SPMD_STEP_LOSS_RTOL
   of the eager plan's, the sixth below the first, launches 2LM / LM / LM
   a step, peak memory); a ``DoRemoteSave`` after step 3 and a
   ``DoRemoteRestore`` into the same servicer, whose step 4 repeats its
   loss bit for bit;
5e. pipeline: the same model, recipe, seed and batches through the task-
   graph pipeline, ``plan_training(num_stages=4, num_micro_batches=8,
   devices=[cuda:0] * 4)``: the forward loss captured at micro-batch
   shapes (seconds), the stage ILP (seconds, status), nodes and flop share
   per stage, cross-stage bytes, tasks by type, ``plan_verify`` (no
   finding), the native scheduler (loaded, equal to the Python
   simulation), the schedule's policy, window and predicted makespan and
   bubble for four devices (the four stages share the one card), then 6
   steps: losses within PIPELINE_LOSS_RTOL of the plan phase's, the sixth
   below the first, launches 2LM / LM / LM a step (768 / 384 / 384), step
   seconds, peak memory, the seconds in each kind of task body of a
   traced seventh step (no profiled step: it made room for the examples
   and tools phases; its earlier reading stays in PERF.md); then each
   kernel against its plain version at the pipeline's micro batch
   [6*25, 1024, 64];
5e2. pipeline_dp: the same model, seed and batches as 2 stages x 2
   intra-stage data replicas over [cuda:0] * 4 (``plan_training(
   num_stages=2, num_micro_batches=8, devices=[cuda:0] * 4)``) for 3
   steps, then its captured program with ZeRO in a new
   ``PipelineExecutable`` for 3: losses within
   PIPELINE_LOSS_RTOL of the pipeline phase's (ZeRO: of the plain run's),
   launches 2LMR / LMR / LMR a step (1536 / 768 / 768), the predicted
   makespan and bubble, step seconds, peak memory (no profiled step:
   its earlier reading stays in PERF.md); then each kernel at a
   replica's micro batch [3*25, 1024, 64];
5e3. collective: GPT-2 1.5B's 48 blocks as 4 stages of the collective
   pipeline over [cuda:0] * 4 (``gpt2.pipelined_loss_fn``, batch 12 in 4
   micro batches of 3 rows): the loss against ``loss_fn_stacked`` on the
   same weights and batch and each gradient leaf against the eager
   one's (the parity phase's bounds), launches 2LM / LM / LM;
5f. seq_kernels: attention alone at Llama 1B's heads (16 after the GQA
   repeat, head_dim 128), bf16 causal, 1 x 16384 tokens, split over
   [cuda:0] * 4 in the one-process form: the ring and Ulysses (flash
   inner) against one whole-sequence call of the kernels (o, LSE, dQ, dK,
   dV; SEQ_TOLERANCE), their launches per call (the ring: 4 causal and 6
   full hops of [16, 4096, 128] each way; Ulysses 4 of [4, 16384, 128])
   and the three timed by CUDA events; then each kernel at the hop shape,
   causal and full, against its plain version;
5g. seq_step: the slice phase's model, recipe, seed and batches with the
   flash ring over [cuda:0] * 4 as attention (hops of [4*25, 256, 64])
   through ``plan_training``: 6 steps, losses within SEQ_STEP_LOSS_RTOL of
   the slice's, 2*L*M*10 forward and L*M*10 dQ and dK/dV launches a step,
   step seconds beside the slice's, peak memory (no profiled step: its
   earlier reading stays in PERF.md); then the kernels at that hop
   shape, causal and full;
5h. seq_plan: Llama 1B's width cut to 2 layers, batch 1 x 16384, planned
   for 8 devices on the host: ``explore`` with its sequence candidates
   (each priced, ring or Ulysses, the winner, the search seconds), then
   the loss rewritten for a seq axis of 4 and planned on data 2 x seq 4,
   which must hold a sequence op for every flash forward and no flash
   forward;
6. llama: Llama 1B at full width and depth (bench.py's recipe: batch 4,
   seq 512, ``adamw(1e-4)``) for 6 steps on the bytes of the repository's
   text files, packed with ``data/tokens.py`` and fed through the
   ``DevicePrefetcher``; finite losses, the sixth below the first, and
   16 launches of each kernel a step, and a seventh step profiled as the
   slice's is. After step 3 the plan saves a checkpoint (``block=False``,
   then joined);
7. checkpoint: a plan from other random weights restores that checkpoint;
   every leaf must equal the saved one bit for bit and its step 4 the
   uninterrupted step 4's loss bit for bit;
8. remat: GPT-2 at 1.5B width and 4 layers, one forward and backward under
   no remat and each policy: grads within the parity bounds of no
   remat's, the flash forward launched 2L times under ``full``, ``dots``
   and ``dots_no_batch`` and L times under ``save_attn`` and no remat, the
   memory the forward keeps and the forward's peak each ordered no remat
   > dots > save_attn > full, and the step's peak no remat > dots >=
   save_attn, full. Each policy runs once more with the backward's memory
   read at every autograd node, which locates the step's peak;
9. sampling: GPT-2 1.5B at full width and depth; in fp32 with TF32 off, 32
   greedy tokens after 8 prompts of 64 must equal the argmax of the full
   forward at every generated position; the same generation timed in bf16;
10. models: one ``plan_training`` step each of gpt_moe ``base-8e`` and Wide
   ResNet ``CONFIGS[0]`` (bench.py's recipes), with finite losses;
11. telemetry (after the build): the telemetry core's native rings, built
   beside the kernels, must have loaded; ns per enabled span and per
   counter increment over 10^5 calls;
12. serving: GPT-2 1.5B at full width and depth through the paged
   ``ServingEngine`` (chunked prefill, prefix cache, a cancel, a sampled
   request): fp32 tokens equal to ``sample()`` and to a slot-mode engine,
   then a timed bf16 run (statuses, zero pages after drain, prefix hits,
   the TTFT histogram's count, no flash launch; its trace is written to
   ``chiprun_out/serving_trace.json``), then the ``ServingSupervisor``
   at 8 layers restarting once on an injected decode fault and delivering
   every request exactly once with the uninterrupted run's tokens;
13. serve_fleet (after serve_rpc): fleet serving on card 0 (comment at
   SHARD_*): GPT-2 1.5B in fp32 at full width, depth cut to SHARD_LAYERS,
   loaded through ``load_fleet_servable`` over two servicers with a KV
   budget that overflows one card, so it is split by the shard planner;
   its greedy tokens equal ``sample()``'s bit for bit. Then
   ``FleetRouter`` prefill and decode pools at full depth on the serving
   schedule: fp32 tokens equal the serving phase's engine's, bf16 timed
   (TTFT, handoff ms, pages moved, affinity hits, no page leaked). Last,
   ``tools/torch_fidelity_report.py --trace`` on the merged trace the
   fleet phase dumped of its unfaulted step: the fitted constants and the
   step error before and after calibration.

14. examples (after serve_fleet): the user's entry points called through
   their ``main(argv)``: ``examples_torch/llama/train.py --config 1B
   --attn flash --batch 4 --seq 512 --steps 6`` (full width and depth,
   ``auto_parallel`` on data = 1 lowered to DTensor; planner seconds, step
   seconds, 16 launches of each kernel a step), ``examples_torch/GPT2/
   main.py --steps 6`` with a copy of ``examples_torch/GPT2/1.5B.json``
   cut to 8 layers (EXAMPLE_GPT2_CUT; batch 8 x 512, einsum, bf16, full
   width; planner seconds, peak memory, no flash launch) and ``examples_torch/smoke_testing/simple.py --steps 3``
   through a ``TepdistServicer`` on the card at an ``inproc:`` address
   reached by ``SERVER_IP``/``SERVER_PORT``; finite losses, the last below
   the first (simple.py's falling each step);
15. tools: ``tools/torch_chaos_run.py``'s fleet, ``--kill-worker`` and
   ``--serve`` arms on in-process workers on the card, each passing its
   own assertion, and ``tools/torch_serve_load.py --config 1.5B
   --workers 2`` (every request done; TTFT p50 / p99, tokens/s); then
   the perf gate (``tools/torch_perf_gate.py``) on this run's own
   numbers: serve_fleet's disagg TTFT and KV handoff p50, the
   kill-worker arm's migration stall and the int8 wire ratio of
   ``encode_literal`` on card tensors, recorded three times into a
   history under ``chiprun_out/``; ``--check`` must pass and a seeded
   regression of each key must trip it.
16. explore_tools (last): a ``TepdistServicer`` over ``[cuda:0] * 4``
   behind ``inproc:`` explores GPT-2 1.5B width at 4 layers for a session
   with no mesh axes (SPMD meshes over its one-rank world, pipeline cuts
   over its device list), builds its pipeline winner and trains 3 steps
   (the third loss below the first, every flash kernel launched); then
   the read-only tools on this run's files: ``torch_plan_explain --trace
   --check`` on the phase's trace, ``torch_trace_summary`` and
   ``torch_ledger_report --trace`` on the fleet phase's traced step,
   ``torch_request_trace --trace`` on serve_rpc's trace, and
   ``torch_verify_plan``'s report on the pipeline phase's program (no
   finding). A tool that fails fails the run.

Then one ``{"kernels": [...]}`` line (a row for each kernel at each
path's shape) and, last, the ``{"ok": true, ...}`` line. Every JSON line
is also written to ``chiprun_out/chip_smoke.jsonl``. Any failed check
raises, so the script exits non-zero before that line. It exits non-zero
when no CUDA device is present or when run outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# Llama path (bench.py's bench_llama: Llama 1B, flash, batch 4, seq 512,
# adamw(1e-4), one micro batch), nothing cut; a checkpoint after step 3.
LLAMA_BATCH, LLAMA_SEQ, LLAMA_STEPS, LLAMA_SAVE_AT = 4, 512, 6, 3
# The repository's own text, packed as byte tokens (nothing is downloaded).
TEXT_FILES = ("SURVEY.md", "PAPER.md", "DESIGN.md")
# Remat phase: GPT-2 at 1.5B width, cut to 4 layers (the slice phase runs
# all 48), batch 8 in one micro batch.
REMAT_LAYERS, REMAT_BATCH = 4, 8
REMAT_POLICIES = (None, "full", "dots", "dots_no_batch", "save_attn")
# Sampling phase: 8 prompts of 64 tokens, 32 new tokens.
SAMPLE_BATCH, SAMPLE_PROMPT, SAMPLE_NEW = 8, 64, 32
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


# Output directory (git-ignored). Every emitted line is also appended to
# LOG_PATH there, for consoles that keep only the end of a long output;
# main() starts the file afresh.
OUT_DIR = "chiprun_out"
LOG_PATH = os.path.join(OUT_DIR, "chip_smoke.jsonl")


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG_PATH, "a") as f:
        f.write(line + "\n")


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

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    """The three CUDA kernels with nvcc, one process each, and beside them
    the telemetry core's native rings (``telemetry/_fastobs.c``) and the
    task scheduler's core (``native/scheduler.cc``) with the host
    compilers; a failed build of any fails the run."""
    import threading

    from tepdist_tpu_torch import native
    from tepdist_tpu_torch.ops import _build
    from tepdist_tpu_torch.telemetry import _fastobs

    fastobs = {}

    def build_fastobs():
        t = time.perf_counter()
        fastobs["loaded"] = _fastobs.load() is not None
        fastobs["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        fastobs["sched_loaded"] = native.native_available()
        fastobs["sched_seconds"] = time.perf_counter() - t

    t0 = time.perf_counter()
    host = threading.Thread(target=build_fastobs)
    host.start()
    seconds = _build.build(KERNELS)
    host.join()
    if not fastobs["loaded"]:
        raise SystemExit("chip_smoke: telemetry/_fastobs.c did not build "
                         "or load (the warning above says why)")
    if not fastobs["sched_loaded"]:
        raise SystemExit("chip_smoke: native/scheduler.cc did not build or "
                         "load (the warning above says why)")
    seconds["_fastobs"] = fastobs["seconds"]
    seconds["_scheduler"] = fastobs["sched_seconds"]
    ptxas = {}
    for name in KERNELS:
        log = _build.library_path(name).with_suffix(".so.log")
        if log.exists():
            ptxas[name] = _ptxas_report(log.read_text())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": seconds, "ptxas": ptxas})


def _ptxas_report(log: str) -> dict:
    """{"<dtype>/D<d>": {"kernel": name, "spill_store_bytes": n,
    "registers": n}} for each kernel instantiation in an ``nvcc -Xptxas
    -v`` log, with "wgmma_serialized": ptxas's reason where it serialized
    the instantiation's wgmmas (a kernel that keeps its products in flight
    loses that overlap). The bf16 kernels (``flash_fwd_sm90_kernel<D>``,
    ``flash_dq_sm90_kernel<D>``, ``flash_dkv_sm90_kernel<D>``) take bf16
    only, so they carry no type argument. The Hopper kernels' registers
    are those a thread has at launch (168: whole warpgroups), before
    setmaxnreg gives the consumers 240."""
    out, key = {}, None
    entry = (r"'_ZN\d+tepdist\d+(\w+?_kernel)I(f|13__nv_bfloat16)?"
             r"Li(\d+)E")
    for line in log.splitlines():
        m = re.search(r"wgmma.mma_async instructions are serialized due to "
                      r"(.*) in the function " + entry, line)
        if m:
            k = f"{'fp32' if m.group(3) == 'f' else 'bf16'}/D{m.group(4)}"
            out.setdefault(k, {"kernel": m.group(2)})[
                "wgmma_serialized"] = m.group(1)
            continue
        m = re.search(r"Compiling entry function " + entry, line)
        if m:
            key = f"{'fp32' if m.group(2) == 'f' else 'bf16'}/D{m.group(3)}"
            out.setdefault(key, {"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key:
            out[key]["spill_store_bytes"] = int(m.group(1))
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
    # Each output element is summed by one CTA in a fixed order, so a
    # second call on the same inputs gives the same bits (the bit-exact
    # checks of resume and of stage x TP against one card rest on it).
    o_again, lse_again = fa.flash_fwd(q, k, v, causal, scale)
    dq_again = fa.flash_dq(*bwd_args)
    dk_again, dv_again = fa.flash_dkv(*bwd_args)
    torch.cuda.synchronize()
    same = {"flash_fwd": torch.equal(o, o_again) and torch.equal(
                lse, lse_again),
            "flash_dq": torch.equal(dq, dq_again),
            "flash_dkv": torch.equal(dk, dk_again) and torch.equal(
                dv, dv_again)}

    checks = {"flash_fwd": [(o, o_ref, o_32), (lse, lse_ref, lse_32)],
              "flash_dq": [(dq, dq_ref, dq_32)],
              "flash_dkv": [(dk, dk_ref, dk_32), (dv, dv_ref, dv_32)]}
    dt = str(dtype).replace("torch.", "")
    out = {}
    for name, pairs in checks.items():
        errs = [_within(*p) for p in pairs]
        rec = {"max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "tolerance": TOLERANCE,
               "ok": all(e[2] for e in errs) and same[name],
               "deterministic": same[name]}
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
        # The Llama path: H = 16 query heads after the GQA repeat, D = 128.
        ("llama_path", dict(B=LLAMA_BATCH, H=16, T=LLAMA_SEQ, D=128,
                            dtype=torch.bfloat16, causal=True), True),
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
        # The remat phase: GPT-2 heads, the whole batch in one micro batch.
        ("remat_path", dict(B=REMAT_BATCH, H=25, T=SEQ, D=64,
                            dtype=torch.bfloat16, causal=True), True),
        # The narrow bf16 head dims, held by the Hopper backward as 64
        # columns with the rest zero-filled by TMA.
        ("ragged_bf16_d16", dict(B=2, H=4, T=100, D=16,
                                 dtype=torch.bfloat16, causal=True), False),
        ("ragged_bf16_d32", dict(B=2, H=4, T=257, D=32,
                                 dtype=torch.bfloat16, causal=False), False),
    ]
    results = {label: _checked_case(label, shape, 100 + i, time_it)
               for i, (label, shape, time_it) in enumerate(cases)}
    return results["main_path"], results["llama_path"], results["remat_path"]


def _checked_case(label, shape, seed, time_it):
    """One kernels-phase case: each kernel against its plain version at
    ``shape`` (and timed when ``time_it``), emitted; fails the run on a
    disagreement."""
    res = _case(**shape, seed=seed, time_it=time_it)
    shown = {k: (str(v).replace("torch.", "") if k == "dtype" else v)
             for k, v in shape.items()}
    emit({"phase": "kernels", "case": label, "shape": shown,
          "results": res})
    bad = [n for n, r in res.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {bad} disagree with their plain "
                         f"versions at {label}")
    return res


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
    _profile_step("GPT-2 1.5B", lambda: plan.step(tokens),
                  sorted(steady)[len(steady) // 2])
    return launches, losses, seconds


# Plan phase: the same model and recipe at bench.py's batch, uncut (48 x
# 1024 tokens), with the micro count left to the sync-free analysis.
PLAN_BATCH = 48


def phase_plan():
    """GPT-2 1.5B at full width and depth, bench.py's recipe uncut:
    ``plan_training`` with no micro count captures the loss-and-grad step
    on fake tensors (no device memory), sizes M from the sync-free
    analysis, then trains 6 steps at that M. Returns the kernels' launches
    over the 6 steps and the micro batch size (the kernels' shape)."""
    import torch

    from tepdist_tpu_torch import train
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.graph import cost
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.performance_utils import chip_spec

    torch.cuda.empty_cache()
    cfg = _config(48)
    L = cfg.n_layer
    params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0, device="cuda")
    capture = {}
    trace_graph = train.trace_graph

    def timed_trace(*args):
        torch.cuda.synchronize()
        capture["allocated_before"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = trace_graph(*args)
        capture["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        capture["allocated_after"] = torch.cuda.memory_allocated()
        capture["graph"] = out[0]
        return out

    def make_plan():
        train.trace_graph = timed_trace
        try:
            return train.plan_training(
                lambda p, t: gpt2.loss_fn_stacked(p, t, cfg),
                adamw_bf16(1e-4), params, tokens, num_micro_batches=None)
        finally:
            train.trace_graph = trace_graph

    def run(plan):
        M = plan.sync_free.num_micro_batches
        want = {"flash_fwd": 2 * L * M, "flash_dq": L * M,
                "flash_dkv": L * M}
        torch.cuda.reset_peak_memory_stats()
        losses, seconds, per_step = [], [], []
        fa.reset_launch_counts()
        for _ in range(STEPS):
            before = dict(fa.launch_counts)
            t0 = time.perf_counter()
            losses.append(plan.step(tokens))   # returns after a device sync
            seconds.append(time.perf_counter() - t0)
            per_step.append({n: fa.launch_counts[n] - before[n]
                             for n in want})
        return want, losses, seconds, per_step, dict(fa.launch_counts)

    t0 = time.perf_counter()
    plan = make_plan()
    setup_s = time.perf_counter() - t0
    default_budget = chip_spec().hbm_gb * 1e9 * 0.6
    override = None
    try:
        want, losses, seconds, per_step, launches = run(plan)
    except torch.cuda.OutOfMemoryError as e:
        # A finding, not a tuning: the default budget ignores the state's
        # bytes. Size M again against the memory left beside the state.
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0]
        override = {"error": str(e).splitlines()[0][:200],
                    "failed_micro_batches":
                        plan.sync_free.num_micro_batches,
                    "hbm_gb": free / 1e9,
                    "note": "HBM_GB set to the card's free memory after "
                            "the state was placed"}
        del plan
        torch.cuda.empty_cache()
        ServiceEnv.reset({"HBM_GB": str(free / 1e9)})
        try:
            plan = make_plan()
            want, losses, seconds, per_step, launches = run(plan)
        finally:
            ServiceEnv.reset()
    res, graph = plan.sync_free, capture["graph"]
    M = res.num_micro_batches
    n_params = gpt2.num_params(cfg)
    tokens_per_step = PLAN_BATCH * SEQ
    steady = seconds[1:]
    emit({"phase": "plan", "model": "GPT-2 1.5B", "n_params": n_params,
          "n_layer": L, "n_embd": cfg.n_embd, "n_head": cfg.n_head,
          "seq": SEQ, "batch": PLAN_BATCH, "cut": "none",
          "capture_seconds": capture["seconds"],
          "allocated_before_capture": capture["allocated_before"],
          "allocated_after_capture": capture["allocated_after"],
          "graph_nodes": len(graph),
          "graph_flash_ops": {n: graph.count(n) for n in KERNELS},
          "total_flops": graph.total_flops(),
          "matmul_flops": sum(n.flops for n in graph.nodes
                              if n.prim in cost.MATMULS),
          "full_remat_flops_8NT": 8.0 * n_params * tokens_per_step,
          "batch_dims": {str(k): v for k, v in res.batch_dims.items()},
          "sync_free_fraction": res.sync_free_fraction,
          "peak_estimate_bytes": res.peak_activation_bytes,
          "budget_bytes": (override["hbm_gb"] * 1e9 * 0.6 if override
                           else default_budget),
          "default_budget_bytes": default_budget,
          "hbm_override": override,
          "micro_batches": M, "topology": str(plan.topology),
          "setup_seconds": setup_s, "losses": losses,
          "step_seconds": seconds,
          "tokens_per_s": tokens_per_step * len(steady) / sum(steady),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "card_memory_bytes": torch.cuda.get_device_properties(0)
          .total_memory,
          "launches_per_step": per_step, "expected_per_step": want})
    if capture["allocated_after"] != capture["allocated_before"]:
        raise SystemExit("chip_smoke: the capture allocated device memory")
    if graph.count("flash_fwd") != 2 * L or graph.count("flash_dq") != L \
            or graph.count("flash_dkv") != L:
        raise SystemExit("chip_smoke: the captured graph does not hold the "
                         "flash ops of every layer")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: loss did not fall {losses}")
    if any(step != want for step in per_step):
        raise SystemExit(f"chip_smoke: launches {per_step} != {want}")
    _profile_step("GPT-2 1.5B plan", lambda: plan.step(tokens),
                  sorted(steady)[len(steady) // 2])
    return launches, PLAN_BATCH // M, losses


# spmd_plan phase: the SPMD search for 8 devices (the reference test
# mesh's size) runs on the card's host, device-free. Its depth is cut: the
# search prices every node of the captured step once per mesh axis and
# candidate, and at 48 layers the exploration alone took 792 s on the
# H100 machine's host (PERF.md section 6), two thirds of this script's
# 1200 s limit. At 4 layers, with the pipeline kind priced too, it took
# 122.6 s; 2 layers make room for the pipeline_dp and collective phases.
SPMD_PLAN_DEVICES, SPMD_PLAN_LAYERS = 8, 2
SPMD_PLAN_CUT = ("depth cut from 48 to 2 layers: at 48 the exploration "
                 "alone took 792 s of the run's 1200 s limit")
# spmd_step phase: the lowered step against the plan phase's eager
# losses (same seed and batches). The capture runs the models' GELU as its
# chain of primitives where the eager step runs the fused op, so bf16
# values round at other points: the parity phase holds one such step's
# loss to 1e-3 relative; over six Adam steps allow twice that.
SPMD_STEP_LOSS_RTOL = 2e-3


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_spmd_plan():
    """GPT-2 1.5B at full width (depth cut, SPMD_PLAN_CUT), bench.py's
    batch 48 x 1024: ``explore_parallelism`` over the SPMD candidates for
    8 devices, then ``auto_parallel`` in cost mode of the whole GA step
    (optimizer apply included) on ``MeshTopology([("data", 8)])``. Both
    plan on the card's host from fake tensors; nothing runs on 8 devices.
    The data-8 plan must split the token input and q, k and v of every
    flash forward on dim 0."""
    import torch

    from tepdist_tpu_torch import train
    from tepdist_tpu_torch.core.dist_spec import DimStrategy
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.parallel.exploration import candidate_summary
    from tepdist_tpu_torch.parallel.performance_utils import chip_spec
    from tepdist_tpu_torch.parallel.sync_free import build_ga_step

    cfg = _config(SPMD_PLAN_LAYERS)
    params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0, device="cuda")

    def loss_fn(p, t):
        return gpt2.loss_fn_stacked(p, t, cfg)

    t0 = time.perf_counter()
    best = train.explore_parallelism(loss_fn, params, tokens,
                                     n_devices=SPMD_PLAN_DEVICES)
    explore_s = time.perf_counter() - t0
    phases = (best.get("report") or {}).get("phases", {})
    per_topology = {}
    for c in best["candidates"]:
        key = (str(c["topology"]) if "topology" in c
               else f"pipeline S={c['num_stages']}")
        per_topology[key] = per_topology.get(key, 0) + 1
    status = {str(c["topology"]): [g.ilp_status for g in c["strategies"]]
              for c in best["candidates"]
              if not c.get("comm_dtype") and not c.get("zero")
              and "strategies" in c}
    # The pipeline stage cuts (ROADMAP item 13b), priced by the task
    # scheduler's simulation: the best of each (S, M, tp, placement).
    pipe_best = {}
    for c in best["candidates"]:
        if c["kind"] != "pipeline":
            continue
        key = (f"S={c['num_stages']} M={c['num_micro_batches']} "
               f"tp={c['intra_tp']} {c['placement']}")
        if (key not in pipe_best or c["cost"].key()
                < pipe_best[key]["cost"].key()):
            pipe_best[key] = c
    pipelines = [{"config": k, "predicted_step_seconds":
                  c["cost"].total_duration,
                  "bubble_ratio": c["cost"].bubble_ratio,
                  "memory_feasible": c["cost"].memory_feasible,
                  "modifiers": (c.get("comm_dtype", "")
                                + ("@zero" if c.get("zero") else ""))}
                 for k, c in sorted(pipe_best.items())]
    # The data x seq candidates are priced by hand (ring or Ulysses comm
    # beside the data axis's), with no strategies of their own.
    seq = [{"topology": str(c["topology"]), "impl": c["seq_impl"],
            "predicted_step_seconds": c["cost"].total_duration,
            "memory_feasible": c["cost"].memory_feasible}
           for c in best["candidates"] if c.get("enum_kind") == "seq"]
    cost = best["cost"]
    # The token input's strategy in the fidelity data-8 candidate, planned
    # without annotations (the step graph's last placeholder).
    data8 = next(c for c in best["candidates"]
                 if c["topology"].device_axes() == [
                     ("data", SPMD_PLAN_DEVICES)]
                 and not c.get("comm_dtype") and not c.get("zero"))
    gs = data8["strategies"][0]
    placeholders = [v for v in gs.var_strategies if v.op == "placeholder"]
    order = {v: i for i, v in enumerate(placeholders[0].graph.nodes)}
    token_unannotated = str(gs.var_strategies[max(placeholders,
                                                  key=order.get)])
    emit({"phase": "spmd_plan", "part": "explore", "model": "GPT-2 1.5B",
          "n_layer": cfg.n_layer, "cut": SPMD_PLAN_CUT,
          "n_embd": cfg.n_embd, "n_head": cfg.n_head,
          "vocab": cfg.vocab_size, "batch": PLAN_BATCH, "seq": SEQ,
          "n_devices": SPMD_PLAN_DEVICES, "chip": chip_spec().name,
          "explore_seconds": explore_s,
          "capture_seconds": phases.get("trace_ms", 0.0) / 1e3,
          "search_seconds": phases.get("spmd_ms", 0.0) / 1e3,
          "seq_search_seconds": phases.get("seq_ms", 0.0) / 1e3,
          "pipeline_search_seconds": phases.get("pipeline_ms", 0.0) / 1e3,
          "seq_candidates": seq,
          "pipeline_candidates": pipelines,
          "candidates_per_topology": per_topology,
          "excluded_kinds": best.get("excluded_kinds"),
          "winner": {"kind": best["kind"],
                     "topology": str(best.get("topology")),
                     "num_stages": best.get("num_stages"),
                     "intra_tp": best.get("intra_tp"),
                     "comm_dtype": best.get("comm_dtype", ""),
                     "zero": bool(best.get("zero", False))},
          "predicted_step_seconds": cost.total_duration,
          "memory_feasible": cost.memory_feasible,
          "peak_bytes_per_device": cost.peak_bytes_per_device,
          "solver_status": status,
          "data8_token_strategy_unannotated": token_unannotated,
          "ranked": candidate_summary(best["candidates"], best)[:6]})
    if best.get("excluded_kinds") != [] or not pipelines:
        raise SystemExit("chip_smoke: exploration did not search (and "
                         "price) every kind")

    # The whole GA step on data=8, the token input annotated as split
    # over data (the batch annotation a data-parallel user gives): the
    # cost model leaves a token input replicated when a glue chain from
    # it to the first layer is free in its objective (ROADMAP C5).
    opt = adamw_bf16(1e-4)
    opt_state = opt.init(params)
    step = build_ga_step(train.value_and_grad(loss_fn),
                         lambda p, s_, g: (p, opt.apply(p, g, s_)), 1)
    n_state = len(tree_leaves((params, opt_state)))
    t0 = time.perf_counter()
    plan = auto_parallel(
        step, MeshTopology([("data", SPMD_PLAN_DEVICES)]), params,
        opt_state, tokens, mode="cost",
        state_alias={1 + k: k for k in range(n_state)},
        annotations={n_state: {"data": DimStrategy.split_on(
            0, SPMD_PLAN_DEVICES)}})
    plan_s = time.perf_counter() - t0
    ts = plan.sharding_plan.var_strategies
    flash = [n for n in plan.graph.nodes if n.prim == "flash_fwd"]
    qkv_split = [all(ts[v].get("data").is_split()
                     and ts[v].get("data").partition_dim == 0
                     for v in n.invars[:3]) for n in flash]
    token_spec = str(plan.sharding_plan.in_specs[n_state])
    emit({"phase": "spmd_plan", "part": "data8", "n_layer": cfg.n_layer,
          "auto_parallel_seconds": plan_s,
          "graph_nodes": len(plan.graph),
          "solver_status": [g.ilp_status for g in plan.strategies],
          "token_placements": token_spec,
          "flash_fwd_nodes": len(flash),
          "flash_qkv_split_dim0": sum(qkv_split),
          "split_state_leaves": sum(
              1 for sp in plan.sharding_plan.in_specs[:n_state]
              if "Shard" in str(sp))})
    if token_spec != "(Shard(dim=0),)":
        raise SystemExit(f"chip_smoke: the data-8 plan does not split the "
                         f"tokens on dim 0: {token_spec}")
    if not flash or not all(qkv_split):
        raise SystemExit("chip_smoke: a flash op's q, k or v is not split "
                         f"on dim 0 ({sum(qkv_split)}/{len(flash)})")
    del plan, params, opt_state
    torch.cuda.empty_cache()


def phase_spmd_step(micro_batches: int, eager_losses):
    """GPT-2 1.5B at full width and depth, the plan phase's recipe, seed
    and batches, through the lowering: ``plan_training(topology=data 1)``
    on a one-rank NCCL world captures the whole GA step, plans it and runs
    it as an fx interpreter on DTensors, the flash kernels launched
    through their ops. Six steps; the losses held to the eager plan's.
    Returns the kernels' launches over the six steps."""
    import torch
    import torch.distributed as dist

    from tepdist_tpu_torch import train
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16

    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        cfg = _config(48)
        L = cfg.n_layer
        params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
        tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0,
                                 device="cuda")
        t0 = time.perf_counter()
        plan = train.plan_training(
            lambda p, t: gpt2.loss_fn_stacked(p, t, cfg), adamw_bf16(1e-4),
            params, tokens, num_micro_batches=micro_batches,
            topology=MeshTopology([("data", 1)]))
        setup_s = time.perf_counter() - t0
        del params
        pp = plan.parallel_plan
        want = {"flash_fwd": 2 * L * micro_batches,
                "flash_dq": L * micro_batches,
                "flash_dkv": L * micro_batches}
        torch.cuda.reset_peak_memory_stats()
        losses, seconds, per_step = [], [], []
        fa.reset_launch_counts()
        for _ in range(STEPS):
            before = dict(fa.launch_counts)
            t0 = time.perf_counter()
            losses.append(plan.step(tokens))   # returns after a device sync
            seconds.append(time.perf_counter() - t0)
            per_step.append({n: fa.launch_counts[n] - before[n]
                             for n in want})
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        remats = plan.involuntary_remats(tokens)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, eager_losses)]
        steady = seconds[1:]
        emit({"phase": "spmd_step", "model": "GPT-2 1.5B", "n_layer": L,
              "batch": PLAN_BATCH, "seq": SEQ, "cut": "none",
              "topology": str(plan.topology),
              "micro_batches": micro_batches,
              "setup_seconds": setup_s, "graph_nodes": len(pp.graph),
              "solver_status": [g.ilp_status for g in pp.strategies],
              "losses": losses, "eager_losses": list(eager_losses),
              "loss_rel_diff": rel, "loss_rtol": SPMD_STEP_LOSS_RTOL,
              "step_seconds": seconds,
              "tokens_per_s": PLAN_BATCH * SEQ * len(steady) / sum(steady),
              "max_memory_allocated_bytes": peak,
              "launches_per_step": per_step, "expected_per_step": want,
              "involuntary_remats": len(remats)})
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"chip_smoke: non-finite loss {losses}")
        if max(rel) > SPMD_STEP_LOSS_RTOL:
            raise SystemExit(f"chip_smoke: lowered losses {losses} differ "
                             f"from the eager plan's {eager_losses}")
        if not losses[-1] < losses[0]:
            raise SystemExit(f"chip_smoke: loss did not fall {losses}")
        if not all(launches[n] for n in want):
            raise SystemExit(f"chip_smoke: a flash kernel was not launched "
                             f"through the lowering {launches}")
        del plan
        return launches, seconds
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


# rpc phase: the spmd_step recipe through the service: a TepdistSession
# against a TepdistServicer on the card, reached through an ``inproc:``
# address (the card's machine has no grpcio). A checkpoint after step
# RPC_SAVE_AT, restored into the same servicer; the next step's loss must
# repeat bit for bit.
RPC_SAVE_AT = 3


def phase_rpc(micro_batches: int, eager_losses, spmd_seconds):
    """GPT-2 1.5B at full width and depth, the plan phase's recipe, M,
    seed and batches, trained through ``TepdistSession.compile_training``
    -> ``BuildExecutionPlan`` -> six ``ExecutePlan`` steps on a servicer
    that holds the card (``mesh_axes=[["data", 1]]``). Prints the capture
    and serde costs, the state transfer's bytes and GB/s, the planner's
    seconds, each step's seconds beside spmd_step's and the servicer's
    host time outside the lowered step, the launches and the peak memory;
    then a remote save after step 3 and a remote restore into the same
    servicer, whose next step repeats step 4's loss bit for bit. Returns
    the kernels' launches over the six steps."""
    import torch
    import torch.distributed as dist

    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16, optimizer_spec
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    torch.cuda.empty_cache()
    servicer = TepdistServicer(["cuda"])
    servicer.ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_rpc_")
    address = "inproc:1"
    inproc.register_servicer(address, servicer)
    # The servicer's host costs: the wire graph's decode, and each
    # ExecutePlan handler's time beside its lowered step (synced).
    timings = {"decode": [], "handler": [], "run": []}
    graph_of = servicer._graph

    def timed_graph(blob):
        t0 = time.perf_counter()
        gm = graph_of(blob)
        timings["decode"].append(time.perf_counter() - t0)
        return gm

    servicer._graph = timed_graph
    execute = servicer.ExecutePlan

    def timed_execute(request, context=None):
        t0 = time.perf_counter()
        resp = execute(request, context)
        timings["handler"].append(time.perf_counter() - t0)
        return resp

    servicer.ExecutePlan = timed_execute
    try:
        cfg = _config(48)
        L = cfg.n_layer
        params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
        tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0,
                                 device="cuda")
        sess = TepdistSession(address, mesh_axes=[("data", 1)])
        t0 = time.perf_counter()
        summary = sess.compile_training(
            lambda p, t: gpt2.loss_fn_stacked(p, t, cfg), adamw_bf16(1e-4),
            params, tokens, num_micro_batches=micro_batches,
            optimizer_spec=optimizer_spec("adamw_bf16", learning_rate=1e-4))
        compile_s = time.perf_counter() - t0
        del params
        stats = dict(sess.compile_stats)
        plan = servicer.plan_cache.resolve(sess.handle)
        run_of = plan.run

        def timed_run(args):
            t0 = time.perf_counter()
            outs = run_of(args)
            torch.cuda.synchronize()
            timings["run"].append(time.perf_counter() - t0)
            return outs

        plan.run = timed_run
        want = {"flash_fwd": 2 * L * micro_batches,
                "flash_dq": L * micro_batches,
                "flash_dkv": L * micro_batches}
        torch.cuda.reset_peak_memory_stats()
        losses, seconds, per_step = [], [], []
        fa.reset_launch_counts()
        save_s = None
        for k in range(STEPS):
            before = dict(fa.launch_counts)
            t0 = time.perf_counter()
            losses.append(sess.run(tokens))
            seconds.append(time.perf_counter() - t0)
            per_step.append({n: fa.launch_counts[n] - before[n]
                             for n in want})
            if k + 1 == RPC_SAVE_AT:
                t0 = time.perf_counter()
                sess.save()
                save_s = time.perf_counter() - t0
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        sess.restore()
        restore_s = time.perf_counter() - t0
        again = sess.run(tokens)
        sess.close()
        outside = [h - r for h, r in zip(timings["handler"],
                                         timings["run"])]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, eager_losses)]
        steady = seconds[1:]
        emit({"phase": "rpc", "model": "GPT-2 1.5B", "n_layer": L,
              "batch": PLAN_BATCH, "seq": SEQ, "cut": "none",
              "transport": address, "device": str(servicer.device),
              "micro_batches": micro_batches,
              "capture_seconds": stats["capture_seconds"],
              "graph_nodes": stats["graph_nodes"],
              "graph_bytes": stats["module_bytes"],
              "encode_seconds": stats["encode_seconds"],
              "decode_seconds": timings["decode"],
              "state_bytes": stats["transfer_bytes"],
              "transfer_seconds": stats["transfer_seconds"],
              "transfer_gb_per_s": (stats["transfer_bytes"]
                                    / stats["transfer_seconds"] / 1e9),
              "planner_seconds": summary["planner_seconds"],
              "compile_training_seconds": compile_s,
              "losses": losses, "eager_losses": list(eager_losses),
              "loss_rel_diff": rel, "loss_rtol": SPMD_STEP_LOSS_RTOL,
              "step_seconds": seconds,
              "spmd_step_seconds": list(spmd_seconds),
              "tokens_per_s": PLAN_BATCH * SEQ * len(steady) / sum(steady),
              "handler_seconds": timings["handler"],
              "lowered_step_seconds": timings["run"],
              "host_seconds_outside_step": outside,
              "max_memory_allocated_bytes": peak,
              "launches_per_step": per_step, "expected_per_step": want,
              "save_after_step": RPC_SAVE_AT, "save_seconds": save_s,
              "restore_seconds": restore_s,
              "step4_loss": losses[RPC_SAVE_AT],
              "step4_loss_after_restore": again})
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"chip_smoke: non-finite loss {losses}")
        if max(rel) > SPMD_STEP_LOSS_RTOL:
            raise SystemExit(f"chip_smoke: losses through the service "
                             f"{losses} differ from the eager plan's "
                             f"{eager_losses}")
        if not losses[-1] < losses[0]:
            raise SystemExit(f"chip_smoke: loss did not fall {losses}")
        if any(step != want for step in per_step):
            raise SystemExit(f"chip_smoke: launches a step {per_step} "
                             f"through the service, expected {want}")
        if again != losses[RPC_SAVE_AT]:
            raise SystemExit(f"chip_smoke: step {RPC_SAVE_AT + 1} after the "
                             f"remote restore gave {again}, before "
                             f"{losses[RPC_SAVE_AT]}")
        return launches
    finally:
        inproc.unregister_servicer(address)
        shutil.rmtree(servicer.ckpt_dir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.cuda.empty_cache()


# pipeline phase: the plan phase's model, recipe, seed and batches in 4
# stages of 8 micro batches (micro batch 6 x 1024), width and depth uncut,
# all four stages on the one card (device list [cuda:0] * 4). The losses
# against the plan phase's: step 1 is the mean of the same per-token fp32
# losses summed in another order (8 micro means against one), about 1e-6
# relative; later steps differ through the gradients, which the pipeline
# sums over 8 micro batches in bf16 accumulators (each add rounds at 2**-9
# relative) where the plan phase's M = 1 rounds once, so Adam's update
# moves by at most that fraction of lr. The CPU at 64-128 width and 4-8
# layers shows 2e-7 to 4.3e-6 over six steps; the spmd_step bound of 2e-3
# (two bf16 rounding points per op over six steps at this width) holds it.
PIPE_STAGES, PIPE_MICRO = 4, 8
PIPELINE_LOSS_RTOL = 2e-3


def _chosen_window(exe) -> int:
    """The 1F1B window the scheduler picked: the candidate whose simulation
    gives the chosen order (simulated on a copy, so the executor's GC plan
    stays the chosen order's)."""
    import copy

    from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler

    sched = exe.schedule
    ts = TaskScheduler(copy.deepcopy(exe.dag), device_type=exe.device_type)
    for w in range(1, 4 * PIPE_MICRO + 1):
        if ts._simulate(w, policy=sched.policy).order == sched.order:
            return w
    return -1


def phase_pipeline(eager_losses, eager_micro: int):
    """GPT-2 1.5B at full width and depth through the task-graph pipeline:
    ``plan_training(num_stages=4, num_micro_batches=8, devices=[cuda:0] *
    4)`` captures the forward loss at micro-batch shapes on fake tensors,
    cuts it with the stage ILP, builds and verifies the task DAG, schedules
    it (1F1B, the native core) and trains 6 steps on the plan phase's
    batches. The four stages share the card, so they run one after
    another; the scheduler's makespan is predicted for four devices.
    Returns the kernels' launches over the six steps, the losses and
    ``tools/torch_verify_plan.py``'s report on the program (text)."""
    import copy

    import torch

    from tepdist_tpu_torch import native, train
    from tepdist_tpu_torch.analysis.plan_verify import (PlanVerificationError,
                                                        verify_plan)
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.performance_utils import chip_spec
    from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler
    from tepdist_tpu_torch.telemetry import configure, tracer

    torch.cuda.empty_cache()
    if not native.native_available():
        raise SystemExit("chip_smoke: the native scheduler did not build or "
                         "load on the card's host")
    cfg = _config(48)
    L, S, M = cfg.n_layer, PIPE_STAGES, PIPE_MICRO
    # The unrolled layout of the plan phase's weights: stacked_init_params
    # stacks these same draws (seed 0).
    params = gpt2.init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0, device="cuda")
    ServiceEnv.reset({"TEPDIST_VERIFY_PLAN": "1"})
    try:
        t0 = time.perf_counter()
        plan = train.plan_training(
            lambda p, t: gpt2.loss_fn(p, t, cfg), adamw_bf16(1e-4), params,
            tokens, num_stages=S, num_micro_batches=M,
            devices=[torch.device("cuda", 0)] * S)
        setup_s = time.perf_counter() - t0
    finally:
        ServiceEnv.reset()
    del params
    exe, prog = plan.executable, plan.pipeline
    sched, dag = exe.schedule, exe.dag
    findings = []
    try:
        verify_plan(dag, schedule=sched, prog=prog)
    except PlanVerificationError as e:
        findings.append(str(e))
    # tools/torch_verify_plan.py's report on this program and schedule
    # (the explore_tools phase prints it).
    verify_text = io.StringIO()
    with contextlib.redirect_stdout(verify_text):
        if _load_tool("torch_verify_plan").report(
                prog, dag, sched, where="chip_smoke pipeline") is None:
            findings.append(verify_text.getvalue())
    gated = exe.verify_report is not None
    probe = TaskScheduler(copy.deepcopy(dag), device_type=exe.device_type)
    native_same = (probe._simulate(2, use_native=True).order
                   == probe._simulate(2, use_native=False).order)
    flops = prog.stage_flops()
    tasks = {}
    for n in dag.nodes:
        tasks[n.task_type.value] = tasks.get(n.task_type.value, 0) + 1
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
    peak = torch.cuda.max_memory_allocated()
    steady = seconds[1:]
    # A diagnostic seventh step with the executor's spans on: host seconds
    # in each kind of task body (they include any wait for the launch
    # queue), per micro batch.
    configure(enabled=True)
    tracer().snapshot(clear=True)
    t0 = time.perf_counter()
    plan.step(tokens)
    traced_s = time.perf_counter() - t0
    records = tracer().snapshot(clear=True)
    configure(enabled=False)
    span_s = {}
    for r in records:
        if r.get("cat") != "step":
            span_s[r["cat"]] = span_s.get(r["cat"], 0.0) + r["dur"] / 1e6
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, eager_losses)]
    emit({"phase": "pipeline", "model": "GPT-2 1.5B", "n_layer": L,
          "n_embd": cfg.n_embd, "batch": PLAN_BATCH, "seq": SEQ,
          "cut": "none", "num_stages": S, "micro_batches": M,
          "devices": "[cuda:0] * 4 (the four stages share the card)",
          "setup_seconds": setup_s, "capture_seconds": prog.trace_seconds,
          "graph_nodes": len(prog.graph),
          "stage_ilp": {"status": prog.sketch.solver_status,
                        "seconds": prog.sketch.solve_seconds,
                        "message": prog.sketch.solver_message,
                        "sketch_nodes": len(prog.sketch.nodes)},
          "nodes_per_stage": [len(m.eqns) for m in prog.stages],
          "flops_share": [f / sum(flops) for f in flops],
          "flash_fwd_per_stage": [sum(1 for n in m.eqns
                                      if n.prim == "flash_fwd")
                                  for m in prog.stages],
          "cross_stage_bytes": prog.decomp.cross_stage_bytes(),
          "tasks": tasks, "plan_verify_findings": findings,
          "plan_verify_gate_ran": gated,
          "native_scheduler_loaded": native.native_available(),
          "native_equals_python": native_same,
          "schedule": {"policy": sched.policy,
                       "window": _chosen_window(exe),
                       "chip": chip_spec().name,
                       "predicted_makespan_s": sched.makespan,
                       "predicted_bubble_ratio": sched.bubble_ratio,
                       "note": "predicted for 4 devices; on one card the "
                               "stages run one after another"},
          "losses": losses, "plan_losses": list(eager_losses),
          "plan_micro_batches": eager_micro, "loss_rel_diff": rel,
          "loss_rtol": PIPELINE_LOSS_RTOL, "step_seconds": seconds,
          "tokens_per_s": PLAN_BATCH * SEQ * len(steady) / sum(steady),
          "max_memory_allocated_bytes": peak,
          "launches_per_step": per_step, "expected_per_step": want,
          "traced_step_seconds": traced_s,
          "task_span_seconds_per_micro_batch":
              {k: v / M for k, v in span_s.items()}})
    if findings or not gated:
        raise SystemExit(f"chip_smoke: plan_verify findings {findings} "
                         f"(gate ran: {gated})")
    if not native_same:
        raise SystemExit("chip_smoke: the native scheduler's order differs "
                         "from the Python simulation's")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: non-finite loss {losses}")
    if max(rel) > PIPELINE_LOSS_RTOL:
        raise SystemExit(f"chip_smoke: pipeline losses {losses} differ from "
                         f"the plan phase's {eager_losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: loss did not fall {losses}")
    if any(step != want for step in per_step):
        raise SystemExit(f"chip_smoke: launches {per_step} != {want}")
    del plan, exe
    torch.cuda.empty_cache()
    return launches, losses, verify_text.getvalue()


# fleet phase: the pipeline phase's recipe (GPT-2 1.5B at full width,
# batch 48 x 1024, 4 stages, M = 8) at FLEET_LAYERS deep, cut by
# plan_pipeline and run through the fleet pipeline: a
# DistributedPipelineSession over FLEET_WORKERS in-process workers that
# all hold card 0 (stages s % 2: two a worker), activations worker to
# worker as RPC raw-data pushes. FLEET_STEPS steps held to a one-process
# PipelineExecutable of the same program over [cuda:0] * 4 (bit for bit
# is the aim; the check is PIPELINE_LOSS_RTOL); then a save, one more
# step (the unfaulted loss, traced: its merged trace is dumped to
# FLEET_TRACE), a restore, and the same step again with a planted
# transient fault on worker 1 (FLEET_FAULT, armed until the master's
# fence): recovered by _recover_step with no rollback, its loss equal to
# the unfaulted step's. Depth cut from 48 to 12 layers: at 48 the
# phase took 99-193 s (shipping the four stage programs alone 28.5-105.6
# s between two runs of one tree), and the whole script came within 24 s
# of its 1200 s limit. Budget: about 60 s.
FLEET_WORKERS, FLEET_STEPS, FLEET_LAYERS = 2, 3, 12
FLEET_FAULT = "server_fault:p=1,verb=ExecuteStepSlice,ti=1"
# The unfaulted step's merged trace (the serve_fleet phase reads it).
FLEET_TRACE = os.path.join("chiprun_out", "fleet_trace.json")
FLEET_VERBS = ("TransferModuleAndDefCtx", "DispatchPlan", "ExecuteStepSlice",
               "TransferHostRawData", "TransferToServerHost", "AbortStep",
               "DoRemoteSave", "DoRemoteRestore")


def _time_verbs(servicer, verbs, table):
    """Wrap ``servicer``'s handlers to record each call's host wall (ms)
    under its verb in ``table``."""
    for verb in verbs:
        fn = getattr(servicer, verb)

        def timed(request, context=None, fn=fn, verb=verb):
            t0 = time.perf_counter()
            try:
                return fn(request, context)
            finally:
                table.setdefault(verb, []).append(
                    (time.perf_counter() - t0) * 1e3)
        setattr(servicer, verb, timed)


def _arm_until_fence(servicer, spec) -> None:
    """Arm the fault spec until ``servicer`` sees the master's fence (a
    plain AbortStep): a transient fault that outlasts the transport's own
    retries, so the master's step-level recovery is what meets it."""
    from tepdist_tpu_torch.rpc import protocol
    from tepdist_tpu_torch.runtime import faults

    faults.configure(spec)
    abort = servicer.AbortStep

    def fenced(request, context=None):
        if not protocol.unpack(request)[0].get("reset"):
            faults.configure(None)
        return abort(request, context)

    servicer.AbortStep = fenced


def phase_fleet():
    """GPT-2 1.5B through ``DistributedPipelineSession`` over in-process
    workers on card 0 (module comment at FLEET_*). Returns the kernels'
    launches over the FLEET_STEPS steps and the one-process executable's
    fastest step of the same program (ms)."""
    import torch

    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.core.tree import tree_map
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.runtime.executor import PipelineExecutable
    from tepdist_tpu_torch.telemetry import ledger as wire_ledger
    from tepdist_tpu_torch.telemetry import metrics

    torch.cuda.empty_cache()
    cfg = _config(FLEET_LAYERS)
    L, M = cfg.n_layer, PIPE_MICRO
    params = gpt2.init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0, device="cuda")
    t0 = time.perf_counter()
    prog = plan_pipeline(lambda p, t: gpt2.loss_fn(p, t, cfg), PIPE_STAGES,
                         M, params, tokens)
    plan_s = time.perf_counter() - t0
    # The reference: the same program in one process, on copies (on one
    # device the executable updates the leaves it is given in place).
    exe = PipelineExecutable(prog, devices=[torch.device("cuda", 0)]
                             * PIPE_STAGES, optimizer=adamw_bf16(1e-4))
    exe.load_variables(tree_map(lambda t: t.clone(), params))
    ref, ref_s = [], []
    for _ in range(FLEET_STEPS + 1):
        t0 = time.perf_counter()
        ref.append(exe.step(tokens))     # returns after a device sync
        ref_s.append(time.perf_counter() - t0)
    del exe
    torch.cuda.empty_cache()
    # The raw-data push (the reference fleet's hop); tickets would make
    # each hop a device copy between the in-process workers.
    knob = os.environ.get("TEPDIST_DEVICE_TRANSFER")
    os.environ["TEPDIST_DEVICE_TRANSFER"] = "0"
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    old_ckpt = os.environ.get("TEPDIST_CKPT_DIR")
    os.environ["TEPDIST_CKPT_DIR"] = ckpt
    cluster, servicers = make_inproc_cluster(
        FLEET_WORKERS, devices=[torch.device("cuda", 0)])
    handler_ms = {}
    for sv in servicers:
        _time_verbs(sv, FLEET_VERBS, handler_ms)
    want = {"flash_fwd": 2 * L * M, "flash_dq": L * M, "flash_dkv": L * M}
    metrics().reset()
    sess = None
    try:
        t0 = time.perf_counter()
        sess = DistributedPipelineSession(prog, cluster,
                                          optimizer=adamw_bf16(1e-4))
        ship_s = time.perf_counter() - t0
        sess.load_variables(params)
        setup_s = time.perf_counter() - t0
        del params
        torch.cuda.reset_peak_memory_stats()
        losses, seconds, per_step = [], [], []
        fa.reset_launch_counts()
        for _ in range(FLEET_STEPS):
            before = dict(fa.launch_counts)
            t1 = time.perf_counter()
            losses.append(sess.step(tokens))
            seconds.append(time.perf_counter() - t1)
            per_step.append({n: fa.launch_counts[n] - before[n]
                             for n in want})
        launches = dict(fa.launch_counts)
        pushes = {sv.task_index: (sv.worker_plan.push_bytes,
                                  sv.worker_plan.push_seconds)
                  for sv in servicers}
        step_handler = {v: _quantiles(ms) for v, ms in handler_ms.items()}
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        sess.save()
        save_s = time.perf_counter() - t1
        # The unfaulted step runs traced, with the RPC ledger on: its
        # merged trace (every worker's spans, the simulator's predicted
        # timeline and the fleet's ledger in the metadata) is the
        # serve_fleet phase's fidelity input and the explore_tools
        # phase's trace_summary and ledger_report input.
        tracer = telemetry.configure(enabled=True, capacity=1 << 18)
        tracer.clear()
        wire_ledger.configure(enabled=True)
        wire_ledger.ledger().clear()
        t1 = time.perf_counter()
        clean = sess.step(tokens)
        clean_s = time.perf_counter() - t1
        trace_path = sess.dump_trace(path=FLEET_TRACE, clear=True)
        wire_ledger.configure(enabled=False)
        telemetry.configure(enabled=False)
        t1 = time.perf_counter()
        sess.restore(FLEET_STEPS)
        restore_s = time.perf_counter() - t1
        before = metrics().snapshot()["counters"]
        _arm_until_fence(servicers[1], FLEET_FAULT)
        t1 = time.perf_counter()
        faulted = sess.step(tokens)
        faulted_s = time.perf_counter() - t1
        faults.configure(None)
        after = metrics().snapshot()["counters"]
    finally:
        faults.configure(None)
        wire_ledger.configure(enabled=False)
        if sess is not None:
            sess.close()
        close_inproc_cluster(cluster)
        shutil.rmtree(ckpt, ignore_errors=True)
        for key, val in (("TEPDIST_DEVICE_TRANSFER", knob),
                         ("TEPDIST_CKPT_DIR", old_ckpt)):
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    got = losses + [faulted]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    steady = seconds[1:]
    emit({"phase": "fleet", "model": "GPT-2 1.5B", "n_layer": L,
          "n_embd": cfg.n_embd, "batch": PLAN_BATCH, "seq": SEQ,
          "micro_batches": M, "num_stages": prog.num_stages,
          "workers": FLEET_WORKERS,
          "devices": "every worker on cuda:0 (inproc: addresses)",
          "stage_worker": sess.stage_worker if sess else None,
          "transport": "RPC raw-data push (TEPDIST_DEVICE_TRANSFER=0)",
          "plan_pipeline_seconds": plan_s,
          "ship_seconds": ship_s, "setup_seconds": setup_s,
          "losses": losses,
          "reference": "PipelineExecutable of the same program over "
                       "[cuda:0] * 4",
          "reference_losses": ref,
          "bit_for_bit_with_reference": losses == ref[:FLEET_STEPS],
          "loss_rel_diff": rel, "loss_rtol": PIPELINE_LOSS_RTOL,
          "step_seconds": seconds,
          "tokens_per_s": PLAN_BATCH * SEQ * len(steady) / sum(steady),
          "max_memory_allocated_bytes": peak,
          "launches_per_step": per_step, "expected_per_step": want,
          "push_bytes_and_seconds": pushes,
          "push_gb_per_s": {ti: (b / s_ / 1e9 if s_ else None)
                            for ti, (b, s_) in pushes.items()},
          "handler_ms_by_verb": step_handler,
          "save_seconds": save_s, "restore_seconds": restore_s,
          "unfaulted_step": {"loss": clean, "seconds": clean_s,
                             "traced": True, "trace": trace_path},
          "faulted_step": {"fault": FLEET_FAULT, "loss": faulted,
                           "seconds": faulted_s,
                           "faults_injected":
                               delta("fault_injected:server_fault"),
                           "step_retries": delta("step_retries"),
                           "elastic_redispatch":
                               delta("elastic_redispatch"),
                           "checkpoint_rollback_steps":
                               delta("checkpoint_rollback_steps")}})
    if not all(math.isfinite(x) for x in got):
        raise SystemExit(f"chip_smoke: fleet non-finite loss {got}")
    if max(rel) > PIPELINE_LOSS_RTOL:
        raise SystemExit(f"chip_smoke: fleet losses {got} differ from the "
                         f"one-process executable's {ref}")
    if faulted != clean:
        raise SystemExit(f"chip_smoke: the faulted step's loss {faulted} "
                         f"differs from the unfaulted step's {clean}")
    if (delta("step_retries") != 1 or not delta("fault_injected:server_fault")
            or delta("elastic_redispatch")
            or delta("checkpoint_rollback_steps")):
        raise SystemExit("chip_smoke: the planted fault was not recovered "
                         "by one transient step retry")
    if any(step != want for step in per_step):
        raise SystemExit(f"chip_smoke: fleet launches {per_step} != {want}")
    torch.cuda.empty_cache()
    # The one-process step of this program: ledger_report's --single-ms.
    return launches, min(ref_s[1:]) * 1e3


# Pipeline stages over several devices (ROADMAP item 13b), one card in the
# one-process form: the pipeline phase's model, seed and batches as 2
# stages x 2 intra-stage data replicas over [cuda:0] * 4, M = 8 (3 rows a
# replica a micro batch), plain for PIPE_DP_STEPS steps (cut from 6 to 3
# for the script's time limit), then the same program with ZeRO for
# PIPE_DP_ZERO_STEPS (held to the plain run's first ones).
PIPE_DP_STAGES, PIPE_DP_REPLICAS = 2, 2
PIPE_DP_STEPS, PIPE_DP_ZERO_STEPS = 3, 3


def phase_pipeline_dp(pipe_losses):
    """GPT-2 1.5B at full width and depth through ``plan_training(
    num_stages=2, num_micro_batches=8, devices=[cuda:0] * 4)``: each stage
    runs as two intra-stage data replicas (the stage modules captured at a
    replica's 3 rows, the partial gradients summed once at APPLY), then
    the same captured program with ZeRO (each replica updates half of
    every padded flat optimizer leaf: reduce-scatter, update, all-gather)
    in a new ``PipelineExecutable``. 3 steps plain, 3 with ZeRO: losses
    within PIPELINE_LOSS_RTOL of the pipeline phase's, ZeRO's of the plain
    run's, launches 2LMR / LMR / LMR a step; the predicted makespan and
    bubble (4 devices, ``h100`` entry), step seconds and peak memory.
    Returns the plain run's launches (the
    path's own, counted from 0)."""
    import torch

    from tepdist_tpu_torch import train
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.performance_utils import chip_spec
    from tepdist_tpu_torch.runtime.executor import PipelineExecutable

    torch.cuda.empty_cache()
    cfg = _config(48)
    L, S, R, M = cfg.n_layer, PIPE_DP_STAGES, PIPE_DP_REPLICAS, PIPE_MICRO
    devices = [torch.device("cuda", 0)] * (S * R)
    tokens = gpt2.fake_batch(cfg, PLAN_BATCH, SEQ, seed=0, device="cuda")
    want = {"flash_fwd": 2 * L * M * R, "flash_dq": L * M * R,
            "flash_dkv": L * M * R}

    def loss_fn(p, t):
        return gpt2.loss_fn(p, t, cfg)

    runs, plain_launches, prog = {}, None, None
    for zero in (False, True):
        params = gpt2.init_params(cfg, seed=0, device="cuda")
        t0 = time.perf_counter()
        if zero:
            # The plain run's captured program and stage cut, with ZeRO.
            prog.zero = True
            exe = PipelineExecutable(prog, devices=devices,
                                     optimizer=adamw_bf16(1e-4))
            exe.load_variables(params)
            step = exe.step
        else:
            plan = train.plan_training(
                loss_fn, adamw_bf16(1e-4), params, tokens, num_stages=S,
                num_micro_batches=M, devices=devices)
            exe, step = plan.executable, plan.step
        setup_s = time.perf_counter() - t0
        del params
        torch.cuda.reset_peak_memory_stats()
        losses, seconds, per_step = [], [], []
        fa.reset_launch_counts()
        for _ in range(PIPE_DP_ZERO_STEPS if zero else PIPE_DP_STEPS):
            before = dict(fa.launch_counts)
            t0 = time.perf_counter()
            losses.append(step(tokens))     # returns after a device sync
            seconds.append(time.perf_counter() - t0)
            per_step.append({n: fa.launch_counts[n] - before[n]
                             for n in want})
        if not zero:
            plain_launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        steady = seconds[1:]
        sched, prog = exe.schedule, exe.prog
        ref = runs["plain"]["losses"] if zero else pipe_losses
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        runs["zero" if zero else "plain"] = {"losses": losses, "rel": rel}
        emit({"phase": "pipeline_dp", "zero": zero, "model": "GPT-2 1.5B",
              "n_layer": L, "batch": PLAN_BATCH, "seq": SEQ,
              "num_stages": S, "replicas_per_stage": R, "micro_batches": M,
              "rows_per_replica": PLAN_BATCH // M // R,
              "devices": "[cuda:0] * 4 (2 stages x 2 replicas share the "
                         "card)",
              "entry": "PipelineExecutable(the plain run's program, "
                       "zero)" if zero else "plan_training",
              "setup_seconds": setup_s,
              "capture_seconds": prog.trace_seconds,
              "stage_ilp": {"status": prog.sketch.solver_status,
                            "seconds": prog.sketch.solve_seconds},
              "flops_share": [f / sum(prog.stage_flops())
                              for f in prog.stage_flops()],
              "schedule": {"policy": sched.policy,
                           "chip": chip_spec().name,
                           "predicted_makespan_s": sched.makespan,
                           "predicted_bubble_ratio": sched.bubble_ratio,
                           "note": "predicted for 4 devices; on one card "
                                   "the stages and replicas run one after "
                                   "another"},
              "losses": losses,
              "reference": "plain run" if zero else "pipeline phase",
              "reference_losses": list(ref), "loss_rel_diff": rel,
              "loss_rtol": PIPELINE_LOSS_RTOL, "step_seconds": seconds,
              "tokens_per_s": PLAN_BATCH * SEQ * len(steady) / sum(steady),
              "max_memory_allocated_bytes": peak,
              "launches_per_step": per_step, "expected_per_step": want})
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"chip_smoke: non-finite loss {losses}")
        if max(rel) > PIPELINE_LOSS_RTOL:
            raise SystemExit(f"chip_smoke: pipeline_dp losses {losses} "
                             f"differ from {ref}")
        if any(st != want for st in per_step):
            raise SystemExit(f"chip_smoke: launches {per_step} != {want}")
        del exe, step
        if not zero:
            del plan
        torch.cuda.empty_cache()
    return plain_launches


# The collective (single-program) pipeline, device form: GPT-2 1.5B's
# 48 blocks as 4 stages of 12 over [cuda:0] * 4, batch 12 x 1024 in 4
# micro batches of 3 rows (the pipeline_dp phase's kernel shape).
COLL_STAGES, COLL_BATCH, COLL_MICRO = 4, 12, 4


def phase_collective():
    """``gpt2.pipelined_loss_fn`` (the GPipe wavefront over S + M - 1
    ticks, the hop a ``.to()``) on the stacked blocks of
    ``shard_stacked_for_stages``: its loss against ``loss_fn_stacked`` on
    the same weights and batch (PARITY_LOSS_RTOL) and each gradient leaf
    against the eager one's (PARITY_GRAD_RL2, worst leaf), the kernels'
    launches (2LM / LM / LM under full remat) and both seconds. Returns
    the launches (the path's own, counted from 0)."""
    import torch

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    cfg = _config(48)
    L, S, M = cfg.n_layer, COLL_STAGES, COLL_MICRO
    devices = [torch.device("cuda", 0)] * S
    params = gpt2.init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, COLL_BATCH, SEQ, seed=4, device="cuda")
    embed, stacked = gpt2.shard_stacked_for_stages(params, cfg, devices)
    del params
    names = sorted(embed) + sorted(stacked)
    leaves = [t.detach().requires_grad_() for t in
              [embed[k] for k in sorted(embed)]
              + [stacked[k] for k in sorted(stacked)]]
    n_e = len(embed)
    e = dict(zip(sorted(embed), leaves[:n_e]))
    b = dict(zip(sorted(stacked), leaves[n_e:]))
    want = {"flash_fwd": 2 * L * M, "flash_dq": L * M, "flash_dkv": L * M}

    eager = dict(e)
    eager["blocks"] = {k: v.reshape((L,) + tuple(v.shape[2:]))
                       for k, v in b.items()}

    def run(pipelined):
        """(loss, grads, seconds) of one forward and backward."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = (gpt2.pipelined_loss_fn(e, b, tokens, cfg, devices, M)
                if pipelined else gpt2.loss_fn_stacked(eager, tokens, cfg))
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.item()
        return loss, grads, time.perf_counter() - t0

    fa.reset_launch_counts()
    loss_c, grads_c, first_c = run(True)
    launches = dict(fa.launch_counts)
    loss_e, grads_e, first_e = run(False)
    rel = {n: ((a.float() - g.float()).norm()
               / g.float().norm().clamp_min(1e-30)).item()
           for n, a, g in zip(names, grads_c, grads_e)}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_c - loss_e) / abs(loss_e)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_c)
    del grads_c, grads_e
    # Both again, warm: the first calls allocate their memory.
    coll_s, eager_s = run(True)[2], run(False)[2]
    emit({"phase": "collective", "model": "GPT-2 1.5B", "n_layer": L,
          "batch": COLL_BATCH, "seq": SEQ, "num_stages": S,
          "micro_batches": M, "rows_per_micro_batch": COLL_BATCH // M,
          "ticks": S + M - 1,
          "devices": "[cuda:0] * 4 (the device form: a hop is a .to())",
          "loss_pipelined": loss_c, "loss_eager": loss_e,
          "loss_rel_err": loss_rel, "loss_rtol": PARITY_LOSS_RTOL,
          "grad_worst_leaf": worst, "grad_max_rel_l2": rel[worst],
          "grad_rel_l2_tol": PARITY_GRAD_RL2,
          "launches": launches, "expected": want,
          "pipelined_step_seconds": coll_s, "eager_step_seconds": eager_s,
          "first_call_seconds": {"pipelined": first_c, "eager": first_e}})
    if not (finite and math.isfinite(loss_c)
            and loss_rel <= PARITY_LOSS_RTOL
            and rel[worst] <= PARITY_GRAD_RL2):
        raise SystemExit("chip_smoke: the collective pipeline disagrees "
                         "with the eager loss or gradients")
    if launches != want:
        raise SystemExit(f"chip_smoke: collective launches {launches} != "
                         f"{want}")
    del leaves, e, b, eager, embed, stacked
    torch.cuda.empty_cache()
    return launches


# Sequence parallelism (ROADMAP item 14). seq_kernels: attention alone at
# Llama 1B's heads (16 query heads after the GQA repeat, head_dim 128),
# bf16, causal, batch 1 x 16384 tokens (within Llama 3.2 1B's published
# 128k context), split over SEQ_RING = 4 ranks of one card
# ([cuda:0] * 4), hops of [16, 4096, 128].
SEQ_RING = 4
SEQ_KERNELS_SHAPE = dict(B=1, H=16, T=16384, D=128)
# The ring (and Ulysses) against one whole-sequence call of the kernels.
# On fp32 operands the kernels phase's fp32 rule, elementwise. On bf16
# operands each output's relative L2 distance to the whole call on
# fp32-upcast inputs may be at most SEQ_GAP_FACTOR times the whole bf16
# call's own distance there (its rounding gap), plus the fp32 rtol: the
# ring rounds each hop's output, dQ, dK and dV to bf16 before it merges
# them in fp32, so it may lie a little further from the fp32 answer than
# the whole call, but not twice as far.
SEQ_GAP_FACTOR = 2.0
SEQ_TOLERANCE = ("fp32: |seq - whole| <= 2e-5 * max(1, max|whole|) + "
                 "1e-4 * |whole| elementwise; bf16: ||seq - whole32|| / "
                 "||whole32|| <= 2 * ||whole - whole32|| / ||whole32|| + "
                 "1e-4, each of o, LSE, dQ, dK, dV")
SEQ_OUTPUTS = ("o", "lse", "dq", "dk", "dv")
# seq_step: the slice phase's model, recipe, seed and batches with the
# flash ring as attention; the losses against the slice phase's, as the
# spmd_step phase holds a different rounding path over six Adam steps.
# The first micro batch's gradients through the ring are also held to
# those through the whole-sequence kernels, each leaf in relative L2: at
# 48 layers bf16 rounding alone puts the sound ring's leaves 1.6e-2 to
# 2.2e-2 from the kernels' (the parity phase reads 7e-3 at 2 layers), a
# ring with its full hops dropped or its merge weights off 0.8 and more
# (tools/torch_seq_faults.py, PERF.md section 6).
SEQ_STEP_LOSS_RTOL = 2e-3
SEQ_GRAD_RL2 = 0.1
# seq_plan: Llama 1B's width (dim 2048, 16 heads, 4 KV heads), depth cut
# to 2 layers, batch 1 x 16384, planned for 8 devices on the host.
SEQ_PLAN_LAYERS, SEQ_PLAN_DEVICES, SEQ_PLAN_TOKENS = 2, 8, 16384


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def seq_rule(got, got32, ref, ref32):
    """({output: readings}, all within?) of the seq rule: ``got`` /
    ``got32`` the sequence-parallel o, LSE, dQ, dK, dV on bf16 / fp32
    operands, ``ref`` / ``ref32`` the whole-sequence call's."""
    out = {}
    for name, a, a32, r, r32 in zip(SEQ_OUTPUTS, got, got32, ref, ref32):
        fp32_err, _, fp32_ok = _within(a32, r32, r32)
        err, gap = _rel_l2(a, r32), _rel_l2(r, r32)
        limit = SEQ_GAP_FACTOR * gap + FP32_RTOL
        out[name] = {"fp32_max_abs_err": fp32_err,
                     "bf16_max_abs_err": (a.float() - r.float()).abs()
                     .max().item(),
                     "bf16_rel_l2": err, "whole_bf16_rel_l2": gap,
                     "bf16_limit": limit, "ok": fp32_ok and err <= limit}
    return out, all(r["ok"] for r in out.values())


def seq_inputs(shape, device):
    """The seq_kernels phase's seeded bf16 q, k, v, dO and fp32 dLSE."""
    import torch

    gen = torch.Generator(device=device).manual_seed(400)
    q, k, v, do = (torch.randn(*shape, generator=gen, device=device)
                   .bfloat16() for _ in range(4))
    dlse = torch.randn(*shape[:3], generator=gen, device=device)
    return q, k, v, do, dlse


def whole_sequence(q, k, v, do, dlse, scale, dtype):
    """[o, lse, dq, dk, dv] of one whole-sequence call of the flash
    kernels on [B, H, T, D] inputs cast to ``dtype``, causal."""
    from tepdist_tpu_torch.ops import flash_attention as fa

    B, H, T, D = q.shape
    flat = [t.to(dtype).reshape(B * H, T, D).contiguous()
            for t in (q, k, v, do)]
    o, lse = fa.flash_fwd(*flat[:3], True, scale)
    delta = ((flat[3].float() * o.float()).sum(-1)
             - dlse.reshape(B * H, T)).contiguous()
    args = (*flat, lse, delta, True, scale)
    dk, dv = fa.flash_dkv(*args)
    return [o.reshape(B, H, T, D), lse.reshape(B, H, T),
            fa.flash_dq(*args).reshape(B, H, T, D), dk.reshape(B, H, T, D),
            dv.reshape(B, H, T, D)]


def seq_call(impl, dtype, inputs, ring, scale):
    """([o, lse, dq, dk, dv], forward launches, backward launches) of the
    flash ``impl`` ("ring" or "ulysses") over ``ring`` on the
    ``seq_inputs`` q, k, v cast to ``dtype``, causal, with dO and dLSE as
    the cotangents; the launches by kernel and mask."""
    import torch

    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.ops.ring_attention import _SeqAttn

    q, k, v, do, dlse = inputs
    leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    o, lse = _SeqAttn.apply(*leaves, ring, True, scale, q.shape[1], impl,
                            "flash")
    torch.cuda.synchronize()
    fwd = dict(fa.mask_launch_counts)
    fa.reset_launch_counts()
    grads = torch.autograd.grad((o, lse), leaves, (do.to(dtype), dlse))
    torch.cuda.synchronize()
    bwd = dict(fa.mask_launch_counts)
    fa.reset_launch_counts()
    return [o.detach(), lse.detach(), *grads], fwd, bwd


def seq_checked(impl, inputs, ring, scale, ref, ref32):
    """(readings, within?, forward launches, backward launches) of
    ``impl`` in bf16 and in fp32 against the whole-sequence call's
    ``ref`` / ``ref32`` under the seq rule."""
    import torch

    got, fwd, bwd = seq_call(impl, torch.bfloat16, inputs, ring, scale)
    got32, _, _ = seq_call(impl, torch.float32, inputs, ring, scale)
    readings, ok = seq_rule(got, got32, ref, ref32)
    return readings, ok, fwd, bwd


def phase_seq_kernels():
    """Ring and Ulysses attention in the one-process form over
    ``[cuda:0] * 4`` at [1, 16, 16384, 128] bf16 causal: o, LSE, dQ, dK
    and dV against one whole-sequence call of the flash kernels, the
    launches per call, and the times of the three. Returns the launches
    by kernel and mask of one ring call, forward and backward."""
    import torch

    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.ops.ring_attention import _SeqAttn, ring_hops
    from tepdist_tpu_torch.ops.seq_comm import DeviceTransport

    B, H, T, D = (SEQ_KERNELS_SHAPE[k] for k in "BHTD")
    inputs = seq_inputs((B, H, T, D), device="cuda")
    q, k, v, do, dlse = inputs
    scale = 1.0 / math.sqrt(D)
    ring = DeviceTransport([torch.device("cuda", 0)] * SEQ_RING)

    ref, ref32 = (whole_sequence(q, k, v, do, dlse, scale, x)
                  for x in (torch.bfloat16, torch.float32))
    out = {}
    launches = {}
    for impl in ("ring", "ulysses"):
        readings, ok, fwd, bwd = seq_checked(impl, inputs, ring, scale, ref,
                                             ref32)
        out[impl] = {"outputs": readings, "ok": ok,
                     "forward_launches": fwd, "backward_launches": bwd}
        launches[impl] = (fwd, bwd)
    del ref, ref32
    hops = ring_hops(SEQ_RING, True)
    want_ring_fwd = {"flash_fwd/causal": hops["diag"],
                     "flash_fwd/full": hops["full"]}
    want_ring_bwd = {f"{n}/{m}": hops[h] for n in ("flash_dq", "flash_dkv")
                     for m, h in (("causal", "diag"), ("full", "full"))}
    want_uly_fwd = {"flash_fwd/causal": SEQ_RING}
    want_uly_bwd = {"flash_dq/causal": SEQ_RING,
                    "flash_dkv/causal": SEQ_RING}

    # Times: forward, and backward from saved results, of the ring,
    # Ulysses and the whole-sequence kernels (CUDA events).
    times = {}
    leaves = [t.requires_grad_() for t in (q, k, v)]
    for impl in ("ring", "ulysses"):
        def fwd_fn(impl=impl):
            return _SeqAttn.apply(*leaves, ring, True, scale, H, impl,
                                  "flash")
        o, lse = fwd_fn()
        times[impl] = {
            "forward_ms": cuda_ms(fwd_fn, iters=5, windows=3),
            "backward_ms": cuda_ms(lambda: torch.autograd.grad(
                (o, lse), leaves, (do, dlse), retain_graph=True), iters=5,
                windows=3)}
        del o, lse
    flat = [t.detach().reshape(B * H, T, D).contiguous()
            for t in (q, k, v, do)]
    o, lse = fa.flash_fwd(*flat[:3], True, scale)
    delta = ((flat[3].float() * o.float()).sum(-1)
             - dlse.reshape(B * H, T)).contiguous()
    args = (*flat, lse, delta, True, scale)
    times["whole"] = {
        "forward_ms": cuda_ms(lambda: fa.flash_fwd(*flat[:3], True, scale),
                          iters=5, windows=3),
        "backward_ms": cuda_ms(lambda: (fa.flash_dq(*args),
                                        fa.flash_dkv(*args)),
                               iters=5, windows=3)}
    fa.reset_launch_counts()
    emit({"phase": "seq_kernels", "model": "Llama 1B attention",
          "shape": f"[{B}, {H}, {T}, {D}] bf16 causal",
          "ring": f"[cuda:0] * {SEQ_RING} (one-process form)",
          "hop_shape": f"[{B * H}, {T // SEQ_RING}, {D}]",
          "tolerance": SEQ_TOLERANCE, "results": out,
          "expected_ring_launches": [want_ring_fwd, want_ring_bwd],
          "expected_ulysses_launches": [want_uly_fwd, want_uly_bwd],
          "times": times,
          "ring_over_whole": {
              k: times["ring"][k][0] / times["whole"][k][0]
              for k in ("forward_ms", "backward_ms")}})
    bad = [impl for impl, r in out.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {bad} disagree with the whole-"
                         f"sequence kernels")
    if launches["ring"] != (want_ring_fwd, want_ring_bwd):
        raise SystemExit(f"chip_smoke: ring launches {launches['ring']}")
    if launches["ulysses"] != (want_uly_fwd, want_uly_bwd):
        raise SystemExit(f"chip_smoke: Ulysses launches "
                         f"{launches['ulysses']}")
    return {**launches["ring"][0], **launches["ring"][1]}


def _leaf_names(tree, prefix=""):
    """Names of ``tree``'s leaves by dict key path, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def seq_grad_gaps(cfg, params, tokens, attn):
    """{leaf: relative L2 distance} between the gradients of the stacked
    GPT-2 loss on ``tokens`` with ``attn`` as attention and with the
    whole-sequence kernels (the slice phase's attention)."""
    import torch

    from tepdist_tpu_torch.core.tree import tree_leaves, tree_unflatten
    from tepdist_tpu_torch.models import gpt2

    def grads(attn_impl):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = gpt2.loss_fn_stacked(tree_unflatten(params, leaves), tokens,
                                    cfg, attn_impl=attn_impl)
        return torch.autograd.grad(loss, leaves)

    want = grads(None)
    got = grads(attn)
    return {name: _rel_l2(a, b) for name, a, b in
            zip(_leaf_names(params), got, want)}


def phase_seq_step(slice_losses, slice_seconds):
    """GPT-2 1.5B at full width and depth, the slice phase's recipe, seed
    and batches, its attention the flash ring over ``[cuda:0] * 4``
    (hops of [4*25, 256, 64]), through ``plan_training``: the first micro
    batch's gradients against the whole-sequence kernels', then 6 steps,
    losses against the slice phase's, 2*L*M*10 forward launches a step
    and L*M*10 of dQ and of dK/dV. Returns the launches over the 6 steps
    by kernel and mask."""
    import torch

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.ops import ring_attention
    from tepdist_tpu_torch.ops.ring_attention import ring_hops
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.train import plan_training

    torch.cuda.empty_cache()
    cfg = _config(48)
    L, M = cfg.n_layer, MICRO
    devices = [torch.device("cuda", 0)] * SEQ_RING

    def attn(q, k, v):
        return ring_attention(q, k, v, devices, inner="flash")

    params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, BATCH, SEQ, seed=0, device="cuda")
    # The first micro batch's gradients through the ring against those
    # through the whole-sequence kernels, before any step.
    grad_gaps = seq_grad_gaps(cfg, params, tokens[:BATCH // M], attn)
    worst = max(grad_gaps, key=grad_gaps.get)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plan = plan_training(
        lambda p, t: gpt2.loss_fn_stacked(p, t, cfg, attn_impl=attn),
        adamw_bf16(1e-4), params, tokens, num_micro_batches=MICRO)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hops = ring_hops(SEQ_RING, True)
    calls = L * M
    want = {"flash_fwd/causal": 2 * calls * hops["diag"],
            "flash_fwd/full": 2 * calls * hops["full"],
            "flash_dq/causal": calls * hops["diag"],
            "flash_dq/full": calls * hops["full"],
            "flash_dkv/causal": calls * hops["diag"],
            "flash_dkv/full": calls * hops["full"]}
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, per_step = [], [], []
    total = {}
    for _ in range(STEPS):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(plan.step(tokens))   # returns after a device sync
        seconds.append(time.perf_counter() - t0)
        step = dict(fa.mask_launch_counts)
        per_step.append(step)
        for key, n in step.items():
            total[key] = total.get(key, 0) + n
    fa.reset_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, slice_losses)]
    steady = seconds[1:]
    emit({"phase": "seq_step", "model": "GPT-2 1.5B", "n_layer": L,
          "n_embd": cfg.n_embd, "seq": SEQ, "batch": BATCH,
          "micro_batches": M, "cut": "batch 48 -> 8 and micro batches "
          "16 -> 2 (the slice phase's recipe)",
          "attention": f"flash ring over [cuda:0] * {SEQ_RING}, hops of "
                       f"[{BATCH // M}*25, {SEQ // SEQ_RING}, 64]",
          "setup_seconds": setup_s, "losses": losses,
          "slice_losses": list(slice_losses), "loss_rel_diff": rel,
          "loss_rtol": SEQ_STEP_LOSS_RTOL,
          "first_grad_rel_l2": grad_gaps, "worst_grad_leaf": worst,
          "grad_rel_l2_tol": SEQ_GRAD_RL2, "step_seconds": seconds,
          "slice_step_seconds": list(slice_seconds),
          "tokens_per_s": BATCH * SEQ * len(steady) / sum(steady),
          "max_memory_allocated_bytes": peak,
          "launches_per_step": per_step, "expected_per_step": want})
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: non-finite loss {losses}")
    if max(rel) > SEQ_STEP_LOSS_RTOL:
        raise SystemExit(f"chip_smoke: ring losses {losses} differ from "
                         f"the slice phase's {slice_losses}")
    if not grad_gaps[worst] <= SEQ_GRAD_RL2:
        raise SystemExit(f"chip_smoke: the ring's gradient of {worst} lies "
                         f"{grad_gaps[worst]} from the kernels'")
    if any(step != want for step in per_step):
        raise SystemExit(f"chip_smoke: launches {per_step} != {want}")
    del plan, params
    torch.cuda.empty_cache()
    return total


def phase_seq_plan():
    """Llama 1B's width, depth cut to 2 layers, batch 1 x 16384, planned
    for 8 devices on the host from fake tensors: ``explore`` with the
    sequence candidates (each priced, ring or Ulysses per seq size, the
    winner, the search seconds); then the forward loss rewritten for a
    seq axis of 4 and planned on data 2 x seq 4, which must leave no
    flash forward unrewritten."""
    import torch

    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.graph.fx_graph import trace_graph
    from tepdist_tpu_torch.models import llama
    from tepdist_tpu_torch.parallel.attention_motif import seq_rewritten_loss
    from tepdist_tpu_torch.parallel.auto_parallel import plan_axes
    from tepdist_tpu_torch.parallel.exploration import (candidate_summary,
                                                        explore)
    from tepdist_tpu_torch.parallel.performance_utils import chip_spec

    cfg = dataclasses.replace(llama.CONFIGS["1B"], n_layer=SEQ_PLAN_LAYERS,
                              n_ctx=SEQ_PLAN_TOKENS, attn="flash")
    params = llama.init_params(cfg, seed=0, device="cuda")
    tokens = llama.fake_batch(cfg, 1, SEQ_PLAN_TOKENS, seed=0,
                              device="cuda")

    def loss_fn(p, t):
        return llama.loss_fn(p, t, cfg)

    t0 = time.perf_counter()
    best = explore(loss_fn, params, tokens, n_devices=SEQ_PLAN_DEVICES)
    explore_s = time.perf_counter() - t0
    report = best.get("report") or {}
    phases = report.get("phases", {})
    seq = [c for c in best["candidates"] if c.get("enum_kind") == "seq"]
    prunes = [p for p in report.get("prunes", [])
              if p.get("kind") == "seq"]
    emit({"phase": "seq_plan", "part": "explore", "model": "Llama 1B",
          "n_layer": cfg.n_layer, "dim": cfg.dim, "n_head": cfg.n_head,
          "n_kv_head": cfg.n_kv_head, "batch": 1,
          "seq": SEQ_PLAN_TOKENS, "cut": "depth 16 -> 2 layers",
          "n_devices": SEQ_PLAN_DEVICES, "chip": chip_spec().name,
          "explore_seconds": explore_s,
          "capture_seconds": phases.get("trace_ms", 0.0) / 1e3,
          "spmd_search_seconds": phases.get("spmd_ms", 0.0) / 1e3,
          "seq_search_seconds": phases.get("seq_ms", 0.0) / 1e3,
          "seq_candidates": [
              {"topology": str(c["topology"]), "impl": c["seq_impl"],
               "predicted_step_seconds": c["cost"].total_duration,
               "coll_ratio": c["cost"].coll_ratio,
               "memory_feasible": c["cost"].memory_feasible}
              for c in seq],
          "seq_prunes": prunes,
          "winner": str(best["topology"]),
          "excluded_kinds": best.get("excluded_kinds"),
          "ranked": candidate_summary(best["candidates"], best)[:6]})
    exceptions = [p for p in prunes
                  if p.get("reason") == "planning_exception"]
    if not seq or exceptions:
        raise SystemExit(f"chip_smoke: no seq candidate priced at Llama 1B "
                         f"width ({len(seq)} priced, {exceptions})")

    t0 = time.perf_counter()
    rewritten, impl = seq_rewritten_loss(loss_fn, 4, params, tokens)
    graph = trace_graph(rewritten, params, tokens)[0]
    topo = MeshTopology([("data", 2), ("seq", 4)])
    strategies = plan_axes(graph, topo)
    plan_s = time.perf_counter() - t0
    emit({"phase": "seq_plan", "part": "data2_seq4",
          "impl": impl, "motifs": len(rewritten.motifs),
          "seq_attn_nodes": graph.count("seq_attn"),
          "flash_fwd_nodes": graph.count("flash_fwd"),
          "solver_status": [g.ilp_status for g in strategies],
          "seconds": plan_s})
    if (graph.count("seq_attn") != cfg.n_layer
            or graph.count("flash_fwd") or len(rewritten.motifs)
            != cfg.n_layer):
        raise SystemExit("chip_smoke: the seq rewrite left a flash "
                         "forward unrewritten")
    del params, tokens
    torch.cuda.empty_cache()


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


def _profile_step(model: str, step, step_s) -> None:
    """One more step (``step()``), after the checked ones, under
    ``torch.profiler`` (CPU and CUDA activities): device time by kernel
    name (top 15) and by kind, the device's busy share of the profiled
    step (whose host work the profiler slows) and the device time over
    ``step_s``, the median unprofiled step (when given), and the flash
    kernels' summed time with their inputs as the step leaves them (cold
    from the QKV matmul, where the kernels phase times them warm in L2). A
    measurement, not a check: a profiler that records no device time is
    reported and the run goes on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    label = "chip_smoke_step"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            step()
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
        emit({"phase": "profile", "model": model, "device_ms": None,
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
    emit({"phase": "profile", "model": model,
          "window_ms": (w1 - w0) / 1e3,
          "device_ms": device_ms,
          "device_busy_share": busy_us / (w1 - w0),
          "device_ms_over_median_step":
              device_ms / (step_s * 1e3) if step_s else None,
          "flash_kernels": flash, "groups": groups,
          "top_kernels": [{"name": n[:160], "ms": r[0], "launches": r[1]}
                          for n, r in top]})


def _text_batches(workdir: str):
    """[LLAMA_BATCH, LLAMA_SEQ + 1] windows of the repository's text as
    byte tokens, drawn with seed 0 from a token file in ``workdir``."""
    from tepdist_tpu_torch.data import (TokenDataset, encode_bytes,
                                        pack_token_file)

    text = "".join(open(name, encoding="utf-8").read()
                   for name in TEXT_FILES)
    path = os.path.join(workdir, "text.bin")
    pack_token_file(encode_bytes(text), path)
    ds = TokenDataset(path)
    return ds, itertools.islice(ds.batches(LLAMA_BATCH, LLAMA_SEQ, seed=0),
                                LLAMA_STEPS)


def _llama_plan(cfg, seed: int, example):
    from tepdist_tpu_torch.models import llama
    from tepdist_tpu_torch.optim import adamw
    from tepdist_tpu_torch.train import plan_training

    return plan_training(lambda p, t: llama.loss_fn(p, t, cfg), adamw(1e-4),
                         llama.init_params(cfg, seed=seed), example,
                         num_micro_batches=1)


def phase_llama(workdir: str):
    """Llama 1B, 6 steps on real tokens through the prefetcher; a
    checkpoint after step 3. Returns the launches and what the checkpoint
    phase needs."""
    import torch

    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.data import DevicePrefetcher
    from tepdist_tpu_torch.models import llama
    from tepdist_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(llama.CONFIGS["1B"], attn="flash")
    ds, host_batches = _text_batches(workdir)
    batches = DevicePrefetcher(host_batches)
    first = next(batches)
    t0 = time.perf_counter()
    plan = _llama_plan(cfg, 0, first)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(plan.variables()[0]))
    ckpt_dir = os.path.join(workdir, "ckpt")
    want = {n: cfg.n_layer for n in KERNELS}
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, per_step, save = [], [], [], {}
    fa.reset_launch_counts()
    for i, batch in enumerate(itertools.chain([first], batches), 1):
        before = dict(fa.launch_counts)
        t0 = time.perf_counter()
        losses.append(plan.step(batch))   # returns after a device sync
        seconds.append(time.perf_counter() - t0)
        per_step.append({n: fa.launch_counts[n] - before[n] for n in want})
        if i == LLAMA_SAVE_AT:
            # A host copy, so the step's peak memory does not count it.
            save["state"] = [t.to("cpu", copy=True)
                             for t in tree_leaves(plan.variables())]
            t0 = time.perf_counter()
            handle = plan.save(ckpt_dir, LLAMA_SAVE_AT, block=False)
            save["snapshot_s"] = time.perf_counter() - t0
            save["path"] = handle.result()
            save["save_s"] = time.perf_counter() - t0
        if i == LLAMA_SAVE_AT + 1:
            save["batch"], save["loss"] = batch, losses[-1]
    launches = dict(fa.launch_counts)
    steady = seconds[1:]
    emit({"phase": "llama", "model": "Llama 1B", "n_params": n_params,
          "dim": cfg.dim, "n_layer": cfg.n_layer, "n_head": cfg.n_head,
          "n_kv_head": cfg.n_kv_head, "head_dim": cfg.head_dim,
          "ffn_dim": cfg.ffn_dim, "vocab": cfg.vocab_size,
          "batch": LLAMA_BATCH, "seq": LLAMA_SEQ, "micro_batches": 1,
          "optimizer": "adamw(1e-4)", "cut": "none",
          "data": {"files": list(TEXT_FILES), "tokens": len(ds),
                   "tokenizer": "bytes"},
          "setup_seconds": setup_s, "losses": losses,
          "step_seconds": seconds,
          "tokens_per_s": LLAMA_BATCH * LLAMA_SEQ * len(steady) / sum(steady),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches_per_step": per_step, "expected_per_step": want})
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: non-finite Llama loss {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: Llama loss did not fall {losses}")
    if any(step != want for step in per_step):
        raise SystemExit(f"chip_smoke: Llama launches {per_step} != {want}")
    _profile_step("Llama 1B", lambda: plan.step(save["batch"]),
                  sorted(steady)[len(steady) // 2])
    save["cfg"], save["dir"] = cfg, ckpt_dir
    return launches, save


def phase_checkpoint(save) -> None:
    """A plan from other random weights restores the step-3 checkpoint:
    every leaf bit for bit, and its step 4 the uninterrupted loss bit for
    bit (the step's loss is a forward on equal state, and the kernels use
    no atomics)."""
    import torch

    from tepdist_tpu_torch.core.tree import tree_leaves

    plan = _llama_plan(save["cfg"], 1, save["batch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = plan.restore(save["dir"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    leaves = tree_leaves(plan.variables())
    equal = [torch.equal(a.cpu(), b)
             for a, b in zip(leaves, save.pop("state"))]
    loss = plan.step(save["batch"])
    nbytes = os.path.getsize(save["path"])
    disk = shutil.disk_usage(save["dir"])
    emit({"phase": "checkpoint", "step_restored": step,
          "bytes_written": nbytes, "leaves": len(leaves),
          "snapshot_seconds": save["snapshot_s"],
          "save_seconds": save["save_s"], "restore_seconds": restore_s,
          "save_gb_per_s": nbytes / save["save_s"] / 1e9,
          "restore_gb_per_s": nbytes / restore_s / 1e9,
          "free_disk_bytes": disk.free,
          "leaves_equal": sum(equal), "step4_loss": save["loss"],
          "step4_loss_restored": loss})
    if step != LLAMA_SAVE_AT or not all(equal) or len(equal) != len(leaves):
        raise SystemExit(f"chip_smoke: restored step {step}, "
                         f"{sum(equal)}/{len(leaves)} leaves equal")
    if loss != save["loss"]:
        raise SystemExit(f"chip_smoke: step 4 after restore {loss!r} != "
                         f"{save['loss']!r}")


def _backward_timeline(loss, leaves):
    """``torch.autograd.grad(loss, leaves)`` with a pre- and a post-hook on
    every node of the graph, each reading the allocator's bytes and its
    peak since the previous hook. Returns the grads and the segments, in
    the order the backward ran them: ``(node, "in" or "after", bytes at
    the segment's start, its peak)``; "in" is the node's own run (with any
    recompute it triggers), "after" the engine's work that follows it."""
    import torch

    marks, handles, seen, stack = [], [], set(), [loss.grad_fn]

    def mark(node, when):
        marks.append((node.name(), when, torch.cuda.memory_allocated(),
                      torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        handles.append(node.register_prehook(
            lambda grad_out, n=node: mark(n, "pre")))
        handles.append(node.register_hook(
            lambda grad_in, grad_out, n=node: mark(n, "post")))
        stack.extend(f for f, _ in node.next_functions)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    try:
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for h in handles:
            h.remove()
    segments, prev = [], ("backward start", "after", start)
    for name, when, now, peak in marks:
        segments.append((prev[0] if when == "pre" else name,
                         "after" if when == "pre" else "in", prev[2], peak))
        prev = (name, when, now)
    return grads, segments


def _peak_of_timeline(segments) -> dict:
    """Where a backward's peak falls: the segment that holds it, its place
    in the run, whether it comes after the blocks' backward (the last run
    of the flash backward, the first layer's), and the five highest
    segments."""
    at = max(range(len(segments)), key=lambda i: segments[i][3])
    flash = [i for i, s in enumerate(segments)
             if s[1] == "in" and s[0] == "_FlashBackward"]
    top = sorted(range(len(segments)), key=lambda i: -segments[i][3])[:5]

    def show(i):
        node, where, start, peak = segments[i]
        return {"segment": i, "node": node, "where": where,
                "start_bytes": start, "peak_bytes": peak}

    return {"segments": len(segments), "peak": show(at),
            "last_flash_backward_segment": flash[-1] if flash else None,
            "peak_after_blocks_backward": bool(flash) and at > flash[-1],
            "highest_segments": [show(i) for i in top]}


def phase_remat():
    """GPT-2 at 1.5B width and 4 layers: one forward and backward under no
    remat and each policy; then each once more with its backward's memory
    read at every autograd node. Returns the kernels' launches over the
    checked runs."""
    import torch

    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa

    base = _config(REMAT_LAYERS)
    params = gpt2.stacked_init_params(base, seed=3, device="cuda")
    tokens = gpt2.fake_batch(base, REMAT_BATCH, SEQ, seed=4, device="cuda")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]

    def policy_cfg(policy):
        return dataclasses.replace(base, remat=policy is not None,
                                   remat_policy=policy or "full")

    def fwd_bwd(cfg, memory):
        base_bytes = torch.cuda.memory_allocated()
        loss = gpt2.loss_fn_stacked(params, tokens, cfg)
        # What the forward keeps for the backward, which the policy
        # decides, and the forward's own peak.
        memory["kept_bytes"] = torch.cuda.memory_allocated() - base_bytes
        memory["forward_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(loss, leaves)
        memory["backward_peak_bytes"] = torch.cuda.max_memory_allocated()
        return loss.item(), grads

    fwd_bwd(policy_cfg(None), {})   # warm-up
    L = base.n_layer
    rows, ref = {}, None
    total = {n: 0 for n in KERNELS}
    for policy in REMAT_POLICIES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        memory = {}
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = fwd_bwd(policy_cfg(policy), memory)
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        for n in KERNELS:
            total[n] += launches[n]
        row = {"seconds": time.perf_counter() - t0, "loss": loss,
               "max_memory_allocated_bytes": max(
                   memory["forward_peak_bytes"],
                   memory["backward_peak_bytes"]), **memory,
               "launches": launches,
               "expected_fwd_launches": (L if policy in (None, "save_attn")
                                         else 2 * L)}
        if ref is None:
            # Kept on the host, so no policy's peak counts them.
            ref = (loss, [g.cpu() for g in grads])
        else:
            rel = [((g.float() - r.to(g.device).float()).norm()
                    / r.float().norm().clamp_min(1e-30)).item()
                   for g, r in zip(grads, ref[1])]
            row["loss_rel_err"] = abs(loss - ref[0]) / abs(ref[0])
            row["grad_max_rel_l2"] = max(rel)
        del grads
        rows[policy or "none"] = row
    emit({"phase": "remat", "n_layer": L, "n_embd": base.n_embd,
          "batch": REMAT_BATCH, "seq": SEQ, "policies": rows,
          "loss_rtol": PARITY_LOSS_RTOL, "grad_rel_l2_tol": PARITY_GRAD_RL2})

    # Where each policy's step peak falls: the same forward and backward
    # once more, with every autograd node of the backward hooked (after
    # the checked runs, since the hooks cost host time).
    for policy in REMAT_POLICIES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = gpt2.loss_fn_stacked(params, tokens, policy_cfg(policy))
        forward_peak = torch.cuda.max_memory_allocated()
        grads, segments = _backward_timeline(loss, leaves)
        del loss, grads
        timeline = _peak_of_timeline(segments)
        emit({"phase": "remat_memory", "policy": policy or "none",
              "forward_peak_bytes": forward_peak,
              "checked_run_backward_peak_bytes":
                  rows[policy or "none"]["backward_peak_bytes"],
              **timeline})

    for name, row in rows.items():
        if row["launches"]["flash_fwd"] != row["expected_fwd_launches"]:
            raise SystemExit(f"chip_smoke: {name} launched the forward "
                             f"{row['launches']['flash_fwd']} times")
        if row["launches"]["flash_dq"] != L:
            raise SystemExit(f"chip_smoke: {name} launched dQ "
                             f"{row['launches']['flash_dq']} times")
        if name != "none" and not (
                row["loss_rel_err"] <= PARITY_LOSS_RTOL
                and row["grad_max_rel_l2"] <= PARITY_GRAD_RL2):
            raise SystemExit(f"chip_smoke: {name} grads disagree with no "
                             "remat's")
    # What the forward keeps, and so the forward's peak, is strictly
    # ordered by the policy. The step's peak is not: full and save_attn
    # both peak in the first layer's block, which holds that layer's O
    # under either policy (the remat_memory lines).
    peak = {k: r["max_memory_allocated_bytes"] for k, r in rows.items()}
    fwd_peak = {k: r["forward_peak_bytes"] for k, r in rows.items()}
    kept = {k: r["kept_bytes"] for k, r in rows.items()}
    if not (peak["none"] > peak["dots"] >= max(peak["save_attn"],
                                               peak["full"])
            and kept["none"] > kept["dots"] > kept["save_attn"]
            > kept["full"]
            and fwd_peak["none"] > fwd_peak["dots"] > fwd_peak["save_attn"]
            > fwd_peak["full"]):
        raise SystemExit(f"chip_smoke: memory out of order: peak {peak}, "
                         f"forward peak {fwd_peak}, kept by the forward "
                         f"{kept}")
    return total


def phase_sampling() -> None:
    """GPT-2 1.5B greedy generation: checked in fp32, timed in bf16."""
    import torch

    from tepdist_tpu_torch.models import gpt2, sampling

    cfg = dataclasses.replace(gpt2.CONFIGS["1.5B"], dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (SAMPLE_BATCH, SAMPLE_PROMPT),
                           generator=gen, device="cuda")
    params = gpt2.init_params(cfg, seed=5, device="cuda")
    out = sampling.sample(params, prompt, cfg, max_new_tokens=SAMPLE_NEW,
                          greedy=True)
    with torch.no_grad():
        logits = gpt2.forward(params, out[:, :-1], cfg)
    want = logits[:, SAMPLE_PROMPT - 1:].argmax(-1)
    agree = int((want == out[:, SAMPLE_PROMPT:]).sum())
    del params, logits

    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg16, seed=5, device="cuda")

    def timed(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampling.sample(params, prompt, cfg16, max_new_tokens=new,
                        greedy=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(2)   # warm-up
    first_s, total_s = timed(1), timed(SAMPLE_NEW)
    n = SAMPLE_BATCH * SAMPLE_NEW
    emit({"phase": "sampling", "model": "GPT-2 1.5B", "n_layer": cfg.n_layer,
          "batch": SAMPLE_BATCH, "prompt": SAMPLE_PROMPT,
          "new_tokens": SAMPLE_NEW, "check_dtype": "float32, TF32 off",
          "positions_equal_full_forward_argmax": agree,
          "positions": n, "timed_dtype": "bfloat16",
          "prefill_and_first_token_seconds": first_s,
          "generate_seconds": total_s,
          "decode_ms_per_token": (total_s - first_s) / (SAMPLE_NEW - 1) * 1e3,
          "tokens_per_s": n / total_s})
    if agree != n:
        raise SystemExit(f"chip_smoke: greedy tokens differ from the full "
                         f"forward's argmax at {n - agree} of {n} positions")


def phase_models() -> None:
    """One plan_training step each of gpt_moe base-8e (bench_moe: batch 8,
    seq 256, adamw(1e-4)) and Wide ResNet CONFIGS[0] (bench_wrn: batch 32,
    224x224, sgd(0.1, momentum=0.9)). Proofs of the path, not
    measurements."""
    import torch

    from tepdist_tpu_torch.models import gpt2, gpt_moe, wide_resnet
    from tepdist_tpu_torch.optim import adamw, sgd
    from tepdist_tpu_torch.train import plan_training

    def run(name, loss_fn, opt, params, inputs, **shape):
        torch.cuda.reset_peak_memory_stats()
        plan = plan_training(loss_fn, opt, params, *inputs,
                             num_micro_batches=1)
        t0 = time.perf_counter()
        loss = plan.step(*inputs)
        seconds = time.perf_counter() - t0
        emit({"phase": "models", "model": name, **shape, "loss": loss,
              "first_step_seconds": seconds,
              "max_memory_allocated_bytes":
                  torch.cuda.max_memory_allocated()})
        if not math.isfinite(loss):
            raise SystemExit(f"chip_smoke: {name} loss {loss}")

    cfg = gpt_moe.CONFIGS["base-8e"]
    run("gpt_moe base-8e", lambda p, t: gpt_moe.loss_fn(p, t, cfg),
        adamw(1e-4), gpt_moe.init_params(cfg, seed=0),
        (gpt2.fake_batch(cfg.base, 8, 256, seed=0),), batch=8, seq=256)
    wcfg = wide_resnet.CONFIGS[0]
    run("wide_resnet 0", lambda p, x, y: wide_resnet.loss_fn(p, x, y, wcfg),
        sgd(0.1, momentum=0.9), wide_resnet.init_params(wcfg, seed=0),
        wide_resnet.fake_batch(wcfg, 32, 224, seed=0), batch=32, image=224)


# Serving phase: GPT-2 1.5B through the paged engine (page 16, max_len
# 1024, prefix cache, 256-token prefill chunks, an 8e9-byte pool budget).
# 16 requests, prompts of 64-512 tokens drawn from SERVE_SEED, 32 new tokens
# each; requests 0 and 9-15 open with one 256-token prefix. Requests 8-15
# are submitted once 0-7 have their first token, request 3 is cancelled
# after its 8th token and request 5 samples (temperature 0.8, top-k 50).
SERVE_REQUESTS, SERVE_NEW, SERVE_PREFIX, SERVE_SEED = 16, 32, 256, 11
SERVE_PROMPT = (64, 512)
SERVE_PREFIXED = (0, 9, 10, 11, 12, 13, 14, 15)
SERVE_CANCEL, SERVE_CANCEL_AT, SERVE_SAMPLED = 3, 8, 5
# The bf16 run's 20th scheduler step (a decode step of the full batch, all
# prefills done) runs under the profiler.
SERVE_PROFILE_AT = 20
SERVE_ENGINE = dict(page_size=16, max_len=1024, prefix_cache=True,
                    prefill_chunk=256, hbm_budget_bytes=8e9)
# Supervisor check: the same schedule at full width and 8 layers, with a
# decode fault injected at the 10th decode step.
SUPERVISOR_LAYERS = 8
SUPERVISOR_FAULT = "serve_fault:op=decode,step=10,ti=0"
TELEMETRY_CALLS = 100_000


def phase_telemetry() -> None:
    """The port's telemetry core on the card's host: the native rings must
    have loaded (the build phase built them); the ns per enabled span and
    per counter increment are measurements."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.telemetry import _fastobs

    tracer = telemetry.configure(enabled=True)
    native = _fastobs.available() and tracer._core is not None
    span, n = telemetry.span, TELEMETRY_CALLS
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    loop_ns = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("bench:span", cat="bench"):
            pass
    span_ns = (time.perf_counter_ns() - t0) / n
    counter = telemetry.metrics().counter("bench_counter")
    t0 = time.perf_counter_ns()
    for _ in range(n):
        counter.inc()
    counter_ns = (time.perf_counter_ns() - t0) / n
    tracer.clear()
    telemetry.metrics().reset()
    emit({"phase": "telemetry", "native_rings": native, "calls": n,
          "ns_per_enabled_span": span_ns, "ns_per_counter_inc": counter_ns,
          "ns_per_empty_loop_iteration": loop_ns})
    if not native:
        raise SystemExit("chip_smoke: the native telemetry rings did not "
                         "load")


def _serve_schedule(vocab: int):
    """The serving phase's 16 requests (see SERVE_*), from SERVE_SEED."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED)
    prefix = rng.integers(0, vocab, SERVE_PREFIX)
    out = []
    for i in range(SERVE_REQUESTS):
        if i in SERVE_PREFIXED:
            n = int(rng.integers(SERVE_PREFIX + 16, SERVE_PROMPT[1] + 1))
            prompt = np.concatenate(
                [prefix, rng.integers(0, vocab, n - SERVE_PREFIX)])
        else:
            n = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
            prompt = rng.integers(0, vocab, n)
        sampled = i == SERVE_SAMPLED
        out.append({"rid": f"r{i}", "prompt": prompt.astype(np.int32),
                    "wave": int(i >= SERVE_REQUESTS // 2),
                    "kw": dict(max_new_tokens=SERVE_NEW, greedy=not sampled,
                               temperature=0.8 if sampled else 1.0,
                               top_k=50 if sampled else 0,
                               seed=1234 if sampled else 0)})
    return out


def _drive(server, schedule, has_work, profile_at=None) -> dict:
    """Run ``schedule`` through an engine or supervisor in lockstep: the
    second wave is submitted once the first has its first tokens, and the
    cancel lands after its SERVE_CANCEL_AT-th token. Host-clock TTFT is
    read after each scheduler step. Scheduler step ``profile_at`` runs
    under the profiler (a measurement; it leaves the schedule as is)."""
    t_sub, ttft, waves = {}, {}, {0: False, 1: False}
    cancel_rid = f"r{SERVE_CANCEL}"
    cancelled, steps, peak_pages = False, 0, 0

    def submit(wave):
        waves[wave] = True
        for r in schedule:
            if r["wave"] == wave:
                t_sub[r["rid"]] = time.perf_counter()
                out = server.submit(r["rid"], r["prompt"], **r["kw"])
                if out["status"] != "queued":
                    raise SystemExit(f"chip_smoke: {r['rid']} not queued: "
                                     f"{out}")

    submit(0)
    t0 = time.perf_counter()
    while True:
        if not has_work():
            if waves[1]:
                break
            submit(1)
        if steps + 1 == profile_at:
            _profile_step("GPT-2 1.5B serving, scheduler step "
                          f"{profile_at}", server.step, None)
        else:
            server.step()
        steps += 1
        now = time.perf_counter()
        res = {r["request_id"]: r for r in server.poll()}
        for rid, r in res.items():
            if r["n_tokens"] and rid not in ttft:
                ttft[rid] = (now - t_sub[rid]) * 1e3
        peak_pages = max(peak_pages, server.stats().get("pages_used", 0))
        if not waves[1] and all(res[r["rid"]]["n_tokens"]
                                for r in schedule if r["wave"] == 0):
            submit(1)
        if not cancelled and res[cancel_rid]["n_tokens"] >= SERVE_CANCEL_AT:
            cancelled = server.cancel(cancel_rid)
        if steps > 20 * SERVE_REQUESTS * SERVE_NEW:
            raise SystemExit("chip_smoke: the serving schedule did not end")
    wall = time.perf_counter() - t0
    return {"results": {r["request_id"]: r for r in server.poll()},
            "host_ttft_ms": ttft, "steps": steps, "wall_s": wall,
            "peak_pages": peak_pages}


def _check_statuses(run: dict, label: str) -> None:
    """Every request ends as the schedule implies: the cancelled one with
    SERVE_CANCEL_AT tokens (one more when a supervisor replay's first
    token and first decode land in one step), every other one done with
    SERVE_NEW tokens."""
    for rid, r in run["results"].items():
        if rid == f"r{SERVE_CANCEL}":
            ok = (r["status"] == "cancelled"
                  and SERVE_CANCEL_AT <= r["n_tokens"] <= SERVE_CANCEL_AT + 1)
        else:
            ok = r["status"] == "done" and r["n_tokens"] == SERVE_NEW
        if not ok:
            raise SystemExit(f"chip_smoke: {label}: {rid} ended "
                             f"{r['status']} with {r['n_tokens']} tokens")
    if len(run["results"]) != SERVE_REQUESTS:
        raise SystemExit(f"chip_smoke: {label}: {len(run['results'])} "
                         f"results for {SERVE_REQUESTS} requests")


def _sample_reference(params, cfg, schedule, run) -> int:
    """Requests whose tokens differ from the port's ``sample()`` on their
    prompt alone (the sampled one with a generator seeded as the engine
    seeds it); a cancelled request is held over the tokens it got."""
    import torch

    from tepdist_tpu_torch.models import sampling

    bad = 0
    for r in schedule:
        got = run["results"][r["rid"]]["tokens"]
        kw = r["kw"]
        gen = None
        if not kw["greedy"]:
            gen = torch.Generator(device="cuda").manual_seed(kw["seed"])
        prompt = torch.as_tensor(r["prompt"], device="cuda").long()[None]
        want = sampling.sample(
            params, prompt, cfg, max_new_tokens=len(got),
            greedy=kw["greedy"], temperature=kw["temperature"],
            top_k=kw["top_k"], generator=gen)[0, prompt.shape[1]:]
        bad += want.tolist() != got
    return bad


def _tokens_differ(a: dict, b: dict) -> list:
    """Rids whose token lists differ between two runs' results (over the
    shorter list where one run cancelled a step later)."""
    out = []
    for rid in a:
        x, y = a[rid]["tokens"], b[rid]["tokens"]
        n = min(len(x), len(y))
        if x[:n] != y[:n]:
            out.append(rid)
    return out


def _quantiles(values) -> dict:
    v = sorted(values)
    if not v:
        return {"p50": None, "p99": None, "n": 0}
    return {"p50": v[len(v) // 2],
            "p99": v[min(len(v) - 1, int(round(0.99 * (len(v) - 1))))],
            "n": len(v)}


def phase_serving() -> dict:
    """GPT-2 1.5B at full width and depth served through the paged
    ``ServingEngine`` (module comment at SERVE_*): in fp32 with TF32 off,
    every request's tokens equal ``sample()`` on its prompt alone and a
    slot-mode engine's on the same schedule; in bf16, statuses, zero pages
    after drain, the prefix hits, the TTFT histogram's count and no flash
    launch are checked and the run is timed; then the supervisor replays a
    decode fault at 8 layers exactly once. Returns the fp32 paged run's
    results by request id (the serve_rpc phase's reference)."""
    import torch

    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.serving import ServingEngine, ServingSupervisor
    from tepdist_tpu_torch.telemetry import flight

    smi = nvidia_smi()
    base = gpt2.CONFIGS["1.5B"]
    schedule = _serve_schedule(base.vocab_size)
    cfg32 = dataclasses.replace(base, dtype=torch.float32)

    def counters():
        return telemetry.metrics().snapshot()["counters"]

    # fp32: paged engine against sample() and against the slot engine.
    params = gpt2.init_params(cfg32, seed=21, device="cuda")
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg32, kv_mode="paged", **SERVE_ENGINE)
    paged = _drive(eng, schedule, eng._has_work)
    _check_statuses(paged, "fp32 paged")
    hits32 = counters().get("prefix_hits", 0)
    del eng
    slot_eng = ServingEngine(params, cfg32, kv_mode="slots",
                             slots=SERVE_REQUESTS,
                             max_len=SERVE_ENGINE["max_len"])
    slots = _drive(slot_eng, schedule, slot_eng._has_work)
    del slot_eng
    vs_slots = _tokens_differ(paged["results"], slots["results"])
    vs_sample = _sample_reference(params, cfg32, schedule, paged)
    fp32_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    # bf16: the timed run, traced.
    params = gpt2.init_params(base, seed=21, device="cuda")
    tracer = telemetry.configure(enabled=True, capacity=1 << 16)
    tracer.clear()
    telemetry.metrics().reset()
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(params, base, kv_mode="paged", **SERVE_ENGINE)
    run = _drive(eng, schedule, eng._has_work, profile_at=SERVE_PROFILE_AT)
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()
    flash = dict(fa.launch_counts)
    eng.drain(wait_ms=0)
    st = eng.stats()
    snap = telemetry.metrics().snapshot()
    spans = tracer.snapshot()
    os.makedirs(OUT_DIR, exist_ok=True)
    trace_path = os.path.join(OUT_DIR, "serving_trace.json")
    telemetry.write_trace(telemetry.build_trace(
        [{"pid": 0, "label": "serving", "spans": spans,
          "metrics": snap, "spans_dropped": tracer.dropped}]), trace_path)
    telemetry.configure(enabled=False)
    _check_statuses(run, "bf16 paged")
    decode_ms = {}
    for sp in spans:
        if sp["name"] == "serve:decode":
            decode_ms.setdefault(sp["args"]["batch"], []).append(
                sp["dur"] / 1e3)
    chunk_ms = _time_chunk(eng)
    del eng
    n_first = sum(1 for r in run["results"].values() if r["n_tokens"])
    hist = snap["histograms"].get("serve_ttft_ms", {})
    c = snap["counters"]
    tokens = sum(r["n_tokens"] for r in run["results"].values())
    emit({"phase": "serving", "model": "GPT-2 1.5B",
          "n_layer": base.n_layer, "nvidia_smi": smi,
          "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
          "engine": SERVE_ENGINE, "pages": st["pages"],
          "check_dtype": "float32, TF32 off",
          "fp32_requests_differing_from_sample": vs_sample,
          "fp32_requests_differing_from_slots": vs_slots,
          "fp32_prefix_hits": hits32, "fp32_seconds": fp32_s,
          "timed_dtype": "bfloat16",
          "statuses": {k: r["status"] for k, r in run["results"].items()},
          "scheduler_steps": run["steps"], "wall_seconds": run["wall_s"],
          "tokens": tokens, "tokens_per_s": tokens / run["wall_s"],
          "ttft_ms_histogram": {"p50": hist.get("p50"),
                                "p99": hist.get("p99"),
                                "count": hist.get("count")},
          "ttft_ms_host": _quantiles(run["host_ttft_ms"].values()),
          "decode_step_ms_by_batch": {
              b: _quantiles(v) for b, v in sorted(decode_ms.items())},
          "prefill_ms_per_256_chunk": chunk_ms,
          "max_memory_allocated_bytes": peak_bytes,
          "peak_pages_used": run["peak_pages"],
          "serve_compiles": c.get("serve_compiles", 0),
          "prefix_hits": c.get("prefix_hits", 0),
          "prefix_hit_tokens": c.get("prefix_hit_tokens", 0),
          "serve_prefill_tokens": c.get("serve_prefill_tokens", 0),
          "pages_used_after_drain": st["pages_used"],
          "page_refs_after_drain": st["page_refs"],
          "flash_launches": flash, "trace": trace_path,
          "trace_spans": len(spans), "trace_spans_dropped": tracer.dropped})
    if vs_sample or vs_slots:
        raise SystemExit(f"chip_smoke: fp32 serving differs from sample() "
                         f"in {vs_sample} requests, from slot mode in "
                         f"{vs_slots}")
    if st["pages_used"] or st["page_refs"]:
        raise SystemExit(f"chip_smoke: pages left after drain: {st}")
    hits = min(hits32, c.get("prefix_hits", 0))
    if hits < len(SERVE_PREFIXED) - 1:
        raise SystemExit(f"chip_smoke: {hits} prefix hits, want "
                         f">= {len(SERVE_PREFIXED) - 1}")
    if hist.get("count") != n_first:
        raise SystemExit(f"chip_smoke: serve_ttft_ms counted "
                         f"{hist.get('count')}, {n_first} first tokens")
    if any(flash.values()):
        raise SystemExit(f"chip_smoke: serving launched flash kernels "
                         f"{flash}")
    del params
    torch.cuda.empty_cache()

    # Supervisor: a decode fault at 8 layers, replayed exactly once.
    cfg8 = dataclasses.replace(cfg32, n_layer=SUPERVISOR_LAYERS)
    params = gpt2.init_params(cfg8, seed=21, device="cuda")
    eng = ServingEngine(params, cfg8, kv_mode="paged", **SERVE_ENGINE)
    clean = _drive(eng, schedule, eng._has_work)
    del eng
    sup = ServingSupervisor(params, cfg8, task_index=0, kv_mode="paged",
                            max_restarts=3, **SERVE_ENGINE)
    flight.recorder().snapshot(clear=True)
    before = counters()
    faults.configure(SUPERVISOR_FAULT)
    try:
        faulted = _drive(sup, schedule, lambda: sup.engine._has_work())
    finally:
        faults.configure(None)
    after = counters()
    delivered = {}
    for ev in flight.recorder().snapshot()["events"]:
        if ev["ev"] == "deliver":
            delivered[ev["rid"]] = delivered.get(ev["rid"], 0) + 1
    done = sum(r["status"] == "done" for r in faulted["results"].values())
    completed = (after.get("serve_requests_completed", 0)
                 - before.get("serve_requests_completed", 0))
    injected = (after.get("fault_injected:serve_fault", 0)
                - before.get("fault_injected:serve_fault", 0))
    differ = _tokens_differ(faulted["results"], clean["results"])
    emit({"phase": "serving_supervisor", "n_layer": SUPERVISOR_LAYERS,
          "dtype": "float32, TF32 off", "fault": SUPERVISOR_FAULT,
          "faults_injected": injected, "restarts": sup.restarts,
          "deliveries": delivered, "completed": completed, "done": done,
          "requests_differing_from_uninterrupted": differ,
          "statuses": {k: r["status"]
                       for k, r in faulted["results"].items()}})
    _check_statuses(faulted, "supervisor")
    if injected != 1 or sup.restarts != 1:
        raise SystemExit(f"chip_smoke: supervisor restarted "
                         f"{sup.restarts} times on {injected} faults, "
                         f"want 1 and 1")
    if (sorted(delivered) != sorted(faulted["results"])
            or set(delivered.values()) != {1} or completed != done):
        raise SystemExit(f"chip_smoke: not delivered exactly once: "
                         f"{delivered}, completed {completed} of {done}")
    if differ:
        raise SystemExit(f"chip_smoke: supervised tokens differ from the "
                         f"uninterrupted run in {differ}")
    del sup, params
    torch.cuda.empty_cache()
    return paged["results"]


# serve_rpc phase: the serving phase's schedule through the service:
# ServeClient over SERVE_RPC_SERVERS in-process servers on card 0, each
# with a supervised engine from LoadServable (the serving phase's engine
# settings). First one KV handoff: r0's prompt prefilled on server 0
# (prefill_only), adopted by server 1 (AdoptPages pulling ExportPages),
# released on server 0, decoded on server 1. Then the schedule: the first
# wave, the second once the first has its first tokens, r3 cancelled after
# SERVE_CANCEL_AT tokens, and server 1 drained right after the second wave
# (its queued requests resubmitted on server 0 under their ids). In fp32
# (TF32 off) every request's tokens equal the serving phase's engine's;
# in bf16 the same schedule is timed. Budget: about 90 s.
SERVE_RPC_SERVERS = 2


def _serve_rpc_run(sc, schedule) -> dict:
    """The schedule through ServeClient ``sc`` (module comment above):
    results by id, host TTFT, the drain's report and the wall."""
    t_sub, ttft, waves = {}, {}, {0: False, 1: False}
    cancel_rid, cancelled, drain = f"r{SERVE_CANCEL}", False, None

    def submit(wave):
        waves[wave] = True
        for r in schedule:
            if r["wave"] == wave:
                t_sub[r["rid"]] = time.perf_counter()
                out = sc.submit(r["prompt"], request_id=r["rid"],
                                **r["kw"])
                if out["status"] != "queued":
                    raise SystemExit(f"chip_smoke: serve_rpc {r['rid']} "
                                     f"not queued: {out}")

    from tepdist_tpu_torch.serving.engine import TERMINAL

    submit(0)
    t0 = time.perf_counter()
    while True:
        res = sc.poll(wait_ms=5.0)
        now = time.perf_counter()
        for rid, r in res.items():
            if r["n_tokens"] and rid not in ttft:
                ttft[rid] = (now - t_sub[rid]) * 1e3
        if not waves[1] and all(res[r["rid"]]["n_tokens"]
                                for r in schedule if r["wave"] == 0):
            submit(1)
            drain = sc.drain(SERVE_RPC_SERVERS - 1, wait_ms=0.0)
        if (not cancelled and cancel_rid in res
                and res[cancel_rid]["n_tokens"] >= SERVE_CANCEL_AT):
            cancelled = sc.cancel(cancel_rid)
        if waves[1] and all(r["status"] in TERMINAL
                            for r in res.values()):
            break
        if now - t0 > 600:
            raise SystemExit("chip_smoke: the serve_rpc schedule did not "
                             "end")
    return {"results": sc.poll(), "host_ttft_ms": ttft,
            "wall_s": time.perf_counter() - t0, "drain": drain}


def _serve_rpc_handoff(sc, servers, rid, r) -> list:
    """One KV handoff server 0 -> server 1 of request ``rid``; its
    tokens."""
    (c0, s0), (c1, s1) = sc._placements[0], sc._placements[1]
    c0.submit_request(s0, rid, r["prompt"], prefill_only=True, **r["kw"])
    for _ in range(6000):
        st = c0.poll_result(s0, [rid], wait_ms=20)[0]
        if st["status"] == "prefilled":
            break
    if st["status"] != "prefilled":
        raise SystemExit(f"chip_smoke: handoff prefill ended {st}")
    out = c1.adopt_pages(s1, rid, r["prompt"], source_addr=servers[0],
                         source_sid=s0, **r["kw"])
    if out.get("status") != "adopted":
        raise SystemExit(f"chip_smoke: AdoptPages answered {out}")
    if not c0.export_pages(s0, rid, release=True)["released"]:
        raise SystemExit("chip_smoke: ExportPages did not release")
    for _ in range(6000):
        st = c1.poll_result(s1, [rid], wait_ms=20)[0]
        if st["status"] == "done":
            return list(st["tokens"])
    raise SystemExit(f"chip_smoke: the adopted request ended {st}")


def phase_serve_rpc(fp32_results) -> None:
    """GPT-2 1.5B served through the service (module comment at
    SERVE_RPC_SERVERS): ServeClient, LoadServable, the serve verbs, a
    KV handoff and a drain; fp32 tokens held to the serving phase's
    engine, then a timed bf16 run."""
    import torch

    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer
    from tepdist_tpu_torch.serving.client import ServeClient
    from tepdist_tpu_torch.telemetry import flight

    smi = nvidia_smi()
    base = gpt2.CONFIGS["1.5B"]
    schedule = _serve_schedule(base.vocab_size)
    engine = dict(SERVE_ENGINE, slots=SERVE_REQUESTS)
    servers = [f"inproc:{9300 + i}" for i in range(SERVE_RPC_SERVERS)]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, dtype=dtype)
        servicers = [TepdistServicer([torch.device("cuda", 0)],
                                     task_index=i)
                     for i in range(SERVE_RPC_SERVERS)]
        for a, sv in zip(servers, servicers):
            inproc.register_servicer(a, sv)
        sc = ServeClient(servers)
        timed = dtype == torch.bfloat16
        try:
            params = gpt2.init_params(cfg, seed=21, device="cuda")
            t0 = time.perf_counter()
            sc.load(params, cfg, name=f"gpt2-{cfg.dtype}", **engine)
            load_s = time.perf_counter() - t0
            del params
            torch.cuda.empty_cache()
            telemetry.metrics().reset()
            handoff = _serve_rpc_handoff(sc, servers, "kv0", schedule[0])
            if timed:
                tracer = telemetry.configure(enabled=True,
                                             capacity=1 << 16)
                tracer.clear()
            fa.reset_launch_counts()
            if timed:
                flight.recorder().clear()
            run = _serve_rpc_run(sc, schedule)
            snap = telemetry.metrics().snapshot()
            spans = tracer.snapshot() if timed else []
            if timed:
                telemetry.configure(enabled=False)
                # The timed run's flight recording, merged: the
                # explore_tools phase's request_trace input.
                sc.dump_trace(path=SERVE_RPC_TRACE)
            out[str(dtype)] = dict(run=run, handoff=handoff, load_s=load_s,
                                   snap=snap, spans=spans,
                                   flash=dict(fa.launch_counts))
        finally:
            sc.close()
            for a, sv in zip(servers, servicers):
                sv.close_servables()
                inproc.unregister_servicer(a)
            torch.cuda.empty_cache()
    r32 = out[str(torch.float32)]
    _check_statuses(r32["run"], "serve_rpc fp32")
    differ = _tokens_differ(r32["run"]["results"], fp32_results)
    kv_ok = r32["handoff"] == fp32_results["r0"]["tokens"]
    b = out[str(torch.bfloat16)]
    _check_statuses(b["run"], "serve_rpc bf16")
    hist = b["snap"]["histograms"].get("serve_ttft_ms", {})
    decode_ms = {}
    for sp in b["spans"]:
        if sp["name"] == "serve:decode":
            decode_ms.setdefault(sp["args"]["batch"], []).append(
                sp["dur"] / 1e3)
    tokens = sum(r["n_tokens"] for r in b["run"]["results"].values())
    c = b["snap"]["counters"]
    emit({"phase": "serve_rpc", "model": "GPT-2 1.5B", "nvidia_smi": smi,
          "servers": SERVE_RPC_SERVERS,
          "devices": "every server on cuda:0 (inproc: addresses)",
          "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
          "engine": engine, "check_dtype": "float32, TF32 off",
          "fp32_requests_differing_from_serving_phase": differ,
          "fp32_kv_handoff_equal": kv_ok,
          "fp32_drain": r32["run"]["drain"],
          "load_seconds": {k: v["load_s"] for k, v in out.items()},
          "timed_dtype": "bfloat16",
          "statuses": {k: r["status"]
                       for k, r in b["run"]["results"].items()},
          "wall_seconds": b["run"]["wall_s"], "tokens": tokens,
          "tokens_per_s": tokens / b["run"]["wall_s"],
          "ttft_ms_histogram": {"p50": hist.get("p50"),
                                "p99": hist.get("p99"),
                                "count": hist.get("count")},
          "ttft_ms_host": _quantiles(b["run"]["host_ttft_ms"].values()),
          "decode_step_ms_by_batch": {
              k: _quantiles(v) for k, v in sorted(decode_ms.items())},
          "drain": b["run"]["drain"],
          "drain_handoffs": c.get("drain_handoffs", 0),
          "prefix_hits": c.get("prefix_hits", 0),
          "kv_pages_adopted": c.get("kv_pages_adopted", 0),
          "flash_launches": b["flash"]})
    if differ or not kv_ok:
        raise SystemExit(f"chip_smoke: serve_rpc fp32 tokens differ from "
                         f"the serving phase's in {differ} (KV handoff "
                         f"equal: {kv_ok})")
    for k, v in out.items():
        if any(v["flash"].values()):
            raise SystemExit(f"chip_smoke: serve_rpc launched flash "
                             f"kernels {v['flash']} ({k})")


# serve_fleet phase (ROADMAP item 17), every servicer on card 0 behind an
# inproc: address. Budget: about 150 s.
# - sharded: GPT-2 1.5B in fp32 (TF32 off, full width, SHARD_LAYERS
#   deep) through load_fleet_servable over SHARD_WORKERS servicers, with
#   hbm_budget_bytes the card's HBM (the h100 entry's 80 GB): a paged pool
#   that large beside the weights overflows verify_servable, so the load
#   goes through plan_sharded_servable's split (the whole explore). The
#   greedy tokens of SHARD_PROMPTS prompts (the serving schedule's first
#   ones) x SHARD_NEW must equal sample()'s bit for bit.
# - disagg: FleetRouter(prefill=1, decode=1) at full width and depth on
#   the serving phase's 16 requests (no waves, no cancel), the serving
#   phase's engine settings with 16 slots: in fp32 every request's tokens
#   equal the serving phase's engine's (the cancelled one over its
#   tokens); in bf16 timed: TTFT, the disagg_ttft_ms and kv_handoff_ms
#   histograms, pages moved against the live pages. Both: the affinity
#   hits, and no page left after drain_all.
# - trace: tools/torch_fidelity_report.py --trace on the fleet phase's
#   merged trace of one fleet step: the fitted constants and the step
#   error before and after calibration. The profile is written to
#   SHARD_PROFILE and installed nowhere (the h100 entry keeps its
#   constants).
SHARD_WORKERS, SHARD_PROMPTS, SHARD_NEW = 2, 4, 32
# Depth cut from 48 to 8 layers: the shard planner (the whole explore at
# n_devices=2, its candidate space uncut) takes 117.7 s at 48 layers and
# 20.5 s at 8 on the card's host (tools/torch_serve_shard_plan.py).
SHARD_LAYERS = 8
SHARD_HBM_BUDGET = 80e9
SHARD_PROFILE = os.path.join("chiprun_out", "fleet_calibration.json")
DISAGG_SERVERS = 2


def _fleet_servicers(n: int, port0: int):
    """``n`` servicers on card 0 behind inproc: addresses, and a client
    each."""
    import torch

    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.client import TepdistClient
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    addrs = [f"inproc:{port0 + i}" for i in range(n)]
    servicers = [TepdistServicer([torch.device("cuda", 0)], task_index=i)
                 for i in range(n)]
    for a, sv in zip(addrs, servicers):
        inproc.register_servicer(a, sv)
    return addrs, servicers, [TepdistClient(a) for a in addrs]


def _close_fleet(addrs, servicers, clients) -> None:
    import torch

    from tepdist_tpu_torch.rpc import inproc

    for c in clients:
        c.close()
    for a, sv in zip(addrs, servicers):
        sv.close_servables()
        inproc.unregister_servicer(a)
    torch.cuda.empty_cache()


def _serve_sharded(schedule) -> dict:
    """The sharded arm (module comment at SHARD_*)."""
    import numpy as np
    import torch

    from tepdist_tpu_torch.models import gpt2, sampling
    from tepdist_tpu_torch.serving import ShardedServable, fleet

    cfg = dataclasses.replace(gpt2.CONFIGS["1.5B"], n_layer=SHARD_LAYERS,
                              dtype=torch.float32)
    params = gpt2.init_params(cfg, seed=21, device="cuda")
    planned = {}
    plan_fn = fleet.plan_sharded_servable

    def timed_plan(*args, **kwargs):
        t0 = time.perf_counter()
        out = plan_fn(*args, **kwargs)
        planned["seconds"] = time.perf_counter() - t0
        return out

    fleet.plan_sharded_servable = timed_plan
    hops = []
    fleet_ = _fleet_servicers(SHARD_WORKERS, 9400)
    try:
        t0 = time.perf_counter()
        sv = fleet.load_fleet_servable(
            fleet_[2], params, cfg, name="gpt2-sharded",
            max_len=SERVE_ENGINE["max_len"],
            page_size=SERVE_ENGINE["page_size"],
            hbm_budget_bytes=SHARD_HBM_BUDGET)
        load_s = time.perf_counter() - t0
        if not isinstance(sv, ShardedServable):
            raise SystemExit(f"chip_smoke: the {SHARD_HBM_BUDGET:.0f} B "
                             f"budget loaded {type(sv).__name__}, not a "
                             "sharded servable")
        for s_, (c, _) in enumerate(sv.placements):
            def hop(sid, op, array, pos=0, fn=c.execute_servable_slice,
                    s_=s_):
                out = fn(sid, op, array, pos=pos)
                hops.append((s_, op, int(out.nbytes)))
                return out
            c.execute_servable_slice = hop
        prompts = [r["prompt"] for r in schedule[:SHARD_PROMPTS]]
        got, ms_per_token = [], []
        for p in prompts:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got.append(sv.generate_one(p, max_new_tokens=SHARD_NEW))
            ms_per_token.append((time.perf_counter() - t1) * 1e3
                                / SHARD_NEW)
        want, sample_ms = [], []
        for p in prompts:
            prompt = torch.as_tensor(p, device="cuda").long()[None]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want.append(sampling.sample(
                params, prompt, cfg, max_new_tokens=SHARD_NEW,
                greedy=True)[0].cpu().numpy())
            torch.cuda.synchronize()
            sample_ms.append((time.perf_counter() - t1) * 1e3 / SHARD_NEW)
        plan = sv.plan
        stages = [s.servables[sid].stats()["stage"]
                  for s, (_, sid) in zip(fleet_[1], sv.placements)]
    finally:
        fleet.plan_sharded_servable = plan_fn
        _close_fleet(*fleet_)
        del params
    differ = [i for i, (g, w) in enumerate(zip(got, want))
              if not np.array_equal(g, w)]
    by_hop = {}
    for s_, op, nbytes in hops:
        by_hop.setdefault(f"stage{s_}:{op}", []).append(nbytes)
    best = plan["candidates"][0]
    return {"n_layer": SHARD_LAYERS, "dtype": "float32, TF32 off",
            "workers": SHARD_WORKERS,
            "hbm_budget_bytes": SHARD_HBM_BUDGET,
            "stages": stages, "num_stages": plan["num_stages"],
            "fallback": plan["fallback"],
            "global_best": {k: best.get(k) for k in (
                "kind", "num_stages", "intra_tp", "placement")}
            | ({"topology": str(best["topology"])}
               if "topology" in best else {}),
            "candidates": plan["n_candidates"],
            "planner_seconds": planned.get("seconds"),
            "explore_phases": plan["explore_phases"],
            "load_seconds": load_s,
            "prompts": [len(p) for p in prompts],
            "new_tokens": SHARD_NEW,
            "ms_per_token": _quantiles(ms_per_token),
            "sample_ms_per_token": _quantiles(sample_ms),
            "bytes_per_hop": {k: {"first": v[0], "last": v[-1],
                                  "n": len(v)}
                              for k, v in sorted(by_hop.items())},
            "prompts_differing_from_sample": differ}


def _serve_disagg(schedule, fp32_results) -> dict:
    """The disagg arm (module comment at SHARD_*): fp32 held to the
    serving phase's engine, then bf16 timed."""
    import torch

    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.serving import FleetRouter, pages_for

    base = gpt2.CONFIGS["1.5B"]
    engine = dict(SERVE_ENGINE, slots=SERVE_REQUESTS)
    live = sum(pages_for(len(r["prompt"]), engine["page_size"])
               for r in schedule)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, dtype=dtype)
        fleet_ = _fleet_servicers(DISAGG_SERVERS, 9500)
        try:
            router = FleetRouter(fleet_[2], prefill=1, decode=1)
            params = gpt2.init_params(cfg, seed=21, device="cuda")
            t0 = time.perf_counter()
            router.load(params, cfg, name=f"gpt2-disagg-{cfg.dtype}",
                        **engine)
            load_s = time.perf_counter() - t0
            del params
            torch.cuda.empty_cache()
            telemetry.metrics().reset()
            t0 = time.perf_counter()
            for r in schedule:
                router.submit(r["prompt"], request_id=r["rid"], **r["kw"])
            handed = [router.handoff(r["rid"], timeout_s=600)
                      for r in schedule]
            results = router.wait([r["rid"] for r in schedule],
                                  timeout_s=600)
            wall = time.perf_counter() - t0
            snap = telemetry.metrics().snapshot()
            router.drain_all(wait_ms=5000.0)
            leaked = sum(int(e.stats().get("pages_used", 0))
                         for sv in fleet_[1] for e in sv.servables.values())
            out[str(dtype)] = dict(
                results=results, wall_s=wall, load_s=load_s, snap=snap,
                leaked=leaked, ttft=list(router.ttft_ms),
                handoff=list(router.handoff_ms),
                adopted=[h.get("status") for h in handed])
        finally:
            _close_fleet(*fleet_)
    r32, b = out[str(torch.float32)], out[str(torch.bfloat16)]
    differ = _tokens_differ(r32["results"], fp32_results)
    hist = b["snap"]["histograms"]
    tokens = sum(r["n_tokens"] for r in b["results"].values())

    def pages(run):
        c = run["snap"]["counters"]
        return {k: c.get(k, 0) for k in (
            "kv_pages_exported", "kv_pages_adopted", "kv_pages_reused",
            "pool_handoffs", "prefix_affinity_hits", "prefix_hits")}

    return {"requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "engine": engine, "live_pages": live,
            "fp32_requests_differing_from_serving_phase": differ,
            "statuses": {k: sorted({r["status"]
                                    for r in v["results"].values()})
                         for k, v in out.items()},
            "adopt_answers": {k: sorted(set(v["adopted"]))
                              for k, v in out.items()},
            "pages": {k: pages(v) for k, v in out.items()},
            "pages_after_drain_all": {k: v["leaked"]
                                      for k, v in out.items()},
            "load_seconds": {k: v["load_s"] for k, v in out.items()},
            "timed_dtype": "bfloat16", "wall_seconds": b["wall_s"],
            "tokens": tokens, "tokens_per_s": tokens / b["wall_s"],
            "ttft_ms_host": _quantiles(b["ttft"]),
            "disagg_ttft_ms": {k: hist.get("disagg_ttft_ms", {}).get(k)
                               for k in ("p50", "p99", "count")},
            "kv_handoff_ms": {k: hist.get("kv_handoff_ms", {}).get(k)
                              for k in ("p50", "p99", "count")},
            "kv_handoff_ms_host": _quantiles(b["handoff"])}


def _fleet_fidelity(trace_path) -> dict:
    """tools/torch_fidelity_report.py --trace on the fleet phase's trace
    (its own process, as a user runs it)."""
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "torch_fidelity_report.py"),
         "--trace", trace_path, "--json", "--save-profile", SHARD_PROFILE],
        capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise SystemExit(f"chip_smoke: torch_fidelity_report.py exited "
                         f"{proc.returncode}: {proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout[proc.stdout.index("{"):
                                 proc.stdout.rindex("}") + 1])
    cal = rep["calibration"]
    return {"trace": trace_path, "step": rep["step"],
            "join": {k: rep["join"][k] for k in (
                "matched", "fraction", "skipped_bookkeeping")}
            | {"orphan_predicted": len(rep["join"]["orphan_predicted"]),
               "orphan_measured": len(rep["join"]["orphan_measured"])},
            "predicted_step_ms": rep.get("predicted_step_ms"),
            "measured_step_ms": rep.get("measured_step_ms"),
            "per_kind": rep["per_kind"],
            "profile": cal["profile"], "profile_path": SHARD_PROFILE,
            "uncalibrated_makespan_ms": rep.get("uncalibrated_makespan_ms"),
            "calibrated_makespan_ms": cal.get("calibrated_makespan_ms"),
            "uncalibrated_error_ms": cal.get("uncalibrated_error_ms"),
            "calibrated_error_ms": cal.get("calibrated_error_ms"),
            "resimulation": ("the trace's predicted timeline replayed in "
                             "its own order" if cal.get("replayed")
                             else "the task graph")}


def phase_serve_fleet(fp32_results, trace_path) -> dict:
    """Fleet serving on card 0 (module comment at SHARD_*): the sharded
    servable, the prefill/decode pools and the fleet trace's fidelity
    report. Fails on any token mismatch, a leaked page, a flash launch or
    a partial join. Returns the timed (bf16) disagg run's
    ``disagg_ttft_ms`` and ``kv_handoff_ms`` p50, the perf gate's
    values."""
    import torch

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa

    smi = nvidia_smi()
    schedule = _serve_schedule(gpt2.CONFIGS["1.5B"].vocab_size)
    seconds = {}
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    sharded = _serve_sharded(schedule)
    seconds["sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    disagg = _serve_disagg(schedule, fp32_results)
    seconds["disagg"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fidelity = _fleet_fidelity(trace_path)
    seconds["trace"] = time.perf_counter() - t0
    flash = dict(fa.launch_counts)
    emit({"phase": "serve_fleet", "model": "GPT-2 1.5B", "nvidia_smi": smi,
          "devices": "every servicer on cuda:0 (inproc: addresses)",
          "sharded": sharded, "disagg": disagg, "fidelity": fidelity,
          "flash_launches": flash, "arm_seconds": seconds})
    if sharded["prompts_differing_from_sample"]:
        raise SystemExit(f"chip_smoke: sharded tokens differ from "
                         f"sample() for prompts "
                         f"{sharded['prompts_differing_from_sample']}")
    if disagg["fp32_requests_differing_from_serving_phase"]:
        raise SystemExit(
            f"chip_smoke: disagg fp32 tokens differ from the serving "
            f"phase's in "
            f"{disagg['fp32_requests_differing_from_serving_phase']}")
    for k, st in disagg["statuses"].items():
        if st != ["done"] or disagg["adopt_answers"][k] != ["adopted"]:
            raise SystemExit(f"chip_smoke: disagg {k}: statuses {st}, "
                             f"adopts {disagg['adopt_answers'][k]}")
    for k, pg in disagg["pages"].items():
        if (pg["kv_pages_adopted"] + pg["kv_pages_reused"]
                != disagg["live_pages"]
                or pg["kv_pages_exported"] != pg["kv_pages_adopted"]
                or pg["pool_handoffs"] != SERVE_REQUESTS):
            raise SystemExit(f"chip_smoke: disagg {k} moved {pg}, "
                             f"live pages {disagg['live_pages']}")
        if pg["prefix_affinity_hits"] < len(SERVE_PREFIXED) - 1:
            raise SystemExit(f"chip_smoke: disagg {k}: "
                             f"{pg['prefix_affinity_hits']} affinity hits")
    if any(disagg["pages_after_drain_all"].values()):
        raise SystemExit(f"chip_smoke: pages left after drain_all: "
                         f"{disagg['pages_after_drain_all']}")
    if any(flash.values()):
        raise SystemExit(f"chip_smoke: serve_fleet launched flash kernels "
                         f"{flash}")
    if (fidelity["join"]["fraction"] != 1.0
            or fidelity["join"]["orphan_measured"]):
        raise SystemExit(f"chip_smoke: the fleet trace's join is partial: "
                         f"{fidelity['join']}")
    torch.cuda.empty_cache()
    return {k: disagg[k]["p50"] for k in ("disagg_ttft_ms", "kv_handoff_ms")}


# examples phase: the user's entry points (examples_torch/), called through
# their main(argv) in this process. Llama 1B with the flash kernels at
# full width and depth; the GPT-2 1.5B JSON example at its own batch and
# sequence (einsum, bf16: no flash launch), full width, depth cut to
# EXAMPLE_GPT2_LAYERS (EXAMPLE_GPT2_CUT); simple.py through a servicer on
# the card reached by SERVER_IP/PORT.
EXAMPLE_LLAMA = ["--config", "1B", "--attn", "flash", "--batch", "4",
                 "--seq", "512", "--steps", "6"]
EXAMPLE_GPT2_JSON = "examples_torch/GPT2/1.5B.json"
EXAMPLE_GPT2_LAYERS = 8
EXAMPLE_GPT2_CUT = ("depth cut from 48 to 8 layers (full width): at 48 "
                    "the example's auto_parallel plans in 80.7-90.2 s, at "
                    "24 the phase took 93.9 s and the whole script "
                    "1035.2 s on an H100 80GB HBM3 at 700 W)")
EXAMPLE_GPT2 = ["--steps", "6"]
EXAMPLE_SIMPLE = ["--steps", "3"]
EXAMPLE_INPROC_PORT = 14001


def _loss_falls(name: str, losses) -> None:
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: non-finite {name} loss {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: {name} loss did not fall {losses}")


def phase_examples() -> dict:
    """``examples_torch/llama/train.py`` (auto_parallel on data = 1,
    the flash kernels: L launches of each a step, a warm step and 6
    printed ones), ``examples_torch/GPT2/main.py`` with the 1.5B JSON at
    EXAMPLE_GPT2_LAYERS (planner seconds, step seconds, peak memory, no
    flash launch) and
    ``examples_torch/smoke_testing/simple.py`` through a ``TepdistServicer``
    on the card at ``inproc:EXAMPLE_INPROC_PORT`` (``SERVER_IP=inproc``):
    every loss finite, the last below the first (simple.py's falling step
    by step). Returns the Llama example's launches."""
    import torch

    from examples_torch.GPT2 import main as gpt2_example
    from examples_torch.llama import train as llama_example
    from examples_torch.smoke_testing import simple
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    smi = nvidia_smi()
    seconds, runs = {}, {}
    with open(EXAMPLE_GPT2_JSON) as f:
        gpt2_json = dict(json.load(f), n_layer=EXAMPLE_GPT2_LAYERS)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gpt2_")
    gpt2_config = os.path.join(workdir, "1.5B.json")
    with open(gpt2_config, "w") as f:
        json.dump(gpt2_json, f)
    for name, module, argv in (
            ("llama", llama_example, EXAMPLE_LLAMA),
            ("gpt2", gpt2_example,
             ["--config", gpt2_config] + EXAMPLE_GPT2)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = module.main(argv)
        seconds[name] = time.perf_counter() - t0
        out["launches"] = dict(fa.launch_counts)
        out["steps_run"] = len(out["losses"]) + 1
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        out["argv"] = argv
        runs[name] = out
    shutil.rmtree(workdir, ignore_errors=True)
    runs["gpt2"]["cut"] = EXAMPLE_GPT2_CUT
    llama = runs["llama"]
    L = 16
    llama["expected_launches"] = {n: L * llama["steps_run"] for n in KERNELS}
    address = f"inproc:{EXAMPLE_INPROC_PORT}"
    inproc.register_servicer(address, TepdistServicer(["cuda"]))
    saved = {k: os.environ.get(k) for k in ("SERVER_IP", "SERVER_PORT")}
    os.environ.update(SERVER_IP="inproc",
                      SERVER_PORT=str(EXAMPLE_INPROC_PORT))
    t0 = time.perf_counter()
    try:
        runs["simple"] = simple.main(EXAMPLE_SIMPLE)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        inproc.unregister_servicer(address)
    seconds["simple"] = time.perf_counter() - t0
    emit({"phase": "examples", "nvidia_smi": smi,
          "budget_seconds": 150, "seconds": seconds,
          "llama": llama, "gpt2": runs["gpt2"],
          "simple": {"address": address, "route": "SERVER_IP=inproc",
                     "losses": runs["simple"]["losses"],
                     "summary": runs["simple"]["summary"]}})
    _loss_falls("llama example", llama["losses"])
    _loss_falls("GPT-2 1.5B example", runs["gpt2"]["losses"])
    s_losses = runs["simple"]["losses"]
    if not all(b < a for a, b in zip(s_losses, s_losses[1:])):
        raise SystemExit(f"chip_smoke: simple.py losses {s_losses} do not "
                         "fall")
    if llama["launches"] != llama["expected_launches"]:
        raise SystemExit(f"chip_smoke: llama example launches "
                         f"{llama['launches']} != "
                         f"{llama['expected_launches']}")
    if any(runs["gpt2"]["launches"].values()):
        raise SystemExit(f"chip_smoke: the GPT-2 example (einsum) launched "
                         f"{runs['gpt2']['launches']}")
    torch.cuda.empty_cache()
    return llama["launches"]


def _load_tool(name: str):
    """A ``tools/`` script as a module (the directory is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOLS_CHAOS_ARMS = (("fleet", []),
                    ("kill_worker", ["--steps", "6", "--kill-worker", "3"]),
                    ("serve", ["--serve"]))
TOOLS_SERVE_LOAD = ["--config", "1.5B", "--workers", "2"]


def phase_tools(fleet_gate_values: dict) -> None:
    """``tools/torch_chaos_run.py``'s fleet, ``--kill-worker`` and
    ``--serve`` arms on the card (in-process workers on cuda:0), each
    passing its own assertion, then ``tools/torch_serve_load.py --config
    1.5B --workers 2``: every request done, TTFT p50 / p99 and tokens/s.
    The ``--kill-master`` arm needs gRPC subprocesses: CPU tests only.
    Last, the perf gate on this run's numbers (``_perf_gate``):
    ``fleet_gate_values`` from serve_fleet, the kill-worker arm's
    migration stall and the int8 wire ratio."""
    import torch

    from tepdist_tpu_torch.ops import flash_attention as fa

    chaos = _load_tool("torch_chaos_run")
    load = _load_tool("torch_serve_load")
    smi = nvidia_smi()
    arms, seconds = {}, {}
    fa.reset_launch_counts()
    for name, argv in TOOLS_CHAOS_ARMS:
        t0 = time.perf_counter()
        arms[name] = chaos.main(argv + ["--device", "cuda"])
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = load.main(TOOLS_SERVE_LOAD + ["--device", "cuda"])
    seconds["serve_load"] = time.perf_counter() - t0
    flash = dict(fa.launch_counts)
    emit({"phase": "tools", "nvidia_smi": smi, "budget_seconds": 60,
          "seconds": seconds, "chaos": arms,
          "serve_load": {k: summary[k] for k in (
              "requests", "statuses", "wall_s", "tokens", "tokens_per_s",
              "ttft_ms", "token_ms", "prefills", "decode_steps",
              "pages_used_after_drain")},
          "serve_load_argv": TOOLS_SERVE_LOAD, "flash_launches": flash})
    failed = [name for name, out in arms.items() if not out["ok"]]
    if failed:
        raise SystemExit(f"chip_smoke: chaos arms failed: {failed}")
    if summary["statuses"] != {"done": summary["requests"]}:
        raise SystemExit(f"chip_smoke: serve_load statuses "
                         f"{summary['statuses']}")
    if any(flash.values()):
        raise SystemExit(f"chip_smoke: the tools launched flash kernels "
                         f"{flash}")
    torch.cuda.empty_cache()
    _perf_gate(dict(fleet_gate_values,
                    migration_stall_ms=arms["kill_worker"][
                        "migration_stall_ms"],
                    quantized_ar_x=_quantized_ar_x()), smi)


# The perf gate step (end of the tools phase; budget 15 s): each value is
# recorded PERF_GATE_RECORDS times into a fresh history, then --check on
# the same values must pass (exit 0) and --seed-regression KEY:PCT must
# trip it (exit 1) for every key. The seeds are the smoke scripts' and
# sit above each key's noise band (BAND_FLOOR_PCT; 10% by default).
PERF_GATE_HISTORY = os.path.join(OUT_DIR, "torch_bench_history.jsonl")
PERF_GATE_RECORDS = 3
PERF_GATE_SEEDS = {"disagg_ttft_ms": 30, "kv_handoff_ms": 30,
                   "migration_stall_ms": 50, "quantized_ar_x": 20}


def _quantized_ar_x() -> float:
    """``tools/torch_quant_ratio.py`` on card tensors: the f32 against
    int8 wire bytes of ``encode_literal`` over the quant smoke's five
    gradient tensors; the f32 round trip must be exact."""
    got = _load_tool("torch_quant_ratio").measure("cuda")
    if got["f32_roundtrip_err"] != 0.0:
        raise SystemExit("chip_smoke: the f32 wire round trip of a card "
                         "tensor is not exact")
    return got["quantized_ar_x"]


def _perf_gate(values: dict, smi: str) -> None:
    """``tools/torch_perf_gate.py`` on ``values`` (module comment at
    PERF_GATE_HISTORY); one line with the verdict rows."""
    gate = _load_tool("torch_perf_gate")
    values = {k: float(v) for k, v in values.items()}
    keys = ",".join(sorted(values))
    record = [a for k, v in sorted(values.items())
              for a in ("--record-value", f"{k}={v!r}")]
    base = ["--history", PERF_GATE_HISTORY]

    def run(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return gate.main(base + argv)

    t0 = time.perf_counter()
    if os.path.exists(PERF_GATE_HISTORY):
        os.remove(PERF_GATE_HISTORY)
    for _ in range(PERF_GATE_RECORDS):
        run(record)
    check = run(["--check", "--keys", keys] + record)
    seeded = {}
    for key in sorted(values):
        pct = PERF_GATE_SEEDS[key]
        out = run(["--check", "--keys", key, "--record-value",
                   f"{key}={values[key]!r}", "--seed-regression",
                   f"{key}:{pct}"])
        seeded[key] = {"pct": pct, "rc": out["rc"],
                       "verdict": out["rows"][0]["verdict"],
                       "current": out["rows"][0]["current"],
                       "band": out["rows"][0].get("band")}
    seconds = time.perf_counter() - t0
    emit({"phase": "perf_gate", "nvidia_smi": smi, "budget_seconds": 15,
          "seconds": seconds, "history": PERF_GATE_HISTORY,
          "values": values, "check_rc": check["rc"],
          "rows": check["rows"], "seeded": seeded})
    if check["rc"]:
        raise SystemExit(f"chip_smoke: the perf gate failed on this run's "
                         f"own values:\n{check['text']}")
    if not all(v["rc"] == 1 and v["verdict"] == "regression"
               for v in seeded.values()):
        raise SystemExit(f"chip_smoke: a seeded regression did not trip "
                         f"the perf gate: {seeded}")
    if values["quantized_ar_x"] < 1.5:
        raise SystemExit(f"chip_smoke: quantized_ar_x "
                         f"{values['quantized_ar_x']} below 1.5")


# explore_tools phase (ROADMAP C13 and item 18). Budget: 120 s.
# - explore: GPT-2 1.5B at full width (1600 wide, 25 heads, vocab 50257,
#   seq 1024, flash, adamw_bf16), EXPLORE_LAYERS deep, batch EXPLORE_BATCH
#   in EXPLORE_MICRO micro batches, through TepdistSession.compile_training
#   with no mesh axes against a TepdistServicer over [cuda:0] *
#   EXPLORE_DEVICES behind an inproc: address: the servicer explores
#   (SPMD meshes over its one-rank world, pipeline cuts over its device
#   list), builds the winner and trains EXPLORE_STEPS steps; the third
#   loss must be below the first, each flash kernel must launch.
# - tools: torch_plan_explain --trace --check on this phase's dump_trace();
#   torch_trace_summary and torch_ledger_report --trace (with --single-ms,
#   the one-process pipeline step of the same program) on the fleet
#   phase's traced step; torch_request_trace --trace on serve_rpc's
#   ServeClient.dump_trace(); torch_verify_plan's report on the pipeline
#   phase's program and schedule (run there, while they live). A tool
#   that raises or returns non-zero fails the run.
EXPLORE_LAYERS, EXPLORE_BATCH, EXPLORE_MICRO = 4, 8, 4
EXPLORE_DEVICES, EXPLORE_STEPS = 4, 3
EXPLORE_TRACE = os.path.join("chiprun_out", "explore_trace.json")
SERVE_RPC_TRACE = os.path.join("chiprun_out", "serve_rpc_trace.json")
TOOLS_TEXT = os.path.join("chiprun_out", "explore_tools.txt")


def _run_tool(name, argv, texts):
    """``tools/torch_<name>.py``'s ``main(argv)``, its printed text kept
    in ``texts``; fails the run unless it returns 0."""
    import contextlib
    import io

    tool = _load_tool(f"torch_{name}")
    with contextlib.redirect_stdout(io.StringIO()):
        out = tool.main(argv)
    texts[name] = out["text"]
    if out["rc"]:
        raise SystemExit(f"chip_smoke: tools/torch_{name}.py {argv} "
                         f"returned {out['rc']}:\n{out['text'][-2000:]}")
    return out


def phase_explore_tools(verify_text: str, fleet_single_ms: float):
    """The explored pipeline and the read-only tools (module comment at
    EXPLORE_*), given the pipeline phase's verifier report and the fleet
    phase's one-process step (ms). Returns the kernels' launches over the
    steps and the rows a replica's flash calls take."""
    import torch
    import torch.distributed as dist

    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import flash_attention as fa
    from tepdist_tpu_torch.optim import adamw_bf16, optimizer_spec
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer
    from tepdist_tpu_torch.runtime.executor import stage_replicas

    smi = nvidia_smi()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = _config(EXPLORE_LAYERS)
    params = gpt2.init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, EXPLORE_BATCH, SEQ, seed=0, device="cuda")
    had_world = dist.is_initialized()
    ServiceEnv.reset()
    servicer = TepdistServicer([torch.device("cuda", 0)] * EXPLORE_DEVICES)
    address = "inproc:14501"
    inproc.register_servicer(address, servicer)
    try:
        sess = TepdistSession(address)
        t0 = time.perf_counter()
        summary = sess.compile_training(
            lambda p, t: gpt2.loss_fn(p, t, cfg), adamw_bf16(1e-4), params,
            tokens, num_micro_batches=EXPLORE_MICRO,
            optimizer_spec=optimizer_spec("adamw_bf16", learning_rate=1e-4))
        compile_s = time.perf_counter() - t0
        del params
        losses, seconds = [], []
        fa.reset_launch_counts()
        for _ in range(EXPLORE_STEPS):
            t0 = time.perf_counter()
            losses.append(sess.run(tokens))
            seconds.append(time.perf_counter() - t0)
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        trace_path = sess.dump_trace(path=EXPLORE_TRACE)
        sess.close()
    finally:
        inproc.unregister_servicer(address)
        ServiceEnv.reset()
        if dist.is_initialized() and not had_world:
            dist.destroy_process_group()
        del servicer
        torch.cuda.empty_cache()
    explore_s = time.perf_counter() - t_phase
    explored = summary.get("explored", {})
    S = summary.get("num_stages")
    tp = summary.get("intra_tp", 1)
    R = (stage_replicas(EXPLORE_DEVICES, S, tp, summary.get("placement",
                                                             "blocked"),
                        summary.get("interleave_groups"))
         if summary.get("kind") == "pipeline" else None)
    texts = {}
    tools = {"plan_explain": _run_tool(
        "plan_explain", ["--trace", trace_path, "--check"], texts)}
    tools["trace_summary"] = _run_tool("trace_summary", [FLEET_TRACE], texts)
    tools["ledger_report"] = _run_tool(
        "ledger_report", ["--trace", FLEET_TRACE, "--single-ms",
                          str(fleet_single_ms)], texts)
    tools["request_trace"] = _run_tool(
        "request_trace", ["--trace", SERVE_RPC_TRACE], texts)
    texts["verify_plan"] = verify_text
    with open(TOOLS_TEXT, "w") as f:
        for name, text in texts.items():
            f.write(f"==== tools/torch_{name}.py\n{text}\n")
    # Every in-process server reads the one flight recorder, so the
    # merged trace holds each request's events once a process: no copy
    # may deliver a request twice (a cancelled one may deliver none).
    rows = {}
    for ev in tools["request_trace"]["events"]:
        rows.setdefault((ev.get("rid"), ev.get("proc")), []).append(
            ev.get("ev"))
    led = tools["ledger_report"]["report"]["gap_table"].get("aggregate")
    ts = tools["trace_summary"]["summary"]
    emit({"phase": "explore_tools", "model": "GPT-2 1.5B",
          "nvidia_smi": smi, "budget_seconds": 120,
          "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
          "batch": EXPLORE_BATCH, "seq": SEQ,
          "micro_batches": EXPLORE_MICRO,
          "devices": f"[cuda:0] * {EXPLORE_DEVICES} (one-rank servicer, "
                     "inproc:)",
          "winner": {"kind": summary.get("kind", "spmd"),
                     "config": next((c["config"] for c in explored.get(
                         "candidates", []) if c["winner"]), None), "S": S,
                     "M": summary.get("num_micro_batches"), "tp": tp,
                     "R": R, "placement": summary.get("placement"),
                     "axes": summary.get("axes")},
          "candidates": explored.get("candidates", [])[:12],
          "n_candidates": len(explored.get("candidates", [])),
          "planner_seconds": summary.get("planner_seconds"),
          "compile_training_seconds": compile_s,
          "losses": losses, "step_seconds": seconds,
          "max_memory_allocated_bytes": peak,
          "flash_launches": launches, "explore_seconds": explore_s,
          "tools": {
              "plan_explain": texts["plan_explain"].splitlines()[-2:],
              "trace_summary": {"n_events": ts["n_events"],
                                "category_ms": ts["category_ms"],
                                "workers": ts["workers"]},
              "ledger_report_aggregate": led,
              "request_trace": {
                  "requests": len({rid for rid, _ in rows if rid != "*"}),
                  "processes": len({proc for _, proc in rows}),
                  "deliver_each": sorted({
                      names.count("deliver")
                      for (rid, _), names in rows.items() if rid != "*"})},
              "verify_plan": texts["verify_plan"].splitlines()[:1],
              "text": TOOLS_TEXT},
          "seconds": time.perf_counter() - t_phase})
    if summary.get("kind") != "pipeline":
        raise SystemExit(f"chip_smoke: the explore picked "
                         f"{summary.get('axes')} at 1.5B width, not a "
                         "pipeline")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: explore_tools non-finite loss "
                         f"{losses}")
    if not losses[2] < losses[0]:
        raise SystemExit(f"chip_smoke: explore_tools loss did not fall "
                         f"{losses}")
    if not all(launches.get(n) for n in KERNELS):
        raise SystemExit(f"chip_smoke: explore_tools launches {launches}")
    twice = sorted(str(key) for key, names in rows.items()
                   if names.count("deliver") > 1)
    if not rows or twice:
        raise SystemExit(f"chip_smoke: serve_rpc's flight trace delivers "
                         f"twice in {twice} ({len(rows)} copies)")
    return launches, EXPLORE_BATCH // EXPLORE_MICRO // R


def _time_chunk(eng) -> dict:
    """Device ms of one 256-token prefill chunk of the bf16 engine (chunk
    executable plus page insert), with no history and with 256 tokens of
    history, on pages attached and released here."""
    import numpy as np

    C = SERVE_ENGINE["prefill_chunk"]
    prompt = np.arange(2 * C, dtype=np.int32) % eng.model.cfg.vocab_size
    table, _ = eng.model.attach(prompt, 1)
    eng.model.extend_table(table, 2 * C)
    out = {}
    for start in (0, C):
        def run(start=start):
            eng.model.prefill_chunk(table.pages, prompt, start, start + C)
        ms, spread = cuda_ms(run, iters=5, warmup=2, windows=3)
        out[f"history_{start}"] = {"ms": ms, "spread": spread}
    eng.model.release_table(table)
    return out


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
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    open(LOG_PATH, "w").close()

    # Seconds between phase boundaries (a timing line before the kernels
    # line), so a run's time can be laid out by phase.
    seconds, clock = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    phase_device()
    phase_build()
    mark("build")
    phase_telemetry()
    gpt2_case, llama_case, remat_case = phase_kernels()
    mark("kernels")
    phase_parity()
    mark("parity")
    gpt2_launches, slice_losses, slice_seconds = phase_slice()
    mark("slice")
    plan_launches, plan_mb, plan_losses = phase_plan()
    torch.cuda.empty_cache()
    # The plan path's kernels at the micro batch it chose.
    plan_case = _checked_case("plan_path", dict(
        B=plan_mb, H=25, T=SEQ, D=64, dtype=torch.bfloat16, causal=True),
        seed=200, time_it=True)
    mark("plan")
    phase_spmd_plan()
    mark("spmd_plan")
    spmd_launches, spmd_seconds = phase_spmd_step(PLAN_BATCH // plan_mb,
                                                  plan_losses)
    mark("spmd_step")
    rpc_launches = phase_rpc(PLAN_BATCH // plan_mb, plan_losses,
                             spmd_seconds)
    mark("rpc")
    pipe_launches, pipe_losses, verify_text = phase_pipeline(
        plan_losses, PLAN_BATCH // plan_mb)
    # The pipeline path's kernels at its micro batch.
    pipe_mb = PLAN_BATCH // PIPE_MICRO
    pipe_case = _checked_case("pipeline_path", dict(
        B=pipe_mb, H=25, T=SEQ, D=64, dtype=torch.bfloat16, causal=True),
        seed=300, time_it=True)
    mark("pipeline")
    # The fleet pipeline: the same program over in-process workers.
    fleet_launches, fleet_single_ms = phase_fleet()
    mark("fleet")
    # Stages over several devices (one card): intra-stage replicas, ZeRO,
    # the collective pipeline; the kernels at a replica's micro batch.
    pipe_dp_launches = phase_pipeline_dp(pipe_losses)
    mark("pipeline_dp")
    coll_launches = phase_collective()
    dp_mb = PLAN_BATCH // PIPE_MICRO // PIPE_DP_REPLICAS
    pipe_dp_case = _checked_case("pipeline_dp_path", dict(
        B=dp_mb, H=25, T=SEQ, D=64, dtype=torch.bfloat16, causal=True),
        seed=600, time_it=True)
    mark("collective")
    # Sequence parallelism: the ring and Ulysses at long context, the
    # kernels at both hop shapes, GPT-2 1.5B through the ring, the seq
    # axis planned at Llama 1B width.
    seq_kernel_launches = phase_seq_kernels()
    H, D = SEQ_KERNELS_SHAPE["H"], SEQ_KERNELS_SHAPE["D"]
    hop_T = SEQ_KERNELS_SHAPE["T"] // SEQ_RING
    seq_hop_cases = {causal: _checked_case(
        f"seq_kernels_hop_{'causal' if causal else 'full'}", dict(
            B=SEQ_KERNELS_SHAPE["B"], H=H, T=hop_T, D=D,
            dtype=torch.bfloat16, causal=causal), seed=500 + causal,
        time_it=True) for causal in (True, False)}
    seq_step_launches = phase_seq_step(slice_losses, slice_seconds)
    step_hop_cases = {causal: _checked_case(
        f"seq_step_hop_{'causal' if causal else 'full'}", dict(
            B=BATCH // MICRO, H=25, T=SEQ // SEQ_RING, D=64,
            dtype=torch.bfloat16, causal=causal), seed=502 + causal,
        time_it=True) for causal in (True, False)}
    phase_seq_plan()
    mark("seq")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        llama_launches, save = phase_llama(workdir)
        phase_checkpoint(save)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del save
    mark("llama_checkpoint")
    remat_launches = phase_remat()
    mark("remat")
    phase_sampling()
    mark("sampling")
    phase_models()
    mark("models")
    fp32_serving = phase_serving()
    mark("serving")
    phase_serve_rpc(fp32_serving)
    mark("serve_rpc")
    fleet_gate_values = phase_serve_fleet(fp32_serving, FLEET_TRACE)
    mark("serve_fleet")
    # The user's entry points: the examples and the fleet tools.
    example_launches = phase_examples()
    mark("examples")
    phase_tools(fleet_gate_values)
    mark("tools")
    explore_launches, explore_rows = phase_explore_tools(verify_text,
                                                         fleet_single_ms)
    explore_case = _checked_case("explore_path", dict(
        B=explore_rows, H=25, T=SEQ, D=64, dtype=torch.bfloat16,
        causal=True), seed=700, time_it=True)
    mark("explore_tools")
    emit({"phase": "timing", "phase_seconds": seconds,
          "total_seconds": sum(seconds.values())})
    rows = []
    for shape, case, launches in (
            ("[4*25, 1024, 64] bf16 causal (GPT-2 1.5B)", gpt2_case,
             gpt2_launches),
            ("[4*16, 512, 128] bf16 causal (Llama 1B)", llama_case,
             llama_launches),
            ("[8*25, 1024, 64] bf16 causal (GPT-2 remat phase, 5 runs)",
             remat_case, remat_launches),
            (f"[{plan_mb}*25, 1024, 64] bf16 causal (GPT-2 1.5B plan "
             f"phase, batch {PLAN_BATCH})", plan_case, plan_launches),
            (f"[{plan_mb}*25, 1024, 64] bf16 causal (GPT-2 1.5B "
             f"spmd_step phase: the lowered step on DTensors)", plan_case,
             spmd_launches),
            (f"[{plan_mb}*25, 1024, 64] bf16 causal (GPT-2 1.5B rpc "
             f"phase: TepdistSession -> ExecutePlan on a servicer)",
             plan_case, rpc_launches),
            (f"[{pipe_mb}*25, 1024, 64] bf16 causal (GPT-2 1.5B pipeline "
             f"phase: 4 stages, M = {PIPE_MICRO})", pipe_case,
             pipe_launches),
            (f"[{pipe_mb}*25, 1024, 64] bf16 causal (GPT-2 1.5B fleet "
             f"phase, {FLEET_LAYERS} layers: 4 stages on {FLEET_WORKERS} "
             f"in-process workers, M = {PIPE_MICRO})", pipe_case,
             fleet_launches),
            (f"[{dp_mb}*25, 1024, 64] bf16 causal (GPT-2 1.5B pipeline_dp "
             f"phase: 2 stages x 2 replicas, M = {PIPE_MICRO})",
             pipe_dp_case, pipe_dp_launches),
            (f"[{COLL_BATCH // COLL_MICRO}*25, 1024, 64] bf16 causal (GPT-2 "
             f"1.5B collective phase: 4 stages, M = {COLL_MICRO})",
             pipe_dp_case, coll_launches),
            ("[4*16, 512, 128] bf16 causal (Llama 1B, examples phase: "
             "examples_torch/llama/train.py --attn flash, auto_parallel "
             "on data = 1, 7 steps)", llama_case, example_launches),
            (f"[{explore_rows}*25, 1024, 64] bf16 causal (GPT-2 1.5B "
             f"explore_tools phase: the explored pipeline over [cuda:0] * "
             f"{EXPLORE_DEVICES}, {EXPLORE_LAYERS} layers, "
             f"{EXPLORE_STEPS} steps)", explore_case, explore_launches)):
        for name, (source, replaces) in KERNELS.items():
            r = case[name]
            rows.append({"name": name, "shape": shape, "route": "cuda",
                         "source": source, "replaces": replaces,
                         "launches": launches[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"]})
            if not launches[name]:
                raise SystemExit(f"chip_smoke: {name} was not launched on "
                                 f"the {shape} path")
    for shape, cases, launches in (
            (f"[1*{H}, {hop_T}, {D}] bf16 (Llama 1B heads at 16384 tokens, "
             f"a ring hop of seq_kernels: one ring call)", seq_hop_cases,
             seq_kernel_launches),
            (f"[{BATCH // MICRO}*25, {SEQ // SEQ_RING}, 64] bf16 (GPT-2 "
             f"1.5B seq_step: a ring hop)", step_hop_cases,
             seq_step_launches)):
        for causal, case in cases.items():
            mask = "causal" if causal else "full"
            for name, (source, replaces) in KERNELS.items():
                r = case[name]
                n = launches.get(f"{name}/{mask}", 0)
                rows.append({"name": name, "shape": f"{shape} {mask}",
                             "route": "cuda", "source": source,
                             "replaces": replaces, "launches": n,
                             "max_abs_err": r["max_abs_err"],
                             "ms": r["ms"], "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound_ms"],
                             "bound_by": r["bound_by"],
                             "library_ms": r["library_ms"]})
                if not n:
                    raise SystemExit(f"chip_smoke: {name} was not launched "
                                     f"on the {shape} {mask} path")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
