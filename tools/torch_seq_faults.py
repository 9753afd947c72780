#!/usr/bin/env python3
"""Planted faults in the flash ring against ``chip_smoke.py``'s seq checks.

    python3 tools/torch_seq_faults.py

Shows that the checks of the ``seq_kernels`` and ``seq_step`` phases can
fail. For the sound ring and for each planted fault, on one card:

* the seq_kernels rule (``SEQ_TOLERANCE``): the ring's o, LSE, dQ, dK and
  dV over ``[cuda:0] * 4`` at [1, 16, 16384, 128] bf16 causal against one
  whole-sequence call of the flash kernels;
* seq_step's gradient check: GPT-2 1.5B's gradients on the first micro
  batch through the ring against those through the whole-sequence
  kernels, the worst leaf against ``SEQ_GRAD_RL2``;
* seq_step's loss check: 6 steps of the slice recipe through the ring,
  the losses against those through the whole-sequence kernels
  (``SEQ_STEP_LOSS_RTOL``).

The faults are planted by patching the ring's module in this process
(the files stay as they are):

* ``no_full_hops``: the hops below the diagonal launch nothing, so each
  block attends to itself alone;
* ``merge_weight``: each full hop's LSE enters the merge one nat low, so
  its block weighs e times too little.

Prints the card's name and power limit and one JSON line, also written
to ``chiprun_out/torch_seq_faults.json``; exits 0 only if the sound ring
passes every check and each fault fails the kernels rule and the
gradient check.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAULTS = ("no_full_hops", "merge_weight")


@contextlib.contextmanager
def planted(fault):
    """The flash ring with ``fault`` planted (None: sound)."""
    ra = importlib.import_module("tepdist_tpu_torch.ops.ring_attention")
    hop_kind, flash_fwd = ra.hop_kind, ra.flash_fwd
    if fault == "no_full_hops":
        def faulty_hop_kind(rank, owner, causal):
            kind = hop_kind(rank, owner, causal)
            return "skip" if kind == "full" else kind
        ra.hop_kind = faulty_hop_kind
    elif fault == "merge_weight":
        def faulty_flash_fwd(q, k, v, causal, scale):
            o, lse = flash_fwd(q, k, v, causal, scale)
            return o, (lse if causal else lse - 1.0)
        ra.flash_fwd = faulty_flash_fwd
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        ra.hop_kind, ra.flash_fwd = hop_kind, flash_fwd


def main() -> int:
    import torch

    import chip_smoke as cs
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.ops import _build
    from tepdist_tpu_torch.ops import ring_attention
    from tepdist_tpu_torch.ops.seq_comm import DeviceTransport
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.train import plan_training

    if not torch.cuda.is_available():
        print("torch_seq_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(cs.KERNELS)
    device = torch.device("cuda", 0)
    ring = DeviceTransport([device] * cs.SEQ_RING)

    # The seq_kernels case.
    B, H, T, D = (cs.SEQ_KERNELS_SHAPE[k] for k in "BHTD")
    inputs = cs.seq_inputs((B, H, T, D), device="cuda")
    scale = 1.0 / math.sqrt(D)
    ref, ref32 = (cs.whole_sequence(*inputs, scale, x)
                  for x in (torch.bfloat16, torch.float32))
    kernels = {}
    for fault in (None,) + FAULTS:
        with planted(fault):
            readings, ok, _, _ = cs.seq_checked("ring", inputs, ring, scale,
                                                ref, ref32)
        kernels[fault or "sound"] = {"ok": ok, "outputs": readings}
    del ref, ref32, inputs
    torch.cuda.empty_cache()

    # The seq_step case: gradients, then losses.
    cfg = cs._config(48)

    def attn(q, k, v):
        return ring_attention(q, k, v, [device] * cs.SEQ_RING,
                              inner="flash")

    params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
    tokens = gpt2.fake_batch(cfg, cs.BATCH, cs.SEQ, seed=0, device="cuda")
    grads = {}
    for fault in (None,) + FAULTS:
        with planted(fault):
            gaps = cs.seq_grad_gaps(cfg, params, tokens[:cs.BATCH // cs.MICRO],
                                    attn)
        worst = max(gaps, key=gaps.get)
        grads[fault or "sound"] = {"worst_leaf": worst,
                                   "rel_l2": gaps[worst],
                                   "ok": gaps[worst] <= cs.SEQ_GRAD_RL2,
                                   "leaves": gaps}
        torch.cuda.empty_cache()
    del params

    def losses(attn_impl):
        params = gpt2.stacked_init_params(cfg, seed=0, device="cuda")
        plan = plan_training(
            lambda p, t: gpt2.loss_fn_stacked(p, t, cfg,
                                              attn_impl=attn_impl),
            adamw_bf16(1e-4), params, tokens, num_micro_batches=cs.MICRO)
        out = [plan.step(tokens) for _ in range(cs.STEPS)]
        del plan, params
        torch.cuda.empty_cache()
        return out

    want = losses(None)
    steps = {}
    for fault in (None,) + FAULTS:
        with planted(fault):
            got = losses(attn)
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        steps[fault or "sound"] = {"losses": got, "max_rel_diff": max(rel),
                                   "ok": max(rel) <= cs.SEQ_STEP_LOSS_RTOL}

    smi = cs.nvidia_smi()
    line = json.dumps({
        "tool": "torch_seq_faults", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "kernels_rule": cs.SEQ_TOLERANCE,
        "grad_rel_l2_tol": cs.SEQ_GRAD_RL2,
        "loss_rtol": cs.SEQ_STEP_LOSS_RTOL, "kernel_losses": want,
        "seq_kernels": kernels, "seq_step_grads": grads,
        "seq_step_losses": steps})
    print(smi)
    print(line)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_seq_faults.json"),
              "w") as f:
        f.write(line + "\n")
    sound = (kernels["sound"]["ok"] and grads["sound"]["ok"]
             and steps["sound"]["ok"])
    caught = all(not kernels[f]["ok"] and not grads[f]["ok"]
                 for f in FAULTS)
    return 0 if sound and caught else 1


if __name__ == "__main__":
    sys.exit(main())
