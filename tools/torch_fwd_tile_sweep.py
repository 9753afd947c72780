#!/usr/bin/env python3
"""Tile sweep of the port's bf16 tensor-core flash-attention forward
(``tepdist_tpu_torch/csrc/flash_fwd.cu``, struct ``FwdTile``) on one
NVIDIA GPU.

Run from the repository root on a machine with a card and nvcc:

    python3 tools/torch_fwd_tile_sweep.py

Each variant is a copy of the kernel sources with ``FwdTile``'s constants
rewritten for D <= 64 (D = 128 keeps its tile), built by nvcc, all variants
at once, into ``tepdist_tpu_torch/_build/sweep/``. Every variant is held
against the plain PyTorch version, under ``chip_smoke.py``'s tolerance, at
the main path's shape and at three small bf16 cases (ragged, full, and
large scores), then timed at the main path's shape ([4*25, 1024, 64] bf16
causal) in two passes, the second in reverse order, beside PyTorch's own
flash-attention forward. A diagnostic variant with P rounded to one bf16
is timed too, to size the cost of the hi/lo pair; it is expected to fail
the check. One JSON line per variant; exits non-zero if a variant fails
to build, or a tile fails to agree. The sweep picks the tile that
``FwdTile`` keeps; it is not a run-time option of the kernel.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# FwdTile members rewritten per variant (C++ expressions in D).
VARIANTS = {
    "q64: 4 warps x 16 rows, 64-key rounds": {},
    "q128: 4 warps x 32 rows, 64-key rounds": {
        "blocks": "D <= 64 ? 2 : 1"},
    "q128: 8 warps x 16 rows, 64-key rounds": {
        "warps": "D <= 64 ? 8 : kTcWarps"},
    "q128: 4 warps x 32 rows, 32-key rounds": {
        "blocks": "D <= 64 ? 2 : 1", "cols": "D <= 64 ? 32 : Tc<D>::cols"},
}
# Timed beside the tiles, never kept: the 64-row tile with P rounded to one
# bf16 (the lo products of accumulate() dropped). It fails the tolerance
# (the emulation test's mutation run) and sizes what the hi/lo pair costs.
SINGLE_P = "q64, single bf16 P (diagnostic)"
SINGLE_P_EDIT = (r"\n *mma_bf16_16816\(acc\[2 \* dd( \+ 1)?\], lo, "
                 r"fx( \+ 2)?\);")
CASES = {  # label: (B, H, T, causal, q_mul), D = 64 bf16
    "main_path": (4, 25, 1024, True, 1),
    "ragged_causal": (2, 4, 100, True, 1),
    "ragged_full": (2, 4, 257, False, 1),
    "large_causal": (2, 4, 300, True, 8),
}


def build_variants():
    from tepdist_tpu_torch.ops import _build
    from tepdist_tpu_torch.ops import flash_attention as fa

    out_dir = _build.BUILD_DIR / "sweep"
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for i, (label, members) in enumerate([*VARIANTS.items(),
                                          (SINGLE_P, {})]):
        src_dir = out_dir / f"v{i}"
        src_dir.mkdir(parents=True)
        for f in [*_build.CSRC.glob("*.cuh"), _build.CSRC / "flash_fwd.cu"]:
            shutil.copy(f, src_dir / f.name)
        if label == SINGLE_P:
            common = src_dir / "flash_common.cuh"
            text, n = re.subn(SINGLE_P_EDIT, "", common.read_text())
            if n != 2:
                raise SystemExit("sweep: accumulate()'s lo products not "
                                 "found")
            common.write_text(text)
        fwd = src_dir / "flash_fwd.cu"
        text = fwd.read_text()
        for member, expr in members.items():
            text, n = re.subn(
                rf"(static constexpr int {member} = )[^;]+;",
                rf"\g<1>{expr};", text, count=1)
            if n != 1:
                raise SystemExit(f"sweep: FwdTile::{member} not found")
        fwd.write_text(text)
        lib = src_dir / "libflash_fwd.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
               str(lib), str(fwd)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), lib)
    entries, ptxas = {}, {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"sweep: nvcc failed for {label}:\n{log}")
        ptxas[label] = chip_smoke._ptxas_report(log).get("bf16/D64")
        fn = ctypes.CDLL(str(lib)).tepdist_flash_fwd
        fn.argtypes = fa._ARGTYPES["flash_fwd"]
        fn.restype = ctypes.c_int
        entries[label] = fn
    return entries, ptxas


def main() -> int:
    import torch

    from tepdist_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device is available")
    print(chip_smoke.nvidia_smi(), flush=True)
    entries, ptxas = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {}
    for i, (label, (B, H, T, causal, q_mul)) in enumerate(CASES.items()):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v = (torch.randn(B * H, T, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        inputs[label] = (q * q_mul, k, v, causal, 1.0 / math.sqrt(64))

    def call(fn, q, k, v, causal, scale):
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device="cuda")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), *fa._meta(q, causal, scale), stream)
        if err != 0:
            raise SystemExit(f"sweep: launch failed with CUDA error {err}")
        return o, lse

    results = {label: {"variant": label, "tile": VARIANTS.get(label, {}),
                       "ptxas_bf16_D64": ptxas[label], "errors": {},
                       "ok": True, "ms": []} for label in entries}
    for label, fn in entries.items():
        for case, (q, k, v, causal, scale) in inputs.items():
            o, lse = call(fn, q, k, v, causal, scale)
            o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
            o_32, lse_32 = fa.flash_fwd_plain(q.float(), k.float(),
                                              v.float(), causal, scale)
            torch.cuda.synchronize()
            checks = [chip_smoke._within(o, o_ref, o_32),
                      chip_smoke._within(lse, lse_ref, lse_32)]
            results[label]["errors"][case] = max(c[0] for c in checks)
            results[label]["ok"] &= all(c[2] for c in checks)
    q, k, v, causal, scale = inputs["main_path"]
    order = list(entries)
    for labels in (order, order[::-1]):
        for label in labels:
            ms, spread = chip_smoke.cuda_ms(
                lambda: call(entries[label], q, k, v, causal, scale))
            results[label]["ms"].append(ms)
            results[label].setdefault("ms_spread", []).append(spread)
    B, H, T, _, _ = CASES["main_path"]
    q4, k4, v4 = (x.view(B, H, T, 64) for x in (q, k, v))
    library_ms, _ = chip_smoke.cuda_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, causal, scale=scale))
    bound_ms, bound_by = chip_smoke.bound("flash_fwd", B * H, T, 64,
                                          "bfloat16", causal)
    for rec in results.values():
        rec.update(library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print(json.dumps(rec), flush=True)
    return 0 if all(r["ok"] for label, r in results.items()
                    if label != SINGLE_P) else 1


if __name__ == "__main__":
    sys.exit(main())
