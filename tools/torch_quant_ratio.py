"""The int8 gradient wire's ratio, the port's ``bench.bench_quantized_ar``:
the f32 against the int8 wire bytes of ``rpc/protocol.encode_literal``
over five gradient-shaped tensors made from ``default_rng(0)``, with the
f32 round trip exact.

    python tools/torch_quant_ratio.py [--device cpu|cuda] [--check]

prints ``quantized_ar_x = R`` and each arm's bytes and round-trip error;
``--check`` exits 1 when the ratio is below 1.5 or the f32 round trip is
not exact. ``scripts/torch_quant_smoke.sh`` and ``chip_smoke.py`` gate
on it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The gradient tensors (default_rng(0), scale 0.02).
SHAPES = [(256, 256), (256,), (1024, 64), (64,), (4, 256, 32)]
GATE_X = 1.5


def measure(device: str = "cuda") -> dict:
    """Each arm's wire bytes and its largest round-trip error, and the
    ratio ``quantized_ar_x``."""
    import numpy as np
    import torch

    from tepdist_tpu_torch.rpc import protocol

    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                              * 0.02).to(device) for s in SHAPES]
    out = {}
    for name, wire in (("f32", None), ("int8", "int8")):
        total, err = 0, 0.0
        for g in grads:
            meta, blob = protocol.encode_literal(g, wire_dtype=wire)
            total += memoryview(blob).nbytes
            back = protocol.decode_literal(meta, blob)
            err = max(err, float((back - g.cpu()).abs().max()))
        out[f"{name}_bytes"] = total
        out[f"{name}_roundtrip_err"] = err
    out["quantized_ar_x"] = out["f32_bytes"] / out["int8_bytes"]
    return out


def main(argv=None) -> dict:
    """``{"rc", "text", **measure()}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser(
        "quant_ratio", description="int8 gradient wire ratio")
    ap.add_argument("--device", default="cuda",
                    help="where the gradient tensors are made")
    ap.add_argument("--check", action="store_true",
                    help=f"exit 1 below {GATE_X}x or on an inexact f32 "
                         f"round trip")
    args = ap.parse_args(argv)
    got = measure(args.device)
    print(f"quantized_ar_x = {got['quantized_ar_x']:.3f} "
          f"(gate: >= {GATE_X})")
    for arm in ("f32", "int8"):
        print(f"  {arm:<5} wire {got[f'{arm}_bytes']} bytes, round-trip "
              f"error {got[f'{arm}_roundtrip_err']!r}")
    ok = got["quantized_ar_x"] >= GATE_X and got["f32_roundtrip_err"] == 0.0
    return (1 if args.check and not ok else 0), got


if __name__ == "__main__":
    sys.exit(main()["rc"])
