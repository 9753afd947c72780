"""Standalone runner of a step shipped over the wire: the port's
counterpart of ``tools/run_jaxpr.py`` (reference: ``run_arbitary_hlo.cc``,
a binary that executes a module outside the service for debugging).

Decodes a graph serialized by ``tepdist_tpu_torch/rpc/fx_serde.py`` (the
wire form of ``BuildExecutionPlan``), runs it on zero inputs (``--random``:
normal draws for floating inputs, from ``--seed``) on ``--device`` (the
card unless ``--device cpu``), and prints one summary line per output.
``--dump`` prints the decoded graph's code first. ``run(blob, inputs)``
runs a decoded graph on given inputs. ``main(argv)`` returns the outputs
beside what it printed (``tools/torch_cli.py``).

    python tools/torch_run_fx.py module.bin [--random] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Sequence

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def run(blob: bytes, inputs: Sequence[Any], device: str = "cuda"
        ) -> List[Any]:
    """The decoded step run on ``inputs`` (flat, graph order), moved to
    ``device``: its flat outputs."""
    import torch

    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.rpc import fx_serde

    dev = resolve_device(device)
    gm = fx_serde.deserialize_graph(blob, device=dev)
    with torch.no_grad():
        outs = gm(*[torch.as_tensor(x).to(dev) for x in inputs])
    return list(outs) if isinstance(outs, (tuple, list)) else [outs]


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "outputs"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    parser = argparse.ArgumentParser("run_fx")
    parser.add_argument("module", help="serialized fx_serde module file")
    parser.add_argument("--random", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="where the step runs (cuda or cpu)")
    parser.add_argument("--dump", action="store_true",
                        help="print the decoded graph")
    args = parser.parse_args(argv)

    import torch

    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.rpc import fx_serde

    dev = resolve_device(args.device)
    with open(args.module, "rb") as f:
        blob = f.read()
    gm = fx_serde.deserialize_graph(blob, device=dev)
    if args.dump:
        print(gm.code)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    inputs = []
    for val in (n.meta["val"] for n in gm.graph.nodes
                if n.op == "placeholder"):
        if args.random and val.dtype.is_floating_point:
            inputs.append(torch.randn(val.shape, generator=gen, device=dev,
                                      dtype=val.dtype))
        else:
            inputs.append(torch.zeros(val.shape, dtype=val.dtype,
                                      device=dev))
    outs = run(blob, inputs, device=args.device)
    for i, o in enumerate(outs):
        o = o.detach().float().cpu() if o.dtype.is_floating_point else o
        mean = o.float().mean().item() if o.numel() else float("nan")
        finite = bool(torch.isfinite(o.float()).all())
        print(f"out[{i}]: shape={tuple(o.shape)} dtype={o.dtype} "
              f"mean={mean:.6g} finite={finite}")
    return 0, {"outputs": outs}


if __name__ == "__main__":
    sys.exit(main()["rc"])
