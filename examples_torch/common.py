"""What the port's examples share: the device rule, the process group the
auto-parallel plans run over, and the lowered step's loop.

Every example runs on the card unless it is given ``--device cpu``. An
example that plans with ``auto_parallel`` plans over the ranks of the
process group it runs in: the world a launcher made (``torchrun`` sets
``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``; rank r then takes card
``LOCAL_RANK``), an existing world in the calling process, or else a world
of one rank on this process's device, made here and torn down at the end.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.tree import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card, the default) or cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_of(name: str) -> torch.device:
    """The example's device: under a launcher, the card of the local rank."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def world(device: torch.device) -> Iterator[int]:
    """The process group the plan runs over; yields its size."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield dist.get_world_size()
        return
    cuda = device.type == "cuda"
    extra = {"device_id": device} if cuda else {}
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method="env://", **extra)
    else:
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, **extra)
    try:
        yield dist.get_world_size()
    finally:
        dist.destroy_process_group()


def rank0_print(*args, **kwargs) -> None:
    """Print on rank 0 only (a launcher's ``RANK`` before the world)."""
    import torch.distributed as dist

    rank = (dist.get_rank() if dist.is_initialized()
            else int(os.environ.get("RANK", "0")))
    if rank == 0:
        print(*args, **kwargs, flush=True)


def run_lowered(plan, state, batch: List[Any], steps: int,
                device: torch.device, line: Callable[[int, float, float],
                                                     str],
                batches: Optional[Iterator[Any]] = None) -> Dict[str, Any]:
    """The reference examples' loop over ``plan.executable()``: the state
    and the batch distributed to the plan's input placements, one warm
    step (not printed), then ``steps`` printed steps whose outputs
    replace the state (``state_alias = {1 + k: k}``). ``batches`` yields
    a new batch for each printed step. Returns the losses and step
    seconds."""
    step = plan.executable(device.type)
    n_state = len(tree_leaves(state))
    flat = [step.distribute_input(i, v)
            for i, v in enumerate(tree_leaves(state) + list(batch))]
    inputs = flat[n_state:]
    outs = step.run(flat)
    float(outs[0].full_tensor())  # the first step: warm
    losses, seconds = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        if batches is not None:
            nxt = next(batches)
            nxt = nxt if isinstance(nxt, (list, tuple)) else [nxt]
            inputs = [step.distribute_input(n_state + j, v)
                      for j, v in enumerate(nxt)]
        outs = step.run(list(outs[1:1 + n_state]) + list(inputs))
        loss = float(outs[0].full_tensor())
        dt = time.perf_counter() - t0
        losses.append(loss)
        seconds.append(dt)
        rank0_print(line(i, loss, dt))
    return {"losses": losses, "step_seconds": seconds}


def stage_devices(device: torch.device, n: int) -> List[torch.device]:
    """``n`` stage devices: the visible cards in turn (one card serves
    several stages when there are fewer cards), or the CPU ``n`` times."""
    if device.type != "cuda":
        return [device] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", (device.index + i) % cards)
            for i in range(n)]
