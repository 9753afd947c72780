"""A pool of 4 ``gloo`` ranks for the port's multi-rank tests.

``GlooPool(module)`` spawns 4 processes (torch.multiprocessing spawn, one
torch thread each, a free localhost port, the planner pricing on the
``cpu`` chip entry) that stay up for a test module. ``pool.run(name,
arg)`` sends every rank the case name: each rank imports ``module`` and
calls its ``case_<name>(rank, arg)``, and rank 0's return value (or any
rank's traceback) comes back. A case that fails on one rank can leave the
others waiting in a collective, so the parent gives up after ``timeout``
seconds (240 by default, as the port's other pools do).
"""

import importlib
import queue
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp

WORLD = 4


def _worker(rank, port, module, inboxes, outbox):
    import torch.distributed as dist

    from tepdist_tpu_torch.core.service_env import ServiceEnv

    # The module first: its own thread cap must not undo the pool's.
    cases = importlib.import_module(module)
    torch.set_num_threads(1)
    # The planner prices on the ``cpu`` chip entry.
    ServiceEnv.reset({"TPU_GENERATION": "cpu"})
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    while True:
        item = inboxes[rank].get()
        if item is None:
            break
        name, arg = item
        try:
            res = ("ok", getattr(cases, f"case_{name}")(rank, arg))
        except Exception:  # noqa: BLE001 — reported to the parent
            res = ("error", traceback.format_exc())
        if rank == 0 or res[0] == "error":
            outbox.put((rank, name, res))
        dist.barrier()
    dist.destroy_process_group()


class GlooPool:
    def __init__(self, module: str):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_worker,
                                  args=(r, port, module, self.inboxes,
                                        self.outbox),
                                  daemon=True) for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, name, arg=None, timeout=240):
        for q in self.inboxes:
            q.put((name, arg))
        try:
            rank, got, (status, value) = self.outbox.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"case {name}: no answer in {timeout} s")
        assert got == name
        assert status == "ok", f"rank {rank}:\n{value}"
        return value

    def close(self):
        for q in self.inboxes:
            q.put(None)
        deadline = time.monotonic() + 30
        for p in self.procs:
            # Drain what the workers still write before joining them.
            while p.is_alive() and time.monotonic() < deadline:
                try:
                    self.outbox.get(timeout=0.1)
                except queue.Empty:
                    pass
            p.join(timeout=1)
            if p.is_alive():
                p.kill()
