"""Multi-host SPMD session: one logical step over N multi-rank servers (the
port of the JAX package's ``client/multihost.py``).

Servers started with ``--coordinator_address``/``--num_processes`` form one
``torch.distributed`` world (NCCL, each rank bound to an indexed card, or
gloo on the CPU) whose ranks compose a single global mesh; every rank runs
the SAME DTensor program and its collectives go over that world. The
control plane stays RPC: this session BROADCASTS every plan / execute /
fetch verb to all servers, so each rank enters the same computation in the
same order (the multi-controller contract), and checks that the plan
handles and the replicated losses agree.

The step is captured with ``trace_graph(functional=True)`` and shipped
through ``rpc/fx_serde.py``, as ``TepdistSession`` does.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from tepdist_tpu_torch.core.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)
from tepdist_tpu_torch.rpc import fx_serde
from tepdist_tpu_torch.rpc.client import TepdistClient


class MultiHostSession:
    def __init__(self, addresses: Sequence[str], mesh_axes: Sequence = (),
                 mode: str = "cost"):
        self.clients = [TepdistClient(a) for a in addresses]
        self.mesh_axes = list(mesh_axes)
        self.mode = mode
        self.handle: Optional[int] = None
        self._step_count = 0
        self.summary: Dict[str, Any] = {}

    def _broadcast(self, fn, *args, **kwargs) -> List[Any]:
        """Run a verb on every server concurrently; all must succeed.
        Collectives inside the verb (execution, gathers) synchronize the
        ranks, so a missing participant would hang: surface errors."""
        results: List[Any] = [None] * len(self.clients)
        errors: Dict[int, Exception] = {}

        def run(i, c):
            try:
                results[i] = fn(c, *args, **kwargs)
            except Exception as e:  # noqa: BLE001
                errors[i] = e

        threads = [threading.Thread(target=run, args=(i, c))
                   for i, c in enumerate(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"multi-host broadcast failures: {errors}")
        return results

    # ------------------------------------------------------------------
    def wait_ready(self, timeout: float = 60.0) -> List[Dict]:
        self._broadcast(lambda c: c.wait_ready(timeout))
        return self._broadcast(lambda c: c.ping())

    def compile_train_step(self, step_fn: Callable, params, opt_state,
                           *example_batch,
                           annotations: Optional[dict] = None) -> Dict:
        """``step_fn(params, opt_state, *batch) -> (loss, params,
        opt_state)``, captured once here and planned by every server on
        the session's mesh; the initial state goes to every server whole
        (each rank places its own shards)."""
        from tepdist_tpu_torch.graph.fx_graph import trace_graph

        graph, _, _ = trace_graph(step_fn, params, opt_state,
                                  *example_batch, functional=True)
        module = fx_serde.serialize_graph(graph.gm)
        state_leaves = tree_leaves((params, opt_state))
        self._state_tree = tree_structure((params, opt_state))
        self._n_state = len(state_leaves)
        n_batch = len(tree_leaves(example_batch))
        self._batch_leaf_idx = list(range(self._n_state,
                                          self._n_state + n_batch))
        state_alias = {1 + k: k for k in range(self._n_state)}
        ann_wire = None
        if annotations:
            ann_wire = {
                str(i): {ax: {"partition_dim": s.partition_dim,
                              "num_splits": s.num_splits,
                              "partial": s.partial,
                              "replicated": s.replicated}
                         for ax, s in spec.items()}
                for i, spec in annotations.items()}

        def build(c):
            return c.build_execution_plan(
                module, mesh_axes=self.mesh_axes,
                variable_indices=list(range(self._n_state)),
                state_alias=state_alias, mode=self.mode,
                annotations=ann_wire)

        resps = self._broadcast(build)
        handles = {r["handle"] for r in resps}
        if len(handles) != 1:
            raise RuntimeError(f"divergent plan handles: {handles}")
        self.handle = handles.pop()
        for i, leaf in enumerate(state_leaves):
            self._broadcast(
                lambda c, a=leaf, gi=i: c.transfer_to_server_host(
                    a, gi, variable=True))
        self.summary = resps[0]["summary"]
        return self.summary

    def compile_training(self, loss_fn, optimizer, params, *example_batch,
                         num_micro_batches: int = 1,
                         annotations: Optional[dict] = None) -> Dict:
        """The full step (gradients + GA + the optimizer's apply) composed
        here, as ``TepdistSession.compile_training`` composes it."""
        from tepdist_tpu_torch.parallel.sync_free import build_ga_step
        from tepdist_tpu_torch.train import value_and_grad

        def apply_fn(p, s, g):
            return p, optimizer.apply(p, g, s)

        step_fn = build_ga_step(
            value_and_grad(loss_fn), apply_fn, num_micro_batches,
            batch_argnums=tuple(range(1, 1 + len(example_batch))))
        return self.compile_train_step(
            step_fn, params, optimizer.init(params), *example_batch,
            annotations=annotations)

    def run(self, *batch) -> float:
        assert self.handle is not None, "compile_train_step first"
        leaves = tree_leaves(batch)
        inline = dict(zip(self._batch_leaf_idx, leaves))
        results = self._broadcast(
            lambda c: c.execute_plan(self.handle, inline_args=inline))
        self._step_count += 1
        losses = [float(r["outputs"][0]) for r in results]
        # Replicated loss: every rank must agree.
        if max(losses) - min(losses) > 1e-5 * (abs(losses[0]) + 1e-9):
            raise RuntimeError(f"divergent losses across hosts: {losses}")
        return losses[0]

    def variables(self):
        results = self._broadcast(
            lambda c: c.fetch_resource_vars(list(range(self._n_state))))
        leaves = [results[0][i] for i in range(self._n_state)]
        return tree_unflatten(self._state_tree, leaves)

    def close(self) -> None:
        for c in self.clients:
            c.close()

