"""Client session: the PyTorch frontend over the RPC service (the port of
the JAX package's ``client/session.py``).

Reference parity: the modified TF client's compile/run flow (reference:
jit/kernels/xla_ops.{h,cc}): XlaCompileOp sends the whole-graph module via
BuildExecutionPlan; XlaRunOp separates data args from variable args,
transfers variables ONCE (cached server-side handles,
``VarsCacheInRemote``), per-step inputs each step, calls ExecutePlan, and
fetches resource variables every ``FETCH_RESOURCE_VAR_STEPS`` steps.

The session captures ``step_fn(params, opt_state, *batch)`` on fake
tensors (``graph/fx_graph.trace_graph(functional=True)``), ships its aten
graph (``rpc/fx_serde.py``), and lets the SERVER plan and execute it on its
devices: the client needs no card. Tensors that live on the ``meta``
device are abstract state: with ``init_specs`` the server creates them.

Robustness: every RPC issued here rides ``TepdistClient.call`` and thus
inherits rpc/retry.py's policy (per-verb deadlines, exponential backoff,
transport-vs-fatal classification). ``run``/``run_async``'s ExecutePlan
carries an idempotency token, so a retried step whose original response
was lost is answered from the server's dedup cache instead of advancing
``global_step`` twice.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import (tree_leaves, tree_map,
                                         tree_structure, tree_unflatten)
from tepdist_tpu_torch.rpc import fx_serde
from tepdist_tpu_torch.rpc.client import TepdistClient


def _abstract(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.device.type == "meta"


class TepdistSession:
    def __init__(self, address: Optional[str] = None,
                 mesh_axes: Sequence = (), mode: str = "cost"):
        self.client = TepdistClient(address)
        self.mesh_axes = list(mesh_axes)
        self.mode = mode
        self.handle: Optional[int] = None
        self._out_tree = None
        self._state_tree = None
        self._n_state = 0
        self._batch_leaf_idx: Sequence[int] = ()
        self._step_count = 0
        self.fetch_every = ServiceEnv.get().fetch_resource_var_steps
        # What the last compile cost on the client: capture and encode
        # seconds, the wire graph's nodes and bytes, the state literals'
        # bytes and transfer seconds.
        self.compile_stats: Dict[str, float] = {}
        # Training-health sentinel (telemetry/watchtower.py): the loss is
        # already on host each run(), so the NaN watchdog + loss-spike
        # detector cost a few float compares. Advisory unless
        # TEPDIST_WATCH_HALT promotes them.
        from tepdist_tpu_torch.telemetry.watchtower import TrainingSentinel
        self.sentinel = TrainingSentinel(
            halt=ServiceEnv.get().tepdist_watch_halt)

    def _capture(self, fn, *args) -> bytes:
        """``fn(*args)`` captured on fake tensors and serialized; fills
        ``compile_stats`` and ``_out_tree``."""
        from tepdist_tpu_torch.graph.fx_graph import trace_graph

        t0 = time.perf_counter()
        graph, _, out_tree = trace_graph(fn, *args, functional=True)
        t1 = time.perf_counter()
        module = fx_serde.serialize_graph(graph.gm)
        self.compile_stats.update(
            capture_seconds=t1 - t0,
            encode_seconds=time.perf_counter() - t1,
            graph_nodes=len(graph.gm.graph.nodes),
            module_bytes=len(module))
        self._out_tree = out_tree
        return module

    # ------------------------------------------------------------------
    def compile_train_step(self, step_fn: Callable, params, opt_state,
                           *example_batch,
                           annotations: Optional[dict] = None,
                           init_specs: Optional[dict] = None,
                           init_seed: int = 0,
                           _explore_extras: Optional[dict] = None) -> Dict:
        """Capture + ship the whole training step; transfer initial state.

        ``step_fn(params, opt_state, *batch) -> (loss, params, opt_state)``.

        ``init_specs``: {flat state index: {shape, dtype, distribution,
        scale, mean, fan_in_scaling}}: variables are created SERVER-side
        and never transferred (reference: init_from_remote).
        ``params``/``opt_state`` may then hold ``meta`` tensors; abstract
        leaves absent from init_specs are zero-initialized. Other leaves
        are transferred once."""
        self.compile_stats = {}
        state_leaves = tree_leaves((params, opt_state))
        # Abstract state is captured from uninitialized host tensors of
        # its shapes (the capture reads shapes, dtypes and devices only).
        args = tree_map(
            lambda t: (torch.empty(t.shape, dtype=t.dtype) if _abstract(t)
                       else t), (params, opt_state) + tuple(example_batch))
        module = self._capture(step_fn, *args)
        self._state_tree = tree_structure((params, opt_state))
        self._n_params = len(tree_leaves(params))
        self._n_state = len(state_leaves)
        n_batch = len(tree_leaves(example_batch))
        self._batch_leaf_idx = list(range(self._n_state,
                                          self._n_state + n_batch))

        # outs = (loss, new_params..., new_opt...) -> alias onto state invars
        state_alias = {1 + k: k for k in range(self._n_state)}

        ann_wire = None
        if annotations:
            ann_wire = {
                str(i): {ax: {"partition_dim": s.partition_dim,
                              "num_splits": s.num_splits,
                              "partial": s.partial,
                              "replicated": s.replicated}
                         for ax, s in spec.items()}
                for i, spec in annotations.items()
            }
        init_specs = dict(init_specs or {})
        if init_specs:
            # Abstract state leaves default to zero init server-side.
            for i, leaf in enumerate(state_leaves):
                if i not in init_specs and _abstract(leaf):
                    init_specs[i] = {
                        "shape": list(leaf.shape),
                        "dtype": str(leaf.dtype).replace("torch.", ""),
                        "distribution": "zeros"}
        resp = self.client.build_execution_plan(
            module,
            mesh_axes=self.mesh_axes,
            variable_indices=list(range(self._n_state)),
            state_alias=state_alias,
            mode=self.mode,
            annotations=ann_wire,
            init_specs=init_specs or None,
            init_seed=init_seed,
            **(_explore_extras or {}),
        )
        self.handle = resp["handle"]

        # Variables not initialized remotely are transferred once; the
        # server holds them across steps either way.
        t0, nbytes = time.perf_counter(), 0
        for i, leaf in enumerate(state_leaves):
            if i in init_specs:
                continue
            self.client.transfer_to_server_host(leaf, i, variable=True)
            nbytes += leaf.numel() * leaf.element_size()
        self.compile_stats.update(
            transfer_bytes=nbytes,
            transfer_seconds=time.perf_counter() - t0)
        self.client.transfer_var_arg_map(
            {i: i for i in range(self._n_state)})
        # Server-side exploration's decision record (telemetry/
        # observatory.py), kept for dump_trace() metadata embedding.
        self.exploration_report = (
            (resp["summary"].get("explored") or {}).get("report"))
        return resp["summary"]

    # ------------------------------------------------------------------
    def compile_training(self, loss_fn, optimizer, params, *example_batch,
                         num_micro_batches: int = 1,
                         annotations=None, init_specs=None,
                         init_seed: int = 0,
                         optimizer_spec: Optional[dict] = None,
                         explore: Optional[bool] = None):
        """Remote counterpart of ``plan_training``: give a loss function
        and an optimizer (``optim``'s ``init``/``apply``); the full
        training step (gradients + GA + optimizer apply) is composed
        client-side, captured, and shipped: the server plans and executes
        it and holds all state.

        FULLY AUTOMATIC planning (reference: the service's exploration
        mode, auto_parallel.cc:236): when the session has NO mesh_axes
        (and mode is not "rule"), the loss graph rides along and the
        SERVER explores SPMD meshes, seq meshes, and pipeline stage cuts,
        building the Evaluator-minimal winner. Pass ``optimizer_spec``
        (``optim.optimizer_spec``) so the server can materialize pipeline
        winners (those compose the step server-side; an optimizer object
        cannot travel). ``explore=False`` opts out."""
        from tepdist_tpu_torch.parallel.sync_free import build_ga_step
        from tepdist_tpu_torch.train import value_and_grad

        def apply_fn(p, s, g):
            return p, optimizer.apply(p, g, s)

        n_batch = len(example_batch)
        step_fn = build_ga_step(
            value_and_grad(loss_fn), apply_fn, num_micro_batches,
            batch_argnums=tuple(range(1, 1 + n_batch)))
        opt_state = optimizer.init(params)
        if explore is None:
            explore = not self.mesh_axes and self.mode != "rule"
        extras = None
        if explore:
            from tepdist_tpu_torch.graph.fx_graph import trace_graph

            graph, _, _ = trace_graph(loss_fn, params, *example_batch)
            extras = {
                "explore": True,
                "loss_module": fx_serde.serialize_graph(graph.gm),
                "n_param_leaves": len(tree_leaves(params)),
                "optimizer_spec": optimizer_spec,
                "num_micro_batches": num_micro_batches,
            }
            b0 = tree_leaves(example_batch)[0]
            if num_micro_batches > 1 and b0.shape[0] % num_micro_batches == 0:
                # Micro-shape loss trace for the server's pipeline
                # proposals (a capture bakes its trace shape:
                # plan_pipeline's micro-trace contract, same helper).
                from tepdist_tpu_torch.parallel.pipeline import (
                    micro_abstract_batch)

                micro = micro_abstract_batch(example_batch,
                                             num_micro_batches)
                graph, _, _ = trace_graph(loss_fn, params, *micro)
                extras["micro_loss_module"] = fx_serde.serialize_graph(
                    graph.gm)
        return self.compile_train_step(
            step_fn, params, opt_state, *example_batch,
            annotations=annotations, init_specs=init_specs,
            init_seed=init_seed, _explore_extras=extras)

    # ------------------------------------------------------------------
    def _inline(self, batch) -> Dict[int, Any]:
        return dict(zip(self._batch_leaf_idx, tree_leaves(batch)))

    def _fetch_now(self) -> bool:
        return (self.fetch_every > 0
                and (self._step_count + 1) % self.fetch_every == 0)

    def run(self, *batch) -> float:
        """One training step: per-step inputs ride inline with ExecutePlan
        (reference: per-step TransferToServerHost + ExecutePlan)."""
        assert self.handle is not None, "compile_train_step first"
        result = self.client.execute_plan(
            self.handle, inline_args=self._inline(batch),
            fetch_resource_variables=self._fetch_now())
        self._step_count += 1
        loss = float(result["outputs"][0])
        self.sentinel.observe(self._step_count - 1, loss)
        return loss

    # ------------------------------------------------------------------
    def compile_generate(self, gen_fn: Callable, params,
                         *example_args) -> Dict:
        """Capture + ship an inference/sampling function that reads the
        SERVER-HELD weights (reference: predict_fns.py: predictions run on
        the estimator's trained weights, nothing is fetched).

        ``gen_fn(params, *args) -> tokens``; ``params`` must have the SAME
        leaf order as the training step's (store indices 0..n_params-1).
        ``example_args`` ride inline per ``generate`` call. Rule-mode
        planning: a decode loop is bandwidth-bound; the cost ILP buys
        nothing over the training plan's sharding."""
        assert self.handle is not None, "compile_train_step first"
        train_out_tree = self._out_tree
        module = self._capture(gen_fn, params, *example_args)
        self._gen_out_tree, self._out_tree = self._out_tree, train_out_tree
        n_params = len(tree_leaves(params))
        assert n_params == self._n_params, (
            f"gen_fn params have {n_params} leaves; the training step "
            f"registered {self._n_params}")
        n_args = len(tree_leaves(example_args))
        resp = self.client.build_execution_plan(
            module,
            mesh_axes=self.mesh_axes,
            variable_indices=list(range(n_params)),
            state_alias={},
            mode="rule",
        )
        self._gen_handle = resp["handle"]
        self._gen_arg_idx = list(range(n_params, n_params + n_args))
        return resp["summary"]

    def generate(self, *args):
        """Run the compiled sampler on the server's current weights and
        return its outputs."""
        assert getattr(self, "_gen_handle", None) is not None, \
            "compile_generate first"
        inline = dict(zip(self._gen_arg_idx, tree_leaves(args)))
        result = self.client.execute_plan(self._gen_handle,
                                          inline_args=inline,
                                          inference=True)
        return tree_unflatten(self._gen_out_tree, result["outputs"])

    # ------------------------------------------------------------------
    def run_async(self, *batch):
        """Pipelined step submission (reference: the optional async RPC path
        bounded by a semaphore, num_parallel_rpc_steps, xla_ops.h:229-232).

        The RPC is dispatched from a single-worker queue, so step order is
        preserved while the caller prepares step N+1 during step N's
        server execution. At most 2 steps are in flight; the permit is
        released by the future's done callback (which also fires on
        cancellation, so cancelled futures cannot leak permits)."""
        import concurrent.futures
        import threading

        assert self.handle is not None, "compile_train_step first"
        if not hasattr(self, "_pool"):
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            self._inflight = threading.Semaphore(2)
        inline = self._inline(batch)
        fetch = self._fetch_now()
        self._step_count += 1
        self._inflight.acquire()

        def go():
            result = self.client.execute_plan(
                self.handle, inline_args=inline,
                fetch_resource_variables=fetch)
            return float(result["outputs"][0])

        try:
            future = self._pool.submit(go)
        except Exception:
            self._inflight.release()
            raise
        future.add_done_callback(lambda _f: self._inflight.release())
        return future

    # ------------------------------------------------------------------
    def variables(self):
        """Fetch (params, opt_state) back from the server
        (reference FetchResourceVars), as host tensors."""
        fetched = self.client.fetch_resource_vars(
            list(range(self._n_state)))
        leaves = [fetched[i] for i in range(self._n_state)]
        return tree_unflatten(self._state_tree, leaves)

    def params(self):
        return self.variables()[0]

    def save(self, max_to_keep: int = 5) -> None:
        self.client.do_remote_save(max_to_keep=max_to_keep)

    def restore(self, global_step: int = -1) -> None:
        self.client.do_remote_restore(global_step=global_step)

    def dump_trace(self, path: Optional[str] = None,
                   clear: bool = False) -> Optional[str]:
        """Pull the server's span buffer + metrics (GetTelemetry),
        clock-align them against this client's own spans, and write ONE
        merged Perfetto-loadable trace (``TEPDIST_TRACE=1`` or DEBUG on
        both processes for a non-empty timeline). When the plan came from
        server-side exploration, the decision record rides in
        ``metadata.exploration``. Returns the written path, or None."""
        from tepdist_tpu_torch.telemetry import dump_merged_trace

        extra = None
        report = getattr(self, "exploration_report", None)
        if report:
            extra = {"exploration": report}
        return dump_merged_trace([self.client], path=path, name="trace",
                                 extra_metadata=extra)

    def close(self) -> None:
        # Drain queued async steps before the channel goes away.
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
        self.client.close()
