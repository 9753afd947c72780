"""ExecutionCoordinator: the master's client side of slave servers.

Reference parity: ``ExecutionCoordinator`` (reference:
pjrt/execution_coordinator.{h,cc}): parses CLUSTER_SPEC, holds a stub+client
per worker, fans out TransferModuleAndDefCtx / DispatchPlan (TaskNodes
serialized as ComputeTasks) / TransferHostRawData / TransferVarArgMap, runs
ExecuteRemotePlan with one thread per worker, forwards DoRemoteSave.

The NCCL unique-id rendezvous (InitRemoteNcclComm) is
``torch.distributed.init_process_group`` on the servers (a multi-rank
server); mesh topology metadata is pushed here (InitMeshTopology). The
port of the JAX package's ``runtime/coordinator.py``."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from tepdist_tpu_torch.core.cluster_spec import ClusterSpec
from tepdist_tpu_torch.rpc import protocol, retry
from tepdist_tpu_torch.rpc.client import TepdistClient


def serialize_task(node) -> dict:
    """TaskNode -> wire dict (reference ComputeTask, xla.proto:358-...)."""
    return {
        "node_id": node.id,
        "type": node.task_type.value,
        "name": node.name,
        "worker_id": node.worker_id,
        "device_group": list(node.device_group),
        "stage": node.stage,
        "micro": node.micro,
        "input_specs": {str(k): list(v) for k, v in node.input_specs.items()},
        "port_map": {str(k): v for k, v in node.port_map.items()},
        "parents": list(node.parents),
        "children": list(node.children),
        "mem_to_release": list(node.mem_to_release),
    }


def deserialize_task_into(dag, d: dict) -> None:
    from tepdist_tpu_torch.runtime.task_graph import TaskType

    node = dag.add(TaskType(d["type"]), d["name"],
                   worker_id=d["worker_id"],
                   device_group=tuple(d["device_group"]),
                   stage=d["stage"], micro=d["micro"])
    node.input_specs = {int(k): tuple(v)
                        for k, v in d["input_specs"].items()}
    node.port_map = {int(k): v for k, v in d["port_map"].items()}
    node.parents = list(d["parents"])
    node.children = list(d["children"])


class ExecutionCoordinator:
    def __init__(self, cluster: Optional[ClusterSpec] = None):
        self.cluster = cluster or ClusterSpec.from_env()
        if self.cluster is None:
            raise ValueError("no CLUSTER_SPEC provided")
        self.clients: Dict[int, TepdistClient] = {}
        for w in self.cluster.slaves:
            self.clients[w.task_index] = TepdistClient(w.address)

    # ------------------------------------------------------------------
    def init_mesh_topology(self) -> None:
        payload = protocol.pack(
            {"cluster_spec": {"workers": [
                {"ip": w.ip, "port": w.port, "device_ids": w.device_ids,
                 "task_index": w.task_index}
                for w in self.cluster.workers]}})
        for c in self.clients.values():
            c.stub.call("InitMeshTopology", payload)

    def transfer_module(self, module_bytes: bytes, module_id: int = 0) -> None:
        payload = protocol.pack({"module_id": module_id}, [module_bytes])
        for c in self.clients.values():
            c.stub.call("TransferModuleAndDefCtx", payload)

    def dispatch_plan(self, dag, topology) -> None:
        """Ship each worker its slice of the task DAG (reference
        DispatchPlanRequest: tasks + split_nums + share_dev_flags +
        placement_layout + stage_split_ordinal)."""
        for task_index, c in self.clients.items():
            tasks = [serialize_task(n) for n in dag.nodes
                     if n.worker_id == task_index]
            try:
                # client.call: per-verb deadline + retry + idem token.
                c.call("DispatchPlan", {
                    "tasks": tasks,
                    "split_nums": topology.split_nums,
                    "share_dev_flags": topology.share_dev_flags,
                    "placement_layout": topology.placement_layout,
                    "stage_split_ordinal": topology.stage_split_ordinal,
                }, timeout=retry.deadline_for("DispatchPlan"))
            except Exception as e:
                raise RuntimeError(
                    f"DispatchPlan failed on worker {task_index}: {e!r}"
                ) from e

    def transfer_var_arg_map(self, var_arg_map: Dict[int, int]) -> None:
        for c in self.clients.values():
            c.transfer_var_arg_map(var_arg_map)

    def execute_remote_plan(self, handle: int = 0) -> List[dict]:
        """One thread per worker (reference: ExecuteRemotePlan threads).
        Each call runs under its verb's own deadline (not the blanket
        default), and a failure names the worker that failed."""
        results: Dict[int, dict] = {}
        errors: Dict[int, Exception] = {}

        def run(ti: int, c: TepdistClient):
            try:
                resp = c.call("ExecuteRemotePlan", {"handle": handle},
                              timeout=retry.deadline_for("ExecuteRemotePlan"))
                results[ti], _ = protocol.unpack(resp)
            except Exception as e:  # noqa: BLE001
                errors[ti] = e

        threads = [threading.Thread(target=run, args=(ti, c))
                   for ti, c in self.clients.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            detail = "; ".join(
                f"worker task_index={ti}: {e!r}"
                for ti, e in sorted(errors.items()))
            raise RuntimeError(f"remote plan failures: {detail}")
        return [results[ti] for ti in sorted(results)]

    def do_remote_save(self, max_to_keep: int, global_step: int) -> None:
        for c in self.clients.values():
            c.do_remote_save(max_to_keep=max_to_keep,
                             global_step=global_step)

    def close(self) -> None:
        for c in self.clients.values():
            c.close()
