"""Cluster topology spec: a copy of the JAX package's
``core/cluster_spec.py``.

Reference parity: ``ClusterSpec``/``GlobalDeviceSpec`` (reference:
service/cluster_and_device_spec.{h,cc}) parsed from the ``CLUSTER_SPEC``
json; config file format preserved from
``config_{1,4}worker_template.json``: a master plus workers, each
``{ip, port, device_ids}`` (the reference's ``gpu_ids``, accepted as an
alias).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class WorkerSpec:
    ip: str
    port: int
    device_ids: List[int]
    task_index: int = 0

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"


@dataclasses.dataclass
class ClusterSpec:
    workers: List[WorkerSpec]

    @property
    def master(self) -> WorkerSpec:
        return self.workers[0]

    @property
    def slaves(self) -> List[WorkerSpec]:
        return self.workers[1:]

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def total_devices(self) -> int:
        return sum(len(w.device_ids) for w in self.workers)

    def global_device_id(self, task_index: int, local_id: int) -> int:
        base = 0
        for w in self.workers:
            if w.task_index == task_index:
                return base + w.device_ids.index(local_id)
            base += len(w.device_ids)
        raise KeyError(f"unknown task {task_index}")

    def worker_of_device(self, global_id: int) -> WorkerSpec:
        base = 0
        for w in self.workers:
            if global_id < base + len(w.device_ids):
                return w
            base += len(w.device_ids)
        raise KeyError(f"device {global_id} out of range")

    @classmethod
    def from_json(cls, data) -> "ClusterSpec":
        if isinstance(data, str):
            data = json.loads(data)
        workers = []
        entries = data.get("workers") or data.get("cluster") or []
        if isinstance(entries, dict):
            entries = [entries[k] for k in sorted(entries)]
        for i, w in enumerate(entries):
            devs = w.get("device_ids", w.get("gpu_ids", []))
            if isinstance(devs, str):
                devs = [int(x) for x in devs.split(",") if x != ""]
            workers.append(WorkerSpec(
                ip=w.get("ip", "127.0.0.1"),
                port=int(w["port"]),
                device_ids=list(devs),
                task_index=int(w.get("task_index", i)),
            ))
        if not workers:
            raise ValueError("CLUSTER_SPEC has no workers")
        return cls(workers)

    @classmethod
    def from_env(cls) -> Optional["ClusterSpec"]:
        raw = os.environ.get("CLUSTER_SPEC", "")
        if not raw:
            return None
        if os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        return cls.from_json(raw)

    def to_json(self) -> str:
        return json.dumps({"workers": [
            {"ip": w.ip, "port": w.port, "device_ids": w.device_ids,
             "task_index": w.task_index} for w in self.workers]})
