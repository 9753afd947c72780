"""TaskDAG / TaskNode: the runtime graph. A copy of the JAX package's
``runtime/task_graph.py`` (framework-neutral; the port cannot import it,
since importing anything under ``tepdist_tpu`` imports jax). Keep the two in
step.

Reference parity: ``TaskNode`` / ``TaskDAG`` (reference:
pjrt/task_graph.{h,cc}, node types at task_graph.h:102-139): Split / Input /
Compute / Output / Send / Recv / AR / GAInit / GA / Merge / Macro nodes, each
carrying worker+device placement, ``SplitId``, a port map (out idx -> arg no)
and input specs (arg <- (parent, out_idx)), plus a GC plan (mem_to_release).

In the port a device group is the logical ids of a stage's devices (their
positions in the executor's device list); a SEND/RECV pair is a
``tensor.to(device)`` onto the consumer's device, a no-op where both stages
share one. The payload is a plain Python callable over tensors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tepdist_tpu_torch.core.mesh import SplitId


class TaskGraphError(ValueError):
    """Typed task-graph defect. ``kind`` names the violated invariant and
    ``tasks`` carries the offending task ids, so construction errors and
    the plan verifier's counterexamples (analysis/plan_verify.py) read
    the same way."""

    def __init__(self, kind: str, message: str,
                 tasks: Sequence[int] = ()):
        self.kind = kind
        self.tasks = tuple(tasks)
        suffix = f" tasks={list(self.tasks)}" if self.tasks else ""
        super().__init__(f"[{kind}] {message}{suffix}")


class TaskType(enum.Enum):
    SPLIT = "split"      # source: distributes per-step inputs
    INPUT = "input"      # routes args onto a device group
    COMPUTE = "compute"  # runs a compiled stage program (fwd or bwd)
    GAINIT = "ga_init"   # zero gradient accumulators
    GA = "ga"            # accumulate micro-batch gradients
    AR = "ar"            # cross-group all-reduce (sharded-apply groups)
    APPLY = "apply"      # optimizer apply (the reference's AG remains)
    SEND = "send"        # cross-stage/worker transfer (producer side)
    RECV = "recv"        # consumer side
    OUTPUT = "output"    # collect stage outputs
    MERGE = "merge"      # sink: merges plan outputs
    MACRO = "macro"


@dataclasses.dataclass
class TaskNode:
    """One schedulable unit (reference TaskNode, task_graph.h:102-399)."""

    id: int
    task_type: TaskType
    name: str
    worker_id: int = 0
    device_group: Tuple[int, ...] = ()      # global device ids it occupies
    split_id: Optional[SplitId] = None
    stage: int = -1
    micro: int = -1
    # Dataflow wiring: arg position -> (parent_task_id, out_idx)
    input_specs: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    # out idx -> consumer-visible port (reference port_map)
    port_map: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Execution payload (a callable over tensors) + static metadata.
    payload: Optional[Callable] = None
    flops: float = 0.0
    out_bytes: float = 0.0
    # Comm-dtype modifier for SEND/RECV/AR payloads (""/"float32" =
    # fidelity wire). Tagged by the planner's compressed candidates; the
    # scheduler prices tagged nodes with the compressed collective cost
    # and the distributed runtime encodes their frames at this dtype.
    comm_dtype: str = ""
    # ZeRO modifier on weight-update tasks: the owning stage's optimizer
    # state is sharded over its intra-stage data replicas, so APPLY runs
    # on a local shard bracketed by reduce-scatter/all-gather.
    zero: bool = False
    parents: List[int] = dataclasses.field(default_factory=list)
    children: List[int] = dataclasses.field(default_factory=list)
    # Task ids whose outputs may be freed once this task completes
    # (reference mem_to_release, driven by the dominance analysis).
    mem_to_release: List[int] = dataclasses.field(default_factory=list)

    def key(self) -> str:
        return f"{self.name}#{self.id}"


class TaskDAG:
    """Runtime graph (reference TaskDAG, task_graph.h:403-795)."""

    def __init__(self):
        self.nodes: List[TaskNode] = []
        self.source_id: Optional[int] = None
        self.sink_id: Optional[int] = None

    # -- construction -----------------------------------------------------
    def add(self, task_type: TaskType, name: str, **kw) -> TaskNode:
        node = TaskNode(id=len(self.nodes), task_type=task_type, name=name,
                        **kw)
        self.nodes.append(node)
        if task_type == TaskType.SPLIT:
            self.source_id = node.id
        if task_type == TaskType.MERGE:
            self.sink_id = node.id
        return node

    def add_edge(self, parent: TaskNode, child: TaskNode,
                 out_idx: int = 0, arg_pos: Optional[int] = None) -> None:
        if parent.id == child.id:
            raise TaskGraphError(
                "self_edge", f"{parent.key()} cannot depend on itself",
                tasks=(parent.id,))
        if child.id not in parent.children:
            parent.children.append(child.id)
        if parent.id not in child.parents:
            child.parents.append(parent.id)
        if arg_pos is not None:
            prev = child.input_specs.get(arg_pos)
            # Identical rewires are idempotent (shared params are wired
            # once per consumer micro-batch); a DIFFERENT producer for a
            # wired arg is a double write.
            if prev is not None and prev != (parent.id, out_idx):
                raise TaskGraphError(
                    "double_write",
                    f"{child.key()} arg {arg_pos} already wired from "
                    f"task {prev[0]} out {prev[1]}, rewire from "
                    f"{parent.key()} out {out_idx}",
                    tasks=(prev[0], parent.id, child.id))
            child.input_specs[arg_pos] = (parent.id, out_idx)

    def node(self, task_id: int) -> TaskNode:
        return self.nodes[task_id]

    def topo_order(self) -> List[TaskNode]:
        indeg = {n.id: len(n.parents) for n in self.nodes}
        ready = [n for n in self.nodes if indeg[n.id] == 0]
        out: List[TaskNode] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for c in n.children:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(self.nodes[c])
        if len(out) != len(self.nodes):
            done = {n.id for n in out}
            stuck = sorted(n.id for n in self.nodes if n.id not in done)
            names = ", ".join(self.nodes[t].key() for t in stuck[:8])
            raise TaskGraphError(
                "cycle",
                f"TaskDAG has a cycle among {len(stuck)} tasks: {names}"
                + ("..." if len(stuck) > 8 else ""),
                tasks=stuck)
        return out

    def validate(self) -> None:
        self.topo_order()
        for n in self.nodes:
            for pos, (pid, oi) in n.input_specs.items():
                if pid not in n.parents:
                    raise TaskGraphError(
                        "structure",
                        f"{n.key()} arg {pos} wired from non-parent "
                        f"task {pid}", tasks=(n.id, pid))

    # -- GC plan ----------------------------------------------------------
    def build_gc_plan(self, order: Optional[Sequence[int]] = None) -> None:
        """Fill ``mem_to_release``: a producer's outputs are releasable after
        its LAST consumer *in the scheduled order* completes. The reference
        derives this from a dominance tree post-scheduling
        (MakeTaskGraphGCPlan; task_graph.h:658 Cooper's algorithm);
        schedule-position maxima give the same release points for static
        per-device lists. With no ``order``, node-id (topological) order is
        assumed."""
        for n in self.nodes:
            n.mem_to_release.clear()
        pos = ({tid: i for i, tid in enumerate(order)} if order is not None
               else {n.id: n.id for n in self.nodes})
        last_consumer: Dict[int, int] = {}
        for n in self.nodes:
            for (pid, _oi) in n.input_specs.values():
                cur = last_consumer.get(pid)
                if cur is None or pos[n.id] > pos[cur]:
                    last_consumer[pid] = n.id
        for pid, cid in last_consumer.items():
            self.nodes[cid].mem_to_release.append(pid)

    # -- debug ------------------------------------------------------------
    def dump_dot(self, path: str) -> None:
        """Graphviz export (reference TaskDAG::Dump)."""
        colors = {
            TaskType.COMPUTE: "lightblue", TaskType.GA: "gold",
            TaskType.GAINIT: "khaki", TaskType.SEND: "salmon",
            TaskType.RECV: "lightgreen", TaskType.APPLY: "orchid",
            TaskType.AR: "orange",
        }
        with open(path, "w") as f:
            f.write("digraph task_dag {\n")
            for n in self.nodes:
                c = colors.get(n.task_type, "white")
                f.write(
                    f'  t{n.id} [label="{n.name}\\n{n.task_type.value} '
                    f's{n.stage} m{n.micro}", style=filled, fillcolor={c}];\n')
            for n in self.nodes:
                for ch in n.children:
                    f.write(f"  t{n.id} -> t{ch};\n")
            f.write("}\n")

    def __len__(self):
        return len(self.nodes)
