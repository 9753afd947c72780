"""ExecutionPlan: build the runtime TaskDAG from a planned pipeline program.

Reference parity: ``ExecutionPlan``/``DistributedPlan``/``LocalPlan``
(reference: pjrt/execution_plan.{h,cc}) + the DAG construction in
``VirtualClient::CompileTaskDAG`` (virtual_client.cc:613-772): DefContext
tree × slice ids → task nodes (kGA/kGAInit/kInput + kCompute + kOutput
groups), edges stitched from input_def_map/input_arg_map, kSplit source and
kMerge sink added, Send/Recv pairs for cross-stage traffic.

Here the DefContext analogue is the StageDecomposition's ``input_def_map``;
micro-batches are the shared (time) ordinal; Send/Recv nodes appear whenever
an activation or cotangent crosses a stage boundary.

A copy of the JAX package's ``runtime/execution_plan.py``: byte counts come
from each stage var's traced value (``graph/fx_graph.var_bytes``) instead of
a jaxpr aval. Keep the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from tepdist_tpu_torch.graph.fx_graph import var_bytes
from tepdist_tpu_torch.parallel.pipeline import PipelineProgram
from tepdist_tpu_torch.runtime.task_graph import TaskDAG, TaskNode, TaskType


@dataclasses.dataclass
class PipelinePlanMaps:
    """Wiring metadata the executor needs beyond the DAG itself."""

    # (stage) -> INPUT task id (params routing)
    input_tasks: Dict[int, int]
    # (stage, micro) -> fwd / bwd compute ids
    fwd_tasks: Dict[Tuple[int, int], int]
    bwd_tasks: Dict[Tuple[int, int], int]
    # (stage) -> GAINIT / APPLY ids
    gainit_tasks: Dict[int, int]
    apply_tasks: Dict[int, int]
    # (stage, micro) -> GA id
    ga_tasks: Dict[Tuple[int, int], int]
    # ((src_stage, out_idx), micro) -> RECV id delivering that activation
    recv_tasks: Dict[Tuple[Tuple[int, int], int], int]
    merge_task: int = -1
    split_task: int = -1
    # RECV id -> expected placement at the consumer, as ("in", stage, pos)
    # for activations (consumer stage input position) or ("out", stage, k)
    # for cotangents (cot of stage's output k). Lets the executor place
    # received values by the consumer's PLANNED sharding under stage x TP
    # nesting instead of a generic replicate rule.
    recv_target: Dict[int, Tuple[str, int, int]] = dataclasses.field(
        default_factory=dict)


def build_pipeline_task_dag(
    prog: PipelineProgram,
    stage_devices: List[Tuple[int, ...]],
) -> Tuple[TaskDAG, PipelinePlanMaps]:
    """Construct the full fwd/bwd/GA/apply task graph for one training step.

    Convention for COMPUTE payload arg layout (executor relies on it):
      fwd(s,m):  [stage s invars...] -> stage s outvars
      bwd(s,m):  [stage s invars..., cotangents of stage s outvars...]
                 -> cotangents of stage s invars
    """
    S = prog.num_stages
    M = prog.num_micro_batches
    # Stage modules captured for intra-stage replicas hold one replica's
    # rows: a COMPUTE task's flops are the whole micro batch's, spread
    # over its device group by the scheduler.
    replicas = getattr(prog, "replicas", 1)
    dag = TaskDAG()
    maps = PipelinePlanMaps({}, {}, {}, {}, {}, {}, {})

    split = dag.add(TaskType.SPLIT, "split", device_group=())
    maps.split_task = split.id

    for s in range(S):
        inp = dag.add(TaskType.INPUT, f"input_s{s}", stage=s,
                      device_group=stage_devices[s])
        maps.input_tasks[s] = inp.id
        gi = dag.add(TaskType.GAINIT, f"gainit_s{s}", stage=s,
                     device_group=stage_devices[s])
        maps.gainit_tasks[s] = gi.id
        dag.add_edge(inp, gi)

    # Forward + Send/Recv per (stage, micro).
    for m in range(M):
        for s in range(S):
            mod = prog.stages[s]
            fwd = dag.add(
                TaskType.COMPUTE, f"fwd_s{s}_m{m}", stage=s, micro=m,
                device_group=stage_devices[s],
                flops=replicas * sum(n.flops for n in prog.graph.nodes
                                     if prog.decomp.assignment[n.id] == s),
                out_bytes=float(sum(var_bytes(v) for v in mod.outvars)),
            )
            maps.fwd_tasks[(s, m)] = fwd.id
            dag.add_edge(dag.node(maps.input_tasks[s]), fwd)
            dag.add_edge(split, fwd)
            for pos in range(len(mod.invars)):
                src = mod.input_def_map[pos]
                if src[0] != "stage":
                    continue
                t, k = src[1], src[2]
                if tuple(stage_devices[t]) == tuple(stage_devices[s]):
                    # Co-resident stages (interleaved placement, or a
                    # shared device group): direct edge — a SEND/RECV
                    # pair would bill simulated transfer time for a
                    # local no-op (mirrors the cotangent path below).
                    dag.add_edge(dag.node(maps.fwd_tasks[(t, m)]), fwd,
                                 out_idx=k, arg_pos=pos)
                    continue
                key = ((t, k), m)
                if key not in maps.recv_tasks:
                    b = var_bytes(mod.invars[pos])
                    send = dag.add(
                        TaskType.SEND, f"send_s{t}o{k}_m{m}", stage=t,
                        micro=m, device_group=stage_devices[t], out_bytes=b)
                    dag.add_edge(dag.node(maps.fwd_tasks[(t, m)]), send,
                                 out_idx=k, arg_pos=0)
                    recv = dag.add(
                        TaskType.RECV, f"recv_s{t}o{k}_m{m}", stage=s,
                        micro=m, device_group=stage_devices[s], out_bytes=b)
                    dag.add_edge(send, recv, out_idx=0, arg_pos=0)
                    maps.recv_tasks[key] = recv.id
                    maps.recv_target[recv.id] = ("in", s, pos)
                dag.add_edge(dag.node(maps.recv_tasks[key]), fwd,
                             out_idx=0, arg_pos=pos)

    # Backward per (stage, micro), mirrored order; cotangent Send/Recv.
    # cot_source[(t, k), m] = (task_id, out_idx) producing the cotangent of
    # stage t's out k for micro m.
    cot_source: Dict[Tuple[Tuple[int, int], int], Tuple[int, int]] = {}
    for m in range(M):
        for s in range(S - 1, -1, -1):
            mod = prog.stages[s]
            bwd = dag.add(
                TaskType.COMPUTE, f"bwd_s{s}_m{m}", stage=s, micro=m,
                device_group=stage_devices[s],
                flops=2.0 * replicas * sum(
                    n.flops for n in prog.graph.nodes
                    if prog.decomp.assignment[n.id] == s),
                out_bytes=float(sum(var_bytes(v) for v in mod.invars)),
            )
            maps.bwd_tasks[(s, m)] = bwd.id
            # Inputs: same sources as fwd (params + received activations).
            dag.add_edge(dag.node(maps.input_tasks[s]), bwd)
            # Control edge fwd(s,m) -> bwd(s,m): the backward recomputes the
            # forward internally (remat), so without this edge the loss
            # stage's bwd — and transitively APPLY — could overtake later
            # micros' forwards and read already-updated weights.
            dag.add_edge(dag.node(maps.fwd_tasks[(s, m)]), bwd)
            for pos in range(len(mod.invars)):
                src = mod.input_def_map[pos]
                if src[0] == "stage":
                    key = ((src[1], src[2]), m)
                    if key in maps.recv_tasks:
                        dag.add_edge(dag.node(maps.recv_tasks[key]), bwd,
                                     out_idx=0, arg_pos=pos)
                    else:
                        # Co-resident producer: direct edge (no recv).
                        dag.add_edge(
                            dag.node(maps.fwd_tasks[(src[1], m)]), bwd,
                            out_idx=src[2], arg_pos=pos)
            # Cotangent inputs for this stage's outputs, delivered by later
            # stages' bwd tasks (cross-stage -> Send/Recv pair).
            n_in = len(mod.invars)
            for k in range(len(mod.outvars)):
                key = ((s, k), m)
                if key in cot_source:
                    src_task, src_out = cot_source[key]
                    src_node = dag.node(src_task)
                    if src_node.device_group != tuple(stage_devices[s]):
                        b = var_bytes(mod.outvars[k])
                        send = dag.add(
                            TaskType.SEND, f"send_cot_s{s}o{k}_m{m}",
                            stage=src_node.stage, micro=m,
                            device_group=src_node.device_group, out_bytes=b)
                        dag.add_edge(src_node, send, out_idx=src_out,
                                     arg_pos=0)
                        recv = dag.add(
                            TaskType.RECV, f"recv_cot_s{s}o{k}_m{m}",
                            stage=s, micro=m,
                            device_group=stage_devices[s], out_bytes=b)
                        dag.add_edge(send, recv, out_idx=0, arg_pos=0)
                        dag.add_edge(recv, bwd, out_idx=0, arg_pos=n_in + k)
                        maps.recv_target[recv.id] = ("out", s, k)
                    else:
                        dag.add_edge(src_node, bwd, out_idx=src_out,
                                     arg_pos=n_in + k)
            # This bwd produces cotangents for its activation inputs.
            for pos in range(len(mod.invars)):
                src = mod.input_def_map[pos]
                if src[0] == "stage":
                    cot_source[((src[1], src[2]), m)] = (bwd.id, pos)

    # NOTE: bwd tasks are created in reverse stage order per micro, so a
    # producer stage's bwd sees cot_source filled by consumer stages. For
    # multi-consumer edges the LAST writer wins — the executor accumulates
    # duplicate cotangents via payload (rare; chain pipelines have one).

    # GA chain per stage + APPLY.
    for s in range(S):
        prev = dag.node(maps.gainit_tasks[s])
        for m in range(M):
            mod = prog.stages[s]
            ga = dag.add(TaskType.GA, f"ga_s{s}_m{m}", stage=s, micro=m,
                         device_group=stage_devices[s],
                         out_bytes=float(sum(
                             var_bytes(mod.invars[p])
                             for p in mod.param_positions())))
            maps.ga_tasks[(s, m)] = ga.id
            dag.add_edge(prev, ga, out_idx=0, arg_pos=0)
            dag.add_edge(dag.node(maps.bwd_tasks[(s, m)]), ga,
                         out_idx=0, arg_pos=1)
            prev = ga
        ap = dag.add(TaskType.APPLY, f"apply_s{s}", stage=s,
                     device_group=stage_devices[s])
        maps.apply_tasks[s] = ap.id
        dag.add_edge(prev, ap, out_idx=0, arg_pos=0)
        dag.add_edge(dag.node(maps.input_tasks[s]), ap)

    # Shared parameters (e.g. tied embeddings consumed by several stages):
    # every sharing stage's final GA feeds the OWNER stage's APPLY so the
    # owner applies the summed gradient exactly once.
    param_stages: Dict[int, List[int]] = {}
    for s in range(S):
        mod = prog.stages[s]
        for p in mod.param_positions():
            i = mod.input_def_map[p][1]
            if i in set(prog.batch_flat_indices):
                continue
            param_stages.setdefault(i, [])
            if s not in param_stages[i]:
                param_stages[i].append(s)
    for i, stages_of_i in param_stages.items():
        if len(stages_of_i) <= 1:
            continue
        owner = min(stages_of_i)
        for t in stages_of_i:
            if t == owner:
                continue
            ga_last = dag.node(maps.ga_tasks[(t, M - 1)])
            apply_node = dag.node(maps.apply_tasks[owner])
            if tuple(stage_devices[t]) != tuple(stage_devices[owner]):
                # Gradient contribution crosses device groups/workers:
                # explicit Send/Recv pair (avoid duplicates when several
                # params share the same stage pair).
                key = (t, owner)
                if key not in getattr(maps, "_grad_xfer", {}):
                    if not hasattr(maps, "_grad_xfer"):
                        maps._grad_xfer = {}
                    send = dag.add(TaskType.SEND, f"send_grad_s{t}to{owner}",
                                   stage=t, device_group=stage_devices[t])
                    dag.add_edge(ga_last, send, out_idx=0, arg_pos=0)
                    recv = dag.add(TaskType.RECV, f"recv_grad_s{t}to{owner}",
                                   stage=owner,
                                   device_group=stage_devices[owner])
                    dag.add_edge(send, recv, out_idx=0, arg_pos=0)
                    maps._grad_xfer[key] = recv.id
                dag.add_edge(dag.node(maps._grad_xfer[key]), apply_node,
                             out_idx=0, arg_pos=1 + t)
            else:
                dag.add_edge(ga_last, apply_node, out_idx=0, arg_pos=1 + t)

    merge = dag.add(TaskType.MERGE, "merge", device_group=())
    maps.merge_task = merge.id
    loss_stage = next(s for s in range(S)
                      if 0 in prog.stages[s].graph_out_map)
    for m in range(M):
        dag.add_edge(dag.node(maps.fwd_tasks[(loss_stage, m)]), merge)
    for s in range(S):
        dag.add_edge(dag.node(maps.apply_tasks[s]), merge)

    # Winner-planned wire compression: tag every cross-stage transfer
    # (and any AR) with the program's comm dtype so the scheduler prices
    # — and the distributed runtime encodes — the compressed payload.
    cd = getattr(prog, "comm_dtype", "") or ""
    if cd:
        for n in dag.nodes:
            if n.task_type in (TaskType.SEND, TaskType.RECV, TaskType.AR):
                n.comm_dtype = cd

    # ZeRO winners: tag the weight-update tasks so executors shard the
    # per-stage optimizer state over intra-stage data replicas
    # (reduce-scatter grads, local apply, all-gather params).
    if getattr(prog, "zero", False):
        for n in dag.nodes:
            if n.task_type in (TaskType.APPLY, TaskType.AR):
                n.zero = True

    dag.validate()
    return dag, maps
