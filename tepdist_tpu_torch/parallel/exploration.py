"""Unified exploration: ONE candidate space for every entry point.

Reference parity: ``AutoParallel::RunExplorationlMode`` (reference:
service/parallel/auto_parallel.cc:236 — GenerateSplitProposals enumerates
DeviceSplitPlan proposals of up to 3 mesh levels INCLUDING pipeline stage
levels, plans each, and keeps the Evaluator-minimal one).

The port of ``tepdist_tpu/parallel/exploration.py``. Every explorer of the
port — ``train.plan_training(explore=True)``, ``train.explore_parallelism``
and the library-level ``auto_parallel_explore`` — calls :func:`explore`
or :func:`spmd_candidates` here, so they all search the SAME space:

  * SPMD mesh factorizations (data / model / data x model / 3-level),
    each with its ``@bf16``, ``@int8`` and ``@zero`` modifiers,
  * sequence-parallel data x seq meshes priced with the ring/Ulysses
    attention cost when the loss contains attention motifs,
  * pipeline stage cuts (S x M x intra-stage TP, with their ``@zero`` and
    comm-dtype modifiers, blocked and interleaved), priced by the task
    scheduler's simulation (``Evaluator.run_pipeline``).

A kind a caller leaves out is recorded as ``excluded_kinds`` in the result
and its report, as the reference records a restricted search.

The winner is a dict: ``{"kind": "spmd"|"pipeline", ..., "cost": Cost,
"candidates": [all proposals]}``; the library surface
(``auto_parallel_explore``) returns a pipeline winner as a
:class:`PipelineWinner`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, List, Tuple

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.telemetry import observatory, span

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PipelineWinner:
    """A pipeline-stage-cut exploration winner (reference: a DeviceSplitPlan
    whose outermost ordinal is the stage level). ``build(optimizer)``
    materializes the task-graph runtime executable for it (over
    ``devices``; under a process group, one device a rank)."""

    num_stages: int
    num_micro_batches: int
    intra_tp: int
    cost: Any
    candidates: List[Dict[str, Any]]
    loss_fn: Callable
    params: Any
    example_batch: Tuple[Any, ...]
    kind: str = "pipeline"
    mode: str = "exploration"
    placement: str = "blocked"
    interleave_groups: Any = None
    comm_dtype: str = ""
    zero: bool = False

    def build(self, optimizer, devices=None, **kwargs):
        import torch.distributed as dist

        from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
        from tepdist_tpu_torch.runtime.executor import (PipelineExecutable,
                                                        stage_replicas)

        if devices is not None:
            n = len(devices)
        elif dist.is_initialized():
            n = dist.get_world_size()
        else:
            n = self.num_stages
        prog = plan_pipeline(self.loss_fn, self.num_stages,
                             self.num_micro_batches, self.params,
                             *self.example_batch, replicas=stage_replicas(
                                 n, self.num_stages, self.intra_tp,
                                 self.placement, self.interleave_groups))
        prog.comm_dtype = self.comm_dtype
        prog.zero = self.zero
        return PipelineExecutable(prog, devices=devices,
                                  optimizer=optimizer,
                                  intra_stage_tp=self.intra_tp,
                                  placement=self.placement,
                                  interleave_groups=self.interleave_groups,
                                  **kwargs)


# ----------------------------------------------------------------------
# Candidate enumerators (shared by every exploration surface)
# ----------------------------------------------------------------------

def spmd_candidates(graph, n_devices: int,
                    annotations=None,
                    num_micro_batches: int = 1) -> List[Dict[str, Any]]:
    """Plan + price every mesh-shape proposal on ``graph`` (reference:
    GenerateSplitProposals step 1-2, auto_parallel.cc:132-181)."""
    from tepdist_tpu_torch.parallel.auto_parallel import (
        explore_topologies,
        plan_axes,
    )
    from tepdist_tpu_torch.parallel.evaluator import Evaluator

    out: List[Dict[str, Any]] = []
    for topo in explore_topologies(n_devices):
        try:
            strategies = plan_axes(graph, topo, annotations, "cost")
            # Fidelity FIRST: Python's min keeps the earliest on exact
            # cost ties, so a compressed variant must strictly beat the
            # fidelity plan to win (bit-identity guarantee on ties).
            cost = Evaluator(topo).run(graph, strategies,
                                       num_micro_batches)
            out.append({"kind": "spmd", "topology": topo, "cost": cost,
                        "strategies": strategies})
            # Comm-dtype candidate modifiers (EQuARX, arXiv:2506.17615):
            # the SAME sharding re-priced with compressed gradient
            # collectives — wire bytes shrink by the dtype ratio, a
            # quantize/dequantize term is added — so the argmin, not an
            # env knob, decides per candidate where compression wins.
            # A plan with no priced collectives has nothing to compress:
            # the re-pricing could only tie (which fidelity wins) or add
            # overhead, so the variants are skipped, not enumerated.
            if cost.coll_ratio > 0.0 and cost.memory_feasible:
                for dt in ("bfloat16", "int8"):
                    ccost = Evaluator(topo, comm_dtype=dt).run(
                        graph, strategies, num_micro_batches)
                    out.append({"kind": "spmd", "topology": topo,
                                "cost": ccost, "strategies": strategies,
                                "comm_dtype": dt})
            # ZeRO modifier (arXiv:2004.13336): every DP-bearing proposal
            # re-priced with the weight update sharded over the data axis.
            # Deliberately NOT gated on the fidelity plan's memory
            # feasibility — the binding scenario is exactly a fidelity
            # plan whose replicated optimizer state does not fit, and an
            # infeasible fidelity keys to inf so ZeRO wins strictly.
            dp = next((sz for nm, sz in topo.device_axes()
                       if nm == "data" and sz > 1), 1)
            if dp > 1 and cost.coll_ratio > 0.0:
                zcost = Evaluator(topo, zero=True).run(
                    graph, strategies, num_micro_batches)
                out.append({"kind": "spmd", "topology": topo,
                            "cost": zcost, "strategies": strategies,
                            "zero": True})
                for dt in ("bfloat16", "int8"):
                    zc = Evaluator(topo, comm_dtype=dt, zero=True).run(
                        graph, strategies, num_micro_batches)
                    out.append({"kind": "spmd", "topology": topo,
                                "cost": zc, "strategies": strategies,
                                "comm_dtype": dt, "zero": True})
        except Exception as e:  # noqa: BLE001 — infeasible proposal
            observatory.record_prune("spmd", str(topo),
                                     "planning_exception", exc=e)
    return out


def seq_candidates(graph, n_devices: int,
                   batch_rows: int) -> List[Dict[str, Any]]:
    """Sequence-parallel data x seq proposals, priced with the cheaper of
    the ring and Ulysses attention comm (forward and reverse): the
    backward nodes are invisible to the forward-seeded propagation, so
    the generic evaluator would overprice seq compute."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.graph.fx_graph import var_bytes, var_shape
    from tepdist_tpu_torch.parallel.attention_motif import (best_seq_comm,
                                                            detect_motifs)
    from tepdist_tpu_torch.parallel.auto_parallel import plan_axes
    from tepdist_tpu_torch.parallel.evaluator import Cost, Evaluator
    from tepdist_tpu_torch.parallel.performance_utils import (
        OPT_STATE_FACTOR, PerfUtils, chip_spec)
    from tepdist_tpu_torch.parallel.sync_free import (
        estimate_peak_activation_bytes)

    motifs = detect_motifs(graph, allow_escape=True)
    if not motifs:
        return []
    out: List[Dict[str, Any]] = []
    for s in (2, 4, 8, 16):
        if s > n_devices or n_devices % s:
            observatory.record_prune(
                "seq", f"seq={s}", "enumeration_skip",
                message=f"seq={s} does not divide {n_devices} devices")
            continue
        d = n_devices // s
        if any(m.seq_len % s for m in motifs) or batch_rows % max(d, 1):
            observatory.record_prune(
                "seq", f"seq={s}", "enumeration_skip",
                message=f"seq_len or batch_rows not divisible at seq={s}")
            continue
        axes = ([("data", d)] if d > 1 else []) + [("seq", s)]
        topo = MeshTopology(axes)
        try:
            # A data x seq mesh shards a transformer's whole compute
            # (every tensor carries the batch or token dim); comm = the
            # data axis's own pricing (gradient reduces) + the exposed
            # ring (forward + reverse).
            spec = chip_spec()
            impl, comm = best_seq_comm(motifs, s, spec,
                                        with_backward=True)
            if d > 1:
                topo_d = MeshTopology([("data", d)])
                gs_d = plan_axes(graph, topo_d, None, "cost")[0]
                # The re-derived pricing the Evaluator applies to the
                # rival SPMD candidates.
                comm += Evaluator(topo_d).derived_comm(graph, gs_d)
            # The COMM_OVERLAP discount the Evaluator applies to the
            # rival candidates, so hand-priced ones compete evenly.
            overlap = min(max(ServiceEnv.get().comm_overlap, 0.0), 1.0)
            comm *= (1.0 - overlap)
            compute_t = PerfUtils.compute_time(
                graph.total_flops() / n_devices, spec)
            state = sum(var_bytes(v) for v in graph.invars)
            act = estimate_peak_activation_bytes(graph) / n_devices
            # The optimizer-state charge of the rival candidates (grads =
            # the non-scalar outputs of the value-and-grad capture).
            opt_bytes = OPT_STATE_FACTOR * sum(
                var_bytes(ov) for ov in graph.outvars
                if ov is not None and var_shape(ov))
            total = compute_t + comm
            budget = spec.hbm_gb * 1e9 * 0.9
            peak = state + act + opt_bytes
            cost = Cost(
                total_duration=total,
                compute_efficiency=compute_t / total if total else 0.0,
                coll_ratio=comm / total if total else 0.0,
                bubble_ratio=0.0,
                peak_bytes_per_device=peak,
                memory_feasible=peak <= budget,
                opt_state_bytes_per_device=opt_bytes)
            out.append({"kind": "spmd", "topology": topo, "cost": cost,
                        "enum_kind": "seq", "seq_impl": impl})
        except Exception as e:  # noqa: BLE001 — infeasible proposal
            observatory.record_prune("seq", str(topo),
                                     "planning_exception", exc=e)
    return out


def pipeline_candidates(loss_fn: Callable, params, example_batch,
                        n_devices: int, batch_rows: int,
                        num_micro_batches: int = 4) -> List[Dict[str, Any]]:
    """Pipeline stage-cut proposals S x M x intra-stage-TP (reference: up
    to 3 split ordinals incl. the stage level, auto_parallel.cc:132-181):
    each tp variant re-prices the SAME stage cut with per-stage compute
    divided over the model axis plus the stage planner's TP comm, folded
    into the task-time model as equivalent flops. Each blocked cut also
    comes with its ``@zero`` (dp > 1) and comm-dtype variants, and each
    even S with an interleaved variant over S/2 groups."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.parallel.evaluator import Evaluator
    from tepdist_tpu_torch.parallel.performance_utils import (
        OPT_STATE_FACTOR, PerfUtils, chip_spec)
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.runtime.execution_plan import (
        build_pipeline_task_dag)
    from tepdist_tpu_torch.runtime.task_graph import TaskType

    # Stage owners hold their stage's params + optimizer state; the
    # scheduler's activation/weight model never sees the optimizer, so
    # pipeline candidates carry the state charge explicitly (per stage
    # ~ total/S, divided over the intra-stage TP axis where present).
    param_bytes = float(sum(math.prod(l.shape) * l.element_size()
                            for l in tree_leaves(params)))

    out: List[Dict[str, Any]] = []
    for S in (2, 4, 8, 16):
        # Blocked placements need S <= devices; VIRTUAL stages (the
        # interleaved variants below) only need S/v groups to fit, so
        # S up to v * n_devices stays proposable.
        blocked_ok = S <= n_devices and n_devices % S == 0
        if not blocked_ok and (S % 2 or n_devices % (S // 2)):
            observatory.record_prune(
                "pipeline", f"S={S}", "enumeration_skip",
                message=f"S={S} not placeable on {n_devices} devices "
                        "(blocked or interleaved)")
            continue
        per = n_devices // S if blocked_ok else 0
        for M in sorted({num_micro_batches, 2 * num_micro_batches}):
            if batch_rows % M:
                observatory.record_prune(
                    "pipeline", f"S={S} M={M}", "enumeration_skip",
                    message=f"batch_rows={batch_rows} not divisible "
                            f"by M={M}")
                continue
            try:
                prog = plan_pipeline(loss_fn, S, M, params, *example_batch)
            except Exception as e:  # noqa: BLE001 — infeasible proposal
                observatory.record_prune(
                    "pipeline", f"S={S} M={M}", "planning_exception",
                    exc=e)
                continue
            stage_devs = ([tuple(range(s * per, (s + 1) * per))
                           for s in range(S)] if blocked_ok else None)
            stage_graphs = None
            for tp in ((1, 2, 4, 8) if blocked_ok else ()):
                if tp > per or per % tp:
                    observatory.record_prune(
                        "pipeline", f"S={S} M={M} tp={tp}",
                        "enumeration_skip",
                        message=f"tp={tp} does not fit the {per} "
                                "devices per stage")
                    continue
                try:
                    dag, _ = build_pipeline_task_dag(prog, stage_devs)
                    if tp > 1:
                        if stage_graphs is None:
                            stage_graphs = _stage_fwd_graphs(prog)
                        comm_s = _stage_tp_comm_seconds(stage_graphs, tp)
                        sec_per_flop = PerfUtils.compute_time(
                            1.0, chip_spec())
                        for n in dag.nodes:
                            if n.task_type == TaskType.COMPUTE:
                                n.flops = (n.flops / tp
                                           + comm_s[n.stage] / sec_per_flop)
                    ev = Evaluator(MeshTopology([("stage", S)]))
                    stage_state = OPT_STATE_FACTOR * param_bytes / (S * tp)
                    cost = ev.run_pipeline(dag,
                                           opt_state_bytes=stage_state)
                    out.append(
                        {"kind": "pipeline", "num_stages": S,
                         "num_micro_batches": M, "intra_tp": tp,
                         "placement": "blocked", "cost": cost})
                    # ZeRO variant: the stage's weight update sharded over
                    # the intra-stage DP replicas (per//tp of them). NOT
                    # gated on fidelity feasibility: the binding case is
                    # a stage whose replicated optimizer state won't fit.
                    dp = per // tp
                    if dp > 1:
                        zs = PerfUtils.zero_update_cost(
                            param_bytes / (S * tp), dp, "", chip_spec())
                        zcost = ev.run_pipeline(
                            dag, opt_state_bytes=stage_state, zero_dp=dp,
                            zero_comm_s=zs)
                        out.append(
                            {"kind": "pipeline", "num_stages": S,
                             "num_micro_batches": M, "intra_tp": tp,
                             "placement": "blocked", "cost": zcost,
                             "zero": True})
                    # Comm-dtype variants: the SAME stage cut with the
                    # cross-stage SEND/RECV (and any AR) payloads shrunk
                    # to the wire dtype (the scheduler prices the tagged
                    # nodes with the compressed ppermute/AR cost).
                    comm_nodes = [n for n in dag.nodes
                                  if n.task_type in (TaskType.SEND,
                                                     TaskType.RECV,
                                                     TaskType.AR)]
                    if not comm_nodes:
                        continue
                    for dt in ("bfloat16", "int8"):
                        for n in comm_nodes:
                            n.comm_dtype = dt
                        if cost.memory_feasible:
                            ccost = ev.run_pipeline(
                                dag, opt_state_bytes=stage_state)
                            out.append(
                                {"kind": "pipeline", "num_stages": S,
                                 "num_micro_batches": M, "intra_tp": tp,
                                 "placement": "blocked", "cost": ccost,
                                 "comm_dtype": dt})
                        if dp > 1:
                            zs = PerfUtils.zero_update_cost(
                                param_bytes / (S * tp), dp, dt,
                                chip_spec())
                            zc = ev.run_pipeline(
                                dag, opt_state_bytes=stage_state,
                                zero_dp=dp, zero_comm_s=zs)
                            out.append(
                                {"kind": "pipeline", "num_stages": S,
                                 "num_micro_batches": M, "intra_tp": tp,
                                 "placement": "blocked", "cost": zc,
                                 "comm_dtype": dt, "zero": True})
                    for n in comm_nodes:
                        n.comm_dtype = ""
                except Exception as e:  # noqa: BLE001 — infeasible proposal
                    observatory.record_prune(
                        "pipeline", f"S={S} M={M} tp={tp}",
                        "planning_exception", exc=e)
            # Interleaved variants (Megatron virtual stages, reference:
            # the stage ordinal placed round-robin): the SAME S-stage cut
            # over G = S/v device groups, stage s -> group s % G. The
            # scheduler's interleaved-aware candidate search prices the
            # chunk-alternating schedule.
            for v in (2,):
                if S % v or S // v < 2:
                    observatory.record_prune(
                        "pipeline", f"S={S} M={M} il/v={v}",
                        "enumeration_skip",
                        message=f"S={S} yields fewer than 2 virtual "
                                f"groups at v={v}")
                    continue
                G = S // v
                if n_devices % G:
                    observatory.record_prune(
                        "pipeline", f"S={S} M={M} il/G={G}",
                        "enumeration_skip",
                        message=f"{G} groups do not divide "
                                f"{n_devices} devices")
                    continue
                per_g = n_devices // G
                groups = [tuple(range(g * per_g, (g + 1) * per_g))
                          for g in range(G)]
                try:
                    dag, _ = build_pipeline_task_dag(
                        prog, [groups[s % G] for s in range(S)])
                    # Each of the G groups owns S/G virtual stages' params
                    # + optimizer state. (ZeRO variants of interleaved
                    # placements are not enumerated: the chunk-alternating
                    # schedule leaves no idle window for the update
                    # collectives the blocked variants amortize.)
                    cost = Evaluator(
                        MeshTopology([("stage", S)])).run_pipeline(
                            dag,
                            opt_state_bytes=(OPT_STATE_FACTOR
                                             * param_bytes / G))
                    out.append(
                        {"kind": "pipeline", "num_stages": S,
                         "num_micro_batches": M, "intra_tp": 1,
                         "placement": "interleaved",
                         "interleave_groups": G, "cost": cost})
                except Exception as e:  # noqa: BLE001 — infeasible proposal
                    observatory.record_prune(
                        "pipeline", f"S={S} M={M} il/G={G}",
                        "planning_exception", exc=e)
    return out


def _stage_fwd_graphs(prog) -> List[Any]:
    """Each stage's forward graph ONCE (tp-independent; reused across the
    tp variants of a proposal): the stage module as an ``FxGraph``."""
    from tepdist_tpu_torch.graph.fx_graph import FxGraph

    return [FxGraph(prog.decomp.stage_fn(s))
            for s in range(prog.num_stages)]


def _stage_tp_comm_seconds(stage_graphs, tp: int) -> List[float]:
    """Per-stage FORWARD TP comm time (seconds) under a ``model`` axis of
    size ``tp``: the stage planner's comm-only objective. NOT doubled for
    the backward: the caller adds it to both the fwd and the bwd COMPUTE
    node of each (stage, micro), which prices the reverse collectives
    (that mirror the forward's) exactly once."""
    from tepdist_tpu_torch.parallel.cost_spmd_strategy import (
        CostSpmdStrategy)

    return [(CostSpmdStrategy(g, "model", tp, fixed={}).run().comm_cost
             or 0.0) for g in stage_graphs]


# ----------------------------------------------------------------------
# The unified explorer
# ----------------------------------------------------------------------

def explore(
    loss_fn: Callable,
    params,
    *example_batch,
    n_devices: int,
    num_micro_batches: int = 4,
    include_pipeline: bool = True,
    include_seq: bool = True,
    entry_point: str = "explore",
) -> Dict[str, Any]:
    """Exploration over the unified candidate space (reference:
    RunExplorationlMode over DeviceSplitPlan proposals incl. pipeline
    levels): evaluate the SPMD mesh factorizations and their modifiers,
    the sequence-parallel data x seq meshes (``include_seq``) and the
    pipeline stage cuts (``include_pipeline``) under the analytic cost
    model (the SPMD and seq kinds on the loss's value-and-grad graph,
    captured on fake tensors: no device is needed); return the winner as
    ``{"kind": "spmd"|"pipeline", ..., "candidates": [...]}``.

    A restricted search is RECORDED in the result (``excluded_kinds``) and
    its report, never silent.

    The whole search runs under an observatory capture: every enumerated
    proposal lands in the winner's ``best["report"]``
    (``telemetry/observatory.ExplorationReport``) as a priced candidate
    or a typed prune record, with phase timings and the winner's
    rationale."""
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.graph.fx_graph import trace_graph
    from tepdist_tpu_torch.train import value_and_grad

    with observatory.capture(entry_point) as col:
        t0 = time.perf_counter()
        with span("explore:trace", cat="planner"):
            graph, _, _ = trace_graph(value_and_grad(loss_fn), params,
                                      *example_batch)
        if col is not None:
            col.phase("trace", time.perf_counter() - t0)

        t0 = time.perf_counter()
        with span("explore:spmd", cat="planner", n_devices=n_devices):
            candidates = spmd_candidates(graph, n_devices)
        if col is not None:
            col.phase("spmd", time.perf_counter() - t0)
        excluded: List[str] = []
        if include_seq:
            t0 = time.perf_counter()
            batch_rows = tree_leaves(example_batch)[0].shape[0]
            with span("explore:seq", cat="planner"):
                candidates += seq_candidates(graph, n_devices, batch_rows)
            if col is not None:
                col.phase("seq", time.perf_counter() - t0)
        else:
            excluded.append("seq")
        if include_pipeline:
            t0 = time.perf_counter()
            batch_rows = tree_leaves(example_batch)[0].shape[0]
            with span("explore:pipeline", cat="planner"):
                candidates += pipeline_candidates(
                    loss_fn, params, example_batch, n_devices, batch_rows,
                    num_micro_batches)
            if col is not None:
                col.phase("pipeline", time.perf_counter() - t0)
        else:
            excluded.append("pipeline")
        if not candidates:
            if col is not None:
                report = observatory.build_report(
                    col, [], None, n_devices, entry_point=entry_point,
                    excluded_kinds=excluded)
                for w in report.warnings:
                    log.warning("exploration: %s", w)
            raise RuntimeError("no feasible parallelism proposal")
        best = min(candidates, key=lambda c: c["cost"].key())
        log.info("exploration winner: %s (duration %.3e s/step) of %d "
                 "proposals", best["kind"], best["cost"].total_duration,
                 len(candidates))
        if ServiceEnv.get().debug:
            _dump_candidate_table(candidates, best)
        best["candidates"] = candidates
        best["excluded_kinds"] = excluded
        if col is not None:
            report = observatory.build_report(
                col, candidates, best, n_devices,
                excluded_kinds=excluded)
            best["report"] = report.to_dict()
    return best


def winner_lowering_postcheck(plan, args) -> List[str]:
    """Winner-only lowering post-check for the LIBRARY explore path: one
    step of the chosen plan runs on ``args`` (flat, graph order) under
    ``CommDebugMode`` (``lowering_diagnostics``). Any all-gather of a
    split operand (parallel/lowering_check.py) is recorded on the plan
    (``plan.lowering_remats``), folded into the winner's candidate row (so
    ``candidate_summary`` surfaces them), and counted under the
    ``involuntary_remat`` warning counter — the same consumer contract as
    the train path. Gated by LOWERING_POSTCHECK; skipped (with a log line)
    when no process group spans the winner's mesh."""
    if not ServiceEnv.get().lowering_postcheck:
        return []
    import torch.distributed as dist

    from tepdist_tpu_torch.telemetry import metrics

    n = plan.topology.num_devices
    if not dist.is_initialized() or dist.get_world_size() != n:
        log.info("lowering post-check skipped: no process group of %d "
                 "ranks", n)
        return []
    device_type = next((a.device.type for a in args
                        if hasattr(a, "device")), "cuda")
    try:
        remats = plan.lowering_diagnostics(args, device_type=device_type)
    except Exception as e:  # noqa: BLE001 — diagnostics only
        log.warning("lowering post-check failed: %r", e)
        return []
    plan.lowering_remats = list(remats)
    for c in getattr(plan, "candidates", None) or ():
        # The winner's candidate dict shares its Cost object with the plan.
        if c.get("cost") is getattr(plan, "cost", None):
            c["involuntary_remats"] = list(remats)
    # Fold the verdict into the decision record (the postcheck runs
    # after the search returned, so the report already exists).
    observatory.fold_remats(getattr(plan, "exploration_report", None),
                            remats)
    if remats:
        metrics().counter("involuntary_remat").inc(len(remats))
        log.warning(
            "explore winner (axes=%s): %d op(s) all-gathered a split "
            "operand (%s) — the chosen sharding forces resharding the "
            "cost model did not price; consider a different topology",
            list(plan.topology.device_axes()), len(remats),
            ", ".join(remats[:3]))
    return list(remats)


_COMM_DTYPE_SHORT = {"bfloat16": "bf16", "int8": "int8"}


def comm_dtype_suffix(comm_dtype: str) -> str:
    """Render a candidate's comm-dtype modifier as the ``@bf16``/``@int8``
    config suffix — the ONE rendering shared by candidate_summary and the
    observatory's candidate_config, so plan_diff joins fidelity and
    compressed variants of the same config as distinct candidates."""
    if not comm_dtype or comm_dtype == "float32":
        return ""
    return "@" + _COMM_DTYPE_SHORT.get(comm_dtype, comm_dtype)


def zero_suffix(zero: bool) -> str:
    """Render a candidate's ZeRO weight-update-sharding modifier as the
    ``@zero`` config suffix — like :func:`comm_dtype_suffix`, the ONE
    rendering shared by candidate_summary and the observatory's
    candidate_config, so plan_diff joins fidelity and ZeRO variants of
    the same config as distinct candidates."""
    return "@zero" if zero else ""


def candidate_summary(candidates, best=None) -> List[Dict[str, Any]]:
    """Wire/debug-friendly ranked table of explored candidates (reference:
    candidate strategy dumps, auto_parallel.cc:309-311)."""
    rows = []
    for c in sorted(candidates, key=lambda c: c["cost"].key()):
        cfg = (str(c["topology"]) if c["kind"] == "spmd" else
               f"S={c['num_stages']} M={c['num_micro_batches']}"
               + (f" tp={c['intra_tp']}" if c.get("intra_tp", 1) > 1
                  else "")
               + (f" il/G={c['interleave_groups']}"
                  if c.get("placement") == "interleaved" else ""))
        cfg += comm_dtype_suffix(c.get("comm_dtype", ""))
        cfg += zero_suffix(c.get("zero", False))
        cost = c["cost"]
        rows.append({
            "kind": c["kind"], "config": cfg,
            "duration_s": float(cost.total_duration),
            "coll_ratio": float(cost.coll_ratio),
            "bubble_ratio": float(cost.bubble_ratio),
            "memory_feasible": bool(cost.memory_feasible),
            "winner": best is not None and c is best,
        })
        if "involuntary_remats" in c:
            rows[-1]["involuntary_remats"] = len(c["involuntary_remats"])
    return rows


# ----------------------------------------------------------------------
# Fleet replan (live migration): re-rank a RECORDED report for a
# new fleet shape
# ----------------------------------------------------------------------

def _config_fits_devices(row: Dict[str, Any], n_devices: int) -> bool:
    """Whether a recorded candidate row's config is placeable on
    ``n_devices`` — the same feasibility rules the enumerators apply at
    proposal time (mesh axis product; S|interleave-group divisibility),
    re-checked from the config STRING because a persisted report no
    longer carries the live proposal dicts."""
    import re as _re
    cfg = row["config"].split("@", 1)[0].strip()
    if row["kind"] == "spmd":
        prod = 1
        for _, v in _re.findall(r"(\w+)=(\d+)", cfg):
            prod *= int(v)
        return 0 < prod <= n_devices
    m = _re.search(r"\bS=(\d+)", cfg)
    if not m:
        return False
    S = int(m.group(1))
    g = _re.search(r"il/G=(\d+)", cfg)
    if g:
        G = int(g.group(1))
        return 0 < G <= n_devices and n_devices % G == 0
    if S <= n_devices and n_devices % S == 0:
        return True
    # Blocked fallback the pipeline enumerator allows: two virtual
    # stages per device group.
    return S % 2 == 0 and S // 2 <= n_devices and n_devices % (S // 2) == 0


def replan_for_fleet(report: Dict[str, Any], n_devices: int,
                     n_workers: int = None
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Re-run the ranking of a recorded exploration report against a NEW
    fleet shape (live migration's replan step): drop candidates whose
    config no longer fits ``n_devices``, re-rank the survivors by the
    same (memory_feasible, total_s) argmin key, and name WHY the winner
    moved via :func:`observatory.diff_reports` (a shrink that evicts the
    old winner reports ``driver == "candidate_set_change"``).

    Recorded costs were modeled for the OLD shape — this is a cheap
    re-rank of the recorded frontier, not a fresh enumeration; the
    migration path only needs the driver attribution and a feasible
    winner, and a full re-exploration can follow out-of-band.

    Returns ``(new_report_dict, diff)``; raises ``ValueError`` when no
    recorded candidate fits the new shape."""
    old_cands = report.get("candidates") or []
    kept = [dict(c) for c in old_cands
            if _config_fits_devices(c, n_devices)]
    if not kept:
        raise ValueError(
            f"no recorded candidate fits {n_devices} devices "
            f"(report had {len(old_cands)})")
    kept.sort(key=lambda c: (not c["cost"]["memory_feasible"],
                             c["cost"]["total_s"]))
    for rank, c in enumerate(kept):
        c["rank"] = rank
        c["winner"] = rank == 0
    new_report = dict(report)
    new_report["candidates"] = kept
    new_report["winner"] = kept[0]
    new_report["runner_up"] = next(
        (c for c in kept[1:] if c["cost"]["memory_feasible"]), None)
    new_report["n_devices"] = n_devices
    new_report["replanned_from_devices"] = report.get("n_devices")
    diff = observatory.diff_reports(report, new_report)
    log.warning(
        "fleet replan: %d devices%s -> %d candidates of %d kept, "
        "winner %s (driver %s)", n_devices,
        f" / {n_workers} workers" if n_workers else "",
        len(kept), len(old_cands), kept[0]["config"],
        diff.get("driver") or "none (winner unchanged)")
    return new_report, diff


def _dump_candidate_table(candidates, best) -> None:
    from tepdist_tpu_torch.core.debug_dump import write_dump

    lines = [f"{'rank':>4} {'kind':>8} {'config':<28} "
             f"{'duration_s':>12} {'coll%':>6} {'bubble%':>8}"]
    for r, row in enumerate(candidate_summary(candidates, best)):
        mark = " <== winner" if row["winner"] else ""
        lines.append(f"{r:>4} {row['kind']:>8} {row['config']:<28} "
                     f"{row['duration_s']:>12.4e} "
                     f"{100 * row['coll_ratio']:>6.1f} "
                     f"{100 * row['bubble_ratio']:>8.1f}{mark}")
    write_dump("exploration_candidates.txt", "\n".join(lines) + "\n")
