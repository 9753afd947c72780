"""Unified exploration: ONE candidate space for every entry point.

Reference parity: ``AutoParallel::RunExplorationlMode`` (reference:
service/parallel/auto_parallel.cc:236 — GenerateSplitProposals enumerates
DeviceSplitPlan proposals of up to 3 mesh levels INCLUDING pipeline stage
levels, plans each, and keeps the Evaluator-minimal one).

The port of ``tepdist_tpu/parallel/exploration.py``. Every explorer of the
port — ``train.plan_training(explore=True)``, ``train.explore_parallelism``
and the library-level ``auto_parallel_explore`` — calls :func:`explore`
or :func:`spmd_candidates` here, so they all search the SAME space: the
SPMD mesh factorizations (data / model / data x model / 3-level), each
with its ``@bf16``, ``@int8`` and ``@zero`` modifiers. The reference's
other two kinds come with their runtimes: pipeline stage cuts
(``pipeline_candidates``, ``PipelineWinner``) with ROADMAP item 13b (their
blocked candidates put several devices in a stage) and
sequence-parallel meshes (``seq_candidates``) with item 14. Until then
:func:`explore` records them as ``excluded_kinds`` in its result and its
report, as the reference records a restricted search.

The winner is a dict: ``{"kind": "spmd", "topology": ..., "cost": Cost,
"candidates": [all proposals], ...}``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Tuple

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.telemetry import observatory, span

log = logging.getLogger(__name__)


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


# ----------------------------------------------------------------------
# The unified explorer
# ----------------------------------------------------------------------

def explore(
    loss_fn: Callable,
    params,
    *example_batch,
    n_devices: int,
    num_micro_batches: int = 4,
    include_pipeline: bool = False,
    include_seq: bool = True,
    entry_point: str = "explore",
) -> Dict[str, Any]:
    """Exploration over the candidate space (reference:
    RunExplorationlMode over DeviceSplitPlan proposals): evaluate the SPMD
    mesh factorizations and their modifiers, and the sequence-parallel
    data x seq meshes (``include_seq``), under the analytic cost model on
    the loss's value-and-grad graph, captured on fake tensors (no device
    is needed); return the winner as ``{"kind": "spmd", ...,
    "candidates": [...]}``.

    ``include_pipeline`` must stay False until the multi-device pipeline
    stages (ROADMAP item 13b) are ported. What the search leaves out is
    RECORDED in the result (``excluded_kinds``) and its report, never
    silent.

    The whole search runs under an observatory capture: every enumerated
    proposal lands in the winner's ``best["report"]``
    (``telemetry/observatory.ExplorationReport``) as a priced candidate
    or a typed prune record, with phase timings and the winner's
    rationale."""
    if include_pipeline:
        raise NotImplementedError(
            "pipeline candidates need more than one device in a stage, "
            "which the pipeline runtime does not run yet (ROADMAP item 13b)")
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
