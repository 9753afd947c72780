"""Live plan migration: master-side move planner for the elastic fleet
(the port of the JAX package's ``runtime/migration.py``; framework
neutral, so the port keeps its own copy).

When the fleet shape changes mid-run (heartbeat-dead
worker, or a revived/new worker registering), the session fences at the
step boundary and — instead of the checkpoint round-trip the
``_auto_redispatch`` rung pays — reshards IN PLACE: this module computes,
from the old and new fleet snapshots, exactly which parameter and
optimizer-state shards each destination worker must adopt and from where,
and the executor fans the resulting move lists out as ``AdoptShard`` RPCs
(worker→worker ``FetchShard`` pulls over the Frames zero-copy path, with
a shared-checkpoint fallback source for state only a dead or dirty worker
held).

Source selection ladder, per destination shard:
  1. the destination already holds the agreed value (it held the shard
     before, is alive, and is CLEAN — it did not locally commit the
     fenced step) -> no move;
  2. a live clean holder exists -> live worker→worker pull
     (``plan_redistribution`` names the pieces; in the current executor
     every holder holds the full extent, so this is one full-extent
     piece, but the planner goes through the redistribution machinery so
     partial layouts compose);
  3. no live clean source -> ``plan_redistribution`` raises the typed
     ``RedistributionError`` whose uncovered ``intervals`` become
     checkpoint-read descriptors against the shard files written at the
     fenced step (elastic autosave writes one every committed step);
  4. no checkpoint at exactly the fenced step -> ``MigrationInfeasible``
     and the executor falls to the checkpoint-rollback rung.

"Dirty" workers — survivors whose WorkerPlan already committed the
fenced step locally (probed via Ping's ``wp_completed``) — are AHEAD of
the fleet's agreed state: their in-memory shards are excluded as sources
and their own holdings are rebased from their checkpoint files (written
at the fenced step, before the step ran, hence clean).

Optimizer state moves ride the same ladder but transfer whole per-stage
slot lists (this executor's @zero sharding is intra-worker: FetchShard
gathers the shards to host and the adopter's ``_apply`` re-pins them over
ITS local mesh at read time). Stages that stay on a clean surviving
worker are not moved at all — the DispatchPlan ``carry_state`` flag
carries their slots across the plan swap (a fresh WorkerPlan would
otherwise silently re-run opt_init).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

log = __import__("logging").getLogger(__name__)


class MigrationInfeasible(RuntimeError):
    """Live migration cannot reconstruct the fleet's agreed state —
    the caller falls back to the checkpoint-rollback rung. ``intervals``
    carries the RedistributionError counterexample when the failure is a
    coverage gap."""

    def __init__(self, message: str, intervals: Optional[List] = None):
        super().__init__(message)
        self.intervals = intervals or []


@dataclasses.dataclass
class FleetSnapshot:
    """One side (old or new) of a migration: the plan's placement facts.

    ``stage_worker``: stage index -> task_index.
    ``placement``: task_index -> set of global param indices held.
    ``owner``: global param index -> owning task_index.
    ``addresses``: task_index -> dialable address.
    """

    stage_worker: List[int]
    placement: Dict[int, Set[int]]
    owner: Dict[int, int]
    addresses: Dict[int, str]


def stage_param_consumers(prog) -> Dict[int, Set[int]]:
    """gi -> set of consuming STAGES (fleet-shape independent; the
    per-worker consumer map is this composed with a stage_worker map)."""
    batch_set = set(prog.batch_flat_indices)
    cons: Dict[int, Set[int]] = {}
    for s in range(prog.num_stages):
        mod = prog.stages[s]
        for p in mod.param_positions():
            gi = mod.input_def_map[p][1]
            if gi not in batch_set:
                cons.setdefault(gi, set()).add(s)
    return cons


def placement_for(stage_worker: Sequence[int],
                  stage_consumers: Dict[int, Set[int]],
                  n_params: int, worker0: int
                  ) -> Tuple[Dict[int, Set[int]], Dict[int, int]]:
    """(placement, owner) for a stage->worker map — the same rule as
    ``DistributedPipelineSession._assign_owners`` (owner = min consuming
    worker; unconsumed params land on worker0)."""
    placement: Dict[int, Set[int]] = {}
    owner: Dict[int, int] = {}
    for gi in range(n_params):
        stages = stage_consumers.get(gi)
        workers = ({stage_worker[s] for s in stages} if stages
                   else {worker0})
        owner[gi] = min(workers)
        for ti in workers:
            placement.setdefault(ti, set()).add(gi)
    return placement, owner


def probe_dirty(clients: Dict[int, Any], step: int, dead: Set[int]
                ) -> Tuple[Set[int], Set[int], Set[int]]:
    """Ping every survivor and read ``wp_completed``: workers that
    already committed the fenced ``step`` locally are DIRTY (ahead of
    the fleet). Returns (dirty, unreachable, ckpt_steps) — an
    unreachable survivor is treated as dead by the planner, and
    ``ckpt_steps`` is the union of checkpoint steps the survivors see in
    THEIR shared checkpoint dir (the master's filesystem may not)."""
    dirty: Set[int] = set()
    unreachable: Set[int] = set()
    ckpt_steps: Set[int] = set()
    for ti, client in clients.items():
        if ti in dead:
            continue
        try:
            hdr = client.ping(want_ckpt_steps=True)
        except Exception:  # noqa: BLE001 — died between fence and probe
            unreachable.add(ti)
            continue
        if step in hdr.get("wp_completed", ()):
            dirty.add(ti)
        ckpt_steps.update(int(s) for s in hdr.get("ckpt_steps", ()))
    return dirty, unreachable, ckpt_steps


def plan_moves(old: FleetSnapshot, new: FleetSnapshot,
               templates: Sequence[Tuple[Sequence[int], str]],
               dirty: Set[int], dead: Set[int],
               step: int, ckpt_step: int,
               wire_dtype: Optional[str] = None
               ) -> Tuple[Dict[int, List[dict]], Dict[int, List[int]]]:
    """Compute (moves, carry_stages).

    ``moves``: destination task_index -> AdoptShard move list (see
    rpc/server.py AdoptShard for the schema). ``carry_stages``:
    destination task_index -> stage indices whose optimizer slots the
    DispatchPlan carry_state flag preserves locally (kept or adopted —
    either way present on the worker when the new plan installs).

    ``templates``: per-gi (global_shape, dtype_name). ``step``: the
    fenced step index (== committed step count); at step 0 no optimizer
    state exists anywhere and lazy opt_init is the correct adoption.
    ``ckpt_step``: checkpoint step available at EXACTLY the fenced step,
    or -1 (older checkpoints cannot rebase a dirty worker — mixing steps
    would corrupt the trajectory).
    """
    from tepdist_tpu_torch.parallel.redistribution import (
        RedistributionError,
        plan_redistribution,
    )

    moves: Dict[int, List[dict]] = {}
    carry: Dict[int, List[int]] = {}

    def clean_live(ti: int) -> bool:
        return ti not in dead and ti not in dirty

    def ckpt_source_worker(gi: int, dst: int) -> int:
        # Prefer the destination's OWN shard file (a dirty survivor
        # rebasing itself), then the old owner's, then any old holder's —
        # every old holder of gi wrote it at the autosave.
        if gi in old.placement.get(dst, ()):
            return dst
        ow = old.owner.get(gi)
        if ow is not None and gi in old.placement.get(ow, ()):
            return ow
        holders = [t for t, gis in old.placement.items() if gi in gis]
        if not holders:
            raise MigrationInfeasible(
                f"var {gi} was held by no worker in the old plan")
        return min(holders)

    # -- variables -----------------------------------------------------
    for gi, (shape, dtype) in enumerate(templates):
        full = tuple((0, int(d)) for d in shape)
        live_srcs = sorted(
            t for t, gis in old.placement.items()
            if gi in gis and clean_live(t))
        for ti in sorted(t for t, gis in new.placement.items()
                         if gi in gis):
            if gi in old.placement.get(ti, ()) and clean_live(ti):
                continue    # already holds the agreed value
            try:
                pieces = plan_redistribution(
                    [full for _ in live_srcs], [full])[0]
                sources = [{"addr": old.addresses[live_srcs[i]],
                            "bounds": [list(b) for b in bounds]}
                           for i, bounds in pieces]
            except RedistributionError as e:
                # No live clean source covers the shard: the typed
                # error's uncovered intervals become checkpoint reads.
                if ckpt_step < 0:
                    raise MigrationInfeasible(
                        f"var {gi}: no live clean source and no "
                        f"checkpoint at the fenced step {step}",
                        intervals=e.intervals) from e
                src_w = ckpt_source_worker(gi, ti)
                sources = [{"ckpt_step": int(ckpt_step),
                            "worker_id": int(src_w),
                            "bounds": [list(b) for b in iv]}
                           for iv in e.intervals]
            moves.setdefault(ti, []).append({
                "kind": "var", "global_idx": int(gi),
                "dst_bounds": [list(b) for b in full],
                "dtype": str(dtype), "wire_dtype": wire_dtype,
                "sources": sources})

    # -- optimizer state (per stage) -----------------------------------
    if len(new.stage_worker) != len(old.stage_worker):
        raise MigrationInfeasible(
            "stage count changed across the migration "
            f"({len(old.stage_worker)} -> {len(new.stage_worker)}); "
            "per-stage optimizer state cannot be re-keyed")
    for s, dst in enumerate(new.stage_worker):
        src = old.stage_worker[s]
        if step == 0:
            continue    # nothing committed yet: lazy opt_init is agreed
        if src == dst and clean_live(dst):
            carry.setdefault(dst, []).append(s)
            continue
        if clean_live(src):
            moves.setdefault(dst, []).append({
                "kind": "opt", "stage": int(s), "src_stage": int(s),
                "addr": old.addresses[src], "wire_dtype": wire_dtype})
        elif ckpt_step >= 0:
            moves.setdefault(dst, []).append({
                "kind": "opt", "stage": int(s), "src_stage": int(s),
                "ckpt_step": int(ckpt_step), "worker_id": int(src)})
        else:
            raise MigrationInfeasible(
                f"stage {s} optimizer state unreachable: old owner "
                f"{src} is dead or dirty and no checkpoint exists at "
                f"the fenced step {step}")
        carry.setdefault(dst, []).append(s)
    return moves, carry


def summarize(moves: Dict[int, List[dict]]) -> Dict[str, int]:
    """Move-plan shape for logs/alerts: counts by kind and source type."""
    out = {"var": 0, "opt": 0, "live_sources": 0, "ckpt_sources": 0}
    for mvs in moves.values():
        for mv in mvs:
            out[mv["kind"]] += 1
            srcs = mv.get("sources") or [mv]
            for srcd in srcs:
                if srcd.get("addr"):
                    out["live_sources"] += 1
                else:
                    out["ckpt_sources"] += 1
    return out
