"""Memory-efficient array redistribution across plan/mesh changes.

Reference: memory-efficient array redistribution (arXiv:2112.01075) —
resharding an N-d array from a source shard layout to a destination
layout needs only the pairwise slice intersections, never a full
materialization; peak memory is one destination shard plus one source
shard. Used by the checkpoint cross-mesh restore path
(``CheckpointUtil.restore_resharded``) so a plan explored on one mesh —
including a compressed-collective winner — restores correctly onto
another, and by the planner to price the reshard itself.

A shard layout is a list of ``bounds``: per-dimension ``(start, stop)``
tuples over the global shape. NamedSharding shard extents (what the
checkpoint writer records per shard) are exactly this form.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Bounds = Tuple[Tuple[int, int], ...]


class RedistributionError(ValueError):
    """A destination shard cannot be filled from the source layout.

    ``kind`` names the failure (currently ``"coverage"``); ``intervals``
    is the counterexample — the uncovered destination sub-rectangles, each
    a ``Bounds`` in global coordinates. Mirrors the
    ``PlanVerificationError`` convention: typed, machine-readable, and
    carrying the minimal witness a caller (or a fallback path such as the
    live-migration checkpoint rung) needs to act on.
    """

    def __init__(self, kind: str, intervals: List[Bounds], message: str):
        super().__init__(message)
        self.kind = kind
        self.intervals = intervals


def _subtract(region: Bounds, hole: Bounds) -> List[Bounds]:
    """Rectangle subtraction: ``region`` minus ``hole`` as disjoint
    boxes. ``hole`` must already be clipped to ``region`` (as overlap()
    outputs are); empty result means the hole covers the region."""
    out: List[Bounds] = []
    rest = list(region)
    for dim, ((r0, r1), (h0, h1)) in enumerate(zip(region, hole)):
        if h0 > r0:
            out.append(tuple(rest[:dim]) + ((r0, h0),) + region[dim + 1:])
        if h1 < r1:
            out.append(tuple(rest[:dim]) + ((h1, r1),) + region[dim + 1:])
        rest[dim] = (h0, h1)
    return out


def uncovered_intervals(
    dst: Bounds, pieces: Sequence[Bounds]
) -> List[Bounds]:
    """The parts of ``dst`` not covered by any piece, as disjoint boxes."""
    holes: List[Bounds] = [dst]
    for p in pieces:
        nxt: List[Bounds] = []
        for h in holes:
            inter = overlap(h, p)
            if inter is None:
                nxt.append(h)
            else:
                nxt.extend(_subtract(h, inter))
        holes = nxt
        if not holes:
            break
    return holes


def _size(b: Bounds) -> int:
    n = 1
    for a, z in b:
        n *= max(z - a, 0)
    return n


def overlap(a: Bounds, b: Bounds) -> Optional[Bounds]:
    """Per-dimension intersection of two extents; None when empty."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def plan_redistribution(
    src: Sequence[Bounds], dst: Sequence[Bounds]
) -> List[List[Tuple[int, Bounds]]]:
    """Per destination shard, the source slices that fill it:
    ``plan[j] = [(src_index, intersection_bounds), ...]``. Raises when a
    destination shard is not fully covered by the source layout (deduped
    by extent — replicated source shards contribute once)."""
    plan: List[List[Tuple[int, Bounds]]] = []
    for d in dst:
        pieces: List[Tuple[int, Bounds]] = []
        seen: set = set()
        covered = 0
        for i, s in enumerate(src):
            inter = overlap(s, d)
            if inter is None or inter in seen:
                continue
            seen.add(inter)
            pieces.append((i, inter))
            covered += _size(inter)
        if covered != _size(d):
            missing = uncovered_intervals(d, [b for _i, b in pieces])
            raise RedistributionError(
                "coverage", missing,
                f"redistribution coverage incomplete for dst {d}: "
                f"{covered}/{_size(d)} elements from {len(src)} source "
                f"shards; uncovered intervals: {missing}")
        plan.append(pieces)
    return plan


def redistribution_cost(
    src: Sequence[Bounds], dst: Sequence[Bounds], elem_bytes: int,
    spec=None, over_dcn: bool = True,
) -> Dict[str, float]:
    """Analytic cost of resharding src -> dst (arXiv:2112.01075 §3: the
    cost is the moved intersection bytes, not the global array size).

    Returns:
      moved_bytes      — bytes crossing a shard boundary (src index !=
                         dst index, the hops a same-placement shard skips)
      transfer_s       — alpha-beta time over those hops
      peak_bytes       — one dst shard + its largest src piece (the
                         memory-efficient path's high-water mark)
      full_materialize_bytes — the naive assemble-full-array peak, for
                         the caller's either/or decision
    """
    from tepdist_tpu_torch.parallel.performance_utils import PerfUtils

    plan = plan_redistribution(src, dst)
    moved = 0
    hops = 0
    peak = 0
    for j, pieces in enumerate(plan):
        biggest = 0
        for i, inter in pieces:
            b = _size(inter) * elem_bytes
            biggest = max(biggest, b)
            if i != j:
                moved += b
                hops += 1
        peak = max(peak, _size(dst[j]) * elem_bytes + biggest)
    transfer_s = sum((PerfUtils.ppermute_cost(moved / max(hops, 1), spec,
                                              over_dcn=over_dcn),) * hops)
    global_bytes = sum(_size(d) * elem_bytes for d in dst)
    return {
        "moved_bytes": float(moved),
        "transfer_s": float(transfer_s),
        "peak_bytes": float(peak),
        "full_materialize_bytes": float(global_bytes + peak),
    }


def assemble_shard(
    dst_bounds: Bounds,
    pieces: Sequence[Tuple[int, Bounds]],
    fetch_src,
    dtype,
) -> np.ndarray:
    """Materialize ONE destination shard from its plan entry. ``fetch_src``
    is ``(src_index, rel_slices) -> np.ndarray`` returning just the
    requested slice of that source shard (the caller streams sources so
    only one is resident at a time)."""
    shape = tuple(z - a for a, z in dst_bounds)
    out = np.zeros(shape, dtype=dtype)
    for i, inter in pieces:
        dst_sl = tuple(slice(lo - a, hi - a)
                       for (lo, hi), (a, _z) in zip(inter, dst_bounds))
        out[dst_sl] = fetch_src(i, inter)
    return out
