"""Lowering-time sharding diagnostics: surface what no pre-lowering cost
model can see.

The port of ``tepdist_tpu/parallel/lowering_check.py``. The reference
counts XLA's "Involuntary full rematerialization" warnings from an AOT
compile: places where the composed shardings force the partitioner to
replicate a value and partition it again, work the cost model did not
price. The port has no XLA. Its counterpart of that event is DTensor
all-gathering an operand that the plan keeps split, because the op that
consumes it has no sharding strategy for the planned placements:
:func:`involuntary_remats` runs one lowered step under
``torch.distributed.tensor.debug.CommDebugMode`` and lists the graph nodes
at which that happened. The resharding the plan placed itself (the
constraints at cone roots, the outputs brought to their placements) is
not counted.
"""

from __future__ import annotations

import logging
from typing import Any, List

log = logging.getLogger(__name__)


def involuntary_remats(step, args: List[Any]) -> List[str]:
    """Run the lowered ``step`` (a ``spmd_transform.SpmdExecutable``) once
    on the flat ``args`` and return the names of the graph nodes whose op
    made DTensor all-gather a split operand — [] for a plan whose
    resharding is all placed by the plan. The graph is functional, so
    nothing the caller holds is updated; the outputs are dropped."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm:
        step.run(list(args), comm_mode=comm)
    hits = list(step.last_remats)
    if hits:
        log.warning(
            "lowering all-gathered split operands at %d op(s) (%s): the "
            "plan's placements have no sharding strategy there, so DTensor "
            "replicates and re-partitions every step — consider different "
            "annotations or a different explore candidate", len(hits),
            ", ".join(sorted(set(hits))[:5]))
    return hits
