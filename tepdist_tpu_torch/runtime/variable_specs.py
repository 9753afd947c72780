"""Per-variable device/slice maps.

Reference parity: ``VariableSpecsMgr``/``VariableSpec`` (reference:
pjrt/variable_specs.{h,cc}): derives, per trainable variable, its
global-device -> local-slice-offset map (from Input/Recv task port maps in
the reference; from the planned TensorStrategy here). Consumed by the
distributed checkpoint (each worker writes only its local slices) and by
FetchResourceVars assembly."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tepdist_tpu_torch.core.dist_spec import TensorStrategy
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.runtime.slice_utils import (
    shard_shape,
    slice_start_offsets,
)


@dataclasses.dataclass
class VariableSpec:
    global_idx: int
    full_shape: Tuple[int, ...]
    dtype: str
    strategy: TensorStrategy
    # device id -> ((start, size), ...) per dim
    start_offset_pairs_map: Dict[int, Tuple[Tuple[int, int], ...]] = (
        dataclasses.field(default_factory=dict))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return shard_shape(self.full_shape, self.strategy)


class VariableSpecsMgr:
    def __init__(self, topology: MeshTopology):
        self.topology = topology
        self.specs: Dict[int, VariableSpec] = {}

    def derive(self, global_idx: int, full_shape: Sequence[int], dtype,
               strategy: TensorStrategy) -> VariableSpec:
        spec = VariableSpec(
            global_idx=global_idx,
            full_shape=tuple(full_shape),
            dtype=str(np.dtype(dtype) if not isinstance(dtype, str) else dtype),
            strategy=strategy,
        )
        for dev in range(self.topology.num_devices):
            spec.start_offset_pairs_map[dev] = slice_start_offsets(
                full_shape, strategy, self.topology, dev)
        self.specs[global_idx] = spec
        return spec

    def devices_holding(self, global_idx: int) -> List[int]:
        spec = self.specs[global_idx]
        # Replicated dims mean several devices hold identical slices; all of
        # them "hold" the variable. Unique slices: group by offsets.
        return sorted(spec.start_offset_pairs_map)

    def unique_slice_devices(self, global_idx: int) -> List[int]:
        """One representative device per distinct slice (who writes it at
        checkpoint time)."""
        spec = self.specs[global_idx]
        seen = {}
        for dev, offs in sorted(spec.start_offset_pairs_map.items()):
            seen.setdefault(offs, dev)
        return sorted(seen.values())
