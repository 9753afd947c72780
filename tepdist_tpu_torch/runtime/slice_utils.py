"""Host-side N-d slice math for sharded tensors.

Reference parity: ``SliceUtils`` (reference: pjrt/slice_utils.{h,cc}:
``GetSliceStartOffsetOnSrc``, ``SliceCopyOnHost`` driven by DistSpec) used
for scatter/gather of shards and checkpoint slice maps. The port keeps
the pure offset math (variable specs, multi-host checkpoints) and leaves
the device scatter/gather to DTensor placements (the JAX package's
``runtime/slice_utils.py``, the same numpy)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from tepdist_tpu_torch.core.dist_spec import TensorStrategy
from tepdist_tpu_torch.core.mesh import MeshTopology


def shard_shape(full_shape: Sequence[int], ts: TensorStrategy
                ) -> Tuple[int, ...]:
    shape = list(full_shape)
    for _axis, s in ts.strategies.items():
        if s.is_split():
            if shape[s.partition_dim] % s.num_splits:
                raise ValueError(
                    f"dim {s.partition_dim} size {shape[s.partition_dim]} "
                    f"not divisible by {s.num_splits}")
            shape[s.partition_dim] //= s.num_splits
    return tuple(shape)


def slice_start_offsets(full_shape: Sequence[int], ts: TensorStrategy,
                        topology: MeshTopology, device_id: int
                        ) -> Tuple[Tuple[int, int], ...]:
    """(start, size) per dim of the slice held by ``device_id``
    (reference GetSliceStartOffsetOnSrc)."""
    sid = topology.split_id_for_device(device_id)
    starts = [0] * len(full_shape)
    sizes = list(shard_shape(full_shape, ts))
    for axis, s in ts.strategies.items():
        if not s.is_split():
            continue
        coord = sid.coord(topology.ordinal_of(axis))
        starts[s.partition_dim] += coord * sizes[s.partition_dim]
    return tuple(zip(starts, sizes))


def slice_copy_on_host(src: np.ndarray, ts: TensorStrategy,
                       topology: MeshTopology, device_id: int) -> np.ndarray:
    """Extract one device's slice of a full host tensor."""
    offs = slice_start_offsets(src.shape, ts, topology, device_id)
    index = tuple(slice(st, st + sz) for st, sz in offs)
    return np.ascontiguousarray(src[index])


def assemble_from_slices(full_shape: Sequence[int],
                         ts: TensorStrategy, topology: MeshTopology,
                         shards: Dict[int, np.ndarray]) -> np.ndarray:
    """Inverse of slice_copy_on_host: scatter device slices into the full
    tensor (checkpoint merge — reference MergeShardedTempFiles role)."""
    out = np.zeros(full_shape, dtype=next(iter(shards.values())).dtype)
    for dev, shard in shards.items():
        offs = slice_start_offsets(full_shape, ts, topology, dev)
        index = tuple(slice(st, st + sz) for st, sz in offs)
        out[index] = shard
    return out
