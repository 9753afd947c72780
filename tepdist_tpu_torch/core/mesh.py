"""Device-mesh addressing: the CommDevManager / SplitId of the reference.

Reference parity: TePDist addresses a device by an N-dim ``SplitId`` over
``split_nums`` (e.g. [micro, stage, spmd]) with ``share_dev_flags`` marking
ordinals that reuse devices (micro-batches), ``stage_split_ordinal`` marking
the pipeline ordinal, and ``placement_layout`` permuting ordinals onto linear
device ids; per-ordinal ``DevGroupArray``s become NCCL communicator groups
(reference: pjrt/dev_id_util.h:94-331).

The port of ``tepdist_tpu/core/mesh.py``: the host logic, copied. The
device-consuming ordinals are the named axes of the device mesh, and
``dev_groups`` gives the participants of a collective over one axis (a
process group's ranks). Shared ("virtual") ordinals such as micro-batching
have no devices — they index time (the GA loop), exactly like TePDist's
``share_dev_flags=true`` ordinals. ``MeshTopology.to_device_mesh`` lowers
the device axes to a ``torch.distributed`` device mesh (the JAX package's
``to_jax_mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

# Canonical axis names used across the framework.
AXIS_DATA = "data"
AXIS_STAGE = "stage"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"


@dataclasses.dataclass(frozen=True)
class SplitId:
    """N-dim address of one execution instance (reference dev_id_util.h:94-140).

    ``ids[i]`` is the coordinate along ordinal ``i`` of ``topology.split_nums``
    (including shared/time ordinals such as micro-batch)."""

    ids: Tuple[int, ...]

    def coord(self, ordinal: int) -> int:
        return self.ids[ordinal]

    def replace(self, ordinal: int, value: int) -> "SplitId":
        ids = list(self.ids)
        ids[ordinal] = value
        return SplitId(tuple(ids))

    def __str__(self) -> str:
        return f"SplitId{self.ids}"


class MeshTopology:
    """Named, ordered split ordinals over a linear device id space.

    Args:
      axes: ordered ``(name, size)`` pairs, outermost first.
      share_dev_flags: per-ordinal; True means the ordinal indexes *time*
        (micro-batches) and consumes no devices.
      stage_split_ordinal: index (into ``axes``) of the pipeline-stage
        ordinal, or -1.
      placement_layout: permutation of the *device-consuming* ordinals giving
        their order from slowest- to fastest-varying in the linear device id
        space; defaults to declaration order. Put the heaviest-traffic
        axis (usually the tensor/model axis) last, so that it spans
        neighbouring devices.
    """

    def __init__(
        self,
        axes: Sequence[Tuple[str, int]],
        share_dev_flags: Optional[Sequence[bool]] = None,
        stage_split_ordinal: int = -1,
        placement_layout: Optional[Sequence[int]] = None,
    ):
        self.axis_names: List[str] = [a for a, _ in axes]
        self.split_nums: List[int] = [int(n) for _, n in axes]
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names: {self.axis_names}")
        self.share_dev_flags: List[bool] = (
            list(share_dev_flags) if share_dev_flags is not None
            else [False] * len(self.split_nums)
        )
        if len(self.share_dev_flags) != len(self.split_nums):
            raise ValueError("share_dev_flags length mismatch")
        self.stage_split_ordinal = stage_split_ordinal
        self._dev_ordinals = [
            i for i, shared in enumerate(self.share_dev_flags) if not shared
        ]
        if placement_layout is None:
            placement_layout = list(self._dev_ordinals)
        else:
            placement_layout = list(placement_layout)
            if sorted(placement_layout) != sorted(self._dev_ordinals):
                raise ValueError(
                    f"placement_layout {placement_layout} must permute "
                    f"device ordinals {self._dev_ordinals}"
                )
        self.placement_layout: List[int] = placement_layout

    # -- sizes ------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return math.prod(self.split_nums[i] for i in self._dev_ordinals) if self._dev_ordinals else 1

    @property
    def num_instances(self) -> int:
        return math.prod(self.split_nums) if self.split_nums else 1

    def ordinal_of(self, name: str) -> int:
        return self.axis_names.index(name)

    def size_of(self, name: str) -> int:
        return self.split_nums[self.ordinal_of(name)]

    def device_axes(self) -> List[Tuple[str, int]]:
        return [(self.axis_names[i], self.split_nums[i]) for i in self._dev_ordinals]

    # -- addressing -------------------------------------------------------
    def device_id(self, split_id: SplitId) -> int:
        """Linear device id for an instance (shared ordinals ignored),
        honoring ``placement_layout`` (reference dev_id_util.h:222-331)."""
        dev = 0
        for ordinal in self.placement_layout:
            dev = dev * self.split_nums[ordinal] + split_id.coord(ordinal)
        return dev

    def split_id_for_device(self, device_id: int, shared_coords: Optional[Dict[int, int]] = None) -> SplitId:
        coords = [0] * len(self.split_nums)
        for ordinal in reversed(self.placement_layout):
            n = self.split_nums[ordinal]
            coords[ordinal] = device_id % n
            device_id //= n
        for k, v in (shared_coords or {}).items():
            coords[k] = v
        return SplitId(tuple(coords))

    def all_split_ids(self) -> List[SplitId]:
        out = [()]
        for n in self.split_nums:
            out = [t + (i,) for t in out for i in range(n)]
        return [SplitId(t) for t in out]

    def dev_groups(self, name: str) -> List[List[int]]:
        """Device groups along axis ``name``: every group is the set of
        device ids that differ only in that ordinal — i.e. the participants of
        a collective over that axis (reference ``DevGroupArray``)."""
        ordinal = self.ordinal_of(name)
        if self.share_dev_flags[ordinal]:
            raise ValueError(f"axis {name} is a shared (time) ordinal")
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for dev in range(self.num_devices):
            sid = self.split_id_for_device(dev)
            key = tuple(
                sid.coord(i) for i in self._dev_ordinals if i != ordinal
            )
            groups.setdefault(key, []).append(dev)
        return [sorted(g) for g in groups.values()]

    # -- lowering ---------------------------------------------------------
    def rank_grid(self) -> List:
        """The process ranks of the device mesh as a nested list over the
        device axes in declaration order: ``placement_layout`` orders them
        from slowest- to fastest-varying over the linear rank space, as
        the JAX package orders its device list."""
        import numpy as np

        n = self.num_devices
        layout_sizes = [self.split_nums[o] for o in self.placement_layout]
        grid = np.arange(n).reshape(layout_sizes or ())
        decl_pos = {o: i for i, o in enumerate(self.placement_layout)}
        perm = [decl_pos[o] for o in self._dev_ordinals]
        if layout_sizes:
            grid = np.transpose(grid, perm)
        return grid.tolist()

    def to_device_mesh(self, device_type: str = "cuda"):
        """A ``torch.distributed`` ``DeviceMesh`` over the device-consuming
        ordinals, named by ``device_axes()`` (a shared time axis such as
        ``micro`` is not a mesh dim). Needs an initialized process group
        of ``num_devices`` ranks; the reference builds a
        ``jax.sharding.Mesh`` here (``to_jax_mesh``)."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        n = self.num_devices
        if not dist.is_initialized():
            raise RuntimeError(
                "to_device_mesh needs an initialized torch.distributed "
                f"process group of {n} ranks")
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"need {n} ranks, the process group has "
                             f"{world}")
        names = tuple(name for name, _ in self.device_axes())
        if not names:
            names = ("data",)
        grid = self.rank_grid() if self._dev_ordinals else [0]
        return DeviceMesh(device_type, torch.tensor(grid, dtype=torch.int),
                          mesh_dim_names=names)

    def __str__(self) -> str:
        parts = []
        for i, (name, n) in enumerate(zip(self.axis_names, self.split_nums)):
            tag = "*" if self.share_dev_flags[i] else ""
            parts.append(f"{name}{tag}={n}")
        return f"MeshTopology({', '.join(parts)})"

    __repr__ = __str__
