"""Sharding annotations: the "spine" data structures of the framework.

Reference parity (see SURVEY.md §1):
  * ``DimStrategy``  ~ TePDist ``DimStrategy``
    (reference: service/parallel/hlo_strategy_spec.h:28-167) — the planner's
    view of how ONE tensor is laid out along ONE mesh axis ("split ordinal").
  * ``DistSpec`` / ``DimDistSpec`` ~ TePDist ``DistSpec``/``DimDistSpec``
    (reference: service/parallel/dist_spec.h:36-227) — the per-instruction
    annotation carried through the compilation pipeline, one entry per mesh
    axis, plus a pipeline ``stage``.
  * ``TensorStrategy`` — convenience aggregate mapping a whole mesh onto one
    tensor.

The port of ``tepdist_tpu/core/dist_spec.py``. Where the JAX package lowers
a strategy to a ``jax.sharding.PartitionSpec`` for GSPMD, the port lowers it
to DTensor placements, one per mesh axis (``Shard(dim)``, ``Replicate()``,
``Partial()``), which need no process group to construct. Unlike a
PartitionSpec, a placement list can say that a value is a partial sum.

Sharding is described logically: (tensor dim, mesh axis) pairs, not
strides over a linearized buffer. What must be preserved is the *semantic*
content: which dim is split, how many ways, and whether the value is a
partial sum awaiting an all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


# Sentinel partition dims (match the reference's conventions where -1 means
# "replicated"; partial-ness is a separate flag, as in hlo_strategy_spec.h).
REPLICATED = -1


@dataclasses.dataclass(frozen=True)
class DimStrategy:
    """How one tensor relates to ONE mesh axis.

    Attributes:
      partition_dim: tensor dimension split along this mesh axis, or
        ``REPLICATED`` (-1) if the tensor is not split along this axis.
      num_splits: size of the mesh axis (1 == trivially replicated).
      partial: the per-shard values are partial sums over this axis; a
        ``psum`` is required to materialize the true value (TePDist
        ``IsPartial()``; produced e.g. by a dot whose contraction dim is
        split).
      replicated: explicitly pinned replicated by the user/planner (TePDist
        ``replicated()``), as opposed to merely undetermined.
    """

    partition_dim: int = REPLICATED
    num_splits: int = 1
    partial: bool = False
    replicated: bool = False

    def is_glue(self) -> bool:
        """Undetermined placeholder (TePDist ``Glue()``): nothing decided."""
        return (
            self.partition_dim == REPLICATED
            and not self.partial
            and not self.replicated
        )

    def is_split(self) -> bool:
        return self.partition_dim >= 0 and self.num_splits > 1

    @classmethod
    def glue(cls) -> "DimStrategy":
        return cls()

    @classmethod
    def make_replicated(cls, num_splits: int = 1) -> "DimStrategy":
        return cls(num_splits=num_splits, replicated=True)

    @classmethod
    def make_partial(cls, num_splits: int) -> "DimStrategy":
        return cls(num_splits=num_splits, partial=True)

    @classmethod
    def split_on(cls, dim: int, num_splits: int) -> "DimStrategy":
        if dim < 0:
            raise ValueError(f"partition dim must be >= 0, got {dim}")
        return cls(partition_dim=dim, num_splits=num_splits)

    def __str__(self) -> str:
        if self.partial:
            return f"P(partial,{self.num_splits})"
        if self.is_split():
            return f"S(dim={self.partition_dim},{self.num_splits})"
        if self.replicated:
            return "R"
        return "G"  # glue


@dataclasses.dataclass(frozen=True)
class DimDistSpec:
    """Serializable per-mesh-axis slice of a ``DistSpec``.

    Mirrors reference dist_spec.h:36-128 minus stride bookkeeping (layout
    is the tensor library's concern); ``partition_dim``/``num_splits``/
    ``partial`` carry the semantic payload.
    """

    partition_dim: int = REPLICATED
    num_splits: int = 1
    partial: bool = False

    @classmethod
    def from_strategy(cls, s: DimStrategy) -> "DimDistSpec":
        return cls(
            partition_dim=s.partition_dim if s.is_split() else REPLICATED,
            num_splits=s.num_splits,
            partial=s.partial,
        )

    def to_strategy(self) -> DimStrategy:
        if self.partial:
            return DimStrategy.make_partial(self.num_splits)
        if self.partition_dim >= 0 and self.num_splits > 1:
            return DimStrategy.split_on(self.partition_dim, self.num_splits)
        return DimStrategy.make_replicated(self.num_splits)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DimDistSpec":
        return cls(**d)


@dataclasses.dataclass
class DistSpec:
    """Full distribution annotation of one tensor: one ``DimDistSpec`` per
    mesh axis (split ordinal), plus the pipeline ``stage`` the producing
    computation was assigned to (reference dist_spec.h:130-227).
    """

    dims: List[DimDistSpec] = dataclasses.field(default_factory=list)
    stage: int = -1

    def num_ordinals(self) -> int:
        return len(self.dims)

    def get(self, ordinal: int) -> DimDistSpec:
        return self.dims[ordinal]

    def is_replicated(self) -> bool:
        return all(d.partition_dim == REPLICATED and not d.partial for d in self.dims)

    def has_partial(self) -> bool:
        return any(d.partial for d in self.dims)

    def to_dict(self) -> dict:
        return {"dims": [d.to_dict() for d in self.dims], "stage": self.stage}

    @classmethod
    def from_dict(cls, d: dict) -> "DistSpec":
        return cls(
            dims=[DimDistSpec.from_dict(x) for x in d.get("dims", [])],
            stage=d.get("stage", -1),
        )

    def placements(self, ndim: int) -> Tuple:
        """Lower to DTensor placements, one per ordinal in order (the
        counterpart of the JAX package's ``partition_spec``): ``Shard(d)``
        for a split, ``Partial()`` for a partial sum, else
        ``Replicate()``."""
        return tuple(_placement(d.partition_dim, d.num_splits, d.partial,
                                ndim) for d in self.dims)


def _placement(partition_dim: int, num_splits: int, partial: bool,
               ndim: int):
    from torch.distributed.tensor import Partial, Replicate, Shard

    if partial:
        return Partial()
    if partition_dim >= 0 and num_splits > 1:
        if partition_dim >= ndim:
            raise ValueError(f"partition dim {partition_dim} out of range "
                             f"for ndim {ndim}")
        return Shard(partition_dim)
    return Replicate()


class TensorStrategy:
    """Aggregate multi-axis strategy for one tensor: ``{axis_name:
    DimStrategy}`` over a named mesh. The working currency of the planner; a
    finished plan lowers each TensorStrategy to DTensor placements.
    """

    def __init__(self, strategies: Optional[Dict[str, DimStrategy]] = None):
        self.strategies: Dict[str, DimStrategy] = dict(strategies or {})

    def set(self, axis: str, s: DimStrategy) -> "TensorStrategy":
        self.strategies[axis] = s
        return self

    def get(self, axis: str) -> DimStrategy:
        return self.strategies.get(axis, DimStrategy.glue())

    def axes(self) -> List[str]:
        return list(self.strategies)

    def has_partial(self) -> bool:
        return any(s.partial for s in self.strategies.values())

    def partial_axes(self) -> List[str]:
        return [a for a, s in self.strategies.items() if s.partial]

    def sharded_dims(self) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for a, s in self.strategies.items():
            if s.is_split():
                out.setdefault(s.partition_dim, []).append(a)
        return out

    def placements(self, axis_order: Sequence[str], ndim: int) -> Tuple:
        """DTensor placements over a mesh whose axes are ``axis_order``
        (the counterpart of the JAX package's ``partition_spec``)."""
        return tuple(_placement(s.partition_dim, s.num_splits, s.partial,
                                ndim)
                     for s in (self.get(a) for a in axis_order))

    def to_dist_spec(self, axis_order: Sequence[str], stage: int = -1) -> DistSpec:
        return DistSpec(
            dims=[DimDistSpec.from_strategy(self.get(a)) for a in axis_order],
            stage=stage,
        )

    def copy(self) -> "TensorStrategy":
        return TensorStrategy(dict(self.strategies))

    def key(self) -> Tuple:
        """Hashable identity used by the planner's memo/ILP tables."""
        return tuple(
            sorted(
                (a, s.partition_dim, s.num_splits, s.partial, s.replicated)
                for a, s in self.strategies.items()
            )
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, TensorStrategy) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __str__(self) -> str:
        inner = ",".join(f"{a}:{s}" for a, s in sorted(self.strategies.items()))
        return f"TS[{inner}]"

    __repr__ = __str__
