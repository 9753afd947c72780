"""User sharding-annotation API (the port of the JAX package's
``client/annotations.py`` on ``core/dist_spec.DimStrategy``).

Reference parity: the ``xla_sharding`` Python API (reference:
xla/experimental/xla_sharding/xla_sharding.py:28-334):
``split(tensor, split_dimension, num_devices)``, ``replicate()``,
``tile()``. Annotations feed the planner as user pins
(``CostSpmdStrategy::ExtractUserSplit``); ``IGNORE_ANNOTATION`` drops them.

Annotations are {flat arg index -> {mesh axis: DimStrategy}} maps consumed
by ``auto_parallel``/the RPC plan options; this module builds them from
trees of tensors, each leaf named by its path as ``jax.tree_util.keystr``
spells it (``"[0]['w1']"``), in ``core/tree``'s flat order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from tepdist_tpu_torch.core.dist_spec import DimStrategy


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of ``tree``, in flat order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f, x in zip(tree._fields, tree)
                for pl in _paths(x, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in _paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


class AnnotationBuilder:
    """Collects per-leaf annotations over the example-args tree."""

    def __init__(self, *example_args):
        self._paths = _paths(example_args)
        self.annotations: Dict[int, Dict[str, DimStrategy]] = {}

    def _find(self, predicate: Callable) -> list:
        return [i for i, (key, leaf) in enumerate(self._paths)
                if predicate(key, leaf)]

    # -- reference API ------------------------------------------------
    def split(self, predicate, split_dimension: int, axis: str,
              num_devices: int) -> "AnnotationBuilder":
        """xla_sharding.split parity: pin a dim split on matching leaves.
        ``predicate(path_str, leaf) -> bool``."""
        for i in self._find(predicate):
            self.annotations.setdefault(i, {})[axis] = DimStrategy.split_on(
                split_dimension, num_devices)
        return self

    def replicate(self, predicate, axis: str,
                  num_devices: int) -> "AnnotationBuilder":
        for i in self._find(predicate):
            self.annotations.setdefault(i, {})[axis] = (
                DimStrategy.make_replicated(num_devices))
        return self

    def tile(self, predicate, assignments: Dict[str, tuple]
             ) -> "AnnotationBuilder":
        """Multi-axis tiling: {axis: (dim, num)} per matching leaf."""
        for i in self._find(predicate):
            for ax, (dim, num) in assignments.items():
                self.annotations.setdefault(i, {})[ax] = (
                    DimStrategy.split_on(dim, num))
        return self

    def build(self) -> Dict[int, Dict[str, DimStrategy]]:
        return dict(self.annotations)


def split(example_args, predicate, split_dimension, axis, num_devices):
    return AnnotationBuilder(*example_args).split(
        predicate, split_dimension, axis, num_devices).build()
