"""The port's tree flattening (tepdist_tpu_torch.core.tree) against
``jax.tree_util`` on trees that hold ``None`` (an empty subtree, as Wide
ResNet's ``shortcut: None``), nested tuples and lists, and NamedTuples
(optax states). Leaves must come out in the same order, so that a flat
index names the same leaf in both packages. Exact: no arithmetic."""

from typing import NamedTuple

import jax
import optax
import pytest
import torch

from tepdist_tpu_torch.core.tree import (tree_leaves, tree_map,
                                         tree_structure, tree_unflatten)

torch.set_num_threads(2)


class State(NamedTuple):
    count: int
    mu: dict
    nu: dict


TREES = {
    "none_in_dict": {"b": {"conv": 1, "shortcut": None}, "a": 2},
    "none_at_top": None,
    "nested_tuples": ((1, (2, None)), [3, (4,)], {"z": 5, "y": (6, 7)}),
    "namedtuple": (State(1, {"w": 2, "b": 3}, {"w": 4, "b": 5}), (), None),
    "optax_adamw": optax.adamw(1e-3).init({"w": 1.0, "b": 2.0}),
    "optax_sgd": optax.sgd(0.1, momentum=0.9).init({"w": 1.0,
                                                    "s": None}),
    "wrn_block": {"s0b0": {"conv1": 1, "shortcut": None, "g1": 2},
                  "s1b0": {"conv1": 3, "shortcut": 4, "g1": 5}},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_leaves_match_jax(name):
    tree = TREES[name]
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_map_skips_none_and_keeps_structure(name):
    tree = TREES[name]
    got = tree_map(lambda x: x * 2, tree)
    want = jax.tree_util.tree_map(lambda x: x * 2, tree)
    assert tree_leaves(got) == jax.tree_util.tree_leaves(want)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))


def test_unflatten_round_trip():
    tree = TREES["namedtuple"]
    leaves = tree_leaves(tree)
    back = tree_unflatten(tree_structure(tree), [x + 10 for x in leaves])
    assert isinstance(back[0], State)
    assert back[0].mu == {"b": 13, "w": 12} and back[2] is None
    with pytest.raises(ValueError, match="leaves"):
        tree_unflatten(tree, leaves[:-1])
