"""The pipeline kind of the port's exploration (``pipeline_candidates``,
``PipelineWinner``, ``explore(include_pipeline=True)``) held to the JAX
package's, device-free.

Both sides enumerate the stage cuts S x M x intra-stage TP (blocked, with
their ``@zero`` and comm-dtype modifiers, and interleaved) and price each
with the task scheduler's simulation. On the same chip entry (``cpu``,
as ``tests/test_torch_spmd.py`` prices) they propose the same candidates,
and each cost is held within the 15% that ``tests/test_torch_seq_planner``
allows (the aten and jaxpr stage cuts need not be equal).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tepdist_tpu.core.service_env import ServiceEnv as JEnv
from tepdist_tpu.parallel import exploration as jexp
from tepdist_tpu.parallel.auto_parallel import (
    auto_parallel_explore as jax_auto_parallel_explore)
from tepdist_tpu_torch.core.service_env import ServiceEnv as TEnv
from tepdist_tpu_torch.parallel import exploration as texp
from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel_explore

torch.set_num_threads(2)

COST_RTOL = 0.15


@pytest.fixture(autouse=True)
def _reset_env():
    yield
    JEnv.reset()
    TEnv.reset()


def _deep_mlp_np(depth, width, batch):
    rng = np.random.default_rng(0)
    params = {f"w{i}": (rng.standard_normal((width, width)) * 0.05)
              .astype(np.float32) for i in range(depth)}
    x = rng.standard_normal((batch, width)).astype(np.float32)
    return params, x, np.zeros((batch, width), np.float32)


def _losses(depth):
    def jl(p, x, y):
        h = x
        for i in range(depth):
            h = jax.nn.relu(h @ p[f"w{i}"])
        return jnp.mean((h - y) ** 2)

    def tl(p, x, y):
        h = x
        for i in range(depth):
            h = torch.relu(h @ p[f"w{i}"])
        return ((h - y) ** 2).mean()

    return jl, tl


def _key(c):
    return (c["num_stages"], c["num_micro_batches"], c["intra_tp"],
            c["placement"], c.get("interleave_groups"),
            c.get("comm_dtype", ""), c.get("zero", False))


def test_pipeline_candidates_match_reference():
    """An 8-layer MLP for 8 devices: the same S x M x tp proposals with the
    same modifiers and placements, each priced within 15% of the
    reference's, with the same memory verdict."""
    JEnv.reset({"TPU_GENERATION": "cpu"})
    TEnv.reset({"TPU_GENERATION": "cpu"})
    params, x, y = _deep_mlp_np(8, 256, 16)
    jl, tl = _losses(8)
    want = jexp.pipeline_candidates(jl, params, (x, y), 8, 16, 2)
    got = texp.pipeline_candidates(
        tl, {k: torch.tensor(v) for k, v in params.items()},
        (torch.tensor(x), torch.tensor(y)), 8, 16, 2)
    w, g = {_key(c): c["cost"] for c in want}, {_key(c): c["cost"]
                                                for c in got}
    assert set(g) == set(w)
    assert {k[:3] for k in g} >= {(2, 2, 1), (2, 4, 4), (4, 2, 2),
                                  (8, 4, 1), (16, 2, 1)}
    assert any(k[3] == "interleaved" for k in g)
    assert any(k[6] for k in g)          # @zero variants
    for k, cost in g.items():
        assert cost.memory_feasible == w[k].memory_feasible, k
        assert cost.total_duration == pytest.approx(
            w[k].total_duration, rel=COST_RTOL), k


def test_stage_tp_proposed_where_a_card_is_visible(monkeypatch):
    """Stage x TP runs across NCCL cards (ROADMAP C8, resolved), so where
    the plan would run on cards the stage cuts with intra-stage TP are
    proposed as they are everywhere else: the same proposals, tp = 2 and
    tp = 4 among them, and no prune naming C8."""
    from tepdist_tpu_torch.telemetry import observatory

    TEnv.reset({"TPU_GENERATION": "cpu"})
    params, x, y = _deep_mlp_np(8, 256, 16)
    _, tl = _losses(8)
    args = (tl, {k: torch.tensor(v) for k, v in params.items()},
            (torch.tensor(x), torch.tensor(y)), 8, 16, 2)
    everywhere = {_key(c) for c in texp.pipeline_candidates(*args)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with observatory.capture("test") as col:
        on_cards = {_key(c) for c in texp.pipeline_candidates(*args)}
    assert on_cards == everywhere
    assert {k[2] for k in on_cards} >= {1, 2, 4}
    assert not [p for p in col.prunes if "C8" in p.message]


def test_deep_skinny_winner_is_a_pipeline_winner():
    """The reference's comm-dominated regime (``tests/test_exploration.py``
    :71-90: a 24-layer 16384-wide stack, a slow interconnect, no overlap,
    replication infeasible): both libraries' explorers return a
    ``PipelineWinner``, memory-feasible, having priced both kinds. Each
    prices on its own default entry; the port's ``h100`` holds the
    replicated 25.8 GB model in its 80 GB, so its budget is set to 32 GB
    (the reference's TPU v4 / v6e entries) to keep replication
    infeasible."""
    depth, width, batch = 24, 16384, 8
    jl, tl = _losses(depth)
    JEnv.reset({"ICI_BANDWIDTH": 0.05, "COMM_OVERLAP": 0.0})
    jparams = {f"w{i}": jax.ShapeDtypeStruct((width, width), jnp.float32)
               for i in range(depth)}
    jx = jax.ShapeDtypeStruct((batch, width), jnp.float32)
    want = jax_auto_parallel_explore(jl, 8, jparams, jx, jx,
                                     num_micro_batches=4)
    TEnv.reset({"ICI_BANDWIDTH": 0.05, "COMM_OVERLAP": 0.0, "HBM_GB": 32})
    tparams = {f"w{i}": torch.empty(width, width, device="meta")
               for i in range(depth)}
    tx = torch.empty(batch, width, device="meta")
    got = auto_parallel_explore(tl, 8, tparams, tx, tx, num_micro_batches=4)
    for winner in (want, got):
        assert type(winner).__name__ == "PipelineWinner", type(winner)
        assert winner.num_stages >= 2
        assert winner.cost.memory_feasible
        assert {c["kind"] for c in winner.candidates} == {"spmd",
                                                          "pipeline"}
    assert isinstance(got, texp.PipelineWinner)
    assert got.exploration_report["excluded_kinds"] == []
