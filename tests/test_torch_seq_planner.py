"""The port's sequence axis in the planner (``parallel/attention_motif``,
``exploration.seq_candidates``) held against the JAX package's, device-free:
both packages detect motifs in a graph captured on abstract or fake values
from the same numpy weights and price on the ``cpu`` chip entry.

What is held to what:

- Motifs (GPT-2 ``test``, einsum and flash): the reference's count and, per
  motif, ``causal``, ``scale``, the sequence length, the head count and the
  sequence dim; the forward graph has L closed motifs, the grad graph none
  unless ``allow_escape``. The rejections of the reference's detector:
  additive and windowed masks (a division by sqrt(d) folds into the
  scale).
- Pricing: ``ring_comm_cost``, ``ulysses_comm_cost`` and ``best_seq_comm``
  equal to the reference's (rel 1e-12: the same formulas on the same
  shapes) on the cases of the reference's
  ``test_seq_impl_choice_ring_vs_ulysses``.
- ``seq_candidates``: the same topologies, the same ring/Ulysses choice
  and comm seconds, and the step seconds within 15% (the Evaluator's
  parity bound in ``tests/test_torch_spmd.py``: the graphs differ in op
  granularity); at the reference's long-context case both explorers pick
  the same mesh, one with a ``seq`` axis.
- The rewritten forward loss (ring and forced Ulysses, einsum and flash)
  equals the dense loss at the reference's rtol 2e-5, and the JAX
  package's rewritten loss on the same weights.
"""

import dataclasses
import importlib
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tepdist_tpu.core.service_env import ServiceEnv as JEnv
from tepdist_tpu.graph.jaxpr_graph import trace_graph as jax_trace_graph
from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv as TEnv
from tepdist_tpu_torch.graph.fx_graph import trace_graph, var_shape
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.parallel import attention_motif as tam
from tepdist_tpu_torch.parallel import exploration as texp
from tepdist_tpu_torch.parallel.auto_parallel import plan_axes
from tepdist_tpu_torch.parallel.spmd_transform import SpmdTransform
from tepdist_tpu_torch.train import value_and_grad

# The JAX package's parallel/__init__ exports functions named like its
# modules.
jam = importlib.import_module("tepdist_tpu.parallel.attention_motif")
jexp = importlib.import_module("tepdist_tpu.parallel.exploration")

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_chip():
    knobs = {"TPU_GENERATION": "cpu", "ILP_TIME_LIMIT": "2"}
    JEnv.reset(knobs)
    TEnv.reset(knobs)
    yield
    JEnv.reset()
    TEnv.reset()


def _gpt2(attn="einsum", batch=2, T=32, **over):
    """(JAX cfg, port cfg, JAX params, port params, JAX tokens, port
    tokens): the port runs on the JAX init's weights."""
    cj = dataclasses.replace(jgpt2.CONFIGS["test"], attn=attn, **over)
    ct = dataclasses.replace(tgpt2.CONFIGS["test"], attn=attn, **over)
    params = jax.device_get(jgpt2.init_params(cj, jax.random.PRNGKey(0)))
    toks = np.asarray(jgpt2.fake_batch(cj, batch, T))
    return (cj, ct, params, convert.to_torch(params, device="cpu"), toks,
            torch.tensor(toks).long())


def _graphs(attn, grad=False, **kw):
    cj, ct, jp, tp, jt, tt = _gpt2(attn, **kw)
    jl = lambda p, t: jgpt2.loss_fn(p, t, cj)  # noqa: E731
    tl = lambda p, t: tgpt2.loss_fn(p, t, ct)  # noqa: E731
    if grad:
        jl, tl = jax.value_and_grad(jl), value_and_grad(tl)
    return jax_trace_graph(jl, jp, jt)[0], trace_graph(tl, tp, tt)[0]


def _key(m, flash):
    return (m.causal, round(m.scale, 7), m.seq_len, m.n_head, m.seq_dim,
            m.flash == flash)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_motifs_match_the_reference(attn):
    n_layer = jgpt2.CONFIGS["test"].n_layer
    jg, tg = _graphs(attn)
    jm, tm = jam.detect_motifs(jg), tam.detect_motifs(tg)
    assert len(tm) == len(jm) == n_layer
    flash = attn == "flash"
    assert [_key(m, flash) for m in tm] == [_key(m, flash) for m in jm]
    assert all(m.causal for m in tm)
    np.testing.assert_allclose(tm[0].scale, 1 / math.sqrt(16), rtol=1e-6)
    # Grad graph: the forward motifs escape into the backward, visible
    # only in pricing mode.
    jgg, tgg = _graphs(attn, grad=True)
    assert tam.detect_motifs(tgg) == [] == jam.detect_motifs(jgg)
    assert (len(tam.detect_motifs(tgg, allow_escape=True))
            == len(jam.detect_motifs(jgg, allow_escape=True)) == n_layer)


def _attn_div(q, k, v):
    T = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    s = torch.where(torch.tril(torch.ones(T, T, dtype=torch.bool)), s,
                    torch.full((), -1e9))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def _attn_additive(q, k, v):
    T = q.shape[2]
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    bias = (j > i).float() * (-1e9)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def _attn_window(q, k, v):
    T = q.shape[2]
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    mask = (j <= i) & (j > i - 8)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    s = torch.where(mask, s, torch.full((), -1e9))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def test_detection_handles_div_scale_and_rejects_masks():
    """The reference's ``test_detection_handles_div_scale_and_rejects_
    additive_mask`` on the port's graphs."""
    q, k, v = (torch.randn(2, 2, 32, 16) for _ in range(3))
    (m,) = tam.detect_motifs(trace_graph(_attn_div, q, k, v)[0])
    np.testing.assert_allclose(m.scale, 1 / math.sqrt(16), rtol=1e-6)
    assert m.causal and m.seq_len == 32 and m.n_head == 2
    assert tam.detect_motifs(trace_graph(_attn_additive, q, k, v)[0]) == []
    assert tam.detect_motifs(trace_graph(_attn_window, q, k, v)[0]) == []


def _motifs_for(T, H):
    jg, tg = _graphs("einsum", n_ctx=T, n_head=H, n_embd=H * 16, T=T)
    return jam.detect_motifs(jg), tam.detect_motifs(tg)


@pytest.mark.parametrize("T,H,P", [(8192, 4, 4), (256, 8, 8), (512, 4, 4),
                                   (256, 3, 4)])
def test_seq_pricing_matches_the_reference(T, H, P):
    jm, tm = _motifs_for(T, H)
    for bwd in (False, True):
        for name in ("ring_comm_cost", "ulysses_comm_cost"):
            got = getattr(tam, name)(tm, P, with_backward=bwd)
            want = getattr(jam, name)(jm, P, with_backward=bwd)
            if math.isinf(want):
                assert math.isinf(got)
            else:
                assert got == pytest.approx(want, rel=1e-12)
        impl, cost = tam.best_seq_comm(tm, P, with_backward=bwd)
        assert (impl, pytest.approx(cost, rel=1e-12)) == \
            jam.best_seq_comm(jm, P, with_backward=bwd)
    if H % P:
        assert impl == "ring" and math.isfinite(cost)


def test_seq_candidates_match_the_reference():
    jg, tg = _graphs("einsum", grad=True, T=64, n_ctx=64, batch=4)
    want = jexp.seq_candidates(jg, 8, 4)
    got = texp.seq_candidates(tg, 8, 4)
    assert ([c["topology"].device_axes() for c in got]
            == [c["topology"].device_axes() for c in want])
    assert [c["seq_impl"] for c in got] == [
        jam.best_seq_comm(jam.detect_motifs(jg, allow_escape=True),
                          dict(c["topology"].device_axes())["seq"],
                          with_backward=True)[0] for c in want]
    for a, b in zip(got, want):
        assert a["cost"].memory_feasible == b["cost"].memory_feasible
        assert a["cost"].total_duration == pytest.approx(
            b["cost"].total_duration, rel=0.15)


def test_exploration_chooses_ring_attention_at_long_context():
    """The reference's long-T small-batch GPT-2, each package on its own
    card's chip entry (the reference's default TPU entry, the port's
    ``h100``; on the ``cpu`` entry no proposal fits its 8 GB): both
    explorers pick the same topology, one with a seq axis."""
    JEnv.reset({"ILP_TIME_LIMIT": "2"})
    TEnv.reset({"ILP_TIME_LIMIT": "2"})
    cj, ct, jp, tp, jt, tt = _gpt2(n_ctx=32768, n_head=2, T=32768)
    want = jexp.explore(lambda p, t: jgpt2.loss_fn(p, t, cj), jp, jt,
                        n_devices=8, include_pipeline=False)
    got = texp.explore(lambda p, t: tgpt2.loss_fn(p, t, ct), tp, tt,
                       n_devices=8, include_pipeline=False)
    for best in (want, got):
        assert best["kind"] == "spmd"
        assert any(n == "seq" for n, _ in best["topology"].device_axes()), (
            best["topology"])
    assert (got["topology"].device_axes()
            == want["topology"].device_axes())
    assert got["excluded_kinds"] == ["pipeline"]


def test_seq_strategy_splits_attention_on_the_sequence():
    _, tg = _graphs("flash")
    (gs,) = plan_axes(tg, MeshTopology([("seq", 4)]))
    assert gs.ilp_status.startswith("seq-") and len(gs.motifs) == 2
    for m in gs.motifs:
        for v in (m.q, m.k, m.v):
            s = gs.node_out[tg.producer[v][0].id][0]
            assert (s.partition_dim, s.num_splits) == (1, 4)
    # The strategy prices the axis; its graph is lowered once rewritten.
    with pytest.raises(ValueError, match="lowered from the rewritten"):
        SpmdTransform(tg, MeshTopology([("seq", 4)])).lower([gs])
    with pytest.raises(ValueError, match="no rewritable attention motif"):
        plan_axes(_graphs("flash", grad=True)[1],
                  MeshTopology([("seq", 4)]))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_rewritten_loss_matches_dense_and_the_reference(devices, attn, impl):
    cj, ct, jp, tp, jt, tt = _gpt2(attn, n_ctx=64, T=64)
    tloss = lambda p, t: tgpt2.loss_fn(p, t, ct)  # noqa: E731
    rw, got_impl = tam.seq_rewritten_loss(tloss, 4, tp, tt, impl=impl)
    assert got_impl == impl and len(rw.motifs) == ct.n_layer
    got = float(rw(tp, tt))
    np.testing.assert_allclose(got, float(tloss(tp, tt)), rtol=2e-5)
    # The JAX package's rewrite, forced to the same algorithm.
    jloss = lambda p, t: jgpt2.loss_fn(p, t, cj)  # noqa: E731
    jg = jax_trace_graph(jloss, jp, jt)[0]
    motifs = jam.detect_motifs(jg)
    for m in motifs:
        m.impl = impl
    mesh = Mesh(np.array(devices[:4]), ("seq",))
    jrw = jam.build_ring_rewritten(jg, motifs, mesh, "seq")
    want = float(jrw(*jax.tree_util.tree_leaves(((jp, jt), {})))[0])
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_rewritten_grad_graph_holds_the_sequence_ops():
    """Differentiating the rewritten loss captures one forward and one
    reverse sequence op a layer, and no flash op."""
    _, ct, _, tp, _, tt = _gpt2("flash")
    rw, _ = tam.seq_rewritten_loss(lambda p, t: tgpt2.loss_fn(p, t, ct), 4,
                                   tp, tt)
    g = trace_graph(value_and_grad(rw), tp, tt)[0]
    assert g.count("seq_attn") == g.count("seq_attn_bwd") == ct.n_layer
    assert g.count("flash_fwd") == 0
    (gs,) = plan_axes(g, MeshTopology([("seq", 4)]))
    assert gs.ilp_status.startswith("seq-") and gs.motifs is None
    for n in tam.seq_op_nodes(g):
        q = n.invars[0]
        assert gs.node_out[g.producer[q][0].id][0].partition_dim == len(
            var_shape(q)) - 2


def test_rewritten_loss_captures_each_input_shape():
    """The rewrite captures the loss again for a new input shape (the GA
    step's micro batches), eagerly or ahead of a capture (``prepare``);
    inside a capture an unprepared shape raises."""
    _, ct, _, tp, _, tt = _gpt2("flash", batch=4)
    tloss = lambda p, t: tgpt2.loss_fn(p, t, ct)  # noqa: E731
    rw, _ = tam.seq_rewritten_loss(tloss, 4, tp, tt)
    half = tt[:2]
    np.testing.assert_allclose(float(rw(tp, half)), float(tloss(tp, half)),
                               rtol=2e-5)
    quarter = tt[:1]
    with pytest.raises(RuntimeError, match="not prepared"):
        trace_graph(rw, tp, quarter)
    rw.prepare(tp, quarter)
    g = trace_graph(value_and_grad(rw), tp, quarter)[0]
    assert g.count("seq_attn") == ct.n_layer


def test_auto_parallel_explore_materializes_a_seq_winner():
    """The library explorer at the long-context case: its seq winner is
    lowered from the loss rewritten before capture (the reference's
    ``_materialize_explored``), so the plan's graph holds the sequence ops
    on a mesh with a seq axis."""
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel_explore

    TEnv.reset({"ILP_TIME_LIMIT": "2"})
    _, ct, _, tp, _, tt = _gpt2("flash", n_ctx=32768, n_head=2, T=32768)
    plan = auto_parallel_explore(lambda p, t: tgpt2.loss_fn(p, t, ct), 8,
                                 tp, tt)
    assert dict(plan.topology.device_axes()).get("seq", 1) > 1
    assert plan.graph.count("seq_attn") == ct.n_layer
    assert plan.graph.count("flash_fwd") == 0
    # Every kind is searched (batch 2 prunes each pipeline cut: M of 4
    # and 8 do not divide it).
    assert plan.excluded_kinds == []
    assert plan.strategies[-1].ilp_status.startswith("seq-")


def test_neighbour_hop_pricing():
    """A ring hop on the ``cpu`` entry is the reference's (one link); on
    the ``h100`` entry it crosses the card's 18 NVLink links through the
    switch, as the port's collectives already do."""
    from tepdist_tpu.parallel import performance_utils as jperf
    from tepdist_tpu_torch.parallel import performance_utils as tperf

    for b in (4096.0, 1.6e7):
        assert tperf.PerfUtils.ppermute_cost(b, tperf.chip_spec("cpu")) == \
            jperf.PerfUtils.ppermute_cost(b, jperf.chip_spec("cpu"))
        h100 = tperf.chip_spec("h100")
        assert tperf.PerfUtils.ppermute_cost(b, h100) == pytest.approx(
            tperf.ALPHA_S + b / (18 * 25e9), rel=1e-12)
