"""The port's SPMD planner, part 2 (``parallel/{cost_spmd_strategy,
fast_spmd_strategy,auto_parallel,evaluator,exploration,spmd_transform,
quantize}``) held against the JAX package, device-free: both packages
plan from a graph captured on abstract or fake values, on the same numpy
inputs, with the cost model on the same chip (the ``cpu`` entry, which
both tables hold).

Tolerances and what is held to what:

- Host logic copied from the reference (mesh proposals, transition costs,
  the quantization codec, candidate rendering): equal.
- ``plan_axes``, cost and rule mode, per graph invar: every parameter's
  strategy equal to the reference's. A batch input is equal too, or split
  on dim 0 where the reference leaves it replicated: the reference's
  elementwise rule stops at the implicit broadcasts jax 0.9 emits
  (ROADMAP C4), here the attention mask (``where`` of a [T, T] mask with
  [B, H, T, T] logits) and the labels' one-hot compare in WRN.
- Evaluator: the step seconds of the two plans within 15% of each other
  (the graphs differ in op granularity: aten views, fused softmax and
  cross-entropy), and the same winner among ``spmd_candidates``.
- GPT-2 and Llama ``test`` (``attn="einsum"``), where C4 leaves the
  reference without a batch path: the port splits the token input on dim
  0 over ``data`` and its predicted step is at or below the reference's.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.core import dist_spec as jds
from tepdist_tpu.core import mesh as jmesh
from tepdist_tpu.core.service_env import ServiceEnv as JEnv
from tepdist_tpu.graph.jaxpr_graph import trace_graph as jax_trace_graph
from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import gpt_moe as jmoe
from tepdist_tpu.models import llama as jllama
from tepdist_tpu.models import mlp as jmlp
from tepdist_tpu.models import wide_resnet as jwrn
from tepdist_tpu.parallel import quantize as jquant
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core import dist_spec as tds
from tepdist_tpu_torch.core import mesh as tmesh
from tepdist_tpu_torch.core.service_env import ServiceEnv as TEnv
from tepdist_tpu_torch.graph.fx_graph import trace_graph
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.models import gpt_moe as tmoe
from tepdist_tpu_torch.models import llama as tllama
from tepdist_tpu_torch.models import wide_resnet as twrn
from tepdist_tpu_torch.parallel import auto_parallel as tap
from tepdist_tpu_torch.parallel import cost_spmd_strategy as tcs
from tepdist_tpu_torch.parallel import evaluator as tev
from tepdist_tpu_torch.parallel import exploration as texp
from tepdist_tpu_torch.parallel import quantize as tquant
from tepdist_tpu_torch.parallel.spmd_transform import SpmdTransform
from tepdist_tpu_torch.train import value_and_grad

from test_torch_sync_free import (_attention_by_slices_jax,
                                  _attention_by_slices_torch)

# The JAX package's parallel/__init__ exports functions named like its
# modules.
jap = importlib.import_module("tepdist_tpu.parallel.auto_parallel")
jcs = importlib.import_module("tepdist_tpu.parallel.cost_spmd_strategy")
jev = importlib.import_module("tepdist_tpu.parallel.evaluator")
jexp = importlib.import_module("tepdist_tpu.parallel.exploration")

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_chip():
    """Both packages price on the ``cpu`` chip entry, and stop an ILP
    solve after 2 s."""
    knobs = {"TPU_GENERATION": "cpu", "ILP_TIME_LIMIT": "2"}
    JEnv.reset(knobs)
    TEnv.reset(knobs)
    yield
    JEnv.reset()
    TEnv.reset()


def _key(s):
    if s is None:
        return None
    return (s.partition_dim, s.num_splits, s.partial, s.replicated)


# --------------------------------------------------------------------------
# Host logic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 6, 8, 16])
def test_explore_topologies_match(n):
    got = [t.device_axes() for t in tap.explore_topologies(n)]
    want = [t.device_axes() for t in jap.explore_topologies(n)]
    assert got == want, (got, want)


def _strategy(pkg, kind, n):
    ds = pkg.DimStrategy
    return {"rep": ds.make_replicated(n), "glue": ds.glue(),
            "partial": ds.make_partial(n), "s0": ds.split_on(0, n),
            "s1": ds.split_on(1, n), None: None}[kind]


@pytest.mark.parametrize("src,dst", [
    ("partial", "partial"), ("partial", "s0"), ("partial", "rep"),
    ("s0", "s0"), ("s0", "s1"), ("s0", "partial"), ("s0", "rep"),
    ("rep", "s0"), ("glue", "s1"), (None, "s0"), ("s1", None)])
def test_transition_cost_matches(src, dst):
    for b, n in ((4096.0, 2), (3.2e7, 8), (1e9, 4)):
        got = tcs.transition_cost(_strategy(tds, src, n),
                                  _strategy(tds, dst, n), b, n)
        want = jcs.transition_cost(_strategy(jds, src, n),
                                   _strategy(jds, dst, n), b, n)
        assert got == want, (got, want)


def test_quantize_codec_matches():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    x[256:512] = 0.0
    q, s = tquant.quantize_np_int8(x)
    jq, js = jquant.quantize_np_int8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(
        tquant.dequantize_np_int8(q, s, x.shape),
        jquant.dequantize_np_int8(jq, js, x.shape))


def test_candidate_suffixes_match():
    for dt in ("", "float32", "bfloat16", "int8"):
        assert texp.comm_dtype_suffix(dt) == jexp.comm_dtype_suffix(dt)
    for z in (False, True):
        assert texp.zero_suffix(z) == jexp.zero_suffix(z)


# --------------------------------------------------------------------------
# plan_axes on the parity graphs
# --------------------------------------------------------------------------

def _np_mlp():
    rng = np.random.default_rng(0)
    params = {"w1": rng.standard_normal((64, 128), dtype=np.float32) * .1,
              "w2": rng.standard_normal((128, 32), dtype=np.float32) * .1}
    x = rng.standard_normal((256, 64), dtype=np.float32)
    return params, x, np.ones((256, 32), np.float32)


def _jax_mlp_step(params, x, y):
    """``tests/test_auto_parallel.py``'s ``_mlp``: the step is
    value_and_grad inside the planned function."""
    def loss(p, x, y):
        return jnp.mean((jax.nn.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)
    return jax.value_and_grad(loss)(params, x, y)


def _torch_mlp_loss(p, x, y):
    return ((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()


@functools.lru_cache(maxsize=None)
def _graphs(name):
    """(JAX graph, port graph, {batch invar index: batch dim})."""
    rng = np.random.default_rng(0)
    if name == "mlp":
        params, x, y = _np_mlp()
        jg = jax_trace_graph(_jax_mlp_step, params, x, y)[0]
        tg = trace_graph(value_and_grad(_torch_mlp_loss),
                         {k: torch.tensor(v) for k, v in params.items()},
                         torch.tensor(x), torch.tensor(y))[0]
        return jg, tg, {2: 0, 3: 0}
    if name == "attention":
        params = jax.device_get(jmlp.init_attention(jax.random.PRNGKey(0)))
        x = rng.standard_normal((64, 16, 64), dtype=np.float32)
        y = rng.standard_normal((64, 16, 64), dtype=np.float32)
        jg = jax_trace_graph(jax.value_and_grad(_attention_by_slices_jax),
                             params, x, y)[0]
        tg = trace_graph(value_and_grad(_attention_by_slices_torch),
                         convert.to_torch(params, device="cpu"),
                         torch.tensor(x), torch.tensor(y))[0]
        return jg, tg, {2: 0, 3: 0}
    if name == "wrn":
        # CONFIGS[0] (~250M params): the JAX side traces abstract values,
        # the port fake tensors made from zeros.
        jc, tc = jwrn.CONFIGS[0], twrn.CONFIGS[0]
        shapes = jax.eval_shape(
            lambda: jwrn.init_params(jc, jax.random.PRNGKey(0)))
        B, S = 16, 32
        jg = jax_trace_graph(
            jax.value_and_grad(lambda p, x, y: jwrn.loss_fn(p, x, y, jc)),
            shapes, jax.ShapeDtypeStruct((B, S, S, 3), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.int32))[0]
        tparams = jax.tree_util.tree_map(
            lambda s: torch.zeros(s.shape, dtype=getattr(torch,
                                                         str(s.dtype))),
            shapes)
        tg = trace_graph(
            value_and_grad(lambda p, x, y: twrn.loss_fn(p, x, y, tc)),
            tparams, torch.zeros(B, S, S, 3),
            torch.zeros(B, dtype=torch.long))[0]
        n = len(jax.tree_util.tree_leaves(shapes))
        return jg, tg, {n: 0, n + 1: 0}
    assert name == "moe"
    jc, tc = jmoe.CONFIGS["test"], tmoe.CONFIGS["test"]
    params = jax.device_get(jmoe.init_params(jc, jax.random.PRNGKey(0)))
    toks = np.asarray(jgpt2.fake_batch(jc.base, 4, 32))
    jg = jax_trace_graph(jax.value_and_grad(
        lambda p, t: jmoe.loss_fn(p, t, jc)), params, toks)[0]
    tg = trace_graph(value_and_grad(lambda p, t: tmoe.loss_fn(p, t, tc)),
                     convert.to_torch(params, device="cpu"),
                     torch.tensor(toks).long())[0]
    return jg, tg, {len(jax.tree_util.tree_leaves(params)): 0}


def _annotations(name, jg, axes, mode, batch):
    """(JAX, port) annotations: the expert weights on the expert axis
    (``tests/test_models.py:131-139``); in rule mode the batch inputs on
    the data axis, as the reference's rule-mode test annotates them."""
    if name == "moe":
        idx = [i for i, v in enumerate(jg.invars)
               if len(v.aval.shape) == 3 and v.aval.shape[0] == 4]
        assert idx
        return ({i: {"expert": jds.DimStrategy.split_on(0, 4)} for i in idx},
                {i: {"expert": tds.DimStrategy.split_on(0, 4)} for i in idx})
    if mode != "rule" or "data" not in dict(axes):
        return None, None
    n = dict(axes)["data"]
    return ({i: {"data": jds.DimStrategy.split_on(d, n)}
             for i, d in batch.items()},
            {i: {"data": tds.DimStrategy.split_on(d, n)}
             for i, d in batch.items()})


_MESHES = [[("data", 8)], [("model", 8)], [("data", 2), ("model", 4)]]
_CASES = ([(g, m, mode) for g in ("mlp", "attention", "wrn")
           for m in _MESHES for mode in ("cost", "rule")]
          + [("moe", [("expert", 4)], mode) for mode in ("cost", "rule")])


@pytest.fixture
def milp_without_wall_clock(monkeypatch):
    """Both packages' strategy modules import ``scipy.optimize.milp`` at
    call time: drop each solve's wall-clock ``time_limit`` (an optimality
    gap the caller asks for stays) and record each solve's HiGHS status.

    Under ``_cpu_chip``'s 2 s limit what a solve returns depends on the
    host's load: the reference's WRN whole-graph solve proves its optimum
    at the root node within the limit on an idle core, but on a loaded
    one the limit stops it before the root node ends, with a worse
    incumbent; the MoE solves stop at the limit even on an idle core.
    HiGHS itself is deterministic: run to the end, every solve gives the
    same plan on any host. The port's MoE solve is the longest."""
    import scipy.optimize

    real = scipy.optimize.milp
    statuses = []

    def milp(*args, options=None, **kwargs):
        opts = dict(options or {})
        opts.pop("time_limit", None)
        res = real(*args, options=opts, **kwargs)
        statuses.append(int(res.status))
        return res

    monkeypatch.setattr(scipy.optimize, "milp", milp)
    return statuses


@pytest.mark.parametrize("name,axes,mode", _CASES,
                         ids=[f"{g}-{'x'.join(f'{a}{n}' for a, n in m)}-{md}"
                              for g, m, md in _CASES])
def test_plan_axes_matches_the_reference(name, axes, mode,
                                        milp_without_wall_clock):
    jg, tg, batch = _graphs(name)
    assert len(jg.invars) == len(tg.invars)
    jann, tann = _annotations(name, jg, axes, mode, batch)
    jst = jap.plan_axes(jg, jmesh.MeshTopology(axes), jann, mode)
    tst = tap.plan_axes(tg, tmesh.MeshTopology(axes), tann, mode)
    # Every solve of both packages ran to its proven optimum (HiGHS
    # status 0), whatever the host's load.
    assert set(milp_without_wall_clock) <= {0}, milp_without_wall_clock
    assert [g.axis_name for g in tst] == [g.axis_name for g in jst]
    for jgs, tgs in zip(jst, tst):
        if mode == "rule":
            assert tgs.ilp_status == jgs.ilp_status == "rule"
        else:
            # An idle host's status: the solve's assignment, not the
            # port's greedy pass (ROADMAP C5), on both sides.
            assert tgs.ilp_status == jgs.ilp_status == "ilp"
        for i, (jv, tv) in enumerate(zip(jg.invars, tg.invars)):
            want = _key(jgs.var_strategies.get(jv))
            got = _key(tgs.var_strategies.get(tv))
            if i in batch and got != want:
                # C4: the reference's split stops at an implicit
                # broadcast; the port's reaches the batch input.
                assert want[0] == -1 and got == (batch[i], tgs.num_splits,
                                                  False, False), (i, got,
                                                                  want)
            else:
                assert got == want, (tgs.axis_name, i, got, want)


def test_evaluator_and_winner_match_on_the_mlp():
    jg, tg, _ = _graphs("mlp")
    for axes in _MESHES:
        jt, tt = jmesh.MeshTopology(axes), tmesh.MeshTopology(axes)
        jcost = jev.Evaluator(jt).run(jg, jap.plan_axes(jg, jt))
        tcost = tev.Evaluator(tt).run(tg, tap.plan_axes(tg, tt))
        assert tcost.memory_feasible == jcost.memory_feasible
        assert abs(tcost.total_duration - jcost.total_duration) <= (
            0.15 * jcost.total_duration), (axes, tcost, jcost)
    want = min(jexp.spmd_candidates(jg, 8), key=lambda c: c["cost"].key())
    got = min(texp.spmd_candidates(tg, 8), key=lambda c: c["cost"].key())
    assert got["topology"].device_axes() == want["topology"].device_axes()
    assert got.get("comm_dtype", "") == want.get("comm_dtype", "")
    assert got.get("zero", False) == want.get("zero", False)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_transformer_plan_splits_the_batch(family):
    """Batch 128 x 33 tokens on data=8: the port splits the tokens on dim
    0, and prices its plan at or below the reference's."""
    toks = np.random.default_rng(0).integers(0, 512, (128, 33)).astype(
        np.int32)
    if family == "gpt2":
        cj, ct = jgpt2.CONFIGS["test"], tgpt2.CONFIGS["test"]
        params = jax.device_get(jgpt2.init_params(cj, jax.random.PRNGKey(0)))
        jl, tl = (lambda p, t: jgpt2.loss_fn(p, t, cj),
                  lambda p, t: tgpt2.loss_fn(p, t, ct))
    else:
        cj, ct = jllama.CONFIGS["test"], tllama.CONFIGS["test"]
        params = jax.device_get(jllama.init_params(cj,
                                                   jax.random.PRNGKey(0)))
        jl, tl = (lambda p, t: jllama.loss_fn(p, t, cj),
                  lambda p, t: tllama.loss_fn(p, t, ct))
    assert getattr(ct, "attn", "einsum") == "einsum"
    jg = jax_trace_graph(jax.value_and_grad(jl), params, toks)[0]
    tg = trace_graph(value_and_grad(tl), convert.to_torch(params,
                                                          device="cpu"),
                     torch.tensor(toks).long())[0]
    jt, tt = jmesh.MeshTopology([("data", 8)]), tmesh.MeshTopology(
        [("data", 8)])
    jst, tst = jap.plan_axes(jg, jt), tap.plan_axes(tg, tt)
    assert _key(tst[0].var_strategies[tg.invars[-1]]) == (0, 8, False,
                                                           False)
    plan = SpmdTransform(tg, tt).lower(tst)
    assert str(plan.in_specs[-1]) == "(Shard(dim=0),)"
    got = tev.Evaluator(tt).run(tg, tst).total_duration
    want = jev.Evaluator(jt).run(jg, jst).total_duration
    assert got <= want, (got, want)


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
def test_zero_probe_plan_matches_the_reference(zero,
                                               milp_without_wall_clock):
    """``bench.bench_zero_opt_mem``'s probe: a 128-256-128 tanh MLP, adam,
    an 8-row batch, ``data=2``, no annotation, the state aliased, plain
    and with ``zero_invars``, each package on its default chip (``v5e``,
    ``h100``) as that probe and ``scripts/torch_zero_smoke.sh`` plan it.
    Every input's strategy equals the reference's: all replicated, and
    with ZeRO the moments split. The whole objective lies inside HiGHS's
    default absolute gap, and the proven solve is kept as the reference
    keeps it. (On the shared ``cpu`` entry both packages split the
    weights, on different dims: neither objective prices a state alias;
    ROADMAP C16.)"""
    import optax

    from tepdist_tpu.parallel.sync_free import build_ga_step as jga
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.sync_free import build_ga_step as tga

    rng = np.random.default_rng(0)
    params = {"w1": rng.standard_normal((128, 256), dtype=np.float32) * .02,
              "w2": rng.standard_normal((256, 128), dtype=np.float32) * .02}
    x = rng.standard_normal((8, 128), dtype=np.float32)
    y = rng.standard_normal((8, 128), dtype=np.float32)

    jopt = optax.adam(1e-3)

    def japply(p, s, g):
        u, s = jopt.update(g, s, p)
        return optax.apply_updates(p, u), s

    def jloss(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    topv = adam(1e-3)
    tp = {k: torch.tensor(v) for k, v in params.items()}

    def tloss(p, x, y):
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    JEnv.reset()
    TEnv.reset()
    jstate, tstate = jopt.init(params), topv.init(tp)
    n_state = len(jax.tree_util.tree_leaves((params, jstate)))
    alias = {1 + i: i for i in range(n_state)}
    zi = list(range(2, n_state)) if zero else None
    jplan = jap.auto_parallel(
        jga(lambda p, *b: jax.value_and_grad(jloss)(p, *b), japply, 1,
            batch_argnums=(1, 2)),
        jmesh.MeshTopology([("data", 2)]), params, jstate, x, y,
        state_alias=alias, zero_invars=zi)
    tplan = tap.auto_parallel(
        tga(value_and_grad(tloss),
            lambda p, s, g: (p, topv.apply(p, g, s)), 1,
            batch_argnums=(1, 2)),
        tmesh.MeshTopology([("data", 2)]), tp, tstate, torch.tensor(x),
        torch.tensor(y), state_alias=alias, zero_invars=zi)
    assert set(milp_without_wall_clock) <= {0}, milp_without_wall_clock
    jgs, tgs = jplan.strategies[0], tplan.strategies[0]
    assert len(tplan.graph.invars) == len(jplan.graph.invars) == n_state + 2
    got = [_key(tgs.var_strategies.get(v)) for v in tplan.graph.invars]
    want = [_key(jgs.var_strategies.get(v)) for v in jplan.graph.invars]
    assert got == want, (got, want)
    split = [i for i, k in enumerate(got) if k[0] >= 0]
    assert split == ([3, 4, 5, 6] if zero else [])


# --------------------------------------------------------------------------
# Exploration and the int8 fake quantization
# --------------------------------------------------------------------------

def test_explore_records_the_excluded_kinds():
    """The port's explorer says what a caller leaves out: without the
    pipeline kind (``include_pipeline=False``, as the reference records a
    restricted search) the SPMD winner and ``excluded_kinds ==
    ["pipeline"]``; by default (the reference's) it searches every kind
    and excludes none. A seq axis on a graph with no attention raises the
    reference's guidance error."""
    params, x, y = _np_mlp()
    tp = {k: torch.tensor(v) for k, v in params.items()}
    best = texp.explore(_torch_mlp_loss, tp, torch.tensor(x),
                        torch.tensor(y), n_devices=8,
                        include_pipeline=False)
    assert best["kind"] == "spmd"
    assert best["excluded_kinds"] == ["pipeline"]
    assert best["report"]["excluded_kinds"] == ["pipeline"]
    assert {r["config"] for r in texp.candidate_summary(best["candidates"])
            } >= {"MeshTopology(data=8)", "MeshTopology(model=8)"}
    full = texp.explore(_torch_mlp_loss, tp, torch.tensor(x),
                        torch.tensor(y), n_devices=8, num_micro_batches=2)
    assert full["excluded_kinds"] == []
    assert full["report"]["excluded_kinds"] == []
    assert {c["kind"] for c in full["candidates"]} == {"spmd", "pipeline"}
    with pytest.raises(ValueError, match="no rewritable attention motif"):
        tap.plan_axes(_graphs("mlp")[1], tmesh.MeshTopology([("seq", 2)]))
    with pytest.raises(ValueError, match="no rewritable attention motif"):
        jap.plan_axes(_graphs("mlp")[0], jmesh.MeshTopology([("seq", 2)]))


@pytest.mark.parametrize("row,n", [
    ({"kind": "spmd", "config": "MeshTopology(data=8)@int8"}, 4),
    ({"kind": "spmd", "config": "MeshTopology(data=2, model=2)"}, 4),
    ({"kind": "pipeline", "config": "S=4 M=8 il/G=2@zero"}, 6),
    ({"kind": "pipeline", "config": "S=8 M=4"}, 4),
    ({"kind": "pipeline", "config": "S=4 M=4 tp=2"}, 8)])
def test_config_fits_devices_matches(row, n):
    assert texp._config_fits_devices(row, n) == jexp._config_fits_devices(
        row, n)


def test_replan_for_fleet_reranks_the_recorded_candidates():
    """The re-rank of a recorded SPMD search (``include_pipeline=False``:
    a 2-stage pipeline cut would still fit the 4-device fleet this test
    shrinks to, where no 8-device mesh does)."""
    params, x, y = _np_mlp()
    tp = {k: torch.tensor(v) for k, v in params.items()}
    best = texp.explore(_torch_mlp_loss, tp, torch.tensor(x),
                        torch.tensor(y), n_devices=8,
                        include_pipeline=False)
    report, _diff = texp.replan_for_fleet(best["report"], 16)
    assert report["n_devices"] == 16
    assert report["replanned_from_devices"] == 8
    assert report["winner"]["config"] == best["report"]["winner"]["config"]
    with pytest.raises(ValueError, match="fits 4 devices"):
        texp.replan_for_fleet(best["report"], 4)


def test_int8_fake_quant_is_unbiased_within_one_scale():
    """Stochastic rounding: each value moves by less than its chunk's
    scale (max|x| / 127), and the mean over draws converges to x."""
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    draws = torch.stack([tquant.fake_quant_int8(x, gen) for _ in range(400)])
    pad = torch.cat([x, x.new_zeros(24)]).reshape(-1, tquant.CHUNK)
    scale = (pad.abs().amax(1, keepdim=True) / 127).expand_as(
        pad).reshape(-1)[:1000]
    assert bool(((draws - x).abs() <= scale * (1 + 1e-6)).all())
    # The mean of 400 draws: error below 4 standard errors (<= scale/2/20).
    assert bool(((draws.mean(0) - x).abs() <= scale * 0.1).all())
    assert tquant.fake_quant_int8(torch.zeros(0), gen).numel() == 0
    bf = tquant.fake_quant_grads({"a": x.bfloat16(), "n": torch.arange(3)},
                                 gen)
    assert bf["a"].dtype == torch.bfloat16 and torch.equal(
        bf["n"], torch.arange(3))
