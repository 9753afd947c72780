"""The port's pipeline (``parallel/{graph_sketch,stage_decomposition,
pipeline}``, ``runtime/executor``, ``plan_training(num_stages=...)``) held
against the JAX package's on the CPU.

Both sides get the same seeded numpy inputs. The JAX side runs its
``PipelineExecutable`` on ``jax.devices()[:S]`` (one virtual CPU device a
stage); the port runs its own on ``["cpu"] * S``. Tolerances are the
reference's own (``tests/test_runtime.py``): losses rtol 1e-5, params and
optimizer state rtol 1e-4 / atol 1e-6 (fp32 sums in another order).

The stage cuts of an aten graph and of a jaxpr need not be equal, so the
GraphSketch is held to properties: stage precedence, every stage above 5%
of the flops, the sketch's flops equal to the graph's, and on ``_mlp4``
each stage's matmul flops equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import wide_resnet as jwrn
from tepdist_tpu.parallel.pipeline import plan_pipeline as jax_plan_pipeline
from tepdist_tpu.runtime.executor import (
    PipelineExecutable as JaxPipelineExecutable)
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
from tepdist_tpu_torch.graph.cost import MATMULS
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.models import wide_resnet as twrn
from tepdist_tpu_torch.optim import adam, sgd
from tepdist_tpu_torch.parallel.graph_sketch import GraphSketch
from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
from tepdist_tpu_torch.parallel.stage_decomposition import StageDecomposition
from tepdist_tpu_torch.parallel.sync_free import build_ga_step
from tepdist_tpu_torch.runtime.executor import PipelineExecutable
from tepdist_tpu_torch.train import plan_training, value_and_grad

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


# --------------------------------------------------------------------------
# models on both sides
# --------------------------------------------------------------------------

def _mlp4_data(batch=32, d=64):
    """The reference's ``_mlp4`` (tests/test_pipeline.py) on numpy draws."""
    rng = np.random.default_rng(0)
    params = {f"w{i}": (rng.standard_normal((d, d)) * 0.3).astype(np.float32)
              for i in range(4)}
    x = rng.standard_normal((batch, d)).astype(np.float32)
    y = rng.standard_normal((batch, d)).astype(np.float32)
    return params, (x, y)


def _jax_mlp4(params, x, y):
    h = x
    for i in range(4):
        h = jnp.tanh(h @ params[f"w{i}"])
    return jnp.mean((h - y) ** 2)


def _torch_mlp4(params, x, y):
    h = x
    for i in range(4):
        h = torch.tanh(h @ params[f"w{i}"])
    return ((h - y) ** 2).mean()


def _gpt2_case():
    """GPT-2 ``test`` with per-block remat and a chunked loss. The port
    runs its flash path (the kernels' plain versions on the CPU); the JAX
    side runs einsum attention, because its pipeline cannot differentiate
    a stage holding a ``pallas_call``: the capture inlines the kernel's
    custom VJP, and binding the bare ``pallas_call`` under ``jax.vjp``
    fails outside a Pallas grid (ROADMAP C6). In fp32 the two attentions
    agree to rounding."""
    common = dict(remat=True, loss_chunk=48)
    cfg_j = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32,
                                attn="einsum", **common)
    cfg_t = dataclasses.replace(tgpt2.CONFIGS["test"], dtype=torch.float32,
                                attn="flash", **common)
    params = jax.device_get(jgpt2.init_params(cfg_j, jax.random.PRNGKey(0)))
    toks = np.asarray(jgpt2.fake_batch(cfg_j, 4, 32, seed=3))
    return ((lambda p, t: jgpt2.loss_fn(p, t, cfg_j)),
            (lambda p, t: tgpt2.loss_fn(p, t, cfg_t)), params, (toks,))


def _wrn_case():
    jcfg, tcfg = jwrn.CONFIGS[-1], twrn.CONFIGS[-1]
    params = jax.device_get(jwrn.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 4).astype(np.int32)
    return ((lambda p, x, y: jwrn.loss_fn(p, x, y, jcfg)),
            (lambda p, x, y: twrn.loss_fn(p, x, y, tcfg)), params,
            (images, labels))


def _to_torch(tree):
    return convert.to_torch(tree, device="cpu")


# --------------------------------------------------------------------------
# two steps on each side
# --------------------------------------------------------------------------

def _jax_run(loss, params, batch, S, M, tx, steps=2, **placement):
    prog = jax_plan_pipeline(loss, S, M, params, *batch)
    n_dev = placement.pop("n_devices", S)
    exe = JaxPipelineExecutable(prog, devices=jax.devices()[:n_dev],
                                optimizer=tx, **placement)
    exe.load_variables(params)
    losses = [exe.step(*batch) for _ in range(steps)]
    return (losses, jax.device_get(exe.fetch_variables()),
            jax.device_get(exe.fetch_opt_state()), exe)


def _torch_run(loss, params, batch, S, M, tx, steps=2, **placement):
    params_t, batch_t = _to_torch(params), _to_torch(batch)
    prog = plan_pipeline(loss, S, M, params_t, *batch_t)
    n_dev = placement.pop("n_devices", S)
    exe = PipelineExecutable(prog, devices=["cpu"] * n_dev, optimizer=tx,
                             **placement)
    exe.load_variables(params_t)
    losses = [exe.step(*batch_t) for _ in range(steps)]
    return losses, exe.fetch_variables(), exe.fetch_opt_state(), exe


def _assert_close_trees(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    g = [convert.tensor_to_array(t) for t in tree_leaves(got)]
    w = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _compare(jloss, tloss, params, batch, S, M, opt, **placement):
    jtx = {"sgd": optax.sgd(0.1), "adam": optax.adam(1e-2)}[opt]
    ttx = {"sgd": sgd(0.1), "adam": adam(1e-2)}[opt]
    jl, jp, jst, _ = _jax_run(jloss, params, batch, S, M, jtx,
                              **dict(placement))
    tl, tp, tst, exe = _torch_run(tloss, params, batch, S, M, ttx,
                                  **dict(placement))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_close_trees(tp, jp)
    _assert_close_trees(tst, jst)
    assert tl[1] < tl[0]
    return exe


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("S,M", [(2, 4), (4, 2)])
def test_mlp4_two_steps_match_jax(S, M, opt):
    params, batch = _mlp4_data()
    exe = _compare(_jax_mlp4, _torch_mlp4, params, batch, S, M, opt)
    types = [n.task_type.value for n in exe.dag.nodes]
    assert types.count("compute") == 2 * S * M
    assert exe.verify_report is not None      # the gate ran (pytest)


def test_gpt2_tied_wte_matches_jax():
    """GPT-2 ``test`` (flash: the port's plain version on the CPU) with the
    embedding tied to the logits: ``wte`` is read by the first and the last
    stage, and its owner applies the summed gradient once."""
    jloss, tloss, params, batch = _gpt2_case()
    exe = _compare(jloss, tloss, params, batch, 2, 2, "sgd")
    # Flat index of wte: the leaves of the keys sorted before it.
    wte = len(tree_leaves({k: v for k, v in params.items() if k < "wte"}))
    assert exe.param_stages[wte] == [0, 1] and exe.param_owner[wte] == 0
    apply1 = exe.dag.node(exe.maps.apply_tasks[0])
    assert 2 in apply1.input_specs        # stage 1's GA feeds stage 0's apply
    flash = [n for m in exe.prog.stages for n in m.eqns
             if n.prim == "flash_fwd"]
    assert len(flash) == 2


def test_wrn_heterogeneous_stages_match_jax():
    jloss, tloss, params, batch = _wrn_case()
    exe = _compare(jloss, tloss, params, batch, 2, 2, "sgd")
    flops = exe.prog.stage_flops()
    assert min(flops) > 0.05 * sum(flops)


def test_interleaved_matches_jax_and_blocked():
    """4 virtual stages over 2 device groups (stage s on group s % 2):
    two steps equal the JAX package's interleaved executable and the
    port's blocked 4-stage one."""
    params, batch = _mlp4_data()
    exe = _compare(_jax_mlp4, _torch_mlp4, params, batch, 4, 2, "sgd",
                   placement="interleaved", interleave_groups=2,
                   n_devices=2)
    assert exe.stage_devices == [(0,), (1,), (0,), (1,)]
    # Co-resident hops are direct edges: only the 0<->1 / 1<->2 / 2<->3
    # group changes ship, all of them here (s and s+1 never share a group).
    assert any(n.task_type.value == "send" for n in exe.dag.nodes)
    bl, bp, _, _ = _torch_run(_torch_mlp4, params, batch, 4, 2, sgd(0.1))
    il, ip, _, _ = _torch_run(_torch_mlp4, params, batch, 4, 2, sgd(0.1),
                              placement="interleaved", interleave_groups=2,
                              n_devices=2)
    np.testing.assert_allclose(il, bl, rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(ip), tree_leaves(bp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


def test_bf16_comm_dtype_matches_jax():
    """The winner's bf16 gradient-contribution cast in the GA payload."""
    params, batch = _mlp4_data()
    jprog = jax_plan_pipeline(_jax_mlp4, 2, 4, params, *batch)
    jprog.comm_dtype = "bfloat16"
    jexe = JaxPipelineExecutable(jprog, devices=jax.devices()[:2],
                                 optimizer=optax.sgd(0.1))
    jexe.load_variables(params)
    jl = [jexe.step(*batch) for _ in range(2)]
    params_t, batch_t = _to_torch(params), _to_torch(batch)
    prog = plan_pipeline(_torch_mlp4, 2, 4, params_t, *batch_t)
    prog.comm_dtype = "bfloat16"
    exe = PipelineExecutable(prog, devices=["cpu"] * 2, optimizer=sgd(0.1))
    exe.load_variables(params_t)
    tl = [exe.step(*batch_t) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    # A bf16 contribution may round one bf16 step (2**-8 relative) the
    # other way: params within lr * 2**-8 * max|grad| of the reference's.
    _assert_close_trees(exe.fetch_variables(),
                        jax.device_get(jexe.fetch_variables()),
                        rtol=PARAM_RTOL, atol=0.1 * 2 ** -8)


def test_int8_comm_dtype_trains():
    """int8 fake quant of each contribution (a generator per stage and
    slot; the reference's threefry draws cannot be matched): the loss
    stays within 5% of the fidelity run's and falls."""
    params, batch = _mlp4_data()
    params_t, batch_t = _to_torch(params), _to_torch(batch)
    runs = {}
    for cd in ("", "int8"):
        prog = plan_pipeline(_torch_mlp4, 2, 4, params_t, *batch_t)
        prog.comm_dtype = cd
        exe = PipelineExecutable(prog, devices=["cpu"] * 2,
                                 optimizer=sgd(0.1))
        exe.load_variables(tree_map(torch.clone, params_t))
        runs[cd] = [exe.step(*batch_t) for _ in range(3)]
    np.testing.assert_allclose(runs["int8"], runs[""], rtol=0.05)
    assert runs["int8"][-1] < runs["int8"][0]


# --------------------------------------------------------------------------
# GraphSketch and StageDecomposition: properties
# --------------------------------------------------------------------------

def _sketch_cases():
    params, batch = _mlp4_data()
    yield "mlp4-2", _torch_mlp4, params, batch, 2
    yield "mlp4-4", _torch_mlp4, params, batch, 4
    _, tloss, params, batch = _gpt2_case()
    yield "gpt2-2", tloss, params, batch, 2
    _, tloss, params, batch = _wrn_case()
    yield "wrn-2", tloss, params, batch, 2


@pytest.mark.parametrize("name", ["mlp4-2", "mlp4-4", "gpt2-2", "wrn-2"])
def test_stage_plan_properties(name):
    case = next(c for c in _sketch_cases() if c[0] == name)
    _, loss, params, batch, S = case
    prog = plan_pipeline(loss, S, 2, _to_torch(params),
                         *_to_torch(batch))
    graph, sketch = prog.graph, prog.sketch
    assert sketch.solver_status in ("ilp", "heuristic")
    assert sketch.solve_seconds >= 0
    assert len(sketch.nodes) < len(graph.nodes)
    assert sketch.total_flops() == pytest.approx(graph.total_flops())
    # The clusters form a DAG (ids follow the first member, so on the
    # aten graphs an operand cluster may carry a larger id; on the MLP they
    # are topological, as the reference's test asserts).
    indeg = {sn.id: len(sn.operands) for sn in sketch.nodes}
    ready = [i for i, d in indeg.items() if d == 0]
    done = 0
    while ready:
        i = ready.pop()
        done += 1
        for u in sketch.nodes[i].users:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    assert done == len(sketch.nodes)
    if name.startswith("mlp4"):
        for sn in sketch.nodes:
            assert all(o < sn.id for o in sn.operands)
    assignment = prog.decomp.assignment
    for n in graph.nodes:
        assert 0 <= assignment[n.id] < S
        for op in n.operands:
            assert assignment[op.id] <= assignment[n.id]
    flops = prog.stage_flops()
    assert sum(flops) == pytest.approx(graph.total_flops())
    assert min(flops) > 0.05 * sum(flops)
    # A multi-output op and its getitems never straddle a cut.
    for m in prog.stages:
        for n in m.eqns:
            for ov in n.outvars:
                assert ov is None or ov not in m.invars


@pytest.mark.parametrize("S", [2, 4])
def test_mlp4_stage_matmul_flops_match_reference(S):
    params, batch = _mlp4_data()
    jprog = jax_plan_pipeline(_jax_mlp4, S, 2, params, *batch)
    want = [0.0] * S
    for n in jprog.graph.nodes:
        if n.prim == "dot_general":
            want[jprog.decomp.assignment[n.id]] += n.flops
    prog = plan_pipeline(_torch_mlp4, S, 2, _to_torch(params),
                         *_to_torch(batch))
    got = [0.0] * S
    for n in prog.graph.nodes:
        if n.prim in MATMULS:
            got[prog.decomp.assignment[n.id]] += n.flops
    assert got == want


def test_decomposition_wiring_and_precedence_error():
    params, batch = _mlp4_data()
    prog = plan_pipeline(_torch_mlp4, 2, 2, _to_torch(params),
                         *_to_torch(batch))
    s0, s1 = prog.stages
    acts = s1.activation_positions()
    assert acts and all(s1.input_def_map[p][:2] == ("stage", 0)
                        for p in acts)
    assert prog.decomp.cross_stage_bytes() == pytest.approx(
        sum(s1.invars[p].meta["val"].nbytes for p in acts))
    assert 0 in s1.graph_out_map
    reversed_assignment = [1 - a for a in prog.decomp.assignment]
    with pytest.raises(ValueError, match="LATER stage"):
        StageDecomposition(prog.graph, reversed_assignment, 2)


def test_stage_module_moves_baked_devices():
    """The capture bakes its device into factory ops (``torch.ones`` in the
    chunked loss's mask); a stage module placed on a device names that
    device in every such node."""
    _, tloss, params, batch = _gpt2_case()
    prog = plan_pipeline(tloss, 2, 2, _to_torch(params), *_to_torch(batch))
    baked = [n for n in prog.graph.gm.graph.nodes
             if isinstance(n.kwargs.get("device"), torch.device)]
    assert baked
    meta = torch.device("meta")
    seen = 0
    for s in range(2):
        gm = prog.decomp.stage_fn(s, device=meta)
        for n in gm.graph.nodes:
            if isinstance(n.kwargs.get("device"), torch.device):
                assert n.kwargs["device"] == meta
                seen += 1
    assert seen == len(baked)


# --------------------------------------------------------------------------
# the correctness anchor and the plan
# --------------------------------------------------------------------------

def test_reference_step_equals_plain_ga_step():
    """``PipelineProgram.reference_step`` (stage by stage, recomputing each
    stage forward in its backward) against the port's plain GA step
    (``sync_free.build_ga_step`` of the whole loss's grad)."""
    params, batch = _mlp4_data()
    params_t, batch_t = _to_torch(params), _to_torch(batch)
    tx = adam(1e-2)

    def apply_fn(p, s, g):
        return p, tx.apply(p, g, s)

    prog = plan_pipeline(_torch_mlp4, 2, 4, params_t, *batch_t)
    ref = prog.reference_step(apply_fn)
    ga = build_ga_step(value_and_grad(_torch_mlp4), apply_fn, 4,
                       batch_argnums=(1, 2))
    p1 = tree_map(torch.clone, params_t)
    p2 = tree_map(torch.clone, params_t)
    s1, s2 = tx.init(p1), tx.init(p2)
    for _ in range(2):
        l1, p1, s1 = ref(p1, s1, *batch_t)
        l2, p2, s2 = ga(p2, s2, *batch_t)
        np.testing.assert_allclose(float(l1), float(l2), rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


def _plans(tmp_path):
    params, batch = _mlp4_data()
    params_t, batch_t = _to_torch(params), _to_torch(batch)

    def pipe():
        return plan_training(_torch_mlp4, adam(1e-2),
                             tree_map(torch.clone, params_t), *batch_t,
                             num_stages=2, num_micro_batches=4,
                             device="cpu", devices=["cpu"] * 2)

    def eager():
        return plan_training(_torch_mlp4, adam(1e-2),
                             tree_map(torch.clone, params_t), *batch_t,
                             num_micro_batches=4, device="cpu")

    return pipe, eager, batch_t


@pytest.mark.parametrize("direction", ["pipeline_to_eager",
                                       "eager_to_pipeline"])
def test_checkpoint_crosses_runtimes(tmp_path, direction):
    """A checkpoint saved by one runtime after a step, restored into the
    other built from other weights, gives the saver's next loss."""
    pipe, eager, batch = _plans(tmp_path)
    src, dst = ((pipe, eager) if direction == "pipeline_to_eager"
                else (eager, pipe))
    a = src()
    a.step(*batch)
    a.save(str(tmp_path), step=1)
    want = a.step(*batch)
    b = dst()
    for leaf in tree_leaves(b.variables()[0]):
        leaf.mul_(0.5)
    assert b.restore(str(tmp_path)) == 1
    got = b.step(*batch)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_plan_training_pipeline_matches_jax_executor():
    """``plan_training(num_stages=2)`` of the port against the JAX
    package's executable on the same program shape (adam)."""
    params, batch = _mlp4_data()
    jl, jp, jst, _ = _jax_run(_jax_mlp4, params, batch, 2, 4,
                              optax.adam(1e-2))
    plan = plan_training(_torch_mlp4, adam(1e-2), _to_torch(params),
                         *_to_torch(batch), num_stages=2,
                         num_micro_batches=4, device="cpu",
                         devices=["cpu"] * 2)
    tl = [plan.step(*_to_torch(batch)) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    p, st = plan.variables()
    _assert_close_trees(p, jp)
    _assert_close_trees(st, jst)


def test_num_stages_env_picks_stages():
    params, batch = _mlp4_data()
    ServiceEnv.reset({"NUM_STAGES": "2", "NUM_MICRO_BATCHES": "2"})
    try:
        plan = plan_training(_torch_mlp4, sgd(0.1), _to_torch(params),
                             *_to_torch(batch), device="cpu",
                             devices=["cpu"] * 2)
    finally:
        ServiceEnv.reset()
    assert plan.pipeline.num_stages == 2
    assert plan.pipeline.num_micro_batches == 2


@pytest.fixture(scope="module")
def gloo_pool():
    """4 ``gloo`` ranks serving the cases of ``test_torch_pipeline_dist``
    (made on first use: two tests here need the group form)."""
    from torch_gloo_pool import GlooPool

    p = GlooPool("test_torch_pipeline_dist")
    yield p
    p.close()


@pytest.mark.parametrize("kw", [
    dict(intra_stage_tp=2),
    dict(devices=["cpu"] * 4),
    dict(zero=True),
], ids=["stage_tp", "two_devices_a_stage", "zero"])
def test_multi_device_stages_raise_13b(kw, gloo_pool):
    """The three multi-device stages that raised before ROADMAP item 13b
    construct and step now (the name records the item): stage x TP on 4
    ranks (the group form, one rank a device), two devices a stage and
    ZeRO over ``["cpu"] * 4`` in the one-process form. Two steps, the
    losses against the JAX package's (TP: the PP x TP bound of
    ``tests/test_pp_tp_depth.py``)."""
    params, batch = _mlp4_data()
    kw = dict(kw)
    zero = kw.pop("zero", False)
    placement = dict(kw, n_devices=4)
    placement.pop("devices", None)
    jl, _, _, _ = _jax_run(_jax_mlp4, params, batch, 2, 4, optax.sgd(0.1),
                           **placement)
    if "intra_stage_tp" in kw:
        got = gloo_pool.run("pipeline", {
            "model": "mlp4", "params": params, "batch": batch, "S": 2,
            "M": 4, "opt": "sgd", "kw": kw})
        assert (got["dp"], got["tp"]) == (1, 2)
        np.testing.assert_allclose(got["losses"], jl, rtol=2e-4)
        return
    params_t, batch_t = _to_torch(params), _to_torch(batch)
    prog = plan_pipeline(_torch_mlp4, 2, 4, params_t, *batch_t)
    prog.zero = zero
    exe = PipelineExecutable(prog, optimizer=sgd(0.1),
                             devices=["cpu"] * 4)
    assert exe.dp == 2 and exe.zero == zero
    exe.load_variables(params_t)
    tl = [exe.step(*batch_t) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
def test_intra_stage_dp_matches_jax(zero):
    """S=2 x dp=2 on ``["cpu"] * 4`` (each stage module captured at a
    replica's half of the micro batch; the partial gradients summed once
    at APPLY) against the JAX executable on 4 devices: losses, params and
    the assembled optimizer state. With ZeRO each replica holds half of
    every padded flat moment; held to the plain-GA trajectory (ROADMAP
    C2), which the JAX executable's ZeRO also follows."""
    params, batch = _mlp4_data()
    jprog = jax_plan_pipeline(_jax_mlp4, 2, 4, params, *batch)
    jexe = JaxPipelineExecutable(jprog, devices=jax.devices()[:4],
                                 optimizer=optax.adam(1e-2))
    jexe.load_variables(params)
    jl = [jexe.step(*batch) for _ in range(2)]
    params_t, batch_t = _to_torch(params), _to_torch(batch)
    prog = plan_pipeline(_torch_mlp4, 2, 4, params_t, *batch_t)
    prog.zero = zero
    exe = PipelineExecutable(prog, devices=["cpu"] * 4,
                             optimizer=adam(1e-2))
    assert exe.prog.replicas == 2 and exe.zero == zero
    # The replica's modules run 4 rows of the micro batch's 8.
    assert exe.prog.graph.invars[-1].meta["val"].shape[0] == 4
    exe.load_variables(params_t)
    tl = [exe.step(*batch_t) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_close_trees(exe.fetch_variables(),
                        jax.device_get(jexe.fetch_variables()))
    _assert_close_trees(exe.fetch_opt_state(),
                        jax.device_get(jexe.fetch_opt_state()))
    if zero:
        mu = exe.opt_states[0][1]["mu"]
        assert all(t.shape == (64 * 64 // 2,) for t in mu.values())


def test_one_process_and_group_forms_agree(gloo_pool):
    """The same scheduled tasks issued in the one-process form (every rank
    in this process, ``["cpu"] * 4``) and in the group form (4 gloo ranks,
    one each): equal losses (the replicas' sum in another order)."""
    params, batch = _mlp4_data()
    spec = {"model": "mlp4", "params": params, "batch": batch, "S": 2,
            "M": 4, "opt": "adam"}
    group = gloo_pool.run("forms_agree", spec)
    tl = _torch_run(_torch_mlp4, params, batch, 2, 4, adam(1e-2),
                    n_devices=4)[0]
    np.testing.assert_allclose(group, tl, rtol=1e-6)


def test_tp_in_one_process_raises():
    """One process cannot hold the ranks of a TP group: a ValueError says
    so, never an untiled run."""
    params, batch = _mlp4_data()
    prog = plan_pipeline(_torch_mlp4, 2, 2, _to_torch(params),
                         *_to_torch(batch))
    with pytest.raises(ValueError, match="one rank a device"):
        PipelineExecutable(prog, optimizer=sgd(0.1), devices=["cpu"] * 4,
                           intra_stage_tp=2)


def test_default_devices_are_the_card():
    """With no devices the executor takes the card, and raises where there
    is none (never a silent fall back to the CPU)."""
    params, batch = _mlp4_data()
    prog = plan_pipeline(_torch_mlp4, 2, 2, _to_torch(params),
                         *_to_torch(batch))
    if torch.cuda.is_available():
        exe = PipelineExecutable(prog, optimizer=sgd(0.1))
        assert all(d.type == "cuda" for d in exe.stage_device)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineExecutable(prog, optimizer=sgd(0.1))
