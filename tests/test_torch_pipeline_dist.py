"""The port's pipeline with stages over several devices, in the
process-group form, on four CPU ranks, held to the JAX package's
``PipelineExecutable`` on ``jax.devices()[:4]`` of the 8-device virtual
CPU mesh (``tests/conftest.py``), and the collective pipeline's group form
to the reference's ``collective_pipeline`` / ``sequential_reference``.

One pool of 4 ``gloo`` ranks (``torch_gloo_pool``) serves every case:
each rank holds one (stage group, intra, model) coordinate and runs the
same scheduled order. The JAX side runs in the parent on the same seeded
numpy inputs. Tolerances:

- the reference's own for a pipeline (``tests/test_runtime.py``): losses
  rtol 1e-5, params and optimizer state rtol 1e-4 / atol 1e-6;
- for stage x TP, ``tests/test_pp_tp_depth.py``'s: losses rtol 2e-4,
  params rtol 1e-3 / atol 1e-5;
- for the collective pipeline, ``tests/test_collective_pipeline.py``'s:
  outputs rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6 (GPT-2:
  loss rtol 2e-5, gradients rtol 2e-4 / atol 1e-6).

ZeRO is held to the same plan without ZeRO (the plain-GA trajectory), not
to the reference's ZeRO output, whose two shard_map tests fail (ROADMAP
C2). GPT-2 runs the port's flash stages against the reference's einsum
stages (ROADMAP C6).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_gloo_pool import GlooPool

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
TP_LOSS_RTOL, TP_PARAM_RTOL, TP_PARAM_ATOL = 2e-4, 1e-3, 1e-5


# --------------------------------------------------------------------------
# Models (numpy inputs; the JAX sides are built in the parent only)
# --------------------------------------------------------------------------

def _mlp4_data(batch=32, d=64):
    """The reference's ``_mlp4`` (tests/test_pipeline.py) on numpy draws."""
    rng = np.random.default_rng(0)
    params = {f"w{i}": (rng.standard_normal((d, d)) * 0.3).astype(np.float32)
              for i in range(4)}
    x = rng.standard_normal((batch, d)).astype(np.float32)
    y = rng.standard_normal((batch, d)).astype(np.float32)
    return params, (x, y)


def _torch_mlp4(params, x, y):
    h = x
    for i in range(4):
        h = torch.tanh(h @ params[f"w{i}"])
    return ((h - y) ** 2).mean()


def _gpt2_cfg_t():
    from tepdist_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32,
                               attn="flash", remat=True, loss_chunk=48)


def _torch_loss(model):
    if model == "mlp4":
        return _torch_mlp4
    from tepdist_tpu_torch.models import gpt2

    cfg = _gpt2_cfg_t()
    return lambda p, t: gpt2.loss_fn(p, t, cfg)


def _np_case(model):
    """(params, batch) as numpy: GPT-2 ``test`` from the JAX package's
    init (the parent only; the ranks get the arrays)."""
    if model == "mlp4":
        return _mlp4_data()
    import jax
    import jax.numpy as jnp

    from tepdist_tpu.models import gpt2 as jgpt2

    cfg = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32)
    params = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    toks = np.asarray(jgpt2.fake_batch(cfg, 8, 32, seed=3))
    return params, (toks,)


def _jax_loss(model):
    import jax.numpy as jnp

    if model == "mlp4":
        def loss(params, x, y):
            h = x
            for i in range(4):
                h = jnp.tanh(h @ params[f"w{i}"])
            return jnp.mean((h - y) ** 2)
        return loss
    from tepdist_tpu.models import gpt2 as jgpt2

    cfg = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32,
                              attn="einsum", remat=True, loss_chunk=48)
    return lambda p, t: jgpt2.loss_fn(p, t, cfg)


def _to_torch(tree):
    from tepdist_tpu_torch import convert

    return convert.to_torch(tree, device="cpu")


def _np_leaves(tree):
    from tepdist_tpu_torch.core.tree import tree_leaves

    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def _optimizer(opt, lib="torch"):
    if lib == "jax":
        import optax
        return {"sgd": optax.sgd(0.1), "adam": optax.adam(1e-2)}[opt]
    from tepdist_tpu_torch.optim import adam, sgd
    return {"sgd": sgd(0.1), "adam": adam(1e-2)}[opt]


# --------------------------------------------------------------------------
# Cases (every rank runs them; rank 0's value goes to the parent)
# --------------------------------------------------------------------------

def _run(spec, steps=2):
    """``spec``: model, (params, batch) as numpy, S, M and the executor's
    keywords; losses and the assembled state after ``steps`` steps."""
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.runtime.executor import PipelineExecutable

    params, batch = _to_torch(spec["params"]), _to_torch(spec["batch"])
    prog = plan_pipeline(_torch_loss(spec["model"]), spec["S"], spec["M"],
                         params, *batch)
    prog.zero = spec.get("zero", False)
    exe = PipelineExecutable(prog, devices=["cpu"] * 4,
                             optimizer=_optimizer(spec["opt"]),
                             **spec.get("kw", {}))
    exe.load_variables(params)
    losses = [exe.step(*batch) for _ in range(steps)]
    return {"losses": losses, "params": _np_leaves(exe.fetch_variables()),
            "state": _np_leaves(exe.fetch_opt_state()),
            "coord": exe._coord, "dp": exe.dp, "tp": exe.tp,
            "zero": exe.zero,
            "split": [sum(1 for p in specs if type(p[1]).__name__ == "Shard")
                      for specs in exe._tp_in_specs if specs is not None]}


def case_pipeline(rank, spec):
    return _run(spec)


def case_embedding_split_tokens(rank, spec):
    """GPT-2's embedding (``gpt2._embed``: ``F.embedding`` + positions) on
    a 2-rank ``model`` mesh at the card's shape for stage x TP (1.5B
    width, seq 1024, one row a micro batch; vocab cut for time), with the
    token ids split on the sequence dim and the table replicated: the ops
    DTensor runs (recorded by a dispatch mode), the table gradient's
    placement, and the gradient against the same function on one rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from tepdist_tpu_torch.models import gpt2

    vocab, T, d = spec
    cfg = dataclasses.replace(gpt2.CONFIGS["1.5B"], vocab_size=vocab,
                              n_layer=1, dtype=torch.float32)
    mesh = init_device_mesh("cpu", (2, 2),
                            mesh_dim_names=("pair", "model"))["model"]
    gen = torch.Generator().manual_seed(0)
    wte = torch.randn(vocab, d, generator=gen) * 0.02
    wpe = torch.randn(cfg.n_ctx, d, generator=gen) * 0.01
    tokens = torch.randint(0, vocab, (1, T), generator=gen,
                           dtype=torch.int32)
    w = torch.randn(1, T, d, generator=gen)

    def loss(params, tok, weight):
        return (gpt2._embed(params, tok, cfg) * weight).sum()

    ref = wte.clone().requires_grad_()
    want = torch.autograd.grad(loss({"wte": ref, "wpe": wpe}, tokens, w),
                               ref)[0]

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    table = distribute_tensor(wte, mesh, [Replicate()]).requires_grad_()
    params = {"wte": table,
              "wpe": distribute_tensor(wpe, mesh, [Replicate()])}
    split_tok = distribute_tensor(tokens, mesh, [Shard(1)])
    split_w = distribute_tensor(w, mesh, [Shard(1)])
    with Ops() as ops:
        got = torch.autograd.grad(loss(params, split_tok, split_w),
                                  table)[0]
    return {"ops": sorted(set(ops.names)),
            "placements": [(type(p).__name__, getattr(p, "reduce_op", None))
                           for p in got.placements],
            "grad": got.full_tensor().numpy(), "want": want.numpy()}


def case_flash_uneven_split(rank, spec):
    """The flash ops on a 2-rank ``model`` mesh with q, k, v of 25
    batch-heads split on the sequence dim (the split stage x TP planned at
    GPT-2 1.5B width and M = 8, where ROADMAP C8 hung): loss and
    gradients through the attention output's view back to the hidden dim,
    against the same function on whole tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from tepdist_tpu_torch.parallel.spmd_transform import (
        register_flash_sharding)

    register_flash_sharding()
    mesh = init_device_mesh("cpu", (2, 2),
                            mesh_dim_names=("pair", "model"))["model"]
    BH, T, D = spec
    gen = torch.Generator().manual_seed(0)
    whole = [torch.randn(BH, T, D, generator=gen) for _ in range(3)]

    def loss(q, k, v):
        o, _ = torch.ops.tepdist.flash_fwd(q, k, v, True, D ** -0.5, BH)
        hidden = o.view(1, BH, T, D).transpose(1, 2).reshape(1, T, BH * D)
        return (hidden * hidden).sum()

    ref = [x.clone().requires_grad_() for x in whole]
    want = loss(*ref)
    want.backward()
    split = [distribute_tensor(x, mesh, [Shard(1)]).requires_grad_()
             for x in whole]
    got = loss(*split)
    got.full_tensor().backward()
    return {"loss": (float(got.full_tensor()), float(want)),
            "grads": [(g.grad.full_tensor().numpy(), r.grad.numpy())
                      for g, r in zip(split, ref)]}


def case_zero_and_plain(rank, spec):
    return {"zero": _run(dict(spec, zero=True)),
            "plain": _run(dict(spec, zero=False))}


def _zero_plan(params, batch, devices=4):
    """A ZeRO pipeline plan of ``_mlp4`` (2 stages, M = 4) over 4 ranks."""
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.train import _plan_pipeline

    return _plan_pipeline(_torch_mlp4, adam(1e-2), params, batch,
                          torch.device("cpu"), 2, 4, ["cpu"] * devices, 1,
                          "blocked", None, "", True, None, None)


def case_checkpoint(rank, directory):
    """Two ZeRO steps, a per-shard save, then the third step's loss."""
    params, batch = _mlp4_data()
    plan = _zero_plan(_to_torch(params), _to_torch(batch))
    for _ in range(2):
        plan.step(*_to_torch(batch))
    plan.save(directory, 2)
    return {"next": plan.step(*_to_torch(batch))}


def case_winner_build(rank, arg):
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.exploration import PipelineWinner

    params, batch = _to_torch(arg[0]), _to_torch(arg[1])
    winner = PipelineWinner(
        num_stages=2, num_micro_batches=2, intra_tp=1, cost=None,
        candidates=[], loss_fn=arg[2], params=params, example_batch=batch)
    exe = winner.build(sgd(0.1), devices=["cpu"] * 4)
    exe.load_variables(params)
    return {"losses": [exe.step(*batch) for _ in range(3)], "dp": exe.dp}


def _deep_mlp_loss(params, x, y):
    h = x
    for i in range(4):
        h = torch.relu(h @ params[f"w{i}"])
    return ((h - y) ** 2).mean()


def case_forms_agree(rank, spec):
    """The group form's losses for the one-process comparison."""
    return _run(spec)["losses"]


def case_ga_zero(rank, spec):
    """``build_ga_step(zero_dp=4)`` over the 4 ranks (each its quarter of
    the rows) against the plain GA step on the whole batch."""
    import torch.distributed as dist

    from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.sync_free import (build_ga_step,
                                                      zero_shard_params)
    from tepdist_tpu_torch.train import value_and_grad

    params, (x, y) = _mlp4_data()
    params, x, y = _to_torch(params), _to_torch(x), _to_torch(y)
    tx = adam(1e-2)
    grad = value_and_grad(_torch_mlp4)

    def apply_plain(p, s, g):
        return p, tx.apply(p, g, s)

    def apply_mean(p, s, g):
        # The reduce-scatter sums the replicas' means: fold in 1/dp.
        return p, tx.apply(p, tree_map(lambda t: t / 4, g), s)

    out = {}
    plain = build_ga_step(grad, apply_plain, 2, batch_argnums=(1, 2))
    p = tree_map(torch.clone, params)
    s = tx.init(p)
    out["plain"] = []
    for _ in range(4):
        loss, p, s = plain(p, s, x, y)
        out["plain"].append(float(loss))
    out["plain_params"] = _np_leaves(p)
    for cd in ("", "int8"):
        step = build_ga_step(grad, apply_mean, 2, batch_argnums=(1, 2),
                             comm_dtype=cd, zero_dp=4,
                             zero_axis_name=dist.group.WORLD)
        p = tree_map(torch.clone, params)
        s = tx.init(zero_shard_params(p, 4, rank))
        rows = slice(rank * 8, (rank + 1) * 8)
        local = []
        for _ in range(4):
            loss, p, s = step(p, s, x[rows], y[rows])
            t = loss.detach().reshape(1).clone()
            dist.all_reduce(t)
            local.append(float(t) / 4)
        out[cd or "fidelity"] = local
        out[(cd or "fidelity") + "_params"] = _np_leaves(p)
        out[(cd or "fidelity") + "_shard"] = [
            t.numel() for t in tree_leaves(s["mu"])]
    return out


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def case_collective(rank, spec):
    """The collective pipeline's group form over a DeviceMesh of the 4
    ranks: outputs and gradients."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from tepdist_tpu_torch.ops.collective_pipeline import (
        collective_pipeline)

    names = tuple(spec["names"])
    mesh = init_device_mesh("cpu", tuple(spec["shape"]),
                            mesh_dim_names=names)
    stacked = {k: torch.tensor(v) for k, v in spec["stacked"].items()}
    x = torch.tensor(spec["x"])
    if "placements" in spec:
        from torch.distributed.tensor import Replicate, Shard
        stacked = {k: distribute_tensor(
            a, mesh, [Shard(d) if d is not None else Replicate()
                      for d in spec["placements"][k]], src_data_rank=None)
            for k, a in stacked.items()}
    leaves = {k: a.detach().requires_grad_() for k, a in stacked.items()}
    pipelined = collective_pipeline(
        _stage_fn, mesh, data_axis="data" if "data" in names else None,
        model_axis="model" if "model" in names else None)
    y = pipelined(leaves, x)
    (y ** 2).mean().backward()
    grads = {k: (a.grad.full_tensor() if hasattr(a.grad, "full_tensor")
                 else a.grad) for k, a in leaves.items()}
    if "placements" not in spec:
        # Each rank's gradient holds its stage's slice: sum them.
        import torch.distributed as dist
        for g in grads.values():
            dist.all_reduce(g)
        if "data" in names:
            for g in grads.values():
                g /= mesh.size(names.index("data"))
    return {"y": y.detach().numpy(),
            "grads": {k: g.detach().numpy() for k, g in grads.items()}}


def case_collective_gpt2_tp(rank, spec):
    """GPT-2 (2 layers) over stage 2 x model 2: the loss and the stacked
    blocks' gradients through the PP x TP collective pipeline."""
    from torch.distributed.device_mesh import init_device_mesh

    from tepdist_tpu_torch.models import gpt2

    # The flash op (its plain version here), whose DTensor rule keeps the
    # heads' attention local: the dense path's mask is a plain tensor.
    cfg = dataclasses.replace(gpt2.CONFIGS["test"], n_layer=2, attn="flash")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("stage", "model"))
    params = _to_torch(spec["params"])
    toks = torch.tensor(spec["tokens"])
    embed, stacked = gpt2.shard_stacked_for_stages(params, cfg, mesh,
                                                   model_axis="model")
    split = {k: str(a.placements) for k, a in stacked.items()}
    leaves = {k: a.detach().requires_grad_() for k, a in stacked.items()}
    loss = gpt2.pipelined_loss_fn(embed, leaves, toks, cfg, mesh,
                                  num_micro=2, model_axis="model")
    loss.backward()
    return {"loss": float(loss), "split": split,
            "grads": {k: a.grad.full_tensor().numpy()
                      for k, a in leaves.items()}}


# --------------------------------------------------------------------------
# The parent
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    p = GlooPool(__name__)
    yield p
    p.close()


def _jax_pipeline(model, params, batch, S, M, opt, steps=2, **kw):
    import jax

    from tepdist_tpu.parallel.pipeline import plan_pipeline
    from tepdist_tpu.runtime.executor import PipelineExecutable

    prog = plan_pipeline(_jax_loss(model), S, M, params, *batch)
    exe = PipelineExecutable(prog, devices=jax.devices()[:4],
                             optimizer=_optimizer(opt, "jax"), **kw)
    exe.load_variables(params)
    losses = [exe.step(*batch) for _ in range(steps)]
    return (losses, [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jax.device_get(exe.fetch_variables()))],
        [np.asarray(a) for a in jax.tree_util.tree_leaves(
            jax.device_get(exe.fetch_opt_state()))], exe)


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


CASES = {
    "mlp4_dp2": ("mlp4", 2, 4, "adam", {}),
    "gpt2_dp2": ("gpt2", 2, 2, "sgd", {}),
    "mlp4_tp2": ("mlp4", 2, 4, "adam", {"intra_stage_tp": 2}),
    "gpt2_tp2": ("gpt2", 2, 2, "sgd", {"intra_stage_tp": 2}),
    "interleaved": ("mlp4", 4, 2, "sgd", {"placement": "interleaved",
                                          "interleave_groups": 2}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_group_form_matches_jax(pool, name):
    """Two steps on 4 ranks against the JAX executable with the same
    devices, ``intra_stage_tp`` and placement: S=2 x dp=2 (the MLP with
    adam, GPT-2 with its tied ``wte``), S=2 x tp=2, and 4 virtual stages
    over 2 groups of 2 data replicas."""
    model, S, M, opt, kw = CASES[name]
    params, batch = _np_case(model)
    got = pool.run("pipeline", {"model": model, "params": params,
                                "batch": batch, "S": S, "M": M,
                                "opt": opt, "kw": kw})
    jl, jp, jst, jexe = _jax_pipeline(model, params, batch, S, M, opt, **kw)
    tp = kw.get("intra_stage_tp", 1)
    assert (got["dp"], got["tp"]) == (4 // (S if "placement" not in kw
                                            else 2) // tp, tp)
    assert got["coord"] == (0, 0, 0)
    if tp > 1:
        lr, pr, pa = TP_LOSS_RTOL, TP_PARAM_RTOL, TP_PARAM_ATOL
        # The stage planner split some input over the model axis, as the
        # reference's did on the same graph (its executor logs the count).
        assert sum(got["split"]) > 0, got["split"]
    else:
        lr, pr, pa = LOSS_RTOL, PARAM_RTOL, PARAM_ATOL
    np.testing.assert_allclose(got["losses"], jl, rtol=lr)
    _close(got["params"], jp, pr, pa)
    _close(got["state"], jst, pr, pa)
    assert got["losses"][1] < got["losses"][0]


def test_embedding_backward_partial_on_split_tokens(pool):
    """The repair of ROADMAP C8's second cause: GPT-2's token lookup is
    ``F.embedding``, so DTensor runs its backward as
    ``embedding_dense_backward`` (no ``index_put``, whose propagation
    failed across the cards), and with split token ids the table's
    gradient comes out ``Partial`` (a sum over the ranks, GSPMD's
    scatter-add). At the card's stage x TP shape (1.5B width, seq 1024,
    one row a micro batch, vocab 1001) the gradient equals the one-rank
    gradient within rtol 1e-5, atol 1e-7 (fp32; the sum over ranks only
    reorders it)."""
    got = pool.run("embedding_split_tokens", (1001, 1024, 1600))
    assert "aten.embedding_dense_backward.default" in got["ops"], got["ops"]
    assert not [op for op in got["ops"] if "index_put" in op], got["ops"]
    assert got["placements"] == [("Partial", "sum")], got["placements"]
    np.testing.assert_allclose(got["grad"], got["want"], rtol=1e-5,
                               atol=1e-7)


def test_flash_split_only_where_it_divides(pool):
    """The repair of ROADMAP C8: the flash ops' DTensor rule splits batch x
    head only where the mesh divides it. At 25 batch-heads over 2 ranks
    the rule used to split them unevenly, and the backward's view back to
    the hidden dim raised on the first stage while the other stage waited
    for it (a hang over NCCL). Loss and gradients equal the whole-tensor
    function's."""
    got = pool.run("flash_uneven_split", (25, 64, 16))
    np.testing.assert_allclose(*got["loss"], rtol=1e-5)
    for g, w in got["grads"]:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_zero_tracks_plain_pipeline(pool):
    """S=2 x dp=2 with ZeRO (each replica updates its half of every
    padded flat leaf) against the same plan without ZeRO, two steps."""
    params, batch = _mlp4_data()
    got = pool.run("zero_and_plain", {"model": "mlp4", "params": params,
                                      "batch": batch, "S": 2, "M": 4,
                                      "opt": "adam"})
    z, p = got["zero"], got["plain"]
    assert z["zero"] and not p["zero"]
    np.testing.assert_allclose(z["losses"], p["losses"], rtol=LOSS_RTOL)
    _close(z["params"], p["params"], PARAM_RTOL, PARAM_ATOL)
    _close(z["state"], p["state"], PARAM_RTOL, PARAM_ATOL)


def test_zero_checkpoint_per_shard(pool, tmp_path):
    """A ZeRO pipeline plan on 4 ranks writes its optimizer state as
    per-shard entries (each rank its shards, with the index sidecar): the
    eager plan restores it and takes the next step as the saver did, and
    the JAX package's ``restore_resharded`` reads the shards."""
    from tepdist_tpu.runtime.checkpoint import (
        CheckpointUtil as JaxCheckpointUtil)
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil
    from tepdist_tpu_torch.train import plan_training

    directory = str(tmp_path)
    got = pool.run("checkpoint", directory)
    step_dir = os.path.join(directory, f"step_{2:012d}")
    metas = sorted(f for f in os.listdir(step_dir) if f.endswith(".json"))
    assert metas == [f"worker{r}.meta.json" for r in range(4)]
    params, batch = _mlp4_data()
    eager = plan_training(_torch_mlp4, adam(1e-2),
                          _to_torch({k: v * 0.5 for k, v in params.items()}),
                          *_to_torch(batch), num_micro_batches=4,
                          device="cpu")
    assert eager.restore(directory) == 2
    np.testing.assert_allclose(eager.step(*_to_torch(batch)), got["next"],
                               rtol=LOSS_RTOL)
    whole, _ = CheckpointUtil(directory).restore(2)
    idx, _ = JaxCheckpointUtil(directory).shard_index(2)
    assert idx, "no shard entries"
    for name, ent in idx.items():
        shape = ent["global_shape"]
        halves = [((0, shape[0] // 2),) + tuple((0, d) for d in shape[1:]),
                  ((shape[0] // 2, shape[0]),)
                  + tuple((0, d) for d in shape[1:])]
        shards, _ = JaxCheckpointUtil(directory).restore_resharded(
            {name: halves}, 2)
        np.testing.assert_array_equal(
            np.concatenate(shards[name]), whole[name].numpy())


def test_pipeline_winner_builds_on_four_ranks(pool):
    """``PipelineWinner.build`` on the 4 ranks (2 stages x 2 replicas):
    its trajectory equals the unsharded one (the reference's
    ``tests/test_exploration.py`` bound, rtol 1e-4)."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(1)
    params = {f"w{i}": (rng.standard_normal((32, 32)) * 0.05)
              .astype(np.float32) for i in range(4)}
    x = rng.standard_normal((8, 32)).astype(np.float32)
    y = np.zeros((8, 32), np.float32)
    got = pool.run("winner_build", (params, (x, y), _deep_mlp_loss))
    assert got["dp"] == 2

    def loss(p, x, y):
        h = x
        for i in range(4):
            h = jax.nn.relu(h @ p[f"w{i}"])
        return jnp.mean((h - y) ** 2)

    tx, p = optax.sgd(0.1), params
    s, ref = tx.init(p), []
    for _ in range(3):
        l, g = jax.value_and_grad(loss)(p, x, y)
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
        ref.append(float(l))
    np.testing.assert_allclose(got["losses"], ref, rtol=1e-4)


def test_build_ga_step_zero_tracks_plain_ga(pool):
    """``build_ga_step(zero_dp=4)`` (reduce-scatter, the update on a
    shard, all-gather) over 4 ranks each holding a quarter of the rows:
    its trajectory is the plain GA step's on the whole batch; each
    rank's moments are a quarter of the padded flat leaf; the int8 branch
    stays within 5% of the plain losses and falls."""
    got = pool.run("ga_zero")
    np.testing.assert_allclose(got["fidelity"], got["plain"],
                               rtol=LOSS_RTOL)
    _close(got["fidelity_params"], got["plain_params"], PARAM_RTOL,
           PARAM_ATOL)
    assert got["fidelity_shard"] == [64 * 64 // 4] * 4
    np.testing.assert_allclose(got["int8"], got["plain"], rtol=0.05)
    assert got["int8"][-1] < got["int8"][0]


def _collective_setup(S=4, M=8, mb=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    stacked = {"w": (rng.standard_normal((S, d, d)) * 0.5).astype(np.float32),
               "b": (rng.standard_normal((S, d)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((M, mb, d)).astype(np.float32)
    return stacked, x


def _jax_sequential(stacked, x):
    import jax
    import jax.numpy as jnp

    from tepdist_tpu.ops.collective_pipeline import sequential_reference

    def sf(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    stacked = jax.tree_util.tree_map(jnp.asarray, stacked)
    y = sequential_reference(sf, stacked, x)
    g = jax.grad(lambda p: (sequential_reference(sf, p, x) ** 2).mean())(
        stacked)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("layout", ["stage4", "stage2_data2",
                                    "stage2_model2"])
def test_collective_pipeline_group_form(pool, layout):
    """The collective pipeline's group form: 4 stages over the 4 ranks,
    PP x DP (stage 2 x data 2) and PP x TP (stage 2 x model 2, the weight
    column-split and the bias split over ``model``) against the
    reference's sequential semantics, outputs and gradients."""
    S = 2 if layout != "stage4" else 4
    stacked, x = _collective_setup(S=S, M=4, mb=8)
    spec = {"stacked": stacked, "x": x}
    if layout == "stage4":
        spec.update(shape=(4,), names=("stage",))
    elif layout == "stage2_data2":
        spec.update(shape=(2, 2), names=("stage", "data"))
    else:
        spec.update(shape=(2, 2), names=("stage", "model"),
                    placements={"w": (0, 2), "b": (0, 1)})
    got = pool.run("collective", spec)
    y, g = _jax_sequential(stacked, x)
    np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-6)
    for k in g:
        np.testing.assert_allclose(got["grads"][k], g[k], rtol=1e-4,
                                   atol=1e-6)


def test_collective_gpt2_pp_x_tp_matches_dense(pool):
    """GPT-2 (2 layers) PP x TP in the group form with the automatic
    Megatron placement: the loss equals the dense loss and the stacked
    blocks' gradients the dense gradients on the [S, L/S, ...] layout
    (the reference's ``tests/test_collective_pipeline.py`` bounds)."""
    import jax
    import jax.numpy as jnp

    from tepdist_tpu.models import gpt2 as jgpt2

    cfg = dataclasses.replace(jgpt2.CONFIGS["test"], n_layer=2)
    params = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    toks = np.asarray(jgpt2.fake_batch(cfg, 8, 32))
    got = pool.run("collective_gpt2_tp", {"params": params, "tokens": toks})
    # qkv is row-split at tp=2 (column thirds need tp % 3 == 0), the MLP's
    # up-projection column-split.
    assert "Shard(dim=2)" in got["split"]["attn_qkv_w"]
    assert "Shard(dim=3)" in got["split"]["mlp_fc_w"]
    dense = float(jgpt2.loss_fn(params, toks, cfg))
    np.testing.assert_allclose(got["loss"], dense, rtol=2e-5)
    gd = jax.grad(lambda p: jgpt2.loss_fn(p, toks, cfg))(params)
    for k, gs in got["grads"].items():
        want = np.stack([np.asarray(gd[f"h{i}"][k])
                         for i in range(cfg.n_layer)]).reshape(gs.shape)
        np.testing.assert_allclose(gs, want, rtol=2e-4, atol=1e-6)
