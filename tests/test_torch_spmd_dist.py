"""The port's SPMD lowering on four CPU ranks: sharded numerics held to
the port's single-device numerics.

One pool of 4 ``gloo`` ranks (spawned processes, one torch thread each)
serves every case of this file: the parent sends a case name, each rank
runs it on its own DTensors over a ``torch.distributed`` device mesh, and
rank 0 sends back what the parent asserts. The plans are made by the
port's planner from the captured graph (``auto_parallel``,
``plan_training(topology=...)``), then run by the fx interpreter on
DTensors: the port's counterpart of the reference's 8-device virtual CPU
mesh (``tests/conftest.py``).

Tolerances are the reference's for sharded against unsharded numerics
(``tests/test_auto_parallel.py:35-56``): loss rtol 1e-5, grads rtol 1e-4
and atol 1e-6. The flash ops run their plain versions on the CPU, so the
GPT-2 cases exercise their DTensor sharding rule. The int8 plan is held
to the fidelity plan at its first step (the loss before any update,
rtol 1e-5) and within 1% after; the sharded fill and the checkpoint
restore equal the full tensors slice for slice.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from torch_gloo_pool import GlooPool

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# Cases (run on every rank; rank 0's return value goes to the parent)
# --------------------------------------------------------------------------

def _mlp():
    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(64, 128, generator=g) * 0.1,
              "w2": torch.randn(128, 32, generator=g) * 0.1}
    x = torch.randn(256, 64, generator=g)
    return params, x, torch.ones(256, 32)


def _mlp_loss(p, x, y):
    return ((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()


def _gpt2():
    from tepdist_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], attn="flash")
    params = gpt2.init_params(cfg, seed=0, device="cpu")
    toks = gpt2.fake_batch(cfg, 32, 32, seed=1, device="cpu")
    return (lambda p, t: gpt2.loss_fn(p, t, cfg)), params, toks


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _grad_case(loss_fn, params, batch, axes):
    """auto_parallel of value_and_grad(loss_fn) over ``axes``: the
    sharded loss and grads against the single-device ones."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.train import value_and_grad

    fn = value_and_grad(loss_fn)
    plan = auto_parallel(fn, MeshTopology(axes), params, *batch)
    loss, grads = plan.step(params, *batch)
    want_loss, want_grads = fn(params, *batch)
    got = [_full(g) for g in tree_leaves(grads)]
    want = tree_leaves(want_grads)
    placements = [str(p) for p in plan.sharding_plan.in_specs]
    return {"loss": (float(_full(loss)), float(want_loss)),
            "grads": [(a.numpy(), b.numpy()) for a, b in zip(got, want)],
            "placements": placements,
            "status": [g.ilp_status for g in plan.strategies]}


def case_mlp_data4(rank, arg):
    p, x, y = _mlp()
    return _grad_case(_mlp_loss, p, (x, y), [("data", 4)])


def case_mlp_data2_model2(rank, arg):
    p, x, y = _mlp()
    return _grad_case(_mlp_loss, p, (x, y), [("data", 2), ("model", 2)])


def case_gpt2_flash_data4(rank, arg):
    loss, p, toks = _gpt2()
    return _grad_case(loss, p, (toks,), [("data", 4)])


def case_gpt2_flash_data2_model2(rank, arg):
    loss, p, toks = _gpt2()
    return _grad_case(loss, p, (toks,), [("data", 2), ("model", 2)])


def _train(topology, zero=False, comm_dtype="", steps=3):
    """Losses and final state of ``steps`` GPT-2 ``test`` (flash, full
    remat, chunked loss) steps; ``topology`` None is the eager plan."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw_bf16
    from tepdist_tpu_torch.parallel.sync_free import build_ga_step
    from tepdist_tpu_torch.train import (_plan_spmd, _remat, plan_training,
                                         value_and_grad)

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], attn="flash",
                              remat=True, loss_chunk=16)
    params = gpt2.stacked_init_params(cfg, seed=0, device="cpu")
    toks = gpt2.fake_batch(cfg, 8, 32, seed=1, device="cpu")
    loss_fn = lambda p, t: gpt2.loss_fn_stacked(p, t, cfg)  # noqa: E731
    opt = adamw_bf16(1e-3)
    if topology is None or not (zero or comm_dtype):
        plan = plan_training(
            loss_fn, opt, params, toks, num_micro_batches=1, device="cpu",
            topology=MeshTopology(topology) if topology else None)
    else:
        step = build_ga_step(
            value_and_grad(_remat(loss_fn)),
            lambda p, s, g: (p, opt.apply(p, g, s)), 1,
            comm_dtype=comm_dtype)
        plan = _plan_spmd(step, params, opt.init(params), (toks,),
                          torch.device("cpu"), MeshTopology(topology), None,
                          None, None, None, zero, None)
    losses = [plan.step(toks) for _ in range(steps)]
    state = [t.numpy().astype(np.float32) if t.dtype != torch.bfloat16
             else t.float().numpy()
             for t in tree_leaves(plan.variables())]
    out = {"losses": losses, "state": state}
    if topology:
        out["state_placements"] = [str(t.placements)
                                   for t in plan._device_state()]
        out["remats"] = plan.involuntary_remats(toks)
    return out


_DP = {}


def _dp():
    """The plain data-parallel run, made once per rank."""
    if not _DP:
        _DP.update(_train([("data", 4)]))
    return _DP


def case_plan_training_data4(rank, arg):
    return {"spmd": _dp(), "eager": _train(None)}


def _mlp_plan(zero, seed=0):
    """The reference ZeRO test's setup (``tests/test_zero.py``: tanh MLP,
    adam(0.02)) as a data=4 SPMD plan, with or without ZeRO."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.sync_free import build_ga_step
    from tepdist_tpu_torch.train import _plan_spmd, value_and_grad

    g = torch.Generator().manual_seed(seed)
    params = {"w1": torch.randn(32, 64, generator=g) * 0.1,
              "w2": torch.randn(64, 8, generator=g) * 0.1}
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(16, 32, generator=g), torch.randn(16, 8, generator=g)

    def loss_fn(p, x, y):
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    opt = adam(0.02)
    step = build_ga_step(value_and_grad(loss_fn),
                         lambda p, s, g: (p, opt.apply(p, g, s)), 1,
                         batch_argnums=(1, 2))
    plan = _plan_spmd(step, params, opt.init(params), (x, y),
                      torch.device("cpu"), MeshTopology([("data", 4)]),
                      None, None, None, None, zero, None)
    return plan, params, (x, y)


def case_checkpoint_round_trip(rank, directory):
    """A ZeRO plan saves after 2 steps; a plan from other weights restores
    it and takes step 3 as the first plan does, bit for bit."""
    import torch.distributed as dist

    plan, _, batch = _mlp_plan(True)
    for _ in range(2):
        plan.step(*batch)
    plan.save(directory, 2)
    dist.barrier()
    want = plan.step(*batch)
    other, _, _ = _mlp_plan(True, seed=1)
    got_step = other.restore(directory)
    return {"step": got_step, "losses": (other.step(*batch), want)}


def _zero_run(zero, steps=8):
    """``steps`` steps of ``_mlp_plan``: the reference ZeRO test runs 8."""
    from tepdist_tpu_torch.core.tree import tree_leaves

    plan, params, batch = _mlp_plan(zero)
    losses = [plan.step(*batch) for _ in range(steps)]
    p, _ = plan.variables()
    n = len(tree_leaves(params))
    return {"losses": losses,
            "params": [t.numpy() for t in tree_leaves(p)],
            "opt_state_placements": [str(t.placements)
                                     for t in plan._device_state()[n:]
                                     if t.ndim >= 1]}


def case_zero_tracks_dp(rank, arg):
    return {"zero": _zero_run(True), "dp": _zero_run(False)}


def case_int8_plan(rank, arg):
    return {"int8": _train([("data", 4)], comm_dtype="int8"), "dp": _dp()}


def case_sharded_fill(rank, arg):
    """The sharded fill equals the full fill, slice for slice."""
    from torch.distributed.tensor import Shard
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.runtime.initializers import (
        init_from_spec, shard_consistent_init)

    ok = []
    for axes, placements in (([("data", 4)], [Shard(0)]),
                             ([("data", 4)], [Shard(1)]),
                             ([("data", 2), ("model", 2)],
                              [Shard(0), Shard(1)]),
                             ([("data", 2), ("model", 2)],
                              [Shard(1), Shard(1)])):
        mesh = MeshTopology(axes).to_device_mesh("cpu")
        for dist_name in ("normal", "uniform", "truncated_normal"):
            full = shard_consistent_init(7, (12, 16), distribution=dist_name,
                                         device="cpu")
            dt = shard_consistent_init(7, (12, 16), mesh=mesh,
                                       placements=placements,
                                       distribution=dist_name)
            ok.append(torch.equal(dt.full_tensor(), full))
        spec = {"shape": [8, 6], "fan_in_scaling": True, "scale": 2.0}
        ok.append(torch.equal(
            init_from_spec(3, spec, mesh, placements).full_tensor(),
            init_from_spec(3, spec, device="cpu")))
    return ok


def case_restore_sharded(rank, directory):
    """save_sharded then restore_sharded onto target placements; and a
    leaf saved as shards (the JAX package's layout: ``::shard`` entries
    with a meta sidecar) landed on a different split."""
    import json

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.runtime.checkpoint import (restore_sharded,
                                                      save_sharded)

    g = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn(8, 12, generator=g),
            "b": torch.randn(12, generator=g).bfloat16(),
            "c": torch.arange(16, dtype=torch.int32).reshape(4, 4)}
    if rank == 0:
        treedef = save_sharded(directory, 3, tree)
        # Rewrite leaf "a" as four row shards of two workers' files.
        step_dir = os.path.join(directory, f"step_{3:012d}")
        for w, rows in ((0, (0, 4)), (1, (4, 8))):
            path = os.path.join(step_dir, f"worker{w}.npz")
            data = dict(np.load(path)) if w == 0 else {}
            data.pop("0", None)
            meta = {}
            for j, (lo, hi) in enumerate(((rows[0], rows[0] + 2),
                                          (rows[0] + 2, rows[1]))):
                key = f"0::shard{j}"
                data[key] = tree["a"][lo:hi].numpy()
                meta[key] = {"of": "0", "global_shape": [8, 12],
                             "index": [[lo, hi], [0, 12]]}
            np.savez(path, **data)
            with open(os.path.join(step_dir, f"worker{w}.meta.json"),
                      "w") as f:
                json.dump(meta, f)
    dist.barrier()
    from tepdist_tpu_torch.core.tree import tree_leaves, tree_structure
    treedef = tree_structure(tree)
    mesh = MeshTopology([("data", 2), ("model", 2)]).to_device_mesh("cpu")
    got, step = restore_sharded(
        directory, treedef, mesh=mesh,
        placements=[[Shard(1), Shard(0)], [Shard(0), Replicate()],
                    [Replicate(), Shard(1)]])
    ok = [step == 3]
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        ok.append(torch.equal(a.full_tensor(), b))
        ok.append(a.to_local().shape != b.shape)   # really split
    plain, _ = restore_sharded(directory, treedef, device="cpu")
    ok += [torch.equal(a, b) for a, b in zip(tree_leaves(plain),
                                             tree_leaves(tree))]
    return ok


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(__name__)
    yield p
    p.close()


def _close(pairs, rtol, atol):
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["mlp_data4", "mlp_data2_model2",
                                  "gpt2_flash_data4",
                                  "gpt2_flash_data2_model2"])
def test_sharded_grads_equal_single_device(pool, name):
    res = pool.run(name)
    got, want = res["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close(res["grads"], rtol=1e-4, atol=1e-6)
    assert set(res["status"]) <= {"ilp", "greedy"}
    # The batch input goes in split on dim 0 over the data axis.
    assert res["placements"][-1].startswith("(Shard(dim=0)"), res[
        "placements"]


def test_plan_training_on_four_ranks_equals_one_device(pool):
    res = pool.run("plan_training_data4")
    np.testing.assert_allclose(res["spmd"]["losses"], res["eager"]["losses"],
                               rtol=1e-5)
    assert res["spmd"]["losses"][-1] < res["spmd"]["losses"][0]
    assert res["spmd"]["remats"] == [] or all(
        isinstance(r, str) for r in res["spmd"]["remats"])


def test_zero_plan_tracks_plain_dp(pool):
    """ZeRO on the SPMD path is placements only: the optimizer state is
    split over data and the trajectory is plain data parallelism's, at
    the tolerances of the reference's ZeRO test (C2's first test,
    ``tests/test_zero.py``, on its model and optimizer): losses rtol 1e-4,
    params rtol 2e-4 and atol 1e-6."""
    res = pool.run("zero_tracks_dp")
    np.testing.assert_allclose(res["zero"]["losses"], res["dp"]["losses"],
                               rtol=1e-4)
    assert res["zero"]["losses"][-1] < res["zero"]["losses"][0]
    _close(zip(res["zero"]["params"], res["dp"]["params"]), rtol=2e-4,
           atol=1e-6)
    # Every moment leaf is split over data.
    assert res["zero"]["opt_state_placements"]
    assert all("Shard" in p for p in res["zero"]["opt_state_placements"])


def test_int8_plan_runs_beside_fidelity(pool):
    res = pool.run("int8_plan")
    got, want = res["int8"]["losses"], res["dp"]["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert got != want


def test_spmd_plan_checkpoint_round_trip(pool):
    with tempfile.TemporaryDirectory() as d:
        res = pool.run("checkpoint_round_trip", d)
    assert res["step"] == 2
    got, want = res["losses"]
    assert got == want


def test_sharded_fill_equals_full_fill(pool):
    assert all(pool.run("sharded_fill"))


def test_restore_sharded_onto_target_placements(pool):
    with tempfile.TemporaryDirectory() as d:
        assert all(pool.run("restore_sharded", d))
