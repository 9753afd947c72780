"""The port's sequence parallelism in the process-group form, on four CPU
ranks: the ring and Ulysses over a ``gloo`` group, and the ``seq`` axis
of the SPMD planner lowered onto DTensor, held to one device.

One pool of 4 ``gloo`` ranks (spawned processes, one torch thread each)
serves every case of this file, as in ``tests/test_torch_spmd_dist.py``:
the parent sends a case name, each rank runs it, and rank 0 sends back
what the parent asserts.

Tolerances: the ring and Ulysses against whole-sequence attention on one
device in fp32, 2e-5 (outputs and LSEs) and 1e-4 (grads), the JAX
package's own bounds for its ring (``tests/test_sequence_parallel.py``);
the planned steps against the eager plan at the reference's sharded
tolerances (``tests/test_torch_spmd_dist.py``: loss rtol 1e-5), and the
rewritten forward against the dense loss at 2e-5 (the reference's
``tests/test_seq_planner.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_gloo_pool import WORLD, GlooPool

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# Cases (run on every rank; rank 0's return value goes to the parent)
# --------------------------------------------------------------------------

def _qkv(seed=0, B=2, H=4, T=64, D=16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, T, D, generator=g) for _ in range(4)]


def case_ring_and_ulysses(rank, arg):
    """Each rank holds its [B, H, T/4, D] block; the ring (both inners,
    causal and full, with the LSE) and Ulysses (dense and flash inner)
    over the group against whole-sequence attention on one device,
    forward and grads."""
    import torch.distributed as dist

    from tepdist_tpu_torch.ops.ring_attention import (reference_attention_lse,
                                                      ring_attention)
    from tepdist_tpu_torch.ops.ulysses import ulysses_attention

    group = dist.group.WORLD
    out = {}
    for causal in (True, False):
        q, k, v, do = _qkv(1)
        o_ref, lse_ref = reference_attention_lse(
            *(x.requires_grad_() for x in (q, k, v)), causal)
        g_ref_o = torch.autograd.grad((o_ref * do).sum(), (q, k, v),
                                      retain_graph=True)
        g_ref = torch.autograd.grad(
            (o_ref * do).sum() + lse_ref.sum(), (q, k, v))
        Tl = q.shape[2] // WORLD

        def mine(x):
            return x[:, :, rank * Tl:(rank + 1) * Tl].detach().clone()

        runs = {
            "ring_einsum": lambda a, b, c: (ring_attention(
                a, b, c, group, causal=causal), None),
            "ring_flash": lambda a, b, c: ring_attention(
                a, b, c, group, causal=causal, inner="flash",
                return_lse=True),
            "ulysses": lambda a, b, c: (ulysses_attention(
                a, b, c, group, causal=causal), None),
            "ulysses_flash": lambda a, b, c: ulysses_attention(
                a, b, c, group, causal=causal, return_lse=True),
        }
        for name, fn in runs.items():
            ql, kl, vl = (mine(x).requires_grad_() for x in (q, k, v))
            o, lse = fn(ql, kl, vl)
            loss = (o * mine(do)).sum() + (lse.sum() if lse is not None
                                           else 0.0)
            grads = torch.autograd.grad(loss, (ql, kl, vl))
            # Without the LSE term: the reference grads of o alone.
            want_g = [mine(g) for g in (g_ref if lse is not None
                                        else g_ref_o)]
            err = {"o": (o - mine(o_ref)).abs().max().item(),
                   "grads": max((a - b).abs().max().item()
                                for a, b in zip(grads, want_g))}
            if lse is not None:
                err["lse"] = (lse - mine(lse_ref)).abs().max().item()
            errs = [None] * WORLD
            dist.all_gather_object(errs, err)
            out[f"{name}-{'causal' if causal else 'full'}"] = errs
    return out


def _gpt2(T=32):
    from tepdist_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], attn="flash")
    params = gpt2.init_params(cfg, seed=2, device="cpu")
    toks = gpt2.fake_batch(cfg, 4, T, seed=3, device="cpu")
    return cfg, params, toks


def case_auto_parallel_direct_seq_flash(rank, arg):
    """``auto_parallel`` called directly on a flash forward with a seq 4
    topology rewrites the motifs into sequence ops and lowers them (the
    reference's ``test_auto_parallel_direct_seq_topology_rewrites_flash``)."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel

    cfg, params, toks = _gpt2()

    def fwd(p, t):
        return gpt2.loss_fn(p, t, cfg)

    plan = auto_parallel(fwd, MeshTopology([("seq", 4)]), params, toks)
    out = plan.step(params, toks)
    return {"seq_ops": plan.graph.count("seq_attn"),
            "flash_nodes": plan.graph.count("flash_fwd"),
            "loss": (float(out.full_tensor()), float(fwd(params, toks))),
            "status": [g.ilp_status for g in plan.strategies]}


def case_partial_factors(rank, arg):
    """A product of two partial sums: reduced first over a ``seq`` mesh
    dimension, left to DTensor's rule over any other. The value is one
    whose partial sums cancel, as a key bias's gradient under a sequence
    split: zero in exact arithmetic, partial sums of +-1e8."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial

    from tepdist_tpu_torch.parallel.spmd_transform import (
        reduce_seq_partial_factors)

    local = torch.tensor([1e8, 1.0, -3.0]) * (1 if rank % 2 else -1)
    out = {}
    for name in ("seq", "data"):
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=(name,))
        x = DTensor.from_local(local, mesh, [Partial()], run_check=False)
        args = reduce_seq_partial_factors(mesh, torch.ops.aten.mul.Tensor,
                                          (x, x))
        sq = torch.ops.aten.mul.Tensor(*args)
        out[name] = {"same": all(a is x for a in args),
                     "replicated": all(p.is_replicate() for a in args
                                       for p in a.placements),
                     "square": sq.full_tensor().tolist(),
                     "others": reduce_seq_partial_factors(
                         mesh, torch.ops.aten.add.Tensor, (x, x))[0] is x}
    dist.barrier()
    return out


def _train(topology, steps=3):
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.train import plan_training

    cfg, params, toks = _gpt2()
    plan = plan_training(
        lambda p, t: gpt2.loss_fn(p, t, cfg), adam(1e-2), params, toks,
        num_micro_batches=1, device="cpu",
        topology=MeshTopology(topology) if topology else None)
    losses = [plan.step(toks) for _ in range(steps)]
    return plan, losses, toks


def case_plan_training_seq(rank, arg):
    """3 steps of ``plan_training(topology=...)`` with a seq axis against
    the eager plan, and the ring's operands in one lowered step: no
    all-gather of the sequence op's q, k or v (its node is no involuntary
    remat), and all-gathers counted beside the op count."""
    from torch.distributed.tensor.debug import CommDebugMode

    eager = _train(None)[1]
    plan, losses, toks = _train(arg)
    pp = plan.parallel_plan
    seq_ops = [n for n in pp.graph.nodes
               if n.prim in ("seq_attn", "seq_attn_bwd")]
    remats = plan.involuntary_remats(toks)
    with CommDebugMode() as comm:
        plan.step(toks)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return {"losses": losses, "eager": eager,
            "seq_ops": [n.prim for n in seq_ops],
            "seq_op_names": [n.eqn.name for n in seq_ops],
            "remats": remats, "comm": counts,
            "status": [g.ilp_status for g in pp.strategies],
            "flash_nodes": pp.graph.count("flash_fwd")}


def case_rewritten_grads(rank, impl):
    """``auto_parallel`` of the gradient of a loss rewritten with ``impl``
    ("ring" or "ulysses") on seq 4: the loss and every gradient against
    the dense loss's on one device, and no sequence op among the nodes
    that all-gathered a split operand."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.parallel.attention_motif import seq_rewritten_loss
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.train import value_and_grad

    cfg, params, toks = _gpt2()

    def loss(p, t):
        return gpt2.loss_fn(p, t, cfg)

    rw, _ = seq_rewritten_loss(loss, 4, params, toks, impl=impl)
    plan = auto_parallel(value_and_grad(rw), MeshTopology([("seq", 4)]),
                         params, toks)
    got_loss, got = plan.step(params, toks)
    want_loss, want = value_and_grad(loss)(params, toks)
    remats = plan.lowering_diagnostics([*tree_leaves(params), toks], "cpu")
    seq_ops = [n.eqn.name for n in plan.graph.nodes
               if n.prim in ("seq_attn", "seq_attn_bwd")]
    return {"loss": (float(got_loss.full_tensor()), float(want_loss)),
            "grads": [(a.full_tensor().numpy(), b.numpy())
                      for a, b in zip(tree_leaves(got), tree_leaves(want))],
            "impls": sorted({str(n.args[6]) for n in plan.graph.nodes
                             if n.prim == "seq_attn"}),
            "remats": remats, "seq_ops": seq_ops}


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(__name__)
    yield p
    p.close()


def test_ring_and_ulysses_over_a_group_equal_one_device(pool):
    res = pool.run("ring_and_ulysses")
    assert len(res) == 8
    for name, per_rank in res.items():
        for err in per_rank:
            assert err["o"] <= 2e-5, (name, err)
            assert err["grads"] <= 1e-4, (name, err)
            assert err.get("lse", 0.0) <= 2e-5, (name, err)


def test_auto_parallel_direct_seq_topology_rewrites_flash(pool):
    res = pool.run("auto_parallel_direct_seq_flash")
    assert res["seq_ops"] == 2 and res["flash_nodes"] == 0
    got, want = res["loss"]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert res["status"][0].startswith("seq-")


@pytest.mark.parametrize("topology", [[("seq", 4)],
                                      [("data", 2), ("seq", 2)]],
                         ids=["seq4", "data2xseq2"])
def test_plan_training_with_a_seq_axis_tracks_the_eager_plan(pool,
                                                             topology):
    res = pool.run("plan_training_seq", topology)
    np.testing.assert_allclose(res["losses"], res["eager"], rtol=1e-5)
    assert res["losses"][-1] < res["losses"][0]
    # The rewrite replaced both layers' flash forward: one ring forward
    # and one reverse ring a layer, no flash op left in the step.
    assert sorted(res["seq_ops"]) == ["seq_attn"] * 2 + ["seq_attn_bwd"] * 2
    assert res["flash_nodes"] == 0
    # No silent gather: no sequence op all-gathered an operand.
    assert not set(res["remats"]) & set(res["seq_op_names"]), res["remats"]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_rewritten_gradient_on_seq4_equals_one_device(pool, impl):
    res = pool.run("rewritten_grads", impl)
    got, want = res["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in res["grads"]:
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert res["impls"] == [impl]
    assert len(res["seq_ops"]) == 4
    assert not set(res["remats"]) & set(res["seq_ops"]), res["remats"]


def test_seq_partial_factors_are_reduced_and_data_ones_are_not(pool):
    res = pool.run("partial_factors")
    seq, data = res["seq"], res["data"]
    assert not seq["same"] and seq["replicated"]
    assert seq["square"] == [0.0, 0.0, 0.0]
    # Another mesh dimension, and any op but a product, keep DTensor's
    # rule: the operands come back as they were.
    assert data["same"] and seq["others"] and data["others"]
