"""The port's multi-host SPMD service (``client/multihost.py`` and a
multi-rank ``rpc/server.py``) held to the JAX package's service.

Four ranks of one ``gloo`` world (the file's pool, ``tests/torch_gloo_pool.py``)
each serve gRPC with one ``TepdistServicer`` on the world; a
``MultiHostSession`` in the parent broadcasts every verb to the four, so
each rank runs the same DTensor step and its collectives meet over the
world (rank 0 plans and broadcasts). The reference is the JAX package's
server planning ``("data", 4)`` in one process on 4 of its virtual CPU
devices, driven by the JAX ``MultiHostSession``: the JAX package's own
multi-host test (``tests/test_multihost_spmd.py``) is marked xfail on
this jaxlib, whose CPU backend refuses programs across processes, so the
single-process server is the reference that runs here. Same numpy
weights and batches; losses within rtol 1e-5, parameters within atol
1e-5 (fp32: a data-parallel mean reorders the gradient sum).
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tepdist_tpu_torch import convert

torch.set_num_threads(2)

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
_SERVER = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def case_serve(rank, ports):
    """Each rank serves gRPC on ``ports[rank]`` over the pool's world."""
    from tepdist_tpu_torch.rpc.server import create_server

    server, servicer, _ = create_server(ports[rank], devices=["cpu"],
                                        task_index=rank)
    server.start()
    _SERVER.update(server=server, servicer=servicer)
    return True


def case_remats(rank, arg):
    """The plan's involuntary remats on this rank's servicer (one
    diagnostic run of the step, nothing updated), with the graph's
    ``index_put`` nodes."""
    from tepdist_tpu_torch.parallel.lowering_check import involuntary_remats

    handle, batch, n_state = arg
    sv = _SERVER["servicer"]
    plan = sv.plan_cache.resolve(handle)
    args = [plan.place(i, sv.variables[i]) for i in range(n_state)]
    args += [plan.place(n_state + j, torch.as_tensor(b))
             for j, b in enumerate(batch)]
    names = involuntary_remats(plan.exe, args)
    targets = {n.name: str(n.target) for n in plan.exe.gm.graph.nodes
               if n.op == "call_function"}
    return {"remats": [targets[n] for n in names],
            "index_put": [t for t in targets.values() if "index_put" in t],
            "embedding_bwd": [t for t in targets.values()
                              if "embedding_dense_backward" in t]}


@pytest.fixture(scope="module")
def addresses():
    from torch_gloo_pool import GlooPool

    from tepdist_tpu_torch.rpc.client import TepdistClient

    pool = GlooPool("test_torch_multihost")
    ports = [_free_port() for _ in range(4)]
    pool.run("serve", ports)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    for a in addrs:
        c = TepdistClient(a)
        c.wait_ready(60)
        c.close()
    yield pool, addrs
    pool.close()


def _mlp_np(batch=16, d=32):
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((d, 64)) * 0.2).astype(np.float32),
              "w2": (rng.standard_normal((64, d)) * 0.2).astype(np.float32)}
    x = rng.standard_normal((batch, d)).astype(np.float32)
    y = rng.standard_normal((batch, d)).astype(np.float32)
    return params, (x, y)


def _torch_mlp(p, x, y):
    return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()


def _jax_mlp(p, x, y):
    return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)


def _jax_service(loss, params, batch, steps, lr=1e-2):
    """The JAX package's server planning ("data", 4) over 4 virtual CPU
    devices in one process, through its MultiHostSession."""
    from tepdist_tpu.client.multihost import MultiHostSession as JaxMH
    from tepdist_tpu.rpc import inproc as jinproc
    from tepdist_tpu.rpc.server import TepdistServicer as JaxServicer

    tx = optax.adam(lr)

    def step(p, s, *b):
        l, g = jax.value_and_grad(loss)(p, *b)
        u, s = tx.update(g, s, p)
        return l, optax.apply_updates(p, u), s

    address = "inproc:7301"
    jinproc.register_servicer(address, JaxServicer(jax.devices()[:4]))
    sess = JaxMH([address], mesh_axes=[("data", 4)])
    try:
        sess.compile_train_step(step, params, tx.init(params), *batch)
        losses = [sess.run(*batch) for _ in range(steps)]
        state = sess.variables()
    finally:
        sess.close()
        jinproc.unregister_servicer(address)
    return losses, jax.device_get(state[0])


def _port_service(addrs, loss, params, batch, steps, lr=1e-2,
                  mesh_axes=(("data", 4),)):
    from tepdist_tpu_torch.client.multihost import MultiHostSession
    from tepdist_tpu_torch.optim import adam

    sess = MultiHostSession(addrs, mesh_axes=list(mesh_axes))
    try:
        summary = sess.compile_training(
            loss, adam(lr), convert.to_torch(params, device="cpu"),
            *convert.to_torch(batch, device="cpu"))
        tb = convert.to_torch(batch, device="cpu")
        losses = [sess.run(*tb) for _ in range(steps)]
        return losses, sess.variables()[0], summary, sess.handle, \
            sess._n_state
    finally:
        sess.close()


def _close(got, want, atol=PARAM_ATOL):
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], atol)
            continue
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)


def test_multihost_mlp_matches_jax_service(addresses):
    """The MLP (adam), 3 steps on ("data", 4) across the 4 ranks."""
    _, addrs = addresses
    params, batch = _mlp_np()
    tl, tp, summary, _, _ = _port_service(addrs, _torch_mlp, params,
                                          batch, 3)
    jl, jp = _jax_service(_jax_mlp, params, batch, 3)
    assert summary["axes"] == [["data", 4]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(tp, jp)
    assert tl[-1] < tl[0]


def test_multihost_default_mesh_spans_the_world(addresses):
    """With no mesh axes a multi-rank server plans ``data`` over every
    rank of its world (the JAX server's default mesh spans every
    process's devices), not over the one device each rank holds."""
    _, addrs = addresses
    params, batch = _mlp_np()
    tl, _, summary, _, _ = _port_service(addrs, _torch_mlp, params, batch,
                                         2, mesh_axes=())
    jl, _ = _jax_service(_jax_mlp, params, batch, 2)
    assert summary["axes"] == [["data", 4]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_multihost_gpt2_matches_jax_service(addresses):
    """GPT-2 ``test`` (fp32, einsum attention, adam 1e-3), 3 steps on
    ("data", 4): the losses and weights of the JAX service (weights within
    atol 2e-5, ``tests/test_torch_rpc.py``'s bound for this model: Adam
    turns the reordered sums of near-zero gradients into whole steps of
    the rate); no
    ``index_put`` in the step's graph (the embedding backward is
    ``embedding_dense_backward``, ROADMAP C8) and none among the ops
    whose split operands DTensor gathered."""
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2

    pool, addrs = addresses
    jcfg = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32)
    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32)
    params = jax.device_get(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(jcfg, 8, 32, seed=3))
    tl, tp, _, handle, n_state = _port_service(
        addrs, lambda p, t: gpt2.loss_fn(p, t, cfg), params, (tokens,), 3,
        lr=1e-3)
    jl, jp = _jax_service(lambda p, t: jgpt2.loss_fn(p, t, jcfg), params,
                          (tokens,), 3, lr=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(tp, jp, atol=2e-5)
    got = pool.run("remats", (handle, [tokens], n_state))
    assert got["embedding_bwd"] and not got["index_put"], got
    assert not [t for t in got["remats"] if "index_put" in t], got


def test_recompose_step_for_a_seq_winner():
    """A seq explore winner's step is composed again on the server
    (``TepdistServicer._recompose_step``): from the shipped loss graph,
    with the optimizer of the client's spec, its attention rewritten into
    the sequence ops (one forward and one reverse op a layer, no flash
    op left); on a mesh with no ``seq`` axis the composed step's loss is
    the eager loss."""
    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.graph.fx_graph import FxGraph, trace_graph
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.rpc.server import TepdistServicer, _LossGraphs

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], attn="flash",
                              dtype=torch.float32)
    params = gpt2.init_params(cfg, seed=0, device="cpu")
    tokens = gpt2.fake_batch(cfg, 2, 32, seed=1, device="cpu")
    plist = list(tree_leaves(params))
    tree = params

    def loss(pl, t):
        from tepdist_tpu_torch.core.tree import (tree_structure,
                                                 tree_unflatten)
        return gpt2.loss_fn(tree_unflatten(tree_structure(tree), pl), t,
                            cfg)

    graph, _, _ = trace_graph(loss, plist, tokens)
    shipped = _LossGraphs([graph.gm], len(plist))
    opt = adam(1e-3)
    n_state = len(plist) + len(tree_leaves(opt.init(plist)))
    sv = TepdistServicer(["cpu"])
    seq_gm = sv._recompose_step(shipped, opt, 1, MeshTopology([("seq", 2)]),
                                plist, [tokens], n_state)
    g = FxGraph(seq_gm)
    assert g.count("seq_attn") == g.count("seq_attn_bwd") == cfg.n_layer
    assert g.count("flash_fwd") == 0
    gm = sv._recompose_step(shipped, opt, 1, MeshTopology([("data", 1)]),
                            plist, [tokens], n_state)
    state = tree_leaves(opt.init(plist))
    got = gm(*[p.clone() for p in plist], *state, tokens)[0]
    np.testing.assert_allclose(float(got), float(loss(plist, tokens)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="optimizer_spec"):
        sv._recompose_step(shipped, opt, 1, MeshTopology([("data", 1)]),
                           plist, [tokens], n_state + 1)
