"""The port's service (``tepdist_tpu_torch/rpc/server.py``, ``rpc/client.py``,
``client/session.py``) held to the JAX package's: the counterparts of
``tests/test_rpc.py`` and ``tests/test_rpc_explore.py``.

One port server runs as a subprocess over gRPC for the module
(``python -m tepdist_tpu_torch.rpc.server --device cpu``, the reference's
pattern: a real server binary on a free port, SIGKILL in teardown);
the other cases drive in-process servicers through ``inproc:``
addresses. Inputs are numpy draws (or the JAX package's initializers),
and each trajectory is held to the JAX package's on the same inputs at
the reference test's own tolerance. The slice as a whole: GPT-2 ``test``
(fp32, flash, adamw, M = 2) trained 3 steps through the port's session
and server and through the JAX session and servicer, from the same
weights: losses within rtol 1e-5 and every fetched parameter within atol
2e-5 (``tests/test_torch_train.py``'s bounds for the same model).
"""

import dataclasses
import itertools
import os
import signal
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tepdist_tpu_torch import convert
from tepdist_tpu_torch.client.session import TepdistSession
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.optim import adam, adamw, optimizer_spec, sgd
from tepdist_tpu_torch.rpc import inproc, protocol, retry
from tepdist_tpu_torch.rpc.client import TepdistClient
from tepdist_tpu_torch.rpc.server import LATER_VERBS, TepdistServicer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORTS = itertools.count(7000)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server():
    port = _free_port()
    env = dict(os.environ)
    env["TEPDIST_CKPT_DIR"] = tempfile.mkdtemp(prefix="tepdist_torch_ckpt_")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tepdist_tpu_torch.rpc.server",
         "--port", str(port), "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
    client = TepdistClient(f"127.0.0.1:{port}")
    try:
        client.wait_ready(timeout=60.0)
    except Exception:
        proc.kill()
        raise RuntimeError("server failed to start:\n"
                           + proc.stdout.read().decode())
    client.close()
    yield f"127.0.0.1:{port}"
    proc.send_signal(signal.SIGKILL)
    proc.wait()


def _servicer(devices=("cpu",)):
    """A port servicer on ``devices`` behind a fresh ``inproc:`` address."""
    address = f"inproc:{next(_PORTS)}"
    servicer = TepdistServicer(list(devices))
    inproc.register_servicer(address, servicer)
    return address, servicer


# -- models (numpy inputs) -------------------------------------------------

def _mlp_np(batch=64, din=32, dh=64, dout=8):
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((din, dh)) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((dh, dout)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((batch, din)).astype(np.float32)
    y = rng.standard_normal((batch, dout)).astype(np.float32)
    return params, x, y


def _t(tree):
    return convert.to_torch(tree, device="cpu")


def _torch_mlp_loss(p, x, y):
    return ((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()


def _jax_mlp_loss(p, x, y):
    return jnp.mean((jax.nn.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)


def _torch_step(opt, loss=_torch_mlp_loss):
    from tepdist_tpu_torch.train import value_and_grad

    def step(params, state, *batch):
        l, g = value_and_grad(loss)(params, *batch)
        return l, params, opt.apply(params, g, state)
    return step


def _jax_trajectory(loss_fn, tx, params, batch, steps):
    @jax.jit
    def step(p, s, *b):
        l, g = jax.value_and_grad(loss_fn)(p, *b)
        u, s = tx.update(g, s, p)
        return l, optax.apply_updates(p, u), s

    p, s, out = params, tx.init(params), []
    for _ in range(steps):
        l, p, s = step(p, s, *batch)
        out.append(float(l))
    return out, jax.device_get(p)


def _close_tree(got, want, rtol, atol):
    g = [np.asarray(a.float()) for a in _leaves(got)]
    w = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _leaves(tree):
    from tepdist_tpu_torch.core.tree import tree_leaves
    return tree_leaves(tree)


# -- the gRPC server -------------------------------------------------------

def test_ping(server):
    client = TepdistClient(server)
    info = client.ping()
    assert info["ok"] and info["n_devices"] == 1
    assert info["platform"] == "cpu"
    client.close()


def test_remote_training_matches_local(server):
    params, x, y = _mlp_np()
    opt = sgd(0.1)
    tp = _t(params)
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    summary = sess.compile_train_step(_torch_step(opt), tp, opt.init(tp),
                                      _t(x), _t(y))
    assert summary["planner_seconds"] >= 0
    remote = [sess.run(_t(x), _t(y)) for _ in range(5)]
    local, lp = _jax_trajectory(_jax_mlp_loss, optax.sgd(0.1), params,
                                (x, y), 5)
    np.testing.assert_allclose(remote, local, rtol=1e-4)
    assert remote[-1] < remote[0]
    got, _ = sess.variables()
    _close_tree(got, lp, 1e-4, 1e-6)
    sess.close()


def test_checkpoint_save_restore_over_rpc(server):
    params, x, y = _mlp_np(batch=32)
    opt = sgd(0.1)
    tp = _t(params)
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    sess.compile_train_step(_torch_step(opt), tp, opt.init(tp), _t(x),
                            _t(y))
    sess.run(_t(x), _t(y))
    sess.save()
    saved, _ = sess.variables()
    for _ in range(3):
        sess.run(_t(x), _t(y))
    drifted, _ = sess.variables()
    assert not torch.allclose(drifted["w1"], saved["w1"])
    sess.restore()
    restored, _ = sess.variables()
    assert torch.equal(restored["w1"], saved["w1"])
    sess.close()


def test_periodic_variable_fetch(server):
    params, x, y = _mlp_np(batch=32)
    opt = sgd(0.1)
    tp = _t(params)
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    sess.compile_train_step(_torch_step(opt), tp, opt.init(tp), _t(x),
                            _t(y))
    result = sess.client.execute_plan(
        sess.handle, inline_args=dict(zip(sess._batch_leaf_idx,
                                          (_t(x), _t(y)))),
        fetch_resource_variables=True)
    assert result["fetched"], "no variables came back with the step"
    assert tuple(result["fetched"][0].shape) == params["w1"].shape
    sess.close()


def test_async_pipelined_steps(server):
    params, x, y = _mlp_np(batch=32)
    opt = sgd(0.1)
    tp = _t(params)
    ref = TepdistSession(server, mesh_axes=[("data", 1)])
    ref.compile_train_step(_torch_step(opt), tp, opt.init(tp), _t(x), _t(y))
    seq = [ref.run(_t(x), _t(y)) for _ in range(4)]
    ref.close()
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    sess.compile_train_step(_torch_step(opt), tp, opt.init(tp), _t(x),
                            _t(y))
    futures = [sess.run_async(_t(x), _t(y)) for _ in range(4)]
    losses = [f.result(timeout=120) for f in futures]
    # Pipelined submission gives exactly the sequential trajectory.
    assert losses == seq
    sess.close()


def test_init_from_remote(server):
    """Weights created SERVER-side from init specs: the client ships only
    shapes (``meta`` tensors); the fetched weights equal the port's own
    ``init_from_spec`` in-process (its splitmix fill is not the
    reference's threefry), and training proceeds."""
    from tepdist_tpu_torch.rpc.server import init_seed_for
    from tepdist_tpu_torch.runtime.initializers import init_from_spec

    opt = sgd(0.1)
    params = {"w1": torch.empty(32, 64, device="meta"),
              "w2": torch.empty(64, 8, device="meta")}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 32)).astype(np.float32))
    y = torch.zeros(64, 8)
    specs = {0: {"shape": [32, 64], "dtype": "float32",
                 "distribution": "normal", "scale": 1.0,
                 "fan_in_scaling": True},
             1: {"shape": [64, 8], "dtype": "float32",
                 "distribution": "normal", "scale": 1.0,
                 "fan_in_scaling": True}}
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    summary = sess.compile_train_step(_torch_step(opt), params,
                                      opt.init(params), x, y,
                                      init_specs=specs, init_seed=7)
    assert summary.get("initialized_vars", 0) >= 2
    got, _ = sess.variables()
    for i, name in enumerate(["w1", "w2"]):
        want = init_from_spec(init_seed_for(7, i), specs[i], device="cpu")
        assert torch.equal(got[name], want)
    losses = [sess.run(x, y) for _ in range(3)]
    assert losses[-1] < losses[0]
    sess.close()


def test_compile_training_remote_ga(server):
    """The loss + optimizer API with remote GA (M = 2) against the JAX
    package's in-process ``plan_training`` of the same loss."""
    from tepdist_tpu.train import plan_training

    params, x, y = _mlp_np(batch=32)
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    sess.compile_training(_torch_mlp_loss, adam(1e-2), _t(params), _t(x),
                          _t(y), num_micro_batches=2)
    remote = [sess.run(_t(x), _t(y)) for _ in range(3)]
    sess.close()
    local = plan_training(_jax_mlp_loss, optax.adam(1e-2), params, x, y,
                          num_micro_batches=2, topology=None, explore=False)
    expected = [local.step(x, y) for _ in range(3)]
    np.testing.assert_allclose(remote, expected, rtol=1e-4)


def _gpt2_np(attn="flash", batch=4):
    from tepdist_tpu.models import gpt2 as jgpt2

    jcfg = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32,
                               attn=attn)
    params = jax.device_get(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(jcfg, batch, 32, seed=3))
    return jcfg, params, tokens


def _torch_gpt2_cfg(attn="flash"):
    from tepdist_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32,
                               attn=attn)


def test_flash_attention_gpt2_over_rpc(server):
    """GPT-2 ``test`` with the flash ops trains THROUGH the gRPC service:
    the shipped graph carries the ``tepdist::flash_*`` nodes, and the
    remote losses match the JAX package's local flash training (Pallas
    in interpret mode) at the reference test's rtol 1e-4."""
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2

    jcfg, params, tokens = _gpt2_np()
    cfg = _torch_gpt2_cfg()
    opt = adamw(1e-3)
    tp = _t(params)
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    sess.compile_train_step(
        _torch_step(opt, lambda p, t: gpt2.loss_fn(p, t, cfg)), tp,
        opt.init(tp), _t(tokens))
    remote = [sess.run(_t(tokens)) for _ in range(3)]
    sess.close()
    local, _ = _jax_trajectory(lambda p, t: jgpt2.loss_fn(p, t, jcfg),
                               optax.adamw(1e-3), params, (tokens,), 3)
    np.testing.assert_allclose(remote, local, rtol=1e-4)


def test_generate_from_trained_checkpoint(server):
    """Greedy sampling through the service on the server-held trained
    weights (train, checkpoint, step past it, restore, decode over RPC):
    the tokens equal the port's local ``sample`` on the fetched weights
    and the JAX package's on the same weights."""
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu.models import sampling as jsampling
    from tepdist_tpu_torch.models import gpt2, sampling

    jcfg, params, tokens = _gpt2_np(attn="einsum")
    cfg = _torch_gpt2_cfg(attn="einsum")
    opt = adam(1e-3)
    tp = _t(params)
    sess = TepdistSession(server, mesh_axes=[("data", 1)])
    sess.compile_train_step(
        _torch_step(opt, lambda p, t: gpt2.loss_fn(p, t, cfg)), tp,
        opt.init(tp), _t(tokens))
    for _ in range(2):
        sess.run(_t(tokens))
    sess.save()
    sess.run(_t(tokens))
    sess.restore()
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int64))

    def gen_fn(p, prompt):
        return sampling.sample(p, prompt, cfg, max_new_tokens=6,
                               greedy=True)

    sess.compile_generate(gen_fn, tp, prompt)
    remote = sess.generate(prompt)
    trained = sess.params()
    sess.close()
    local = sampling.sample(trained, prompt, cfg, max_new_tokens=6,
                            greedy=True)
    assert torch.equal(remote, local)
    ref = jsampling.sample(convert.to_numpy(trained), prompt.numpy(), jcfg,
                           max_new_tokens=6, greedy=True)
    np.testing.assert_array_equal(remote.numpy(), np.asarray(ref))


# -- in-process servicers ---------------------------------------------------

def test_execute_plan_failure_invalidates_donated_vars():
    """A step that fails after the store gave up its donated state leaves
    those entries invalidated (a clear "re-transfer or restore" path),
    not pointing at half-consumed buffers."""
    from tepdist_tpu_torch.rpc.server import _CompiledPlan

    servicer = TepdistServicer(["cpu"])
    servicer.variables[0] = torch.arange(4.0)

    class Exploding:
        def distribute_input(self, i, val):
            return val

        def run(self, args):
            args.clear()             # the donated leaf is consumed
            raise RuntimeError("boom after dispatch")

    plan = _CompiledPlan(Exploding(), var_arg_indices={0},
                         state_alias={0: 0}, n_invars=1, donate=(0,))
    handle = servicer.plan_cache.insert(plan)
    with pytest.raises(RuntimeError, match="boom"):
        servicer.ExecutePlan(protocol.pack({"handle": handle}))
    assert 0 not in servicer.variables


def test_later_verbs_name_their_items():
    address, servicer = _servicer()
    client = TepdistClient(address)
    for verb, item in LATER_VERBS.items():
        with pytest.raises(retry.ServerError, match=f"item {item}"):
            client.call(verb, {})
    inproc.unregister_servicer(address)


def test_plan_over_more_ranks_than_the_server_names_15b():
    """An SPMD plan over more devices than the server's world runs one
    rank a device, across the ranks of a multi-rank server (the
    multi-host client, item 15b): on a server of one rank it is refused,
    never run on a smaller mesh."""
    address, _ = _servicer()
    params, x, y = _mlp_np(batch=32)
    sess = TepdistSession(address, mesh_axes=[("data", 2)])
    with pytest.raises(retry.ServerError, match="world has 1 rank"):
        sess.compile_training(_torch_mlp_loss, sgd(0.1), _t(params),
                              _t(x), _t(y))
    sess.close()


def test_slice_port_session_matches_jax_session():
    """The slice as a whole: GPT-2 ``test`` (fp32, flash, adamw, M = 2)
    trained 3 steps by the port's session against the port's server and
    by the JAX session against the JAX servicer (its in-process
    transport), from the same numpy weights."""
    from tepdist_tpu.client.session import TepdistSession as JaxSession
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu.rpc import inproc as jinproc
    from tepdist_tpu.rpc.server import TepdistServicer as JaxServicer
    from tepdist_tpu_torch.models import gpt2

    jcfg, params, tokens = _gpt2_np(batch=4)
    cfg = _torch_gpt2_cfg()
    address, _ = _servicer()
    sess = TepdistSession(address, mesh_axes=[("data", 1)])
    sess.compile_training(lambda p, t: gpt2.loss_fn(p, t, cfg),
                          adamw(1e-3), _t(params), _t(tokens),
                          num_micro_batches=2)
    assert sess.compile_stats["graph_nodes"] > 0
    tl = [sess.run(_t(tokens)) for _ in range(3)]
    tparams = sess.params()
    sess.close()

    jaddress = f"inproc:{next(_PORTS)}"
    jinproc.register_servicer(jaddress, JaxServicer(jax.devices()[:1]))
    jsess = JaxSession(jaddress, mesh_axes=[("data", 1)])
    jsess.compile_training(lambda p, t: jgpt2.loss_fn(p, t, jcfg),
                           optax.adamw(1e-3), params, tokens,
                           num_micro_batches=2)
    jl = [jsess.run(tokens) for _ in range(3)]
    jparams = jsess.params()
    jsess.close()
    jinproc.unregister_servicer(jaddress)

    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _close_tree(tparams, jparams, 0, 2e-5)


# -- server-side exploration (tests/test_rpc_explore.py) --------------------

def _deep_mlp_np(depth=2, width=64, batch=64):
    rng = np.random.default_rng(0)
    scale = (2.0 / width) ** 0.5
    params = {f"w{i}": (rng.standard_normal((width, width)) * scale)
              .astype(np.float32) for i in range(depth)}
    x = rng.standard_normal((batch, width)).astype(np.float32)
    y = rng.standard_normal((batch, width)).astype(np.float32)
    return params, x, y


def _deep_losses(depth):
    def tl(p, x, y):
        h = x
        for i in range(depth):
            h = torch.relu(h @ p[f"w{i}"])
        return ((h - y) ** 2).mean()

    def jl(p, x, y):
        h = x
        for i in range(depth):
            h = jax.nn.relu(h @ p[f"w{i}"])
        return jnp.mean((h - y) ** 2)
    return tl, jl


# The comm-dominated / memory-tight regime: pipeline stage cuts win.
_PIPELINE_ENV = {"HBM_GB": "0.01", "ICI_BANDWIDTH": "0.05",
                 "COMM_OVERLAP": "0.0"}


@pytest.fixture
def pipeline_env():
    ServiceEnv.reset(_PIPELINE_ENV)
    yield
    ServiceEnv.reset()


def test_no_topology_session_gets_explored_plan():
    """compile_training with NO mesh_axes on a one-device server runs the
    server-side exploration: the summary lists the explored candidates
    with costs, and the trajectory equals local SGD."""
    params, x, y = _deep_mlp_np()
    tl, jl = _deep_losses(2)
    address, _ = _servicer()
    sess = TepdistSession(address, mesh_axes=())
    summary = sess.compile_training(
        tl, sgd(0.1), _t(params), _t(x), _t(y),
        optimizer_spec=optimizer_spec("sgd", learning_rate=0.1))
    assert "explored" in summary, summary
    cands = summary["explored"]["candidates"]
    assert len(cands) > 1
    assert any(c["winner"] for c in cands)
    assert {"duration_s", "kind", "config"} <= set(cands[0])
    losses = [sess.run(_t(x), _t(y)) for _ in range(3)]
    sess.close()
    ref, _ = _jax_trajectory(jl, optax.sgd(0.1), params, (x, y), 3)
    np.testing.assert_allclose(losses, ref, rtol=1e-5)


def test_pipeline_winner_executes_over_rpc(pipeline_env):
    """When a stage cut wins, BuildExecutionPlan builds the pipeline
    runtime over the server's devices (``["cpu"] * 4``, the one-process
    form) behind the handle; the no-topology client trains through it and
    fetches its state back: plain SGD's trajectory (GA over equal micro
    batches of a mean loss is the full-batch gradient)."""
    params, x, y = _deep_mlp_np(depth=8, width=512, batch=16)
    tl, jl = _deep_losses(8)
    address, _ = _servicer(["cpu"] * 4)
    sess = TepdistSession(address, mesh_axes=())
    summary = sess.compile_training(
        tl, sgd(0.01), _t(params), _t(x), _t(y), num_micro_batches=4,
        optimizer_spec=optimizer_spec("sgd", learning_rate=0.01))
    assert summary.get("kind") == "pipeline", summary
    assert summary["num_stages"] >= 2
    assert "explored" in summary
    losses = [sess.run(_t(x), _t(y)) for _ in range(3)]
    fetched = sess.params()
    sess.close()
    ref, ref_params = _jax_trajectory(jl, optax.sgd(0.01), params, (x, y), 3)
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    _close_tree(fetched, ref_params, 1e-4, 1e-6)


def test_explicit_mesh_axes_skip_exploration():
    params, x, y = _deep_mlp_np()
    tl, jl = _deep_losses(2)
    address, _ = _servicer()
    sess = TepdistSession(address, mesh_axes=[("data", 1)])
    summary = sess.compile_training(tl, sgd(0.1), _t(params), _t(x), _t(y))
    assert "explored" not in summary
    assert summary["axes"] == [["data", 1]]
    losses = [sess.run(_t(x), _t(y)) for _ in range(2)]
    sess.close()
    ref, _ = _jax_trajectory(jl, optax.sgd(0.1), params, (x, y), 2)
    np.testing.assert_allclose(losses, ref, rtol=1e-5)


def test_explore_without_optimizer_spec_records_exclusions():
    """No optimizer_spec: the server cannot build pipeline/seq winners, so
    those kinds are EXCLUDED from the search, and the exclusion is
    recorded in the summary."""
    params, x, y = _deep_mlp_np()
    tl, _ = _deep_losses(2)
    address, _ = _servicer()
    sess = TepdistSession(address, mesh_axes=())
    summary = sess.compile_training(tl, sgd(0.1), _t(params), _t(x), _t(y))
    explored = summary["explored"]
    assert set(explored.get("excluded_kinds", [])) == {"seq", "pipeline"}
    assert "optimizer_spec" in explored.get("excluded_reason", "")
    losses = [sess.run(_t(x), _t(y)) for _ in range(2)]
    assert losses[1] < losses[0]
    sess.close()


def test_superseded_pipeline_handle_refuses_steps(pipeline_env):
    """A NEW state-writing plan retires the live pipeline runtime; the
    old handle REFUSES further steps, while the new plan trains."""
    params, x, y = _deep_mlp_np(depth=8, width=512, batch=16)
    tl, _ = _deep_losses(8)
    address, _ = _servicer(["cpu"] * 4)
    kw = dict(num_micro_batches=4,
              optimizer_spec=optimizer_spec("sgd", learning_rate=0.01))
    sess = TepdistSession(address, mesh_axes=())
    summary = sess.compile_training(tl, sgd(0.01), _t(params), _t(x),
                                    _t(y), **kw)
    assert summary.get("kind") == "pipeline", summary
    old_handle = sess.handle
    first = sess.run(_t(x), _t(y))
    sess2 = TepdistSession(address, mesh_axes=())
    sess2.compile_training(tl, sgd(0.01), _t(params), _t(x), _t(y), **kw)
    np.testing.assert_allclose(sess2.run(_t(x), _t(y)), first, rtol=1e-5)
    with pytest.raises(retry.ServerError, match="superseded"):
        sess.client.execute_plan(old_handle,
                                 inline_args={8: _t(x), 9: _t(y)})
    sess.close()
    sess2.close()


def test_servicer_verbs_and_fences_match_reference():
    """The control verbs on a port servicer and a JAX servicer fed the
    same request bytes: raw-data stores (keyed, multi, tuple), a stale
    plan generation dropped, InitMeshTopology, GetTelemetry(Delta), the
    epoch fence (a stale epoch refused before any effect) and the
    idempotency cache (a replayed TransferToServerHost answered from the
    cache)."""
    from tepdist_tpu.rpc import protocol as jp
    from tepdist_tpu.rpc import retry as jretry
    from tepdist_tpu.rpc.server import TepdistServicer as JaxServicer

    port, ref = TepdistServicer(["cpu"]), JaxServicer(jax.devices()[:1])
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    meta, blob = jp.encode_literal(a)
    requests = [
        ("TransferHostRawData", {"raw_key": "t1:0", "literal": meta},
         [blob]),
        ("TransferHostRawData", {"raw_multi": [
            {"raw_key": "batch:0:0:0", "literal": meta},
            {"raw_key": "batch:0:1:0", "literal": meta}]}, [blob, blob]),
        ("TransferHostRawData", {"raw_key": "t2:0",
                                 "literals": [meta, meta]}, [blob, blob]),
        ("TransferHostRawData", {"raw_key": "t3:0", "literal": meta,
                                 "plan_gen": 7}, [blob]),
        ("InitMeshTopology", {"cluster_spec": {"workers": []},
                              "master_epoch": 3}, []),
        ("TransferToServerHost", {"global_idx": 5, "variable": True,
                                  "literal": meta, "idem": "c:T:1"},
         [blob]),
    ]
    for verb, header, blobs in requests:
        got = protocol.unpack(getattr(port, verb)(protocol.pack(header,
                                                                blobs)))[0]
        want = jp.unpack(getattr(ref, verb)(jp.pack(header, blobs)))[0]
        assert got == want, (verb, got, want)
    for key in ("t1:0", "batch:0:1:0"):
        np.testing.assert_array_equal(port.raw_store.get(key).numpy(),
                                      np.asarray(ref.raw_store.get(key)))
    assert len(port.raw_store.get("t2:0")) == 2
    assert "t3:0" not in port.raw_store._data      # stale generation
    assert port.cluster_spec == ref.cluster_spec == {"workers": []}
    # A replay with the same token is answered from the cache.
    port.variables[5] = torch.zeros(2, 3)
    replay = port.TransferToServerHost(protocol.pack(requests[-1][1],
                                                     [blob]))
    assert protocol.unpack(replay)[0]["ok"]
    assert torch.equal(port.variables[5], torch.zeros(2, 3))
    # The epoch fence: epoch 3 latched, 2 refused before any effect.
    for servicer, pack, err in ((port, protocol.pack, retry),
                                (ref, jp.pack, jretry)):
        with pytest.raises(err.StaleEpochError):
            servicer.TransferToServerHost(pack(
                {"global_idx": 6, "variable": True, "literal": meta,
                 "master_epoch": 2}, [blob]))
        assert 6 not in servicer.variables
    for verb in ("GetTelemetry", "GetTelemetryDelta", "Ping"):
        got = protocol.unpack(getattr(port, verb)(protocol.pack({})))[0]
        want = jp.unpack(getattr(ref, verb)(jp.pack({})))[0]
        assert got["ok"] and want["ok"]
        assert set(want) - set(got) <= {"platform", "wp_completed"}, verb
