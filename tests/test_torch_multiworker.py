"""The port's fleet pipeline (``runtime/distributed_executor.py``,
``rpc/worker_plan.py``, ``runtime/coordinator.py`` and the server's worker
verbs) held to the JAX package's: the counterparts of
``tests/test_multiworker.py`` and the fleet cases of ``tests/test_faults.py``.

Most cases run on in-process workers (``inproc:`` addresses, one servicer
each) on both sides: the port's ``DistributedPipelineSession`` over port
servicers, the JAX one over JAX servicers, from the same numpy weights and
batches. One case runs the port's fleet over real gRPC servers, one in
each rank of the file's pool of 4 spawned processes
(``tests/torch_gloo_pool.py``). A death is an in-process worker that stops
answering (its address unregistered, its execute wedged): the heartbeat
declares it dead and the elastic session re-dispatches onto the survivor.

Tolerances (fp32 MLP and GPT-2 ``test``): losses within rtol 1e-5 of the
JAX fleet's, parameters within atol 1e-5 (the reference test's own bound
against its reference step is rtol 1e-4); the port's fleet against the
port's one-process ``PipelineExecutable``: equal bit for bit.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.cluster_spec import ClusterSpec, WorkerSpec
from tepdist_tpu_torch.optim import adam, sgd
from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
from tepdist_tpu_torch.rpc import inproc, protocol
from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                          make_inproc_cluster)
from tepdist_tpu_torch.runtime import faults
from tepdist_tpu_torch.runtime.distributed_executor import (
    DistributedPipelineSession)
from tepdist_tpu_torch.telemetry import metrics

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    faults.configure(None)
    yield
    faults.reset()


def _mlp_np(seed=0, d=32, batch=16):
    rng = np.random.default_rng(seed)
    params = {f"w{i}": (rng.standard_normal((d, d)) * 0.3).astype(np.float32)
              for i in range(4)}
    x = rng.standard_normal((batch, d)).astype(np.float32)
    y = rng.standard_normal((batch, d)).astype(np.float32)
    return params, x, y


def _torch_mlp(p, x, y):
    h = x
    for i in range(4):
        h = torch.tanh(h @ p[f"w{i}"])
    return ((h - y) ** 2).mean()


def _jax_mlp(p, x, y):
    h = x
    for i in range(4):
        h = jnp.tanh(h @ p[f"w{i}"])
    return jnp.mean((h - y) ** 2)


def _t(tree):
    return convert.to_torch(tree, device="cpu")


def _opts(name):
    return {"adam": (adam(1e-2), optax.adam(1e-2)),
            "sgd": (sgd(0.1), optax.sgd(0.1))}[name]


def _jax_fleet(loss, params, batch, S, M, W, opt, steps):
    """The JAX package's fleet over its own in-process workers."""
    from tepdist_tpu.parallel.pipeline import plan_pipeline as jplan
    from tepdist_tpu.rpc.inproc import (close_inproc_cluster as jclose,
                                        make_inproc_cluster as jmake)
    from tepdist_tpu.runtime.distributed_executor import (
        DistributedPipelineSession as JaxSession)

    prog = jplan(loss, S, M, params, *batch)
    cluster, _ = jmake(W, devices=jax.devices()[:1])
    sess = JaxSession(prog, cluster, optimizer=_opts(opt)[1])
    try:
        sess.load_variables(params)
        losses = [sess.step(*batch) for _ in range(steps)]
        return losses, jax.device_get(sess.fetch_variables())
    finally:
        sess.close()
        jclose(cluster)


def _port_fleet(loss, params, batch, S, M, cluster, opt, steps, **kw):
    prog = plan_pipeline(loss, S, M, _t(params), *_t(batch))
    sess = DistributedPipelineSession(prog, cluster, optimizer=_opts(opt)[0],
                                      **kw)
    try:
        sess.load_variables(_t(params))
        losses = [sess.step(*_t(batch)) for _ in range(steps)]
        return losses, sess.fetch_variables(), sess
    finally:
        sess.close()


def _close(got, want, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _close(g, w, atol)
            continue
        np.testing.assert_allclose(np.asarray(g.float()),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("n_workers", [2, 4])
def test_n_worker_fleet_matches_jax(n_workers):
    """S = W stages, one a worker, M = 2, adam: 3 steps of the port's
    fleet against the JAX fleet, and against the port's one-process
    executable (bit for bit)."""
    from tepdist_tpu_torch.runtime.executor import PipelineExecutable

    params, x, y = _mlp_np()
    cluster, _ = make_inproc_cluster(n_workers, devices=["cpu"])
    try:
        tl, tp, _ = _port_fleet(_torch_mlp, params, (x, y), n_workers, 2,
                                cluster, "adam", 3)
    finally:
        close_inproc_cluster(cluster)
    jl, jp = _jax_fleet(_jax_mlp, params, (x, y), n_workers, 2, n_workers,
                        "adam", 3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(tp, jp)
    assert tl[-1] < tl[0]
    prog = plan_pipeline(_torch_mlp, n_workers, 2, _t(params), _t(x), _t(y))
    exe = PipelineExecutable(prog, devices=["cpu"] * n_workers,
                             optimizer=adam(1e-2))
    exe.load_variables(_t(params))
    assert [exe.step(_t(x), _t(y)) for _ in range(3)] == tl
    for k, v in exe.fetch_variables().items():
        assert torch.equal(v, tp[k]), k


def test_four_stages_over_two_workers():
    """Stages interleave over workers (s % W): same-worker edges take the
    local passthrough, remote ones the raw push."""
    params, x, y = _mlp_np(seed=3)
    cluster, _ = make_inproc_cluster(2, devices=["cpu"])
    try:
        tl, tp, _ = _port_fleet(_torch_mlp, params, (x, y), 4, 2, cluster,
                                "sgd", 2)
    finally:
        close_inproc_cluster(cluster)
    jl, jp = _jax_fleet(_jax_mlp, params, (x, y), 4, 2, 2, "sgd", 2)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(tp, jp)


def test_two_worker_tied_embeddings_gpt2():
    """GPT-2 ``test`` (fp32, einsum attention) ties wte between stage 0
    (worker 0) and the last stage (worker 1): its gradient contribution
    travels worker 1 -> worker 0, the owner applies the sum, and sends
    the new table back to worker 1. Step 1 is held to the JAX fleet;
    three steps to the port's one-process executable, bit for bit. (The
    JAX fleet leaves worker 1's copy at the loaded table, so its later
    steps read a stale embedding: ROADMAP C9.)"""
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.runtime.executor import PipelineExecutable

    jcfg = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32)
    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32)
    params = jax.device_get(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(jcfg, 4, 32))

    def loss(p, t):
        return gpt2.loss_fn(p, t, cfg)

    prog = plan_pipeline(loss, 2, 2, _t(params), _t(tokens))
    cluster, _ = make_inproc_cluster(2, devices=["cpu"])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(0.1))
    try:
        sess.load_variables(_t(params))
        tl = [sess.step(_t(tokens))]
        first = sess.fetch_variables()
        tl += [sess.step(_t(tokens)) for _ in range(2)]
        last = sess.fetch_variables()
    finally:
        sess.close()
        close_inproc_cluster(cluster)
    jl, jp = _jax_fleet(lambda p, t: jgpt2.loss_fn(p, t, jcfg), params,
                        (tokens,), 2, 2, 2, "sgd", 1)
    np.testing.assert_allclose(tl[:1], jl, rtol=LOSS_RTOL)
    _close(first, jp)
    exe = PipelineExecutable(prog, devices=["cpu"] * 2, optimizer=sgd(0.1))
    exe.load_variables(_t(params))
    assert [exe.step(_t(tokens)) for _ in range(3)] == tl
    want = exe.fetch_variables()
    for k in ("wte", "wpe"):
        assert torch.equal(last[k], want[k]), k


def test_device_direct_tickets_equal_host_push(monkeypatch):
    """Pull tickets (``TEPDIST_DEVICE_TRANSFER=1``: the producer parks the
    value in its process's transfer registry, the consumer's server
    prefetches it) give the host push's trajectory bit for bit, and every
    parked buffer is freed."""
    params, x, y = _mlp_np(seed=1)
    runs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("TEPDIST_DEVICE_TRANSFER", knob)
        cluster, servicers = make_inproc_cluster(2, devices=["cpu"])
        try:
            runs[knob] = _port_fleet(_torch_mlp, params, (x, y), 2, 2,
                                     cluster, "adam", 3)[:2]
            for sv in servicers:
                sv.release_parked_transfers()
        finally:
            close_inproc_cluster(cluster)
    assert runs["0"][0] == runs["1"][0]
    from tepdist_tpu_torch.rpc import worker_plan
    assert not worker_plan._PARKED


def test_execution_coordinator_fanout(tmp_path, monkeypatch):
    """ExecutionCoordinator: mesh init, module transfer, var-arg map,
    execute and save fan-out over the slaves (task 0 is the master)."""
    from tepdist_tpu_torch.graph.fx_graph import trace_graph
    from tepdist_tpu_torch.rpc import fx_serde
    from tepdist_tpu_torch.runtime.coordinator import (
        ExecutionCoordinator, deserialize_task_into, serialize_task)
    from tepdist_tpu_torch.runtime.execution_plan import (
        build_pipeline_task_dag)
    from tepdist_tpu_torch.runtime.task_graph import TaskDAG

    monkeypatch.setenv("TEPDIST_CKPT_DIR", str(tmp_path))
    cluster, servicers = make_inproc_cluster(3, devices=["cpu"])
    try:
        coord = ExecutionCoordinator(cluster)
        assert set(coord.clients) == {1, 2}
        coord.init_mesh_topology()
        g, _, _ = trace_graph(lambda v: v * 2, torch.zeros(4))
        coord.transfer_module(fx_serde.serialize_graph(g.gm), module_id=7)
        coord.transfer_var_arg_map({0: 0})
        results = coord.execute_remote_plan()
        assert [r.get("ok") for r in results] == [True, True]
        coord.do_remote_save(max_to_keep=2, global_step=0)
        for sv in servicers[1:]:
            assert 7 in sv.modules and sv.var_arg_map == {0: 0}
            assert sv.cluster_spec["workers"][2]["task_index"] == 2
        coord.close()
    finally:
        close_inproc_cluster(cluster)
    # The wire form of a task round-trips (DispatchPlan's tasks).
    params, x, y = _mlp_np()
    prog = plan_pipeline(_torch_mlp, 2, 2, _t(params), _t(x), _t(y))
    dag, _ = build_pipeline_task_dag(prog, [(0,), (1,)])
    copy = TaskDAG()
    for n in dag.nodes:
        deserialize_task_into(copy, serialize_task(n))
    assert [serialize_task(n) for n in copy.nodes] == [
        dict(serialize_task(n), mem_to_release=[]) for n in dag.nodes]


def _kill_inproc(cluster, ti):
    """An in-process worker that stops answering: its address is gone."""
    inproc.unregister_servicer(cluster.workers[ti].address)


def test_elastic_redispatch_onto_shrunken_cluster(tmp_path, monkeypatch):
    """Worker 1 dies between steps; the ELASTIC session finds it on the
    next step, migrates onto the survivor (which adopts stage 1) and
    retries, with no resume call: the trajectory equals the JAX fleet's
    uninterrupted 4 steps."""
    monkeypatch.setenv("TEPDIST_CKPT_DIR", str(tmp_path))
    params, x, y = _mlp_np()
    cluster, _ = make_inproc_cluster(2, devices=["cpu"])
    prog = plan_pipeline(_torch_mlp, 2, 2, _t(params), _t(x), _t(y))
    sess = DistributedPipelineSession(prog, cluster, optimizer=adam(1e-2),
                                      elastic=True, autosave_every=1)
    try:
        sess.health.interval = 0.25
        sess.health.timeout = 0.5
        sess.load_variables(_t(params))
        losses = [sess.step(_t(x), _t(y)) for _ in range(2)]
        _kill_inproc(cluster, 1)
        losses += [sess.step(_t(x), _t(y)) for _ in range(2)]
        assert sess.cluster.num_workers == 1
        got = sess.fetch_variables()
    finally:
        sess.close()
        close_inproc_cluster(cluster)
    jl, jp = _jax_fleet(_jax_mlp, params, (x, y), 2, 2, 2, "adam", 4)
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    _close(got, jp)


@pytest.mark.parametrize("victim_ti", [1, 0])
def test_mid_step_death_detected_by_heartbeat(tmp_path, monkeypatch,
                                              victim_ti):
    """A worker wedges inside its execute verb and stops answering pings:
    the master's heartbeat join declares it dead within seconds (not the
    60 s recv timeout), AbortStep wakes the survivor, and the elastic
    path re-dispatches onto it: the step retries and the trajectory
    equals the JAX fleet's uninterrupted run."""
    monkeypatch.setenv("TEPDIST_CKPT_DIR", str(tmp_path))
    params, x, y = _mlp_np()
    cluster, servicers = make_inproc_cluster(2, devices=["cpu"])
    prog = plan_pipeline(_torch_mlp, 2, 2, _t(params), _t(x), _t(y))
    sess = DistributedPipelineSession(prog, cluster, optimizer=adam(1e-2),
                                      elastic=True, autosave_every=1)
    release = threading.Event()
    victim = servicers[victim_ti]
    try:
        sess.health.interval = 0.25
        sess.health.timeout = 0.5
        sess.abort_grace_s = 2.0
        sess.load_variables(_t(params))
        losses = [sess.step(_t(x), _t(y))]

        def wedged(request, context=None):
            _kill_inproc(cluster, victim_ti)
            release.wait(30)
            raise ConnectionError("worker wedged")

        victim.ExecuteStepSlice = wedged
        t0 = time.monotonic()
        losses.append(sess.step(_t(x), _t(y)))
        detect_s = time.monotonic() - t0
        losses += [sess.step(_t(x), _t(y)) for _ in range(2)]
        assert sess.cluster.num_workers == 1
        assert detect_s < 20.0, detect_s
        got = sess.fetch_variables()
    finally:
        release.set()
        sess.close()
        close_inproc_cluster(cluster)
    jl, jp = _jax_fleet(_jax_mlp, params, (x, y), 2, 2, 2, "adam", 4)
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    _close(got, jp)


def test_transient_fault_recovered_without_rollback():
    """A planted ``server_fault`` on worker 1's ExecuteStepSlice that
    lasts until the master fences the fleet: ``_recover_step`` classifies
    it transient (every ping answers), fences, resets and re-executes the
    same step from the kept inputs: the faulted run's losses and
    parameters equal the clean run's bit for bit, with one step retry and
    no rollback or re-dispatch."""
    params, x, y = _mlp_np(seed=2)
    runs = {}
    for planted in (False, True):
        metrics().reset()
        cluster, servicers = make_inproc_cluster(2, devices=["cpu"])
        prog = plan_pipeline(_torch_mlp, 2, 2, _t(params), _t(x), _t(y))
        sess = DistributedPipelineSession(prog, cluster,
                                          optimizer=adam(1e-2))
        try:
            sess.health.interval = 0.25
            sess.load_variables(_t(params))
            losses = [sess.step(_t(x), _t(y))]
            if planted:
                arm_until_fence(servicers[1],
                                "server_fault:p=1,verb=ExecuteStepSlice,ti=1")
            losses += [sess.step(_t(x), _t(y)) for _ in range(2)]
            runs[planted] = (losses, sess.fetch_variables(),
                             metrics().snapshot()["counters"])
        finally:
            faults.configure(None)
            sess.close()
            close_inproc_cluster(cluster)
    clean, faulted = runs[False], runs[True]
    assert faulted[0] == clean[0]
    for k, v in clean[1].items():
        assert torch.equal(v, faulted[1][k]), k
    assert faulted[2].get("step_retries") == 1
    assert faulted[2].get("fault_injected:server_fault", 0) > 0
    assert "elastic_redispatch" not in faulted[2]
    assert "checkpoint_rollback_steps" not in faulted[2]


def arm_until_fence(servicer, spec):
    """Arm the fault spec until ``servicer`` sees the master's fence (a
    plain AbortStep): a transient fault that outlasts the transport's own
    retries."""
    faults.configure(spec)
    abort = servicer.AbortStep

    def fenced(request, context=None):
        header, _ = protocol.unpack(request)
        if not header.get("reset"):
            faults.configure(None)
        return abort(request, context)

    servicer.AbortStep = fenced


def test_fleet_save_restore_and_trace(tmp_path, monkeypatch):
    """``save`` has every worker write its variables and stage optimizer
    slots; ``restore`` after two more steps puts them back, and the next
    step repeats the saved run's loss bit for bit. ``dump_trace`` merges
    the workers' spans with the predicted timeline."""
    monkeypatch.setenv("TEPDIST_CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("TEPDIST_TRACE", "1")
    params, x, y = _mlp_np()
    cluster, _ = make_inproc_cluster(2, devices=["cpu"])
    prog = plan_pipeline(_torch_mlp, 2, 2, _t(params), _t(x), _t(y))
    sess = DistributedPipelineSession(prog, cluster, optimizer=adam(1e-2))
    try:
        sess.load_variables(_t(params))
        sess.step(_t(x), _t(y))
        sess.save()
        after = [sess.step(_t(x), _t(y)) for _ in range(2)]
        sess.restore(1)
        again = sess.step(_t(x), _t(y))
        path = sess.dump_trace(str(tmp_path / "trace.json"))
    finally:
        sess.close()
        close_inproc_cluster(cluster)
    assert again == after[0]
    import json
    with open(path) as f:
        trace = json.load(f)
    assert trace["metadata"]["fidelity"]["predicted"]


@pytest.fixture(scope="module")
def pool():
    from tests.torch_gloo_pool import GlooPool

    p = GlooPool("tests.test_torch_multiworker")
    yield p
    p.close()


def case_serve(rank, ports):
    """Each rank serves gRPC on ``ports[rank]`` (a worker of the fleet)
    until the pool closes."""
    from tepdist_tpu_torch.rpc.server import create_server

    server, _, _ = create_server(ports[rank], devices=["cpu"],
                                 task_index=rank)
    server.start()
    globals()["_SERVER"] = server
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_grpc_fleet_four_workers(pool):
    """The port's fleet over 4 real gRPC servers (one in each spawned
    rank), 4 stages, adam: held to the JAX fleet."""
    from tepdist_tpu_torch.rpc.client import TepdistClient

    ports = [_free_port() for _ in range(4)]
    pool.run("serve", ports)
    for p in ports:
        c = TepdistClient(f"127.0.0.1:{p}")
        c.wait_ready(60)
        c.close()
    cluster = ClusterSpec([WorkerSpec("127.0.0.1", p, [0], task_index=i)
                           for i, p in enumerate(ports)])
    params, x, y = _mlp_np(seed=4)
    tl, tp, _ = _port_fleet(_torch_mlp, params, (x, y), 4, 2, cluster,
                            "adam", 3)
    jl, jp = _jax_fleet(_jax_mlp, params, (x, y), 4, 2, 4, "adam", 3)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(tp, jp)

