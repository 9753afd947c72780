"""The port's fleet-state modules held to the JAX package's, case by case:
``runtime/migration.py`` (move plans and their moved bytes),
``parallel/redistribution.py`` (plans, costs, assembled shards),
``runtime/{slice_utils,variable_specs,dist_buffer}.py`` and
``runtime/controlplane.py`` (the journal's bytes and its replay), on the
cases of ``tests/test_migration.py``, ``test_redistribution.py``,
``test_state_subsystems.py`` and ``test_controlplane*.py``. The planners
are pure host code in both packages: their outputs must be EQUAL. Then
the session level: a live migration onto a joining worker and a master
re-adoption from the WAL, whose trajectories equal the JAX fleet's and an
uninterrupted run's (fp32, losses within rtol 1e-5), and the serving
supervisor rebuilt from the WAL delivering every request once.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tepdist_tpu.core.dist_spec import DimStrategy as JDim
from tepdist_tpu.core.dist_spec import TensorStrategy as JTS
from tepdist_tpu.core.mesh import MeshTopology as JTopo
from tepdist_tpu.parallel import redistribution as jred
from tepdist_tpu.runtime import controlplane as jcp
from tepdist_tpu.runtime import migration as jmig
from tepdist_tpu.runtime import slice_utils as jsu
from tepdist_tpu.runtime import variable_specs as jvs
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.dist_spec import DimStrategy, TensorStrategy
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.parallel import redistribution as tred
from tepdist_tpu_torch.runtime import controlplane as tcp
from tepdist_tpu_torch.runtime import migration as tmig
from tepdist_tpu_torch.runtime import slice_utils as tsu
from tepdist_tpu_torch.runtime import variable_specs as tvs

torch.set_num_threads(2)


# -- migration ----------------------------------------------------------------

def _snap(mig, stage_worker, n_params, consumers, addresses):
    pl, owner = mig.placement_for(stage_worker, consumers, n_params,
                                  min(addresses))
    return mig.FleetSnapshot(list(stage_worker), pl, owner, dict(addresses))


CONS = {0: {0}, 1: {1}}
MOVE_CASES = {
    # name: (old, new, dirty, dead, step, ckpt_step)
    "live_clean": (([0, 1], {0: "a0", 1: "a1"}), ([0, 0], {0: "a0"}),
                   set(), set(), 3, 3),
    "dead_to_checkpoint": (([0, 1], {0: "a0", 1: "a1"}),
                           ([0, 0], {0: "a0"}), set(), {1}, 3, 3),
    "dirty_rebase": (([0, 1], {0: "a0", 1: "a1"}),
                     ([0, 1], {0: "a0", 1: "a1"}), {1}, set(), 5, 5),
    "step_zero": (([0, 1], {0: "a0", 1: "a1"}), ([0, 0], {0: "a0"}),
                  set(), set(), 0, -1),
    "grow": (([0, 0], {0: "a0"}), ([0, 1], {0: "a0", 1: "a1"}),
             set(), set(), 2, 2),
}


def _moved_bytes(moves, templates):
    size = {"float32": 4, "bfloat16": 2}
    total = 0
    for mvs in moves.values():
        for mv in mvs:
            if mv["kind"] == "var":
                total += int(np.prod([z - a for a, z in mv["dst_bounds"]])
                             ) * size[mv["dtype"]]
    return total


@pytest.mark.parametrize("name", sorted(MOVE_CASES))
def test_plan_moves_equal(name):
    (osw, oaddr), (nsw, naddr), dirty, dead, step, ckpt = MOVE_CASES[name]
    templates = [((4, 4), "float32"), ((4, 4), "bfloat16")]
    out = []
    for mig in (jmig, tmig):
        old = _snap(mig, osw, 2, CONS, oaddr)
        new = _snap(mig, nsw, 2, CONS, naddr)
        moves, carry = mig.plan_moves(old, new, templates, dirty=dirty,
                                      dead=dead, step=step, ckpt_step=ckpt,
                                      wire_dtype="bfloat16")
        out.append((moves, carry, mig.summarize(moves),
                    _moved_bytes(moves, templates)))
    assert out[0] == out[1]


def test_plan_moves_infeasible_equal():
    got = []
    for mig in (jmig, tmig):
        old = _snap(mig, [0, 1], 2, CONS, {0: "a0", 1: "a1"})
        new = _snap(mig, [0, 0], 2, CONS, {0: "a0"})
        with pytest.raises(mig.MigrationInfeasible) as ei:
            mig.plan_moves(old, new, [((4, 4), "float32")] * 2,
                           dirty=set(), dead={1}, step=3, ckpt_step=-1)
        got.append(ei.value.intervals)
    assert got[0] == got[1] == [((0, 4), (0, 4))]


# -- redistribution -------------------------------------------------------------

def _grid(shape, cuts):
    def splits(dim, k):
        step = dim // k
        return [(i * step, dim if i == k - 1 else (i + 1) * step)
                for i in range(k)]

    bounds = [()]
    for dim, k in zip(shape, cuts):
        bounds = [b + (s,) for b in bounds for s in splits(dim, k)]
    return bounds


@pytest.mark.parametrize("src_cuts,dst_cuts", [((2, 1), (1, 2)),
                                               ((2, 2), (4, 1)),
                                               ((1, 1), (2, 2)),
                                               ((2, 1), (2, 1))])
def test_redistribution_equal(src_cuts, dst_cuts):
    """Plans, costs (both priced on the ``cpu`` chip entry) and assembled
    shards of both packages."""
    from tepdist_tpu.core.service_env import ServiceEnv as JEnv
    from tepdist_tpu_torch.core.service_env import ServiceEnv as TEnv

    JEnv.reset({"TPU_GENERATION": "cpu"})
    TEnv.reset({"TPU_GENERATION": "cpu"})
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    src, dst = _grid((8, 8), src_cuts), _grid((8, 8), dst_cuts)
    jplan = jred.plan_redistribution(src, dst)
    tplan = tred.plan_redistribution(src, dst)
    assert jplan == tplan
    kw = dict(elem_bytes=4)
    assert (jred.redistribution_cost(src, dst, **kw)
            == tred.redistribution_cost(src, dst, **kw))

    def fetch(i, inter):
        piece = full[tuple(slice(lo, hi) for lo, hi in src[i])]
        return piece[tuple(slice(lo - a, hi - a)
                           for (lo, hi), (a, _z) in zip(inter, src[i]))]

    for d, pieces in zip(dst, tplan):
        np.testing.assert_array_equal(
            tred.assemble_shard(d, pieces, fetch, np.float32),
            jred.assemble_shard(d, pieces, fetch, np.float32))
    assert (jred.overlap(src[0], dst[-1]) == tred.overlap(src[0], dst[-1]))
    JEnv.reset()
    TEnv.reset()


def test_redistribution_incomplete_coverage_equal():
    src, dst = [((0, 4), (0, 8))], [((0, 8), (0, 8))]
    errs = []
    for red in (jred, tred):
        with pytest.raises(red.RedistributionError) as ei:
            red.plan_redistribution(src, dst)
        errs.append(ei.value.intervals)
    assert errs[0] == errs[1]


# -- slice utils, variable specs, distributed buffer ----------------------------

def _ts(pkg, splits):
    dim, ts = pkg
    return ts({ax: dim.split_on(d, n) for ax, (d, n) in splits.items()})


@pytest.mark.parametrize("splits", [{"data": (0, 2), "model": (1, 4)},
                                    {"model": (0, 4)}, {}])
def test_slice_utils_and_variable_specs_equal(splits):
    jt, tt = JTopo([("data", 2), ("model", 4)]), MeshTopology(
        [("data", 2), ("model", 4)])
    jts, tts = _ts((JDim, JTS), splits), _ts((DimStrategy, TensorStrategy),
                                             splits)
    src = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
    for d in range(8):
        assert (jsu.slice_start_offsets((16, 16), jts, jt, d)
                == tsu.slice_start_offsets((16, 16), tts, tt, d))
        np.testing.assert_array_equal(
            jsu.slice_copy_on_host(src, jts, jt, d),
            tsu.slice_copy_on_host(src, tts, tt, d))
    shards = {d: tsu.slice_copy_on_host(src, tts, tt, d) for d in range(8)}
    np.testing.assert_array_equal(
        tsu.assemble_from_slices((16, 16), tts, tt, shards), src)
    jm, tm = jvs.VariableSpecsMgr(jt), tvs.VariableSpecsMgr(tt)
    js, ts = (jm.derive(3, (16, 16), "float32", jts),
              tm.derive(3, (16, 16), "float32", tts))
    assert js.local_shape == ts.local_shape
    assert jm.unique_slice_devices(3) == tm.unique_slice_devices(3)
    assert jm.devices_holding(3) == tm.devices_holding(3)


def test_distributed_buffer_lifecycle_equal():
    from tepdist_tpu.runtime.dist_buffer import DistributedBuffer as JBuf
    from tepdist_tpu_torch.runtime.dist_buffer import DistributedBuffer

    for Buf, add in ((JBuf, lambda v: v + 1), (DistributedBuffer,
                                               lambda v: v + 1)):
        buf = Buf.placeholder((4, 4), np.float32)
        assert buf.is_placeholder and "placeholder" in repr(buf)
        with pytest.raises(ValueError):
            buf.device_value()
    eye = np.eye(4, dtype=np.float32)
    jb = JBuf.from_host(eye)
    jb.update_device(jb.device_value() + 1)
    tb = DistributedBuffer.from_host(eye, sharding=torch.device("cpu"))
    dv = tb.device_value()
    assert tb.on_device and tb.on_host and isinstance(dv, torch.Tensor)
    tb.update_device(dv + 1)
    assert not tb.on_host
    np.testing.assert_array_equal(tb.host_value(), jb.host_value())
    assert [s.shape for s in tb.addressable_shards()] == [(4, 4)]
    back = DistributedBuffer.from_device(torch.ones(2, 3))
    assert back.shape == (2, 3) and back.on_device


# -- control plane --------------------------------------------------------------

def _journal(cp, wal_dir):
    wal = cp.ControlPlaneWAL(wal_dir, fsync=False)
    cp.log_epoch(wal, 3)
    cp.log_plan(wal, plan_gen=7, fingerprint="ab12",
                plan_meta={"num_micro_batches": 2, "comm_dtype": "",
                           "zero": False},
                stage_worker=[0, 1], members={0: "inproc:1",
                                              1: "inproc:2"})
    cp.log_member(wal, 1, "inproc:2", action="dead")
    for s in range(5):
        cp.log_step(wal, s)
    cp.log_ckpt(wal, 4)
    cp.log_serve(wal, "r1", "admit", seq=0, prompt=[1, 2, 3],
                 max_new_tokens=4, greedy=True, temperature=1.0, top_k=0,
                 seed=0, deadline_ms=None, slo_class="default",
                 prefill_only=False)
    cp.log_serve(wal, "r2", "admit", seq=1, prompt=[4], max_new_tokens=2,
                 greedy=True, temperature=1.0, top_k=0, seed=0,
                 deadline_ms=None, slo_class="default", prefill_only=False)
    cp.log_serve(wal, "r1", "delivered", n_tokens=4)
    wal.close()


def _bytes(wal_dir):
    return {f: open(os.path.join(wal_dir, f), "rb").read()
            for f in sorted(os.listdir(wal_dir))}


def test_controlplane_journal_bytes_and_replay_equal(tmp_path):
    """The same records through both packages' writers: the same segment
    files byte for byte, the same replayed state; with a torn tail (a
    half-written last record) both replays stop at the same record."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    _journal(jcp, jd)
    _journal(tcp, td)
    assert _bytes(jd) == _bytes(td)
    js, ts = jcp.replay(jd), tcp.replay(td)
    assert (js.epoch, js.plan_gen, js.step) == (ts.epoch, ts.plan_gen,
                                                ts.step) == (3, 7, 5)
    assert list(js.pending_serving()) == list(ts.pending_serving())
    assert [r for r, _ in ts.pending_serving()] == ["r2"]
    for d in (jd, td):
        seg = os.path.join(d, tcp.list_segments(d)[-1])
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - 5)
    js, ts = jcp.replay(jd), tcp.replay(td)
    assert [r for r, _ in js.pending_serving()] == [
        r for r, _ in ts.pending_serving()] == ["r1", "r2"]


# -- session level ----------------------------------------------------------------

def _case(dim=8, micro=2):
    rng = np.random.default_rng(0)
    params = {f"w{i}": (rng.standard_normal((dim, dim)) * 0.3)
              .astype(np.float32) for i in range(4)}
    x = rng.standard_normal((4 * micro, dim)).astype(np.float32)
    y = rng.standard_normal((4 * micro, dim)).astype(np.float32)
    return params, x, y


def _torch_loss(p, x, y):
    h = x
    for i in range(4):
        h = torch.tanh(h @ p[f"w{i}"])
    return ((h - y) ** 2).mean()


def _jax_loss(p, x, y):
    h = x
    for i in range(4):
        h = jnp.tanh(h @ p[f"w{i}"])
    return jnp.mean((h - y) ** 2)


def _t(tree):
    return convert.to_torch(tree, device="cpu")


@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    from tepdist_tpu_torch.telemetry import metrics
    monkeypatch.setenv("TEPDIST_CKPT_DIR", str(tmp_path / "ckpt"))
    metrics().reset()
    yield str(tmp_path)


def test_live_migration_grow_matches_jax(ckpt_env):
    """Start on one worker, fold a second in with ``register_worker``:
    stage 1's params and adam slots move over live FetchShard pulls (no
    checkpoint read), the move plan equals the JAX fleet's for the same
    grow, and the trajectory equals the JAX fleet's."""
    from tepdist_tpu.parallel.pipeline import plan_pipeline as jplan
    from tepdist_tpu.rpc import inproc as jinproc
    from tepdist_tpu.rpc.server import TepdistServicer as JServicer
    from tepdist_tpu.runtime.distributed_executor import (
        DistributedPipelineSession as JSession)
    from tepdist_tpu_torch.core.cluster_spec import WorkerSpec
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)

    params, x, y = _case()
    runs = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from tepdist_tpu.core.cluster_spec import WorkerSpec as WS
            ip, plan, Sess, Sv, opt = (jinproc, jplan, JSession, JServicer,
                                       optax.adam(1e-2))
            dev, batch, p0 = jax.devices()[:1], (x, y), params
        else:
            WS = WorkerSpec
            ip, plan, Sess, Sv, opt = (inproc, plan_pipeline,
                                       DistributedPipelineSession,
                                       TepdistServicer, adam(1e-2))
            dev, batch, p0 = ["cpu"], _t((x, y)), _t(params)
        cluster, _ = ip.make_inproc_cluster(1, devices=dev)
        port = next(ip._NEXT_PORT)
        joiner = Sv(dev, task_index=1)
        ip.register_servicer(f"inproc:{port}", joiner)
        prog = plan(_jax_loss if pkg == "jax" else _torch_loss, 2, 2, p0,
                    *batch)
        sess = Sess(prog, cluster, optimizer=opt, elastic=True,
                    autosave_every=1)
        try:
            sess.load_variables(p0)
            losses = [sess.step(*batch) for _ in range(2)]
            mig = sess.register_worker(WS(ip="inproc", port=port,
                                          device_ids=[0], task_index=1))
            assert 1 in joiner.worker_plan.opt_states
            losses += [sess.step(*batch) for _ in range(2)]
        finally:
            sess.close()
            ip.unregister_servicer(f"inproc:{port}")
            ip.close_inproc_cluster(cluster)
        runs.append((losses, {k: mig[k] for k in (
            "var", "opt", "live_sources", "ckpt_sources", "carried_stages",
            "new_workers", "dead", "dirty")}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    assert runs[1][1] == runs[0][1]
    assert runs[1][1]["live_sources"] > 0 and runs[1][1]["ckpt_sources"] == 0


def test_readopt_resumes_live_fleet_bit_exact(tmp_path, ckpt_env):
    """A master journals its session to the WAL and dies (no close); a
    new master ``readopt``s the live fleet from the journal, claims the
    next epoch, and continues: the trajectory equals an uninterrupted
    run bit for bit, the old master is fenced out, and its journal's
    records are the JAX session's for the same program and fleet."""
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc import retry
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)

    params, x, y = _case()
    batches = [_t((np.random.default_rng(1000 + i).standard_normal(
        x.shape).astype(np.float32), np.random.default_rng(2000 + i)
        .standard_normal(y.shape).astype(np.float32))) for i in range(6)]

    def fleet(steps, wal_dir=None):
        cluster, servicers = make_inproc_cluster(2, devices=["cpu"])
        prog = plan_pipeline(_torch_loss, 2, 2, _t(params), *_t((x, y)))
        sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(0.1),
                                          wal_dir=wal_dir)
        sess.load_variables(_t(params))
        return ([sess.step(*batches[i]) for i in range(steps)], sess,
                cluster, prog)

    base, bsess, bcluster, _ = fleet(6)
    bsess.close()
    close_inproc_cluster(bcluster)
    wal_dir = str(tmp_path / "wal")
    first, s1, cluster, prog = fleet(3, wal_dir)
    s1._wal.close()
    s1.health.stop()
    s2 = DistributedPipelineSession.readopt(prog, cluster, _t(params),
                                            optimizer=sgd(0.1),
                                            wal_dir=wal_dir)
    try:
        assert (s2._step, s2._epoch, s2._plan_gen) == (
            3, s1._epoch + 1, s1._plan_gen)
        rest = [s2.step(*batches[i]) for i in range(3, 6)]
        assert first + rest == base
        with pytest.raises(retry.StaleEpochError):
            s1.clients[0].call("AbortStep", {})
    finally:
        s2.close()
        close_inproc_cluster(cluster)
    kinds = [r["kind"] for r in tcp.read_records(wal_dir)[0]]
    assert kinds[:3] == ["epoch", "plan", "step"]
    assert kinds.count("epoch") == 2


def test_supervisor_rebuild_from_wal_delivers_once(tmp_path):
    """The serving supervisor journals admissions and deliveries to the
    control-plane WAL; a supervisor rebuilt from the replayed journal
    re-runs only the undelivered request, whose tokens equal the
    uninterrupted run's (greedy, fp32)."""
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.serving.supervisor import ServingSupervisor

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32,
                              n_layer=1)
    params = gpt2.init_params(cfg, seed=0, device="cpu")
    prompts = {"a": np.arange(1, 9, dtype=np.int32),
               "b": np.arange(5, 17, dtype=np.int32)}
    wal_dir = str(tmp_path / "wal")
    wal = tcp.ControlPlaneWAL(wal_dir, fsync=False)
    sup = ServingSupervisor(params, cfg, slots=2, max_len=32, wal=wal,
                            device="cpu")
    for rid, p in prompts.items():
        sup.submit(rid, p, max_new_tokens=4)
    sup.run_until_idle()
    done = {r["request_id"]: r["tokens"] for r in sup.poll(["a"])}
    wal.close()   # the master dies before "b" is polled (delivered)
    state = tcp.replay(wal_dir)
    assert [rid for rid, _ in state.pending_serving()] == ["b"]
    rebuilt = ServingSupervisor.rebuild_from_wal(
        params, cfg, state, slots=2, max_len=32, device="cpu")
    rebuilt.run_until_idle()
    got = {r["request_id"]: r for r in rebuilt.poll()}
    assert set(got) == {"b"} and got["b"]["status"] == "done"
    ref = ServingSupervisor(params, cfg, slots=2, max_len=32, device="cpu")
    ref.submit("b", prompts["b"], max_new_tokens=4)
    ref.run_until_idle()
    assert got["b"]["tokens"] == ref.poll(["b"])[0]["tokens"]
    assert len(done["a"]) == 4


def test_worker_runs_one_step_at_a_time():
    """A replay of step k that reaches a worker while a dead master's step
    k still runs there waits for it and is served from the completed-step
    cache: run beside it, the replay read the old weights and applied its
    update over the first's commit (stage 0's step applied twice, seen in
    the kill-master chaos arm on a loaded host)."""
    import threading
    import time

    from tepdist_tpu_torch.rpc.worker_plan import WorkerPlan

    wp = WorkerPlan.__new__(WorkerPlan)
    wp._run_lock = threading.Lock()
    wp._completed = {}
    inside, runs = [0], []

    def body(step):
        cached = wp._completed.get(step)
        if cached is not None:
            return cached
        inside[0] += 1
        runs.append(inside[0])
        time.sleep(0.05)
        inside[0] -= 1
        wp._completed[step] = {"losses": [float(len(runs))]}
        return wp._completed[step]

    wp._run_step = body
    out = []
    threads = [threading.Thread(target=lambda: out.append(wp.run_step(3)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert runs == [1]                  # one execution, never two at once
    assert out == [{"losses": [1.0]}] * 2
