"""The port's task-graph runtime core (``runtime/{task_graph,task_scheduler,
execution_plan}``, ``native/``, ``analysis/plan_verify``,
``Evaluator.run_pipeline``) held against the JAX package's on the CPU.

These modules are framework-neutral copies, so they are held exactly: the
reference's own DAG (``_mlp4`` at (S, M) = (2, 4) on
``[(0,1,2,3),(4,5,6,7)]``, ``tests/test_runtime.py``) is rebuilt node for
node as the port's ``TaskDAG``, and both schedulers, priced on the same
``cpu`` chip entry, must give the same order, start times, makespan, bubble
ratio and peak bytes. The port's native and Python simulations must agree,
and ``plan_verify`` must reject every corruption the reference's tests name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.parallel import evaluator as jevaluator
from tepdist_tpu.parallel import performance_utils as jperf
from tepdist_tpu.parallel.pipeline import plan_pipeline as jax_plan_pipeline
from tepdist_tpu.runtime import execution_plan as jexecution_plan
from tepdist_tpu.runtime import task_scheduler as jtask_scheduler
from tepdist_tpu_torch import convert, native
from tepdist_tpu_torch.analysis.plan_verify import (PlanVerificationError,
                                                    maybe_verify_plan,
                                                    verify_enabled,
                                                    verify_plan,
                                                    verify_servable)
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.models.gpt2 import GPT2Config
from tepdist_tpu_torch.parallel import performance_utils as tperf
from tepdist_tpu_torch.parallel.evaluator import Evaluator
from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
from tepdist_tpu_torch.runtime.execution_plan import build_pipeline_task_dag
from tepdist_tpu_torch.runtime.task_graph import (TaskDAG, TaskGraphError,
                                                  TaskType)
from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler
from tepdist_tpu_torch.telemetry import metrics

torch.set_num_threads(2)

DEVS_2x4 = [(0, 1, 2, 3), (4, 5, 6, 7)]


def _mlp4_np(batch=32, d=64, layers=4, scale=0.3, seed=0):
    rng = np.random.default_rng(seed)
    params = {f"w{i}": (rng.standard_normal((d, d)) * scale)
              .astype(np.float32) for i in range(layers)}
    x = rng.standard_normal((batch, d)).astype(np.float32)
    y = rng.standard_normal((batch, d)).astype(np.float32)
    return params, (x, y)


def _jax_loss(params, x, y):
    h = x
    for k in sorted(params):
        h = jnp.tanh(h @ params[k])
    return jnp.mean((h - y) ** 2)


def _torch_loss(params, x, y):
    h = x
    for k in sorted(params):
        h = torch.tanh(h @ params[k])
    return ((h - y) ** 2).mean()


def _jax_dag(S=2, M=4, devs=DEVS_2x4, **kw):
    params, batch = _mlp4_np(**kw)
    prog = jax_plan_pipeline(_jax_loss, S, M, params, *batch)
    return jexecution_plan.build_pipeline_task_dag(prog, devs)


def _port_prog(S=2, M=4, **kw):
    params, batch = _mlp4_np(**kw)
    return plan_pipeline(_torch_loss, S, M,
                         convert.to_torch(params, device="cpu"),
                         *convert.to_torch(batch, device="cpu"))


def _copy_dag(jdag) -> TaskDAG:
    """The reference's DAG as the port's, node for node."""
    dag = TaskDAG()
    for n in jdag.nodes:
        t = dag.add(TaskType(n.task_type.value), n.name,
                    worker_id=n.worker_id,
                    device_group=tuple(n.device_group), stage=n.stage,
                    micro=n.micro, flops=n.flops, out_bytes=n.out_bytes,
                    comm_dtype=n.comm_dtype, zero=n.zero)
        t.parents = list(n.parents)
        t.children = list(n.children)
        t.input_specs = dict(n.input_specs)
    return dag


def _chips():
    return jperf.chip_spec("cpu"), tperf.chip_spec("cpu")


def _same(a, b):
    assert a.order == b.order
    assert a.start == b.start and a.finish == b.finish
    assert a.makespan == b.makespan
    assert a.bubble_ratio == b.bubble_ratio
    assert a.peak_bytes == b.peak_bytes
    assert a.memory_feasible == b.memory_feasible
    assert a.policy == b.policy
    assert {tuple(k): v for k, v in a.per_device.items()} == \
        {tuple(k): v for k, v in b.per_device.items()}


@pytest.fixture(scope="module")
def ref_dag():
    jdag, jmaps = _jax_dag()
    return jdag, jmaps, _copy_dag(jdag)


# --------------------------------------------------------------------------
# same DAG, same schedule
# --------------------------------------------------------------------------

def test_reference_dag_same_schedule(ref_dag):
    jdag, _, dag = ref_dag
    jchip, tchip = _chips()
    _same(jtask_scheduler.TaskScheduler(jdag, chip=jchip).schedule(),
          TaskScheduler(dag, chip=tchip, device_type="cpu").schedule())


@pytest.mark.parametrize("window", [0, 1, 2, 4])
@pytest.mark.parametrize("use_native", [False, True],
                         ids=["python", "native"])
def test_reference_dag_same_simulation(ref_dag, window, use_native):
    jdag, _, dag = ref_dag
    jchip, tchip = _chips()
    _same(jtask_scheduler.TaskScheduler(jdag, chip=jchip)._simulate(
              window, use_native=use_native),
          TaskScheduler(dag, chip=tchip, device_type="cpu")._simulate(
              window, use_native=use_native))


def test_reference_dag_mem_limit_same_window():
    """The reference's mem_limit case (2 stages x 6 micros, batch 2048):
    a limit between the wide and the narrow window's peaks; both
    schedulers pick the same feasible schedule (the same window), and an
    impossible limit gives the same min-peak schedule, flagged."""
    jdag, _ = _jax_dag(S=2, M=6, devs=[(0,), (1,)], batch=2048)
    dag = _copy_dag(jdag)
    jchip, tchip = _chips()

    def both(**kw):
        return (jtask_scheduler.TaskScheduler(jdag, chip=jchip, **kw),
                TaskScheduler(dag, chip=tchip, device_type="cpu", **kw))

    jw, tw = both(micro_num_limit=6)
    wide_j, wide_t = jw.schedule(), tw.schedule()
    _same(wide_j, wide_t)
    narrow = both(micro_num_limit=1)[1]._simulate(1)
    peak_wide = max(wide_t.peak_bytes.values())
    peak_narrow = max(narrow.peak_bytes.values())
    assert peak_narrow < peak_wide
    limit = (peak_wide + peak_narrow) / 2
    js, ts = both(micro_num_limit=6, mem_limit_bytes=limit)
    got_j, got_t = js.schedule(), ts.schedule()
    _same(got_j, got_t)
    assert got_t.memory_feasible
    windows = [w for w in range(1, 9)
               if ts._simulate(w, policy=got_t.policy).order == got_t.order]
    assert windows and all(
        js._simulate(w, policy=got_j.policy).order == got_j.order
        for w in windows)
    ji, ti = both(micro_num_limit=6, mem_limit_bytes=1.0)
    bad_j, bad_t = ji.schedule(), ti.schedule()
    _same(bad_j, bad_t)
    assert not bad_t.memory_feasible


def test_reference_dag_same_reports(ref_dag, tmp_path):
    """The schedule's predicted timeline, critical path, per-device lists
    and Chrome trace equal the reference's."""
    import json

    jdag, _, dag = ref_dag
    jchip, tchip = _chips()
    js = jtask_scheduler.TaskScheduler(jdag, chip=jchip).schedule()
    ts = TaskScheduler(dag, chip=tchip, device_type="cpu").schedule()
    assert ts.predicted_timeline(dag) == js.predicted_timeline(jdag)
    assert ts.critical_path(dag) == js.critical_path(jdag)
    assert ts.show_per_device(dag) == js.show_per_device(jdag)
    js.to_chrome_trace(jdag, str(tmp_path / "j.json"))
    ts.to_chrome_trace(dag, str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))


def test_async_transport_follows_device_type(ref_dag):
    """ASYNC_TRANSPORT=auto: transports hold the device on the CPU and
    only their launch on a CUDA device, as the reference's
    ``jax.default_backend()`` check does; '0' forces blocking."""
    _, _, dag = ref_dag
    _, chip = _chips()
    send = next(n for n in dag.nodes if n.task_type == TaskType.SEND)
    cpu = TaskScheduler(dag, chip=chip, device_type="cpu")
    cuda = TaskScheduler(dag, chip=chip, device_type="cuda")
    assert cpu.occupancy_time(send) == cpu.task_time(send)
    assert cuda.occupancy_time(send) < cuda.task_time(send)
    ServiceEnv.reset({"ASYNC_TRANSPORT": "0"})
    try:
        forced = TaskScheduler(dag, chip=chip, device_type="cuda")
        assert forced.occupancy_time(send) == forced.task_time(send)
    finally:
        ServiceEnv.reset()


def test_evaluator_run_pipeline_matches_reference(ref_dag):
    jdag, _, dag = ref_dag
    jchip, tchip = _chips()
    from tepdist_tpu.core.mesh import MeshTopology as JMeshTopology
    want = jevaluator.Evaluator(JMeshTopology([("data", 8)]),
                                chip=jchip).run_pipeline(jdag)
    got = Evaluator(MeshTopology([("data", 8)]),
                    chip=tchip).run_pipeline(dag)
    assert got.__dict__ == want.__dict__
    assert 0.0 <= got.bubble_ratio <= 1.0 and got.total_duration > 0


def test_port_dag_matches_reference_structure():
    """The port's own DAG for ``_mlp4`` at (2, 4): the cut carries one
    activation both ways, as the reference's does, so the task graphs have
    the same tasks, edges, wiring and transfer bytes."""
    jdag, _ = _jax_dag()
    dag, _ = build_pipeline_task_dag(_port_prog(), DEVS_2x4)
    assert len(dag.nodes) == len(jdag.nodes)
    for a, b in zip(dag.nodes, jdag.nodes):
        assert (a.task_type.value, a.name, a.stage, a.micro,
                a.device_group) == (b.task_type.value, b.name, b.stage,
                                    b.micro, tuple(b.device_group))
        assert a.parents == b.parents and a.children == b.children
        assert a.input_specs == b.input_specs
        assert a.out_bytes == b.out_bytes


# --------------------------------------------------------------------------
# native equals Python
# --------------------------------------------------------------------------

def test_native_builds_into_build_dir():
    assert native.native_available(), "g++ build of scheduler.cc failed"
    path = native.library_path()
    assert path.endswith("tepdist_tpu_torch/_build/"
                         "libtepdist_torch_sched.so")


@pytest.mark.parametrize("window", [1, 2, 4])
def test_native_matches_python_on_port_dag(window):
    prog = _port_prog(S=2, M=8, batch=64)
    dag, _ = build_pipeline_task_dag(
        prog, [tuple(range(s * 4, (s + 1) * 4)) for s in range(2)])
    sched = TaskScheduler(dag, micro_num_limit=window, device_type="cpu")
    r_py = sched._simulate(window, use_native=False)
    r_cc = sched._simulate(window, use_native=True)
    assert r_py.order == r_cc.order
    assert r_py.makespan == pytest.approx(r_cc.makespan, rel=1e-12)
    for t in r_py.start:
        assert r_py.start[t] == pytest.approx(r_cc.start[t], rel=1e-12)
    assert r_py.peak_bytes == r_cc.peak_bytes


def test_wide_dag_native_matches_python():
    """Thousands of simultaneously ready chains (the reference's wide
    case): the heap-based Python simulation and the C++ core agree."""
    dag = TaskDAG()
    for c in range(300):
        prev = None
        for k in range(3):
            n = dag.add(TaskType.COMPUTE, f"fwd_c{c}_{k}", stage=0,
                        micro=c % 8, device_group=[c % 16], flops=1e9)
            if prev is not None:
                dag.add_edge(prev, n)
            prev = n
    s = TaskScheduler(dag, device_type="cpu")
    r_native = s._simulate(0, use_native=True)
    r_py = s._simulate(0, use_native=False)
    assert r_native.order == r_py.order
    assert abs(r_native.makespan - r_py.makespan) < 1e-12
    assert r_native.peak_bytes == r_py.peak_bytes


def test_large_dag_uses_native_by_default():
    prog = _port_prog(S=4, M=16, batch=64)
    dag, _ = build_pipeline_task_dag(
        prog, [tuple(range(s * 2, (s + 1) * 2)) for s in range(4)])
    assert len(dag.nodes) >= 256
    r = TaskScheduler(dag, device_type="cpu").schedule()
    assert len(r.order) == len(dag.nodes)
    assert sorted(r.order) == list(range(len(dag.nodes)))


# --------------------------------------------------------------------------
# the verifier (the reference's tests/test_plan_verify.py cases)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prog2():
    return _port_prog(S=2, M=2, batch=8, d=16, scale=0.1)


def _fresh_plan(prog, per_stage=1):
    S = prog.num_stages
    stage_devices = [tuple(range(s * per_stage, (s + 1) * per_stage))
                     for s in range(S)]
    dag, maps = build_pipeline_task_dag(prog, stage_devices)
    return dag, maps, TaskScheduler(dag, device_type="cpu").schedule()


def test_fixture_plan_verifies_clean(prog2):
    dag, _maps, schedule = _fresh_plan(prog2)
    rep = verify_plan(dag, schedule=schedule, prog=prog2)
    assert rep.n_tasks == len(dag.nodes)
    assert "wait_cycle" in rep.checks and "signature" in rep.checks
    assert rep.peak_bytes


def test_verify_on_by_default_under_pytest_and_counts(prog2):
    assert verify_enabled()
    before = metrics().counter("plan_verified").value
    dag, _maps, schedule = _fresh_plan(prog2)
    assert maybe_verify_plan(dag, schedule=schedule, prog=prog2) is not None
    assert metrics().counter("plan_verified").value == before + 1


def test_gate_is_a_noop_when_disabled(prog2):
    env = ServiceEnv.get()
    env.set("TEPDIST_VERIFY_PLAN", False)
    try:
        dag, _maps, _sched = _fresh_plan(prog2)
        send = next(n for n in dag.nodes if n.task_type == TaskType.SEND)
        send.children.clear()
        assert maybe_verify_plan(dag) is None
    finally:
        env.set("TEPDIST_VERIFY_PLAN", True)


def _first_send(dag):
    return next(n for n in dag.nodes if n.task_type == TaskType.SEND)


def corrupt_drop_recv(dag, maps):
    send = _first_send(dag)
    recv = dag.nodes[send.children[0]]
    send.children.remove(recv.id)
    recv.parents.remove(send.id)
    recv.input_specs.pop(0, None)
    return "orphan_send", {send.id}


def corrupt_retype_send(dag, maps):
    send = _first_send(dag)
    recv = dag.nodes[send.children[0]]
    send.task_type = TaskType.COMPUTE
    return "orphan_recv", {recv.id}


def corrupt_reverse_edge(dag, maps):
    fwd = dag.node(maps.fwd_tasks[(0, 0)])
    bwd = dag.node(maps.bwd_tasks[(0, 0)])
    fwd.children.remove(bwd.id)
    bwd.parents.remove(fwd.id)
    bwd.children.append(fwd.id)
    fwd.parents.append(bwd.id)
    return "cycle", {fwd.id, bwd.id}


def corrupt_double_write(dag, maps):
    orig = maps.apply_tasks[0]
    dup = dag.add(TaskType.APPLY, "apply_s0_dup", stage=0,
                  device_group=dag.node(orig).device_group)
    return "double_write", {orig, dup.id}


def corrupt_inflate_buffer(dag, maps):
    fwd = dag.node(maps.fwd_tasks[(0, 0)])
    fwd.out_bytes = 1e18
    return "hbm_overflow", {fwd.id}


def corrupt_transfer_bytes(dag, maps):
    send = _first_send(dag)
    recv = dag.nodes[send.children[0]]
    recv.out_bytes = send.out_bytes + 1337.0
    return "transfer_bytes_mismatch", {send.id, recv.id}


def corrupt_wire_from_non_parent(dag, maps):
    bwd = dag.node(maps.bwd_tasks[(0, 0)])
    stranger = maps.fwd_tasks[(1, 1)]
    assert stranger not in bwd.parents
    bwd.input_specs[99] = (stranger, 0)
    return "structure", {bwd.id, stranger}


CORRUPTIONS = [corrupt_drop_recv, corrupt_retype_send, corrupt_reverse_edge,
               corrupt_double_write, corrupt_inflate_buffer,
               corrupt_transfer_bytes, corrupt_wire_from_non_parent]


@pytest.mark.parametrize("corrupt", CORRUPTIONS, ids=lambda c: c.__name__)
def test_verifier_rejects_each_corruption(prog2, corrupt):
    dag, maps, _sched = _fresh_plan(prog2)
    want_kind, want_tasks = corrupt(dag, maps)
    with pytest.raises(PlanVerificationError) as ei:
        verify_plan(dag, prog=prog2)
    assert ei.value.kind == want_kind, f"wanted {want_kind}, got {ei.value}"
    assert want_tasks & set(ei.value.tasks)


def test_wait_cycle_deadlock_detected(prog2):
    dag, _maps, schedule = _fresh_plan(prog2)
    dev0 = act_send = cot_recv = None
    for n in dag.nodes:
        if n.task_type == TaskType.SEND and act_send is None:
            dev0 = n.device_group
            act_send = n
        elif n.task_type == TaskType.RECV and n.device_group == dev0 \
                and dag.nodes[n.parents[0]].device_group != dev0:
            cot_recv = n
    assert act_send is not None and cot_recv is not None
    order = [t for t in schedule.order if t != cot_recv.id]
    order.insert(order.index(act_send.id), cot_recv.id)
    with pytest.raises(PlanVerificationError) as ei:
        verify_plan(dag, order=order)
    assert ei.value.kind == "wait_cycle"
    assert {act_send.id, cot_recv.id} & set(ei.value.tasks)


@pytest.mark.parametrize("bad", [("stage", 0, 99), ("stage", 5, 0)],
                         ids=["missing_output", "missing_stage"])
def test_signature_rewire_detected(prog2, bad):
    """A cross-stage input wired to an output or a stage that does not
    exist is a signature violation."""
    dag, _maps, schedule = _fresh_plan(prog2)
    s1 = prog2.stages[1]
    pos = s1.activation_positions()[0]
    saved = s1.input_def_map[pos]
    s1.input_def_map[pos] = bad
    try:
        with pytest.raises(PlanVerificationError) as ei:
            verify_plan(dag, schedule=schedule, prog=prog2)
        assert ei.value.kind == "signature"
    finally:
        s1.input_def_map[pos] = saved


def test_topo_order_cycle_names_tasks():
    dag = TaskDAG()
    a = dag.add(TaskType.COMPUTE, "a")
    b = dag.add(TaskType.COMPUTE, "b")
    dag.add_edge(a, b)
    dag.add_edge(b, a)
    with pytest.raises(TaskGraphError) as ei:
        dag.topo_order()
    assert ei.value.kind == "cycle"
    assert set(ei.value.tasks) == {a.id, b.id}


def test_add_edge_rejects_self_edge_and_conflicting_rewire():
    dag = TaskDAG()
    a = dag.add(TaskType.COMPUTE, "a")
    b = dag.add(TaskType.COMPUTE, "b")
    c = dag.add(TaskType.COMPUTE, "c")
    with pytest.raises(TaskGraphError) as ei:
        dag.add_edge(a, a)
    assert ei.value.kind == "self_edge"
    dag.add_edge(a, c, out_idx=0, arg_pos=0)
    dag.add_edge(a, c, out_idx=0, arg_pos=0)  # identical rewire: ok
    with pytest.raises(TaskGraphError) as ei:
        dag.add_edge(b, c, out_idx=0, arg_pos=0)
    assert ei.value.kind == "double_write"
    assert {a.id, b.id, c.id} == set(ei.value.tasks)


def test_validate_names_non_parent_wire():
    dag = TaskDAG()
    a = dag.add(TaskType.COMPUTE, "a")
    b = dag.add(TaskType.COMPUTE, "b")
    b.input_specs[0] = (a.id, 0)
    with pytest.raises(TaskGraphError) as ei:
        dag.validate()
    assert ei.value.kind == "structure"
    assert set(ei.value.tasks) == {b.id, a.id}


def test_verify_servable_clean_and_overflow():
    cfg = GPT2Config(vocab_size=256, n_ctx=64, n_embd=32, n_layer=2,
                     n_head=2, dtype=torch.float32)
    verify_servable(cfg, slots=2, max_len=32, buckets=[8, 16, 32])
    with pytest.raises(PlanVerificationError) as ei:
        verify_servable(cfg, slots=2, max_len=32, buckets=[8, 16, 32],
                        hbm_limit_bytes=1e4)
    assert ei.value.kind == "hbm_overflow"
    for bad in (dict(slots=2, buckets=[16, 8]), dict(slots=0, buckets=[8]),
                dict(slots=2, buckets=[8, 64])):
        with pytest.raises(PlanVerificationError):
            verify_servable(cfg, max_len=32, **bad)
    verify_servable(cfg, slots=1, max_len=32, buckets=[8, 32],
                    kv_mode="paged", page_size=8, n_pages=4)
    with pytest.raises(PlanVerificationError):
        verify_servable(cfg, slots=1, max_len=32, buckets=[8, 32],
                        kv_mode="paged", page_size=8, n_pages=3)


# --------------------------------------------------------------------------
# properties of the port's own DAG (the reference's tests/test_runtime.py)
# --------------------------------------------------------------------------

def test_dag_structure():
    dag, maps = build_pipeline_task_dag(_port_prog(), DEVS_2x4)
    types = [n.task_type for n in dag.nodes]
    assert types.count(TaskType.COMPUTE) == 2 * 2 * 4
    assert types.count(TaskType.GA) == 2 * 4
    assert types.count(TaskType.GAINIT) == 2
    assert types.count(TaskType.APPLY) == 2
    assert types.count(TaskType.SEND) >= 4
    dag.validate()
    f1 = dag.node(maps.fwd_tasks[(1, 0)])
    assert any(dag.node(pid).task_type == TaskType.RECV for pid in f1.parents)


def test_schedule_is_1f1b_at_window_1():
    dag, maps = build_pipeline_task_dag(_port_prog(), DEVS_2x4)
    sched = TaskScheduler(dag, micro_num_limit=1,
                          device_type="cpu")._simulate(1)
    assert len(sched.order) == len(dag.nodes)
    pos = {tid: i for i, tid in enumerate(sched.order)}
    for m in range(2):
        assert pos[maps.bwd_tasks[(0, m)]] < pos[maps.fwd_tasks[(0, m + 2)]]
    assert sched.makespan > 0
    assert 0.0 <= sched.bubble_ratio <= 1.0
    assert sched.peak_bytes


def test_schedule_overlaps_stages():
    dag, _ = build_pipeline_task_dag(_port_prog(), DEVS_2x4)
    ts = TaskScheduler(dag, device_type="cpu")
    serial = sum(ts.task_time(n) for n in dag.nodes)
    assert ts.schedule().makespan < serial


def test_gc_plan_releases_buffers():
    dag, _ = build_pipeline_task_dag(_port_prog(), DEVS_2x4)
    dag.build_gc_plan()
    released = [rid for n in dag.nodes for rid in n.mem_to_release]
    assert released
    assert len(released) == len(set(released))


def test_pp_bandwidth_knob():
    dag, _ = build_pipeline_task_dag(_port_prog(), [(0,), (1,)])
    try:
        ServiceEnv.reset({"PP_BANDWIDTH": "0.0001"})
        slow = TaskScheduler(dag, device_type="cpu").schedule().makespan
        ServiceEnv.reset({"PP_BANDWIDTH": "1000"})
        fast = TaskScheduler(dag, device_type="cpu").schedule().makespan
        assert slow > fast * 2
    finally:
        ServiceEnv.reset()


def test_runtime_modules_import_without_jax():
    """The runtime modules, the native loader and the verifier alone in a
    fresh interpreter: no jax, nothing of the JAX package."""
    import os
    import subprocess
    import sys

    probe = (
        "import sys\n"
        "import tepdist_tpu_torch.runtime.executor, "
        "tepdist_tpu_torch.analysis.plan_verify, tepdist_tpu_torch.native, "
        "tepdist_tpu_torch.parallel.pipeline\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'tepdist_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
