"""TaskScheduler: discrete-event simulation → per-device static task lists.

A copy of the JAX package's ``runtime/task_scheduler.py``, with one change:
``ASYNC_TRANSPORT=auto`` reads whether the executor's devices are CUDA
devices (the ``device_type`` the executor passes in), where the JAX package
reads ``jax.default_backend()``. The native core is the port's own build of
the same ``scheduler.cc`` (``tepdist_tpu_torch/native``). Keep the two in
step.

Reference parity: ``TaskScheduler::Schedule`` (reference:
pjrt/task_scheduler.{h,cc}: ClusterState→MachineState→DevState hierarchy,
per-device ready queues, per-task time estimates, memory accounting with OOM
state, ``MICRO_NUM_LIMIT`` in-flight micro-batch cap, ``GROUP_SCHED_COUNT``
candidate schedules, Reorder post-passes). The simulated order is the static
execution order — deadlock-freedom is proven before anything runs.

The in-flight cap is what turns the greedy list schedule into 1F1B: once
``MICRO_NUM_LIMIT`` forwards are outstanding on a stage, its backward tasks
outrank further forwards.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.parallel.performance_utils import (
    ALPHA_S,
    PerfUtils,
    chip_spec,
)
from tepdist_tpu_torch.runtime.task_graph import TaskDAG, TaskNode, TaskType

# Device-occupying WORK for bubble accounting: compute, gradient
# accumulation, optimizer apply, and collectives all hold the device and
# are not pipeline bubble; transport tasks (SEND/RECV) model link latency
# and stay outside "busy" (reference: bubble = pipeline idle, DevState
# busy spans, pjrt/task_scheduler.h).
_BUSY_TYPES = (TaskType.COMPUTE, TaskType.GA, TaskType.GAINIT,
               TaskType.APPLY, TaskType.AR)


@dataclasses.dataclass
class ScheduleResult:
    order: List[int]                          # global start order (task ids)
    per_device: Dict[Tuple[int, ...], List[int]]  # device-group -> task ids
    start: Dict[int, float]
    finish: Dict[int, float]
    makespan: float
    peak_bytes: Dict[int, float]              # per global device id
    bubble_ratio: float
    # Whether max(peak_bytes) fits the scheduler's mem_limit_bytes (always
    # True when no limit is set). Reference: DevState OOM accounting,
    # pjrt/task_scheduler.h:86-180 — an OOM schedule is never selected
    # while a feasible candidate window exists.
    memory_feasible: bool = True
    # Which priority policy produced this schedule ("standard" 1F1B or
    # "interleaved" Megatron-1F1B chunk alternation).
    policy: str = "standard"

    def device_list(self, dev: int) -> List[int]:
        out = []
        for group, tasks in self.per_device.items():
            if dev in group:
                out.extend(tasks)
        return sorted(out, key=lambda t: self.start[t])

    def predicted_timeline(self, dag) -> List[Dict[str, object]]:
        """Structured per-task predicted schedule keyed by task id — the
        join surface for telemetry/fidelity.py. Measured spans carry the
        same ``task`` id (worker_plan.py / executor.py tag them), so
        predicted-vs-measured is an exact id join, not a name match.
        ``parents`` rides along so a dumped trace file is a self-contained
        fidelity input (critical-path walks need the dependency edges)."""
        out: List[Dict[str, object]] = []
        for tid in self.order:
            n = dag.node(tid)
            out.append({
                "task": tid,
                "name": n.name,
                "kind": n.task_type.value,
                "stage": n.stage,
                "micro": n.micro,
                "worker": n.worker_id,
                "devices": list(n.device_group),
                "bytes": float(n.out_bytes),
                "parents": list(n.parents),
                "start_us": self.start[tid] * 1e6,
                "dur_us": (self.finish[tid] - self.start[tid]) * 1e6,
            })
        return out

    def critical_path(self, dag) -> List[int]:
        """Task ids along the simulated critical path (first -> last):
        from the last-finishing task, walk the latest-finishing
        predecessor (DAG parent or the preceding occupant of a shared
        device) back to a source."""
        from tepdist_tpu_torch.telemetry.fidelity import timeline_critical_path
        return timeline_critical_path(self.predicted_timeline(dag))

    def show_per_device(self, dag, max_tasks: int = 0) -> str:
        """Printable per-device static task lists (reference:
        ShowPerDeviceTaskList, execution_plan.h:187, gated by DEBUG)."""
        lines = []
        devs = sorted({d for g in self.per_device for d in g})
        for d in devs:
            tasks = self.device_list(d)
            if max_tasks:
                tasks = tasks[:max_tasks]
            names = [dag.node(t).key() for t in tasks]
            lines.append(f"device {d}: " + " -> ".join(names))
        return "\n".join(lines)

    # Predicted lanes sit at tid >= _SIM_TID_BASE inside each worker's
    # process group, so they stack NEXT TO the measured thread lanes
    # (which are small per-thread indices) instead of on top of them.
    _SIM_TID_BASE = 10000

    def to_chrome_trace(self, dag, path: str,
                        clock_base_us: float = 0.0,
                        flow: bool = True) -> None:
        """Export the simulated schedule as a Chrome trace (chrome://tracing
        / Perfetto), aligned with the MEASURED fleet trace
        (``session.dump_trace()``, telemetry/export.py): same ``pid`` =
        worker task_index, named ``sim:devN`` lanes, and — when
        ``clock_base_us`` is set to the measured step's start timestamp —
        the same clock base, so predicted and measured timelines load
        side-by-side in one Perfetto view. ``flow=True`` adds flow arrows
        task->task along the predicted critical path."""
        import json

        events = []
        seen_pids = set()
        seen_tids = set()
        for tid in self.order:
            n = dag.node(tid)
            pid = n.worker_id
            if pid not in seen_pids:
                seen_pids.add(pid)
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0, "ts": 0, "dur": 0,
                               "args": {"name": f"worker{pid}"}})
            for d in (n.device_group or (0,)):
                lane = self._SIM_TID_BASE + d
                if (pid, lane) not in seen_tids:
                    seen_tids.add((pid, lane))
                    events.append({"name": "thread_name", "ph": "M",
                                   "pid": pid, "tid": lane, "ts": 0,
                                   "dur": 0,
                                   "args": {"name": f"sim:dev{d}"}})
                events.append({
                    "name": n.name,
                    "cat": n.task_type.value,
                    "ph": "X",
                    "ts": clock_base_us + self.start[tid] * 1e6,
                    "dur": max((self.finish[tid] - self.start[tid]) * 1e6,
                               0.01),
                    "pid": pid,
                    "tid": lane,
                    "args": {"task": tid, "stage": n.stage,
                             "micro": n.micro, "predicted": True},
                })
        if flow:
            cp = self.critical_path(dag)
            for i, (a, b) in enumerate(zip(cp, cp[1:])):
                na, nb = dag.node(a), dag.node(b)
                lane_a = self._SIM_TID_BASE + (na.device_group or (0,))[0]
                lane_b = self._SIM_TID_BASE + (nb.device_group or (0,))[0]
                common = {"name": "critical_path", "cat": "sim",
                          "id": i + 1, "dur": 0}
                events.append({**common, "ph": "s", "pid": na.worker_id,
                               "tid": lane_a,
                               "ts": clock_base_us
                               + self.finish[a] * 1e6 - 0.005})
                events.append({**common, "ph": "f", "bp": "e",
                               "pid": nb.worker_id, "tid": lane_b,
                               "ts": clock_base_us + self.start[b] * 1e6})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)


class TaskScheduler:
    """List scheduler over a TaskDAG with simulated time + memory."""

    def __init__(self, dag: TaskDAG, chip=None,
                 micro_num_limit: Optional[int] = None,
                 mem_limit_bytes: Optional[float] = None,
                 device_type: Optional[str] = None):
        """``device_type``: the type of the devices the DAG will run on
        ("cuda" or "cpu"; the executor passes its own), which decides
        ``ASYNC_TRANSPORT=auto``. None reads the default device: "cuda"
        when a CUDA device is present, as the JAX package reads its
        default backend."""
        env = ServiceEnv.get()
        self.dag = dag
        self.device_type = device_type
        self.spec = chip or chip_spec()
        self.micro_limit = (micro_num_limit if micro_num_limit is not None
                            else env.micro_num_limit)
        self.mem_limit = mem_limit_bytes

    # -- time model -------------------------------------------------------
    def occupancy_time(self, n: TaskNode) -> float:
        """How long the task HOLDS its devices. Transport tasks (SEND/
        RECV) are async copies on an accelerator — the device pays only
        the launch alpha while the wire latency gates the CONSUMER
        (task_time), so extra pipeline hops (interleaved placements) do
        not serialize against compute (reference: ASYNC_SEND/ASYNC_RECV,
        service_env.h:46-47). On the CPU a transport IS the device (the
        copy runs on it), so ASYNC_TRANSPORT=auto keeps the schedule
        model faithful to the devices it will run on; '1'/'0' force."""
        if (n.task_type in (TaskType.SEND, TaskType.RECV)
                and self._async_transport()):
            # The HOST dispatch floor is paid regardless — only the WIRE
            # time collapses to the launch alpha.
            return self._host_floor_s() + min(self._device_time(n), ALPHA_S)
        return self.task_time(n)

    def _host_floor_s(self) -> float:
        """Per-task host dispatch floor, seconds. A calibration profile
        (TEPDIST_CALIB_PROFILE, telemetry/calibrate.py) carries the
        MEASURED floor and beats the TASK_OVERHEAD_US default."""
        from tepdist_tpu_torch.telemetry.calibrate import active_profile
        prof = active_profile()
        if prof is not None and prof.task_overhead_us > 0:
            return prof.task_overhead_us * 1e-6
        return ServiceEnv.get().task_overhead_us * 1e-6

    def _async_transport(self) -> bool:
        mode = ServiceEnv.get().async_transport.lower()
        if mode in ("1", "true", "on", "yes"):
            return True
        if mode in ("0", "false", "off", "no"):
            return False
        if mode != "auto":
            import warnings
            warnings.warn(f"unknown ASYNC_TRANSPORT={mode!r}; using auto")
        if not hasattr(self, "_async_auto"):
            device_type = self.device_type
            if device_type is None:
                import torch
                device_type = "cuda" if torch.cuda.is_available() else "cpu"
            self._async_auto = device_type != "cpu"
        return self._async_auto

    def task_time(self, n: TaskNode) -> float:
        # Per-task host dispatch floor (TASK_OVERHEAD_US, or a fitted
        # calibration profile): every task is a host-side dispatch (a
        # stage call, a copy or a store). 0 by default — on an accelerator
        # the host work overlaps long device compute — but on the CPU it is
        # the measured per-task floor.
        return self._host_floor_s() + self._device_time(n)

    def _device_time(self, n: TaskNode) -> float:
        if n.task_type == TaskType.COMPUTE:
            ndev = max(len(n.device_group), 1)
            return max(PerfUtils.compute_time(n.flops / ndev, self.spec), 1e-7)
        if n.task_type in (TaskType.SEND, TaskType.RECV):
            env = ServiceEnv.get()
            if env.pp_bandwidth > 0:
                # PP_BANDWIDTH knob: cross-stage transfer bandwidth override
                # (reference: PP_BANDWIDTH GB/s, service_env.h:63).
                return max(n.out_bytes / (env.pp_bandwidth * 1e9), 1e-7)
            # Cross-worker hops ride DCN, intra-worker hops ride ICI
            # (reference: cross-stage transfer on inter-node bandwidth,
            # evaluator.cc:131).
            peers = (n.children if n.task_type == TaskType.SEND
                     else n.parents)
            over_dcn = any(self.dag.nodes[p].worker_id != n.worker_id
                           for p in peers)
            # Comm-dtype-tagged transfers ride the shrunk wire plus the
            # quantize/dequantize term (performance_utils).
            return max(PerfUtils.compressed_ppermute_cost(
                n.out_bytes, getattr(n, "comm_dtype", ""), self.spec,
                over_dcn=over_dcn), 1e-7)
        if n.task_type == TaskType.AR:
            ndev = max(len(n.device_group), 1)
            return max(PerfUtils.compressed_all_reduce_cost(
                n.out_bytes, ndev, getattr(n, "comm_dtype", ""),
                self.spec), 1e-7)
        if n.task_type in (TaskType.GA, TaskType.GAINIT, TaskType.APPLY):
            return max(PerfUtils.hbm_time(n.out_bytes, self.spec), 1e-7)
        return 1e-8

    # -- priority policies ------------------------------------------------
    def _interleave_factors(self) -> Optional[Tuple[int, int]]:
        """(G device groups, v chunks per group) when the DAG runs MORE
        pipeline stages than device groups (interleaved placement, stage
        s -> group s % G); None for blocked placements. Cached — called
        per policy/rank/window within one schedule()."""
        if hasattr(self, "_ifactors"):
            return self._ifactors
        stages = {n.stage for n in self.dag.nodes
                  if n.task_type == TaskType.COMPUTE and n.stage >= 0}
        groups = {tuple(n.device_group) for n in self.dag.nodes
                  if n.task_type == TaskType.COMPUTE and n.device_group}
        S, G = len(stages), len(groups)
        self._ifactors = ((G, S // G)
                          if G >= 1 and S > G and S % G == 0 else None)
        return self._ifactors

    def _ranks(self, policy: str) -> List[int]:
        """Per-task priority rank (lower starts first; ties by id) — THE
        scheduling policy, shared verbatim with the native core.

        standard: (micro, bwd-before-fwd) — classic 1F1B drain-over-fill.

        Cached per policy (schedule() simulates every (policy, window)
        candidate; ranks depend only on the policy).

        interleaved (reference: the Megatron interleaved-1F1B order the
        reference approximates with Reorder post-passes,
        task_scheduler.h:347-374): each device holds v model chunks
        (virtual stages); micros advance in ROUNDS of G, and within a
        round a device runs chunk 0's G forwards before chunk 1's — the
        virtual micro index vm = (m//G)*v*G + chunk*G + m%G linearizes
        that order, with backwards draining chunks in reverse."""
        cache = getattr(self, "_rank_cache", None)
        if cache is None:
            cache = self._rank_cache = {}
        if policy in cache:
            return cache[policy]
        factors = self._interleave_factors()
        ranks: List[int] = []
        for n in self.dag.nodes:
            m = n.micro if n.micro >= 0 else 0
            bwd = (n.task_type == TaskType.COMPUTE and "bwd" in n.name)
            if policy == "standard" or factors is None:
                ranks.append(m * 2 + (0 if bwd else 1))
                continue
            G, v = factors
            c = n.stage // G if n.stage >= 0 else 0
            cc = (v - 1 - c) if bwd else c
            vm = (m // G) * v * G + cc * G + (m % G)
            ranks.append(vm * 2 + (0 if bwd else 1))
        cache[policy] = ranks
        return ranks

    def _policies(self) -> List[str]:
        return (["standard", "interleaved"]
                if self._interleave_factors() is not None
                else ["standard"])

    # -- scheduling -------------------------------------------------------
    def schedule(self) -> ScheduleResult:
        """Try GROUP_SCHED_COUNT window policies x priority policies, keep
        the best makespan among memory-feasible candidates (reference:
        candidate schedules loop + Reorder post-passes + DevState OOM
        state, pjrt/task_scheduler.h:86-180,347-374). Wider 1F1B windows
        trade peak activation memory for bubble time; when a window's
        simulated peak exceeds ``mem_limit_bytes`` it is rejected, and if
        every candidate is infeasible the search walks *narrower* windows
        (fewer in-flight micros) until one fits. Only when no window fits
        at all is the min-peak schedule returned, flagged
        ``memory_feasible=False``. Interleaved placements additionally
        try the Megatron chunk-alternating priority (see _ranks) — the
        best simulated candidate wins, so the policy never regresses a
        blocked layout."""
        env = ServiceEnv.get()
        windows = [self.micro_limit]
        for delta in range(1, env.group_sched_count):
            w = self.micro_limit + delta
            windows.append(w)
        windows = windows[: env.group_sched_count]
        factors = self._interleave_factors()
        if factors is not None:
            # A device holding v chunks at per-virtual-stage window w has
            # ~v*w micros resident — each 1/v the blocked activation size
            # — so the v-scaled windows are the SAME memory class as the
            # blocked candidates (the mem_limit gate still arbitrates).
            v = factors[1]
            windows += [w * v for w in windows if w * v not in windows]
        results = [self._simulate(w, policy=p)
                   for p in self._policies() for w in windows]
        if self.mem_limit is not None:
            for r in results:
                r.memory_feasible = (
                    max(r.peak_bytes.values(), default=0.0) <= self.mem_limit)
            feasible = [r for r in results if r.memory_feasible]
            if not feasible:
                for w in range(self.micro_limit - 1, 0, -1):
                    for p in self._policies():
                        r = self._simulate(w, policy=p)
                        r.memory_feasible = (
                            max(r.peak_bytes.values(), default=0.0)
                            <= self.mem_limit)
                        results.append(r)
                        if r.memory_feasible:
                            feasible.append(r)
                    if feasible:
                        break
            if feasible:
                return min(feasible, key=lambda r: r.makespan)
            # Nothing fits: surface the least-bad schedule, flagged.
            return min(results,
                       key=lambda r: max(r.peak_bytes.values(), default=0.0))
        return min(results, key=lambda r: r.makespan)

    def _simulate(self, window: int, use_native: Optional[bool] = None,
                  policy: str = "standard") -> ScheduleResult:
        if use_native is None:
            use_native = len(self.dag.nodes) >= 256  # amortize call overhead
        ranks = self._ranks(policy)
        if use_native:
            r = self._simulate_native(window, ranks)
            if r is not None:
                r.policy = policy
                return r
        r = self._simulate_py(window, ranks)
        r.policy = policy
        return r

    def _native_arrays(self):
        """Marshal the DAG once per scheduler (schedule() simulates several
        candidate windows; only `window` changes between them)."""
        if getattr(self, "_marshalled", None) is None:
            from tepdist_tpu_torch import native

            dag = self.dag
            kind, dur, occ, stage, micro, groups, children, n_parents = (
                [], [], [], [], [], [], [], [])
            for n in dag.nodes:
                if n.task_type == TaskType.COMPUTE and "bwd" in n.name:
                    kind.append(native.KIND_BWD)
                elif n.task_type == TaskType.COMPUTE and "fwd" in n.name:
                    kind.append(native.KIND_FWD)
                else:
                    kind.append(native.KIND_OTHER)
                dur.append(self.task_time(n))
                occ.append(self.occupancy_time(n))
                stage.append(n.stage)
                micro.append(n.micro)
                groups.append(list(n.device_group))
                children.append(list(n.children))
                n_parents.append(len(n.parents))
            self._marshalled = (kind, dur, occ, stage, micro, groups,
                                children, n_parents)
        return self._marshalled

    def _simulate_native(self, window: int,
                         ranks: Optional[List[int]] = None
                         ) -> Optional[ScheduleResult]:
        """C++ simulation core (tepdist_tpu_torch/native/scheduler.cc); produces
        bit-identical schedules to the Python loop (tested)."""
        from tepdist_tpu_torch import native

        dag = self.dag
        (kind, dur, occ, stage, micro, groups, children,
         n_parents) = self._native_arrays()
        res = native.schedule_native(kind, dur, occ, stage, micro, groups,
                                     children, n_parents, window,
                                     rank=ranks)
        if res is None:
            return None
        order_a, start_a, finish_a = res
        order = [int(t) for t in order_a]
        start = {t: float(start_a[t]) for t in order}
        finish = {t: float(finish_a[t]) for t in order}
        per_device: Dict[Tuple[int, ...], List[int]] = {}
        sim_busy: Dict[int, float] = {}
        for t in order:
            n = dag.node(t)
            per_device.setdefault(tuple(n.device_group), []).append(t)
            for d in n.device_group:
                sim_busy[d] = sim_busy.get(d, 0.0) + (
                    dur[t] if n.task_type in _BUSY_TYPES else 0.0)
        makespan = max(finish.values(), default=0.0)
        peak = self._memory_account(order)
        ndev = max(len({d for g in per_device for d in g}), 1)
        bubble = (1.0 - sum(sim_busy.values()) / (ndev * makespan)
                  if makespan > 0 else 0.0)
        return ScheduleResult(order, per_device, start, finish, makespan,
                              peak, bubble)

    def _simulate_py(self, window: int,
                     ranks: Optional[List[int]] = None) -> ScheduleResult:
        """Event-driven simulation (reference: ClusterState::ScheduleNextTask
        + MarkTaskDoneByTime, pjrt/task_scheduler.cc): a task STARTS only
        when every parent has *finished in simulated time* and its devices
        are free — not merely when parents have been scheduled. That
        time-gating is what creates run-ahead: while micro 0's backward is
        still in flight downstream, stage 0's device is free and starts
        micro 1's forward. The 1F1B window is a hard admission gate on that
        run-ahead (fwd of a new micro may not start while ``window`` micros
        are in flight on its stage), which is exactly the bubble-vs-peak-
        memory trade the mem_limit search explores."""
        dag = self.dag
        if ranks is None:
            ranks = self._ranks("standard")
        indeg = {n.id: len(n.parents) for n in dag.nodes}
        dev_free: Dict[int, float] = {}
        for n in dag.nodes:
            for d in n.device_group:
                dev_free.setdefault(d, 0.0)
        task_finish: Dict[int, float] = {}
        start: Dict[int, float] = {}
        order: List[int] = []
        per_device: Dict[Tuple[int, ...], List[int]] = {}
        # in-flight micro-batches per stage: fwd STARTED, bwd not FINISHED.
        inflight: Dict[int, set] = {}

        def is_bwd(n: TaskNode) -> bool:
            return n.task_type == TaskType.COMPUTE and "bwd" in n.name

        def is_fwd(n: TaskNode) -> bool:
            return n.task_type == TaskType.COMPUTE and "fwd" in n.name

        def priority(n: TaskNode) -> Tuple:
            # Among startable tasks: lower policy rank first (standard:
            # micro asc, backward before forward — drain beats fill at
            # equal micro), stable by id. Ranks come from _ranks() so the
            # native core orders identically.
            return (ranks[n.id], n.id)

        # ready: dep-satisfied, unstarted tasks as a PRIORITY HEAP. A popped
        # task that cannot start yet is PARKED on the resource blocking it
        # (one busy device, or its stage's full 1F1B window) and re-enters
        # the heap when exactly that resource frees — each task is pushed
        # O(|device_group| + window events) times instead of the old
        # rescan-the-whole-pool-per-start O(N*pool). Start order is
        # unchanged: at any instant the heap pops the same minimum-priority
        # startable task the linear scan chose (the native C++ core's
        # bit-identical contract is asserted by tests/test_native_scheduler).
        ready: List[Tuple[Tuple, int]] = [
            (priority(n), n.id) for n in dag.nodes if indeg[n.id] == 0]
        heapq.heapify(ready)
        dev_parked: Dict[int, List[Tuple[Tuple, int]]] = {}
        win_parked: Dict[int, List[Tuple[Tuple, int]]] = {}
        events: List[Tuple[float, int]] = []   # (finish_time, task id)
        sim_busy: Dict[int, float] = {}
        t_now = 0.0

        def drain_ready() -> None:
            while ready:
                pr, tid = heapq.heappop(ready)
                n = dag.node(tid)
                busy = next((d for d in n.device_group
                             if dev_free[d] > t_now), None)
                if busy is not None:
                    dev_parked.setdefault(busy, []).append((pr, tid))
                    continue
                if (is_fwd(n) and window > 0 and n.micro not in
                        inflight.get(n.stage, ()) and
                        len(inflight.get(n.stage, ())) >= window):
                    win_parked.setdefault(n.stage, []).append((pr, tid))
                    continue        # 1F1B gate: stage window full
                dur = self.task_time(n)
                occ = self.occupancy_time(n)
                start[tid] = t_now
                fin = t_now + dur
                order.append(tid)
                per_device.setdefault(tuple(n.device_group), []).append(tid)
                for d in n.device_group:
                    dev_free[d] = t_now + occ
                    sim_busy[d] = sim_busy.get(d, 0.0) + (
                        dur if n.task_type in _BUSY_TYPES else 0.0)
                if is_fwd(n):
                    inflight.setdefault(n.stage, set()).add(n.micro)
                heapq.heappush(events, (fin, tid))
                if occ < dur:
                    # Async transport: the device frees before the wire
                    # latency elapses — a sentinel wake event lets parked
                    # work start at the release instant.
                    heapq.heappush(events, (t_now + occ, -1))

        while len(order) < len(dag.nodes):
            drain_ready()
            if not events:
                raise RuntimeError("schedule deadlock: DAG not fully drained")
            # Advance to the next completion instant; process every event at
            # that time before starting more work (ties by id via the heap).
            t_now, tid = heapq.heappop(events)
            finished = [tid]
            while events and events[0][0] == t_now:
                finished.append(heapq.heappop(events)[1])
            for tid in finished:
                if tid < 0:
                    continue        # sentinel: device-release wake only
                n = dag.node(tid)
                task_finish[tid] = t_now
                if is_bwd(n):
                    inflight.setdefault(n.stage, set()).discard(n.micro)
                    for item in win_parked.pop(n.stage, []):
                        heapq.heappush(ready, item)
                for c in n.children:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        heapq.heappush(ready,
                                       (priority(dag.node(c)), c))
            # Wake parked work on every device free at this instant (a
            # task finish or an async-transport occupancy release).
            for d in list(dev_parked):
                if dev_free[d] <= t_now:
                    for item in dev_parked.pop(d, []):
                        heapq.heappush(ready, item)

        makespan = max(task_finish.values(), default=0.0)
        peak = self._memory_account(order)
        busy = sum(sim_busy.values())
        ndev = max(len(dev_free), 1)
        bubble = 1.0 - busy / (ndev * makespan) if makespan > 0 else 0.0
        return ScheduleResult(order, per_device, start, task_finish,
                              makespan, peak, bubble)

    def _memory_account(self, order: List[int]) -> Dict[int, float]:
        """Replay the schedule tracking live output bytes per device
        (reference: DevState memory accounting with OOM state)."""
        self.dag.build_gc_plan(order)
        live: Dict[int, float] = {}
        peak: Dict[int, float] = {}
        alive_bytes: Dict[int, float] = {}
        for tid in order:
            n = self.dag.node(tid)
            share = n.out_bytes / max(len(n.device_group), 1)
            alive_bytes[tid] = share
            for d in n.device_group:
                live[d] = live.get(d, 0.0) + share
                peak[d] = max(peak.get(d, 0.0), live[d])
            for rid in n.mem_to_release:
                r = self.dag.node(rid)
                rshare = alive_bytes.get(rid, 0.0)
                for d in r.device_group:
                    live[d] = live.get(d, 0.0) - rshare
        return peak
