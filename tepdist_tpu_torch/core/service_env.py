"""Declarative env/config knob table (reference: service_env.h:37-66).

A copy of ``tepdist_tpu/core/service_env.py``: the port cannot import it,
since importing anything under ``tepdist_tpu`` imports jax. Keep the two
knob tables in step. The port's training path reads REMAT_POLICY,
NUM_MICRO_BATCHES, FP16_COMM and DEBUG.

Every knob is readable from the environment or a JSON config file
(``TEPDIST_CONFIG`` or ``config.json`` in the CWD), with env taking
precedence — matching the reference's ``SERVICE_ENV_LIST`` +
``LoadConfigFileSettings`` behavior. Knobs keep the reference's names where
the concept carried over; CUDA/NCCL-only knobs were dropped and TPU knobs
added (marked [tpu]).
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

_DEF = object()

# (name, type, default, help)
_ENV_LIST: List[Tuple[str, type, Any, str]] = [
    ("DEBUG", bool, False, "verbose task/step logging"),
    ("CLUSTER_SPEC", str, "", "json cluster topology (multi-host)"),
    ("RULE_MODE", bool, False, "use fast rule-based SPMD inference, skip ILP"),
    ("IGNORE_ANNOTATION", bool, False, "ignore user sharding annotations"),
    ("AUX_AFFINITY", bool, True, "variable<->optimizer-state affinity terms in ILP"),
    ("COST_FACTOR", float, 1.0, "scale factor on comm costs"),
    ("COMM_OVERLAP", float, 0.3, "fraction of collective time hidden under "
     "compute (XLA async collectives); evaluator prices exposed_comm = "
     "(1 - COMM_OVERLAP) * comm"),
    ("FP16_COMM", bool, False, "compress gradient all-reduce to bf16 [tpu: bf16]"),
    ("NUM_GRADIENTS", int, -1, "compat: gradients are detected structurally"),
    ("FORWARD_SUB_GRAPH_NUM", int, -1, "compat alias: see SUBGRAPH_NODES"),
    ("SUBGRAPH_NODES", int, 20000, "graph nodes above which CostSpmdStrategy "
     "cuts into subgraphs + DP (reference FindSubGraphs; 0 = whole-graph ILP"
     " always)"),
    ("SUBGRAPH_BEAM", int, 3, "beam width over boundary-strategy states in "
     "subgraph DP; data-picked (tests/test_subgraph_dp.py beam curve: "
     "beam=2 already exact on transformer grad graphs with lookahead, "
     "3 = +1 margin)"),
    ("SUBGRAPH_WIDTH", int, 4, "max interface vars for the forced-boundary "
     "DP variant (wider interfaces: natural variant only)"),
    ("VAR_MEM_LIMIT", int, -1, "per-device variable bytes before ZeRO splitting"),
    ("OPT_LEVEL", int, 2, "planner effort: 0 rule, 1 config, 2 exploration"),
    ("UNBALANCED_RATIO", float, 8.0, "pipeline stage flops imbalance tolerance"),
    ("NUM_MICRO_BATCHES", int, -1, "fixed micro-batch count (config mode)"),
    ("NUM_STAGES", int, -1, "fixed pipeline stage count (config mode)"),
    ("INTRA_STAGE_TP", int, -1,
     "model-parallel degree within each pipeline stage (stage x spmd "
     "nesting, config mode; -1 = planner/exploration decides)"),
    ("MICRO_NUM_LIMIT", int, 2, "max in-flight micro-batches (1F1B window)"),
    ("GROUP_SCHED_COUNT", int, 3, "candidate schedules tried by TaskScheduler"),
    ("PP_BANDWIDTH", float, 0.0, "pipeline xfer bandwidth GB/s override "
     "(0 = auto: ICI intra-worker, DCN cross-worker; reference fixed 16)"),
    ("ILP_TIME_LIMIT", float, 5.0, "ILP solver time limit (s)"),
    ("ILP_NUM_THREADS", int, 0, "compat: scipy/HiGHS milp is single-threaded"),
    ("GLUE_WALK_HOPS", int, 64, "max glue-chain depth when translating comm "
     "edge demands back to their producers (CostSpmdStrategy._collect_edges; "
     "the walk is memoized, so the cap only guards recursion depth — edges "
     "past it are dropped from the ILP objective with a warning)"),
    ("FAKE_INPUT", bool, False, "reuse first batch forever (benchmark mode)"),
    # Accepted for config compatibility with the reference; no-ops on TPU
    # (the mechanism they tune does not exist here — see help text).
    ("BUFFER_SAVE", bool, False, "compat no-op: XLA owns buffer reuse"),
    ("EARLY_GA", bool, False, "compat no-op: GA order is the scheduler's"),
    ("ASYNC_RECV", bool, True, "compat no-op: PJRT dispatch is async"),
    ("ASYNC_SEND", bool, True, "compat no-op: PJRT dispatch is async"),
    ("MULTI_REORDER", bool, False, "compat no-op: candidate windows instead"),
    ("DISABLE_BUFFER_ALIAS", bool, False,
     "compat: disables state-buffer donation"),
    ("DUMP_LLVM_PTX", bool, False, "compat no-op: no PTX on TPU"),
    ("FRONTEND", str, "JAX", "client frontend identifier"),
    ("FETCH_RESOURCE_VAR_STEPS", int, 0, "fetch vars to client every N steps"),
    # --- TPU-native knobs -------------------------------------------------
    ("TPU_GENERATION", str, "h100", "chip for the cost model (a key of "
     "parallel/performance_utils.CHIPS)"),
    ("ICI_BANDWIDTH", float, -1.0, "[tpu] override ICI GB/s per link"),
    ("DCN_BANDWIDTH", float, -1.0, "[tpu] override DCN GB/s per host"),
    ("HBM_GB", float, -1.0, "[tpu] override per-device HBM GB for the cost "
     "model (reference: the MEMORY per-device byte default, "
     "evaluator.h:53)"),
    ("ASYNC_TRANSPORT", str, "auto", "[tpu] scheduler transport occupancy: "
     "'auto' = async DMA (launch-alpha device hold) on accelerator "
     "backends, device-blocking on the CPU mesh (where device_put IS the "
     "device); '1'/'0' force"),
    ("TASK_OVERHEAD_US", float, 0.0, "[tpu] per-task HOST dispatch "
     "overhead (us) added to every task in the schedule model; 0 = pure "
     "device model (overheads overlap long device compute). The CPU-mesh "
     "measured validation calibrates it to the Python dispatch floor"),
    ("REMAT_POLICY", str, "none", "[tpu] jax.checkpoint policy for stages"),
    ("DONATE_ARGS", bool, True, "[tpu] donate variable buffers into the step"),
    # --- RPC hot path -----------------------------------------------------
    ("TEPDIST_BATCH_DISPATCH", bool, True, "coalesce the master's per-step "
     "fleet dispatch into ONE ExecuteStepSlice RPC per worker (micro-batch "
     "slices + the execute trigger ride a single envelope, results return "
     "in one reply); 0 = legacy per-verb path (TransferHostRawData pushes "
     "+ ExecuteRemotePlan)"),
    ("TEPDIST_SEND_OVERLAP", bool, True, "workers overlap host-push "
     "activation serde + the peer RPC with the tail of compute (async "
     "send pool, joined at step end); 0 = synchronous sends inside the "
     "task loop"),
    ("TEPDIST_WIRE_DTYPE", str, "", "opt-in wire dtype for fleet tensor "
     "payloads — worker host-push activations AND master dispatch "
     "envelopes. 'bfloat16'/'float16': f32/f64 tensors are down-cast on "
     "the wire and restored to their source dtype on arrival (halves "
     "tx_blob bytes at reduced mantissa); 'int8': shape-aware chunk-scale "
     "quantization (parallel/quantize.py, ~26% of the f32 payload; "
     "EQuARX-style, arXiv:2506.17615). Integer payloads are never cast. "
     "Default '' defers to the exploration winner's comm_dtype (plan_meta)"
     " and otherwise keeps the wire bit-identical"),
    ("TEPDIST_HEAVY_RPC_SLOTS", int, 0, "bounded async server executor: "
     "max concurrently RUNNING heavy handlers (ExecuteStepSlice/"
     "ExecuteRemotePlan/ExecutePlan/BuildExecutionPlan/LoadServable) per "
     "gRPC server, so control verbs (Ping/AbortStep/telemetry/serving "
     "polls) never queue behind long executes; 0 = auto "
     "(max(2, max_workers // 4)), negative = unbounded"),
    # --- telemetry --------------------------------------------------------
    ("TEPDIST_TRACE", bool, False, "record step/planner spans for the "
     "merged Perfetto timeline (telemetry/); DEBUG implies it"),
    ("TEPDIST_TRACE_CAPACITY", int, 65536, "span ring-buffer capacity per "
     "process (oldest spans are dropped; the overflow count is exported "
     "as spans_dropped)"),
    ("TEPDIST_CALIB_PROFILE", str, "", "path to a calibration-profile "
     "JSON (telemetry/calibrate.py, written by tools/fidelity_report.py "
     "--save-profile); when set, the evaluator and TaskScheduler price "
     "tasks with MEASURED constants (host floor, bandwidths, compute "
     "scale) instead of spec-sheet defaults"),
    ("LOWERING_POSTCHECK", bool, True, "winner-only involuntary-remat "
     "lowering check after exploration (parallel/lowering_check.py); "
     "records the involuntary_remat counter + a warning"),
    ("TEPDIST_PLAN_REPORT", str, "", "path (file or directory) the "
     "exploration observatory (telemetry/observatory.py) writes each "
     "ExplorationReport JSON to — the full candidate ledger, typed "
     "prune records, winner rationale; rendered by tools/plan_explain.py "
     "and compared by tools/plan_diff.py. Empty: report still rides the "
     "explore RPC and trace metadata, just not persisted standalone"),
    ("TEPDIST_LEDGER", bool, False, "per-verb RPC wire/serde ledger "
     "(telemetry/ledger.py): call counts, header vs blob bytes, "
     "encode/decode wall time, handler time, retry backoff — reduced to "
     "the serde/orchestration/idle/compute gap table by "
     "tools/ledger_report.py; off by default (hot-path hooks cost one "
     "branch when off)"),
    ("TEPDIST_LEDGER_RING", int, 16384, "ledger ring capacity per writer "
     "thread in records (fixed-stride int64 slots preallocated at first "
     "record; oldest records dropped and counted per category)"),
    ("TEPDIST_FLIGHT", bool, True, "serving flight recorder "
     "(telemetry/flight.py): bounded ring of per-request waterfall "
     "events (submit/admit/prefill/decode/restart/deliver) rendered by "
     "tools/request_trace.py; on by default — one ring-slot write per "
     "event, no allocation"),
    ("TEPDIST_FLIGHT_CAPACITY", int, 8192, "flight-recorder ring "
     "capacity per writer thread (oldest events dropped; overflow "
     "exported as dropped)"),
    ("TEPDIST_FLIGHT_SAMPLE", int, 1, "flight head-sampling stride: keep "
     "every Nth request's waterfall (hash of request id), shed the rest "
     "at record time and count them as sampled_out. 1 = record all; "
     "the wildcard rid '*' bypasses sampling (engine-wide events)"),
    ("TEPDIST_WATCH", bool, False, "watchtower poller thread "
     "(telemetry/watchtower.py): continuously polls every worker's "
     "GetTelemetryDelta, maintains per-worker rolling step-time/RTT "
     "digests, and raises typed straggler/fleet-shape/SLO-burn alerts. "
     "The training-health sentinel (NaN watchdog + loss-spike) is "
     "always on regardless — it costs a few float compares per step"),
    ("TEPDIST_WATCH_INTERVAL", float, 2.0, "watchtower poll interval in "
     "seconds (per-worker GetTelemetryDelta cadence)"),
    ("TEPDIST_WATCH_HALT", str, "", "promote sentinel alerts from "
     "advisory to halting: 'nan' fences the fleet via the AbortStep "
     "path and raises WatchHalt on a non-finite loss; '' (default) "
     "records the alert and keeps training"),
    ("TEPDIST_SLO_FILE", str, "", "path to slo.toml declaring SLO "
     "targets (step_time_ms percentiles, per-class serve TTFT/token "
     "tails, error rates) for the watchtower's multi-window burn-rate "
     "engine; empty = no SLO evaluation"),
    # --- control-plane crash safety (WAL + epoch fencing) -----------------
    ("TEPDIST_WAL_DIR", str, "", "directory for the master's durable "
     "control-plane journal (runtime/controlplane.py): fsync'd CRC-"
     "checksummed records of plan dispatches, fleet membership, the "
     "per-step commit watermark, checkpoint registrations and serving "
     "transitions. Enables DistributedPipelineSession.readopt() (master "
     "crash -> replay + re-adopt the live fleet) and arms epoch fencing "
     "on every mutating verb. Empty = no WAL, no fencing"),
    ("TEPDIST_WAL_SEGMENT_MB", int, 4, "WAL segment rotation size in MB"),
    ("TEPDIST_WAL_SNAPSHOT_EVERY", int, 512, "compact the WAL (snapshot "
     "+ truncate superseded segments) every N appended records; 0 "
     "disables automatic snapshots (explicit snapshot() only)"),
    ("TEPDIST_WAL_FSYNC", bool, True, "fsync each WAL group-commit "
     "batch; 0 trades crash durability for latency (still "
     "write()-ordered, survives process death but not power loss)"),
    # --- static analysis --------------------------------------------------
    ("TEPDIST_VERIFY_PLAN", bool,
     "pytest" in sys.modules or "PYTEST_CURRENT_TEST" in os.environ,
     "pre-dispatch static plan verifier (analysis/plan_verify.py): "
     "acyclicity, SEND/RECV pairing, cross-worker wait-cycle (deadlock), "
     "exactly-once writes, signature consistency, static peak-HBM — run "
     "on every built plan before dispatch (executor, distributed "
     "session, LoadServable). Default: on under pytest, off otherwise"),
    ("TEPDIST_LOCKDEP", bool, False, "runtime-assisted lockdep "
     "(analysis/lockdep_runtime.py): instrumented lock wrappers record "
     "actual acquisition-order edges to confirm/retire static "
     "lock-order edges from tools/lockdep.py"),
]

_CONFIG_FILE_ENV = "TEPDIST_CONFIG"
_DEFAULT_CONFIG_FILE = "config.json"


def _parse(ty: type, raw: Any) -> Any:
    if ty is bool:
        if isinstance(raw, bool):
            return raw
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    return ty(raw)


class ServiceEnv:
    """Process-wide config singleton. ``ServiceEnv.get().ilp_time_limit`` etc.
    (lower-cased knob names become attributes)."""

    _instance: Optional["ServiceEnv"] = None
    _lock = threading.Lock()

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        file_cfg = self._load_config_file()
        for name, ty, default, _help in _ENV_LIST:
            if name in os.environ:
                val = _parse(ty, os.environ[name])
            elif name in file_cfg:
                val = _parse(ty, file_cfg[name])
            else:
                val = default
            self._values[name] = val
        for k, v in (overrides or {}).items():
            self.set(k, v)

    @staticmethod
    def _load_config_file() -> Dict[str, Any]:
        path = os.environ.get(_CONFIG_FILE_ENV, _DEFAULT_CONFIG_FILE)
        try:
            with open(path) as f:
                cfg = json.load(f)
            return cfg if isinstance(cfg, dict) else {}
        except (OSError, json.JSONDecodeError):
            return {}

    @classmethod
    def get(cls) -> "ServiceEnv":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls, overrides: Optional[Dict[str, Any]] = None) -> "ServiceEnv":
        with cls._lock:
            cls._instance = cls(overrides)
            return cls._instance

    def set(self, name: str, value: Any) -> None:
        name = name.upper()
        for n, ty, _d, _h in _ENV_LIST:
            if n == name:
                self._values[name] = _parse(ty, value)
                return
        raise KeyError(f"unknown knob {name}")

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        key = name.upper()
        if key in values:
            return values[key]
        raise AttributeError(name)

    @staticmethod
    def knobs() -> List[Tuple[str, type, Any, str]]:
        return list(_ENV_LIST)
