"""The port imports neither jax nor anything of tepdist_tpu, nor
ml_dtypes (the card's machine has none): every module of
tepdist_tpu_torch, and chip_smoke.py, imported in a fresh interpreter (the
pytest process has jax loaded already); the telemetry, serving and graph
packages each imported alone; and each module of the planner and of the
service (the wire, the server, the client and the session) and of the
fleet (workers, the multi-host and serving clients, migration, the
control plane, the distributed executor) imported alone. No module imports grpc when it is imported (the card's machine has
no grpcio): only the functions that open a channel or a server do."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import tepdist_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tepdist_tpu_torch.__path__,
                                               "tepdist_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch, torch.nn.functional  # what chip_smoke's phases import
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "tepdist_tpu.",
                                            "grpc."))
             or m in ("tepdist_tpu", "ml_dtypes", "optax", "grpc"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 24 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_SUBPACKAGE_PROBE = """
import importlib, pkgutil, sys
pkg = importlib.import_module(sys.argv[1])
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "tepdist_tpu.",
                                            "grpc."))
             or m in ("tepdist_tpu", "ml_dtypes", "optax", "grpc"))
print(len(names), bad)
sys.exit(1 if bad or not names else 0)
"""


@pytest.mark.parametrize("package", ["tepdist_tpu_torch.telemetry",
                                     "tepdist_tpu_torch.serving",
                                     "tepdist_tpu_torch.graph",
                                     "tepdist_tpu_torch.rpc",
                                     "tepdist_tpu_torch.client"])
def test_subpackage_imports_no_jax(package):
    """Each of the port's telemetry, serving and graph packages, with
    every one of its modules, imported alone in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SUBPACKAGE_PROBE, package],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_MODULE_PROBE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "tepdist_tpu.",
                                            "grpc."))
             or m in ("tepdist_tpu", "ml_dtypes", "optax", "grpc"))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("module", [
    "tepdist_tpu_torch.core.par_type", "tepdist_tpu_torch.core.dist_spec",
    "tepdist_tpu_torch.core.mesh", "tepdist_tpu_torch.parallel.strategy_utils",
    "tepdist_tpu_torch.parallel.liveness",
    "tepdist_tpu_torch.parallel.performance_utils",
    "tepdist_tpu_torch.parallel.resolve_utils",
    "tepdist_tpu_torch.parallel.cost_spmd_strategy",
    "tepdist_tpu_torch.parallel.fast_spmd_strategy",
    "tepdist_tpu_torch.parallel.inst_affinity",
    "tepdist_tpu_torch.parallel.spmd_transform",
    "tepdist_tpu_torch.parallel.auto_parallel",
    "tepdist_tpu_torch.parallel.evaluator",
    "tepdist_tpu_torch.parallel.exploration",
    "tepdist_tpu_torch.parallel.quantize",
    "tepdist_tpu_torch.parallel.lowering_check",
    "tepdist_tpu_torch.runtime.initializers",
    "tepdist_tpu_torch.core.cluster_spec",
    "tepdist_tpu_torch.rpc.protocol", "tepdist_tpu_torch.rpc.retry",
    "tepdist_tpu_torch.rpc.fx_serde", "tepdist_tpu_torch.rpc.inproc",
    "tepdist_tpu_torch.rpc.client", "tepdist_tpu_torch.rpc.worker_plan",
    "tepdist_tpu_torch.rpc.server", "tepdist_tpu_torch.runtime.health",
    "tepdist_tpu_torch.client.annotations",
    "tepdist_tpu_torch.client.session",
    # Workers, the multi-host client, the serving client and the fleet.
    "tepdist_tpu_torch.runtime.coordinator",
    "tepdist_tpu_torch.client.multihost",
    "tepdist_tpu_torch.serving.client",
    "tepdist_tpu_torch.runtime.variable_specs",
    "tepdist_tpu_torch.runtime.slice_utils",
    "tepdist_tpu_torch.runtime.dist_buffer",
    "tepdist_tpu_torch.parallel.redistribution",
    "tepdist_tpu_torch.runtime.migration",
    "tepdist_tpu_torch.runtime.controlplane",
    "tepdist_tpu_torch.runtime.distributed_executor",
    # Fleet serving and the lockdep lint.
    "tepdist_tpu_torch.serving.fleet",
    "tepdist_tpu_torch.analysis.lockdep"])
def test_planner_module_imports_no_jax(module):
    """Each module of the planner (both parts) and of the service imported
    alone in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _MODULE_PROBE, module],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_TOOL_PROBE = """
import sys
sys.path.insert(0, "tools")
sys.argv = [sys.argv[1]] + sys.argv[2:]
import runpy
try:
    runpy.run_path("tools/" + sys.argv[0] + ".py", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "tepdist_tpu.",
                                            "grpc."))
             or m in ("tepdist_tpu", "ml_dtypes", "optax", "grpc"))
print(bad)
sys.exit(3 if bad else 0)
"""


@pytest.mark.parametrize("tool,args", [
    ("torch_lockdep", ["--check"]),
    ("torch_fidelity_report", ["--device", "cpu", "--steps", "1"]),
    ("torch_verify_plan", ["--device", "cpu", "--check"]),
    ("torch_request_trace", ["--demo", "--device", "cpu"]),
    ("torch_perf_gate", [
        "--history", os.devnull, "--check", "--keys", "quantized_ar_x",
        "--record-value", "quantized_ar_x=3.9", "--plan-diff",
        "tests/fixtures/coll_flip_before.json,"
        "tests/fixtures/coll_flip_before.json"]),
    ("torch_quant_ratio", ["--device", "cpu", "--check"])])
def test_port_tool_imports_no_jax(tool, args):
    """The port's tools run (the lint over the package, the fidelity
    fixture, the plan verifier's self-test, the flight-recorder demo on
    the CPU, the perf gate's check with a plan diff and the int8 wire
    ratio's check) in a fresh
    interpreter without importing jax or anything of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _TOOL_PROBE, tool, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


_FILE_PROBE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("probe_module", sys.argv[1])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "tepdist_tpu.",
                                            "grpc."))
             or m in ("tepdist_tpu", "ml_dtypes", "optax", "grpc"))
print(bad)
sys.exit(1 if bad else 0)
"""

_EXAMPLE_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(os.path.join(ROOT, "examples_torch"))
    for f in files if f.endswith(".py"))


def test_every_example_is_probed():
    assert len(_EXAMPLE_FILES) >= 12, _EXAMPLE_FILES


_READ_ONLY_TOOLS = [f"tools/torch_{name}.py" for name in (
    "cli", "trace_summary", "plan_diff", "verify_plan", "plan_explain",
    "ledger_report", "watch", "request_trace", "metrics_dump",
    "obs_overhead", "run_fx", "perf_gate", "quant_ratio")]


@pytest.mark.parametrize("path", _EXAMPLE_FILES + [
    "tools/torch_chaos_run.py", "tools/torch_serve_load.py"]
    + _READ_ONLY_TOOLS)
def test_examples_and_tools_import_no_jax(path):
    """Each script of ``examples_torch/``, the two fleet drivers and the
    read-only tools, imported alone in a fresh interpreter: no jax,
    nothing of the JAX package, no optax or ml_dtypes, and no grpc at
    import time (the scripts open channels inside functions)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FILE_PROBE, path],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_SMOKE_SCRIPTS = sorted(
    f"scripts/{f}" for f in os.listdir(os.path.join(ROOT, "scripts"))
    if f.startswith("torch_") and f.endswith("_smoke.sh"))

# What a port smoke script must not name: the JAX package, jax itself,
# bench.py, a JAX tool (a tools/ script without the torch_ prefix) or a
# JAX test (a tests/ file without the torch_ prefix).
_JAX_REFERENCE = re.compile(
    r"tepdist_tpu(?!_torch)|\bjax\b|JAX_PLATFORMS|\bbench\b|bench\.py"
    r"|tools/(?!torch_)\w+\.py|tests/test_(?!torch_)\w+\.py")


def test_every_smoke_script_is_probed():
    assert len(_SMOKE_SCRIPTS) >= 13, _SMOKE_SCRIPTS


@pytest.mark.parametrize("path", _SMOKE_SCRIPTS)
def test_smoke_scripts_run_nothing_of_the_jax_package(path):
    """Each ``scripts/torch_*_smoke.sh`` calls only the port's tools, its
    package and its tests: outside comments, no line names the JAX
    package, jax, bench.py, a JAX tool or a JAX test."""
    with open(os.path.join(ROOT, path)) as f:
        code = [line for line in f
                if not line.lstrip().startswith("#")]
    bad = [line.rstrip() for line in code if _JAX_REFERENCE.search(line)]
    assert not bad, bad
