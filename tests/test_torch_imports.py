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
    "tepdist_tpu_torch.runtime.distributed_executor"])
def test_planner_module_imports_no_jax(module):
    """Each module of the planner (both parts) and of the service imported
    alone in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _MODULE_PROBE, module],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
