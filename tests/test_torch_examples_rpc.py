"""The port's service examples (``examples_torch/``) over real gRPC on the
CPU, held to the JAX package's (``examples/``) on the same inputs.

Each JAX example runs in this process (``runpy`` with a patched
``sys.argv``) and spawns its own JAX server; the port's example spawns
``python -m tepdist_tpu_torch.rpc.server --device cpu``. The reference's
initial arrays are computed here as the example computes them and handed
to the port's ``run(args, params, batch)`` through ``convert.to_torch``.
Every spawned server is killed when its example returns (the examples'
own ``finally``), and ``launch_workers.py``'s process group in teardown.

Tolerances: fp32 throughout; printed losses within 2e-4 absolute (the
examples print 6 decimals), greedy tokens equal. ``auto_explore``: the
port's server binary owns one device (its ``--device``), so the JAX
example's server is started with one CPU device too
(``XLA_FLAGS=--xla_force_host_platform_device_count=1``, which the JAX
example keeps when set) and the winners' kinds are compared on one
device in both regimes; then an in-process servicer on ``["cpu"] * 8``
and on ``["cpu"] * 4`` (one gloo rank a device) is held to the JAX
server on 8 and on 4 virtual devices.
"""

import contextlib
import io
import json
import os
import re
import runpy
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import mlp as jmlp
from tepdist_tpu_torch import convert

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 2e-4
_LOSS = re.compile(r"loss ?= ?(-?[0-9.]+)")


def _run_jax(rel: str, argv) -> str:
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [rel] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "examples", rel),
                           run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def _run_port(module, argv, params=None, batch=None, **kw):
    args = module.parse_args(list(argv) + ["--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.run(args, params=params, batch=batch, **kw)
    return buf.getvalue(), out


def _losses(text):
    return [float(x) for x in _LOSS.findall(text)]


def test_simple_local():
    from examples_torch.smoke_testing import simple

    argv = ["--local", "--steps", "3"]
    jt = _run_jax("smoke_testing/simple.py", argv)
    k = jax.random.PRNGKey(0)
    params = jax.device_get(jmlp.init_mlp(k, din=32, dh=64, dout=8))
    x = np.asarray(jax.random.normal(k, (256, 32)))
    pt, out = _run_port(simple, argv, convert.to_torch(params, device="cpu"),
                        (torch.tensor(x), torch.ones((256, 8))))
    want = _losses(jt)
    assert len(want) == len(_losses(pt)) == 3
    np.testing.assert_allclose(out["losses"], want, rtol=0, atol=LOSS_ATOL)
    assert all(b < a for a, b in zip(out["losses"], out["losses"][1:]))
    assert out["server"]["platform"] == "cpu"


def test_generate_greedy_tokens_equal_jax():
    from examples_torch.GPT2 import generate

    argv = ["--local", "--config", "test", "--steps", "2",
            "--max_new_tokens", "8", "--greedy"]
    jt = _run_jax("GPT2/generate.py", argv)
    cfg = jgpt2.CONFIGS["test"]
    params = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(cfg, 8, 32))
    prompt = np.asarray(jgpt2.fake_batch(cfg, 2, 9))[:, :8]
    pt, out = _run_port(generate, argv, convert.to_torch(params, device="cpu"),
                        (torch.tensor(tokens).long(),
                         torch.tensor(prompt).long()))
    np.testing.assert_allclose(out["losses"], _losses(jt), rtol=0,
                               atol=LOSS_ATOL)
    want = [[int(t) for t in ln.split()[1:]]
            for ln in jt.splitlines() if ln.startswith("generated:")]
    assert len(want) == 2 and len(want[0]) == 16
    assert out["generated"] == want
    assert pt.count("generated:") == 2


def test_sampled_generation_over_the_wire_equals_local_sample():
    """A sampling (non-greedy) decode program crosses the wire with its
    generator (``rpc/fx_serde.py``: the seed, a new generator on the
    server): the server's tokens equal ``sample()`` run here on the
    fetched weights with the same seed."""
    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.models import gpt2, sampling
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer
    from tepdist_tpu_torch.train import value_and_grad

    cfg = gpt2.CONFIGS["test"]
    params = gpt2.init_params(cfg, seed=0, device="cpu")
    tokens = gpt2.fake_batch(cfg, 4, 16, device="cpu")
    prompt = tokens[:2, :6]
    tx = adam(1e-3)
    grad_fn = value_and_grad(lambda p, t: gpt2.loss_fn(p, t, cfg))

    def step(p, s, t):
        loss, g = grad_fn(p, t)
        return loss, p, tx.apply(p, g, s)

    def gen_fn(p, prompt):
        return sampling.sample(p, prompt, cfg, max_new_tokens=8,
                               temperature=0.8, top_k=20)

    address = "inproc:14101"
    inproc.register_servicer(address, TepdistServicer(["cpu"]))
    try:
        sess = TepdistSession(address)
        sess.compile_train_step(step, params, tx.init(params), tokens)
        sess.run(tokens)
        sess.compile_generate(gen_fn, params, prompt)
        remote = sess.generate(prompt)
        trained = sess.params()
        sess.close()
    finally:
        inproc.unregister_servicer(address)
    local = gen_fn(trained, prompt)
    assert torch.equal(remote, local)
    assert not torch.equal(remote, sampling.sample(
        trained, prompt, cfg, max_new_tokens=8, greedy=True))


def _explore_arrays():
    depth, width, batch = 8, 512, 16
    k = jax.random.PRNGKey(0)
    scale = (2.0 / width) ** 0.5
    params = {f"w{i}": np.asarray(jax.random.normal(
        jax.random.fold_in(k, i), (width, width)) * scale)
        for i in range(depth)}
    x = np.asarray(jax.random.normal(jax.random.fold_in(k, 100),
                                     (batch, width)))
    y = np.asarray(jax.random.normal(jax.random.fold_in(k, 101),
                                     (batch, width)))
    return (convert.to_torch(params, device="cpu"),
            (torch.tensor(x), torch.tensor(y)))


_JAX_EXPLORE = {}
_ROW = re.compile(r"^\s*(spmd|pipeline|seq) (.+?)\s+([0-9.e+-]+)\s+"
                  r"(True|False)( <== winner)?$", re.M)


def _jax_explore(regime, n_devices, monkeypatch):
    """The JAX example's output with its server on ``n_devices`` virtual
    CPU devices (one run per regime and count in this module)."""
    key = (regime, n_devices)
    if key not in _JAX_EXPLORE:
        with monkeypatch.context() as m:
            m.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count="
                     f"{n_devices}")
            _JAX_EXPLORE[key] = _run_jax(
                "auto_explore/main.py",
                ["--steps", "2", "--regime", regime])
    return _JAX_EXPLORE[key]


def _table(text):
    """The printed candidate rows: (kind, config, seconds, fits, won)."""
    return [(k, c.strip(), float(d), f == "True", bool(w))
            for k, c, d, f, w in _ROW.findall(text)]


@pytest.mark.parametrize("regime", ["auto", "pipeline"])
def test_auto_explore(regime, monkeypatch):
    from examples_torch.auto_explore import main as auto_explore

    argv = ["--steps", "2", "--regime", regime]
    jt = _jax_explore(regime, 1, monkeypatch)
    params, batch = _explore_arrays()
    pt, out = _run_port(auto_explore, argv, params, batch)
    jwin = re.search(r"winner: (\w+)\s+\(plan kind: (\w+)", jt).groups()
    assert (out["winner"], out["kind"]) == jwin, (jt, pt)
    np.testing.assert_allclose(out["losses"], _losses(jt), rtol=0,
                               atol=LOSS_ATOL)
    assert any(c["winner"] for c in out["candidates"])


def _explore_on(n_devices, regime, monkeypatch):
    """The port's ``auto_explore`` through a servicer over ``["cpu"] *
    n_devices`` (the group form: one gloo rank a device) against the JAX
    example's server on ``n_devices`` virtual devices: the same winner,
    losses within ``LOSS_ATOL``; no rank outlives the servicer, and the
    caller's process gains no process group."""
    import torch.distributed as dist

    from examples_torch.auto_explore import main as auto_explore
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    jt = _jax_explore(regime, n_devices, monkeypatch)
    want = next(r for r in _table(jt) if r[4])
    had_world = dist.is_initialized()
    ServiceEnv.reset(auto_explore.REGIME_ENV[regime])
    address = f"inproc:c15-{regime}-{n_devices}"
    servicer = TepdistServicer(["cpu"] * n_devices)
    assert servicer.rank_group.size == n_devices
    inproc.register_servicer(address, servicer)
    try:
        params, batch = _explore_arrays()
        pt, out = _run_port(auto_explore, ["--steps", "2", "--regime",
                                           regime], params, batch,
                            address=address)
    finally:
        inproc.unregister_servicer(address)
        ServiceEnv.reset()
    assert not any(servicer.rank_group.alive())
    assert dist.is_initialized() == had_world
    won = next(c for c in out["candidates"] if c["winner"])
    assert (won["kind"], won["config"]) == want[:2], (jt, pt)
    assert out["kind"] == want[0]
    np.testing.assert_allclose(out["losses"], _losses(jt), rtol=0,
                               atol=LOSS_ATOL)
    return want


@pytest.mark.parametrize("regime", ["auto", "pipeline"])
def test_auto_explore_on_eight_devices(regime, monkeypatch):
    """ROADMAP C13 and C15: a servicer on ``["cpu"] * 8`` forms 8 gloo
    ranks, one a device, explores over them as the JAX server explores
    its 8 virtual devices (pipeline cuts with intra-stage TP included),
    and builds and trains the winner: the JAX winner in both regimes
    (``S=2 M=4 tp=2@int8`` in the pipeline regime, a stage of 2 TP ranks
    x 2 replicas; ``data=8`` in the auto regime), losses within
    ``LOSS_ATOL`` of the JAX run (every candidate computes the same fp32
    step)."""
    want = _explore_on(8, regime, monkeypatch)
    assert want[:2] == {"pipeline": ("pipeline", "S=2 M=4 tp=2@int8"),
                        "auto": ("spmd", "MeshTopology(data=8)")}[regime]


@pytest.mark.parametrize("regime", ["auto", "pipeline"])
def test_auto_explore_on_four_devices(regime, monkeypatch):
    """ROADMAP C15: the same over ``["cpu"] * 4`` (4 gloo ranks) against
    the JAX server on 4 virtual devices; in the pipeline regime the JAX
    winner is ``S=8 M=4 il/G=4`` (8 stages interleaved over 4 groups of
    one rank)."""
    want = _explore_on(4, regime, monkeypatch)
    if regime == "pipeline":
        assert want[:2] == ("pipeline", "S=8 M=4 il/G=4")


@pytest.fixture
def launched_worker(tmp_path):
    """``launch_workers.py`` on a one-worker config rewritten to a free
    port, in its own process group (killed at teardown)."""
    from examples_torch import common

    with open(os.path.join(ROOT, "examples_torch",
                           "config_1worker_template.json")) as f:
        spec = json.load(f)
    port = common.free_port()
    spec["workers"][0]["port"] = port
    config = tmp_path / "config.json"
    config.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "examples_torch/launch_workers.py", "--config",
         str(config), "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    yield f"127.0.0.1:{port}", proc
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def test_launch_workers_serves_a_session(launched_worker):
    """A session trains through the launched server: its losses equal
    the JAX package's local SGD on the same arrays."""
    import jax.numpy as jnp
    import optax

    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.train import value_and_grad

    address, proc = launched_worker
    k = jax.random.PRNGKey(0)
    params = jax.device_get(jmlp.init_mlp(k, din=32, dh=64, dout=8))
    x = np.asarray(jax.random.normal(k, (64, 32)))
    y = np.ones((64, 8), np.float32)
    tx = sgd(0.1)
    grad_fn = value_and_grad(
        lambda p, a, b: ((torch.relu(a @ p["w0"]) @ p["w1"] - b) ** 2).mean())

    def step(p, s, a, b):
        loss, g = grad_fn(p, a, b)
        return loss, p, tx.apply(p, g, s)

    tp = convert.to_torch(params, device="cpu")
    sess = TepdistSession(address)
    sess.client.wait_ready(timeout=120)
    assert sess.client.ping()["platform"] == "cpu"
    sess.compile_train_step(step, tp, tx.init(tp), torch.tensor(x),
                            torch.tensor(y))
    losses = [sess.run(torch.tensor(x), torch.tensor(y)) for _ in range(3)]
    sess.close()

    jtx = optax.sgd(0.1)

    def jloss(p):
        return jnp.mean((jax.nn.relu(x @ p["w0"]) @ p["w1"] - y) ** 2)

    p, s, want = params, jtx.init(params), []
    for _ in range(3):
        loss, g = jax.value_and_grad(jloss)(p)
        u, s = jtx.update(g, s, p)
        p = optax.apply_updates(p, u)
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert proc.poll() is None
