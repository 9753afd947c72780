"""The port's fleet tools, ``tools/torch_chaos_run.py`` and
``tools/torch_serve_load.py``, held to the JAX package's
``tools/chaos_run.py`` and ``tools/serve_load.py`` on the CPU.

Chaos: each arm of the port passes its own assertion (an identical
trajectory under ``rpc_drop``; one live migration and no rollback when a
worker dies; bit-identical tokens across engine restarts; one takeover,
no rollback and exactly-once steps when the master is SIGKILLed over
gRPC), on the JAX tool's arrays (its ``_build_case``, carried by
``convert.to_torch``). The port's fault-free trajectory is held to the
JAX tool's: the fleet arm's to ``chaos_run.run_fleet`` (SGD, fp32, rtol
1e-5, ``tests/test_torch_multiworker.py``'s bound), the two kill arms'
undisturbed references to the JAX tool's (the program's sequential step
with Adam, as ``kill_worker_chaos`` computes it), rtol 1e-5. The serving
arm's statuses and fp32 greedy tokens equal ``chaos_run.run_serve``'s.

Load: ``run_load(config="test")`` with the same seed in both packages,
on the same weights: the same request mix (prompts and output lengths,
drawn from ``np.random.RandomState(seed)``), the same statuses, token and
prefill counts, and equal fp32 greedy tokens request by request, for
``kv_mode`` paged and slots and for ``--disagg 1:1``, with a slot (and
its pages) for every request, so no handoff meets a full decode pool.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu_torch import convert

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tools():
    return {n: _tool(n) for n in ("chaos_run", "torch_chaos_run",
                                  "serve_load", "torch_serve_load")}


def _jax_case(jchaos, stages=2, micro=2):
    _, params, x, y = jchaos._build_case(stages, micro)
    return jax.device_get(params), np.asarray(x), np.asarray(y)


def _port_arrays(params, x, y):
    return (convert.to_torch(params, device="cpu"),
            (torch.tensor(x), torch.tensor(y)))


def _jax_adam_reference(jchaos, params, x, y, steps, stages=2, micro=2):
    """``kill_worker_chaos``'s undisturbed trajectory (its own lines)."""
    import optax

    from tepdist_tpu.parallel.pipeline import plan_pipeline

    loss_fn, _, _, _ = jchaos._build_case(stages, micro)
    prog = plan_pipeline(loss_fn, stages, micro, params, x, y)
    tx = optax.adam(1e-2)

    def apply_fn(pp, ss, g):
        u, ss = tx.update(g, ss, pp)
        return optax.apply_updates(pp, u), ss

    ref_step = jax.jit(prog.reference_step(apply_fn))
    p, s, out = params, tx.init(params), []
    for _ in range(steps):
        loss, p, s = ref_step(p, s, x, y)
        out.append(float(loss))
    return out


def test_chaos_fleet_arm(tools):
    jchaos, tchaos = tools["chaos_run"], tools["torch_chaos_run"]
    params, x, y = _jax_case(jchaos)
    out = tchaos.run(tchaos.parse_args(["--device", "cpu"]),
                     *_port_arrays(params, x, y))
    assert out["ok"]
    assert out["chaos"] == out["baseline"]
    assert out["fault_injected"] > 0 and out["rpc_retries"] > 0
    want = jchaos.run_fleet(10, 2, 2)
    np.testing.assert_allclose(out["baseline"], want, rtol=LOSS_RTOL)


def test_chaos_kill_worker_arm(tools):
    jchaos, tchaos = tools["chaos_run"], tools["torch_chaos_run"]
    params, x, y = _jax_case(jchaos)
    out = tchaos.run(tchaos.parse_args(
        ["--device", "cpu", "--steps", "6", "--kill-worker", "3"]),
        *_port_arrays(params, x, y))
    assert out["ok"]
    assert out["survivors"] == 1
    assert out["counters"]["elastic_migrations"] == 1
    assert not out["counters"].get("checkpoint_rollback_steps")
    want = _jax_adam_reference(jchaos, params, x, y, 6)
    np.testing.assert_allclose(out["baseline"], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)


def test_chaos_kill_master_arm_over_grpc(tools):
    jchaos, tchaos = tools["chaos_run"], tools["torch_chaos_run"]
    params, x, y = _jax_case(jchaos)
    out = tchaos.run(tchaos.parse_args(
        ["--device", "cpu", "--steps", "8", "--kill-master", "3"]),
        *_port_arrays(params, x, y))
    assert out["ok"]
    assert out["master_takeovers"] == "1"
    assert out["checkpoint_rollback_steps"] == "0"
    assert 0 < out["resumed_at"] < 8
    want = _jax_adam_reference(jchaos, params, x, y, 8)
    np.testing.assert_allclose(out["baseline"], want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)


def test_chaos_serve_arm(tools):
    jchaos, tchaos = tools["chaos_run"], tools["torch_chaos_run"]
    cfg = jgpt2.CONFIGS["test"]
    params = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    out = tchaos.run(tchaos.parse_args(["--device", "cpu", "--serve"]),
                     convert.to_torch(params, device="cpu"))
    assert out["ok"]
    assert out["engine_restarts"] >= 1 and out["fault_injected"] >= 1
    want = jchaos.run_serve(10, 2, 2)
    assert [(i, s, tuple(int(t) for t in tok)) for i, s, tok in want] \
        == out["baseline"] == out["chaos"]


def _recording(monkeypatch, classes, log):
    """Record every submit's prompt, output length and request id, and
    every wait's results, on the serving clients of both packages."""
    for cls in classes:
        submit, wait = cls.submit, cls.wait

        def rec_submit(self, prompt, *a, _f=submit, **k):
            log["mix"].append((tuple(int(t) for t in np.asarray(prompt)),
                               int(k["max_new_tokens"])))
            out = _f(self, prompt, *a, **k)
            log["rids"].append(out["request_id"])
            return out

        def rec_wait(self, *a, _f=wait, **k):
            res = _f(self, *a, **k)
            log["results"].append(res)
            return res
        monkeypatch.setattr(cls, "submit", rec_submit)
        monkeypatch.setattr(cls, "wait", rec_wait)


def _tokens_in_order(log):
    """(status, tokens) of each request, in submission order."""
    (results,) = log["results"]
    return [(results[rid]["status"],
             tuple(int(t) for t in results[rid].get("tokens", ())))
            for rid in log["rids"]]


@pytest.mark.parametrize("mode", [dict(kv_mode="paged"),
                                  dict(kv_mode="slots"),
                                  dict(kv_mode="paged", disagg="1:1")],
                         ids=["paged", "slots", "disagg"])
def test_serve_load_matches_jax(tools, mode, monkeypatch):
    import tepdist_tpu.serving as jserving
    import tepdist_tpu_torch.serving as tserving

    cfg = jgpt2.CONFIGS["test"]
    params = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    # Slots (and so pages) for every request at once: a handoff into a
    # full decode pool is rejected and neither tool retries it, so a
    # smaller pool makes the run depend on how fast earlier requests
    # finish (on a loaded host the JAX tool's decode replica ran out).
    kw = dict(config="test", workers=2, slots=12, requests=12, seed=3,
              shared_prefix=4, **mode)
    jlog = {"mix": [], "rids": [], "results": []}
    _recording(monkeypatch, (jserving.ServeClient, jserving.FleetRouter),
               jlog)
    want = tools["serve_load"].run_load(**kw)
    monkeypatch.undo()
    tlog = {"mix": [], "rids": [], "results": []}
    _recording(monkeypatch, (tserving.ServeClient, tserving.FleetRouter),
               tlog)
    got = tools["torch_serve_load"].run_load(
        device="cpu", params=convert.to_torch(params, device="cpu"), **kw)
    assert tlog["mix"] == jlog["mix"] and len(tlog["mix"]) == 12
    for k in ("requests", "statuses", "tokens", "prefills",
              "prefill_tokens", "pages_used_after_drain",
              "disagg_pages_leaked", "pool_handoffs"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["statuses"] == {"done": 12}
    assert _tokens_in_order(tlog) == _tokens_in_order(jlog)
