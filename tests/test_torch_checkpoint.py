"""The port's checkpoints (tepdist_tpu_torch.runtime.checkpoint and
``TrainingPlan.save``/``restore``) on the CPU: the single-device cases of
``tests/test_checkpoint.py`` rerun on the port, files crossing between the
two packages in both directions, and training resumed across them.

Tolerances: files cross bit for bit (exact). A resumed trajectory is held
to ``tests/test_torch_train.py``'s fp32 tolerances against the other
package's uninterrupted run: loss rtol 1e-5 (fp32 sums in another order),
params and fp32 state atol 2e-5 (a last-bit gradient difference can round
a bf16 Adam moment the other way, moving an element by up to lr * 2**-7
per step). The bf16 moments of ``adamw_bf16`` themselves: at most 1% of
their elements, over all moment leaves, differ, each by at most one bf16
step (``test_torch_optim.py``'s rule for one step) plus 1e-6 of its leaf's
largest magnitude (near-zero gradients, whose fp32 sums in another order
differ by far more than their last bit relative to themselves).
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import llama as jllama
from tepdist_tpu.optim import adamw_bf16 as jax_adamw_bf16
from tepdist_tpu.runtime.checkpoint import CheckpointUtil as JaxCheckpointUtil
from tepdist_tpu.train import plan_training as jax_plan_training
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.models import llama as tllama
from tepdist_tpu_torch.optim import adamw, adamw_bf16
from tepdist_tpu_torch.runtime.checkpoint import (
    CheckpointUtil,
    restore_sharded,
    save_sharded,
)
from tepdist_tpu_torch.train import plan_training

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _bits(x) -> np.ndarray:
    """Raw bits of a tensor or numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


# -- the single-device cases of tests/test_checkpoint.py ------------------

def test_round_trip_with_bf16(tmp_path):
    util = CheckpointUtil(str(tmp_path))
    data = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(5, dtype=torch.bfloat16),
            "count": torch.tensor(7, dtype=torch.int32)}
    util.save(3, data)
    out, step = util.restore()
    assert step == 3
    assert torch.equal(out["w"], data["w"])
    assert out["b"].dtype == torch.bfloat16
    assert torch.equal(out["b"], data["b"])
    assert out["count"].shape == () and int(out["count"]) == 7


def test_keep_queue_prunes(tmp_path):
    util = CheckpointUtil(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        util.save(s, {"x": torch.tensor([s])})
    assert util.steps() == [2, 3]
    assert not (tmp_path / "step_000000000001").exists()
    with pytest.raises(FileNotFoundError):
        util.restore(1)


def test_shard_only_writer_leaves_manifest_alone(tmp_path):
    w1 = CheckpointUtil(str(tmp_path), own_manifest=False)
    w1.save(7, {"x": torch.tensor([1.0])}, worker_id=1)
    assert not (tmp_path / "manifest.json").exists()
    w0 = CheckpointUtil(str(tmp_path), own_manifest=True)
    w0.save(7, {"x": torch.tensor([2.0])}, worker_id=0)
    assert w0.steps() == [7]
    step_dir = tmp_path / "step_000000000007"
    assert (step_dir / "worker0.npz").exists()
    assert (step_dir / "worker1.npz").exists()


def _write_shards(step_dir, full, extents, name="0"):
    for w, (lo, hi) in enumerate(extents):
        np.savez(step_dir / f"worker{w}.npz",
                 **{f"{name}::shard0": full[lo:hi]})
        with open(step_dir / f"worker{w}.meta.json", "w") as f:
            json.dump({f"{name}::shard0": {
                "of": name, "index": [[lo, hi], [0, full.shape[1]]],
                "global_shape": list(full.shape)}}, f)


def test_shard_assembly_across_workers(tmp_path):
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    util = CheckpointUtil(str(tmp_path))
    util.save(5, {})
    _write_shards(tmp_path / "step_000000000005", full, [(0, 4), (4, 8)])
    out, step = util.restore(worker_id=0)
    assert step == 5
    np.testing.assert_array_equal(out["0"].numpy(), full)
    union, _ = util.restore_union()
    np.testing.assert_array_equal(union["0"].numpy(), full)


def test_shard_assembly_incomplete_coverage_raises(tmp_path):
    util = CheckpointUtil(str(tmp_path))
    util.save(1, {})
    _write_shards(tmp_path / "step_000000000001",
                  np.zeros((8, 4), np.float32), [(0, 2)])
    with pytest.raises(ValueError, match="coverage incomplete"):
        util.restore(worker_id=0)


def test_restore_resharded_builds_each_destination(tmp_path):
    """Saved as two row halves, read back as three other row extents and
    a column extent: each equals that slice of the full array."""
    full = np.arange(48, dtype=np.float32).reshape(12, 4)
    util = CheckpointUtil(str(tmp_path))
    util.save(2, {})
    _write_shards(tmp_path / "step_000000000002", full, [(0, 6), (6, 12)])
    dsts = [((0, 4), (0, 4)), ((4, 9), (0, 4)), ((9, 12), (0, 4)),
            ((0, 12), (1, 3))]
    got, step = util.restore_resharded({"0": dsts})
    assert step == 2
    for d, shard in zip(dsts, got["0"]):
        want = full[d[0][0]:d[0][1], d[1][0]:d[1][1]]
        np.testing.assert_array_equal(shard.numpy(), want)
    with pytest.raises(ValueError, match="coverage incomplete"):
        util.restore_resharded({"0": [((0, 13), (0, 4))]})


def test_crash_mid_save_keeps_last_committed_step(tmp_path, monkeypatch):
    util = CheckpointUtil(str(tmp_path))
    util.save(1, {"x": torch.tensor([1.0])})

    def boom(self, step):
        raise RuntimeError("simulated crash before manifest commit")

    monkeypatch.setattr(CheckpointUtil, "_commit_step", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        util.save(2, {"x": torch.tensor([2.0])})
    monkeypatch.undo()
    assert util.steps() == [1]
    data, step = util.restore()
    assert step == 1 and data["x"][0] == 1.0
    util.save(2, {"x": torch.tensor([2.0])})
    assert util.steps() == [1, 2]
    data, step = util.restore()
    assert step == 2 and data["x"][0] == 2.0


def _dead_pid() -> int:
    pid = 4_000_000
    while pid > 2:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return pid
        except OSError:
            pass
        pid -= 7919
    raise RuntimeError("no dead pid found")  # pragma: no cover


def test_stale_tmp_cleanup_on_next_save(tmp_path):
    util = CheckpointUtil(str(tmp_path))
    util.save(3, {"x": torch.tensor([1.0])})
    step_dir = tmp_path / "step_000000000003"
    stale = step_dir / f"worker0.npz.tmp.{_dead_pid()}.140234.99"
    stale.write_bytes(b"partial write from a dead process")
    own = step_dir / f"worker1.npz.tmp.{os.getpid()}.1.2"
    own.write_bytes(b"another thread's in-flight save")
    weird = step_dir / "worker2.npz.tmp.notapid"
    weird.write_bytes(b"unparseable: leave it")
    util.save(3, {"x": torch.tensor([2.0])})
    assert not stale.exists()
    assert own.exists() and weird.exists()
    data, step = util.restore(3)
    assert step == 3 and data["x"][0] == 2.0
    stale.write_bytes(b"again")
    assert CheckpointUtil._clean_stale_tmps(str(step_dir)) == 1
    assert CheckpointUtil._clean_stale_tmps("/nonexistent-dir") == 0


def test_async_save_overlap_and_restore(tmp_path):
    util = CheckpointUtil(str(tmp_path), max_to_keep=5)
    a = torch.arange(10000, dtype=torch.float32).reshape(100, 100)
    v1, v2 = {"a": a}, {"a": a * 2}
    h1 = util.save_async(1, v1)
    h2 = util.save_async(2, v2)
    a.zero_()   # the snapshot was taken when save_async returned
    p1, p2 = h1.result(60), h2.result(60)
    assert h1.done() and h2.done()
    assert p1.endswith(".npz") and p2.endswith(".npz")
    assert util.steps() == [1, 2]
    base = torch.arange(10000, dtype=torch.float32).reshape(100, 100)
    assert torch.equal(util.restore(1)[0]["a"], base)
    assert torch.equal(util.restore(2)[0]["a"], base * 2)


def test_streaming_save_bounded_host_residency(tmp_path, monkeypatch):
    """Variables are copied to the host one at a time: at no point do more
    than 2 fetched host copies coexist."""
    alive: set = set()
    max_alive = [0]
    orig_fetch = CheckpointUtil._fetch

    def tracking_fetch(value):
        gc.collect()
        host = orig_fetch(value)
        token = id(host)
        alive.add(token)
        weakref.finalize(host, alive.discard, token)
        max_alive[0] = max(max_alive[0], len(alive))
        return host

    monkeypatch.setattr(CheckpointUtil, "_fetch",
                        staticmethod(tracking_fetch))
    gen = torch.Generator().manual_seed(0)
    variables = {f"v{i}": torch.randn(512, 512, generator=gen)
                 for i in range(8)}
    CheckpointUtil(str(tmp_path)).save(3, variables)
    assert max_alive[0] <= 2, f"{max_alive[0]} host copies coexisted"
    data, step = CheckpointUtil(str(tmp_path)).restore()
    assert step == 3
    for k, v in variables.items():
        assert torch.equal(data[k], v)


def test_save_sharded_tree_round_trip(tmp_path):
    tree = {"a": torch.arange(16.0).reshape(4, 4),
            "blk": {"conv": torch.ones(2, dtype=torch.bfloat16),
                    "shortcut": None},
            "n": torch.tensor(3, dtype=torch.int32)}
    treedef = save_sharded(str(tmp_path), 11, tree)
    back, step = restore_sharded(str(tmp_path), treedef, device="cpu")
    assert step == 11 and back["blk"]["shortcut"] is None
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- files cross between the packages -------------------------------------

def _mixed_arrays():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "h": jnp.asarray(rng.standard_normal((7, 3)), jnp.bfloat16),
            "count": np.array(3, np.int32),
            "ids": np.arange(9, dtype=np.int64)}


def test_jax_checkpoint_restores_into_port_bit_for_bit(tmp_path):
    data = _mixed_arrays()
    JaxCheckpointUtil(str(tmp_path)).save(4, data)
    out, step = CheckpointUtil(str(tmp_path)).restore()
    assert step == 4 and sorted(out) == sorted(data)
    assert out["h"].dtype == torch.bfloat16
    assert out["count"].shape == ()
    for k, v in data.items():
        np.testing.assert_array_equal(_bits(out[k]), _bits(v))


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    data = {k: convert.array_to_tensor(v, device="cpu")
            for k, v in _mixed_arrays().items()}
    CheckpointUtil(str(tmp_path)).save(4, data)
    out, step = JaxCheckpointUtil(str(tmp_path)).restore()
    assert step == 4 and sorted(out) == sorted(data)
    assert out["h"].dtype == jnp.bfloat16
    for k, v in data.items():
        np.testing.assert_array_equal(_bits(out[k]), _bits(v))


_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None  # any import of it now raises ImportError
from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil
out, step = CheckpointUtil(sys.argv[1]).restore()
assert str(out["h"].dtype) == "torch.bfloat16", out["h"].dtype
print(out["h"].float().sum().item())
"""


def test_restore_needs_no_ml_dtypes(tmp_path):
    data = _mixed_arrays()
    JaxCheckpointUtil(str(tmp_path)).save(1, data)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES,
                          str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    want = float(np.asarray(data["h"], np.float32).sum())
    assert float(out.stdout.strip()) == pytest.approx(want, rel=1e-6)


# -- training resumed across the packages ---------------------------------

def _gpt2_case():
    cfg_j = dataclasses.replace(jgpt2.CONFIGS["test"])
    cfg_t = dataclasses.replace(tgpt2.CONFIGS["test"])
    params = jax.device_get(jgpt2.init_params(cfg_j, jax.random.PRNGKey(0)))
    return (params, jgpt2.fake_batch(cfg_j, 4, 32, seed=0),
            lambda p, t: jgpt2.loss_fn(p, t, cfg_j),
            lambda p, t: tgpt2.loss_fn(p, t, cfg_t),
            lambda: jax_adamw_bf16(LR), lambda: adamw_bf16(LR))


def _llama_case():
    cfg_j, cfg_t = jllama.CONFIGS["test"], tllama.CONFIGS["test"]
    params = jax.device_get(jllama.init_params(cfg_j,
                                               jax.random.PRNGKey(0)))
    return (params, jllama.fake_batch(cfg_j, 4, 32, seed=0),
            lambda p, t: jllama.loss_fn(p, t, cfg_j),
            lambda p, t: tllama.loss_fn(p, t, cfg_t),
            lambda: optax.adamw(LR), lambda: adamw(LR))


CASES = {"gpt2_adamw_bf16": _gpt2_case, "llama_adamw": _llama_case}


def _jax_plan(case, params):
    """A JAX plan on a copy of the numpy ``params`` (the plan donates its
    state buffers)."""
    _, toks, jloss, _, jopt, _ = case
    params = jax.tree_util.tree_map(np.array, params)
    return jax_plan_training(jloss, jopt(), params, toks,
                             num_micro_batches=2, devices=jax.devices()[:1])


def _torch_plan(case, params):
    _, toks, _, tloss, _, topt = case
    tparams = convert.to_torch(jax.device_get(params), device="cpu")
    return plan_training(tloss, topt(), tparams,
                         torch.tensor(np.asarray(toks)),
                         num_micro_batches=2, device="cpu")


def _jax_state(plan):
    return [np.asarray(jnp.asarray(a, jnp.float32))
            for a in jax.tree_util.tree_leaves(plan.variables())]


def _torch_state(plan):
    return [a.float().numpy() for a in tree_leaves(plan.variables())]


def _assert_resumed(loss, ref_loss, state, ref_state, bf16):
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert len(state) == len(ref_state) == len(bf16)
    for a, b, low in zip(state, ref_state, bf16):
        if not low:
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    if any(bf16):
        low = [i for i, x in enumerate(bf16) if x]
        a = np.concatenate([state[i].ravel() for i in low])
        b = np.concatenate([ref_state[i].ravel() for i in low])
        floor = np.concatenate([np.full(ref_state[i].size,
                                        1e-6 * np.abs(ref_state[i]).max())
                                for i in low])
        differ = a != b
        assert differ.mean() <= 0.01, differ.mean()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(b[differ]) + 1e-38)) - 7)
        assert np.all(np.abs(a - b)[differ] <= ulp + floor[differ])


def _bf16_moments(plan):
    """Per state leaf: a bf16 optimizer-state leaf?"""
    params, opt_state = plan.variables()
    return ([False] * len(tree_leaves(params))
            + [t.dtype == torch.bfloat16 for t in tree_leaves(opt_state)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_resumes_a_jax_checkpoint(tmp_path, name):
    """The JAX plan trains 2 steps and saves; a port plan built from other
    weights restores that file and runs step 3, which matches the JAX
    plan's own step 3."""
    case = CASES[name]()
    params, toks = case[0], case[1]
    jplan = _jax_plan(case, params)
    jplan.step(toks), jplan.step(toks)
    jplan.save(str(tmp_path), 2)
    ref_loss = jplan.step(toks)

    other = jax.tree_util.tree_map(lambda a: a * 2, params)
    tplan = _torch_plan(case, other)
    assert tplan.restore(str(tmp_path)) == 2
    loss = tplan.step(torch.tensor(np.asarray(toks)))
    _assert_resumed(loss, ref_loss, _torch_state(tplan), _jax_state(jplan),
                    _bf16_moments(tplan))


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_resumes_a_port_checkpoint(tmp_path, name):
    """The reverse: the port trains 2 steps and saves asynchronously; a
    JAX plan restores the file and its step 3 matches the port's."""
    case = CASES[name]()
    params, toks = case[0], case[1]
    ttoks = torch.tensor(np.asarray(toks))
    tplan = _torch_plan(case, params)
    tplan.step(ttoks), tplan.step(ttoks)
    handle = tplan.save(str(tmp_path), 2, block=False)
    ref_loss = tplan.step(ttoks)   # updates the state while the file writes
    assert handle.result(60).endswith("worker0.npz")

    other = jax.tree_util.tree_map(lambda a: a * 2, params)
    jplan = _jax_plan(case, other)
    assert jplan.restore(str(tmp_path)) == 2
    loss = jplan.step(toks)
    _assert_resumed(loss, ref_loss, _jax_state(jplan), _torch_state(tplan),
                    _bf16_moments(tplan))


def test_restore_is_bit_exact_and_rejects_a_wrong_tree(tmp_path):
    case = _gpt2_case()
    params, toks = case[0], torch.tensor(np.asarray(case[1]))
    plan = _torch_plan(case, params)
    plan.step(toks)
    plan.save(str(tmp_path), 1)
    saved = [t.clone() for t in tree_leaves(plan.variables())]
    fresh = _torch_plan(case, jax.tree_util.tree_map(lambda a: a * 0,
                                                     params))
    fresh.restore(str(tmp_path))
    for a, b in zip(tree_leaves(fresh.variables()), saved):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert fresh.step(toks) == plan.step(toks)
    small = plan_training(case[3], adamw_bf16(LR),
                          {"w": torch.zeros(3)}, toks, num_micro_batches=1,
                          device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        small.restore(str(tmp_path))
