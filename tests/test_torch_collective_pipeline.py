"""The port's collective (single-program) pipeline in its device form,
``ops/collective_pipeline.py`` over ``["cpu"] * 4``, held to the JAX
package's ``collective_pipeline`` on 4 virtual CPU devices
(``tests/conftest.py``), the reference's own cases
(``tests/test_collective_pipeline.py``): the wavefront against the
sequential stages, its gradients, a training step, GPT-2 against the dense
loss, and PP x DP. Its tolerances: outputs rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-6, GPT-2's loss rtol 2e-5. The group form
and PP x TP run on 4 gloo ranks in ``tests/test_torch_pipeline_dist.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.ops.collective_pipeline import (
    collective_pipeline as jax_collective_pipeline)
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.ops.collective_pipeline import (collective_pipeline,
                                                       sequential_reference)
from tepdist_tpu_torch.optim import adam

torch.set_num_threads(2)

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _jax_stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _setup(S=4, M=8, mb=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    stacked = {"w": (rng.standard_normal((S, d, d)) * 0.5).astype(np.float32),
               "b": (rng.standard_normal((S, d)) * 0.1).astype(np.float32)}
    return stacked, rng.standard_normal((M, mb, d)).astype(np.float32)


def _t(tree, grad=False):
    out = convert.to_torch(tree, device="cpu")
    if grad:
        out = {k: v.requires_grad_() for k, v in out.items()}
    return out


@pytest.fixture()
def stage_mesh(devices):
    return Mesh(np.array(devices[:4]), axis_names=("stage",))


def test_pipeline_matches_sequential_and_reference(stage_mesh):
    stacked, x = _setup()
    got = collective_pipeline(_stage_fn, ["cpu"] * 4)(_t(stacked),
                                                       torch.tensor(x))
    want = jax_collective_pipeline(_jax_stage_fn, stage_mesh)(stacked, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    seq = sequential_reference(_stage_fn, _t(stacked), torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), seq.numpy(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_pipeline_gradients_match(stage_mesh):
    stacked, x = _setup(M=4)
    p = _t(stacked, grad=True)
    y = collective_pipeline(_stage_fn, ["cpu"] * 4)(p, torch.tensor(x))
    (y ** 2).mean().backward()
    pipelined = jax_collective_pipeline(_jax_stage_fn, stage_mesh)
    want = jax.grad(lambda q: (pipelined(q, x) ** 2).mean())(
        jax.tree_util.tree_map(jnp.asarray, stacked))
    for k in stacked:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(want[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_pipeline_training_step(stage_mesh):
    """Six adam steps of the wavefront's squared output: the losses equal
    the reference's one-jit steps (its bound for gradients) and fall."""
    stacked, x = _setup(M=4)
    pipelined = jax_collective_pipeline(_jax_stage_fn, stage_mesh)
    tx = optax.adam(1e-2)

    @jax.jit
    def step(p, o):
        l, g = jax.value_and_grad(
            lambda p: (pipelined(p, x) ** 2).mean())(p)
        u, o = tx.update(g, o, p)
        return l, optax.apply_updates(p, u), o

    p = jax.tree_util.tree_map(jnp.asarray, stacked)
    o, want = tx.init(p), []
    for _ in range(6):
        l, p, o = step(p, o)
        want.append(float(l))

    tp = _t(stacked)
    opt = adam(1e-2)
    state, got = opt.init(tp), []
    run = collective_pipeline(_stage_fn, ["cpu"] * 4)
    xt = torch.tensor(x)
    for _ in range(6):
        leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
        loss = (run(leaves, xt) ** 2).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        state = opt.apply(tp, grads, state)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL)
    assert got[-1] < got[0]


def test_gpt2_collective_pipeline_matches_dense(stage_mesh):
    """GPT-2 with its block stack run as the collective pipeline over 4
    stages: the loss equals the dense loss (and the reference's pipelined
    loss), and its gradients equal the dense ones on the stacked
    layout."""
    jcfg = jgpt2.GPT2Config(vocab_size=512, n_ctx=64, n_embd=64, n_layer=4,
                            n_head=4, dtype=jnp.float32)
    tcfg = tgpt2.GPT2Config(vocab_size=512, n_ctx=64, n_embd=64, n_layer=4,
                            n_head=4, dtype=torch.float32)
    params = jax.device_get(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(jcfg, 8, 32))
    jembed, jstacked = jgpt2.shard_stacked_for_stages(params, jcfg,
                                                      stage_mesh)
    want = float(jgpt2.pipelined_loss_fn(jembed, jstacked, tokens, jcfg,
                                         stage_mesh, num_micro=4))
    dense = float(jgpt2.loss_fn(params, tokens, jcfg))
    tp = convert.to_torch(params, device="cpu")
    embed, stacked = tgpt2.shard_stacked_for_stages(tp, tcfg, ["cpu"] * 4)
    assert stacked["attn_qkv_w"].shape == (4, 1, 64, 192)
    leaves = {k: v.detach().requires_grad_() for k, v in stacked.items()}
    loss = tgpt2.pipelined_loss_fn(embed, leaves, torch.tensor(tokens),
                                   tcfg, ["cpu"] * 4, num_micro=4)
    np.testing.assert_allclose(float(loss), dense, rtol=2e-5)
    np.testing.assert_allclose(float(loss), want, rtol=2e-5)
    loss.backward()
    gd = jax.grad(lambda p: jgpt2.loss_fn(p, tokens, jcfg))(params)
    for k, leaf in leaves.items():
        dense_stack = np.stack([np.asarray(gd[f"h{i}"][k])
                                for i in range(4)]).reshape(leaf.shape)
        np.testing.assert_allclose(leaf.grad.numpy(), dense_stack,
                                   rtol=2e-4, atol=GRAD_ATOL)


def test_pipeline_pp_x_dp_hybrid(devices):
    """PP x DP: 2 stages x 4 data replicas (``[["cpu"] * 4] * 2``), the
    micro rows split over the replicas: outputs and gradients against the
    reference's 2 x 4 mesh."""
    mesh2d = Mesh(np.array(devices).reshape(2, 4),
                  axis_names=("stage", "data"))
    stacked, x = _setup(S=2, M=4, mb=8)
    jpipe = jax_collective_pipeline(_jax_stage_fn, mesh2d, data_axis="data")
    want = jpipe(stacked, x)
    pipe = collective_pipeline(_stage_fn, [["cpu"] * 4] * 2,
                               data_axis="data")
    p = _t(stacked, grad=True)
    got = pipe(p, torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    (got ** 2).mean().backward()
    gw = jax.grad(lambda q: (jpipe(q, x) ** 2).mean())(
        jax.tree_util.tree_map(jnp.asarray, stacked))
    for k in stacked:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(gw[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_model_axis_needs_a_device_mesh():
    """A device list holds every rank in one process: tensor parallelism
    over a model axis raises, never runs untiled."""
    with pytest.raises(ValueError, match="one rank a device"):
        collective_pipeline(_stage_fn, ["cpu"] * 4, model_axis="model")
