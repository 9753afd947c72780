"""The port's traceable flash ops and graph capture
(``tepdist_tpu_torch/ops/flash_attention.py``, ``graph/fx_graph.py``,
``graph/cost.py``) held against the JAX package's jaxpr capture, on the
CPU.

- Ops: each flash op's fake impl gives its real output's shape and dtype,
  and the op path (taken under a dispatch mode) and the direct path give
  bit-identical values through the same kernel wrappers.
- Capture: the GPT-2 ``test`` flash loss-and-grad, captured on fake
  tensors, holds one ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` node a
  layer (two ``flash_fwd`` under ``full`` remat), as the reference's jaxpr
  holds its ``pallas_call``s, each with causal, scale and the head count;
  run on real tensors the graph gives the eager loss and grads (fp32, rel.
  1e-6: the graph computes the tanh GELU as the reference's chain of
  primitives, the eager step as one op); capture allocates no memory for
  the step's values.
- Cost: matmul flops of the captured graphs equal the reference's
  ``dot_general`` flops on the same models.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from tepdist_tpu.graph.jaxpr_graph import trace_graph as jax_trace_graph
from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import llama as jllama
from tepdist_tpu.models import mlp as jmlp
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.graph import cost
from tepdist_tpu_torch.graph.fx_graph import trace_graph
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.models import llama as tllama
from tepdist_tpu_torch.models import mlp as tmlp
from tepdist_tpu_torch.ops import flash_attention as tfa
from tepdist_tpu_torch.train import value_and_grad

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_OPS = ("flash_fwd", "flash_dq", "flash_dkv")


class _Passthrough(TorchDispatchMode):
    """An active dispatch mode that changes nothing: the flash attention
    takes its op path under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _qkv(dtype, seed=0, shape=(2, 3, 40, 16)):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape, dtype=np.float32)).to(
        dtype) for _ in range(5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_impls_match_real_outputs(dtype):
    q, k, v, do, _ = (x.reshape(6, 40, 16) for x in _qkv(dtype))
    lse = torch.zeros(6, 40)
    delta = torch.zeros(6, 40)
    calls = {
        tfa.FLASH_FWD_OP: (q, k, v, True, 0.25, 3),
        tfa.FLASH_DQ_OP: (q, k, v, do, lse, delta, True, 0.25, 3),
        tfa.FLASH_DKV_OP: (q, k, v, do, lse, delta, False, 0.25, 3),
    }
    for op, args in calls.items():
        real = op(*args)
        with FakeTensorMode() as mode:
            fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args]
            fake = op(*fake_args)
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert len(real) == len(fake)
        for r, f in zip(real, fake):
            assert isinstance(f, FakeTensor)
            assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype,
                                                      r.stride())
    o, lse = tfa.FLASH_FWD_OP(*calls[tfa.FLASH_FWD_OP])
    assert (o.dtype, lse.dtype, lse.shape) == (dtype, torch.float32, (6, 40))


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_path_equals_direct_path(dtype, with_lse, monkeypatch):
    """Forward and backward through the ops (under a dispatch mode) and
    straight through the wrappers give the same bits, and call each
    kernel wrapper as often (the card's launch counts)."""
    q0, k0, v0, do, dl = _qkv(dtype, seed=1)
    dlse = dl[..., 0].float()
    counts = {}
    for name in FLASH_OPS:
        wrapped = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _w=wrapped: (
            counts.__setitem__(_n, counts.get(_n, 0) + 1) or _w(*a)))

    def run():
        counts.clear()
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        if with_lse:
            o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
            loss = (o.float() * do.float()).sum() + (lse * dlse).sum()
            outs = [o, lse]
        else:
            o = tfa.flash_attention(q, k, v, causal=True)
            loss = (o.float() * do.float()).sum()
            outs = [o]
        grads = torch.autograd.grad(loss, (q, k, v))
        return [t.detach() for t in (*outs, *grads)], dict(counts)

    direct, direct_counts = run()
    with _Passthrough():
        via_ops, op_counts = run()
    assert direct_counts == op_counts == {n: 1 for n in FLASH_OPS}
    for a, b in zip(direct, via_ops):
        assert torch.equal(a, b)


def _gpt2_cfgs(**kw):
    return (dataclasses.replace(jgpt2.CONFIGS["test"], **kw),
            dataclasses.replace(tgpt2.CONFIGS["test"], **kw))


def _gpt2_capture(remat: bool, seed=3):
    cfg_j, cfg = _gpt2_cfgs(attn="flash", remat=remat, loss_chunk=48)
    params = jgpt2.init_params(cfg_j, jax.random.PRNGKey(0))
    toks = np.asarray(jgpt2.fake_batch(cfg_j, 4, 32, seed=seed))
    tparams = convert.to_torch(jax.device_get(params), device="cpu")
    ttoks = torch.tensor(toks).long()
    grad_fn = value_and_grad(lambda p, t: tgpt2.loss_fn(p, t, cfg))
    graph, _, _ = trace_graph(grad_fn, tparams, ttoks)
    return cfg, graph, grad_fn, tparams, ttoks, (params, toks, cfg_j)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "full"])
def test_capture_holds_the_flash_ops(remat):
    cfg, graph, *_, (params, toks, cfg_j) = _gpt2_capture(remat)
    L = cfg.n_layer
    counts = {name: graph.count(name) for name in FLASH_OPS}
    assert counts == {"flash_fwd": 2 * L if remat else L,
                      "flash_dq": L, "flash_dkv": L}
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for node in graph.nodes:
        if node.prim in FLASH_OPS:
            causal, s, n_head = node.args[-3:]
            assert (causal, n_head) == (True, cfg.n_head)
            assert s == pytest.approx(scale, rel=1e-12)
    if remat:
        return
    # The reference's jaxpr of the same loss and grad: a pallas_call per
    # kernel call, the forward's name carrying causal, scale and heads.
    jgraph, _, _ = jax_trace_graph(
        jax.value_and_grad(lambda p: jgpt2.loss_fn(p, jnp.asarray(toks),
                                                   cfg_j)), params)
    calls = [n for n in jgraph.nodes if n.prim == "pallas_call"]
    fwd = [n for n in calls if str(n.eqn.params.get("name", "")).startswith(
        "tepdist_flash_fwd")]
    assert len(calls) == sum(counts.values())
    assert len(fwd) == counts["flash_fwd"]
    name = str(fwd[0].eqn.params["name"])
    assert name.endswith(f"__c1__s{scale!r}__h{cfg.n_head}")


def test_captured_graph_equals_eager():
    cfg, graph, grad_fn, tparams, ttoks, _ = _gpt2_capture(remat=True)
    leaves = tree_leaves((tparams, ttoks))
    out = graph.gm(*leaves)
    loss, grads = grad_fn(tparams, ttoks)
    want = [loss] + tree_leaves(grads)
    assert len(out) == len(want)
    for got, ref in zip(out, want):
        scale = ref.abs().max().clamp_min(1e-30)
        assert ((got - ref).abs().max() / scale).item() <= 1e-6


_ALLOC_PROBE = """
import resource, sys, torch
from tepdist_tpu_torch.graph.fx_graph import trace_graph
from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.train import value_and_grad
import dataclasses
torch.set_num_threads(2)
cfg = dataclasses.replace(gpt2.CONFIGS["test"], n_embd=256, n_head=4,
                          vocab_size=4096, n_ctx=512, attn="flash")
params = gpt2.init_params(cfg, device="cpu")
toks = gpt2.fake_batch(cfg, 64, 511, device="cpu")
grad_fn = value_and_grad(lambda p, t: gpt2.loss_fn(p, t, cfg))
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
graph, _, _ = trace_graph(grad_fn, params, toks)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
values = sum(n.out_bytes() for n in graph.nodes)
print(len(graph), (after - before) * 1024, values)
"""


def test_capture_allocates_no_step_memory():
    """Captured in a fresh interpreter at 64 x 512 tokens and width 256:
    the step's values total well over 2 GB, and the process's peak
    resident memory grows by under 256 MB while capturing them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ALLOC_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_nodes, grown, values = (float(x) for x in out.stdout.split()[-3:])
    assert n_nodes > 100
    assert values > 2e9
    assert grown < 256 * 2 ** 20


def _matmul_flops(nodes, prims):
    return sum(n.flops for n in nodes if n.prim in prims)


def _models():
    rng = np.random.default_rng(0)
    cj, ct = jgpt2.CONFIGS["test"], tgpt2.CONFIGS["test"]
    lj, lt = jllama.CONFIGS["test"], tllama.CONFIGS["test"]
    toks = rng.integers(0, 512, (8, 33)).astype(np.int32)
    return {
        "mlp": (jmlp.mlp_loss, tmlp.mlp_loss,
                jmlp.init_mlp(jax.random.PRNGKey(0)),
                [rng.standard_normal((16, 32), dtype=np.float32),
                 rng.standard_normal((16, 8), dtype=np.float32)]),
        "attention": (jmlp.attention_loss, tmlp.attention_loss,
                      jmlp.init_attention(jax.random.PRNGKey(0)),
                      [rng.standard_normal((8, 16, 64), dtype=np.float32),
                       rng.standard_normal((8, 16, 64), dtype=np.float32)]),
        "gpt2": (lambda p, t: jgpt2.loss_fn(p, t, cj),
                 lambda p, t: tgpt2.loss_fn(p, t, ct),
                 jgpt2.init_params(cj, jax.random.PRNGKey(0)), [toks]),
        "llama": (lambda p, t: jllama.loss_fn(p, t, lj),
                  lambda p, t: tllama.loss_fn(p, t, lt),
                  jllama.init_params(lj, jax.random.PRNGKey(0)), [toks]),
    }


@pytest.mark.parametrize("model", ["mlp", "attention", "gpt2", "llama"])
def test_matmul_flops_equal_the_reference(model):
    """The contractions of the loss-and-grad graph cost what the
    reference's dot_generals cost (2 x output x contracted size), and the
    graph's total counts them."""
    jl, tl, params, batch = _models()[model]
    jgraph, _, _ = jax_trace_graph(jax.value_and_grad(jl), params,
                                   *map(jnp.asarray, batch))
    graph, _, _ = trace_graph(
        value_and_grad(tl), convert.to_torch(jax.device_get(params),
                                             device="cpu"),
        *(torch.tensor(b).long() if b.dtype == np.int32 else torch.tensor(b)
          for b in batch))
    want = _matmul_flops(jgraph.nodes, {"dot_general"})
    assert want > 0
    assert _matmul_flops(graph.nodes, cost.MATMULS) == want
    assert graph.total_flops() >= want


def test_node_costs():
    """mm: 2 M N K flops; an elementwise op one flop per output element;
    a flash op one flop per output element (as the reference prices its
    pallas_call); bytes = operands + results."""
    a, b = torch.zeros(6, 5), torch.zeros(5, 7)
    out = [torch.zeros(6, 7)]
    assert cost.node_flops("mm", [a, b], out) == 2 * 6 * 7 * 5
    assert cost.node_flops("addmm", [torch.zeros(7), a, b], out) == 420
    bm = [torch.zeros(3, 6, 5), torch.zeros(3, 5, 7)]
    assert cost.node_flops("bmm", bm, [torch.zeros(3, 6, 7)]) == 2 * 126 * 5
    x = torch.zeros(4, 8, 3, 3)
    w = torch.zeros(16, 8, 3, 3)
    y = torch.zeros(4, 16, 3, 3)
    assert cost.node_flops("convolution", [x, w], [y]) == 2 * y.numel() * 72
    assert cost.node_flops("add", [a, a], [a]) == 30
    q = torch.zeros(6, 40, 16, dtype=torch.bfloat16)
    lse = torch.zeros(6, 40)
    assert cost.node_flops("flash_fwd", [q, q, q], [q, lse]) == 6 * 40 * 17
    assert cost.node_bytes([q, q, q], [q, lse]) == 4 * q.numel() * 2 + 960
    assert cost.COMPUTE_INTENSIVE == {"mm", "addmm", "bmm", "baddbmm",
                                      "convolution"}


def _flops_by_prim(graph):
    out = {}
    for n in graph.nodes:
        out.setdefault(n.prim, []).append(n.flops)
    return out


_LAYOUT_CASES = {
    # A layer on [B, T, C] rows: view -> mm -> _unsafe_view in aten, one
    # dot_general in the jaxpr.
    "linear": (lambda x, w, v: x @ w, lambda x, w, v: x @ w),
    # GPT-2's attention einsum: unsqueeze/permute/view -> bmm -> view/
    # permute/view in aten, one dot_general in the jaxpr.
    "heads": (lambda x, w, v: torch.einsum("bhqd,bhkd->bhqk", x, x),
              lambda x, w, v: jnp.einsum("bhqd,bhkd->bhqk", x, x)),
    # The same layouts feeding an add are priced in both (the jaxpr's
    # reshape and transpose equations).
    "reshape_add": (lambda x, w, v: x.reshape(2, -1) + 1.0,
                    lambda x, w, v: x.reshape(2, -1) + 1.0),
    "permute_add": (lambda x, w, v: x.permute(0, 2, 1, 3) + 1.0,
                    lambda x, w, v: jnp.transpose(x, (0, 2, 1, 3)) + 1.0),
    # ``a @ b.T`` holds transpose equations in the jaxpr too.
    "transpose_mm": (lambda x, w, v: w.T @ v.T,
                     lambda x, w, v: w.T @ v.T),
}


@pytest.mark.parametrize("case", sorted(_LAYOUT_CASES))
def test_layout_nodes_priced_as_the_jaxpr(case):
    """ROADMAP C14: a ``view``/``permute`` (and ``_unsafe_view``,
    ``unsqueeze``, ``expand``, ``t``) that only lays out a contraction's
    operands or its result costs zero, as ``dot_general``'s dimension
    numbers absorb it (a transpose only next to a batched contraction);
    the same node feeding an ``add`` costs one flop per output element.
    Each function's total flops equal the reference's jaxpr on the same
    shapes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    v = rng.standard_normal((6, 4)).astype(np.float32)
    tf, jf = _LAYOUT_CASES[case]
    graph, _, _ = trace_graph(tf, *map(torch.tensor, (x, w, v)))
    jgraph, _, _ = jax_trace_graph(jf, *map(jnp.asarray, (x, w, v)))
    assert graph.total_flops() == jgraph.total_flops()
    prims = _flops_by_prim(graph)
    if case in ("linear", "heads"):
        layout = [f for p in cost.FOLDED_VIEWS for f in prims.get(p, [])]
        assert layout and not any(layout)
    if case.endswith("_add"):
        node = "view" if case == "reshape_add" else "permute"
        assert prims[node] == [float(x.size)]
    if case == "transpose_mm":
        assert sum(prims.get("permute", []) + prims.get("t", [])) == (
            v.size + w.size)
