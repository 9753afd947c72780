"""The wire form of a step (``tepdist_tpu_torch/rpc/fx_serde.py``), the
counterpart of the JAX package's ``rpc/jaxpr_serde.py``
(``tests/test_jaxpr_serde.py``'s round-trip cases).

Each captured graph (the MLP step, the GPT-2 ``test`` GA step with flash
and ``full`` remat and with ``save_attn``'s ``attn_out`` tags, Llama
``test``, the sequence-rewritten loss's gradient) is serialized and
decoded; the decoded graph run on real tensors equals the original bit
for bit, ``FxGraph`` over it has the same nodes and flops, every
``tepdist::`` op survives, and ``plan_axes`` gives the same strategies.
An op outside the allowlist is refused at decode time, and baked
``device=`` arguments and constants are rebound to the decoding device.
The inputs come from the JAX package's initializers (numpy), as the other
port tests take them.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.graph.fx_graph import FxGraph, trace_graph
from tepdist_tpu_torch.parallel.auto_parallel import plan_axes
from tepdist_tpu_torch.rpc import fx_serde, protocol

torch.set_num_threads(2)


def _ga_step(loss, opt, params, *batch, micro=2):
    from tepdist_tpu_torch.parallel.sync_free import build_ga_step
    from tepdist_tpu_torch.train import value_and_grad

    state = opt.init(params)
    step = build_ga_step(value_and_grad(loss),
                         lambda p, s, g: (p, opt.apply(p, g, s)), micro,
                         batch_argnums=tuple(range(1, 1 + len(batch))))
    return step, (params, state) + tuple(batch)


def _mlp():
    from tepdist_tpu_torch.optim import sgd

    rng = np.random.default_rng(0)
    params = {"w1": rng.standard_normal((16, 32)).astype(np.float32) * 0.1,
              "w2": rng.standard_normal((32, 4)).astype(np.float32) * 0.1}
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)

    def loss(p, x, y):
        return ((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    return _ga_step(loss, sgd(0.1), *convert.to_torch((params, x, y),
                                                      device="cpu"))


def _gpt2(**kw):
    import jax

    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adamw

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32,
                              **kw)
    jcfg = jgpt2.CONFIGS["test"]
    params = convert.to_torch(jax.device_get(jgpt2.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    tokens = torch.from_numpy(np.asarray(jgpt2.fake_batch(jcfg, 4, 32,
                                                          seed=3)))
    return _ga_step(lambda p, t: gpt2.loss_fn(p, t, cfg), adamw(1e-3),
                    params, tokens)


def _llama():
    import jax

    from tepdist_tpu.models import llama as jllama
    from tepdist_tpu_torch.models import llama
    from tepdist_tpu_torch.optim import adam

    cfg = dataclasses.replace(llama.CONFIGS["test"], dtype=torch.float32)
    jcfg = jllama.CONFIGS["test"]
    params = convert.to_torch(jax.device_get(jllama.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    tokens = torch.from_numpy(np.asarray(jllama.fake_batch(jcfg, 2, 32,
                                                           seed=3)))
    return _ga_step(lambda p, t: llama.loss_fn(p, t, cfg), adam(1e-3),
                    params, tokens)


def _seq_loss():
    """The value-and-grad of GPT-2 ``test`` (flash) rewritten for a
    4-rank ring: the ``tepdist::seq_attn`` op and its backward."""
    import jax

    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.parallel.attention_motif import (
        seq_rewritten_loss)
    from tepdist_tpu_torch.train import value_and_grad

    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32,
                              attn="flash", n_ctx=64)
    jcfg = dataclasses.replace(jgpt2.CONFIGS["test"], n_ctx=64)
    params = convert.to_torch(jax.device_get(jgpt2.init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    tokens = torch.from_numpy(np.asarray(jgpt2.fake_batch(jcfg, 2, 64,
                                                          seed=3)))
    rw, _ = seq_rewritten_loss(lambda p, t: gpt2.loss_fn(p, t, cfg), 4,
                               params, tokens)
    return value_and_grad(rw), (params, tokens)


CASES = {
    "mlp_step": _mlp,
    "gpt2_flash_full_remat": lambda: _gpt2(attn="flash", remat=True),
    "gpt2_save_attn": lambda: _gpt2(attn="einsum", remat=True,
                                    remat_policy="save_attn"),
    "llama_step": _llama,
    "seq_rewritten_grad": _seq_loss,
}
WANT_OPS = {"gpt2_flash_full_remat": ("flash_fwd", "flash_dq", "flash_dkv"),
            "gpt2_save_attn": ("attn_out",),
            "seq_rewritten_grad": ("seq_attn", "seq_attn_bwd")}


def _tepdist_ops(gm):
    return collections.Counter(
        n.target._schema.name.split("::")[1] for n in gm.graph.nodes
        if n.op == "call_function"
        and isinstance(n.target, torch._ops.OpOverload)
        and n.target._schema.name.startswith("tepdist::"))


@pytest.mark.parametrize("name", list(CASES))
def test_round_trip(name):
    fn, args = CASES[name]()
    graph, _, _ = trace_graph(fn, *args, functional=True)
    data = fx_serde.serialize_graph(graph.gm)
    gm = fx_serde.deserialize_graph(data, device="cpu")
    back = FxGraph(gm)
    # Same nodes (kind, op, name) and flops.
    assert [(n.op, str(n.target), n.name) for n in gm.graph.nodes] == [
        (n.op, str(n.target), n.name) for n in graph.gm.graph.nodes]
    assert len(back.nodes) == len(graph.nodes)
    assert back.total_flops() == graph.total_flops()
    ops = _tepdist_ops(gm)
    assert ops == _tepdist_ops(graph.gm)
    for op in WANT_OPS.get(name, ()):
        assert ops[op] > 0, (op, ops)
    # Every node's re-derived value has the capture's shape and dtype.
    for a, b in zip(graph.gm.graph.nodes, gm.graph.nodes):
        va, vb = a.meta.get("val"), b.meta.get("val")
        if isinstance(va, torch.Tensor):
            assert (tuple(va.shape), va.dtype) == (tuple(vb.shape),
                                                   vb.dtype), a.name
    # Bit for bit on real tensors.
    leaves = [x.detach().clone() for x in tree_leaves(args)]
    want = graph.gm(*[x.clone() for x in leaves])
    got = gm(*[x.clone() for x in leaves])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # The planner reads the same graph.
    if name != "seq_rewritten_grad":
        topo = MeshTopology([("data", 2)])
        (ws,), (gs,) = plan_axes(graph, topo), plan_axes(back, topo)
        assert ({v.name: str(s) for v, s in gs.var_strategies.items()}
                == {v.name: str(s) for v, s in ws.var_strategies.items()})


def test_op_outside_the_allowlist_is_refused():
    fn, args = CASES["mlp_step"]()
    graph, _, _ = trace_graph(fn, *args, functional=True)
    header, blobs = fx_serde.encode_graph(graph.gm)
    for bad in ("os::system", "builtins.eval", "torch.load",
                "aten::no_such_op.default"):
        nodes = [dict(n) for n in header["nodes"]]
        k = next(i for i, n in enumerate(nodes)
                 if n["op"] == "call_function")
        nodes[k]["target"] = bad
        with pytest.raises(fx_serde.SerdeError):
            fx_serde.decode_graph(dict(header, nodes=nodes), blobs)
    # A Python callable never reaches the wire.
    node = next(n for n in graph.gm.graph.nodes if n.op == "call_function")
    node.target = torch.sin
    with pytest.raises(fx_serde.SerdeError, match="no wire form"):
        fx_serde.encode_graph(graph.gm)


def test_device_arguments_and_constants_are_rebound():
    """A factory op's baked ``device=`` and a lifted constant land on the
    decoding device (``meta`` here: the card's stand-in)."""
    def fn(x):
        pos = torch.arange(x.shape[1], device=x.device)
        return x * pos + torch.tensor([0.5, 1.5, 2.5, 3.5])

    x = torch.randn(2, 4)
    graph, _, _ = trace_graph(fn, x)
    header, blobs = fx_serde.encode_graph(graph.gm)
    devices = [a for n in header["nodes"]
               for a in n.get("kwargs", {}).values()
               if isinstance(a, dict) and "device" in a]
    assert devices and all(a["device"] == "cpu" for a in devices)
    assert any(n["op"] == "get_attr" for n in header["nodes"])
    gm = fx_serde.decode_graph(header, blobs, device="meta")
    kw = [n.kwargs["device"] for n in gm.graph.nodes
          if n.op == "call_function" and "device" in n.kwargs]
    assert kw and all(d == torch.device("meta") for d in kw)
    assert all(b.device.type == "meta" for b in gm.buffers())
    assert all(n.meta["val"].device.type == "meta" for n in gm.graph.nodes
               if n.op in ("placeholder", "call_function"))
    # On the CPU the decoded graph computes the original.
    cpu = fx_serde.decode_graph(header, blobs, device="cpu")
    assert torch.equal(cpu(x)[0], graph.gm(x)[0])


def test_wire_header_is_json_with_literal_constants():
    """The message is the protocol envelope: a JSON header of nodes and
    one literal blob per constant, nothing executable."""
    def fn(x):
        return x + torch.tensor([1.0, 2.0], dtype=torch.bfloat16)

    graph, _, _ = trace_graph(fn, torch.ones(2, dtype=torch.bfloat16))
    data = fx_serde.serialize_graph(graph.gm)
    header, blobs = protocol.unpack(data)
    assert header["fx_graph"] == 1 and len(blobs) == 1
    const = next(n for n in header["nodes"] if n["op"] == "get_attr")
    assert const["literal"] == {"dtype": "bfloat16", "shape": [2]}
    assert b"pickle" not in data and b"exec" not in data
