"""The wire form of a step: an aten graph, node by node (the port's
counterpart of the JAX package's ``rpc/jaxpr_serde.py``).

The reference ships the jaxpr its planner reads, eqn by eqn, with each
primitive looked up by name on the server. The port ships the graph its
planner reads: the functional aten graph that
``graph/fx_graph.trace_graph(functional=True)`` captures, with the
kernels as the ``tepdist::`` custom ops.

Wire form (a ``protocol`` envelope, one JSON header and one blob per
constant):

  * nodes in graph order, each ``{"op", "name", ...}`` of kind
    ``placeholder`` (its shape and dtype), ``get_attr`` (a constant: the
    index of its literal blob), ``call_function`` (``target`` and the
    encoded ``args``/``kwargs``) or ``output``;
  * a target is an ``OpOverload``'s qualified name,
    ``"<ns>::<op>.<overload>"``, resolved on the server through
    ``torch.ops.<ns>.<op>.<overload>`` for a namespace on the allowlist
    (``aten``, ``prims``, ``tepdist``), or ``"operator.getitem"``, the one
    Python callable allowed;
  * an argument is a node reference, a scalar (floats that JSON cannot
    hold are tagged), a ``torch.dtype``, ``torch.device``, layout or
    memory format, or a list or tuple of these.

Nothing executable travels: no pickle, no ``exec`` of generated code, no
``torch.load``. On the server every ``device=`` argument is rebound to the
server's device and every constant placed there, and ``meta["val"]`` is
derived again with ``FakeTensorProp`` from the shipped input shapes and
dtypes (the reference re-derives effects with ``abstract_eval`` alike).
"""

from __future__ import annotations

import importlib
import math
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.fx as fx

from tepdist_tpu_torch.rpc import protocol

NAMESPACES = ("aten", "prims", "tepdist")
# The modules that register the ``tepdist::`` ops: the server imports them
# before it resolves any name.
OP_MODULES = ("tepdist_tpu_torch.ops.flash_attention",
              "tepdist_tpu_torch.models.gpt2",
              "tepdist_tpu_torch.ops.ring_attention")
_GETITEM = "operator.getitem"
_LAYOUTS = {str(torch.strided): torch.strided}
_FORMATS = {str(x): x for x in (torch.contiguous_format,
                                torch.preserve_format,
                                torch.channels_last,
                                torch.channels_last_3d)}


class SerdeError(ValueError):
    """A graph the wire form cannot carry, or a message that names
    something the server does not resolve."""


# -- encode -----------------------------------------------------------------

def _target_name(target) -> str:
    if target is operator.getitem:
        return _GETITEM
    if isinstance(target, torch._ops.OpOverload):
        ns, op = target._schema.name.split("::")
        if ns not in NAMESPACES:
            raise SerdeError(f"op namespace {ns!r} of {target} is not on "
                             f"the wire's allowlist {NAMESPACES}")
        return f"{ns}::{op}.{target._overloadname}"
    raise SerdeError(f"call target {target!r} has no wire form (an aten, "
                     "prims or tepdist op overload, or operator.getitem)")


def _enc(a) -> Any:
    if isinstance(a, fx.Node):
        return {"n": a.name}
    if a is None or isinstance(a, (bool, str)):
        return a
    if isinstance(a, int):
        return a
    if isinstance(a, float):
        return a if math.isfinite(a) else {"float": repr(a)}
    if isinstance(a, torch.dtype):
        return {"dtype": protocol.dtype_name(a)}
    if isinstance(a, torch.device):
        return {"device": str(a)}
    if isinstance(a, torch.layout):
        return {"layout": str(a)}
    if isinstance(a, torch.memory_format):
        return {"memory_format": str(a)}
    if isinstance(a, list):
        return {"list": [_enc(x) for x in a]}
    if isinstance(a, tuple):
        return {"tuple": [_enc(x) for x in a]}
    raise SerdeError(f"argument {a!r} ({type(a).__name__}) has no wire form")


def _val_meta(n: fx.Node) -> Dict[str, Any]:
    val = n.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise SerdeError(f"placeholder {n.name} has no tensor meta['val']")
    return {"shape": list(val.shape), "dtype": protocol.dtype_name(val.dtype)}


def encode_graph(gm: fx.GraphModule) -> Tuple[Dict[str, Any], List[Any]]:
    """(header, blobs) of ``gm``: the JSON node list and one literal blob
    per constant."""
    nodes: List[Dict[str, Any]] = []
    blobs: List[Any] = []
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            nodes.append({"op": "placeholder", "name": n.name,
                          **_val_meta(n)})
        elif n.op == "get_attr":
            const = getattr(gm, n.target)
            if not isinstance(const, torch.Tensor):
                raise SerdeError(f"attribute {n.target} is not a tensor")
            meta, blob = protocol.encode_literal(const)
            nodes.append({"op": "get_attr", "name": n.name,
                          "target": n.target, "literal": meta,
                          "blob": len(blobs)})
            blobs.append(blob)
        elif n.op == "call_function":
            nodes.append({"op": "call_function", "name": n.name,
                          "target": _target_name(n.target),
                          "args": _enc(list(n.args)),
                          "kwargs": {k: _enc(v)
                                     for k, v in n.kwargs.items()}})
        elif n.op == "output":
            nodes.append({"op": "output", "name": n.name,
                          "args": _enc(list(n.args))})
        else:
            raise SerdeError(f"node kind {n.op!r} ({n.name}) has no wire "
                             "form")
    return {"fx_graph": 1, "nodes": nodes}, blobs


def serialize_graph(gm: fx.GraphModule) -> bytes:
    """The envelope bytes of ``gm`` (``protocol.pack``)."""
    header, blobs = encode_graph(gm)
    return protocol.pack(header, blobs)


# -- decode -----------------------------------------------------------------

_registered = False


def _register_ops() -> None:
    global _registered
    if not _registered:
        for mod in OP_MODULES:
            importlib.import_module(mod)
        _registered = True


def resolve_target(name: str):
    """The callable a wire target names, on the allowlist only."""
    if name == _GETITEM:
        return operator.getitem
    if "::" not in name:
        raise SerdeError(f"target {name!r} is not an op overload name")
    ns, rest = name.split("::", 1)
    if ns not in NAMESPACES:
        raise SerdeError(f"op namespace {ns!r} of {name!r} is not on the "
                         f"allowlist {NAMESPACES}")
    op, _, overload = rest.partition(".")
    _register_ops()
    try:
        target = getattr(getattr(getattr(torch.ops, ns), op),
                         overload or "default")
    except (AttributeError, RuntimeError) as e:
        raise SerdeError(f"unknown op {name!r}") from e
    if not isinstance(target, torch._ops.OpOverload):
        raise SerdeError(f"{name!r} does not name an op overload")
    return target


def _dec(a, env: Dict[str, fx.Node], device: Optional[torch.device]):
    if isinstance(a, dict):
        if "n" in a:
            if a["n"] not in env:
                raise SerdeError(f"reference to unknown node {a['n']!r}")
            return env[a["n"]]
        if "list" in a:
            return [_dec(x, env, device) for x in a["list"]]
        if "tuple" in a:
            return tuple(_dec(x, env, device) for x in a["tuple"])
        if "float" in a:
            return float(a["float"])
        if "dtype" in a:
            return protocol.torch_dtype(a["dtype"])
        if "device" in a:
            return device if device is not None else torch.device(
                a["device"])
        for key, table in (("layout", _LAYOUTS),
                           ("memory_format", _FORMATS)):
            if key in a:
                if a[key] not in table:
                    raise SerdeError(f"unknown {key} {a[key]!r}")
                return table[a[key]]
        raise SerdeError(f"unknown argument form {sorted(a)}")
    if isinstance(a, list):
        raise SerdeError("untagged list in the wire form")
    return a


def decode_graph(header: Dict[str, Any], blobs: Sequence[Any],
                 device=None) -> fx.GraphModule:
    """The ``fx.GraphModule`` of a wire form, on ``device`` (every
    ``device=`` argument and every constant rebound there), with
    ``meta["val"]`` on each node from ``FakeTensorProp``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.passes.fake_tensor_prop import FakeTensorProp

    if header.get("fx_graph") != 1:
        raise SerdeError("not an fx graph message")
    device = torch.device(device) if device is not None else None
    root = torch.nn.Module()
    graph = fx.Graph()
    env: Dict[str, fx.Node] = {}
    specs: List[Tuple[List[int], torch.dtype]] = []
    for nd in header["nodes"]:
        op = nd.get("op")
        if op == "placeholder":
            node = graph.placeholder(nd["name"])
            specs.append((nd["shape"], protocol.torch_dtype(nd["dtype"])))
        elif op == "get_attr":
            const = protocol.decode_literal(nd["literal"],
                                            blobs[int(nd["blob"])]).clone()
            if device is not None:
                const = const.to(device)
            attr = nd["target"]
            if (not isinstance(attr, str) or not attr.isidentifier()
                    or attr.startswith("__") or hasattr(root, attr)):
                raise SerdeError(f"constant name {attr!r} is not a fresh "
                                 "attribute name")
            root.register_buffer(attr, const)
            node = graph.create_node("get_attr", attr, name=nd["name"])
        elif op == "call_function":
            target = resolve_target(nd["target"])
            node = graph.create_node(
                "call_function", target,
                tuple(_dec(nd["args"], env, device)),
                {k: _dec(v, env, device) for k, v in nd["kwargs"].items()},
                name=nd["name"])
        elif op == "output":
            (out,) = _dec(nd["args"], env, device)
            graph.output(out)
            continue
        else:
            raise SerdeError(f"unknown node kind {op!r}")
        env[nd["name"]] = node
    gm = fx.GraphModule(root, graph)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fakes = [torch.empty(shape, dtype=dtype, device=device or "cpu")
                 for shape, dtype in specs]
    FakeTensorProp(gm, mode).propagate_dont_convert_inputs(*fakes)
    return gm


def deserialize_graph(data, device=None) -> fx.GraphModule:
    """``decode_graph`` of envelope bytes (or ``protocol.Frames``)."""
    header, blobs = protocol.unpack(data)
    return decode_graph(header, blobs, device=device)
