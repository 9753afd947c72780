"""Ulysses (DeepSpeed-style) sequence parallelism by head <-> sequence
all-to-all. The port of ``tepdist_tpu/ops/ulysses.py``.

With the sequence split over P ranks and H heads, an all-to-all re-splits
[B, H, T/P, D] -> [B, H/P, T, D]; attention then runs over the WHOLE
sequence on H/P heads, and a second all-to-all restores the sequence
split. H must divide by P. The all-to-all is ``ops/seq_comm.py``'s, in the
process-group form (one rank's block) or the one-process form (a device
list), as for the ring.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from tepdist_tpu_torch.ops import seq_comm
from tepdist_tpu_torch.ops.flash_attention import (flash_attention_with_lse,
                                                   flash_dkv, flash_dq,
                                                   flash_fwd)
from tepdist_tpu_torch.ops.seq_comm import Transport, transport_for


def _to_heads(transport, xs, a2a=seq_comm.all_to_all):
    """[B, H, T/P, D] blocks -> [B, H/P, T, D]: split heads, gather T."""
    return a2a(transport, xs, 1, 2)


def _to_seq(transport, xs, a2a=seq_comm.all_to_all):
    """[B, H/P, T, D] -> [B, H, T/P, D]."""
    return a2a(transport, xs, 2, 1)


def ulysses_local(qs, ks, vs, transport: Transport, causal: bool,
                  scale: Optional[float], inner: Optional[Callable],
                  return_lse: bool = False):
    """The per-rank body over the held [B, H, T/P, D] blocks,
    differentiable by autograd. ``inner(q, k, v)`` on [B, H/P, T, D]
    returns the output, or (output, LSE) with ``return_lse``; None is the
    dense reference (with its LSE)."""
    from tepdist_tpu_torch.ops.ring_attention import (reference_attention,
                                                      reference_attention_lse)

    qh, kh, vh = (_to_heads(transport, x) for x in (qs, ks, vs))
    if inner is None:
        inner = functools.partial(
            reference_attention_lse if return_lse else reference_attention,
            causal=causal, scale=scale)
    res = [inner(a, b, c) for a, b, c in zip(qh, kh, vh)]
    if not return_lse:
        return _to_seq(transport, res)
    oh = [o for o, _ in res]
    # The LSE crosses with the same head <-> seq all-to-all, with one
    # trailing singleton dim to match the 4-d transpose.
    lse = _to_seq(transport, [lse[..., None] for _, lse in res])
    return _to_seq(transport, oh), [x[..., 0] for x in lse]


def _raw(transport, xs, split_dim, concat_dim):
    return transport.all_to_all_raw(xs, split_dim, concat_dim)


def ulysses_forward(qs, ks, vs, transport: Transport, causal: bool,
                    scale: float, inner: str):
    """(outputs, LSEs) of the sequence op's Ulysses path (no autograd):
    ``inner`` "flash" launches the flash forward once per held rank on
    [B * H/P, T, D]; "einsum" runs the dense reference."""
    if inner != "flash":
        with torch.no_grad():
            return ulysses_local(qs, ks, vs, transport, causal, scale, None,
                                 return_lse=True)
    qh, kh, vh = (_to_heads(transport, x, _raw) for x in (qs, ks, vs))
    oh, lseh = [], []
    for a, b, c in zip(qh, kh, vh):
        B, Hp, T, D = a.shape
        o, lse = flash_fwd(*(x.reshape(B * Hp, T, D) for x in (a, b, c)),
                           causal, scale)
        oh.append(o.reshape(B, Hp, T, D))
        lseh.append(lse.reshape(B, Hp, T, 1))
    lses = _to_seq(transport, lseh, _raw)
    return _to_seq(transport, oh, _raw), [x[..., 0] for x in lses]


def ulysses_flash_backward(qs, ks, vs, os, lses, dos, dlses,
                           transport: Transport, causal: bool, scale: float):
    """(dQ, dK, dV) blocks of the flash Ulysses path: q, k, v, O, dO, the
    LSE and its cotangent go to heads (O and the LSE there equal what the
    forward computed), the dQ and dK/dV kernels run on the whole sequence,
    and the gradients come back to the sequence split."""
    def heads(xs):
        return _to_heads(transport, xs, _raw)

    def heads_rows(xs):
        return [x[..., 0] for x in heads([r[..., None] for r in xs])]

    qh, kh, vh, oh, doh = (heads(x) for x in (qs, ks, vs, os, dos))
    lseh = heads_rows(lses)
    dlseh = None if dlses is None else heads_rows(dlses)
    dq, dk, dv = [], [], []
    for i, q in enumerate(qh):
        B, Hp, T, D = q.shape
        flat = [x.reshape(B * Hp, T, D).contiguous()
                for x in (q, kh[i], vh[i], doh[i])]
        delta = (flat[3].float() * oh[i].reshape(B * Hp, T, D).float()
                 ).sum(-1)
        if dlseh is not None:
            delta = delta - dlseh[i].reshape(B * Hp, T).float()
        args = (*flat, lseh[i].reshape(B * Hp, T).contiguous(),
                delta.contiguous(), causal, scale)
        dq.append(flash_dq(*args).reshape(B, Hp, T, D))
        dk_, dv_ = flash_dkv(*args)
        dk.append(dk_.reshape(B, Hp, T, D))
        dv.append(dv_.reshape(B, Hp, T, D))
    return tuple(_to_seq(transport, g, _raw) for g in (dq, dk, dv))


def ulysses_attention(q, k, v, ring, axis_name: str = "seq",
                      causal: bool = True, scale: Optional[float] = None,
                      inner: Optional[Callable] = None,
                      return_lse: bool = False):
    """Sequence-parallel attention by double all-to-all. q, k, v:
    [B, H, T, D] over ``ring`` (a device list, whole tensors; a
    ``DeviceMesh`` with ``axis_name``, or a process group, this rank's
    block: as :func:`~tepdist_tpu_torch.ops.ring_attention.ring_attention`).
    H must divide by the ring's size. ``inner`` optionally overrides the
    local attention on [B, H/P, T, D] (e.g. the flash kernels).
    ``return_lse``: also return the [B, H, T] log-sum-exp; ``inner`` must
    then return (o, lse) (default: the flash kernels,
    ``flash_attention_with_lse``). Differentiable."""
    if hasattr(ring, "get_group"):
        ring = ring.get_group(axis_name)
    transport = transport_for(ring)
    H = q.shape[1]
    size = transport.size
    if H % size != 0:
        raise ValueError(f"heads {H} not divisible by axis {axis_name}="
                         f"{size}")
    if return_lse and inner is None:
        inner = functools.partial(flash_attention_with_lse, causal=causal,
                                  scale=scale)
    if scale is None and inner is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    blocks = [transport.split(x, 2) for x in (q, k, v)]
    res = ulysses_local(*blocks, transport, causal, scale, inner,
                        return_lse=return_lse)
    if return_lse:
        outs, lses = res
        return transport.join(outs, 2), transport.join(lses, 2)
    return transport.join(res, 2)
