"""Chunk-scale quantization for comm-efficient collectives and the wire:
the port of ``tepdist_tpu/parallel/quantize.py`` (the numpy codec copied
as it is).

Two symmetric halves of the same scheme (EQuARX, arXiv:2506.17615: block
scaling keeps quantized AllReduce quality loss negligible):

* Tensor side (:func:`fake_quant_int8`) — quantize->dequantize of
  gradient contributions inside the accumulation step, with STOCHASTIC
  rounding so the quantization error is zero-mean across steps and the
  training loss stays inside a gated band of the fidelity trajectory.
  The rounding noise comes from a ``torch.Generator`` (the reference folds
  a threefry key; those values cannot be matched, the properties can).
* NumPy side (:func:`quantize_np_int8` / :func:`dequantize_np_int8`) —
  deterministic round-to-nearest for the RPC wire (host_push activation
  payloads, cross-worker SEND/RECV), where byte-exact ledger accounting
  matters and stochasticity would make retransmits unverifiable.

Both use per-chunk max-abs scales over flattened CHUNK-element blocks:
scale = maxabs/127 per chunk, q = clip(round(x/scale), -127, 127). A
zero chunk gets scale 0 and dequantizes to exact zeros.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tepdist_tpu_torch.core.tree import tree_leaves, tree_unflatten

# Elements per scale block. 256 keeps the scale overhead at 4/256 bytes
# per element (1.6% of the f32 payload) while bounding each block's
# dynamic range tightly enough that outliers cannot wash out a layer.
CHUNK = 256


def _pad_len(n: int, chunk: int) -> int:
    return (chunk - n % chunk) % chunk


# ----------------------------------------------------------------------
# Tensor side: fake-quant with stochastic rounding
# ----------------------------------------------------------------------

def fake_quant_int8(x: torch.Tensor, generator: torch.Generator,
                    chunk: int = CHUNK) -> torch.Tensor:
    """Quantize->dequantize ``x`` (a float tensor) through int8 chunk
    scales with stochastic rounding drawn from ``generator`` (on ``x``'s
    device). Shape- and dtype-preserving; the identity for empty tensors.

    Stochastic rounding: q = floor(x/scale + u), u ~ U[0,1). E[q*scale]
    = x, so the per-step quantization error is unbiased — the property
    the loss-trajectory band test gates on.
    """
    if x.numel() == 0:
        return x
    flat = x.reshape(-1).to(torch.float32)
    pad = _pad_len(flat.numel(), chunk)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, chunk)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    u = torch.rand(blocks.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    q = torch.clamp(torch.floor(blocks / safe + u), -127.0, 127.0)
    deq = torch.where(scale > 0, q * safe, torch.zeros_like(q))
    out = deq.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def fake_quant_grads(grads, generator: torch.Generator,
                     chunk: int = CHUNK):
    """Apply :func:`fake_quant_int8` to every floating leaf of a grad
    tree. The leaves draw from the one generator in flat order, so no two
    tensors share a rounding pattern."""
    leaves = tree_leaves(grads)
    out = [fake_quant_int8(leaf, generator, chunk)
           if leaf.is_floating_point() else leaf for leaf in leaves]
    return tree_unflatten(grads, out)


# ----------------------------------------------------------------------
# NumPy side: deterministic wire codec
# ----------------------------------------------------------------------

def quantize_np_int8(arr: np.ndarray,
                     chunk: int = CHUNK) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (round-half-to-even) int8 chunk quantization of a
    float array. Returns ``(q, scales)``: ``q`` int8 of ``arr.size``
    elements, ``scales`` float32 of ``ceil(size/chunk)`` entries."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    pad = _pad_len(flat.size, chunk)
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), np.float32)])
    blocks = flat.reshape(-1, chunk)
    scales = (np.max(np.abs(blocks), axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)[:, None]
    q = np.clip(np.rint(blocks / safe), -127, 127).astype(np.int8)
    q = q.reshape(-1)
    if pad:
        q = q[:-pad]
    return q, scales


def dequantize_np_int8(q: np.ndarray, scales: np.ndarray, shape,
                       dtype=np.float32,
                       chunk: int = CHUNK) -> np.ndarray:
    """Inverse of :func:`quantize_np_int8` (up to the rounding step)."""
    flat = np.ascontiguousarray(q, dtype=np.int8).reshape(-1)
    pad = _pad_len(flat.size, chunk)
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), np.int8)])
    blocks = flat.astype(np.float32).reshape(-1, chunk)
    deq = (blocks * np.asarray(scales, np.float32)[:, None]).reshape(-1)
    if pad:
        deq = deq[:-pad]
    return deq.reshape(shape).astype(dtype, copy=False)
