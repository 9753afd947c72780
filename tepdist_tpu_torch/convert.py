"""Weight bridge between the JAX package and the port, through numpy.

:func:`to_torch` turns a tree of numpy arrays (JAX params after
``np.asarray``) into the port's tree of tensors; :func:`to_numpy` goes
back. Trees keep their structure, so both GPT-2 layouts cross unchanged:
unrolled ``h{i}`` block dicts and stacked ``blocks`` of [L, ...] leaves.
bf16 crosses as its uint16 bits, as the JAX package's checkpoints store it,
so the round trip is bit-exact. Neither direction imports jax. Tensors
go to the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.tree import tree_map


def _bf16_numpy_dtype():
    """numpy's bfloat16 (from ml_dtypes, which jax brings) if present."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def array_to_tensor(a, device="cuda") -> torch.Tensor:
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``. bf16 comes back as numpy bfloat16 where
    ml_dtypes is installed (it is wherever jax is), else as its uint16
    bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    bits = t.view(torch.int16).numpy().view(np.uint16).copy()
    bf16 = _bf16_numpy_dtype()
    return bits if bf16 is None else bits.view(bf16)


def to_torch(tree, device="cuda"):
    """Tree of numpy arrays -> tree of tensors on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: array_to_tensor(a, device), tree)


def to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays (see ``tensor_to_array``)."""
    return tree_map(tensor_to_array, tree)
