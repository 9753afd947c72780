"""Sharded deterministic initialization.

Reference parity: ``dist_rng::functor::FillShardPhiloxRandom`` (reference:
pjrt/initializers.{h,cc}, 685 LoC + fill_philox_random.h): per-slice Philox
skip-ahead so each device fills exactly its slice of a variable without
materializing the full tensor, with slice-for-slice equality to the
full-tensor fill (initializers_test.cc asserts this).

The port of ``tepdist_tpu/runtime/initializers.py``. The JAX package gets
that property from threefry's value semantics under a sharded jit. The
port makes it explicit: every element's random bits are a counter-based
hash (splitmix64) of the seed and the element's flat index in the FULL
tensor, so a rank that fills only its slice computes the same values the
full fill holds there, on any device and for any placements. Its values
are not JAX's (threefry cannot be matched); the property is the point.
``init_from_spec`` applies the standard initializer specs the server
uses when clients register shape-only variables (reference
init_specs_map, hlo.proto:426-430).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from tepdist_tpu_torch.core.device import resolve_device


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)


def _lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _bits(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """splitmix64 of (seed, counter): 64 well-mixed bits per element
    (int64 arithmetic wraps as uint64 does)."""
    z = counter * _GOLDEN + _s64((seed * 0xD1B54A32D192ED03) % (1 << 64))
    z = z + _GOLDEN
    z = (z ^ _lsr(z, 30)) * _M1
    z = (z ^ _lsr(z, 27)) * _M2
    return z ^ _lsr(z, 31)


def _uniform(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """fp32 uniform in (0, 1] from the top 24 bits of the hash."""
    top = _lsr(_bits(seed, counter), 40)
    return (top.to(torch.float32) + 1.0) * (1.0 / (1 << 24))


def _fill(seed: int, index: torch.Tensor, distribution: str,
          scale: float, mean: float) -> torch.Tensor:
    """Values at flat full-tensor indices ``index`` (int64)."""
    if distribution == "zeros":
        return torch.zeros(index.shape, device=index.device)
    if distribution == "ones":
        return torch.ones(index.shape, device=index.device)
    u = _uniform(seed, 2 * index)
    if distribution == "uniform":
        return (mean - scale) + (2.0 * scale) * (u - 2.0 ** -25)
    if distribution == "normal":
        # Box-Muller on two streams of the same counter.
        u2 = _uniform(seed, 2 * index + 1)
        z = torch.sqrt(-2.0 * torch.log(u)) * torch.cos(2.0 * math.pi * u2)
        return z * scale + mean
    if distribution == "truncated_normal":
        # Inverse CDF of the normal restricted to [-2, 2].
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        p = lo + (1.0 - 2.0 * lo) * (u - 2.0 ** -25)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
        return z.clamp(-2.0, 2.0) * scale + mean
    raise ValueError(f"unknown distribution {distribution!r}")


def _flat_index(shape: Sequence[int], offset: Sequence[int],
                local: Sequence[int], device) -> torch.Tensor:
    """Flat indices into the full ``shape`` of the block at ``offset`` of
    extent ``local``."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        ar = torch.arange(offset[d], offset[d] + local[d],
                          dtype=torch.int64, device=device)
        view = [1] * len(shape)
        view[d] = local[d]
        idx = idx + ar.reshape(view) * stride
        stride *= shape[d]
    return idx.expand(tuple(local)) if shape else idx


def shard_consistent_init(
    seed: int,
    shape: Tuple[int, ...],
    dtype=torch.float32,
    mesh=None,
    placements: Optional[Sequence[Any]] = None,
    distribution: str = "normal",
    scale: float = 1.0,
    mean: float = 0.0,
    device="cuda",
):
    """Fill a (possibly sharded) tensor deterministically. Without a
    ``mesh`` the full tensor comes back; with ``mesh`` and DTensor
    ``placements`` each rank materializes only its shard and a DTensor
    comes back. The values do not depend on the placements."""
    shape = tuple(int(s) for s in shape)
    if mesh is None:
        dev = resolve_device(device)
        local, offset = shape, (0,) * len(shape)
    else:
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        dev = torch.device(mesh.device_type)
        local, offset = compute_local_shape_and_global_offset(
            shape, mesh, list(placements))
    index = _flat_index(shape, offset, local, dev)
    block = _fill(seed, index, distribution, scale, mean).to(dtype)
    if mesh is None:
        return block
    return DTensor.from_local(block.contiguous(), mesh, list(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    stride, out = 1, []
    for s in reversed(shape):
        out.append(stride)
        stride *= s
    return tuple(reversed(out))


# Initializer specs (reference init_specs_map): the server creates variables
# from these when the client registers shape-only (weights never leave the
# server).

def init_from_spec(seed: int, spec: Dict[str, Any], mesh=None,
                   placements=None, device="cuda"):
    """spec: {shape, dtype, distribution, scale, mean, fan_in_scaling?}."""
    shape = tuple(spec["shape"])
    dtype = getattr(torch, spec.get("dtype", "float32"))
    dist = spec.get("distribution", "normal")
    scale = float(spec.get("scale", 1.0))
    if spec.get("fan_in_scaling"):
        fan_in = math.prod(shape[:-1]) or 1
        scale = scale / math.sqrt(fan_in)
    return shard_consistent_init(
        seed, shape, dtype, mesh, placements, distribution=dist,
        scale=scale, mean=float(spec.get("mean", 0.0)), device=device)
