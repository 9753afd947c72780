"""DistributedBuffer: the device-count-wide distributed tensor handle (the
port of the JAX package's ``runtime/dist_buffer.py``).

Reference parity: ``DAPPLEBuffer`` (reference: pjrt/dapple_buffer.{h,cc} +
dapple_buffer_utils): host raw value + per-device shards, placeholder
creation (shape-only until materialized), host/device state flags, and
H2D/D2H slice transfer.

Here the device value is a torch tensor on one device, or a DTensor whose
local shards are the per-device collection (``placements`` over a
``DeviceMesh``); the host value is a numpy array, as in the JAX package,
so the two hold the same bytes."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from tepdist_tpu_torch.convert import to_numpy, to_torch


class DistributedBuffer:
    def __init__(self, shape: Tuple[int, ...], dtype,
                 sharding=None, global_idx: int = -1,
                 is_variable: bool = False):
        """``sharding``: where the device value lives: a device, or a
        ``(DeviceMesh, placements)`` pair for a DTensor."""
        self.shape = tuple(shape)
        self.dtype = (dtype if isinstance(dtype, torch.dtype)
                      or hasattr(dtype, "name") else np.dtype(dtype))
        self.sharding = sharding
        self.global_idx = global_idx
        self.is_variable = is_variable
        self._host: Optional[np.ndarray] = None
        self._device: Optional[torch.Tensor] = None

    # -- creation -------------------------------------------------------
    @classmethod
    def placeholder(cls, shape, dtype, sharding=None, global_idx=-1,
                    is_variable=False) -> "DistributedBuffer":
        """Shape-only buffer (reference placeholder creation): materialized
        later by server-side init or a transfer."""
        return cls(shape, dtype, sharding, global_idx, is_variable)

    @classmethod
    def from_host(cls, value, sharding=None, global_idx=-1,
                  is_variable=False) -> "DistributedBuffer":
        arr = np.asarray(value)
        buf = cls(arr.shape, arr.dtype, sharding, global_idx, is_variable)
        buf._host = arr
        return buf

    @classmethod
    def from_device(cls, value: torch.Tensor, global_idx=-1,
                    is_variable=False) -> "DistributedBuffer":
        sharding = ((value.device_mesh, tuple(value.placements))
                    if hasattr(value, "device_mesh") else value.device)
        buf = cls(tuple(value.shape), value.dtype, sharding, global_idx,
                  is_variable)
        buf._device = value
        return buf

    # -- state flags ------------------------------------------------------
    @property
    def on_host(self) -> bool:
        return self._host is not None

    @property
    def on_device(self) -> bool:
        return self._device is not None

    @property
    def is_placeholder(self) -> bool:
        return self._host is None and self._device is None

    # -- movement ---------------------------------------------------------
    def device_value(self) -> torch.Tensor:
        if self._device is None:
            if self._host is None:
                raise ValueError("placeholder buffer not materialized")
            t = to_torch(self._host, device="cpu")
            if isinstance(self.sharding, tuple):
                from torch.distributed.tensor import distribute_tensor
                mesh, placements = self.sharding
                t = distribute_tensor(t.to(mesh.device_type), mesh,
                                      list(placements))
            elif self.sharding is not None:
                t = t.to(self.sharding)
            self._device = t
        return self._device

    def host_value(self) -> np.ndarray:
        if self._host is None:
            if self._device is None:
                raise ValueError("placeholder buffer not materialized")
            val: Any = self._device
            if hasattr(val, "full_tensor"):
                val = val.full_tensor()
            self._host = to_numpy(val)
        return self._host

    def update_device(self, value: torch.Tensor) -> None:
        self._device = value
        self._host = None  # stale

    def addressable_shards(self):
        """This process's shards: a DTensor's local tensor, or the whole
        value on its one device."""
        val = self.device_value()
        return [val.to_local() if hasattr(val, "to_local") else val]

    def __repr__(self):
        state = ("placeholder" if self.is_placeholder else
                 "+".join(s for s, ok in
                          (("host", self.on_host), ("device", self.on_device))
                          if ok))
        return (f"DistributedBuffer(shape={self.shape}, "
                f"dtype={self.dtype}, {state}, var={self.is_variable})")
