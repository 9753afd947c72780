"""Transport over the ranks of one group: the port's ``lax.ppermute`` (a
neighbour shift around a ring), ``lax.all_to_all`` (tiled, between the
sequence and head dims), and the collectives a pipeline stage spread over
replicas needs: ``psum`` (all-reduce), ``psum_scatter`` (reduce-scatter)
and ``all_gather`` of flat vectors.

The reference runs ring and Ulysses attention under ``shard_map``, where
each device sees its own block of the sequence. The port runs the same
bodies over the ranks of one ``seq`` dimension that this process holds,
as a list with one shard per held rank, so a body is written once for
two forms of transport:

* :class:`GroupTransport`, the process-group form: this process holds one
  rank of a ``torch.distributed`` group (the ``seq`` dimension of a
  ``DeviceMesh``); a shift is one ``batch_isend_irecv`` round to the next
  rank, an all-to-all one ``all_to_all_single`` (gloo on the CPU, NCCL on
  cards). The DTensor lowering uses it.
* :class:`DeviceTransport`, the one-process form: this process holds all
  P ranks, shard ``i`` on entry ``i`` of a device list, which may repeat
  (``["cpu"] * 4``, ``[cuda:0] * 4``, as the pipeline executor takes its
  stage devices); a shift rotates the list and moves each shard to its
  next device. It is the counterpart of the reference's ``shard_map`` over
  a mesh of one process's devices.

:func:`shift` and :func:`all_to_all` are differentiable: the shift's
backward is the reverse shift (the transpose of ``ppermute``), the
all-to-all's is the all-to-all with the split and concat dims swapped.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

Shards = List[torch.Tensor]


class Transport:
    """The ranks of one ring that this process holds: ``size`` ranks in
    all, this process's at positions ``ranks`` (one entry per shard)."""

    size: int
    ranks: List[int]

    def shift_raw(self, tensors: Sequence[Shards], offset: int = 1
                  ) -> List[Shards]:
        """Each logical tensor of ``tensors`` (a list of shards, one per
        held rank) moved ``offset`` ranks on: rank r receives rank
        r - offset's shard."""
        raise NotImplementedError

    def all_to_all_raw(self, shards: Shards, split_dim: int,
                       concat_dim: int) -> Shards:
        """Tiled all-to-all: each rank's shard cut in ``size`` pieces along
        ``split_dim``; rank i gathers every rank's piece i along
        ``concat_dim``, in rank order."""
        raise NotImplementedError

    def all_reduce_raw(self, shards: Shards) -> Shards:
        """Every rank's tensor replaced by the sum over the ranks."""
        raise NotImplementedError

    def reduce_scatter_raw(self, shards: Shards) -> Shards:
        """Tiled reduce-scatter of 1-D tensors of ``size * chunk``
        elements: rank i receives piece i of the sum over the ranks."""
        raise NotImplementedError

    def all_gather_raw(self, shards: Shards) -> Shards:
        """Tiled all-gather of 1-D tensors: every rank receives the
        concatenation of every rank's tensor, in rank order."""
        raise NotImplementedError

    def split(self, x: torch.Tensor, dim: int) -> Shards:
        """The shards this process holds of ``x`` along ``dim``, each
        contiguous: for a group, ``x`` is already this rank's shard."""
        raise NotImplementedError

    def join(self, shards: Shards, dim: int) -> torch.Tensor:
        """The inverse of :meth:`split`."""
        raise NotImplementedError


class DeviceTransport(Transport):
    """The one-process form: all ranks, shard i on ``devices[i]``."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a ring needs at least one device")
        self.size = len(self.devices)
        self.ranks = list(range(self.size))

    def shift_raw(self, tensors, offset=1):
        P = self.size
        return [[xs[(i - offset) % P].to(self.devices[i]) for i in range(P)]
                for xs in tensors]

    def all_to_all_raw(self, shards, split_dim, concat_dim):
        P = self.size
        pieces = [x.chunk(P, split_dim) for x in shards]
        return [torch.cat([pieces[j][i].to(self.devices[i])
                           for j in range(P)], concat_dim)
                for i in range(P)]

    def _total(self, shards):
        # Summed in rank order on the first rank's device.
        home = self.devices[0]
        total = shards[0].to(home, copy=True)
        for x in shards[1:]:
            total.add_(x.to(home))
        return total

    def all_reduce_raw(self, shards):
        total = self._total(shards)
        return [total.to(d, copy=True) for d in self.devices]

    def reduce_scatter_raw(self, shards):
        pieces = self._total(shards).chunk(self.size)
        return [p.to(d, copy=True) for p, d in zip(pieces, self.devices)]

    def all_gather_raw(self, shards):
        home = self.devices[0]
        full = torch.cat([x.to(home) for x in shards])
        return [full.to(d, copy=True) for d in self.devices]

    def split(self, x, dim):
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks")
        return [c.to(d).contiguous()
                for c, d in zip(x.chunk(self.size, dim), self.devices)]

    def join(self, shards, dim):
        home = shards[0].device
        return torch.cat([s.to(home) for s in shards], dim)


class GroupTransport(Transport):
    """The process-group form: this process is one rank of ``group``."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = [self.rank]
        self._global = [dist.get_global_rank(group, r)
                        for r in range(self.size)]

    def shift_raw(self, tensors, offset=1):
        import torch.distributed as dist

        if self.size == 1:
            return [list(xs) for xs in tensors]
        dst = self._global[(self.rank + offset) % self.size]
        src = self._global[(self.rank - offset) % self.size]
        sends = [xs[0].contiguous() for xs in tensors]
        outs = [torch.empty_like(x) for x in sends]
        ops = [dist.P2POp(dist.isend, x, dst, self.group) for x in sends]
        ops += [dist.P2POp(dist.irecv, y, src, self.group) for y in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [[y] for y in outs]

    def all_to_all_raw(self, shards, split_dim, concat_dim):
        import torch.distributed as dist

        x = shards[0]
        if self.size == 1:
            return [x]
        send = torch.stack(x.chunk(self.size, split_dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return [torch.cat(recv.unbind(0), concat_dim)]

    def all_reduce_raw(self, shards):
        import torch.distributed as dist

        x = shards[0].contiguous()
        if self.size > 1:
            dist.all_reduce(x, group=self.group)
        return [x]

    def reduce_scatter_raw(self, shards):
        import torch.distributed as dist

        x = shards[0].contiguous()
        if self.size == 1:
            return [x]
        out = x.new_empty(x.numel() // self.size)
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return [out]

    def all_gather_raw(self, shards):
        import torch.distributed as dist

        x = shards[0].contiguous()
        if self.size == 1:
            return [x]
        out = x.new_empty(x.numel() * self.size)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return [out]

    def split(self, x, dim):
        return [x.contiguous()]

    def join(self, shards, dim):
        return shards[0]


def transport_for(ring) -> Transport:
    """A transport from what a caller names as the ring: a transport, a
    device list (the one-process form) or a process group."""
    if isinstance(ring, Transport):
        return ring
    if isinstance(ring, (list, tuple)):
        return DeviceTransport(ring)
    return GroupTransport(ring)


class _Shift(torch.autograd.Function):
    """Differentiable shift of ``n`` logical tensors, ``k`` shards each,
    flattened: the backward shifts the cotangents back."""

    @staticmethod
    def forward(ctx, transport, offset, n, *flat):
        ctx.transport, ctx.offset, ctx.n = transport, offset, n
        k = len(flat) // n
        groups = [list(flat[i * k:(i + 1) * k]) for i in range(n)]
        out = transport.shift_raw(groups, offset)
        return tuple(y for ys in out for y in ys)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        k = len(grads) // n
        groups = [list(grads[i * k:(i + 1) * k]) for i in range(n)]
        back = ctx.transport.shift_raw(groups, -ctx.offset)
        return (None, None, None, *(g for gs in back for g in gs))


def shift(transport: Transport, tensors: Sequence[Shards],
          offset: int = 1) -> List[Shards]:
    """The differentiable neighbour shift (``lax.ppermute`` with the perm
    ``i -> i + offset``) of several logical tensors in one round."""
    n = len(tensors)
    k = len(tensors[0])
    flat = _Shift.apply(transport, offset, n,
                        *(x for xs in tensors for x in xs))
    return [list(flat[i * k:(i + 1) * k]) for i in range(n)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, transport, split_dim, concat_dim, *shards):
        ctx.transport = transport
        ctx.dims = (split_dim, concat_dim)
        return tuple(transport.all_to_all_raw(list(shards), split_dim,
                                              concat_dim))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        back = ctx.transport.all_to_all_raw(list(grads), concat_dim,
                                            split_dim)
        return (None, None, None, *back)


def all_to_all(transport: Transport, shards: Shards, split_dim: int,
               concat_dim: int) -> Shards:
    """The differentiable tiled all-to-all (``lax.all_to_all(...,
    tiled=True)``)."""
    return list(_AllToAll.apply(transport, split_dim, concat_dim, *shards))
