"""Collective pipeline parallelism: the whole pipeline in ONE program, the
port of ``tepdist_tpu/ops/collective_pipeline.py``.

The reference keeps every stage, micro-batch rotation and inter-stage
transfer inside one jitted ``shard_map`` program: stages live on a
``stage`` mesh axis, activations hop stage -> stage by ``lax.ppermute``,
and the schedule is a ``lax.scan`` over S + M - 1 ticks (the GPipe
wavefront). The port runs the same body over the stages this process
holds, in the two forms of ``ops/seq_comm``:

* the device form: ``mesh`` is a list of S devices (one a stage, which may
  repeat: ``["cpu"] * 4``, ``[cuda:0] * 4``), or S lists of D devices for
  a ``data_axis`` (the reference's ``np.array(devices).reshape(S, D)``);
  the process holds every stage, a hop is a ``.to()``, and the final
  ``psum`` of the masked outputs is a sum (the last stage's buffer moved to
  the first device);
* the group form: ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` with a
  dimension named ``axis`` (and ``data_axis`` / ``model_axis``); this rank
  holds one stage (its coordinate on ``axis``), a hop is one
  ``batch_isend_irecv`` round, and the final ``psum`` is an all-reduce
  whose backward passes the cotangent through (every rank computes the
  same loss from the replicated outputs, as under ``shard_map``'s
  replicated ``out_specs``).

The ticks are a Python loop over S + M - 1; the hop is ``seq_comm.shift``,
differentiable (its backward is the reverse shift), so autograd runs the
reverse pipeline. A stage skips the ticks where it would hold no micro
batch (the reference computes them on zeros and drops the result).
``model_axis`` (group form only) runs each stage function on DTensors over
the model dimension: the stacked params carry the placements
``models.gpt2.shard_stacked_for_stages`` gives them (``spec_for``), and the
activations hop as replicated local values.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
from tepdist_tpu_torch.ops.seq_comm import (DeviceTransport, GroupTransport,
                                            Transport, shift)


class _SumReplicated(torch.autograd.Function):
    """The final ``psum`` over a group: the forward sums, the backward
    passes the (replicated) cotangent through."""

    @staticmethod
    def forward(ctx, group, x):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ReplicatedIn(torch.autograd.Function):
    """A value replicated over a group (params over ``data_axis``): the
    forward passes it through, the backward sums the ranks' cotangents
    (the transpose of the replication)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


class _GatherRows(torch.autograd.Function):
    """The outputs' rows gathered over a group along ``dim`` (every rank
    then computes the same loss): the backward keeps this rank's rows."""

    @staticmethod
    def forward(ctx, group, dim, x):
        import torch.distributed as dist

        n = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.rows = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, g.narrow(ctx.dim, ctx.rank * ctx.rows, ctx.rows)


def _pipeline_local(stage_params: Sequence[Any],
                    x_micro: Sequence[torch.Tensor], *, stage_fn: Callable,
                    transport: Transport, num_stages: int, num_micro: int,
                    wrap: Optional[Callable] = None,
                    unwrap: Optional[Callable] = None,
                    chained: bool = False) -> List[torch.Tensor]:
    """The GPipe wavefront over the stages ``transport`` holds here.

    ``stage_params[k]`` and ``x_micro[k]`` (``[M, mb, ...]``) belong to
    held rank ``transport.ranks[k]``, on that rank's device. Returns, per
    held rank, its masked ``[M, mb, ...]`` buffer: the outputs on the last
    stage, zeros elsewhere. ``wrap`` / ``unwrap`` turn a hopped value into
    a stage function's input and back (DTensors over a model dimension).

    A stage computes only the ticks that hold a micro batch and passes
    its state on in the others (the reference computes those on zeros and
    drops them). ``chained`` (the group form, one autograd graph a rank):
    every rank's values form one chain through every hop: stage 0 reads
    its state with weight 0 beside the fed micro batch (the reference's
    select), the other stages the fed batch with weight 0, and a non-last
    stage's zero buffer takes its last value with weight 0. Autograd then
    runs each hop's reverse shift, and the input's replication, on every
    rank in one order, as the transpose of the reference's single program
    does. In the device form one graph spans every stage, and the plain
    wavefront suffices."""
    S, M = num_stages, num_micro
    ranks = transport.ranks
    # Chained, the first state takes part in autograd wherever it is on,
    # so every rank records every hop (a hop of values that need no
    # gradient would leave no node to run backward on that rank alone).
    state = [torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device
                         ).requires_grad_(chained and torch.is_grad_enabled())
             for x in x_micro]
    outs: List[List[torch.Tensor]] = [[] for _ in ranks]
    ys: List[torch.Tensor] = state
    for t in range(S + M - 1):
        ys = []
        for k, r in enumerate(ranks):
            m = t - r                 # the micro batch at stage r now
            if not 0 <= m < M:
                ys.append(state[k])
                continue
            feed = x_micro[k][m]
            inp = feed if r == 0 else state[k]
            if chained:
                inp = inp + 0 * (state[k] if r == 0 else feed)
            if wrap is not None:
                inp = wrap(inp)
            y = stage_fn(stage_params[k], inp)
            if unwrap is not None:
                y = unwrap(y)
            if r == S - 1:
                outs[k].append(y)
            ys.append(y)
        if t < S + M - 2:
            state = shift(transport, [ys], 1)[0]
    return [torch.stack(o) if r == S - 1
            else torch.zeros_like(x) + 0 * y if chained
            else torch.zeros_like(x)
            for o, r, x, y in zip(outs, ranks, x_micro, ys)]


def _group_coord(mesh, name: Optional[str]):
    """(size, my index, process group) of a named mesh dimension."""
    if name is None:
        return 1, 0, None
    group = mesh.get_group(name)
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group), group


def collective_pipeline(
    stage_fn: Callable,
    mesh,
    axis: str = "stage",
    data_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
) -> Callable:
    """Build ``pipelined(stacked_params, x_micro) -> y_micro``.

    ``stacked_params``: a tree whose leaves have a leading stage dim of
    size S. ``x_micro``: ``[M, mb, ...]``, the same whole value in every
    process. ``stage_fn(params_slice, x) -> y`` with ``y.shape ==
    x.shape``. The result is the whole ``[M, mb, ...]`` output, on the
    first device (device form) or on every rank (group form).

    ``data_axis``: PP x DP: the micro-batch rows (dim 1 of ``x_micro``)
    split over it, params replicate over it (their gradients are summed
    over it), and activations hop within each data slice.

    ``model_axis`` (group form): PP x TP: each stage function runs on
    DTensors over that mesh dimension; pass the stacked leaves as DTensors
    of the whole mesh (``gpt2.shard_stacked_for_stages(...,
    model_axis=...)``), whose placement on ``model_axis`` each stage
    keeps."""
    if isinstance(mesh, (list, tuple)):
        if model_axis is not None:
            raise ValueError(
                "model_axis: tensor parallelism needs one rank a device (a "
                "DeviceMesh over a process group), not a device list")
        return _device_pipeline(stage_fn, mesh, data_axis is not None)
    return _group_pipeline(stage_fn, mesh, axis, data_axis, model_axis)


def _device_pipeline(stage_fn: Callable, mesh, with_data: bool) -> Callable:
    grid = ([list(row) for row in mesh] if with_data
            else [[d] for d in mesh])
    S, D = len(grid), len(grid[0])
    grid = [[torch.device(d) for d in row] for row in grid]
    home = grid[0][0]

    def pipelined(stacked_params, x_micro):
        M = x_micro.shape[0]
        if x_micro.shape[1] % D:
            raise ValueError(f"{x_micro.shape[1]} micro rows do not split "
                             f"over {D} data replicas")
        rows = x_micro.chunk(D, 1)
        outs = []
        for d in range(D):
            ring = DeviceTransport([grid[s][d] for s in range(S)])
            params = [tree_map(lambda a, s=s: a[s].to(grid[s][d]),
                               stacked_params) for s in range(S)]
            xs = [rows[d].to(grid[0][d])] + [
                rows[d].to(grid[s][d]) for s in range(1, S)]
            y = _pipeline_local(params, xs, stage_fn=stage_fn,
                                transport=ring, num_stages=S,
                                num_micro=M)[S - 1]
            # The masked buffers' sum: the last stage's, on one device.
            outs.append(y.to(home))
        return torch.cat(outs, 1) if D > 1 else outs[0]

    return pipelined


def _group_pipeline(stage_fn, mesh, axis, data_axis, model_axis):
    S, stage, stage_group = _group_coord(mesh, axis)
    D, data, data_group = _group_coord(mesh, data_axis)
    ring = GroupTransport(stage_group)
    wrap = unwrap = None
    model_mesh = mesh[model_axis] if model_axis is not None else None
    if model_mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate

        from tepdist_tpu_torch.parallel.spmd_transform import (
            register_flash_sharding)

        register_flash_sharding()   # a stage may run the flash ops

        def wrap(x):
            return DTensor.from_local(x, model_mesh, [Replicate()],
                                      run_check=False)

        def unwrap(y):
            return y.redistribute(model_mesh, [Replicate()]).to_local()

    def local_slice(a):
        """This stage's slice of a stacked leaf (a DTensor of the whole
        mesh keeps its placement over the model dimension)."""
        from torch.distributed.tensor import DTensor, Shard

        if isinstance(a, DTensor):
            names = a.device_mesh.mesh_dim_names
            local = a.to_local()[0]
            if data_group is not None:
                local = _ReplicatedIn.apply(data_group, local)
            if model_mesh is None:
                return local
            p = a.placements[names.index(model_axis)]
            if isinstance(p, Shard):
                p = Shard(p.dim - 1)
            return DTensor.from_local(local, model_mesh, [p],
                                      run_check=False)
        local = a[stage]
        if data_group is not None:
            local = _ReplicatedIn.apply(data_group, local)
        return local

    def pipelined(stacked_params, x_micro):
        M = x_micro.shape[0]
        if x_micro.shape[1] % D:
            raise ValueError(f"{x_micro.shape[1]} micro rows do not split "
                             f"over {D} data replicas")
        # The input is replicated over the stages and data slices: its
        # cotangent is summed over them (stage 0 of each slice feeds it).
        x_micro = _ReplicatedIn.apply(stage_group, x_micro)
        if data_group is not None:
            x_micro = _ReplicatedIn.apply(data_group, x_micro)
        xs = x_micro.chunk(D, 1)[data].contiguous()
        params = tree_map(local_slice, stacked_params)
        y = _pipeline_local([params], [xs], stage_fn=stage_fn,
                            transport=ring, num_stages=S, num_micro=M,
                            wrap=wrap, unwrap=unwrap, chained=True)[0]
        y = _SumReplicated.apply(stage_group, y)
        if data_group is not None:
            y = _GatherRows.apply(data_group, 1, y)
        return y

    return pipelined


def sequential_reference(stage_fn: Callable, stacked_params, x_micro):
    """Unpipelined semantics for testing: apply stages in order per micro
    batch."""
    S = tree_leaves(stacked_params)[0].shape[0]
    outs = []
    for m in range(x_micro.shape[0]):
        h = x_micro[m]
        for s in range(S):
            h = stage_fn(tree_map(lambda a, s=s: a[s], stacked_params), h)
        outs.append(h)
    return torch.stack(outs)
