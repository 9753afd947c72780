"""Ring attention: sequence parallelism by K/V blocks rotating around a
ring of ranks. The port of ``tepdist_tpu/ops/ring_attention.py``.

Layout: q, k, v are [B, H, T, D] with T split over the ring's P ranks.
Each rank keeps its query block and, hop by hop, attends to the K/V block
that rests on it, while a neighbour shift (``ops/seq_comm.py``, the
reference's ``lax.ppermute``) moves the blocks on by one rank; the hops'
partial results merge by online softmax. The transport is either a
process group (this rank's block; the DTensor lowering) or a device list
in one process (every block; the counterpart of the reference's
``shard_map`` over one process's devices): the hop loop below runs over
the ranks the process holds, so both run the same code.

Two inners, as in the reference:

* ``"einsum"``: each hop is plain torch (``_block_attention``, an
  online-softmax accumulation step); autograd differentiates through it
  and the differentiable shift, as JAX does through ``fori_loop``.
* ``"flash"``: each hop is one launch of the port's flash forward kernel,
  which returns the hop's output and LSE; the hops merge by log-sum-exp.
  Causal block selection is positional: the diagonal hop runs the causal
  kernel, hops strictly below it the non-causal kernel, and hops above it
  launch nothing and count with an LSE of -1e30. The backward is written
  out, not traced: a reverse ring runs the dQ and dK/dV kernels hop by
  hop with the MERGED LSE and delta = rowsum(dO * O) - dLSE, which makes
  each hop's P = exp(S - LSE) the global softmax and each partial sum
  exact; the dK/dV accumulators travel with their K/V block and come home
  after the last hop. The reference differentiates its forward hops
  instead; both give the exact gradient.

The flash path is also the ``tepdist::seq_attn`` op (with
``tepdist::seq_attn_bwd`` as its registered backward) that the sequence
rewrite of ``parallel/attention_motif.py`` puts into a loss, so a graph
captured with ``make_fx`` holds the ring as one node, as the reference's
jaxpr holds its ``shard_map``. Outside a DTensor lowering the op runs the
one-process form over ``[q.device] * seq_size``; the lowering runs it
over the ``seq`` dimension's process group.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tepdist_tpu_torch.ops import seq_comm
from tepdist_tpu_torch.ops.flash_attention import (_use_ops, flash_dkv,
                                                   flash_dq, flash_fwd)
from tepdist_tpu_torch.ops.seq_comm import Transport, transport_for

_NEG_INF = -1e30


# --------------------------------------------------------------------------
# The einsum inner
# --------------------------------------------------------------------------

def _block_attention(q, k, v, m, l, o, q_start: int, k_start: int,
                     causal: bool, scale: float):
    """One online-softmax accumulation step against a K/V block. Both
    einsums take their (q-dtype) operands to fp32 and give fp32: what XLA
    makes of the reference's bf16 einsum followed by a cast to fp32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        qpos = q_start + torch.arange(Tq, device=q.device)[:, None]
        kpos = k_start + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    m_block = s.amax(-1, keepdim=True)                         # [B,H,Tq,1]
    m_new = torch.maximum(m, m_block)
    # Guard fully-masked rows (m_new == -inf): keep exp at 0.
    p = torch.exp(s - m_new)
    p = torch.where(m_new <= _NEG_INF / 2, torch.zeros_like(p), p)
    corr = torch.exp(m - m_new)
    corr = torch.where(m <= _NEG_INF / 2, torch.zeros_like(corr), corr)
    l_new = l * corr + p.sum(-1, keepdim=True)
    o_new = o * corr + torch.einsum("bhqk,bhkd->bhqd",
                                    p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def _ring_attention_local(qs, ks, vs, transport: Transport, causal: bool,
                          scale: float):
    """The einsum ring over the held ranks' [B, H, T/P, D] blocks:
    (outputs, LSEs), differentiable by autograd."""
    P = transport.size
    B, H, Tl, D = qs[0].shape
    m = [q.new_full((B, H, Tl, 1), _NEG_INF, dtype=torch.float32)
         for q in qs]
    l = [q.new_zeros((B, H, Tl, 1), dtype=torch.float32) for q in qs]
    o = [q.new_zeros((B, H, Tl, D), dtype=torch.float32) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for s in range(P):
        for i, r in enumerate(transport.ranks):
            j = (r - s) % P            # owner of the resident K/V block
            m[i], l[i], o[i] = _block_attention(
                qs[i], k_cur[i], v_cur[i], m[i], l[i], o[i],
                q_start=r * Tl, k_start=j * Tl, causal=causal, scale=scale)
        if s < P - 1:
            k_cur, v_cur = seq_comm.shift(transport, [k_cur, v_cur])
    outs = [(oi / li.clamp_min(1e-30)).to(q.dtype)
            for oi, li, q in zip(o, l, qs)]
    lses = [(mi + torch.log(li.clamp_min(1e-30)))[..., 0]
            for mi, li in zip(m, l)]
    return outs, lses


# --------------------------------------------------------------------------
# The flash inner
# --------------------------------------------------------------------------

def hop_kind(rank: int, owner: int, causal: bool) -> str:
    """"diag", "full" or "skip": the kernel a hop of the causal ring runs
    for the K/V block of ``owner`` on ``rank``."""
    if not causal or owner < rank:
        return "full"
    return "diag" if owner == rank else "skip"


def ring_hops(P: int, causal: bool) -> dict:
    """Hops of one ring call by kind, over all P ranks."""
    kinds = {"diag": 0, "full": 0, "skip": 0}
    for r in range(P):
        for s in range(P):
            kinds[hop_kind(r, (r - s) % P, causal)] += 1
    return kinds


def _flat(x):
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D)


def ring_flash_forward(qs, ks, vs, transport: Transport, causal: bool,
                       scale: float):
    """The flash ring's forward over the held ranks' contiguous
    [B, H, T/P, D] blocks: (outputs in q's dtype, fp32 LSEs [B, H, T/P])."""
    P = transport.size
    B, H, Tl, D = qs[0].shape
    q3 = [_flat(q) for q in qs]
    m = [q.new_full((B * H, Tl, 1), _NEG_INF, dtype=torch.float32)
         for q in qs]
    num = [q.new_zeros((B * H, Tl, D), dtype=torch.float32) for q in qs]
    den = [q.new_zeros((B * H, Tl, 1), dtype=torch.float32) for q in qs]
    k_cur, v_cur = [_flat(k) for k in ks], [_flat(v) for v in vs]
    for s in range(P):
        for i, r in enumerate(transport.ranks):
            kind = hop_kind(r, (r - s) % P, causal)
            if kind == "skip":
                continue          # LSE -1e30: zero weight, no launch
            o_blk, lse_blk = flash_fwd(q3[i], k_cur[i], v_cur[i],
                                       kind == "diag", scale)
            lse_blk = lse_blk[..., None]
            m_new = torch.maximum(m[i], lse_blk)
            w_old = torch.where(m[i] <= _NEG_INF / 2,
                                torch.zeros_like(m_new),
                                torch.exp(m[i] - m_new))
            w_new = torch.where(lse_blk <= _NEG_INF / 2,
                                torch.zeros_like(m_new),
                                torch.exp(lse_blk - m_new))
            # In place: two passes over the [BH, T/P, D] accumulator.
            num[i].mul_(w_old).addcmul_(o_blk, w_new)
            den[i].mul_(w_old).add_(w_new)
            m[i] = m_new
        if s < P - 1:
            k_cur, v_cur = transport.shift_raw([k_cur, v_cur])
    outs, lses = [], []
    for i, q in enumerate(qs):
        d = den[i].clamp_min(1e-30)
        outs.append((num[i] / d).to(q.dtype).reshape(B, H, Tl, D))
        lses.append((m[i] + torch.log(d)).reshape(B, H, Tl))
    return outs, lses


def ring_flash_backward(qs, ks, vs, os, lses, dos, dlses,
                        transport: Transport, causal: bool, scale: float):
    """The reverse ring: (dQ, dK, dV) blocks of the flash ring from the
    saved blocks, the merged outputs and LSEs, and the cotangents of the
    outputs and (or None) of the LSEs."""
    P = transport.size
    B, H, Tl, D = qs[0].shape
    q3, o3 = [_flat(q) for q in qs], [_flat(o) for o in os]
    do3 = [_flat(d).contiguous() for d in dos]
    lse2 = [lse.reshape(B * H, Tl).contiguous() for lse in lses]
    delta = []
    for i in range(len(qs)):
        d = (do3[i].float() * o3[i].float()).sum(-1)
        if dlses is not None and dlses[i] is not None:
            d = d - dlses[i].reshape(B * H, Tl).float()
        delta.append(d.contiguous())
    dq = [torch.zeros_like(q, dtype=torch.float32) for q in q3]
    k_cur, v_cur = [_flat(k) for k in ks], [_flat(v) for v in vs]
    dk_cur = [torch.zeros_like(k, dtype=torch.float32) for k in k_cur]
    dv_cur = [torch.zeros_like(v, dtype=torch.float32) for v in v_cur]
    for s in range(P):
        for i, r in enumerate(transport.ranks):
            kind = hop_kind(r, (r - s) % P, causal)
            if kind == "skip":
                continue
            args = (q3[i], k_cur[i], v_cur[i], do3[i], lse2[i], delta[i],
                    kind == "diag", scale)
            dq[i].add_(flash_dq(*args))
            dk_blk, dv_blk = flash_dkv(*args)
            dk_cur[i].add_(dk_blk)
            dv_cur[i].add_(dv_blk)
        if s < P - 1:
            k_cur, v_cur, dk_cur, dv_cur = transport.shift_raw(
                [k_cur, v_cur, dk_cur, dv_cur])
    # After P - 1 shifts block j's accumulators rest on rank j - 1: one
    # more shift brings them home.
    dk_cur, dv_cur = transport.shift_raw([dk_cur, dv_cur])
    shape = (B, H, Tl, D)
    return ([g.to(q.dtype).reshape(shape) for g, q in zip(dq, qs)],
            [g.to(k.dtype).reshape(shape) for g, k in zip(dk_cur, ks)],
            [g.to(v.dtype).reshape(shape) for g, v in zip(dv_cur, vs)])


# --------------------------------------------------------------------------
# Sequence attention: ring or Ulysses, flash or einsum, over held blocks
# --------------------------------------------------------------------------

def seq_forward(qs, ks, vs, transport: Transport, causal: bool,
                scale: float, impl: str, inner: str):
    """(outputs, LSEs) of ``impl`` ("ring" or "ulysses") attention with
    ``inner`` ("flash" or "einsum") over the held [B, H, T/P, D] blocks."""
    if impl == "ulysses":
        from tepdist_tpu_torch.ops import ulysses
        return ulysses.ulysses_forward(qs, ks, vs, transport, causal, scale,
                                       inner)
    if impl != "ring":
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    if inner == "flash":
        return ring_flash_forward(qs, ks, vs, transport, causal, scale)
    with torch.no_grad():
        return _ring_attention_local(qs, ks, vs, transport, causal, scale)


def seq_backward(qs, ks, vs, os, lses, dos, dlses, transport: Transport,
                 causal: bool, scale: float, impl: str, inner: str):
    """(dQ, dK, dV) blocks of :func:`seq_forward`. The flash inners have a
    backward of their own; the einsum inners run their forward again
    under autograd."""
    if inner == "flash":
        if impl == "ulysses":
            from tepdist_tpu_torch.ops import ulysses
            return ulysses.ulysses_flash_backward(
                qs, ks, vs, os, lses, dos, dlses, transport, causal, scale)
        return ring_flash_backward(qs, ks, vs, os, lses, dos, dlses,
                                   transport, causal, scale)
    leaves = [x.detach().requires_grad_() for x in (*qs, *ks, *vs)]
    n = len(qs)
    with torch.enable_grad():
        if impl == "ulysses":
            from tepdist_tpu_torch.ops import ulysses
            o2, l2 = ulysses.ulysses_local(
                leaves[:n], leaves[n:2 * n], leaves[2 * n:], transport,
                causal, scale, None, return_lse=True)
        else:
            o2, l2 = _ring_attention_local(leaves[:n], leaves[n:2 * n],
                                           leaves[2 * n:], transport, causal,
                                           scale)
        outs = list(o2) + [lse for lse, g in zip(l2, dlses or [None] * n)
                           if g is not None]
        grads = list(dos) + [g for g in (dlses or []) if g is not None]
        g = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    g = [torch.zeros_like(x) if gi is None else gi
         for gi, x in zip(g, leaves)]
    return g[:n], g[n:2 * n], g[2 * n:]


def _as4(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B*H, T, D] or [B, H, T, D] as [B, H, T, D]."""
    T, D = x.shape[-2:]
    return x.reshape(-1, n_head, T, D)


def seq_attention_blocks(q, k, v, transport: Transport, causal: bool,
                         scale: float, n_head: int, impl: str, inner: str):
    """Forward of the sequence op on this process's tensors (whole tensors
    for a device list, this rank's block for a group); T is dim -2.
    Returns (o, lse) with o like q and lse q's shape without D, fp32."""
    if impl == "ulysses" and n_head % transport.size:
        raise ValueError(f"heads {n_head} not divisible by the ring's "
                         f"{transport.size} ranks")
    split = [transport.split(_as4(x, n_head), 2) for x in (q, k, v)]
    outs, lses = seq_forward(*split, transport, causal, scale, impl, inner)
    o = transport.join(outs, 2).reshape(q.shape)
    lse = transport.join(lses, 2).reshape(q.shape[:-1])
    return o, lse


def seq_attention_blocks_backward(q, k, v, o, lse, do, dlse,
                                  transport: Transport, causal: bool,
                                  scale: float, n_head: int, impl: str,
                                  inner: str):
    """(dq, dk, dv) of :func:`seq_attention_blocks`."""
    def sp(x):
        return transport.split(_as4(x, n_head), 2)

    def sp3(x):
        B, H = _as4(q, n_head).shape[:2]
        return transport.split(x.reshape(B, H, x.shape[-1]), 2)

    dlses = None if dlse is None else sp3(dlse)
    dqs, dks, dvs = seq_backward(sp(q), sp(k), sp(v), sp(o), sp3(lse),
                                 sp(do), dlses, transport, causal, scale,
                                 impl, inner)
    return tuple(transport.join(g, 2).reshape(x.shape)
                 for g, x in ((dqs, q), (dks, k), (dvs, v)))


class _SeqAttn(torch.autograd.Function):
    """The direct path of the sequence op: (o, lse), both differentiable,
    on any transport, with the op's backward."""

    @staticmethod
    def forward(ctx, q, k, v, transport, causal, scale, n_head, impl,
                inner):
        o, lse = seq_attention_blocks(q, k, v, transport, causal, scale,
                                      n_head, impl, inner)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (transport, causal, scale, n_head, impl, inner)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do
        dq, dk, dv = seq_attention_blocks_backward(q, k, v, o, lse, do,
                                                   dlse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


# The op: the one-process form over [q.device] * seq_size. A DTensor
# lowering intercepts its nodes and runs them over its process group
# (parallel/spmd_transform.py), so the op never sees a group.

@torch.library.custom_op("tepdist::seq_attn", mutates_args=())
def _seq_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float, n_head: int, impl: str,
                 inner: str, seq_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    t = seq_comm.DeviceTransport([q.device] * seq_size)
    return seq_attention_blocks(q, k, v, t, causal, scale, n_head, impl,
                                inner)


@_seq_attn_op.register_fake
def _(q, k, v, causal, scale, n_head, impl, inner, seq_size):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:-1], dtype=torch.float32))


@torch.library.custom_op("tepdist::seq_attn_bwd", mutates_args=())
def _seq_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     dlse: Optional[torch.Tensor], causal: bool,
                     scale: float, n_head: int, impl: str, inner: str,
                     seq_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    t = seq_comm.DeviceTransport([q.device] * seq_size)
    return seq_attention_blocks_backward(q, k, v, o, lse, do, dlse, t,
                                         causal, scale, n_head, impl, inner)


@_seq_attn_bwd_op.register_fake
def _(q, k, v, o, lse, do, dlse, causal, scale, n_head, impl, inner,
      seq_size):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _seq_setup_context(ctx, inputs, output):
    q, k, v, *args = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = tuple(args)
    ctx.set_materialize_grads(False)


def _seq_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    do = torch.zeros_like(o) if do is None else do.contiguous()
    dq, dk, dv = SEQ_ATTN_BWD_OP(q, k, v, o, lse, do, dlse, *ctx.args)
    return dq, dk, dv, None, None, None, None, None, None


_seq_attn_op.register_autograd(_seq_backward,
                               setup_context=_seq_setup_context)

SEQ_ATTN_OP = torch.ops.tepdist.seq_attn.default
SEQ_ATTN_BWD_OP = torch.ops.tepdist.seq_attn_bwd.default


def seq_attention(q, k, v, causal: bool, scale: float, n_head: int,
                  impl: str, inner: str, seq_size: int):
    """(o, lse) of exact attention computed by a ``seq_size``-rank ring
    (``impl`` "ring") or Ulysses all-to-all (``impl`` "ulysses") with the
    ``inner`` block compute: through the ``tepdist::seq_attn`` op while a
    dispatch mode is active (graph capture), else directly, in the
    one-process form over ``[q.device] * seq_size``."""
    if _use_ops():
        return SEQ_ATTN_OP(q, k, v, causal, scale, n_head, impl, inner,
                           seq_size)
    t = seq_comm.DeviceTransport([q.device] * seq_size)
    return _SeqAttn.apply(q, k, v, t, causal, scale, n_head, impl, inner)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def ring_attention(q, k, v, ring, axis_name: str = "seq",
                   causal: bool = True, scale: Optional[float] = None,
                   inner: str = "einsum", return_lse: bool = False):
    """Sequence-parallel attention of [B, H, T, D] q, k, v over ``ring``.

    ``ring`` is a device list (the one-process form: q, k, v are whole and
    split along T over it, the output is whole), a ``DeviceMesh`` (its
    ``axis_name`` dimension's group) or a process group (the process-group
    form: q, k, v and the output are this rank's [B, H, T/P, D] block).

    ``inner``: "einsum" (online-softmax einsum blocks) or "flash" (the
    flash kernels, LSE merge, the reverse-ring backward).
    ``return_lse`` (flash inner only) also returns the global [B, H, T]
    log-sum-exp. Differentiable."""
    if hasattr(ring, "get_group"):
        ring = ring.get_group(axis_name)
    transport = transport_for(ring)
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if inner == "flash":
        o, lse = _SeqAttn.apply(q, k, v, transport, causal, scale,
                                q.shape[1], "ring", "flash")
        return (o, lse) if return_lse else o
    if return_lse:
        raise ValueError("return_lse requires inner='flash'")
    if inner != "einsum":
        raise ValueError(f"unknown inner {inner!r}; expected 'einsum' or "
                         "'flash'")
    blocks = [transport.split(x, 2) for x in (q, k, v)]
    outs, _ = _ring_attention_local(*blocks, transport, causal, scale)
    return transport.join(outs, 2)


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Unsharded reference for testing."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        T = q.shape[2]
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def reference_attention_lse(q, k, v, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`reference_attention` and its fp32 [B, H, T] log-sum-exp."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        T = q.shape[2]
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v), lse

