"""Flash attention (forward + backward) on hand-written Hopper kernels.

The port of ``tepdist_tpu/ops/pallas/flash_attention.py``. Three CUDA
kernels (``csrc/flash_fwd.cu``, ``flash_dq.cu``, ``flash_dkv.cu``) replace
the three Pallas kernels. The forward saves (O, LSE); the backward
recomputes P from the LSE in two kernels, one accumulating dQ over key
tiles and one accumulating dK/dV over query tiles, so no [T, T] matrix
reaches device memory. An LSE cotangent folds into delta.

Each kernel wrapper (:func:`flash_fwd`, :func:`flash_dq`, :func:`flash_dkv`)
takes flattened [BH, T, D] tensors. On a CUDA tensor it launches its kernel
(or raises) and adds one to :data:`launch_counts`; on a CPU tensor it runs
the plain PyTorch version beside it (``*_plain``), which the CPU tests use.
The kernels mask the ragged edge themselves, so any T works and the JAX
package's pad-to-128 and dense fallbacks have no counterpart here.

Each kernel is also a ``torch.library`` custom op (``tepdist::flash_fwd``,
``tepdist::flash_dq``, ``tepdist::flash_dkv``; :data:`FLASH_FWD_OP` and its
two siblings) with a fake impl and the head count as an argument, and the
forward op's backward is the other two ops (``register_autograd``). So a
graph captured with ``make_fx`` on fake tensors holds all three, as the
reference's jaxpr holds its ``pallas_call``s, and a selective-checkpoint
policy can name the forward and keep its outputs (GPT-2's ``save_attn``).
The ops run only while a dispatch mode is active (capture, a policy);
otherwise :func:`flash_attention` goes straight to the wrappers through an
``autograd.Function`` with the same backward, which skips the ops' host
dispatch. Both paths give the same values and the same launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from tepdist_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# Launches of each kernel since the last reset_launch_counts(); only a
# successful kernel launch counts, never a plain-version call.
launch_counts: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0,
                                 "flash_dkv": 0}
# The same launches split by mask: "flash_fwd/causal", "flash_fwd/full".
mask_launch_counts: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    mask_launch_counts.clear()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # pointers..., BH, T, D, is_bf16, causal, scale, stream
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _P],
    "flash_dq": [_P] * 7 + [_I] * 5 + [_F, _P],
    "flash_dkv": [_P] * 8 + [_I] * 5 + [_F, _P],
}


_entries: Dict[str, object] = {}


def _entry(name: str):
    """The C entry of kernel ``name``, its library built and loaded at the
    first call."""
    if name not in _entries:
        fn = getattr(_build.load(name), f"tepdist_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def _check(name: str, slabs, rows=()) -> torch.device:
    """Validate what the kernel takes: same-shape contiguous [BH, T, D]
    slabs of one dtype (fp32 or bf16) and D in HEAD_DIMS, fp32 [BH, T]
    row vectors, all on one CPU or CUDA device."""
    ref = slabs[0]
    if ref.dim() != 3:
        raise ValueError(f"{name}: expected [BH, T, D], got {tuple(ref.shape)}")
    BH, T, D = ref.shape
    if D not in HEAD_DIMS or T < 1 or BH < 1:
        raise ValueError(f"{name}: shape {tuple(ref.shape)} unsupported "
                         f"(head dim must be one of {HEAD_DIMS})")
    if ref.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {ref.dtype} unsupported "
                        f"(float32 or bfloat16)")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {ref.device} unsupported")
    for t in slabs:
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{name}: operands differ in shape or dtype")
    for t in rows:
        if t.shape != (BH, T) or t.dtype != torch.float32:
            raise ValueError(f"{name}: LSE/delta must be float32 [BH, T]")
    for t in (*slabs, *rows):
        if t.device != ref.device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return ref.device


def _launch(name: str, device: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    launch_counts[name] += 1
    # args end with (..., causal, scale): _meta's order.
    key = f"{name}/{'causal' if args[-2] else 'full'}"
    mask_launch_counts[key] = mask_launch_counts.get(key, 0) + 1


def _meta(q: torch.Tensor, causal: bool, scale: float):
    BH, T, D = q.shape
    return (BH, T, D, int(q.dtype == torch.bfloat16), int(causal),
            float(scale))


# --------------------------------------------------------------------------
# Plain PyTorch versions: the same functions, dense, in fp32 (Q, K, V are
# upcast before both dots, as in the Pallas kernels).
# --------------------------------------------------------------------------

def _scores(q, k, causal: bool, scale: float):
    """Masked fp32 scores [BH, T, T] and the mask (True = attended)."""
    s = (q.float() * scale) @ k.float().transpose(1, 2)
    T = q.shape[1]
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    return torch.where(keep, s, torch.full_like(s, _NEG_INF)), keep


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    s, _ = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m <= _NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s, keep = _scores(q, k, causal, scale)
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = do.float() @ v.float().transpose(1, 2)
    return p, p * (dp - delta[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    return ((ds @ k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dk = ds.transpose(1, 2) @ (q.float() * scale)
    dv = p.transpose(1, 2) @ do.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def flash_fwd(q, k, v, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[BH, T, D] q, k, v -> (o [BH, T, D], lse [BH, T] fp32)."""
    device = _check("flash_fwd", (q, k, v))
    if device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=device)
    _launch("flash_fwd", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *_meta(q, causal, scale))
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float
             ) -> torch.Tensor:
    """dQ [BH, T, D] from q, k, v, dO and the fp32 [BH, T] LSE and delta."""
    device = _check("flash_dq", (q, k, v, do), (lse, delta))
    if device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    _launch("flash_dq", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_meta(q, causal, scale))
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [BH, T, D] from q, k, v, dO and the fp32 LSE and delta."""
    device = _check("flash_dkv", (q, k, v, do), (lse, delta))
    if device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_meta(q, causal, scale))
    return dk, dv


# --------------------------------------------------------------------------
# The kernels as torch.library ops. Each carries the head count H beside
# causal and scale (the reference's forward call names all three, and the
# flattened [BH, T, D] layout loses H); each has a fake impl, so a graph
# captured on fake tensors holds them, and the forward's backward is the
# other two ops, registered with ``register_autograd``.
# --------------------------------------------------------------------------

@torch.library.custom_op("tepdist::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, n_head: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal, scale)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale, n_head):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op("tepdist::flash_dq", mutates_args=())
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, scale: float, n_head: int) -> torch.Tensor:
    return flash_dq(q, k, v, do, lse, delta, causal, scale)


@_flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, causal, scale, n_head):
    return torch.empty_like(q)


@torch.library.custom_op("tepdist::flash_dkv", mutates_args=())
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, scale: float, n_head: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_dkv(q, k, v, do, lse, delta, causal, scale)


@_flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, causal, scale, n_head):
    return torch.empty_like(k), torch.empty_like(v)


FLASH_FWD_OP = torch.ops.tepdist.flash_fwd.default
FLASH_DQ_OP = torch.ops.tepdist.flash_dq.default
FLASH_DKV_OP = torch.ops.tepdist.flash_dkv.default


def _use_ops(x: Optional[torch.Tensor] = None) -> bool:
    """Whether to call the kernels through their ops: while a dispatch
    mode is active (graph capture, a selective-checkpoint policy), or on a
    tensor subclass (a DTensor, whose sharding rule is the op's). An eager
    step calls the wrappers directly, skipping the op's host dispatch
    (50-94 us a call against 29-52 us, PERF.md section 6)."""
    return (_get_current_dispatch_mode() is not None
            or (x is not None and type(x) is not torch.Tensor
                and not isinstance(x, torch.nn.Parameter)))


# --------------------------------------------------------------------------
# Differentiable attention
# --------------------------------------------------------------------------

def _flat(x: torch.Tensor) -> torch.Tensor:
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D).contiguous()


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale, n_head = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale, ctx.n_head = causal, scale, n_head
    # An unused output's cotangent stays None (no zeros to fold in).
    ctx.set_materialize_grads(False)


def _backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    args = (ctx.causal, ctx.scale)
    do = torch.zeros_like(o) if do is None else do.contiguous()
    # delta = rowsum(dO * O); an LSE cotangent folds in here, since
    # d lse / d s = P turns dS = P * (dP - delta + dLSE) into the same
    # kernels with delta - dLSE.
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    delta = delta.contiguous()
    if _use_ops(q):
        dq = FLASH_DQ_OP(q, k, v, do, lse, delta, *args, ctx.n_head)
        dk, dv = FLASH_DKV_OP(q, k, v, do, lse, delta, *args, ctx.n_head)
    else:
        dq = flash_dq(q, k, v, do, lse, delta, *args)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *args)
    return dq, dk, dv, None, None, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)


class _Flash(torch.autograd.Function):
    """The direct path: (O, LSE) of flattened [BH, T, D] attention, both
    differentiable, through the wrappers with the ops' own backward (the
    two ``custom_vjp``s of the JAX package in one)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, n_head):
        o, lse = flash_fwd(q, k, v, causal, scale)
        _setup_context(ctx, (q, k, v, causal, scale, n_head), (o, lse))
        return o, lse

    backward = staticmethod(_backward)


def _attend(q, k, v, causal: bool, scale: float, n_head: int):
    if _use_ops(q):
        return FLASH_FWD_OP(_flat(q), _flat(k), _flat(v), causal, scale,
                            n_head)
    return _Flash.apply(_flat(q), _flat(k), _flat(v), causal, scale, n_head)


def _resolve_blocks(T: int, block_q: Optional[int],
                    block_k: Optional[int]) -> None:
    """Validate explicit block sizes as the JAX package does (they must
    divide T). They choose no CUDA tile: the kernels' tiles are fixed, and
    the JAX default of 512 is a TPU sweep."""
    if block_q is None and block_k is None:
        return
    bq = min(block_q or block_k, T)
    bk = min(block_k or bq, T)
    if T % bq or T % bk:
        raise ValueError(f"seq len {T} must divide blocks {bq}/{bk}")


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q, k, v: [B, H, T, D] -> [B, H, T, D]. Differentiable."""
    B, H, T, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _resolve_blocks(T, block_q, block_k)
    o, _ = _attend(q, k, v, causal, scale, H)
    return o.reshape(B, H, T, D)


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None):
    """[B, H, T, D] -> (o [B, H, T, D], lse [B, H, T] fp32), both
    differentiable (the LSE cotangent folds into the backward's delta)."""
    B, H, T, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _resolve_blocks(T, block_q, block_k)
    o, lse = _attend(q, k, v, causal, scale, H)
    return o.reshape(B, H, T, D), lse.reshape(B, H, T)
