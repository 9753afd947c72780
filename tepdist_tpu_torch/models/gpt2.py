"""GPT-2 in PyTorch: the port of ``tepdist_tpu/models/gpt2.py``.

Parameters are the JAX package's pytree as nested dicts of tensors, with the
same names, shapes and dtypes: matrices and biases in ``cfg.dtype`` (bf16
for the real configs), LayerNorm gains and biases in fp32. Both layouts are
kept: unrolled ``h{i}`` blocks and stacked ``blocks`` ([L, ...] leaves, the
scan-over-layers form the big configs train in). The functions mirror their
JAX namesakes op for op (LayerNorm math in fp32, tanh GELU, logits cast to
fp32 after the matmul, chunked cross-entropy with a zero-padded masked
tail), so the tests can hold one against the other.

Remat: ``cfg.remat`` checkpoints each block with
``torch.utils.checkpoint(use_reentrant=False)`` under the JAX package's
``remat_policy``, as a selective-checkpoint policy (``core/remat.py``):
``full`` recomputes the whole block in backward, ``dots`` keeps every
matmul output, ``dots_no_batch`` those without a batch dimension, and
``save_attn`` only the attention output. Under ``save_attn`` the flash
path keeps the outputs of the flash forward op (``tepdist::flash_fwd``),
so the backward launches no forward kernel; another attention keeps its
output through the ``tepdist::attn_out`` tag, a copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from tepdist_tpu_torch.core import remat
from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.ops import activations
from tepdist_tpu_torch.ops.flash_attention import (FLASH_FWD_OP,
                                                   flash_attention)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_ctx: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16
    # "einsum" (dense softmax attention) or "flash" (the port's kernels).
    attn: str = "einsum"
    remat: bool = False
    # "full", "dots", "dots_no_batch" or "save_attn" (module docstring).
    remat_policy: str = "full"
    # Flash tile sizes, validated against T as in the JAX package; they
    # choose no CUDA tile (0 = unset).
    flash_block_q: int = 0
    flash_block_k: int = 0
    # Chunked cross-entropy over this many tokens at a time (0 = dense).
    loss_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


CONFIGS: Dict[str, GPT2Config] = {
    "117M": GPT2Config(n_embd=768, n_layer=12, n_head=12),
    "345M": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "762M": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "1.5B": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
    "175B": GPT2Config(n_embd=12288, n_layer=96, n_head=96, n_ctx=2048),
    # tiny config for tests
    "test": GPT2Config(vocab_size=512, n_ctx=64, n_embd=64, n_layer=2,
                       n_head=4, dtype=torch.float32),
}

_EMBED_KEYS = ("wte", "wpe", "ln_f_g", "ln_f_b")


def num_params(cfg: GPT2Config) -> int:
    d, L, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    per_layer = 12 * d * d + 13 * d
    return v * d + cfg.n_ctx * d + L * per_layer + 2 * d


def init_params(cfg: GPT2Config, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """GPT-2 initialisation: normal(0.02), residual projections scaled by
    1/sqrt(2*n_layer), zero biases, unit LayerNorm gains. Drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; the values
    differ from the JAX package's threefry draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = 0.02
    resid_std = std / math.sqrt(2 * cfg.n_layer)
    d = cfg.n_embd
    f32 = torch.float32

    def norm(shape, s):
        x = torch.randn(shape, generator=gen, device=dev, dtype=f32)
        return (x * s).to(cfg.dtype)

    def const(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    params: Dict[str, Any] = {
        "wte": norm((cfg.vocab_size, d), std),
        "wpe": norm((cfg.n_ctx, d), std),
        "ln_f_g": const((d,), 1.0, f32),
        "ln_f_b": const((d,), 0.0, f32),
    }
    for i in range(cfg.n_layer):
        params[f"h{i}"] = {
            "ln1_g": const((d,), 1.0, f32),
            "ln1_b": const((d,), 0.0, f32),
            "attn_qkv_w": norm((d, 3 * d), std),
            "attn_qkv_b": const((3 * d,), 0.0, cfg.dtype),
            "attn_proj_w": norm((d, d), resid_std),
            "attn_proj_b": const((d,), 0.0, cfg.dtype),
            "ln2_g": const((d,), 1.0, f32),
            "ln2_b": const((d,), 0.0, f32),
            "mlp_fc_w": norm((d, 4 * d), std),
            "mlp_fc_b": const((4 * d,), 0.0, cfg.dtype),
            "mlp_proj_w": norm((4 * d, d), resid_std),
            "mlp_proj_b": const((d,), 0.0, cfg.dtype),
        }
    return params


def _layer_norm(x, g, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def _flash_impl(cfg: GPT2Config) -> Callable:
    def impl(q, k, v):
        return flash_attention(q, k, v, causal=True,
                               block_q=cfg.flash_block_q or None,
                               block_k=cfg.flash_block_k or None)
    return impl


def _einsum_attention(q, k, v):
    T = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    # The scale in q's dtype, as JAX's weak typing rounds a Python scalar.
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.tensor(
        scale, dtype=q.dtype, device=q.device)
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q.device))
    logits = torch.where(mask, logits.float(),
                         torch.full((), -1e9, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


@torch.library.custom_op("tepdist::attn_out", mutates_args=())
def _attn_out(o: torch.Tensor) -> torch.Tensor:
    """The ``attn_out`` name of the JAX package's ``checkpoint_name``: a
    copy of ``o`` that the ``save_attn`` policy keeps."""
    return o.clone()


_attn_out.register_fake(lambda o: torch.empty_like(o))
_attn_out.register_autograd(lambda ctx, g: g)
_ATTN_OUT_OP = torch.ops.tepdist.attn_out.default

_REMAT_POLICIES = {**remat.POLICIES,
                   "save_attn": frozenset({FLASH_FWD_OP, _ATTN_OUT_OP})}


def attention(block, x, cfg: GPT2Config, attn_impl: Optional[Callable] = None):
    """``attn_impl(q, k, v)`` on [B, H, T, hd] overrides ``cfg.attn``."""
    B, T, D = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    qkv = x @ block["attn_qkv_w"] + block["attn_qkv_b"]
    q, k, v = qkv.split(D, dim=-1)
    q = q.reshape(B, T, H, hd).transpose(1, 2)
    k = k.reshape(B, T, H, hd).transpose(1, 2)
    v = v.reshape(B, T, H, hd).transpose(1, 2)
    flash = attn_impl is None and cfg.attn == "flash"
    if attn_impl is None:
        if flash:
            attn_impl = _flash_impl(cfg)
        elif cfg.attn == "einsum":
            attn_impl = _einsum_attention
        else:
            raise ValueError(f"unknown attn {cfg.attn!r}; expected 'flash' "
                             "or 'einsum'")
    o = attn_impl(q, k, v)
    if cfg.remat and cfg.remat_policy == "save_attn" and not flash:
        o = _attn_out(o)
    o = o.transpose(1, 2).reshape(B, T, D)
    return o @ block["attn_proj_w"] + block["attn_proj_b"]


def mlp(block, x):
    h = x @ block["mlp_fc_w"] + block["mlp_fc_b"]
    h = activations.gelu_tanh(h)
    return h @ block["mlp_proj_w"] + block["mlp_proj_b"]


def _remat_saved(cfg: GPT2Config):
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; expected 'full', "
            "'dots', 'dots_no_batch', or 'save_attn'")
    return _REMAT_POLICIES[cfg.remat_policy]


def transformer_block(block, x, cfg: GPT2Config, attn_impl=None):
    x = x + attention(block, _layer_norm(x, block["ln1_g"], block["ln1_b"]),
                      cfg, attn_impl)
    x = x + mlp(block, _layer_norm(x, block["ln2_g"], block["ln2_b"]))
    return x


def _run_blocks(blocks, x, cfg: GPT2Config, attn_impl):
    """Apply each per-layer param dict in turn, each block under a
    non-reentrant checkpoint with ``cfg.remat_policy`` when ``cfg.remat``."""
    block_fn = transformer_block
    if cfg.remat:
        block_fn = remat.remat(transformer_block, _remat_saved(cfg))
    for block in blocks:
        x = block_fn(block, x, cfg, attn_impl)
    return x


def _embed(params, tokens, cfg: GPT2Config):
    """Token + position embeddings. The token lookup is ``F.embedding``,
    whose backward (``embedding_dense_backward``) DTensor propagates with
    split token ids: the table's gradient comes out ``Partial`` (a sum
    over the ranks), as GSPMD's scatter-add does. An indexing lookup's
    backward (``index_put`` with accumulate) fails to propagate there on
    some torch releases (ROADMAP C8)."""
    T = tokens.shape[1]
    x = (torch.nn.functional.embedding(tokens.long(), params["wte"])
         + params["wpe"][:T])
    return x.to(cfg.dtype)


def hidden_states(params, tokens, cfg: GPT2Config, attn_impl=None):
    """tokens: int [B, T] -> final (ln_f-normalised) hidden [B, T, D]."""
    x = _embed(params, tokens, cfg)
    x = _run_blocks([params[f"h{i}"] for i in range(cfg.n_layer)], x, cfg,
                    attn_impl)
    return _layer_norm(x, params["ln_f_g"], params["ln_f_b"])


def forward(params, tokens, cfg: GPT2Config, attn_impl=None):
    """tokens: int [B, T] -> logits [B, T, vocab] (fp32)."""
    x = hidden_states(params, tokens, cfg, attn_impl)
    return (x @ params["wte"].T).float()


def _ce_chunk(xc, tc, mc, wte):
    logits = (xc @ wte.T).float()                       # [chunk, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[:, None])[:, 0]
    return ((logz - gold) * mc).sum()


def _ce_from_hidden(x, wte, targets, cfg: GPT2Config):
    """Cross entropy from final hidden states, optionally chunked: each
    chunk of ``cfg.loss_chunk`` tokens runs under a checkpoint, so only one
    [chunk, V] fp32 logits block lives at a time in either direction. A
    non-dividing token count gets a zero-padded, masked tail chunk; the sum
    is divided by the real token count."""
    B, T, D = x.shape
    chunk = cfg.loss_chunk
    n_tokens = B * T
    targets = targets.long()
    if chunk <= 0:
        logits = (x @ wte.T).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None])[..., 0]
        return (logz - gold).mean()

    n_chunks = -(-n_tokens // chunk)
    pad = n_chunks * chunk - n_tokens
    xf = x.reshape(n_tokens, D)
    tf = targets.reshape(n_tokens)
    valid = torch.ones(n_tokens, dtype=torch.float32, device=x.device)
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, D)])
        tf = torch.cat([tf, tf.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_ce_chunk, xf[sl], tf[sl], valid[sl], wte,
                                   use_reentrant=False)
    return total / n_tokens


def loss_fn(params, tokens, cfg: GPT2Config, attn_impl=None):
    """Next-token cross entropy over shifted tokens."""
    x = hidden_states(params, tokens[:, :-1], cfg, attn_impl)
    return _ce_from_hidden(x, params["wte"], tokens[:, 1:], cfg)


# --------------------------------------------------------------------------
# Stacked form: per-layer params stacked on a leading [L, ...] dim. The
# JAX package scans over it; here a Python loop runs over one unbind of
# each leaf, whose backward stacks the per-layer grads once.
# --------------------------------------------------------------------------

def stack_block_params(params, cfg: GPT2Config):
    """h0..hN per-layer dicts -> one dict of [L, ...] stacked leaves."""
    keys = params["h0"].keys()
    return {k: torch.stack([params[f"h{i}"][k] for i in range(cfg.n_layer)])
            for k in keys}


def stacked_init_params(cfg: GPT2Config, seed: int = 0, device="cuda"):
    """init_params in stacked form: {embed leaves, "blocks": {k: [L, ...]}}."""
    params = init_params(cfg, seed, device)
    out = {k: params[k] for k in _EMBED_KEYS}
    out["blocks"] = stack_block_params(params, cfg)
    return out


def hidden_states_stacked(params, tokens, cfg: GPT2Config, attn_impl=None):
    x = _embed(params, tokens, cfg)
    per_key = {k: v.unbind(0) for k, v in params["blocks"].items()}
    blocks = [{k: per_key[k][i] for k in per_key}
              for i in range(cfg.n_layer)]
    x = _run_blocks(blocks, x, cfg, attn_impl)
    return _layer_norm(x, params["ln_f_g"], params["ln_f_b"])


def forward_stacked(params, tokens, cfg: GPT2Config, attn_impl=None):
    x = hidden_states_stacked(params, tokens, cfg, attn_impl)
    return (x @ params["wte"].T).float()


def loss_fn_stacked(params, tokens, cfg: GPT2Config, attn_impl=None):
    x = hidden_states_stacked(params, tokens[:, :-1], cfg, attn_impl)
    return _ce_from_hidden(x, params["wte"], tokens[:, 1:], cfg)


# --------------------------------------------------------------------------
# Stacked-stage form for the collective (single-program) pipeline: the
# block leaves stacked [S, L/S, ...], stage s's slice run by stage s
# (ops/collective_pipeline.py).
# --------------------------------------------------------------------------

# Megatron-style TP placement of the stacked block leaves over a model
# axis: column-split the up-projections (their biases follow), row-split
# the down-projections (a sum follows), replicate norms and residual
# biases. Dims count from the end of the [..., d_in, d_out] tail of the
# [S, L/S, ...] leaves. The FUSED qkv weight's column thirds are the Q/K/V
# slabs, so a column split only lines up with the later split in three
# when tp % 3 == 0; otherwise it is row-split (one sum before the bias).
_TP_DIM_FROM_END = {
    "mlp_fc_w": 1, "mlp_fc_b": 1,
    "attn_proj_w": 2, "mlp_proj_w": 2,
}


def _tp_dim_from_end(name: str, tp: int) -> Optional[int]:
    if name == "attn_qkv_w":
        return 1 if tp % 3 == 0 else 2
    if name == "attn_qkv_b":
        return 1 if tp % 3 == 0 else None
    return _TP_DIM_FROM_END.get(name)


def spec_for(name: str, a: torch.Tensor, dim_names: Sequence[str],
             tp: int, axis: str = "stage",
             model_axis: Optional[str] = None) -> list:
    """DTensor placements of stacked leaf ``name`` (``[S, L/S, ...]``) on a
    mesh of ``dim_names``: split over ``axis`` on dim 0, and over
    ``model_axis`` on its Megatron dim where ``tp`` divides it (a leaf
    that does not divide stays replicated there, with a warning);
    replicated over any other dimension."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * len(dim_names)
    placements[list(dim_names).index(axis)] = Shard(0)
    d_from_end = _tp_dim_from_end(name, tp) if model_axis else None
    if d_from_end is not None:
        d = a.dim() - d_from_end
        if a.shape[d] % tp == 0:
            placements[list(dim_names).index(model_axis)] = Shard(d)
        else:
            import logging
            logging.getLogger(__name__).warning(
                "TP placement: %s dim %d (size %d) not divisible by %s=%d: "
                "the leaf stays replicated over the model axis", name, d,
                a.shape[d], model_axis, tp)
    return placements


def shard_stacked_for_stages(params, cfg: GPT2Config, mesh,
                             axis: str = "stage",
                             model_axis: Optional[str] = None):
    """Split full params into (embed leaves, stacked blocks ``{k: [S, L/S,
    ...]}``) for the collective pipeline. ``mesh`` is a list of S stage
    devices (the device form: the blocks stay whole; the pipeline moves
    each stage's slice to its device) or a ``DeviceMesh`` (the group form:
    the blocks become DTensors of the whole mesh with :func:`spec_for`'s
    placements, ``model_axis`` adding the Megatron split — the PP x TP
    placement ``collective_pipeline(..., model_axis=...)`` takes).
    Validates the stage count against the layers."""
    if isinstance(mesh, (list, tuple)):
        if model_axis is not None:
            raise ValueError("model_axis needs a DeviceMesh (one rank a "
                             "device)")
        S, tp = len(mesh), 1
    else:
        names = mesh.mesh_dim_names
        S = mesh.size(names.index(axis))
        tp = mesh.size(names.index(model_axis)) if model_axis else 1
    if cfg.n_layer % S:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by "
                         f"{S} stages")
    stacked = {k: a.reshape((S, cfg.n_layer // S) + tuple(a.shape[1:]))
               for k, a in stack_block_params(params, cfg).items()}
    if not isinstance(mesh, (list, tuple)):
        from torch.distributed.tensor import distribute_tensor

        stacked = {k: distribute_tensor(
            a.to(mesh.device_type), mesh,
            spec_for(k, a, names, tp, axis, model_axis), src_data_rank=None)
            for k, a in stacked.items()}
    embed = {k: params[k] for k in _EMBED_KEYS}
    return embed, stacked


def make_stage_fn(cfg: GPT2Config, layers_per_stage: int,
                  attn_impl=None) -> Callable:
    """Stage body for the collective pipeline: this stage's layer slice
    (leading dim ``layers_per_stage``), block by block (each under the
    config's remat)."""

    def stage_fn(stage_params, x):
        blocks = [{k: v[j] for k, v in stage_params.items()}
                  for j in range(layers_per_stage)]
        return _run_blocks(blocks, x, cfg, attn_impl)

    return stage_fn


def pipelined_loss_fn(params, stacked_blocks, tokens, cfg: GPT2Config,
                      mesh, num_micro: int, axis: str = "stage",
                      model_axis: Optional[str] = None, attn_impl=None):
    """Next-token CE with the block stack run as a collective pipeline.

    ``params``: the embedding and final-norm leaves (wte/wpe/ln_f_*).
    ``stacked_blocks``: the ``[S, L/S, ...]`` leaves of
    :func:`shard_stacked_for_stages` for the same ``mesh`` (and
    ``model_axis``: PP x TP in the group form)."""
    from tepdist_tpu_torch.ops.collective_pipeline import (
        collective_pipeline)

    if isinstance(mesh, (list, tuple)):
        S = len(mesh)
    else:
        S = mesh.size(mesh.mesh_dim_names.index(axis))
    B, Tfull = tokens.shape
    T = Tfull - 1
    x = _embed(params, tokens[:, :-1], cfg)
    x_micro = x.reshape(num_micro, B // num_micro, T, cfg.n_embd)
    pipelined = collective_pipeline(
        make_stage_fn(cfg, cfg.n_layer // S, attn_impl), mesh, axis=axis,
        model_axis=model_axis)
    y = pipelined(stacked_blocks, x_micro).reshape(B, T, cfg.n_embd)
    y = _layer_norm(y, params["ln_f_g"], params["ln_f_b"])
    return _ce_from_hidden(y, params["wte"], tokens[:, 1:], cfg)


def fake_batch(cfg: GPT2Config, batch_size: int,
               seq_len: Optional[int] = None, seed: int = 0,
               device="cuda") -> torch.Tensor:
    """FAKE_INPUT-mode batch: uniform int64 tokens [batch_size, T + 1] from
    a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    T = seq_len or cfg.n_ctx
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch_size, T + 1),
                         generator=gen, device=dev)
