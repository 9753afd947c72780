"""Llama-style decoder in PyTorch: the port of ``tepdist_tpu/models/llama.py``
(RMSNorm, SwiGLU, rotary embeddings, grouped-query attention).

Parameters are the JAX package's tree (``tok_emb``, ``norm_f``,
``lm_head`` and one ``l{i}`` dict per layer) with the same names, shapes
and dtypes, so weights and checkpoints cross by flat index. RMSNorm and
RoPE run in fp32 and cast back. GQA repeats each KV head over its query
group with ``repeat_interleave`` (``jnp.repeat``: a head's copies sit next
to each other) before attention; ``attn="flash"`` runs the port's flash
kernels on the result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.ops import activations
from tepdist_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_ctx: int = 2048
    dim: int = 2048
    n_layer: int = 16
    n_head: int = 16
    n_kv_head: int = 4            # grouped-query attention
    ffn_mult: float = 2.6875      # hidden = mult * dim, rounded to 128
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # "einsum" (dense softmax attention) or "flash" (the port's kernels,
    # after RoPE and the GQA repeat).
    attn: str = "einsum"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_head

    @property
    def ffn_dim(self) -> int:
        return int((self.ffn_mult * self.dim + 127) // 128 * 128)


CONFIGS: Dict[str, LlamaConfig] = {
    "1B": LlamaConfig(dim=2048, n_layer=16, n_head=16, n_kv_head=4),
    "7B": LlamaConfig(dim=4096, n_layer=32, n_head=32, n_kv_head=32,
                      ffn_mult=2.6875),
    "test": LlamaConfig(vocab_size=512, n_ctx=64, dim=64, n_layer=2,
                        n_head=4, n_kv_head=2, dtype=torch.float32),
}


def init_params(cfg: LlamaConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Normal(1/sqrt(dim)) matrices (0.02 for the embedding, residual
    outputs scaled by 1/sqrt(2*n_layer)), unit norm gains. Drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; the values
    differ from the JAX package's threefry draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim
    kvd = cfg.n_kv_head * hd
    f = cfg.ffn_dim
    std = 1.0 / math.sqrt(d)
    resid = std / math.sqrt(2 * cfg.n_layer)

    def norm(shape, s=std):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * s).to(cfg.dtype)

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    params: Dict[str, Any] = {
        "tok_emb": norm((cfg.vocab_size, d), 0.02),
        "norm_f": ones(),
        "lm_head": norm((d, cfg.vocab_size)),
    }
    for i in range(cfg.n_layer):
        params[f"l{i}"] = {
            "attn_norm": ones(),
            "wq": norm((d, d)),
            "wk": norm((d, kvd)),
            "wv": norm((d, kvd)),
            "wo": norm((d, d), resid),
            "ffn_norm": ones(),
            "w_gate": norm((d, f)),
            "w_up": norm((d, f)),
            "w_down": norm((f, d), resid),
        }
    return params


def _rms_norm(x, g, eps=1e-5):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * g).to(x.dtype)


def _rope(x, theta: float):
    """Rotary embedding over [B, H, T, hd] (rotate-half formulation)."""
    T, hd = x.shape[2], x.shape[3]
    half = hd // 2
    pos = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (pos / half))
    angles = (torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
              * freqs[None, :])
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attention(blk, x, cfg: LlamaConfig):
    B, T, D = x.shape
    H, KV, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = (x @ blk["wq"]).reshape(B, T, H, hd).transpose(1, 2)
    k = (x @ blk["wk"]).reshape(B, T, KV, hd).transpose(1, 2)
    v = (x @ blk["wv"]).reshape(B, T, KV, hd).transpose(1, 2)
    q = _rope(q, cfg.rope_theta)
    k = _rope(k, cfg.rope_theta)
    # GQA: broadcast each KV head over its query group.
    group = H // KV
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    if cfg.attn == "flash":
        o = flash_attention(q, k, v, causal=True)
    elif cfg.attn == "einsum":
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(hd)
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                     device=x.device))
        s = torch.where(mask, s, torch.full((), -1e9, device=x.device))
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    else:
        raise ValueError(f"unknown attn {cfg.attn!r}; expected 'flash' or "
                         "'einsum'")
    o = o.transpose(1, 2).reshape(B, T, D)
    return o @ blk["wo"]


def _swiglu(blk, x):
    return ((activations.silu(x @ blk["w_gate"]) * (x @ blk["w_up"]))
            @ blk["w_down"])


def forward(params, tokens, cfg: LlamaConfig):
    """tokens: int [B, T] -> logits [B, T, vocab] (fp32)."""
    x = params["tok_emb"][tokens.long()].to(cfg.dtype)
    for i in range(cfg.n_layer):
        blk = params[f"l{i}"]
        x = x + _attention(blk, _rms_norm(x, blk["attn_norm"]), cfg)
        x = x + _swiglu(blk, _rms_norm(x, blk["ffn_norm"]))
    x = _rms_norm(x, params["norm_f"])
    return (x @ params["lm_head"]).float()


def loss_fn(params, tokens, cfg: LlamaConfig):
    """Next-token cross entropy over shifted tokens."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def fake_batch(cfg: LlamaConfig, batch_size: int,
               seq_len: Optional[int] = None, seed: int = 0,
               device="cuda") -> torch.Tensor:
    """FAKE_INPUT-mode batch: uniform int64 tokens [batch_size, T + 1] from
    a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    T = seq_len or cfg.n_ctx
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch_size, T + 1),
                         generator=gen, device=dev)
