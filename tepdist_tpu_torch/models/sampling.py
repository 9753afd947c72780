"""Incremental decoding (KV cache) and sampling for the GPT-2 family: the
port of ``tepdist_tpu/models/sampling.py``.

A static-shape KV cache ([n_layer, B, H, max_len, head_dim]) is filled by a
prefill over the prompt and then one position per decode step; attention
against it is the einsum path in fp32, as in the JAX package (a decode step
reads the cache once, so a flash kernel buys nothing at one query). The
JAX package scans the decode steps in one compiled program; here they are
a Python loop. Greedy decoding takes the argmax; otherwise temperature and
top-k shape the logits and a Gumbel-max draw from an explicit
``torch.Generator`` picks the token (the JAX package draws with threefry,
whose values cannot be matched; the contracts are the same: a seed is
deterministic and top-k restricts the support).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.models.gpt2 import GPT2Config, _layer_norm

_NEG_INF = -1e30


def init_cache(cfg: GPT2Config, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    device = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _attn_with_cache(block, x, ck, cv, start: int, cfg: GPT2Config):
    """Causal attention of a length-S query block at positions
    [start, start+S) against the cache, which it updates in place.
    ck/cv: [B, H, L, hd]."""
    B, S, D = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    qkv = x @ block["attn_qkv_w"] + block["attn_qkv_b"]
    q, k, v = qkv.split(D, dim=-1)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, H, hd).transpose(1, 2)
    v = v.reshape(B, S, H, hd).transpose(1, 2)
    ck[:, :, start:start + S] = k.to(ck.dtype)
    cv[:, :, start:start + S] = v.to(cv.dtype)
    L = ck.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhsd,bhld->bhsl", q.float(), ck.float()) * scale
    q_pos = start + torch.arange(S, device=x.device)[:, None]
    k_pos = torch.arange(L, device=x.device)[None, :]
    s = torch.where(k_pos <= q_pos, s, torch.full((), _NEG_INF,
                                                  device=x.device))
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bhsl,bhld->bhsd", p, cv)
    o = o.transpose(1, 2).reshape(B, S, D)
    return o @ block["attn_proj_w"] + block["attn_proj_b"]


def _forward_with_cache(params, tokens, cache, start: int,
                        cfg: GPT2Config):
    """tokens [B, S] at positions [start, start+S) -> last-position logits
    [B, vocab] fp32; the cache is updated in place."""
    S = tokens.shape[1]
    x = (params["wte"][tokens.long()]
         + params["wpe"][start:start + S]).to(cfg.dtype)
    for i in range(cfg.n_layer):
        blk = params[f"h{i}"]
        x = x + _attn_with_cache(
            blk, _layer_norm(x, blk["ln1_g"], blk["ln1_b"]),
            cache["k"][i], cache["v"][i], start, cfg)
        x = x + gpt2.mlp(blk, _layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
    x = _layer_norm(x[:, -1], params["ln_f_g"], params["ln_f_b"])
    return (x @ params["wte"].T).float()


def _pick(logits, generator: Optional[torch.Generator], temperature: float,
          top_k: int, greedy: bool):
    if greedy:
        return logits.argmax(-1)
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, _NEG_INF),
                             logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits + gumbel).argmax(-1)


@torch.no_grad()
def sample(params, prompt, cfg: GPT2Config, *, max_new_tokens: int,
           temperature: float = 1.0, top_k: int = 0, greedy: bool = False,
           generator: Optional[torch.Generator] = None):
    """prompt int [B, T] -> int64 [B, T + max_new_tokens] on the prompt's
    device.

    Greedy (``greedy=True``) or temperature/top-k sampling; without a
    ``generator`` one seeded with 0 on the prompt's device is used."""
    B, T = prompt.shape
    L = T + max_new_tokens
    if L > cfg.n_ctx:
        raise ValueError(f"{L} tokens > n_ctx={cfg.n_ctx}")
    device = prompt.device
    if not greedy and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cache = init_cache(cfg, B, L, device)
    logits = _forward_with_cache(params, prompt, cache, 0, cfg)
    out = [prompt.long()]
    for pos in range(T, L):
        tok = _pick(logits, generator, temperature, top_k, greedy)
        out.append(tok[:, None])
        if pos + 1 < L:
            logits = _forward_with_cache(params, tok[:, None], cache, pos,
                                         cfg)
    return torch.cat(out, dim=1)
