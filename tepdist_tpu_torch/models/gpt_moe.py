"""GPT-MoE in PyTorch: the port of ``tepdist_tpu/models/gpt_moe.py`` — GPT-2
blocks whose MLP is, every ``moe_every``-th block, a GShard-style top-2
gated mixture of experts with capacity-limited einsum dispatch.

Parameters are the JAX package's tree: GPT-2's, with ``mlp_*`` of each MoE
block replaced by ``moe_gate_w`` [D, E], ``moe_wi`` [E, D, 4D] and
``moe_wo`` [E, 4D, D]. Attention is the port's ``gpt2.attention``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.ops import activations
from tepdist_tpu_torch.models.gpt2 import GPT2Config, _layer_norm, attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    base: GPT2Config = GPT2Config()
    num_experts: int = 8
    capacity_factor: float = 1.25
    moe_every: int = 2         # every k-th block uses MoE MLP


CONFIGS: Dict[str, MoEConfig] = {
    "base-8e": MoEConfig(base=GPT2Config(n_embd=768, n_layer=12, n_head=12),
                         num_experts=8),
    "test": MoEConfig(
        base=GPT2Config(vocab_size=512, n_ctx=64, n_embd=64, n_layer=2,
                        n_head=4, dtype=torch.float32),
        num_experts=4, moe_every=1),
}


def init_params(cfg: MoEConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """GPT-2's initialisation, then normal(0.02) expert and gate weights
    (the expert outputs scaled by 1/sqrt(2*n_layer)) from a
    ``torch.Generator`` seeded with ``seed + 1000``."""
    params = gpt2.init_params(cfg.base, seed, device)
    dev = params["wte"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    d, E, dt = cfg.base.n_embd, cfg.num_experts, cfg.base.dtype
    std = 0.02

    def norm(shape, s):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * s).to(dt)

    for i in range(0, cfg.base.n_layer, cfg.moe_every):
        blk = params[f"h{i}"]
        for name in ("mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b"):
            del blk[name]
        blk["moe_gate_w"] = norm((d, E), std)
        blk["moe_wi"] = norm((E, d, 4 * d), std)
        blk["moe_wo"] = norm((E, 4 * d, d),
                             std / math.sqrt(2 * cfg.base.n_layer))
    return params


def moe_mlp(blk, x, cfg: MoEConfig):
    """Top-2 gated MoE with capacity-limited einsum dispatch (GShard).
    x: [B, T, D] -> [B, T, D]."""
    B, T, D = x.shape
    E = cfg.num_experts
    S = B * T
    C = max(int(cfg.capacity_factor * S * 2 / E), 1)
    dt = cfg.base.dtype
    xf = x.reshape(S, D)

    gate_logits = (xf @ blk["moe_gate_w"]).float()              # [S, E]
    probs = torch.softmax(gate_logits, dim=-1)
    g1, i1 = torch.topk(probs, 2, dim=-1)
    w = g1 / (g1.sum(-1, keepdim=True) + 1e-9)                  # renormalize

    def one_hot_dispatch(idx, gate_w):
        onehot = F.one_hot(idx, E).float()                      # [S, E]
        pos = torch.cumsum(onehot, dim=0) * onehot              # rank in expert
        keep = (pos <= C).float() * onehot
        # A token not routed to an expert has pos 0 there, so slot -1,
        # clamped to 0 here; keep is 0 for it either way.
        pos_clamped = torch.clamp(pos - 1, min=0, max=C - 1).long()
        cap_oh = F.one_hot(pos_clamped, C).float()
        return keep[..., None] * cap_oh, keep * gate_w[:, None]

    d1, k1 = one_hot_dispatch(i1[:, 0], w[:, 0])
    d2, k2 = one_hot_dispatch(i1[:, 1], w[:, 1])
    dispatch = d1 + d2                                          # [S, E, C]
    combine = d1 * k1.sum(-1)[:, None, None] + d2 * k2.sum(-1)[:, None, None]

    xin = torch.einsum("sec,sd->ecd", dispatch.to(dt), xf)
    h = torch.einsum("ecd,edf->ecf", xin, blk["moe_wi"])
    h = activations.gelu_tanh(h)
    hout = torch.einsum("ecf,efd->ecd", h, blk["moe_wo"])
    out = torch.einsum("sec,ecd->sd", combine.to(dt), hout)
    return out.reshape(B, T, D)


def forward(params, tokens, cfg: MoEConfig):
    """tokens: int [B, T] -> logits [B, T, vocab] (fp32)."""
    base = cfg.base
    x = gpt2._embed(params, tokens, base)
    for i in range(base.n_layer):
        blk = params[f"h{i}"]
        x = x + attention(blk, _layer_norm(x, blk["ln1_g"], blk["ln1_b"]),
                          base)
        h_in = _layer_norm(x, blk["ln2_g"], blk["ln2_b"])
        if "moe_gate_w" in blk:
            x = x + moe_mlp(blk, h_in, cfg)
        else:
            x = x + gpt2.mlp(blk, h_in)
    x = _layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    return (x @ params["wte"].T).float()


def loss_fn(params, tokens, cfg: MoEConfig):
    """Next-token cross entropy over shifted tokens."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (logz - gold).mean()
