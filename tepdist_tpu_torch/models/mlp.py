"""Smoke-test models in PyTorch: the port of ``tepdist_tpu/models/mlp.py`` —
a ReLU MLP, one causal attention block and a small conv net, each with an
MSE or cross-entropy loss. Parameter trees and layouts (HWIO conv kernel,
NHWC images) are the JAX package's."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.models.wide_resnet import _conv


def _normal(gen, shape, s, dtype, dev):
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return (x * s).to(dtype)


def init_mlp(seed: int = 0, din=32, dh=64, dout=8, depth=2,
             dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dims = [din] + [dh] * (depth - 1) + [dout]
    return {f"w{i}": _normal(gen, (dims[i], dims[i + 1]),
                             1.0 / math.sqrt(dims[i]), dtype, dev)
            for i in range(depth)}


def mlp_loss(params, x, y):
    h = x
    n = len(params)
    for i in range(n):
        h = h @ params[f"w{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return ((h - y) ** 2).mean()


def init_attention(seed: int = 0, d=64, heads=4, dtype=torch.float32,
                   device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = 1.0 / math.sqrt(d)
    return {"qkv": _normal(gen, (d, 3 * d), s, dtype, dev),
            "proj": _normal(gen, (d, d), s, dtype, dev)}


def attention_loss(params, x, y, heads=4):
    """One causal attention block + MSE. ``heads`` is static."""
    B, T, D = x.shape
    H = heads
    hd = D // H
    qkv = x @ params["qkv"]
    q, k, v = qkv.split(D, dim=-1)
    q = q.reshape(B, T, H, hd).transpose(1, 2)
    k = k.reshape(B, T, H, hd).transpose(1, 2)
    v = v.reshape(B, T, H, hd).transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    probs = torch.softmax(torch.where(mask, logits, torch.full_like(
        logits, -1e9)), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    o = o.transpose(1, 2).reshape(B, T, D)
    out = o @ params["proj"]
    return ((out - y) ** 2).mean()


def init_conv(seed: int = 0, cin=3, cout=16, dtype=torch.float32,
              device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"conv_w": _normal(gen, (3, 3, cin, cout), 0.1, dtype, dev),
            "fc": _normal(gen, (cout, 10), 0.1, dtype, dev)}


def conv_loss(params, x, y):
    """Conv + pool + fc. x: [B, H, W, C] (NHWC), y: int labels [B]."""
    h = torch.relu(_conv(x, params["conv_w"]))
    h = h.mean(dim=(1, 2))
    logits = h @ params["fc"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y.long()[:, None])[..., 0]
    return (logz - gold).mean()
