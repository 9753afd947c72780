"""Wide-ResNet in PyTorch: the port of ``tepdist_tpu/models/wide_resnet.py``
(model_type 0-6, 250M-13B parameters).

The parameter tree is the JAX package's, layouts included: HWIO conv
kernels, per-block ``shortcut`` a 1x1 kernel or ``None`` (an empty subtree:
no leaf), so weights and checkpoints cross leaf for leaf. Activations are
NHWC as there; ``_conv`` hands them to the convolution as a channels-last
NCHW view (no copy) and the kernel as OIHW. The norm is the JAX model's
batch-stat-free per-image, per-channel normalisation over H and W.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from tepdist_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WRNConfig:
    depth_per_stage: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 128
    widen: int = 2
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16


CONFIGS: Dict[int, WRNConfig] = {
    0: WRNConfig(width=128, widen=2),      # ~250M
    1: WRNConfig(width=192, widen=2),
    2: WRNConfig(width=256, widen=2),      # ~1B
    3: WRNConfig(width=320, widen=2),
    4: WRNConfig(width=384, widen=3),      # ~4B
    5: WRNConfig(width=448, widen=3),
    6: WRNConfig(width=512, widen=4),      # ~13B
    -1: WRNConfig(depth_per_stage=(1, 1), width=16, widen=1, num_classes=10,
                  dtype=torch.float32),    # test config
}


def init_params(cfg: WRNConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Kernels normal(1/sqrt(fan_in)) from a ``torch.Generator`` seeded
    with ``seed``; unit gains, zero biases."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv_init(shape):
        fan_in = math.prod(shape[:-1])
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(cfg.dtype)

    def vec(value, n):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    c = cfg.width
    params: Dict[str, Any] = {"stem": conv_init((7, 7, 3, c))}
    for s, depth in enumerate(cfg.depth_per_stage):
        cout = c * (2 ** s) * cfg.widen
        cin = c if s == 0 else c * (2 ** (s - 1)) * cfg.widen
        for b in range(depth):
            ci = cin if b == 0 else cout
            params[f"s{s}b{b}"] = {
                "conv1": conv_init((3, 3, ci, cout)),
                "g1": vec(1.0, cout),
                "b1": vec(0.0, cout),
                "conv2": conv_init((3, 3, cout, cout)),
                "g2": vec(1.0, cout),
                "b2": vec(0.0, cout),
                "shortcut": (conv_init((1, 1, ci, cout)) if ci != cout
                             else None),
            }
    c_final = c * (2 ** (len(cfg.depth_per_stage) - 1)) * cfg.widen
    params["fc_w"] = conv_init((c_final, cfg.num_classes))
    params["fc_b"] = torch.zeros((cfg.num_classes,), dtype=cfg.dtype,
                                 device=dev)
    return params


def _norm_act(x, g, b):
    x32 = x.float()
    mu = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.var(dim=(1, 2), keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + 1e-5) * g + b
    return torch.relu(y).to(x.dtype)


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"``: out = ceil(n / stride), the total padding
    split with the odd element after (a 7x7 stride-2 conv on 224 pads 2
    before and 3 after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NHWC ``x``, HWIO ``w`` -> NHWC, stride ``stride``, SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    x = x.permute(0, 3, 1, 2)                       # channels-last NCHW
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def forward(params, images, cfg: WRNConfig):
    """images: [B, H, W, 3] -> logits [B, classes] (fp32)."""
    x = _conv(images.to(cfg.dtype), params["stem"], stride=2)
    for s, depth in enumerate(cfg.depth_per_stage):
        for b in range(depth):
            blk = params[f"s{s}b{b}"]
            stride = 2 if (b == 0 and s > 0) else 1
            h = _conv(x, blk["conv1"], stride)
            h = _norm_act(h, blk["g1"], blk["b1"])
            h = _conv(h, blk["conv2"])
            sc = x if blk["shortcut"] is None else _conv(x, blk["shortcut"],
                                                         stride)
            x = _norm_act(h + sc, blk["g2"], blk["b2"])
    pooled = x.mean(dim=(1, 2)).float()
    return pooled @ params["fc_w"].float() + params["fc_b"].float()


def loss_fn(params, images, labels, cfg: WRNConfig):
    logits = forward(params, images, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[..., 0]
    return (logz - gold).mean()


def fake_batch(cfg: WRNConfig, batch_size: int, image_size: int = 224,
               seed: int = 0, device="cuda"):
    """(images [B, S, S, 3] fp32 normal, labels [B] int64) from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn((batch_size, image_size, image_size, 3),
                         generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (batch_size,), generator=gen,
                           device=dev)
    return images, labels
