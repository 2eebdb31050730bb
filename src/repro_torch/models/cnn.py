"""The paper's image models, a CIFAR-scale CNN and a MedMNIST-scale
classifier (§5.2), mirroring ``repro/models/cnn.py``.

Parameters are a ``dict[str, Tensor]`` in the reference layouts: conv
weights HWIO and dense weights ``[in, out]``, inputs NHWC.  Compression
blocks run along each leaf's last dim, so keeping these layouts keeps every
block, scale and top-k threshold on the same elements as the reference;
the layout change to PyTorch's NCHW happens at the conv call.

Where clients train lane-exact (``common.lane_exact``: on the CPU) the 3x3
convolution is an im2col and one matrix product (``_conv3x3``), not
``F.conv2d``: under the engines' ``vmap`` over stacked clients,
``F.conv2d`` becomes a grouped convolution whose per-group result (the
weight gradient most) depends on the group count, so a client's update
would depend on how many clients share its bucket.  A batched matrix
product computes each lane alike whatever the lane count (from two lanes
on, ``core.round.MIN_LANES``).  On the card ``F.conv2d`` stays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.common import lane_exact


@dataclass(frozen=True)
class CNNConfig:
    name: str
    in_shape: tuple          # (H, W, C)
    num_classes: int
    channels: tuple = (32, 64)
    dense: int = 256


CIFAR_CNN = CNNConfig("paper-cifar-cnn", (32, 32, 3), 10)
MEDMNIST_CNN = CNNConfig("paper-medmnist-cnn", (28, 28, 1), 9,
                         channels=(16, 32), dense=128)


def _conv3x3(x, w_hwio, b):
    """SAME 3x3 convolution, stride 1: x [B, C, H, W] NCHW, w HWIO -> NCHW.
    The patches are the zero-padded input's nine shifted views, stacked in
    ``F.unfold``'s (C, kh, kw) order (plain indexing: cheaper than
    ``F.unfold`` under ``vmap``, and so is its backward), against the
    weight taken to [C*3*3, C_out] in that order."""
    B, _, H, W = x.shape
    kh, kw, c_in, c_out = w_hwio.shape
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
    cols = torch.stack([xp[:, :, i:i + H, j:j + W] for i in range(kh)
                        for j in range(kw)], dim=2)     # [B, C, kh*kw, H, W]
    cols = cols.reshape(B, c_in * kh * kw, H * W)
    wm = w_hwio.permute(2, 0, 1, 3).reshape(c_in * kh * kw, c_out)
    out = cols.transpose(1, 2) @ wm + b                  # [B, H*W, C_out]
    return out.transpose(1, 2).reshape(B, c_out, H, W)


def _conv_library(x, w_hwio, b):
    """The same convolution as ``F.conv2d`` (cuDNN's on the card)."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=1)


def _conv(x, w_hwio, b):
    """``_conv3x3`` where clients train lane-exact, else ``_conv_library``
    (module docstring)."""
    conv = _conv3x3 if lane_exact(x) else _conv_library
    return conv(x, w_hwio, b)


class CNN:
    def __init__(self, cfg: CNNConfig):
        self.cfg = cfg

    def shapes(self) -> dict:
        """Leaf name -> shape, in the reference's parameter order."""
        cfg = self.cfg
        c_in = cfg.in_shape[-1]
        h, w = cfg.in_shape[:2]
        out = {}
        for i, c_out in enumerate(cfg.channels):
            out[f"conv{i}_w"] = (3, 3, c_in, c_out)
            out[f"conv{i}_b"] = (c_out,)
            c_in = c_out
            h, w = h // 2, w // 2
        out["dense1_w"] = (h * w * c_in, cfg.dense)
        out["dense1_b"] = (cfg.dense,)
        out["dense2_w"] = (cfg.dense, cfg.num_classes)
        out["dense2_b"] = (cfg.num_classes,)
        return out

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """Random params with the reference's distributions (``ParamBuilder``):
        conv weights N(0, 0.1^2), dense weights N(0, 1/fan_in) with fan_in =
        shape[-2], zero biases.  Draws come from ``generator`` on its own
        device, in the reference's order; the dict is in sorted-key order."""
        params = {}
        for name, shape in self.shapes().items():
            if name.endswith("_b"):
                params[name] = torch.zeros(shape, device=device)
                continue
            scale = 0.1 if name.startswith("conv") else \
                1.0 / math.sqrt(max(shape[-2], 1))
            draw = torch.randn(shape, generator=generator,
                               device=generator.device)
            params[name] = (draw * scale).to(device)
        return {k: params[k] for k in sorted(params)}

    def apply(self, params: dict, x):
        """x: [B, H, W, C] -> logits [B, num_classes]."""
        x = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        for i in range(len(self.cfg.channels)):
            x = _conv(x, params[f"conv{i}_w"], params[f"conv{i}_b"])
            x = F.max_pool2d(F.relu(x), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
        x = F.relu(x @ params["dense1_w"] + params["dense1_b"])
        return x @ params["dense2_w"] + params["dense2_b"]

    def loss_fn(self, params: dict, batch: dict):
        logits = self.apply(params, batch["image"])
        labels = batch["label"].long()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[:, None])[:, 0]
        loss = (lse - picked).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc}

    def accuracy(self, params: dict, batch: dict):
        logits = self.apply(params, batch["image"])
        return (logits.argmax(-1) == batch["label"].long()).float().mean()
