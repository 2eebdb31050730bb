"""Plain PyTorch versions of the commit-path kernels (the correctness
contract), mirroring ``repro/kernels/ref.py``.

A CPU tensor takes these in every kernel wrapper; on the card
``chip_smoke.py`` holds each CUDA kernel against them.  Top-k uses the sort
threshold with ties kept, as the reference oracle does; rounding is
``torch.round`` (half to even, like ``jnp.round``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _blocks_lastdim(x, block):
    """Shared grouping rule: blocks along the last dim, zero-padded."""
    shape, dtype = x.shape, x.dtype
    L = shape[-1] if x.ndim else 1
    xx = x.reshape(tuple(shape) or (1,)).to(torch.float32)
    pad = (-L) % block
    if pad:
        xx = F.pad(xx, (0, pad))
    return xx.reshape(*xx.shape[:-1], -1, block), pad, shape, dtype


def _unblocks(b, pad, shape, dtype):
    y = b.reshape(*b.shape[:-2], -1)
    if pad:
        y = y[..., :-pad]
    return y.reshape(shape).to(dtype)


def quantize_blocks(b, bits: int):
    """Per-block (last dim) symmetric quantize -> dequantize."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = block_scale(b, qmax)
    return torch.clamp(torch.round(b / scale), -qmax - 1, qmax) * scale


def block_scale(b, qmax: float):
    """Per-block scale ``max|b| / qmax``, with a zero scale made 1.  The
    divisor is a tensor so that CUDA divides too: with a Python-number
    divisor PyTorch multiplies by its reciprocal there, one ulp off the
    kernels' and the CPU's IEEE division."""
    amax = b.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, qmax)
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def topk_blocks(b, k: int):
    """Per-block (last dim) top-k by magnitude: keep |x| >= the k-th largest
    |x|, ties kept."""
    mag = b.abs()
    thresh = torch.sort(mag, dim=-1, descending=True).values[..., k - 1:k]
    return torch.where(mag >= thresh, b, torch.zeros_like(b))


def quantize_dequant_ref(x, bits: int, block: int = 256):
    """Deterministic blockwise symmetric quantization round-trip."""
    b, pad, shape, dtype = _blocks_lastdim(x, block)
    return _unblocks(quantize_blocks(b, bits), pad, shape, dtype)


def topk_sparsify_ref(x, k: int, block: int = 256):
    """Keep entries with |x| >= (k-th largest magnitude) per block."""
    b, pad, shape, dtype = _blocks_lastdim(x, block)
    return _unblocks(topk_blocks(b, k), pad, shape, dtype)


def slot_weights(w, s, alpha):
    """``w_i * (1 + s_i)^(-alpha)``, the FedBuff-discounted slot weights."""
    return w.to(torch.float32) * (1.0 + s.to(torch.float32)) ** (-alpha)


def fused_accum_ref(xb, w, s, alpha):
    """Plain version of the fused accumulate over a blocked [K, R, block]
    stack: ``sum_i w_i * (1 + s_i)^(-alpha) * x_i``.  w, s are [K, 1]."""
    w_eff = slot_weights(w, s, alpha)
    return (xb.to(torch.float32) * w_eff[:, :, None]).sum(0)


def fused_plain_commit_ref(xb, w, s, alpha, bits: int, k: int = 0):
    """Plain version of the one-pass commit over the blocked [K, R, block]
    stack: per-slot top-k -> per-slot per-block symmetric quantize ->
    staleness-discounted weighted sum over slots."""
    x = xb.to(torch.float32)
    if k:
        x = topk_blocks(x, k)
    if bits:
        x = quantize_blocks(x, bits)
    return fused_accum_ref(x, w, s, alpha)
