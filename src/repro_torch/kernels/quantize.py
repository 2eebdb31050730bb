"""Blockwise symmetric quantize -> dequantize over [R, block] rows.

Replaces the Pallas kernel ``repro/kernels/quantize.py:
quantize_dequant_blocks`` (body ``_kernel``).  The CUDA kernel is
``quantize_rows`` in ``csrc/commit_kernels.cu``, whose note gives its bound
on the card and its design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launches, ref

NAME = "quantize"


def quantize_dequant_blocks(xb, bits: int):
    """xb: [R, block] f32 -> the same shape, each row quantized onto its own
    symmetric int{bits} grid and dequantized."""
    launches.check_shapes(NAME, xb, 2)
    if launches.on_cpu(xb):
        return ref.quantize_blocks(xb.to(torch.float32), bits)
    from repro_torch.kernels import _build
    launches.check_operands(NAME, xb)
    R, block = xb.shape
    out = torch.empty_like(xb)
    _build.launch("commit_kernels", "quantize_rows", xb.data_ptr(),
                  out.data_ptr(), R, block, bits, device=xb.device)
    launches.count(NAME)
    return out
