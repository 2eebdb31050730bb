"""One-pass plain commit over a blocked slot stack: per-slot per-block
top-k, then per-slot per-block symmetric quantize, then the
staleness-discounted weighted sum over slots.

Replaces the Pallas kernel
``repro/kernels/fused_quant_mask.py:plain_commit_blocks`` (body
``_plain_kernel``, threshold ``topk_threshold_mask``).  The CUDA kernel is
``plain_commit`` in ``csrc/commit_kernels.cu``, whose note gives its bound
on the card and its design.  The secure half of the reference module
(``secure_commit_blocks``) belongs to the secure-aggregation slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launches, ref

NAME = "plain_commit"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]


def plain_commit_blocks(xb, w, s, alpha: float, *, bits: int, k: int):
    """xb: [K, R, block] f32; w, s: [K] f32 -> [R, block] f32 reduced rows.
    ``bits`` 0 skips the quantize, ``k`` 0 skips the top-k."""
    launches.check_shapes(NAME, xb, 3, w, s)
    K, R, block = xb.shape
    if launches.on_cpu(xb, w, s):
        return ref.fused_plain_commit_ref(xb, w.reshape(K, 1), s.reshape(K, 1),
                                          alpha, bits, k=k)
    from repro_torch.kernels import _build
    launches.check_operands(NAME, xb, w, s)
    out = torch.empty((R, block), dtype=torch.float32, device=xb.device)
    _build.launch(NAME, _ARGTYPES, xb.data_ptr(), w.data_ptr(), s.data_ptr(),
                  float(alpha), out.data_ptr(), K, R, block, bits, k,
                  device=xb.device)
    launches.count(NAME)
    return out
