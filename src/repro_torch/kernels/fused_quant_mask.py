"""The one-pass commit kernels over a blocked slot stack, mirroring
``repro/kernels/fused_quant_mask.py``.

* ``plain_commit_blocks``: per-slot per-block top-k, then per-slot
  per-block symmetric quantize, then the staleness-discounted weighted sum
  over slots.  Replaces the Pallas kernel ``plain_commit_blocks`` (body
  ``_plain_kernel``); the CUDA kernel is ``plain_commit`` in
  ``csrc/commit_kernels.cu``.
* ``secure_commit_blocks``: per-slot top-k, ONE commit-common per-block
  scale, integer quantize, uint32 modular pairwise masks on the int32 wire
  words, sum, dequantize.  Replaces the Pallas kernel
  ``secure_commit_blocks`` (body ``_secure_kernel``); the CUDA kernel is
  ``secure_commit`` in ``csrc/secure_commit.cu``.  Unlike the Pallas
  kernel it also takes stochastic rounding, through a ``noise`` operand of
  uniform [0, 1) draws, so both rounding modes launch it on the card.

Each CUDA source's note gives its bound on the card and its design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launches, ref

NAME = "plain_commit"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]
SECURE = "secure_commit"
_SECURE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int]


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
    _build.launch("commit_kernels", NAME, _ARGTYPES, xb.data_ptr(),
                  w.data_ptr(), s.data_ptr(), float(alpha), out.data_ptr(), K,
                  R, block, bits, k, device=xb.device)
    launches.count(NAME)
    return out


def secure_commit_blocks(xb, w_eff, seeds, coef, base: int, *, bits: int,
                         k: int, noise=None):
    """xb: [K, R, block] f32; w_eff: [K] f32 effective slot weights; seeds:
    [K, K] uint32 values (int64 holding them, or any integer dtype); coef:
    [K, K] in {-1, 0, +1}; ``base`` the global element index of row 0;
    ``noise`` None (round half to even) or [K, R, block] uniform [0, 1)
    f32 (stochastic rounding).  Returns [R, block] f32."""
    launches.check_shapes(SECURE, xb, 3, w_eff)
    K, R, block = xb.shape
    for m in (seeds, coef):
        if tuple(m.shape) != (K, K):
            raise ValueError(f"{SECURE}: pair matrix of shape "
                             f"{tuple(m.shape)} for {K} slots")
    if noise is not None and noise.shape != xb.shape:
        raise ValueError(f"{SECURE}: noise of shape {tuple(noise.shape)} "
                         f"for blocks {tuple(xb.shape)}")
    extra = () if noise is None else (noise,)
    if launches.on_cpu(xb, w_eff, seeds, coef, *extra):
        return ref.fused_secure_commit_ref(xb, w_eff.reshape(K, 1), seeds,
                                           coef, base, bits, k=k, noise=noise)
    from repro_torch.kernels import _build
    launches.check_operands(SECURE, xb, w_eff)
    if noise is not None:
        launches.check_operands(SECURE, noise)
    # the pair matrices as the kernel reads them: uint32 bits, int32
    seeds32 = ref.u32_to_i32(ref.to_u32(seeds)).to(torch.int32).contiguous()
    coef32 = coef.to(torch.int32).contiguous()
    out = torch.empty((R, block), dtype=torch.float32, device=xb.device)
    _build.launch("secure_commit", SECURE, _SECURE_ARGTYPES, xb.data_ptr(),
                  w_eff.data_ptr(), seeds32.data_ptr(), coef32.data_ptr(),
                  int(base) & ref.U32,
                  None if noise is None else noise.data_ptr(),
                  out.data_ptr(), K, R, block, bits, k, device=xb.device)
    launches.count(SECURE)
    return out
