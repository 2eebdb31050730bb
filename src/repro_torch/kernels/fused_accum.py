"""Fused staleness-weighted accumulate over a blocked slot stack.

``out = sum_i w_i * (1 + s_i)^(-a) * x_i`` in one pass: each slot is read
once and only the reduced rows are written.  Replaces the Pallas kernel
``repro/kernels/fused_accum.py:fused_accum_blocks`` (body ``_kernel``).
The CUDA kernel is ``fused_accum`` in ``csrc/commit_kernels.cu``, whose
note gives its bound on the card and its design.
"""
from __future__ import annotations

from repro_torch.kernels import launches, ref

NAME = "fused_accum"


def fused_accum_blocks(xb, w, s, alpha: float):
    """xb: [K, R, block] f32; w, s: [K] f32; alpha: the discount exponent.
    Returns the [R, block] f32 discounted weighted sum over slots."""
    K = xb.shape[0]
    launches.check_shapes(NAME, xb, 3, w, s)
    if launches.on_cpu(xb, w, s):
        return ref.fused_accum_ref(xb, w.reshape(K, 1), s.reshape(K, 1), alpha)
    from repro_torch.kernels import _build
    launches.check_operands(NAME, xb, w, s)
    out = xb.new_empty(xb.shape[1:])          # float32, on xb's device
    _build.launch("commit_kernels", NAME, xb.data_ptr(), w.data_ptr(),
                  s.data_ptr(), float(alpha), out.data_ptr(), K, out.numel(),
                  device=xb.device)
    launches.count(NAME)
    return out
