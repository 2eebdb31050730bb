"""One chunk of Mamba's selective scan, mirroring
``repro/kernels/selective_scan.py``:

    h_t = a_t * h_{t-1} + b_t   over the chunk's L steps

Replaces the Pallas kernel ``selective_scan_chunk_kernel`` (body
``_kernel``).  The CUDA kernel is ``selective_scan`` in
``csrc/selective_scan.cu``, whose note gives its bound on the card and its
design.  ``a`` and ``b`` may be chunk views of a whole ``[B, S, D, N]``
tensor: each batch row must be contiguous, and the batch strides go to the
kernel as they are, so no chunk is copied.

``selective_scan_chunk_bwd_blocks`` is the scan's backward, the kernel
``selective_scan_bwd`` of the same library (the reference's custom VJP
``_ss_bwd``, a reverse-time recurrence with no Pallas kernel); its ``a``,
``hs`` and ``g_hs`` are taken with their batch strides in the same way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launches, ref

NAME = "selective_scan"
BWD_NAME = "selective_scan_bwd"


def rows_contiguous(t) -> bool:
    """Each batch row of ``t`` [B, L, D, N] is one contiguous block."""
    _, L, D, N = t.shape
    return not (L > 1 and t.stride(1) != D * N or D > 1 and t.stride(2) != N
                or N > 1 and t.stride(3) != 1)


def _check_row_major(t, what, name=NAME):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 {what}, got {t.dtype}")
    if not rows_contiguous(t):
        raise ValueError(f"{name}: {what} is not contiguous within a batch "
                         f"row (strides {t.stride()})")


def selective_scan_chunk_blocks(a, b, h0):
    """a, b: [B, L, D, N] f32; h0: [B, D, N] f32.
    Returns (hs [B, L, D, N], h_last [B, D, N]) f32."""
    if a.ndim != 4 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                          *a.shape[2:]):
        raise ValueError(f"{NAME}: expected a, b [B, L, D, N] and h0 "
                         f"[B, D, N], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    if launches.on_cpu(a, b, h0):
        return ref.selective_scan_chunk_ref(a, b, h0)
    from repro_torch.kernels import _build
    _check_row_major(a, "a")
    _check_row_major(b, "b")
    launches.check_operands(NAME, h0)
    B, L, D, N = a.shape
    hs = torch.empty((B, L, D, N), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    _build.launch("selective_scan", NAME, a.data_ptr(),
                  b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
                  h_last.data_ptr(), B, L, D * N, a.stride(0), b.stride(0),
                  device=a.device)
    launches.count(NAME)
    return hs, h_last


def selective_scan_chunk_bwd_blocks(a, hs, h0, g_hs, g_hl=None):
    """a, hs, g_hs: [B, L, D, N] f32; h0 and ``g_hl`` (None: no gradient
    reached the last state): [B, D, N] f32.  Returns (ga, gb [B, L, D, N],
    gh0 [B, D, N]) f32."""
    lanes = (a.shape[0], *a.shape[2:])
    if a.ndim != 4 or hs.shape != a.shape or g_hs.shape != a.shape \
            or h0.shape != lanes or g_hl is not None and g_hl.shape != lanes:
        raise ValueError(f"{BWD_NAME}: expected a, hs, g_hs [B, L, D, N] "
                         f"and h0, g_hl [B, D, N], got {tuple(a.shape)}, "
                         f"{tuple(hs.shape)}, {tuple(h0.shape)}, "
                         f"{tuple(g_hs.shape)}, "
                         f"{None if g_hl is None else tuple(g_hl.shape)}")
    rest = () if g_hl is None else (g_hl,)
    if launches.on_cpu(a, hs, h0, g_hs, *rest):
        return ref.selective_scan_chunk_bwd_ref(a, hs, h0, g_hs, g_hl)
    from repro_torch.kernels import _build
    for t, what in ((a, "a"), (hs, "hs"), (g_hs, "g_hs")):
        _check_row_major(t, what, BWD_NAME)
    launches.check_operands(BWD_NAME, h0, *rest)
    B, L, D, N = a.shape
    ga = torch.empty((B, L, D, N), dtype=torch.float32, device=a.device)
    gb = torch.empty((B, L, D, N), dtype=torch.float32, device=a.device)
    gh0 = torch.empty((B, D, N), dtype=torch.float32, device=a.device)
    _build.launch("selective_scan", BWD_NAME, a.data_ptr(), hs.data_ptr(),
                  h0.data_ptr(), g_hs.data_ptr(),
                  None if g_hl is None else g_hl.data_ptr(), ga.data_ptr(),
                  gb.data_ptr(), gh0.data_ptr(), B, L, D * N, a.stride(0),
                  hs.stride(0), g_hs.stride(0), device=a.device)
    launches.count(BWD_NAME)
    return ga, gb, gh0
