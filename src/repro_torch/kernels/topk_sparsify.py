"""Per-row magnitude top-k over [R, block] rows: keep every entry whose |x|
is >= the k-th largest |x| of its row (ties kept), zero the rest.

Replaces the Pallas kernel ``repro/kernels/topk_sparsify.py:
topk_sparsify_blocks`` (body ``_kernel``).  That kernel bisects on values
for 32 steps; the CUDA kernel ``topk_rows`` in ``csrc/commit_kernels.cu``
selects on the bits of |x| instead (``digit_select`` in ``row_ops.cuh``:
the top exponent digit by warp reductions, one bit at a time while more
than 32 candidates are left, then the last candidates ranked against each
other), which gives the sort threshold of the plain version exactly.  One
warp per row with streaming loads and stores; bound by the bytes it moves,
one read and one write of the rows, since the selects' instructions
overlap the other warps' loads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launches, ref

NAME = "topk_sparsify"


def topk_sparsify_blocks(xb, k: int):
    """xb: [R, block] f32 -> the same shape, top-k per row kept."""
    launches.check_shapes(NAME, xb, 2)

    def prepare():
        launches.check_operands(NAME, xb)
        return torch.empty_like(xb), ()
    if launches.on_cpu(xb):
        return launches.plain(xb.device, lambda: ref.topk_blocks(
            xb.to(torch.float32), k), prepare)
    from repro_torch.kernels import _build
    R, block = xb.shape
    out, _ = prepare()
    _build.launch("commit_kernels", "topk_rows", xb.data_ptr(),
                  out.data_ptr(), R, block, k, device=xb.device)
    launches.count(NAME)
    return out
