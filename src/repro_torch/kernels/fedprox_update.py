"""Fused FedProx local SGD update over a client-stacked leaf, mirroring
``repro/kernels/fedprox_update.py``:

    w <- w - lr * (g + mu * (w - w0))

Replaces the Pallas kernel ``fedprox_update_flat`` (body ``_kernel``).  The
CUDA kernel is ``fedprox_update`` in ``csrc/fedprox_update.cu``, whose note
gives its bound on the card and its design: ``w`` and ``g`` are [C, N] (C
clients' copies of one leaf), ``w0`` is the [N] global leaf that every
client reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launches, ref

NAME = "fedprox_update"


def fedprox_update_flat(w, g, w0, lr: float, mu: float):
    """w, g: [C, N] f32; w0: [N] f32 -> [C, N] f32."""
    if w.ndim != 2 or g.shape != w.shape or tuple(w0.shape) != (w.shape[1],):
        raise ValueError(f"{NAME}: expected w, g [C, N] and w0 [N], got "
                         f"{tuple(w.shape)}, {tuple(g.shape)}, "
                         f"{tuple(w0.shape)}")
    if launches.on_cpu(w, g, w0):
        return ref.fedprox_update_ref(w, g, w0[None], lr, mu)
    from repro_torch.kernels import _build
    launches.check_operands(NAME, w, g, w0)
    C, N = w.shape
    out = torch.empty_like(w)
    _build.launch("fedprox_update", NAME, w.data_ptr(),
                  g.data_ptr(), w0.data_ptr(), out.data_ptr(), float(lr),
                  float(mu), C, N, device=w.device)
    launches.count(NAME)
    return out
