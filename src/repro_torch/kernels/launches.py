"""Launch counts of the hand-written kernels, and the operand checks every
kernel wrapper runs before it hands pointers to CUDA.

``KERNEL_LAUNCHES[name]`` goes up by one each time a wrapper launches the
kernel ``name`` on the card, and nowhere else: the plain PyTorch version a
CPU (or ``meta``) tensor takes is not a launch.  A run reads the counts to
show which kernels its path went through; ``reset()`` zeroes them.
"""
from __future__ import annotations

from collections import Counter

import torch

KERNEL_LAUNCHES: Counter = Counter()


def count(name: str) -> None:
    KERNEL_LAUNCHES[name] += 1


def reset() -> None:
    KERNEL_LAUNCHES.clear()


def on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU (the plain version runs),
    or on ``meta`` (the plain version runs on shapes alone: the dry run);
    False when every operand lies on one CUDA device (the kernel runs).
    Anything else raises: no operand silently changes device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on several devices: {devices}")
    dev = devices.pop()
    if dev.type in ("cpu", "meta"):
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check_shapes(name: str, blocks, ndim: int, *vectors) -> None:
    """``blocks`` must have ``ndim`` dims, and each slot vector one entry per
    slot (the leading dim of ``blocks``)."""
    if blocks.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-d blocks, got "
                         f"{tuple(blocks.shape)}")
    for v in vectors:
        if tuple(v.shape) != (blocks.shape[0],):
            raise ValueError(f"{name}: slot vector of shape {tuple(v.shape)} "
                             f"for {blocks.shape[0]} slots")


def check_operands(name: str, blocks, *vectors) -> None:
    """Raise on what the kernel does not take: an operand that is not
    contiguous float32, or a ``blocks`` array (which the kernels load as
    float4) that is not 16-byte aligned."""
    for t in (blocks, *vectors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand is not contiguous")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{name}: blocks are not 16-byte aligned")
