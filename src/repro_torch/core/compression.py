"""Communication-efficient update compression (paper §4.3), mirroring
``repro/core/compression.py``.

Three techniques, applied to model-update dicts before aggregation:
  * gradient quantization   — blockwise symmetric int8/int4 with per-block
                              scales (optionally stochastic rounding),
  * update sparsification   — per-block magnitude top-k,
  * federated dropout       — structured random neuron (output-column) masks.

All are straight-through: compress(x) returns the decompressed value the
server would reconstruct, while ``payload_bytes()`` accounts for the bytes
the transfer would need.  ``use_kernels=True`` routes top-k and the
deterministic quantize through the CUDA kernels (``kernels/ops``).

Randomness comes from a ``torch.Generator``: each draw is made on the
generator's own device and moved to the data's, so a CPU generator gives
the same compression on the CPU and on the card.  ``batch_dims`` leading
dims are slots of a stacked update: blocks and top-k are per row anyway,
and federated dropout draws one column mask per slot.  A stack whose slots
are a share of a longer one (split over a mesh), or a leaf that is a share
of a whole one (cut over ``data`` and ``model`` at rest, its blocks whole:
``core.pipeline.block_aligned``), draws over the whole and keeps its share
(a cut, ``models.sharding.shard_cut``'s form), so that a split commit
draws what the unsplit one does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.launch import memory
from repro_torch.models import sharding as sh
from repro_torch.pytree import ordered


@dataclass(frozen=True)
class CompressionConfig:
    quantize_bits: int = 0        # 0 (off) | 8 | 4
    stochastic_rounding: bool = True
    topk_frac: float = 0.0        # fraction of entries KEPT per block (0 = off)
    dropout_frac: float = 0.0     # fraction of output neurons dropped (0 = off)
    block: int = 256              # quant/top-k block length
    use_kernels: bool = False     # CUDA kernels for the per-slot hot loops
    use_fused: bool = True        # fuse the commit path (compress + discount
    #                               + accumulate in one pass, kernels/fused_*)

    @property
    def enabled(self) -> bool:
        return bool(self.quantize_bits or self.topk_frac or self.dropout_frac)

    @property
    def topk_k(self) -> int:
        """Entries KEPT per block under topk_frac (0 = top-k off)."""
        if not self.topk_frac:
            return 0
        return max(1, int(np.ceil(self.topk_frac * self.block)))


def _rand(shape, generator: torch.Generator, device, cut=()):
    """Uniform [0, 1) draws made on the generator's device.  ``cut``
    (``sharding.shard_cut``'s form) marks ``shape`` as a share of a whole
    (slots split over a mesh, a leaf cut at rest): the whole is drawn, as
    every process of the split draws it, and the share kept before it
    moves to ``device``, so each process holds its share of the unsplit
    draws.  On ``meta`` (the dry run) the draws are a ``meta`` tensor of
    the share's shape, and the generator is left as it is."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), device="meta")
    return memory.drawn(lambda: sh.take_share(torch.rand(
        sh.whole_shape(shape, cut), generator=generator,
        device=generator.device), cut), generator, device)


# ---------------------------------------------------------------------------
# blockwise helpers: blocks along the LAST dimension, zero padded
# ---------------------------------------------------------------------------

def _to_blocks(x, block):
    """[..., L] -> ([..., nb, block] float32, pad)."""
    L = x.shape[-1] if x.ndim else 1
    x = x.reshape(tuple(x.shape) or (1,)).to(torch.float32)
    pad = (-L) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (L + pad) // block, block), pad


def _from_blocks(blocks, pad, shape, dtype):
    y = blocks.reshape(*blocks.shape[:-2], -1)
    if pad:
        y = y[..., :-pad]
    return y.reshape(shape).to(dtype)


def quantize_dequant(x, bits: int, block: int = 256, generator=None,
                     stochastic: bool = True, use_kernel: bool = False,
                     cut=()):
    """Blockwise symmetric quantization round-trip (``cut``: ``_rand``'s,
    in ``x``'s dims, for the stochastic rounding of a share: a cut of the
    last dim cuts whole blocks)."""
    if use_kernel and not stochastic:
        from repro_torch.kernels import ops as kops
        return kops.quantize_dequant(x, bits=bits, block=block)
    b, pad = _to_blocks(x, block)
    qmax = 2.0 ** (bits - 1) - 1
    scale = _ref.block_scale(b, qmax)
    y = b / scale
    if stochastic and generator is not None:
        y = torch.floor(y + _rand(y.shape, generator, y.device, cut))
    else:
        y = torch.round(y)
    y = torch.clamp(y, -qmax - 1, qmax) * scale
    return _from_blocks(y, pad, x.shape, x.dtype)


def topk_sparsify(x, frac: float, block: int = 256, use_kernel: bool = False):
    """Keep the top ceil(frac*block) entries by |magnitude| per block."""
    k = max(1, int(np.ceil(frac * block)))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.topk_sparsify(x, k=k, block=block)
    b, pad = _to_blocks(x, block)
    return _from_blocks(_ref.topk_blocks(b, k), pad, x.shape, x.dtype)


def federated_dropout(x, frac: float, generator, batch_dims: int = 0,
                      cut=()):
    """Drop a random ``frac`` of output neurons (last dim), rescale the
    rest; one mask per slot over ``batch_dims`` leading slot dims
    (``cut``: ``_rand``'s, in ``x``'s dims, for a share; the mask has only
    the slot dims and the last)."""
    if x.ndim - batch_dims < 2:
        return x
    shape = (tuple(x.shape[:batch_dims]) + (1,) * (x.ndim - batch_dims - 1)
             + (x.shape[-1],))
    cut = tuple(c for c in cut if c[0] < batch_dims or c[0] == x.ndim - 1)
    keep = _rand(shape, generator, x.device, cut) < (1.0 - frac)
    return torch.where(keep, x / (1.0 - frac), torch.zeros_like(x)).to(x.dtype)


# ---------------------------------------------------------------------------
# tree-level API (trees are dict[str, Tensor], walked in jax.tree order)
# ---------------------------------------------------------------------------

def compress_tree(tree: dict, cfg: CompressionConfig, generator,
                  batch_dims: int = 0, cut=(), shares=None) -> dict:
    """Straight-through compression of an update dict.  ``cut``: the slot
    dims' share of a longer stack (slots split over a mesh,
    ``sharding.shard_cut``); ``shares``: ``{leaf: cut}`` in the leaf's own
    dims for the leaves that are shares of whole ones
    (``sharding.leaf_shares``).  Each draw is made one leaf at a time over
    the whole and cut to the share, so it is the share of the unsplit
    draw."""
    if not cfg.enabled:
        return tree
    shares = shares or {}
    out = {}
    for name in ordered(tree):
        leaf = tree[name]
        y = leaf
        share = tuple(cut) + tuple((batch_dims + d, i, n)
                                   for d, i, n in shares.get(name, ()))
        if cfg.dropout_frac:
            y = federated_dropout(y, cfg.dropout_frac, generator, batch_dims,
                                  share)
        if cfg.topk_frac:
            y = topk_sparsify(y, cfg.topk_frac, cfg.block,
                              use_kernel=cfg.use_kernels)
        if cfg.quantize_bits:
            y = quantize_dequant(y, cfg.quantize_bits, cfg.block,
                                 generator=generator,
                                 stochastic=cfg.stochastic_rounding,
                                 use_kernel=cfg.use_kernels, cut=share)
        out[name] = y.to(leaf.dtype)
    return out


def payload_bytes(tree: dict, cfg: Optional[CompressionConfig]) -> int:
    """Bytes one client's update costs on the wire under `cfg`.

    Uncompressed: dtype bytes per element.  Quantized: bits/8 per element +
    one f32 scale per block.  Top-k: only k entries (+4-byte indices) per
    block survive.  Dropout removes a frac of columns entirely.
    """
    total = 0
    for name in ordered(tree):
        leaf = tree[name]
        n = int(np.prod(tuple(leaf.shape)))
        itemsize = leaf.element_size()
        if cfg is None or not cfg.enabled:
            total += n * itemsize
            continue
        frac_cols = 1.0 - (cfg.dropout_frac if leaf.ndim >= 2 else 0.0)
        n_eff = n * frac_cols
        if cfg.topk_frac:
            k = max(1, int(np.ceil(cfg.topk_frac * cfg.block)))
            per_entry_bits = (cfg.quantize_bits or itemsize * 8) + 32  # + index
            n_blocks = np.ceil(n_eff / cfg.block)
            total += int(n_blocks * k * per_entry_bits / 8 + n_blocks * 4)
        elif cfg.quantize_bits:
            n_blocks = np.ceil(n_eff / cfg.block)
            total += int(n_eff * cfg.quantize_bits / 8 + n_blocks * 4)
        else:
            total += int(n_eff * itemsize)
    return total
