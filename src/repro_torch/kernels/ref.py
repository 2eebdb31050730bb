"""Plain PyTorch versions of the port's kernels (the correctness contract),
mirroring ``repro/kernels/ref.py`` and the PRF of
``repro/kernels/fused_quant_mask.py``.

A CPU tensor takes these in every kernel wrapper; on the card
``chip_smoke.py`` holds each CUDA kernel against them.  Top-k uses the sort
threshold with ties kept, as the reference oracle does; rounding is
``torch.round`` (half to even, like ``jnp.round``).

uint32 arithmetic (the secure commit's mask PRF) is computed in int64
tensors that hold values in [0, 2^32), reduced with ``& 0xFFFFFFFF`` after
every step; a product is split into 16-bit halves so that no int64
intermediate overflows.
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


# ---------------------------------------------------------------------------
# uint32 mask PRF of the integer-domain secure commit (int64 holding uint32)
# ---------------------------------------------------------------------------

U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9             # element-index mixing constant


def mul_u32(a, b):
    """``a * b mod 2^32`` for int64 tensors (or ints) holding uint32
    values; ``b`` split into 16-bit halves keeps every product < 2^49."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def hash_u32(x):
    """"lowbias32"-style avalanche hash, uint32 -> uint32."""
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def to_u32(x):
    """Any integer tensor -> int64 holding its two's-complement uint32."""
    return x.to(torch.int64) & U32


def u32_to_i32(x):
    """int64 holding uint32 -> the same bits read as int32 (an int64 value
    in [-2^31, 2^31))."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def mask_total_u32(seeds_row, coef_row, idx):
    """Slot i's summed pairwise masks over its K peers, uint32 modular:
    ``sum_j coef[j] * hash_u32(idx * GOLDEN + seed[j])``.  ``idx`` is the
    [rows, block] global element index; the coefficients enter as
    two's-complement uint32, so the signed sum is exact under wraparound."""
    cu = to_u32(coef_row)
    bits = hash_u32((mul_u32(to_u32(idx)[None], GOLDEN)
                     + to_u32(seeds_row)[:, None, None]) & U32)
    return mul_u32(cu[:, None, None], bits).sum(0) & U32


def fold_mask_words(seeds, coef):
    """The mask words of a whole [K, K] commit that do not cancel, as
    (seeds, net coefficients), int64 holding uint32, in row-major order of
    the entries that carry them.  A word depends only on its seed, so entry
    (i, j), i < j, takes in (j, i) when their seeds are equal (net
    ``c_ij + c_ji``, and (j, i) is dropped); a diagonal entry and every
    other entry stand alone; a word whose net is 0 mod 2^32 is dropped.
    Exact for any seeds and coefficients: ``mask_total_u32`` over the
    folded words equals the sum over i of ``mask_total_u32(seeds[i],
    coef[i], idx)`` under wraparound.  The plain version of the secure
    commit kernel's prologue; the commit's plain version does not use it."""
    s, c = to_u32(seeds), to_u32(coef)
    K = s.shape[0]
    i = torch.arange(K, device=s.device)[:, None]
    j = torch.arange(K, device=s.device)[None, :]
    merged = (s == s.T) & (i != j)
    net = torch.where(merged, (c + c.T) & U32, c)
    keep = (net != 0) & ~(merged & (i > j))
    return s[keep], net[keep]


def fused_secure_commit_ref(xb, w_eff, seeds, coef, base, bits: int,
                            k: int = 0, noise=None, rows=None):
    """Plain version of the integer-domain secure commit over a blocked
    [K, R, block] stack: per-slot top-k, weighted values quantized onto ONE
    commit-common per-row grid, int32 wire words plus uint32 modular
    pairwise masks, summed with wraparound, dequantized through the common
    scale.  ``w_eff`` is [K, 1]; ``seeds`` [K, K] uint32 values (any integer
    dtype); ``coef`` [K, K] in {-1, 0, +1}; ``base`` the global element
    index of row 0.  ``noise`` ([K, R, block] uniform [0, 1)) switches
    ``round`` to stochastic rounding ``floor(y / scale + u)``.  ``rows``
    (None, or an [R] integer table of each row's global block-row index)
    places row r at element ``base + rows[r] * block`` of the mask stream,
    where it is ``base + r * block`` without one."""
    x = xb.to(torch.float32)
    K, R, block = x.shape
    if k:
        x = topk_blocks(x, k)
    y = x * w_eff.to(torch.float32)[:, :, None]
    qmax = 2.0 ** (bits - 1) - 1
    amax = y.abs().amax(dim=(0, 2), keepdim=True)            # [1, R, 1]
    scale = amax / torch.full_like(amax, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    yq = y / scale
    q = torch.floor(yq + noise) if noise is not None else torch.round(yq)
    qu = to_u32(torch.clamp(q, -qmax - 1, qmax).to(torch.int64))
    if rows is None:
        idx = (int(base) + torch.arange(R * block, dtype=torch.int64,
                                        device=x.device).reshape(R, block))
    else:
        idx = (int(base) + to_u32(rows).to(x.device)[:, None] * block
               + torch.arange(block, dtype=torch.int64, device=x.device))
    idx = idx & U32
    seeds, coef = seeds.to(x.device), coef.to(x.device)
    total = torch.zeros((R, block), dtype=torch.int64, device=x.device)
    for i in range(K):
        total = (total + qu[i] + mask_total_u32(seeds[i], coef[i], idx)) & U32
    return u32_to_i32(total).to(torch.float32) * scale[0]


def fedprox_update_ref(w, g, w0, lr: float, mu: float):
    """``w - lr * (g + mu * (w - w0))`` in float32; ``w0`` broadcasts
    against ``w`` (one global copy for a [C, ...] stack of clients)."""
    wf = w.to(torch.float32)
    return (wf - lr * (g.to(torch.float32)
                       + mu * (wf - w0.to(torch.float32)))).to(w.dtype)


def selective_scan_chunk_ref(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` over the chunk dim (axis 1), one step
    at a time in float32 (one rounding per multiply and per add).
    a, b: [B, L, D, N]; h0: [B, D, N].  Returns (hs [B, L, D, N], h_last
    [B, D, N])."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    h = h0.to(torch.float32)
    hs = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h


def selective_scan_chunk_bwd_ref(a, hs, h0, g_hs, g_hl=None):
    """The scan's backward (the reference's custom VJP ``_ss_bwd``), one
    reverse-time step at a time in float32 with one rounding per multiply
    and per add:

        G_{L-1} = g_hs_{L-1} + g_hl,   G_t = g_hs_t + a_{t+1} * G_{t+1},
        ga_t = G_t * h_{t-1} (h_{-1} = h0),   gb = G,   gh0 = a_0 * G_0.

    a, hs, g_hs: [B, L, D, N]; h0, g_hl: [B, D, N] (``g_hl`` None is
    zero).  Returns (ga, gb [B, L, D, N], gh0 [B, D, N]).  The steps are
    stacked from lists, with no write into a fresh tensor."""
    a, hs = a.to(torch.float32), hs.to(torch.float32)
    h0, g_hs = h0.to(torch.float32), g_hs.to(torch.float32)
    L = a.shape[1]
    G = g_hs[:, L - 1]
    if g_hl is not None:
        G = G + g_hl.to(torch.float32)
    gs = [G]
    for t in range(L - 2, -1, -1):
        G = g_hs[:, t] + a[:, t + 1] * G
        gs.append(G)
    gs.reverse()
    h_prev = [h0] + [hs[:, t] for t in range(L - 1)]
    ga = torch.stack([g * h for g, h in zip(gs, h_prev)], dim=1)
    return ga, torch.stack(gs, dim=1), a[:, 0] * gs[0]
