"""The one-pass commit kernels over a blocked slot stack, mirroring
``repro/kernels/fused_quant_mask.py``.

* ``plain_commit_blocks``: per-slot per-block top-k, then per-slot
  per-block symmetric quantize, then the staleness-discounted weighted sum
  over slots.  Replaces the Pallas kernel ``plain_commit_blocks`` (body
  ``_plain_kernel``); the CUDA kernel is ``plain_commit`` in
  ``csrc/commit_kernels.cu``: one thread block per block-row stages its
  slot rows in shared memory once, selects and quantizes each in place,
  and sums them in slot order.
* ``secure_commit_blocks``: per-slot top-k, ONE commit-common per-block
  scale, integer quantize, uint32 modular pairwise masks on the int32 wire
  words, sum, dequantize.  Replaces the Pallas kernel
  ``secure_commit_blocks`` (body ``_secure_kernel``); the CUDA kernel is
  ``secure_commit`` in ``csrc/secure_commit.cu``, which first folds the
  [K, K] pair seeds and coefficients into the mask words that do not cancel
  (``secure_fold``; its plain version is ``ref.fold_mask_words``).  Unlike
  the Pallas kernel it also takes stochastic rounding, through a ``noise``
  operand of uniform [0, 1) draws, so both rounding modes launch it on the
  card.  An optional row table places each row at its own block-row of
  the commit's mask stream, where the rows are a share of the whole
  bucket (a leaf cut over ``data`` or ``model``).

Both take any number of slots K, as the Pallas kernels do.

Each CUDA source's note gives its bound on the card and its design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launches, ref

NAME = "plain_commit"
SECURE = "secure_commit"


def plain_commit_blocks(xb, w, s, alpha: float, *, bits: int, k: int):
    """xb: [K, R, block] f32; w, s: [K] f32 -> [R, block] f32 reduced rows.
    ``bits`` 0 skips the quantize, ``k`` 0 skips the top-k."""
    launches.check_shapes(NAME, xb, 3, w, s)
    K, R, block = xb.shape

    def prepare():
        launches.check_operands(NAME, xb, w, s)
        return torch.empty((R, block), dtype=torch.float32,
                           device=xb.device), ()
    if launches.on_cpu(xb, w, s):
        return launches.plain(xb.device, lambda: ref.fused_plain_commit_ref(
            xb, w.reshape(K, 1), s.reshape(K, 1), alpha, bits, k=k), prepare)
    from repro_torch.kernels import _build
    out, _ = prepare()
    _build.launch("commit_kernels", NAME, xb.data_ptr(), w.data_ptr(),
                  s.data_ptr(), float(alpha), out.data_ptr(), K, R, block, bits,
                  k, device=xb.device)
    launches.count(NAME)
    return out


def _check_pairs(seeds, coef, K: int) -> None:
    for m in (seeds, coef):
        if tuple(m.shape) != (K, K):
            raise ValueError(f"{SECURE}: pair matrix of shape "
                             f"{tuple(m.shape)} for {K} slots")


def _pair_operands(seeds, coef):
    """The [K, K] pair matrices as the CUDA kernels read them: seeds int64
    (the low 32 bits are the uint32 seed), coefficients int32 (equal mod
    2^32 to any integer ones); no copy when they already are."""
    if seeds.dtype != torch.int64:
        seeds = seeds.to(torch.int64)
    if coef.dtype != torch.int32:
        coef = coef.to(torch.int32)
    return seeds.contiguous(), coef.contiguous()


def secure_commit_blocks(xb, w_eff, seeds, coef, base: int, *, bits: int,
                         k: int, noise=None, rows=None):
    """xb: [K, R, block] f32; w_eff: [K] f32 effective slot weights; seeds:
    [K, K] uint32 values (int64 holding them, or any integer dtype); coef:
    [K, K] integers (in {-1, 0, +1} from ``core.secure_agg``); ``base`` the
    global element index of row 0; ``noise`` None (round half to even) or
    [K, R, block] uniform [0, 1) f32 (stochastic rounding); ``rows`` None
    (row r at element ``base + r * block`` of the mask stream) or an [R]
    integer table of each row's global block-row index (row r at ``base +
    rows[r] * block``: the rows of a share of the whole bucket,
    ``kernels.ops.row_table``).  Returns [R, block] f32.  The kernel's
    scratch: the folded mask words, 1 + 2K^2 int32 (134 MB at K = 4096),
    and the per-slot top-k thresholds, [R, K] int32."""
    launches.check_shapes(SECURE, xb, 3, w_eff)
    K, R, block = xb.shape
    _check_pairs(seeds, coef, K)
    if noise is not None and noise.shape != xb.shape:
        raise ValueError(f"{SECURE}: noise of shape {tuple(noise.shape)} "
                         f"for blocks {tuple(xb.shape)}")
    if rows is not None and tuple(rows.shape) != (R,):
        raise ValueError(f"{SECURE}: a row table of shape "
                         f"{tuple(rows.shape)} for {R} rows")
    extra = () if noise is None else (noise,)
    table = () if rows is None else (rows,)

    def prepare():
        launches.check_operands(SECURE, xb, w_eff, *extra)
        pairs = _pair_operands(seeds, coef)
        # uint32 indices, the same bits as int32
        index = None if rows is None else rows.to(torch.int32).contiguous()
        # the folded mask words: a count, then (seed, net coefficient)
        # pairs; each row's per-slot top-k thresholds
        words = xb.new_empty(1 + 2 * K * K, dtype=torch.int32)
        thresh = xb.new_empty((R, K), dtype=torch.int32)
        out = xb.new_empty((R, block))        # float32, on xb's device
        return out, (pairs, index, words, thresh)
    if launches.on_cpu(xb, w_eff, seeds, coef, *extra, *table):
        return launches.plain(xb.device, lambda: ref.fused_secure_commit_ref(
            xb, w_eff.reshape(K, 1), seeds, coef, base, bits, k=k,
            noise=noise, rows=rows), prepare)
    from repro_torch.kernels import _build
    out, ((seeds, coef), rows, words, thresh) = prepare()
    _build.launch("secure_commit", SECURE, xb.data_ptr(), w_eff.data_ptr(),
                  seeds.data_ptr(), coef.data_ptr(), int(base) & ref.U32,
                  rows.data_ptr() if table else None,
                  noise.data_ptr() if extra else None, words.data_ptr(),
                  thresh.data_ptr(),
                  out.data_ptr(), K, R, block, bits, k, device=xb.device)
    launches.count(SECURE)
    return out


def fold_mask_words(seeds, coef):
    """The secure commit's mask words, folded: [K, K] pair seeds and
    coefficients -> (seeds, net coefficients), int64 holding uint32, one
    entry per word that does not cancel (``ref.fold_mask_words``).  On the
    card this runs the commit kernel's own prologue (``secure_fold``) alone
    and returns its words in its order, so that it can be held against the
    plain version; the commit never calls this, and it counts no launch."""
    K = seeds.shape[0]
    _check_pairs(seeds, coef, K)
    if launches.on_cpu(seeds, coef):
        return ref.fold_mask_words(seeds, coef)
    from repro_torch.kernels import _build
    seeds, coef = _pair_operands(seeds, coef)
    words = torch.empty(1 + 2 * K * K, dtype=torch.int32, device=seeds.device)
    _build.launch("secure_commit", "secure_fold", seeds.data_ptr(),
                  coef.data_ptr(), words.data_ptr(), K, device=seeds.device)
    n = int(words[0])
    pairs = ref.to_u32(words[1:1 + 2 * n].reshape(n, 2))
    return pairs[:, 0], pairs[:, 1]
