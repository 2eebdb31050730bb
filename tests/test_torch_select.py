"""The port's exact top-k select (``digit_select`` in
``repro_torch/kernels/csrc/row_ops.cuh``), modelled step for step in numpy
and checked on the CPU before any card runs it.

The model follows the CUDA select's passes on one row of |x| bit patterns:
the walk down the top 8-bit digits (a count, then the next digit present
through a wrapped uint32 minimum), the check for fewer than k nonzero
entries, one-bit passes while more than 32 candidates are left (with the
jump to the highest bit where the candidates differ, or the end where they
are all equal), the least candidate when exactly ``rank`` are left, and the
rank of the last <= 32
candidates, in the integer form and in the FP32 form the kernel uses for
normal floats (a fused multiply-add that must give an integer of magnitude
>= 1 for unequal candidates); the counts of the walk's first step and of
the bit passes are also checked in the FP32 form the kernel uses there.  It is held bit for bit against the sort
threshold of ``repro_torch.kernels.ref.topk_blocks`` and, as the output of
the top-k, against the JAX package's oracle and its ``topk_sparsify_blocks``
in interpret mode (where that kernel's bisection resolves the threshold), on
seeded adversarial rows: ties across the k-th value, zero rows, padded rows
with fewer nonzeros than k, k=1 and k=block, subnormals, +-0, one
exponent.  Every path of the select is taken by some row.

plain_commit's quantize replaces the division x / scale by a product with
the correctly rounded reciprocal and divides only where the product lies
within |r| 2^-20 of a half-integer; the numpy model of that rule is held
against rint of the IEEE quotient, bit for bit, on half-way and near
half-way values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.topk_sparsify import topk_sparsify_blocks
from repro_torch.kernels import ref as tref

U32 = 0xFFFFFFFF


def abs_bits(x):
    return np.asarray(x, np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)


def rank_candidates(cands, rank, top, paths):
    """Step 3: the least candidate with fewer than ``rank`` candidates
    greater, by the FP32 form where the kernel uses it."""
    cands = cands.astype(np.int64)
    if 12 <= top <= 126:
        paths.add("rank_fp32")
        e = 2 * top - 127                  # exponent of the digit's low binade
        vals = cands.astype(np.uint32).view(np.float32).astype(np.float64)
        lo, hi = 2.0 ** e, 2.0 ** (e + 2)
        assert ((vals >= lo) & (vals < hi)).all()
        # (a - v) 2^(23-e): integers, >= 1 in magnitude where a != v, and
        # below 2^25, so one float32 rounding keeps sign and magnitude >= 1
        diff = (vals[:, None] - vals[None, :]) * 2.0 ** (23 - e)
        assert np.array_equal(diff, np.round(diff))
        assert (np.abs(diff[diff != 0]) >= 1).all()
        assert (np.abs(diff) < 2.0 ** 25).all()
        gt = (diff > 0).sum(axis=0)
    else:
        paths.add("rank_int")
        gt = (cands[:, None] > cands[None, :]).sum(axis=0)
    return int(cands[gt < rank].min())


def count_at_least(u, m, digit):
    """The kernel's FP32 count of patterns >= m, m in the binades of the
    top digit ``digit``: saturate((x - pred(m)) 2^(24-e)) summed, computed
    exactly in float64 and rounded once to float32 as the fused
    multiply-add does."""
    e = 2 * int(digit) - 127
    x = np.asarray(u, np.uint64).astype(np.uint32).view(np.float32)
    pm = np.array([m - 1], np.uint32).view(np.float32)[0]
    v = (x.astype(np.float64) - np.float64(pm)) * 2.0 ** (24 - e)
    at_least = x >= np.array([m], np.uint32).view(np.float32)[0]
    assert (v[at_least] >= 1).all() and (v[~at_least] <= 0).all()
    got = np.clip(v.astype(np.float32), 0, 1)       # one rounding, saturate
    assert np.array_equal(got, at_least.astype(np.float32))
    return int(got.sum())


def select_model(u, k, paths):
    """The CUDA digit_select on one row of uint32 |x| patterns."""
    u = np.asarray(u, np.uint64)           # room for the wrapped arithmetic
    top = int(u.max())
    if top == 0:
        paths.add("zero_row")
        return 0
    rank, digit = k, top >> 24
    first = True
    d = u >> 24
    above = 0
    while True:
        in_bin = int((d == digit).sum())
        if first and 12 <= digit <= 126:
            paths.add("count_fp32")
            assert count_at_least(u, digit << 24, digit) == in_bin
        if in_bin >= rank:
            break
        if first and int((u != 0).sum()) < k:
            paths.add("padded")
            return 0
        first = False
        paths.add("walk")
        dm1 = (digit - 1) & U32
        gap = int(((dm1 - d) & U32).min())  # entries at or above wrap high
        rank -= in_bin
        above += in_bin
        digit = (dm1 - gap) & U32
        assert digit == int(d[d < (dm1 + 1)].max())
    prefix, shift = digit << 24, 24
    while in_bin > 32 and in_bin != rank and shift > 0:
        paths.add("bits")
        shift -= 1
        mid = prefix | (1 << shift)
        mask = (U32 << shift) & U32
        upper = int(((u & mask) == mid).sum())
        if 12 <= digit and top >> 24 <= 126:
            paths.add("count_fp32")
            assert count_at_least(u, mid, digit) - above == upper
        if upper in (0, in_bin):
            fixed = (U32 << (shift + 1)) & U32
            cand = u[(u & fixed) == prefix]
            lo, hi = int(cand.min()), int(cand.max())
            if lo == hi:
                paths.add("equal")
                return lo
            paths.add("jump")
            shift = (lo ^ hi).bit_length()         # 32 - __clz(lo ^ hi)
            prefix = hi & ((U32 << shift) & U32)
            assert ((cand & ((U32 << shift) & U32)) == prefix).all()
            continue
        if upper >= rank:
            prefix, in_bin = mid, upper
        else:
            rank -= upper
            in_bin -= upper
            above += upper
    mask = (U32 << shift) & U32
    cands = u[(u & mask) == prefix]
    assert len(cands) == in_bin
    if in_bin == rank:
        paths.add("least")
        return int(cands.min())
    if in_bin > 32:
        paths.add("all_bits")
        return prefix
    return rank_candidates(cands, rank, digit, paths)


def adversarial_rows(block, rng):
    """name -> [rows, block] float32."""
    n = 16
    g = rng.normal(0, 0.01, (n, block)).astype(np.float32)
    ties = np.round(g * 200) / 200
    ties[::3] = 0.0                                          # zero rows
    padded10 = g.copy()
    padded10[:, 10:] = 0.0
    padded64 = g.copy()
    padded64[:, 64:] = 0.0
    one_exp = (np.sign(g) * (1.0 + np.abs(g) * 30)).astype(np.float32)
    subnormal = (g * np.float32(1e-36)).astype(np.float32)
    signed_zero = g.copy()
    signed_zero[:, ::3] = -0.0
    signed_zero[:, 1::3] = 0.0
    scales = np.float32(10.0) ** rng.integers(-30, 30, (n, 1))
    wide = (g * scales).astype(np.float32)                   # other exponents
    dense = (rng.uniform(1, 4, (n, block)) * np.float32(0.01)).astype(
        np.float32)                          # many entries in the top digit
    equal_top = np.full((n, block), np.float32(0.75))
    equal_top[:, ::5] = np.float32(0.5)                      # ties at the top
    huge = (g * np.float32(1e38)).astype(np.float32)         # digit 127 rows
    return {"gaussian": g, "ties_and_zero_rows": ties, "padded_10": padded10,
            "padded_64": padded64, "one_exponent": one_exp,
            "subnormal": subnormal, "signed_zero": signed_zero,
            "wide_scales": wide, "dense_top_digit": dense,
            "equal_top": equal_top, "huge": huge,
            "all_zero": np.zeros((2, block), np.float32)}


def sort_threshold(x, k):
    mag = torch.from_numpy(np.ascontiguousarray(x)).abs()
    t = torch.sort(mag, dim=-1, descending=True).values[..., k - 1]
    return abs_bits(t.numpy())


@pytest.mark.parametrize("block", [128, 256, 512, 1024])
def test_select_model_equals_the_sort_threshold(block):
    rng = np.random.default_rng(block)
    paths = set()
    ks = sorted({1, 2, 10, 26, 31, 32, 33, 64, block // 2, block - 1, block})
    for name, x in adversarial_rows(block, rng).items():
        u = abs_bits(x)
        for k in ks:
            want = sort_threshold(x, k)
            got = np.array([select_model(row, k, paths) for row in u],
                           np.uint32)
            assert np.array_equal(got, want), (name, k)
            # the top-k it gives is the plain version's, bit for bit
            kept = np.where(u >= got[:, None], x, np.float32(0))
            plain = tref.topk_blocks(torch.from_numpy(x), k).numpy()
            assert np.array_equal(kept.view(np.uint32),
                                  plain.view(np.uint32)), (name, k)
    assert paths == {"zero_row", "padded", "walk", "bits", "jump", "equal",
                     "least", "rank_fp32", "rank_int", "count_fp32"}


# Rows on which the JAX kernel's 32-step bisection on values resolves the
# k-th largest magnitude.  It does not across ties at the k-th value: its
# final step keeps the upper end of the bracket when more than k entries
# reach the lower one.  There the JAX package's own oracle, the sort
# threshold, is the contract.  Subnormal rows are held against the torch
# sort threshold only (above): XLA on the CPU flushes subnormals to zero.
BISECTION_EXACT = ("gaussian", "padded_10", "padded_64", "one_exponent",
                   "signed_zero", "wide_scales", "dense_top_digit",
                   "equal_top", "huge", "all_zero")


@pytest.mark.parametrize("k", [1, 26, 128, 256])
def test_select_model_matches_jax_topk(k):
    """The model's top-k against the JAX oracle (``repro.kernels.ref``,
    the sort threshold) on the adversarial rows, and against the Pallas
    ``topk_sparsify_blocks`` in interpret mode where its bisection resolves
    the threshold (every row at k=1 and k=block), as values (the JAX
    kernel writes +0 where a kept -0 stays -0)."""
    block = 256
    rng = np.random.default_rng(k)
    paths = set()
    for name, x in adversarial_rows(block, rng).items():
        if name == "subnormal":
            continue
        u = abs_bits(x)
        t = np.array([select_model(row, k, paths) for row in u], np.uint32)
        kept = np.where(u >= t[:, None], x, np.float32(0))
        oracle = np.asarray(jref.topk_sparsify_ref(jnp.asarray(x), k, block))
        assert np.array_equal(kept.view(np.uint32),
                              oracle.view(np.uint32)), name
        if name in BISECTION_EXACT or k in (1, block):
            pallas = np.asarray(topk_sparsify_blocks(jnp.asarray(x), k, True))
            np.testing.assert_array_equal(kept, pallas, err_msg=name)


def quantize_kept_model(y, top, bits):
    """plain_commit's quantize of kept entries y (float32): rint(y / scale)
    through the reciprocal, the IEEE division where the warp's product lies
    near a half-integer or scale is not a normal finite float."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    scale = np.float32(top) / qmax
    if scale == 0:
        scale = np.float32(1)
    inv = np.float32(1) / scale
    with np.errstate(over="ignore", invalid="ignore"):
        r = y * inv
        q = np.rint(r)
        near = (np.float32(0.5) - np.abs(r - q)) <= np.abs(r) * np.float32(
            2.0 ** -20)
    normal = np.isfinite(scale) and scale >= np.finfo(np.float32).tiny
    if near.any() or not normal:
        q = np.rint(y / scale)
    return np.clip(q, -qmax - 1, qmax) * scale, (near.any() or not normal)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_reciprocal_quantize_equals_the_division(bits):
    rng = np.random.default_rng(bits)
    qmax = 2 ** (bits - 1) - 1
    fell_back = kept_product = 0
    for trial in range(400):
        kind = trial % 4
        if kind == 0:                       # random kept entries
            y = (rng.normal(0, 1, 256) * 10.0 ** rng.integers(-30, 30)
                 ).astype(np.float32)
        else:                               # exact and near half-way quotients
            scale = np.float32(2.0 ** rng.integers(-40, 40))
            n = rng.integers(-qmax, qmax, 256).astype(np.float32) + 0.5
            y = (n * scale).astype(np.float32)
            if kind == 2:
                y = np.nextafter(y, np.float32(np.inf) * np.sign(y))
            elif kind == 3:
                y = np.nextafter(y, np.float32(0))
            y[0] = np.float32(qmax) * scale        # the row max sets scale
        top = np.abs(y).max()
        got, fb = quantize_kept_model(y, top, bits)
        scale = np.float32(top) / np.float32(qmax)
        scale = scale if scale != 0 else np.float32(1)
        want = np.clip(np.rint(y / scale), -qmax - 1, qmax) * scale
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        fell_back += fb
        kept_product += not fb
    # both paths are taken: half-way rows divide, random rows multiply
    assert fell_back and kept_product
