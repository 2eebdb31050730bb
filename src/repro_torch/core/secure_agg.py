"""Secure aggregation via commit-keyed pairwise additive masking (the
paper's §6 privacy layer, Bonawitz et al. 2017), mirroring
``repro/core/secure_agg.py``.

Each participating update slot i adds, for every other participating slot
j, a pseudorandom mask with sign sgn(id_j - id_i); the masks cancel
pairwise in the sum, so the aggregator only learns the aggregate.  Masks
are ``PRF(commit_key, min(id_i, id_j), max(id_i, id_j))``: both slots of a
pair derive the same mask, whatever the slot order.  A slot with
participation 0 (a dropped client or a straggler cut) zeroes every pair
mask that touches it, the functional stand-in for the protocol's
seed-reveal round.  Participating ids must be unique within a commit.

Keys and seeds are integers.  The reference derives its pair keys with
threefry ``fold_in``, which torch cannot reproduce, so the port keeps its
own integer derivation: a commit key is a uint32, and the pair seed of
``(lo, hi)`` is ``hash_u32`` folded over (key, lo, hi) (``pair_seeds``).
The same seeds drive both mask domains:

  * the integer domain (``pair_seeds`` / ``pair_coef_int``, consumed by the
    ``secure_commit`` kernel): one uint32 seed per pair, streamed over the
    element index by the kernel's avalanche hash;
  * the float domain (``pair_mask``, ``mask_slot``, ``mask_batch``): normal
    draws from a ``torch.Generator`` seeded with the pair seed, on the
    data's device.  The masks cancel, so the result depends on the draws
    only through float32 cancellation error.

A leaf that is a share of a whole one (cut over ``data`` and ``model`` at
rest: ``shares``, ``sharding.leaf_shares``' form) takes the share of each
whole-leaf mask, one pair's draw at a time, and the integer domain's mask
words follow the whole leaf's element index (``kernels.ops.row_table``):
a split commit masks as the unsplit one does.

The Diffie-Hellman key agreement and Shamir sharing of the real protocol
are out of scope: the keyed PRF stands in for the agreed pair keys and the
participation vector for the reveal round.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import U32, hash_u32
from repro_torch.models import sharding as sh
from repro_torch.pytree import ordered

MASK_DOMAIN_TAG = 0x5EC_A66   # domain separator: secure-agg mask keys


def _fold(h, v):
    """Fold ``v`` into the running uint32 hash ``h`` (ints or int64
    tensors holding uint32 values)."""
    return hash_u32((h ^ hash_u32(v & U32)) & U32)


def commit_key(commit_id: int, base_seed: int = 0) -> int:
    """Per-commit uint32 key: ``base_seed`` folded with the mask domain tag
    and the commit id.  Any per-commit-unique uint32 works as a commit key
    (the pipeline draws one from the run's generator); this is the explicit
    (commit_id -> key) form."""
    return _fold(_fold(base_seed & U32, MASK_DOMAIN_TAG), commit_id)


def pair_seed(key: int, lo, hi):
    """The pair seed PRF(key, lo, hi), a uint32, for ``lo <= hi`` (ints, or
    int64 tensors of ids that give a tensor of seeds)."""
    return _fold(_fold(key & U32, lo), hi)


def pair_seeds(key: int, ids):
    """Symmetric [K, K] pair seeds (int64 holding uint32) for the integer
    domain kernel: both slots of a pair get the SAME seed, so both draw
    identical mask words and the signed sum cancels exactly under uint32
    wraparound."""
    ids = ids.to(torch.int64)
    return pair_seed(key, torch.minimum(ids[:, None], ids[None, :]),
                     torch.maximum(ids[:, None], ids[None, :]))


def pair_coef_int(ids, participation):
    """[K, K] int32 ``sgn(id_j - id_i) * [p_i > 0] * [p_j > 0]``, applied to
    mask words as exact two's-complement multiplies.  The sign comes from
    comparisons, not a subtraction that could wrap."""
    ids = ids.to(participation.device)
    sign = ((ids[None, :] > ids[:, None]).to(torch.int32)
            - (ids[None, :] < ids[:, None]).to(torch.int32))
    p = (participation > 0).to(torch.int32)
    return sign * p[None, :] * p[:, None]


def _pair_coef(ids, participation):
    """[K, K] float ``sgn(id_j - id_i) * p_i * p_j``: zero on the diagonal
    and for any pair touching a non-participant."""
    ids = ids.to(participation.device)
    sign = torch.sign(ids[None, :] - ids[:, None]).to(torch.float32)
    p = participation.to(torch.float32)
    return sign * p[None, :] * p[:, None]


def pair_mask(key: int, id_i: int, id_j: int, shape, device="cpu", cut=()):
    """The symmetric float pair mask: standard normals from a generator on
    ``device`` seeded with the pair seed.  Callers apply the sign.
    ``cut``: ``shape`` is that share of the whole mask, which is drawn and
    cut."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(pair_seed(key, min(id_i, id_j), max(id_i, id_j)))
    return sh.take_share(torch.randn(sh.whole_shape(tuple(shape), cut),
                                     generator=gen, device=dev,
                                     dtype=torch.float32), cut)


def _row_total(key: int, ids, coef_row, id_i: int, shape, device, cut=()):
    """Slot i's summed pair masks ``sum_j coef[j] * mask(i, j)``, drawing
    only the pairs whose coefficient is not 0 (``cut``: ``pair_mask``'s)."""
    total = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    for j, c in enumerate(coef_row.tolist()):
        if c:
            total = total + c * pair_mask(key, id_i, int(ids[j]), shape,
                                          device, cut)
    return total


def mask_slot(key: int, ids, participation, idx: int, tree: dict,
              shares=None) -> dict:
    """Mask ONE slot's update (leaves without a slot dim): the streaming
    form of the sequential modes.  ``shares``: ``{leaf: cut}`` of the
    leaves that are shares of whole ones."""
    coef = _pair_coef(ids, participation)[idx]
    id_i = int(ids[idx])
    shares = shares or {}
    return {k: (leaf.to(torch.float32)
                + _row_total(key, ids, coef, id_i, leaf.shape, leaf.device,
                             shares.get(k, ()))).to(leaf.dtype)
            for k, leaf in tree.items()}


def mask_batch(tree: dict, key: int, ids, participation,
               first: int = 0, shares=None) -> dict:
    """Mask a stacked batch (leaves [K, ...]), slot by slot, so the peak
    memory stays one slot's mask per leaf.  The leaves may hold slots
    ``first`` to ``first + K`` of a longer batch (a process's share of
    slots split over a mesh); ``ids`` and ``participation`` are the whole
    batch's.  ``shares``: ``{leaf: cut}``, in the leaf's dims after the
    slot dim, of the leaves that are shares of whole ones."""
    coef = _pair_coef(ids, participation)
    shares = shares or {}

    def mask_leaf(leaf, cut):
        totals = torch.stack([
            _row_total(key, ids, coef[first + i], int(ids[first + i]),
                       leaf.shape[1:], leaf.device, cut)
            for i in range(leaf.shape[0])])
        return (leaf.to(torch.float32) + totals).to(leaf.dtype)

    return {k: mask_leaf(leaf, shares.get(k, ())) for k, leaf in tree.items()}


def aggregate_masked(masked_updates: dict, participation) -> dict:
    """Sum masked updates over the leading slot dim: pairwise masks cancel
    among participants, recovering the sum of participating updates."""
    def agg(d):
        p = participation.reshape((-1,) + (1,) * (d.ndim - 1)).to(d.dtype)
        return (d * p).sum(0)
    return {k: agg(d) for k, d in masked_updates.items()}


def secure_weighted_mean(updates: dict, weights, participation, key: int,
                         ids=None) -> dict:
    """End-to-end reference: pre-weight each slot's update, mask, sum,
    normalise by the (public) participating weight mass.  ``updates``
    leaves have a leading slot dim K."""
    K = next(iter(updates.values())).shape[0]
    if ids is None:
        ids = torch.arange(K, dtype=torch.int32)
    wp = weights * participation

    def weighted(d):
        return d.to(torch.float32) * wp.reshape(
            (-1,) + (1,) * (d.ndim - 1)).to(torch.float32)

    pre = {k: weighted(d) for k, d in updates.items()}
    total = aggregate_masked(mask_batch(pre, key, ids, participation),
                             participation)
    denom = torch.clamp(wp.sum(), min=1e-12)
    return {k: t / denom for k, t in total.items()}


def masked_payload_bytes(tree: dict, cfg=None, n_slots: int = 2) -> int:
    """Wire bytes of one MASKED update slot.

    Without quantization, additive masks are dense f32 noise: 4 bytes per
    element whatever the plain path would have paid.  With quantization
    (``cfg.quantize_bits``) the masks live in the quantized integer domain
    (the ``secure_commit`` kernel): each element ships as one finite-ring
    word of ``quantize_bits + ceil(log2(n_slots))`` bits, plus one f32
    scale per block.  Sparsity does not survive masking either way."""
    bits = int(getattr(cfg, "quantize_bits", 0) or 0) if cfg is not None \
        else 0
    if not bits:
        return int(sum(np.prod(tuple(l.shape)) * 4 for l in tree.values()))
    ring_bits = bits + max(1, int(np.ceil(np.log2(max(n_slots, 2)))))
    block = int(getattr(cfg, "block", 256))
    total = 0
    for name in ordered(tree):
        n = int(np.prod(tuple(tree[name].shape)))
        total += int(n * ring_bits / 8 + np.ceil(n / block) * 4)
    return total
