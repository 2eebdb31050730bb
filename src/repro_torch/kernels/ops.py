"""Public entry points of the port's kernels, mirroring
``repro/kernels/ops.py``.

They handle the blocking (blocks along the LAST dim of each leaf, zero
padded, leading dims collapsed to rows), the leaf bucketing, and the slot
vectors, then call a kernel wrapper.  The device is explicit: a CPU tensor
takes the kernel's plain PyTorch version, a CUDA tensor launches the CUDA
kernel or raises.  Nothing falls back.

Leaf bucketing: ``fused_*_tree`` concatenate every leaf's blocked rows into
one ``[K, R_total, block]`` bucket, so a whole model costs one kernel
launch per commit.  Rows are whole blocks of one leaf each, so per-block
scales and top-k thresholds are the same as per-leaf calls.
The secure commit's mask stream is indexed by the bucket's row-major
element index from 0, which equals the reference's per-leaf ``base``
accumulation; where leaves are shares of whole ones (``cuts``), by the
WHOLE bucket's, through a table of each local row's global block-row
(``row_table``).  ``selective_scan_chunk`` is the Mamba mixer's scan, an
``autograd.Function`` whose backward is the scan's backward kernel.
``KERNEL_LAUNCHES`` counts launches on the card by kernel name.

Row split (the reference's ``_shard_rows_map`` / ``_shard_rows_reduce``):
under a mesh of processes whose ``fusion_axes`` are larger than one, the
blocked rows are zero-padded to a multiple of the shard count (zero rows
are a fixed point of every block kernel) and split into one contiguous
share a process, in the order of ``sharding.flat_shard_index`` over the
fusion axes.  Each process runs the kernel on its own rows (``rows_map``,
``rows_reduce``), the secure commit's from the GLOBAL element index of its
row 0, so masks cancel across shards, and one all-gather of the rows over
the fusion axes gives every process the whole result.  Where the slot dim
of a commit stack arrives split over some axes (``slot_axes``: a parallel
round's clients, [C/n, R, block] a process), one ``all_to_all`` over those
axes first turns the client split into the row split ([C, R/n, block]).
A row map (quantize, top-k) is row-local: it runs over the axes its input
is whole along, which ``exclude_axes`` of a client split leaves in
``fusion_axes``.  Without a mesh, or on one device, every entry point runs
one shard, the whole stack.  A ``model`` axis is a fusion axis like any
other.  The leaves of a stack may be shares of leaves cut over ``data``
and ``model`` at rest (the pipeline's ``model_commit``, which drops the
cutting axes from the fusion axes): each share's rows are whole blocks of
the whole leaf, so every row kernel gives the share's rows of the whole
leaf's result, and the secure commit places them in its mask stream by
the row table.  ``shard_rows_map``
and ``shard_rows_reduce`` take a shard count and run the shards one after
another in one process, so a test can hold them shard by shard.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import fedprox_update as _fp
from repro_torch.kernels import fused_accum as _fa
from repro_torch.kernels import fused_quant_mask as _fqm
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import topk_sparsify as _tk
from repro_torch.kernels.launches import KERNEL_LAUNCHES  # noqa: F401
from repro_torch.models import sharding as sh


def _fusion_shards():
    """(axes, count, index) of this process's row share over the active
    mesh's ``fusion_axes``: ((), 1, 0) without a mesh or on one device."""
    axes = sh.fusion_axes()
    if not axes:
        return (), 1, 0
    return axes, sh.shard_count(axes), sh.shard_index(axes)


def _pad_rows(xb, mult: int, dim: int):
    pad = (-xb.shape[dim]) % mult
    if pad:
        widths = [0, 0] * (xb.ndim - 1 - dim) + [0, pad]
        xb = F.pad(xb, widths)
    return xb, pad


def shard_rows_map(fn, xb, n: int):
    """A rows op ([R, block] -> [R, block]) run as ``n`` row shards."""
    xb, pad = _pad_rows(xb, n, 0)
    r = xb.shape[0] // n
    y = torch.cat([fn(xb[i * r:(i + 1) * r].contiguous())
                   for i in range(n)]) if n > 1 else fn(xb)
    return y[:-pad] if pad else y


def shard_rows_reduce(fn, xb, n: int, base: int = 0):
    """A slot-reducing rows kernel ([K, R, block] -> [R, block]) run as
    ``n`` row shards: ``fn(xb_local, global_base)``, where a shard's base
    is ``base`` plus the element index of its row 0 in the stack."""
    xb, pad = _pad_rows(xb, n, 1)
    r, block = xb.shape[1] // n, xb.shape[2]
    y = torch.cat([fn(xb[:, i * r:(i + 1) * r].contiguous(),
                      base + i * r * block) for i in range(n)]) \
        if n > 1 else fn(xb, base)
    return y[:-pad] if pad else y


def rows_map(fn, xb):
    """A rows op ([R, block] -> [R, block], the same on every process) run
    on this process's rows of the active mesh's fusion axes, the rows then
    gathered: the reference's ``_shard_rows_map``."""
    axes, n, i = _fusion_shards()
    if n == 1:
        return fn(xb)
    xb, pad = _pad_rows(xb, n, 0)
    r = xb.shape[0] // n
    y = sh.all_gather(fn(xb[i * r:(i + 1) * r].contiguous()), axes, 0)
    return y[:-pad] if pad else y


def _to_row_split(xb, slot_axes, axes, n, r):
    """The [K_local, R_pad, block] stack whose slot dim is split over
    ``slot_axes`` -> [K, r, block], this process's rows of all K slots: to
    each member of its slot group the rows of that member's shard, one
    ``all_to_all``."""
    mesh = sh.get_mesh()
    slot_axes = mesh.live(slot_axes)
    if not set(slot_axes) <= set(axes):
        raise ValueError(f"slots split over {slot_axes}, rows over {axes}")
    coords = mesh.coords
    sizes = [mesh.shape[a] for a in slot_axes]
    chunks = []
    for member in range(sh.shard_count(slot_axes)):
        c, rem = dict(coords), member
        for a, size in reversed(list(zip(slot_axes, sizes))):
            c[a], rem = rem % size, rem // size
        f = sh.flat_shard_index(axes, c, mesh)
        chunks.append(xb[:, f * r:(f + 1) * r])
    got = sh.all_to_all(torch.stack(chunks), slot_axes, 0, 0)
    return got.reshape((-1,) + tuple(got.shape[2:])).contiguous()


def rows_reduce(fn, xb, base: int = 0, slot_axes=(), aligned=None,
                table=None):
    """A slot-reducing rows kernel ([K, R, block] -> [R, block]) run on
    this process's rows of the fusion axes, the rows then gathered:
    ``fn(xb_rows, global_base, aligned_rows, table_rows)``, where
    ``global_base`` is ``base`` plus the element index of the share's row
    0 (the reference's ``flat_shard_index`` offset), ``aligned`` (None, or
    a whole [K, R, block] operand such as the rounding noise) comes cut to
    the same rows, and so does ``table`` (None, or [R]: each row's global
    block-row, ``row_table``; with one, ``global_base`` stays ``base``).
    ``xb``'s slots are whole, or split over ``slot_axes`` (a client split,
    exchanged to the row split first)."""
    axes, n, i = _fusion_shards()
    if n == 1:
        if sh.shard_count(slot_axes) > 1:
            raise ValueError(f"slots split over {slot_axes} with no rows "
                             f"to split")
        return fn(xb, base, aligned, table)
    xb, pad = _pad_rows(xb, n, 1)
    r, block = xb.shape[1] // n, xb.shape[2]
    if sh.shard_count(slot_axes) > 1:
        xl = _to_row_split(xb, slot_axes, axes, n, r)
    else:
        xl = xb[:, i * r:(i + 1) * r].contiguous()
    if aligned is not None:
        aligned = _pad_rows(aligned, n, 1)[0][:, i * r:(i + 1) * r]
        aligned = aligned.contiguous()
    if table is not None:
        table = _pad_rows(table, n, 0)[0][i * r:(i + 1) * r].contiguous()
    else:
        base = base + i * r * block
    y = sh.all_gather(fn(xl, base, aligned, table), axes, 0)
    return y[:-pad] if pad else y


def _as_blocks(x, block):
    """Blocks along the LAST dim (core.compression's grouping), then leading
    dims collapsed to rows: ``([R, block] f32, meta)``."""
    L = x.shape[-1] if x.ndim else 1
    xx = x.reshape(tuple(x.shape) or (1,)).to(torch.float32)
    pad = (-L) % block
    if pad:
        xx = F.pad(xx, (0, pad))
    rows_shape = tuple(xx.shape[:-1]) + ((L + pad) // block,)
    return xx.reshape(-1, block).contiguous(), (pad, rows_shape)


def _from_blocks(b, meta, shape, dtype):
    pad, rows_shape = meta
    y = b.reshape(*rows_shape, -1).reshape(*rows_shape[:-1], -1)
    if pad:
        y = y[..., :-pad]
    return y.reshape(shape).to(dtype)


def quantize_dequant(x, *, bits: int = 8, block: int = 256):
    xb, meta = _as_blocks(x, block)
    y = rows_map(lambda b: _q.quantize_dequant_blocks(b, bits), xb)
    return _from_blocks(y, meta, x.shape, x.dtype)


def topk_sparsify(x, *, k: int, block: int = 256):
    # padded zero lanes are part of their block, as in the plain version
    xb, meta = _as_blocks(x, block)
    y = rows_map(lambda b: _tk.topk_sparsify_blocks(b, k), xb)
    return _from_blocks(y, meta, x.shape, x.dtype)


def fedprox_update(w, g, w0, *, lr: float, mu: float = 0.0):
    """``w - lr * (g + mu * (w - w0))`` for one leaf: ``w`` and ``g`` are
    the leaf (``w0``'s shape) or C clients' copies of it ([C, *w0.shape]);
    the kernel reads ``w0`` once for all of them."""
    n = w0.numel()
    C = w.numel() // max(n, 1)
    if tuple(w.shape[w.ndim - w0.ndim:]) != tuple(w0.shape) or C * n != \
            w.numel():
        raise ValueError(f"fedprox_update: w {tuple(w.shape)} is not "
                         f"[C, *{tuple(w0.shape)}]")
    flat = lambda t, shape: t.reshape(shape).to(torch.float32).contiguous()
    y = _fp.fedprox_update_flat(flat(w, (C, n)), flat(g, (C, n)),
                                flat(w0, (n,)), lr, mu)
    return y.reshape(w.shape).to(w.dtype)


# ---------------------------------------------------------------------------
# fused commit path: compress + discount + accumulate in one pass over a
# slot-stacked [K, ...] leaf.  core/pipeline.py dispatches through the
# bucketed fused_*_tree entry points; the per-leaf forms serve tests.
# ---------------------------------------------------------------------------

def _stack_blocks(x, block):
    """[K, ...] slot-stacked leaf -> ([K, R, block] f32, meta), blocks along
    the leaf's last dim per slot, leading dims collapsed into rows."""
    K = x.shape[0]
    lead = tuple(x.shape[1:])
    xx = x.reshape((K,) + (lead or (1,))).to(torch.float32)
    L = xx.shape[-1]
    pad = (-L) % block
    if pad:
        xx = F.pad(xx, (0, pad))
    return xx.reshape(K, -1, block), (pad, tuple(xx.shape[1:]), lead)


def _unstack_sum(y, meta, dtype):
    """[R, block] summed blocks -> the un-padded summed leaf."""
    pad, padded_shape, lead = meta
    y = y.reshape(*padded_shape[:-1], -1)
    if pad:
        y = y[..., :-pad]
    return y.reshape(lead).to(dtype)


def pack_blocks(leaves, block):
    """Slot-stacked [K, ...] leaves -> ONE [K, R_total, block] bucket.
    Returns (bucket, metas, row counts)."""
    blocked, metas, rows = [], [], []
    for leaf in leaves:
        xb, meta = _stack_blocks(leaf, block)
        blocked.append(xb)
        metas.append(meta)
        rows.append(xb.shape[1])
    return torch.cat(blocked, dim=1).contiguous(), metas, rows


def row_table(leaves, cuts, block):
    """Each row of ``pack_blocks(leaves, block)``'s bucket as a block-row
    of the WHOLE bucket, the one the whole leaves would pack into: (an [R]
    int64 table, the whole bucket's row count).  ``cuts[j]``: leaf j's cut
    (``sharding.shard_cut``'s form, in its dims after the slot dim), ``()``
    for a whole leaf, which keeps its own rows; a cut leaf's blocks must be
    whole blocks of the whole leaf (``core.pipeline.block_aligned``)."""
    parts, r0 = [], 0
    for leaf, cut in zip(leaves, cuts):
        shape = sh.whole_shape(tuple(leaf.shape[1:]) or (1,), cut)
        rows = shape[:-1] + (-(-shape[-1] // block),)
        idx = torch.arange(r0, r0 + math.prod(rows), dtype=torch.int64)
        parts.append(sh.take_share(idx.reshape(rows), cut).reshape(-1))
        r0 += idx.numel()
    return torch.cat(parts), r0


def unpack_sums(y, metas, rows, dtype=torch.float32):
    """[R_total, block] summed bucket -> the per-leaf summed leaves."""
    out, r0 = [], 0
    for meta, r in zip(metas, rows):
        out.append(_unstack_sum(y[r0:r0 + r], meta, dtype))
        r0 += r
    return out


def _slot_vector(v, K, device):
    """A per-slot vector as contiguous [K] f32.  Numbers and arrays are made
    on ``device``; a tensor keeps its own device (the kernel wrapper refuses
    operands on different devices)."""
    return torch.as_tensor(
        v, dtype=torch.float32,
        device=None if torch.is_tensor(v) else device).reshape(K).contiguous()


def _slot_vectors(w, staleness, K, device):
    """Per-slot weights and staleness as contiguous [K] f32."""
    return _slot_vector(w, K, device), _slot_vector(staleness, K, device)


def _secure_rows(xb, w_eff, seeds, coef, base, bits, k, use_kernel,
                 noise_generator, slot_axes=(), table=None, whole_rows=None):
    """The secure commit of a blocked [K, R, block] stack (its slots whole
    or split over ``slot_axes``): the kernel, or its plain version where
    the caller turned fusion off, each on this process's rows.  ``table``
    (``row_table``'s, ``whole_rows`` rows whole) places the rows in the
    whole bucket's mask stream.  A ``noise_generator`` switches on
    stochastic rounding: the uniform draws of the whole [K, R, block]
    stack (of the whole bucket, its rows then taken by the table) are made
    on the generator's device, the same on every process, and moved to the
    stack's (on ``meta``, a ``meta`` tensor, the generator left alone)."""
    wv = _slot_vector(w_eff, torch.as_tensor(w_eff).numel(), xb.device)
    K = wv.shape[0]
    noise = None
    if noise_generator is not None and xb.device.type == "meta":
        noise = torch.empty(xb.shape, device="meta")
    elif noise_generator is not None:
        rows = xb.shape[1] if table is None else whole_rows
        noise = torch.rand((K, rows, xb.shape[2]), generator=noise_generator,
                           device=noise_generator.device)
        if table is not None:
            noise = noise.index_select(1, table.to(noise.device))
        noise = noise.to(xb.device)
    seeds, coef = seeds.to(xb.device), coef.to(xb.device)
    if table is not None:
        table = table.to(xb.device)

    def one(xl, b, nz, rows):
        if use_kernel:
            return _fqm.secure_commit_blocks(xl, wv, seeds, coef, b,
                                             bits=bits, k=k, noise=nz,
                                             rows=rows)
        return ref.fused_secure_commit_ref(xl, wv[:, None], seeds, coef, b,
                                           bits, k=k, noise=nz, rows=rows)
    return rows_reduce(one, xb, base, slot_axes, noise, table)


def _accum_rows(xb, wv, sv, exponent, slot_axes=()):
    return rows_reduce(
        lambda xl, *_: _fa.fused_accum_blocks(xl, wv, sv, exponent), xb, 0,
        slot_axes)


def _plain_rows(xb, wv, sv, exponent, bits, k, slot_axes=()):
    return rows_reduce(
        lambda xl, *_: _fqm.plain_commit_blocks(xl, wv, sv, exponent,
                                                bits=bits, k=k), xb, 0,
        slot_axes)


def fused_accum_tree(leaves, w, staleness, exponent, *, block: int = 256,
                     slot_axes=()):
    """Bucketed fused accumulate over a flattened leaf list: one kernel
    launch for the whole tree.  Returns the per-leaf f32 sums.  Under a
    mesh the leaves' slot dim may be split over ``slot_axes`` (``w`` and
    ``staleness`` whole)."""
    xb, metas, rows = pack_blocks(list(leaves), block)
    K = torch.as_tensor(w).numel()
    wv, sv = _slot_vectors(w, staleness, K, xb.device)
    return unpack_sums(_accum_rows(xb, wv, sv, exponent, slot_axes), metas,
                       rows)


def fused_plain_commit_tree(leaves, w, staleness, exponent, *, bits: int,
                            k: int, block: int = 256, slot_axes=()):
    """Bucketed one-pass plain commit (top-k + quantize + discounted sum)
    over a flattened leaf list: one kernel launch for the whole tree."""
    xb, metas, rows = pack_blocks(list(leaves), block)
    K = torch.as_tensor(w).numel()
    wv, sv = _slot_vectors(w, staleness, K, xb.device)
    return unpack_sums(_plain_rows(xb, wv, sv, exponent, bits, k, slot_axes),
                       metas, rows)


def fused_secure_commit_tree(leaves, w_eff, seeds, coef, *, bits: int,
                             k: int = 0, block: int = 256,
                             use_kernel: bool = True, noise_generator=None,
                             slot_axes=(), cuts=None):
    """Bucketed integer-domain secure commit over a flattened leaf list: one
    kernel launch for the whole tree, the mask stream indexed from 0 over
    the bucket.  ``seeds`` [K, K] uint32 values and ``coef`` [K, K] int
    from ``core.secure_agg``.  ``cuts`` (None, or one cut a leaf: ``()``
    for a whole one): leaves that are shares of whole leaves, each element
    masked at its index in the whole leaves' bucket (``row_table``).
    Returns the per-leaf f32 sums."""
    leaves = list(leaves)
    xb, metas, rows = pack_blocks(leaves, block)
    table, whole_rows = (row_table(leaves, cuts, block)
                         if cuts and any(cuts) else (None, None))
    return unpack_sums(_secure_rows(xb, w_eff, seeds, coef, 0, bits, k,
                                    use_kernel, noise_generator, slot_axes,
                                    table, whole_rows), metas, rows)


def weighted_sum_tree(leaves, w, *, block: int = 256, slot_axes=()):
    """``sum_i w_i * x_i`` over the slot dim in float32, in plain PyTorch
    on this process's rows of the bucket (slots whole, or split over
    ``slot_axes``): the unfused commit's sum, in the fused commit's
    layout."""
    xb, metas, rows = pack_blocks(list(leaves), block)
    wv = _slot_vector(w, torch.as_tensor(w).numel(), xb.device)
    return unpack_sums(rows_reduce(
        lambda xl, *_: (xl * wv[:, None, None]).sum(0), xb, 0, slot_axes),
        metas, rows)


def fused_accum(x, w, staleness, exponent, *, block: int = 256):
    """``sum_i w_i * (1+s_i)^(-exponent) * x_i`` over the slot dim of one
    leaf in a single pass."""
    xb, meta = _stack_blocks(x, block)
    wv, sv = _slot_vectors(w, staleness, xb.shape[0], xb.device)
    return _unstack_sum(_accum_rows(xb.contiguous(), wv, sv, exponent), meta,
                        torch.float32)


def fused_plain_commit(x, w, staleness, exponent, *, bits: int, k: int,
                       block: int = 256):
    """Per-slot top-k + deterministic quantize + discounted weighted sum
    over the slot dim of one leaf, in one pass."""
    xb, meta = _stack_blocks(x, block)
    wv, sv = _slot_vectors(w, staleness, xb.shape[0], xb.device)
    return _unstack_sum(_plain_rows(xb.contiguous(), wv, sv, exponent, bits,
                                    k), meta, torch.float32)


def fused_secure_commit(x, w_eff, seeds, coef, base, *, bits: int, k: int = 0,
                        block: int = 256, use_kernel: bool = True,
                        noise_generator=None):
    """Integer-domain secure aggregation of one slot-stacked leaf: top-k,
    commit-common-scale integer quantize, uint32 modular pairwise masks,
    sum, dequantize.  ``base`` is the leaf's global element-index offset
    into the commit-wide mask stream."""
    xb, meta = _stack_blocks(x, block)
    return _unstack_sum(_secure_rows(xb.contiguous(), w_eff, seeds, coef,
                                     base, bits, k, use_kernel,
                                     noise_generator), meta, torch.float32)


# ---------------------------------------------------------------------------
# selective scan: forward and backward are kernels (or their plain versions
# on the CPU), each an autograd.Function in the setup_context style with a
# vmap rule, so the round's torch.func.grad_and_value, under vmap in
# parallel mode, runs them
# ---------------------------------------------------------------------------

def _fold(x, bdim, n):
    """A vmapped operand as one kernel operand: the vmapped dim (``bdim``,
    size ``n``) folded into the batch dim, [n * B, ...]; an unbatched
    operand (``bdim`` None) is expanded first.  A kernel reads
    ``data_ptr()``, so it never sees a batched tensor."""
    x = x.expand((n,) + tuple(x.shape)) if bdim is None else x.movedim(bdim,
                                                                        0)
    return x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))


def _unfold(x, n):
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


class _SelectiveScanChunk(torch.autograd.Function):
    @staticmethod
    def forward(a, b, h0):
        if a.device.type == "meta":      # shapes only: the dry run's sizing
            return torch.empty_like(a), torch.empty_like(h0)
        return _ss.selective_scan_chunk_blocks(a, b, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, _, h0 = inputs
        ctx.save_for_backward(a, output[0], h0)   # the reference's _ss_fwd
        # an output no loss reached (the last chunk's h_last) comes to
        # backward as None, not as a tensor of zeros
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g_hs, g_hl):
        a, hs, h0 = ctx.saved_tensors
        if g_hs is None:
            g_hs = torch.zeros_like(hs)
        return _SelectiveScanChunkBwd.apply(a, hs, h0, g_hs, g_hl)

    @staticmethod
    def vmap(info, in_dims, a, b, h0):
        n = info.batch_size
        hs, hl = _SelectiveScanChunk.apply(
            *(_fold(x, d, n) for x, d in zip((a, b, h0), in_dims)))
        return (_unfold(hs, n), _unfold(hl, n)), (0, 0)


class _SelectiveScanChunkBwd(torch.autograd.Function):
    """(a, hs, h0, g_hs, g_hl) -> (ga, gb, gh0): the kernel
    ``selective_scan_bwd``.  ``g_hl`` is None where no gradient reached the
    last state.  Double backward is not needed and raises."""

    @staticmethod
    def forward(a, hs, h0, g_hs, g_hl):
        if a.device.type == "meta":      # shapes only: the dry run's sizing
            return torch.empty_like(a), torch.empty_like(a), \
                torch.empty_like(h0)
        if not _ss.rows_contiguous(g_hs):
            g_hs = g_hs.contiguous()
        return _ss.selective_scan_chunk_bwd_blocks(a, hs, h0, g_hs, g_hl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the selective scan's backward has no "
                                  "backward of its own")

    @staticmethod
    def vmap(info, in_dims, a, hs, h0, g_hs, g_hl):
        n = info.batch_size
        args = [None if x is None else _fold(x, d, n)
                for x, d in zip((a, hs, h0, g_hs, g_hl), in_dims)]
        out = _SelectiveScanChunkBwd.apply(*args)
        return tuple(_unfold(x, n) for x in out), (0, 0, 0)


def selective_scan_chunk(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` over one chunk.  a, b: [B, L, D, N]
    f32 (each batch row contiguous; chunk views of a longer sequence are
    taken as they are); h0: [B, D, N] f32.  Returns (hs [B, L, D, N],
    h_last [B, D, N]).  Differentiable in a, b and h0 (the backward is the
    kernel ``selective_scan_bwd``), also under ``torch.func`` transforms."""
    return _SelectiveScanChunk.apply(a, b, h0)
