"""Attention: GQA/MQA/MHA with RoPE, optional sliding window, chunked
(online-softmax) computation for long sequences, the decode path over a
KV cache (whole, or a shard of its sequence for the flash-decoding merge
over ``model``: ``decode_partials``), and cross attention to image patches
(the VLM family), mirroring ``repro/models/attention.py``.

Layouts:
  q        [B, S, H, hd]
  k, v     [B, T, KV, hd]      (KV heads never repeated in memory)
  caches   [B, S_max, KV, hd]  (decode: S_max split over ``model``)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _group(q, kv_heads):
    B, S, H, hd = q.shape
    return q.reshape(B, S, kv_heads, H // kv_heads, hd)


def _scores_mask(qpos, kpos, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _where_masked(scores, mask):
    return torch.where(mask, scores, torch.full((), NEG_INF,
                                                dtype=scores.dtype,
                                                device=scores.device))


def attend_full(q, k, v, *, causal=True, window=0):
    """Plain (un-chunked) GQA attention on small S.  (The reference's
    position offsets and ``kv_valid`` mask have no caller and are left
    out.)"""
    B, S, H, hd = q.shape
    KV, T = k.shape[2], k.shape[1]
    qg = _group(q, KV)                                   # [B,S,KV,G,hd]
    # not in place: training runs this under vmap(grad)
    scores = torch.einsum("bsngd,btnd->bngst", qg, k).to(torch.float32)
    scores = scores * hd ** -0.5
    mask = _scores_mask(torch.arange(S, device=q.device),
                        torch.arange(T, device=q.device), causal, window)
    scores = _where_masked(scores, mask[None, None, None])
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnd->bsngd", p, v)
    return out.reshape(B, S, H, hd)


def attend_chunked(q, k, v, *, causal=True, window=0, q_chunk=1024,
                   kv_chunk=1024):
    """Memory-bounded attention: outer loop over q chunks, inner loop over
    kv chunks with online softmax.  Never materialises [S, S] scores."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    nq, nk = S // q_chunk, T // kv_chunk
    if nq * q_chunk != S or nk * kv_chunk != T:
        raise ValueError(f"attend_chunked: S={S}, T={T} are not multiples "
                         f"of the chunks {q_chunk}, {kv_chunk}")
    qg = _group(q, KV)
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for iq in range(nq):
        q0 = iq * q_chunk
        qi = qg[:, q0:q0 + q_chunk]                      # [B,qc,KV,G,hd]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for ik in range(nk):
            k0 = ik * kv_chunk
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqngd,bknd->bngqk", qi, kc)
            s = s.to(torch.float32) * scale              # [B,KV,G,qc,kc]
            msk = _scores_mask(torch.arange(q_chunk, device=dev) + q0,
                               torch.arange(kv_chunk, device=dev) + k0,
                               causal, window)
            s = _where_masked(s, msk[None, None, None])
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngqk,bknd->bngqd", p.to(vc.dtype), vc).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B,KV,G,qc,hd]
        outs.append(out.permute(0, 3, 1, 2, 4))           # [B,qc,KV,G,hd]
    return torch.cat(outs, dim=1).reshape(B, S, H, hd).to(q.dtype)


def attend(q, k, v, *, causal=True, window=0, chunk_threshold=2048,
           q_chunk=1024, kv_chunk=1024):
    if q.shape[1] <= chunk_threshold:
        return attend_full(q, k, v, causal=causal, window=window)
    return attend_chunked(q, k, v, causal=causal, window=window,
                          q_chunk=min(q_chunk, q.shape[1]),
                          kv_chunk=min(kv_chunk, k.shape[1]))


# ---------------------------------------------------------------------------
# Decode (one query token against a cache)
# ---------------------------------------------------------------------------

def decode_attend(q1, k_cache, v_cache, pos: int, *, window=0):
    """q1 [B,H,hd]; caches [B,S,KV,hd]; pos the index of the current token
    (the caches already hold its k/v at ``pos``, or, for ring buffers, at
    ``pos % S``).  Softmax over the cache dim."""
    B, S, KV, hd = k_cache.shape
    H = q1.shape[1]
    qg = q1.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bngd,btnd->bngt", qg, k_cache).to(torch.float32)
    s *= hd ** -0.5
    if window and pos + 1 >= S:
        # ring buffer of size S == window: once full, every slot holds one
        # of the last S tokens (incl. current) and is valid.
        valid = torch.ones(S, dtype=torch.bool, device=q1.device)
    else:
        valid = torch.arange(S, device=q1.device) <= pos
    s = _where_masked(s, valid[None, None, None])
    p = torch.softmax(s, dim=-1).to(q1.dtype)
    out = torch.einsum("bngt,btnd->bngd", p, v_cache)
    return out.reshape(B, H, hd)


def decode_partials(q1, k_shard, v_shard, pos: int, *, window=0, offset=0,
                    total=None):
    """``decode_attend`` over one shard of the cache, for the
    flash-decoding merge (``sharding.merge_partials``): q1 [B,H,hd];
    shards [B,S,KV,hd] holding the global slots ``offset .. offset+S-1``
    of a cache of ``total`` slots (``S`` by default).  Validity is reckoned
    on the global slot, the ring-buffer rule included.  Returns the
    shard's float32 partials: the running max m [B,KV,G], the denominator
    l [B,KV,G] and the unnormalised numerator o [B,KV,G,hd].  The scores
    are formed in the model dtype and scaled in float32, as in
    ``decode_attend``; the numerator stays float32 until the merge, where
    ``decode_attend`` casts the softmax to the model dtype before ``p v``
    (in bfloat16 the two differ by that rounding, ~2^-8 of a term)."""
    B, S, KV, hd = k_shard.shape
    total = total or S
    H = q1.shape[1]
    qg = q1.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bngd,btnd->bngt", qg, k_shard).to(torch.float32)
    s *= hd ** -0.5
    if window and pos + 1 >= total:
        valid = torch.ones(S, dtype=torch.bool, device=q1.device)
    else:
        valid = torch.arange(offset, offset + S, device=q1.device) <= pos
    s = _where_masked(s, valid[None, None, None])
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bngt,btnd->bngd", p, v_shard.to(torch.float32))
    return m, p.sum(-1), o


def cache_write(cache, new, pos: int):
    """Write ``new`` [B,L,KV,hd] into ``cache`` [B,S,KV,hd] at slots
    ``pos .. pos+L-1``, in place (the reference's ``dynamic_update_slice``
    returns a new array).  The caller handles the ring modulo and, for a
    shard of a cache split over ``model``, the shard's offset (``pos`` is
    local); a write that would run off the end raises instead of being
    clamped."""
    L, S = new.shape[1], cache.shape[1]
    if not 0 <= pos <= S - L:
        raise IndexError(f"cache_write: slots {pos}..{pos + L - 1} outside a "
                         f"cache of {S}")
    cache[:, pos:pos + L] = new.to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Cross attention (VLM): kv from patch embeddings, no mask/rope.
# ---------------------------------------------------------------------------

def cross_attend(q, k, v):
    """q [B,S,H,hd] against k, v [B,T,KV,hd] (T patches), every query to
    every patch.  The scores are taken in the model dtype and scaled in
    float32, the softmax in float32 and cast back to ``q.dtype``, as in
    the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = _group(q, KV)
    s = torch.einsum("bsngd,btnd->bngst", qg, k).to(torch.float32) \
        * hd ** -0.5
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnd->bsngd", p, v)
    return out.reshape(B, S, H, hd)
