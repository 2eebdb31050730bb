"""Mixture-of-Experts layer, mirroring ``repro/models/moe.py``.

Under a mesh the reference runs the layer expert-parallel in a shard_map:
the experts split over ``model`` (a shard owns ``E / model`` experts from
``e_lo = model index * E / model``), the expert F dim over ``data``, the
tokens over whichever batch axes divide the batch, with weight or token
gathers and ``psum`` combines.  Under the port's SPMD convention
(``models.sharding``) ``x`` is the process's share of the batch, whole on
every ``model`` rank, and the expert weights are held at rest as their
spec cuts them: the rank's ``E / model`` experts and its ``F / data``
share of their hidden dim, where the axes divide them.  The reference's
two layouts:

* ``gather_weights`` (train and prefill): the expert F dim is gathered
  over ``data`` inside the layer, once a layer (a transient ZeRO-3
  gather, ``sharding.gather_from_data``, whose backward sums the
  gradient over ``data`` and keeps the rank's share).  The process's own
  tokens are routed with the whole router on every rank, the capacity
  from the local token count, dispatched to the rank's experts (ids
  offset by ``e_lo``), and the ranks' outputs summed over ``model``
  (``reduce_from_model``); the tokens and gates enter the expert split
  through ``copy_to_model``, so the router and the tokens take the whole
  gradient.  The aux loss is computed whole on every rank, the
  reference's ``pmean`` over ``model`` of equal values.
* ``gather_tokens`` (decode; it serves only): the tokens are all-gathered
  over the axes that split the batch and routed with the whole router,
  with the capacity from the gathered count, as the reference's
  ``shard_map`` computes it; F stays cut, so each rank's experts give
  partial sums over its F share.  The output is summed over ``model``,
  then over ``data`` (``reduce_from_data``: the F partials), and the
  process's rows kept; the aux loss takes its ``pmean`` over ``data``.

A client body whose client dim owns ``data`` (``exclude_axes``) holds the
experts whole over it, and both layouts run with F whole.

Dispatch is sort-based with a fixed capacity per expert: the token
assignments are stably sorted by expert, each keeps its rank within its
expert's segment, and ranks at or beyond the capacity are dropped.  No
[T, E, C] one-hot dispatch tensor is built.  Empty capacity slots point at
token 0 with gate 0.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import sharding as sh
from repro_torch.models.common import act_fn


def init_moe(pb, path, d_model: int, cfg: MoEConfig, n_groups: int):
    E, Fd = cfg.num_experts, cfg.d_expert
    g = (n_groups,) if n_groups else ()
    pre = (None,) if n_groups else ()
    # the router is tiny ([D, E]): replicated, so routing gathers no weight
    pb.add(path + ["router"], g + (d_model, E), pre + (None, None))
    pb.add(path + ["w1"], g + (E, d_model, Fd), pre + (sh.MODEL, None, sh.DATA))
    pb.add(path + ["w3"], g + (E, d_model, Fd), pre + (sh.MODEL, None, sh.DATA))
    pb.add(path + ["w2"], g + (E, Fd, d_model), pre + (sh.MODEL, sh.DATA, None))


def _route(x2d, router, cfg: MoEConfig):
    """x2d [T, D] -> (expert ids [T,K], gate weights [T,K], aux loss)."""
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # [T, E]
    gate, eid = torch.topk(probs, cfg.top_k, dim=-1)              # [T, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    E = cfg.num_experts
    # a comparison, not F.one_hot, which reads its input's max on the host
    # and so cannot run under the round's vmap
    hard = (eid[:, :1] == torch.arange(E, device=eid.device)).to(
        torch.float32)
    aux = E * torch.mean(hard.mean(0) * probs.mean(0))
    return eid, gate.to(x2d.dtype), aux


def _dispatch_indices(eid, gate, e_lo: int, e_n: int, capacity: int):
    """Sort-based capacity dispatch for local experts [e_lo, e_lo+e_n).

    Returns tok_idx [e_n, C] (into the flat token dim; slot 0 used for
    dropped/empty with gate 0) and gates [e_n, C]."""
    T, K = eid.shape
    dev = eid.device
    flat_e = eid.reshape(-1)                                       # [T*K]
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    local = flat_e - e_lo
    in_range = (local >= 0) & (local < e_n)
    key = torch.where(in_range, local, torch.full_like(local, e_n))
    order = torch.argsort(key, stable=True)
    k_sorted = key[order]
    # rank within each expert segment
    seg_start = torch.searchsorted(
        k_sorted, torch.arange(e_n + 1, device=dev, dtype=k_sorted.dtype))
    rank = torch.arange(T * K, device=dev) - seg_start[k_sorted.clamp(0, e_n)]
    keep = (k_sorted < e_n) & (rank < capacity)
    e_slot = torch.where(keep, k_sorted, torch.full_like(k_sorted, e_n))
    c_slot = torch.where(keep, rank, torch.zeros_like(rank))
    # dropped assignments all land in row e_n, which is cut off below; the
    # writes are out of place (index_put), which vmap takes
    idx = (e_slot, c_slot)
    tok_idx = torch.zeros((e_n + 1, capacity), dtype=torch.int64,
                          device=dev).index_put(idx, flat_t[order])
    gates = torch.zeros((e_n + 1, capacity), dtype=flat_g.dtype,
                        device=dev).index_put(
        idx, torch.where(keep, flat_g[order], torch.zeros_like(flat_g)))
    return tok_idx[:e_n], gates[:e_n]


def _expert_ffn(xs, w1, w3, w2, act: str):
    """xs [E, C, D] through per-expert gated FFN."""
    h1 = torch.einsum("ecd,edf->ecf", xs, w1)
    if act in ("swiglu", "geglu"):
        inner = act_fn({"swiglu": "silu", "geglu": "gelu"}[act])
        h = inner(h1) * torch.einsum("ecd,edf->ecf", xs, w3)
    else:
        h = act_fn(act)(h1)
    return torch.einsum("ecf,efd->ecd", h, w2)


def _moe_local(x, router, w1, w3, w2, *, cfg: MoEConfig, act: str,
               tp: bool = False):
    """The MoE body over the local experts: all of them, or with ``tp``
    the rank's ``E / model`` from ``e_lo``.  x [B, S, D]; w1/w3 [E, D, F],
    w2 [E, F, D].  Returns (out [B, S, D], aux).

    The combine is an ``index_add_`` over the flat token dim.  Each token
    receives at most ``top_k`` nonzero terms plus exact zeros (empty
    capacity slots point at token 0 with gate 0), so the order in which
    the card's atomics add them does not change the result."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    E = w1.shape[0]
    eid, gate, aux = _route(x2d, router, cfg)
    e_lo = 0
    if tp:
        e_lo = sh.model_index() * E
        x2d, gate = sh.copy_to_model(x2d), sh.copy_to_model(gate)
    cap = max(int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 4)
    tok_idx, gates = _dispatch_indices(eid, gate, e_lo, E, cap)
    flat_idx = tok_idx.reshape(-1)
    xs = x2d[flat_idx].reshape(E, cap, D)
    ys = _expert_ffn(xs, w1, w3, w2, act)
    out = torch.zeros_like(x2d).index_add_(
        0, flat_idx, (gates[..., None] * ys).reshape(-1, D))
    if tp:
        out = sh.reduce_from_model(out)
    return out.reshape(B, S, D), aux


def moe_apply(p, x, *, cfg: MoEConfig, act: str, mode: str = "gather_weights"):
    """x [B, S, D]; p has router/w1/w3/w2 (already sliced to this layer),
    the experts as the rank holds them at rest.

    The reference's two modes, ``gather_weights`` (train/prefill) and
    ``gather_tokens`` (decode), differ only in which operand their mesh
    gathers: ``gather_weights`` gathers the experts' F over ``data`` and
    routes the local tokens to the rank's experts, ``gather_tokens``
    gathers the tokens over the axes that split the batch and sums the
    F partials over ``data``; off a mesh, or on one device, they are the
    same computation."""
    if mode not in ("gather_weights", "gather_tokens"):
        raise ValueError(mode)
    tp = sh.model_split(cfg.num_experts) > 1
    f_cut = sh.data_split(cfg.d_expert) > 1
    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    if mode == "gather_weights":
        if f_cut:
            # the transient ZeRO-3 gather of the expert F dim, once a layer
            w1, w3 = (sh.gather_from_data(w, -1) for w in (w1, w3))
            w2 = sh.gather_from_data(w2, -2)
        return _moe_local(x, p["router"], w1, w3, w2, cfg=cfg, act=act,
                          tp=tp)
    tok_axes = sh.batch_split_axes()
    B = x.shape[0]
    out, aux = _moe_local(sh.all_gather(x, tok_axes, 0), p["router"], w1,
                          w3, w2, cfg=cfg, act=act, tp=tp)
    if f_cut:
        out = sh.reduce_from_data(out)          # the F partials summed
        aux = sh.pmean(aux, sh.DATA)
    i = sh.shard_index(tok_axes)
    return out[i * B:(i + 1) * B], aux
