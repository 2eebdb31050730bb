"""xLSTM blocks [arXiv:2405.04517], mirroring ``repro/models/xlstm.py``:
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory, a true
recurrence over time), in train, prefill and decode modes.

mLSTM uses the chunkwise-parallel form of gated linear attention: within a
chunk the quadratic (decay-weighted) attention is computed directly, across
chunks a matrix state (C [hd, hd], normaliser n [hd], stabiliser m) is
carried, and decode is one O(1) recurrence step.  sLSTM has hidden-to-gate
feedback, so it cannot be parallelised over time: ``_scan_slstm`` is a
Python loop over the steps, where the reference runs ``lax.scan``.
Exponential gating is stabilised with the max-state m as in the paper.

The reference runs the sLSTM block under ``shard_map``, heads split over
``model``, in train and prefill mode when ``_head_shard_mesh`` finds a
mesh whose ``model`` axis is larger than 1, not excluded, and divides the
heads; otherwise it takes the unsharded path.  The port does the same on
the process's share of the batch (``models.sharding``'s SPMD convention),
in decode mode too: the gate projections ``w{i,f,z,o}`` are
column-parallel, and their contiguous share is the rank's heads; ``r*``,
``b*`` and the carry hold ``H / m`` heads; the loop over time runs on
them, and ``down`` is row-parallel.  The decode state stays whole over
``model`` (its spec ``(None, BATCH, None, None)``): a rank starts from its
heads' share of it and gathers the final carry whole.  Where the axis
divides ``D`` but not the heads, the split weights are gathered
(``gather_from_model``) and the block runs whole on every rank.  The
mLSTM's ``up`` is held as its spec's contiguous share of ``[u | z]``, so
each rank's product is gathered and cut to its channels of ``u`` and
``z`` (``sharding.pair_shares``); ``wq``/``wk``/``wv``/``wi``/``wf``
contract the channels (their partial products summed over ``model``), the
cell runs whole on every rank in every mode (its state ``C``, ``n``,
``m`` whole, as its specs say), and its output enters the row-parallel
``down`` cut to the rank's channels (``scatter_to_model``).  Under a
``data`` axis larger than 1 both blocks take their weights already
gathered over ``data`` (``up``, ``down`` and the sLSTM's ``w*`` cut on
their ``d_model`` dims at rest; ``transformer.LM`` gathers a layer at a
time), so the sizes read from the leaves (the mLSTM's ``du``) are the
gathered ones and the ``model`` logic is unchanged.

Nothing is written in place, so ``LM.loss_fn`` runs these mixers under the
round's ``vmap(grad_and_value)``.  Gate pre-activations, states and the
recurrences are float32; the projections run in the model dtype, and a
float32 state meets a model-dtype weight in float32, as JAX promotes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import sharding as sh

F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(pb, path, d_model: int, n_heads: int, cfg: XLSTMConfig,
               n_groups: int):
    du = int(cfg.proj_factor * d_model)
    g = (n_groups,) if n_groups else ()
    pre = (None,) if n_groups else ()
    add = pb.add
    add(path + ["up"], g + (d_model, 2 * du), pre + (sh.DATA, sh.MODEL))
    for w in ("wq", "wk", "wv"):
        add(path + [w], g + (du, du), pre + (sh.MODEL, None))
    add(path + ["wi"], g + (du, n_heads), pre + (sh.MODEL, None))
    add(path + ["wf"], g + (du, n_heads), pre + (sh.MODEL, None))
    add(path + ["bi"], g + (n_heads,), pre + (None,), init="zeros")
    # forget-gate bias 3: remember by default
    add(path + ["bf"], g + (n_heads,), pre + (None,),
        init=lambda gen, s: torch.full(s, 3.0, device=gen.device))
    add(path + ["down"], g + (du, d_model), pre + (sh.MODEL, sh.DATA))


def _mlstm_chunk(q, k, v, li, lf, C0, n0, m0):
    """One chunk of chunkwise-parallel mLSTM.
    q,k,v [B,H,L,hd]; li,lf log gates [B,H,L]; states C0 [B,H,hd,hd],
    n0 [B,H,hd], m0 [B,H].  Returns y [B,H,L,hd] + new states (f32)."""
    L, hd = q.shape[2], q.shape[3]
    f_cum = torch.cumsum(lf, dim=-1)                      # log prod f_1..t
    # decay from chunk start to t (inclusive), and total chunk decay
    g_t = f_cum                                            # [B,H,L]
    g_all = f_cum[..., -1]
    # intra-chunk log decay D[t,s] = sum_{u=s+1..t} lf_u + li_s  (s<=t)
    D = g_t[..., :, None] - g_t[..., None, :] + li[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(mask, D, torch.full_like(D, -torch.inf))
    # inter-chunk term decay: a_t = g_t + m0
    inter = g_t + m0[..., None]
    # amax (not max(dim)) shares the gradient among ties, as JAX's max does
    m_new = torch.maximum(D.amax(-1), inter)             # [B,H,L]
    Dn = torch.exp(D - m_new[..., None])                  # [B,H,L,L]
    an = torch.exp(inter - m_new)                         # [B,H,L]
    scale = hd ** -0.5
    s = torch.einsum("bhld,bhsd->bhls", q, k) * scale     # [B,H,L,L]
    qa = q * an[..., None] * scale
    num = torch.einsum("bhls,bhsd->bhld", s * Dn, v) \
        + torch.einsum("bhld,bhde->bhle", qa, C0)
    # normaliser: n_t = sum_s Dn * (q.k) + an * (q.n0)
    nq = torch.einsum("bhls,bhsd,bhld->bhl", Dn, k, q) * scale \
        + torch.einsum("bhd,bhld->bhl", n0, qa)
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_new))
    y = num / denom[..., None]
    # chunk-final states
    w_log = g_all[..., None] - g_t + li                   # [B,H,L]
    m_out = torch.maximum(g_all + m0, w_log.amax(-1))
    wC = torch.exp(w_log - m_out[..., None])
    carry = torch.exp(g_all + m0 - m_out)
    C_new = carry[..., None, None] * C0 \
        + torch.einsum("bhl,bhld,bhle->bhde", wC, k, v)
    n_new = carry[..., None] * n0 + torch.einsum("bhl,bhld->bhd", wC, k)
    return y, C_new, n_new, m_out


def mlstm_apply(p, x, *, n_heads: int, cfg: XLSTMConfig, mode="train",
                state=None):
    """x [B,S,D].  mode train/prefill: chunkwise scan from zero states
    (train returns (out, None), prefill (out, {"C", "n", "m"})).  mode
    decode: x [B,1,D] and ``state`` {"C": [B,H,hd,hd], "n": [B,H,hd], "m":
    [B,H]} f32."""
    B, S, _ = x.shape
    du = p["wq"].shape[1]
    hd = du // n_heads
    tp = sh.model_split(du)
    if tp > 1:
        u, z = sh.pair_shares(x, p["up"], du)              # [B,S,du/m] each
        proj = lambda w: sh.reduce_from_model(u @ w)
    else:
        u, z = (x @ p["up"]).chunk(2, dim=-1)             # [B,S,du]
        proj = lambda w: u @ w
    u = sh.shard(u, sh.BATCH, None, sh.MODEL)

    def heads(w):
        return proj(w).reshape(B, S, n_heads, hd).transpose(1, 2)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    # log-space input gate and log forget gate, [B,H,S] f32
    li = (proj(p["wi"]) + p["bi"]).transpose(1, 2).to(F32)
    lf = F.logsigmoid((proj(p["wf"]) + p["bf"]).transpose(1, 2).to(F32))

    if mode in ("train", "prefill"):
        L = min(cfg.chunk, S)
        C = torch.zeros((B, n_heads, hd, hd), dtype=F32, device=x.device)
        nrm = torch.zeros((B, n_heads, hd), dtype=F32, device=x.device)
        m = torch.zeros((B, n_heads), dtype=F32, device=x.device)
        ys = []
        for s0 in range(0, S, L):          # the last chunk may be shorter
            sl = slice(s0, min(s0 + L, S))
            y, C, nrm, m = _mlstm_chunk(
                q[:, :, sl].to(F32), k[:, :, sl].to(F32),
                v[:, :, sl].to(F32), li[..., sl], lf[..., sl], C, nrm, m)
            ys.append(y)
        y = torch.cat(ys, dim=2).transpose(1, 2).reshape(B, S, du)
        if tp > 1:
            y = sh.scatter_to_model(y, -1)
        out = (F.silu(z) * y.to(x.dtype)) @ p["down"]
        if tp > 1:
            out = sh.reduce_from_model(out)
        if mode == "prefill":
            return out, {"C": C, "n": nrm, "m": m}
        return out, None

    # decode step
    C, nrm, m = state["C"], state["n"], state["m"]
    q1, k1, v1 = (t[:, :, 0].to(F32) for t in (q, k, v))  # [B,H,hd]
    li1, lf1 = li[:, :, 0], lf[:, :, 0]
    m_new = torch.maximum(lf1 + m, li1)
    fw = torch.exp(lf1 + m - m_new)
    iw = torch.exp(li1 - m_new)
    C = fw[..., None, None] * C + iw[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k1, v1)
    nrm = fw[..., None] * nrm + iw[..., None] * k1
    qs = q1 * hd ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", nrm, qs)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, du).to(x.dtype)
    if tp > 1:
        y = sh.scatter_to_model(y, -1)
    out = (F.silu(z) * y) @ p["down"]
    if tp > 1:
        out = sh.reduce_from_model(out)
    return out, {"C": C, "n": nrm, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(pb, path, d_model: int, n_heads: int, n_groups: int):
    """The recurrent matrices are block-diagonal per head ([H, hd, hd]);
    the gate projections are dense [D, D]."""
    hd = d_model // n_heads
    g = (n_groups,) if n_groups else ()
    pre = (None,) if n_groups else ()
    add = pb.add
    for gate in ("i", "f", "z", "o"):
        add(path + [f"w{gate}"], g + (d_model, d_model),
            pre + (sh.DATA, sh.MODEL))
        add(path + [f"r{gate}"], g + (n_heads, hd, hd),
            pre + (sh.MODEL, None, None))
        add(path + [f"b{gate}"], g + (d_model,), pre + (sh.MODEL,),
            init="zeros" if gate != "f" else (
                lambda gen, s: torch.full(s, 3.0, device=gen.device)))
    add(path + ["down"], g + (d_model, d_model), pre + (sh.MODEL, sh.DATA))


def _slstm_step(rp, carry, xt):
    """One sLSTM time step.  ``rp``: the recurrent matrices [H,hd,hd] in
    float32; ``carry`` (c, n, h, m) and ``xt`` (the four pre-projected gate
    inputs), each [B,H,hd] f32."""
    c, n, h, m = carry

    def rec(w):  # block-diagonal recurrent projection, within each head
        return torch.einsum("bhd,hde->bhe", h, w)

    xi, xf, xz, xo = xt
    i_t = xi + rec(rp["ri"])
    f_t = xf + rec(rp["rf"])
    z_t = torch.tanh(xz + rec(rp["rz"]))
    o_t = torch.sigmoid(xo + rec(rp["ro"]))
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    i_w = torch.exp(i_t - m_new)
    f_w = torch.exp(lf + m - m_new)
    c_new = f_w * c + i_w * z_t
    n_new = torch.maximum(f_w * n + i_w, torch.exp(-m_new))
    h_new = o_t * c_new / n_new
    return c_new, n_new, h_new, m_new


def _scan_slstm(rp, xs, carry0):
    """The sLSTM over time, one step at a time.  xs: the four gate inputs,
    each [S,B,H,hd].  Returns (last carry, hs [S,B,H,hd])."""
    carry, hs = carry0, []
    for t in range(xs[0].shape[0]):
        carry = _slstm_step(rp, carry, tuple(x[t] for x in xs))
        hs.append(carry[2])
    return carry, torch.stack(hs)


def _head_shard_mesh(n_heads: int, d_model: int) -> int:
    """The reference's decision to split the sLSTM's heads over ``model``:
    the shards, where a ``model`` axis larger than 1 that ``exclude_axes``
    has not dropped divides the heads (and ``D``); else 1."""
    return sh.model_split(n_heads, d_model)


def slstm_apply(p, x, *, n_heads: int, mode="train", state=None):
    """x [B,S,D].  ``state`` (prefill: the zeroed decode state, decode: the
    running one) is {"c", "n", "h", "m"}, each [B,H,hd] f32; with none
    (train) the carry starts at zero with n = 1e-6.  Returns (out, state),
    state None in train mode.  Under a ``model`` axis the heads split over
    it (``_head_shard_mesh``): the rank starts from its heads' share of a
    given state and returns the final state gathered whole."""
    B, S, D = x.shape
    H, hd = n_heads, D // n_heads
    m = _head_shard_mesh(n_heads, D)
    split = m == 1 and sh.model_split(D) > 1
    if split:
        # the weights are split over `model` at rest but the heads are not
        # whole in a share: gathered, and the block runs whole everywhere
        p = dict(p, down=sh.gather_from_model(p["down"], 0),
                 **{f"{k}{g}": sh.gather_from_model(p[f"{k}{g}"], -1)
                    for k in "wb" for g in "ifzo"})
    if m > 1:
        x = sh.copy_to_model(x)
    H, Dl = H // m, D // m
    if state is None:
        z0 = torch.zeros((B, H, hd), dtype=F32, device=x.device)
        state = {"c": z0, "n": z0 + 1e-6, "h": z0, "m": z0}
    elif m > 1:
        state = {k: sh.scatter_to_model(v, 1) for k, v in state.items()}
    carry0 = (state["c"], state["n"], state["h"], state["m"])
    rp = {k: p[k].to(F32) for k in ("ri", "rf", "rz", "ro")}
    gates = tuple(x @ p[f"w{g}"] + p[f"b{g}"] for g in "ifzo")
    if mode in ("train", "prefill"):
        xs = tuple(a.transpose(0, 1).to(F32).reshape(S, B, H, hd)
                   for a in gates)
        carry, hs = _scan_slstm(rp, xs, carry0)
        y = hs.transpose(0, 1).reshape(B, S, Dl).to(x.dtype)
    else:
        xt = tuple(a[:, 0].to(F32).reshape(B, H, hd) for a in gates)
        carry = _slstm_step(rp, carry0, xt)
        y = carry[2].reshape(B, 1, Dl).to(x.dtype)
    out = y @ p["down"]
    if m > 1:
        out = sh.reduce_from_model(out)
    if mode == "train":
        return out, None
    if m > 1:
        carry = tuple(sh.gather_from_model(c, 1) for c in carry)
    return out, dict(zip("cnhm", carry))
