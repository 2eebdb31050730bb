"""Mamba (S6) block: selective state-space model with a chunked scan,
mirroring ``repro/models/mamba.py`` in train, prefill and decode modes.

Every chunk of the train and prefill scans, the remainder chunk included,
goes through ``kernels.ops.selective_scan_chunk``: the reference's
``use_kernel=True`` path.  A CPU tensor takes the scan's plain version, a
CUDA tensor the hand-written kernel; in train mode its backward is the
kernel ``selective_scan_bwd``, under the round's ``torch.func`` transforms
too.  The decay ``a`` and drive ``b`` are materialised as [B, S, d_inner,
d_state] float32, as in the reference, and each chunk is a view of them
that the kernel reads in place.  Decode is one recurrence step with no
scan.  The reference's default (``use_kernel=False``) scans each chunk
associatively, which rounds differently from the sequential scan: the two
agree to about 1e-6 relative.

Under a ``model`` axis larger than 1 (``models.sharding``), in every mode,
the ``d_inner`` channels split over ``model``.  ``in_proj`` is held at rest
as its spec's contiguous share of the ``2 * d_inner`` columns ``[x | z]``,
which is not the rank's channels of both halves, so each rank multiplies
its share and the products are gathered and cut to the rank's channels of
``x`` and of ``z`` (``sharding.pair_shares``).  ``conv_w``, ``conv_b``,
``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` are channel-local;
``x_proj`` contracts the channels (its partial products summed over
``model``, then fed to every rank's channels), and ``out_proj`` is
row-parallel.  The scan and its backward run on the rank's ``[B, L,
d_inner / m, N]``, and the decode state (``conv`` [B, d_conv-1, di/m], ``h``
[B, di/m, N]) holds the same channels, the share its spec
``(None, BATCH, None, MODEL)`` / ``(None, BATCH, MODEL, None)`` cuts.

Under a ``data`` axis larger than 1 the block takes its weights already
gathered over ``data`` (``in_proj``'s and ``out_proj``'s ``d_model``
dims; ``transformer.LM`` gathers a layer at a time), so every size read
from a leaf (``dt_proj``'s rank) is the gathered one, and the ``model``
logic above is unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as sh


def dt_rank(d_model: int, cfg: MambaConfig) -> int:
    return cfg.dt_rank or math.ceil(d_model / 16)


def _dt_bias_init(generator, shape):
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32) * (hi - lo) + lo
    return torch.log(torch.expm1(torch.exp(u)))


def init_mamba(pb, path, d_model: int, cfg: MambaConfig, n_groups: int):
    di = cfg.expand * d_model
    R = dt_rank(d_model, cfg)
    N = cfg.d_state
    g = (n_groups,) if n_groups else ()
    pre = (None,) if n_groups else ()
    add = pb.add
    add(path + ["in_proj"], g + (d_model, 2 * di), pre + (sh.DATA, sh.MODEL))
    add(path + ["conv_w"], g + (cfg.d_conv, di), pre + (None, sh.MODEL))
    add(path + ["conv_b"], g + (di,), pre + (sh.MODEL,), init="zeros")
    add(path + ["x_proj"], g + (di, R + 2 * N), pre + (sh.MODEL, None))
    add(path + ["dt_proj"], g + (R, di), pre + (None, sh.MODEL))
    add(path + ["dt_bias"], g + (di,), pre + (sh.MODEL,),
        init=_dt_bias_init)
    add(path + ["A_log"], g + (di, N), pre + (sh.MODEL, None),
        init=lambda gen, s: torch.log(torch.arange(
            1, N + 1, dtype=torch.float32,
            device=gen.device)).expand(s).contiguous())
    add(path + ["D"], g + (di,), pre + (sh.MODEL,), init="ones")
    add(path + ["out_proj"], g + (di, d_model), pre + (sh.MODEL, sh.DATA))


def _ssm_coeffs(x, p, cfg: MambaConfig, in_place: bool = True,
                tp: bool = False):
    """x [B, L, di] -> decay a [B,L,di,N], drive b [B,L,di,N], C [B,L,N].

    ``dt`` stays in the model dtype and ``dt * B`` is formed there before
    the cast to float32, as in the reference; ``a`` is formed in float32.
    With ``tp`` the channels are the rank's share of a split over
    ``model``: ``x_proj``'s partial products are summed over ``model``.
    With ``in_place`` (prefill and decode) the elementwise passes over [B,
    L, di, N] run in place where the reference makes a new array: the
    values are the same.  Train mode writes nothing in place, for autograd
    and the round's vmap."""
    N = cfg.d_state
    R = p["dt_proj"].shape[0]
    proj = x @ p["x_proj"]                                  # [B,L,R+2N]
    if tp:
        # the channels' partial sums, whole, then into each rank's channels
        proj = sh.copy_to_model(sh.reduce_from_model(proj))
    dt_in, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    # F.softplus is linear above 20, where jax.nn.softplus (logaddexp(x, 0))
    # differs from x by less than 1e-8 relative
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])   # [B,L,di]
    A = -torch.exp(p["A_log"].to(torch.float32))           # [di, N]
    a = dt.to(torch.float32)[..., None] * A                # [B,L,di,N]
    b = (dt[..., None] * Bc[..., None, :]).to(torch.float32)
    if in_place:
        return torch.exp_(a), b.mul_(x[..., None].to(torch.float32)), Cc
    return torch.exp(a), b * x[..., None].to(torch.float32), Cc


def selective_scan_chunked(a, b, C, h0, chunk: int):
    """Full-sequence selective scan via chunks.  a,b [B,S,di,N]; C [B,S,N].
    Returns y [B,S,di] and final state [B,di,N]."""
    B, S, di, N = a.shape
    chunk = min(chunk, S)
    ys, h = [], h0
    for s0 in range(0, S, chunk):          # the last chunk may be shorter
        s1 = min(s0 + chunk, S)
        hs, h = kops.selective_scan_chunk(a[:, s0:s1], b[:, s0:s1], h)
        ys.append(torch.einsum("bldn,bln->bld", hs, C[:, s0:s1].to(hs.dtype)))
        del hs
    return torch.cat(ys, dim=1), h


def mamba_apply(p, x, *, cfg: MambaConfig, mode: str = "train",
                state=None):
    """x [B,S,D].  mode train/prefill: full scan (train returns (out, None),
    prefill (out, state)).  mode decode: x [B,1,D] with state {"conv":
    [B,d_conv-1,di], "h": [B,di,N]}."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    B, S, D = x.shape
    di = cfg.expand * D
    N = cfg.d_state
    m = sh.model_split(di)
    if m > 1:
        xin, z = sh.pair_shares(x, p["in_proj"], di)        # [B,S,di/m] each
        di //= m
    else:
        xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)        # [B,S,di] each
    xin = sh.shard(xin, sh.BATCH, None, sh.MODEL)

    if mode in ("train", "prefill"):
        # causal depthwise conv, summed in the reference's order
        pad = torch.zeros((B, cfg.d_conv - 1, di), dtype=xin.dtype,
                          device=xin.device)
        xpad = torch.cat([pad, xin], dim=1)
        conv = xpad[:, 0:S] * p["conv_w"][0]
        for i in range(1, cfg.d_conv):
            conv = conv + xpad[:, i:i + S] * p["conv_w"][i]
        conv = F.silu(conv + p["conv_b"])
        a, b, Cc = _ssm_coeffs(conv, p, cfg, in_place=mode == "prefill",
                               tp=m > 1)
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        y, h_last = selective_scan_chunked(a, b, Cc, h0, cfg.chunk)
        del a, b
        y = y.to(x.dtype) + conv * p["D"]
        out = (F.silu(z) * y) @ p["out_proj"]
        if m > 1:
            out = sh.reduce_from_model(out)
        if mode == "train":
            return out, None
        # keep the last d_conv-1 raw (pre-conv) inputs for decode
        new_state = {"conv": xpad[:, -(cfg.d_conv - 1):], "h": h_last}
        return out, new_state

    # decode: single token
    conv_state, h = state["conv"], state["h"]               # [B,dc-1,di], [B,di,N]
    x1 = xin[:, 0]                                          # [B,di]
    window = torch.cat([conv_state, x1[:, None]], dim=1)    # [B,dc,di]
    conv = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    conv = F.silu(conv)[:, None]                            # [B,1,di]
    a, b, Cc = _ssm_coeffs(conv, p, cfg, tp=m > 1)
    h_new = a[:, 0] * h + b[:, 0]                           # [B,di,N]
    y = torch.einsum("bdn,bn->bd", h_new, Cc[:, 0].to(h_new.dtype))
    y = y.to(x.dtype)[:, None] + conv * p["D"]
    out = (F.silu(z) * y) @ p["out_proj"]
    if m > 1:
        out = sh.reduce_from_model(out)
    return out, {"conv": window[:, 1:], "h": h_new}
