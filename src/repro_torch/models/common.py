"""Shared building blocks of the LM zoo, mirroring
``repro/models/common.py`` (and ``lane_exact``, the port's own): parameter construction with each parameter's
logical sharding spec, norms, activations, RoPE, the embedding lookup and
the cross-entropy loss.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import sharding as sh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def lane_exact(x: torch.Tensor) -> bool:
    """Whether clients train on ``x``'s device by the lane-exact form, in
    which a stacked lane's result is the same for every lane count, so the
    deferred engines equal the per-event one bit for bit: the CNN's im2col
    convolution (``cnn._conv3x3``), at least ``core.round.MIN_LANES``
    lanes a stacked call, the per-event client as one stacked lane.  Only
    on the CPU: on the card neither form is lane-exact (cuDNN and cuBLAS
    pick kernels by the batch) and this one costs time."""
    return x.device.type == "cpu"


class ParamBuilder:
    """Builds a nested ``dict[str, Tensor]`` of parameters with the
    reference's shapes, scales and ``init`` rules.  Every draw comes from
    ``generator`` on the generator's device, in float32, and is then cast
    to ``dtype`` on ``device``; a CUDA generator draws on the card.

    On the ``meta`` device it is the reference's abstract mode: each leaf
    is an empty tensor of its shape and dtype, so nothing is allocated or
    drawn (``generator`` may be None).  Each call site declares the
    parameter's logical sharding; ``specs`` collects them in a tree
    parallel to ``params``, so init and sharding cannot drift apart.

    ``keep(tensor, logical) -> tensor``, where given, is applied to each
    leaf as soon as it is drawn and only what it returns is held (a
    rank's share of the leaf: ``launch.specs.shard_leaf``), so the whole
    tree is never allocated."""

    def __init__(self, generator: torch.Generator | None, dtype, device,
                 keep: Callable | None = None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.keep = keep
        self.params: dict = {}
        self.specs: dict = {}

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)

    def add(self, path: list[str], shape, logical, init="normal",
            scale: float | None = None):
        """Create one parameter at params[path]; record its logical spec
        (one entry per dim) at specs[path]."""
        shape = tuple(shape)
        if self.device.type == "meta":
            val = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            val = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            val = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "normal":
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            val = self._normal(shape).mul_(s).to(self.device, self.dtype)
        elif callable(init):
            val = init(self.generator, shape).to(self.device, self.dtype)
        else:
            raise ValueError(init)
        if self.keep is not None:
            val = self.keep(val, tuple(logical))
        node, snode = self.params, self.specs
        for k in path[:-1]:
            node = node.setdefault(k, {})
            snode = snode.setdefault(k, {})
        node[path[-1]] = val
        snode[path[-1]] = tuple(logical)
        return val


def logical_to_pspec_tree(spec_tree, mesh):
    """A tree of logical-axis tuples -> the same tree of
    ``sharding.PartitionSpec`` for ``mesh`` (all replicated without one)."""
    if isinstance(spec_tree, dict):
        return {k: logical_to_pspec_tree(v, mesh)
                for k, v in spec_tree.items()}
    if mesh is None:
        return sh.P()
    return sh.P(*(sh.resolve(e, mesh) for e in spec_tree))


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-5):
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str) -> Callable:
    return {"gelu": _gelu, "silu": F.silu, "relu": F.relu}[name]


def glu_mlp(x, w1, w3, w2, act: str, tp: bool = False):
    """Gated MLP. act in {swiglu, geglu}; w3 is the gate projection.  With
    ``tp`` the weights are this rank's share of a split over ``model``:
    ``w1``/``w3`` its columns (column-parallel, the input copied to the
    split) and ``w2`` its rows (row-parallel, the partial outputs summed
    over ``model``)."""
    inner = act_fn({"swiglu": "silu", "geglu": "gelu"}[act])
    if tp:
        x = sh.copy_to_model(x)
    out = (inner(x @ w1) * (x @ w3)) @ w2
    return sh.reduce_from_model(out) if tp else out


def plain_mlp(x, w1, w2, act: str, tp: bool = False):
    """Ungated MLP; ``tp`` as in ``glu_mlp``."""
    if tp:
        x = sh.copy_to_model(x)
    out = act_fn(act)(x @ w1) @ w2
    return sh.reduce_from_model(out) if tp else out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [B, T, H, hd]; positions: [T] or [B, T] integers."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)   # [hd/2]
    ang = positions.to(torch.float32)[..., None] * freqs  # [T,hd/2] or [B,T,hd/2]
    while ang.ndim < x.ndim:                              # align to [B,T,H,hd/2]
        ang = ang[..., None, :] if ang.ndim == x.ndim - 1 else ang[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy_logits(logits, targets, vocab: int, chunk: int = 0):
    """Mean next-token CE.  logits [B, S, Vp] (Vp >= vocab; the padded
    columns get -1e9), targets [B, S] integers; with codebooks, logits
    [B, S, n_cb, Vp] and targets [B, S, n_cb], the mean over every
    codebook position.  The log-softmax is taken in float32.  With
    ``chunk`` > 0 the S dim is taken ``chunk`` positions at a time, their
    sums added in order, to bound the float32 workspace (vocab-heavy
    archs)."""
    vp = logits.shape[-1]

    def ce(lg, tg):
        lg = lg.to(torch.float32)
        if vp > vocab:
            pad = torch.arange(vp, device=lg.device) >= vocab
            lg = lg + pad.to(torch.float32) * -1e9
        lse = torch.logsumexp(lg, dim=-1)
        # gather takes int64 indices; the data's targets are int32
        picked = torch.gather(lg, -1, tg.to(torch.int64)[..., None])[..., 0]
        return lse - picked

    S = logits.shape[1]
    if chunk and S > chunk:
        n = S // chunk
        tot = torch.zeros((), dtype=torch.float32, device=logits.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            tot = tot + ce(logits[:, sl], targets[:, sl]).sum()
        if S - n * chunk:
            tot = tot + ce(logits[:, n * chunk:],
                           targets[:, n * chunk:]).sum()
        return tot / math.prod(targets.shape)
    return ce(logits, targets).mean()


def take_embedding(table, tokens, tp: bool = False):
    """Rows of the [V, D] ``table`` at ``tokens`` (any shape) -> [*, D].
    With ``tp`` the table is this rank's share of D (its spec ``(None,
    MODEL)``): the rank looks up its columns and the shares are gathered
    over ``model`` (backward: the rank's share of the equal cotangents).
    Its backward is ``index_select``'s, a scatter-add into the table's
    gradient: the transpose of ``jnp.take`` that the reference takes on one
    device (its one-hot contraction serves only a model-sharded mesh).  On
    the card the scatter adds with atomics, so a token seen twice sums its
    rows' gradients in no fixed order: equal to the CPU to float32
    rounding, not bit for bit."""
    out = table.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, table.shape[-1])
    return sh.gather_from_model(out, -1) if tp else out
