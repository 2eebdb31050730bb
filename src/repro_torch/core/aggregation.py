"""Aggregation strategies for federated updates (paper §4.4), mirroring
``repro/core/aggregation.py``.  Operates on stacked client deltas (a dict
of tensors with a leading client dim C).  Ported here: fedavg (mask/weight
normalised mean) and weighted (data size x inverse training loss).
``trimmed_mean`` is not ported yet (ROADMAP queue 1)."""
from __future__ import annotations

import torch


def effective_weights(weights, mask, losses=None, mode: str = "fedavg"):
    """[C] weights combined with the participation mask (and losses)."""
    w = weights * mask
    if mode == "weighted" and losses is not None:
        w = w / (1.0 + torch.clamp(losses, min=0.0))
    return w


def weighted_mean(deltas: dict, w) -> dict:
    """deltas: dict of [C, ...] tensors;  w: [C]."""
    denom = torch.clamp(w.sum(), min=1e-12)

    def agg(d):
        wb = w.reshape((-1,) + (1,) * (d.ndim - 1)).to(d.dtype)
        return (d * wb).sum(0) / denom.to(d.dtype)

    return {k: agg(d) for k, d in deltas.items()}
