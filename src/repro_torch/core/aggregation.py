"""Aggregation strategies for federated updates (paper §4.4), mirroring
``repro/core/aggregation.py``.  Operates on stacked client deltas (a dict
of tensors with a leading client dim C):
  * fedavg        — mask/weight-normalised mean (weights = data sizes),
  * weighted      — data size x inverse training loss,
  * trimmed_mean  — coordinate-wise trimmed mean over clients."""
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


def trimmed_mean(deltas: dict, mask, trim_frac: float = 0.1) -> dict:
    """Coordinate-wise trimmed mean over clients.  Non-participating clients
    (mask 0) contribute zero deltas, which the trimming largely discards for
    the extreme coordinates; robust-aggregation callers should pass a full
    mask."""
    C = mask.shape[0]
    k = int(trim_frac * C)

    def agg(d):
        s = torch.sort(d, dim=0).values
        if k:
            s = s[k:C - k]
        return s.mean(0)

    return {name: agg(d) for name, d in deltas.items()}
