"""Staleness-aware asynchronous (FedBuff-style) server aggregation,
mirroring ``repro/core/async_round.py``.

Clients train against whatever params snapshot they were handed; their
deltas land in a bounded server buffer whenever they finish, and the server
commits an aggregate every K arrivals (or T seconds of quiet).  An update
computed ``s`` commits ago is discounted, not discarded:

    w_eff[i] = effective_weights(weights, mask)[i] * 1 / (1 + s_i)^a

and the committed delta is normalised by the UN-discounted weight mass
(``sum w_eff * d / sum w_raw``), so a buffer whose updates are all equally
stale takes a ``1/(1+s)^a``-scaled step rather than a full one.

Split of responsibilities (as in ``core/round.py``):
  * ``build_client_update_step`` — one client's local training,
    ``(params_snapshot, batches[H, b, ...]) -> (delta, loss)``: the sync
    path's ``build_local_train``, so FedProx and the fused update kernel
    behave as they do there.
  * ``build_buffer_commit_step`` — the server step over a FIXED-K buffer:
    ``(params, server_state, deltas[K, ...], weights[K], staleness[K],
    losses[K], mask[K], ids[K], exponent, generator) -> (params', state',
    metrics)``.  Timeout commits with fewer than K live updates pad with
    zero deltas, weight 0 and mask 0.  The transform is the SAME
    ``core.pipeline`` stage stack the sync modes use: the fused kernels
    take the raw weights, the staleness and the exponent and compute the
    discount themselves.  ``ids`` carries unique per-commit slot indices
    that key the secure-aggregation masks; ``exponent`` is a runtime float,
    so the adaptive controller below moves it between commits.
  * ``build_chunked_commit_steps`` — the same commit accumulated C slots at
    a time, one call per chunk, normalised and applied once.
  * Event ordering, buffer policy, staleness bookkeeping and comm
    accounting are host-side: ``repro_torch.orchestrator.async_server``.

With staleness zero, a full mask and no compression, one buffer commit over
the C deltas of a sync round gives the sync round's new params.

Under a mesh of processes (``models.sharding``) every process calls the
commit with the same whole buffer: the K slots stay whole on every
process, and the commit kernels split the bucket's rows over the mesh's
fusion axes, each process on its rows, the rows then gathered
(``kernels/ops.rows_reduce``).  Where the params are cut over ``data``
and ``model`` at rest, so are the buffer's deltas, and ``cuts``
(``launch.specs.leaf_cuts``' ``{leaf: {axis: dim}}``) says how: the
commit runs on the shares (``pipeline.model_commit``) and returns the
rank's share.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import numpy as np
import torch

from repro_torch.core.pipeline import (build_update_pipeline,  # noqa: F401
                                       staleness_weights)
from repro_torch.core.round import FLConfig, build_local_train, global_norm
from repro_torch.models.common import lane_exact
from repro_torch.optim import Optimizer, ServerOptimizer


@dataclass(frozen=True)
class AsyncConfig:
    """Policy knobs of the buffered-asynchronous execution regime."""
    buffer_size: int = 8            # K: commit every K buffered updates
    staleness_exponent: Union[float, str] = 0.5  # a in 1/(1+s)^a (0 -> no
    #                                 discount), or "adaptive": the online
    #                                 alpha of AdaptiveStalenessController
    max_staleness: int = 20         # drop updates staler than this
    commit_timeout_s: float = 0.0   # T: commit a partial buffer once its
    #                                 oldest update has waited T sim-seconds
    #                                 without a K-commit (0 = off)
    max_concurrency: int = 16       # clients training at once
    commit_chunk: int = 0           # C: accumulate the buffer in C-sized
    #                                 chunks (one call per chunk, one
    #                                 normalise + apply at the end); 0 = the
    #                                 single-shot commit.  Equal in exact
    #                                 arithmetic; float sums in another order
    #                                 agree to ~1e-5

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.max_concurrency < 1:
            raise ValueError(
                f"max_concurrency must be >= 1, got {self.max_concurrency}")
        if self.commit_chunk < 0:
            raise ValueError(
                f"commit_chunk must be >= 0 (0 = single-shot commit), got "
                f"{self.commit_chunk}")
        if isinstance(self.staleness_exponent, str):
            if self.staleness_exponent != "adaptive":
                raise ValueError(
                    f"staleness_exponent must be a non-negative float or "
                    f"'adaptive', got {self.staleness_exponent!r}")
        elif self.staleness_exponent < 0:
            raise ValueError("staleness_exponent must be non-negative")
        if self.max_staleness < 0 or self.commit_timeout_s < 0:
            raise ValueError("max_staleness and commit_timeout_s must be "
                             "non-negative")

    @property
    def adaptive_staleness(self) -> bool:
        return self.staleness_exponent == "adaptive"

    def initial_exponent(self) -> float:
        return (AdaptiveStalenessController().alpha
                if self.adaptive_staleness else float(self.staleness_exponent))


class AdaptiveStalenessController:
    """Online FedAsync-style staleness exponent (host numpy, deterministic).

    Picks ``a`` so that the discount at the OBSERVED tail staleness (an EMA
    of each commit's p90) equals ``w_floor``:

        a = ln(1/w_floor) / ln(1 + s_p90)

    A fleet whose updates arrive barely stale gets a sharp exponent; one
    where high staleness is the norm gets a gentle one, so slow sites keep
    contributing.  A drift brake tightens the discount whenever the
    committed step norm rises above its EMA.  ``state()``/``set_state()``
    make it checkpointable, so a resumed run replays the same exponents."""

    def __init__(self, w_floor: float = 0.1, alpha0: float = 0.5,
                 alpha_min: float = 0.05, alpha_max: float = 4.0,
                 ema: float = 0.8, drift_gain: float = 1.0):
        self.w_floor = w_floor
        self.alpha = alpha0
        self.alpha_min, self.alpha_max = alpha_min, alpha_max
        self.ema = ema
        self.drift_gain = drift_gain
        self._stale_p90 = 0.0
        self._norm_ema = None

    def update(self, staleness, delta_norm: float) -> float:
        """Feed one commit's staleness values and committed delta norm;
        returns the alpha for the NEXT commit."""
        if len(staleness):
            p90 = float(np.quantile(np.asarray(staleness, np.float64), 0.9))
            self._stale_p90 = (self.ema * self._stale_p90
                               + (1.0 - self.ema) * p90)
        if self._stale_p90 > 0:
            base = np.log(1.0 / self.w_floor) / np.log1p(self._stale_p90)
        else:
            base = self.alpha_max     # nothing is stale: discount is inert
        drift = 0.0
        if delta_norm == delta_norm:  # skip NaN (empty commits)
            if self._norm_ema is None:
                self._norm_ema = float(delta_norm)
            else:
                drift = max(0.0, (float(delta_norm) - self._norm_ema)
                            / (self._norm_ema + 1e-12))
                self._norm_ema = (self.ema * self._norm_ema
                                  + (1.0 - self.ema) * float(delta_norm))
        self.alpha = float(np.clip(base * (1.0 + self.drift_gain * drift),
                                   self.alpha_min, self.alpha_max))
        return self.alpha

    def state(self) -> dict:
        return {"alpha": self.alpha, "stale_p90": self._stale_p90,
                "norm_ema": self._norm_ema}

    def set_state(self, s: dict):
        self.alpha = float(s["alpha"])
        self._stale_p90 = float(s["stale_p90"])
        self._norm_ema = (None if s["norm_ema"] is None
                          else float(s["norm_ema"]))


def _refuse_trimmed_mean(cfg: FLConfig):
    if cfg.aggregation == "trimmed_mean":
        raise ValueError(
            "aggregation='trimmed_mean' is not supported by the async "
            "buffered commit (robust trimming over a padded, "
            "staleness-weighted buffer is undefined); use fedavg/weighted "
            "or the sync round loop")


def build_client_update_step(loss_fn: Callable, client_opt: Optimizer,
                             cfg: FLConfig):
    """``(params_snapshot, batches[H, b, ...]) -> (delta, loss)``: the sync
    path's local training for ONE client, against the params snapshot it
    was dispatched with.  Local training draws no randomness.  Where
    clients train lane-exact (``models.common.lane_exact``: on the CPU)
    the client trains as one lane of the stacked step, as the batched
    engines' clients do, so every engine computes a client bit for bit
    alike; elsewhere it trains unstacked."""
    single = build_local_train(loss_fn, client_opt, cfg)
    stacked = build_local_train(loss_fn, client_opt, cfg, stacked=True)

    def client_update(params: dict, batches: dict):
        if not lane_exact(next(iter(batches.values()))):
            return single(params, batches)
        delta, loss = stacked(params, {k: v[None] for k, v in
                                       batches.items()})
        return {k: d[0] for k, d in delta.items()}, loss[0]

    return client_update


def build_buffer_commit_step(server_opt: ServerOptimizer, cfg: FLConfig,
                             async_cfg: AsyncConfig, cuts=None):
    """The server commit over a fixed-size buffer of K client deltas:

    commit(params, server_state, deltas, weights, staleness, losses, mask,
           ids, exponent, generator) -> (new_params, new_server_state,
                                         metrics)

    ``deltas`` values are [K, ...]; ``weights``/``staleness``/``losses``/
    ``mask`` are [K]; ``ids`` [K] int32 unique slot indices; ``exponent``
    the discount's ``a`` (a float).  Padding slots carry mask 0: their
    deltas and their masks never contribute.  ``losses`` feeds
    aggregation='weighted' as in the sync round; 'trimmed_mean' is refused
    here, when the step is built.  ``cuts``: ``{leaf: {axis: dim}}`` of
    each leaf cut at rest (the deltas are the rank's shares)."""
    _refuse_trimmed_mean(cfg)
    pipe = build_update_pipeline(cfg)

    def commit(params, server_state, deltas, weights, staleness, losses,
               mask, ids, exponent, generator):
        delta, w_eff, _, _ = pipe.model_commit(
            lambda d: pipe.combine(
                d, weights, mask, losses, generator, ids=ids,
                staleness=staleness, exponent=exponent), deltas, cuts)
        new_params, new_state = server_opt.apply(params, delta, server_state)
        metrics = {
            "delta_norm": global_norm(delta, cuts),
            "n_updates": mask.sum(),
            "mean_staleness": (staleness * mask).sum()
            / torch.clamp(mask.sum(), min=1),
            "effective_weight": w_eff.sum(),
        }
        return new_params, new_state, metrics

    return commit


def build_chunked_commit_steps(server_opt: ServerOptimizer, cfg: FLConfig,
                               async_cfg: AsyncConfig, cuts=None):
    """(accumulate, finalize): the buffer commit split into C-sized chunks.

    ``accumulate(acc, wsum, deltas[C, ...], weights, staleness, losses,
    mask, ids, exponent, generator) -> (acc', wsum')`` folds one chunk's
    unnormalised weighted (masked) sum into a float32 accumulator;
    ``finalize(params, server_state, acc, wsum)`` normalises by the total
    raw mass and applies the server optimizer.  Every stage before the
    normalise is additive, so this equals the single-shot commit over the
    concatenated slots in exact arithmetic (float sums in another order:
    ~1e-5).  Each chunk draws its own randomness and mask key from the
    generator and uses its own arange ids, so secure-aggregation masks
    cancel chunk by chunk.  ``cuts`` as in
    ``build_buffer_commit_step``."""
    _refuse_trimmed_mean(cfg)
    pipe = build_update_pipeline(cfg)

    def accumulate(acc, wsum, deltas, weights, staleness, losses, mask, ids,
                   exponent, generator):
        summed, _, w_raw, _ = pipe.model_commit(
            lambda d: pipe.combine_unnormalised(
                d, weights, mask, losses, generator, ids=ids,
                staleness=staleness, exponent=exponent), deltas, cuts)
        acc = {k: a + summed[k].to(a.dtype) for k, a in acc.items()}
        return acc, wsum + w_raw.sum()

    def finalize(params, server_state, acc, wsum):
        delta = pipe.normalise(acc, wsum)
        new_params, new_state = server_opt.apply(params, delta, server_state)
        return new_params, new_state, {"delta_norm": global_norm(delta, cuts)}

    return accumulate, finalize
