"""The update pipeline, plain (unmasked) half, mirroring
``repro/core/pipeline.py``.

Stages over update dicts plus per-slot scalars; a "slot" is one client
update in a batch of K (a sync cohort):

    compress -> weight -> aggregate -> normalise

Fused commit path (``compression.use_fused``, default on): every stage
between compress and normalise is elementwise or a slot reduction, so the
batched combinator runs them as one CUDA kernel over a bucket of all leaves
(``kernels/ops.fused_*_tree``):
  * deterministic quantize and/or top-k -> ``plain_commit`` (top-k +
    per-slot-block quantize + discounted sum);
  * no compression -> ``fused_accum``;
  * stochastic rounding or federated dropout need per-slot randomness, so
    compression runs per slot first (top-k and the deterministic quantize
    through their CUDA kernels) and only the accumulate fuses.
``--no-use-fused`` runs the plain stages.

Not ported yet (ROADMAP queue 1), and refused when configured: secure
aggregation, trimmed-mean aggregation, and the hierarchical pod combine.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core.compression import compress_tree
from repro_torch.kernels import ops as kops

if TYPE_CHECKING:                       # avoid circular import with round.py
    from repro_torch.core.round import FLConfig


def refuse_unported(cfg: "FLConfig") -> None:
    """Raise NotImplementedError for FLConfig values whose branches are not
    ported, naming the ROADMAP item that will port them."""
    unported = [
        (cfg.mode != "sync", f"mode={cfg.mode!r}",
         "queue 1, still to port, item 5 (async regime)"),
        (cfg.client_exec != "parallel", f"client_exec={cfg.client_exec!r}",
         "queue 1, still to port, item 1 (sequential modes)"),
        (cfg.hierarchical, "hierarchical=True",
         "queue 1, still to port, item 1 (pod combine)"),
        (cfg.aggregation == "trimmed_mean", "aggregation='trimmed_mean'",
         "queue 1, still to port, item 1 (trimmed mean)"),
        (cfg.secure_agg, "secure_agg=True",
         "queue 1, still to port, item 2 (secure aggregation)"),
        (cfg.use_fused_update, "use_fused_update=True",
         "queue 1, still to port, item 3 (fused FedProx update)"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"FLConfig({what}) is not ported to repro_torch yet: "
                f"ROADMAP {item}")


class UpdatePipeline:
    """The configured stage stack.  Stateless; one instance serves every
    round of a run."""

    def __init__(self, cfg: "FLConfig", allow_fused: bool = True):
        refuse_unported(cfg)
        comp = cfg.compression
        self.fused = bool(comp.use_fused) and allow_fused
        # fully-fusable compression: deterministic rounding, no per-slot
        # dropout randomness
        self._fusable_comp = (not comp.dropout_frac
                              and not (comp.quantize_bits
                                       and comp.stochastic_rounding))
        if self.fused and comp.enabled and not comp.use_kernels:
            # per-slot compress stages route through the CUDA compress
            # kernels under fusion
            cfg = dataclasses.replace(
                cfg, compression=dataclasses.replace(comp, use_kernels=True))
        self.cfg = cfg

    # ------------------------------------------------------------- stage 1
    def compress(self, tree: dict, generator) -> dict:
        return compress_tree(tree, self.cfg.compression, generator)

    def compress_each(self, stacked: dict, generator) -> dict:
        """The compress stage over every slot of a [K, ...] stack at once:
        blocks are per row, and dropout draws one mask per slot."""
        return compress_tree(stacked, self.cfg.compression, generator,
                             batch_dims=1)

    # ------------------------------------------------------------- stage 2
    def client_weights(self, weights, mask, losses=None):
        """Per-slot weights: data sizes x participation (x inverse loss
        under aggregation='weighted')."""
        return agg.effective_weights(weights, mask, losses,
                                     self.cfg.aggregation)

    # --------------------------------------------------------- stages 4/5
    def weighted_sum(self, stacked: dict, w) -> dict:
        """sum_i w_i * d_i over the slot dim, in float32."""
        def one(d):
            wb = w.reshape((-1,) + (1,) * (d.ndim - 1)).to(torch.float32)
            return (d.to(torch.float32) * wb).sum(0)
        return {k: one(d) for k, d in stacked.items()}

    def normalise(self, summed: dict, w_sum) -> dict:
        denom = torch.clamp(w_sum, min=1e-12)
        return {k: s / denom.to(s.dtype) for k, s in summed.items()}

    # --------------------------------------------------------- combinators
    def combine_unnormalised(self, deltas: dict, weights, mask, losses,
                             generator):
        """compress -> weight -> weighted sum, WITHOUT the closing
        normalise.  Returns (summed, w).  A sync commit has no staleness:
        the fused kernels get zero staleness and exponent 0, a discount of
        exactly 1."""
        w = self.client_weights(weights, mask, losses)
        comp = self.cfg.compression
        names = sorted(deltas)
        if self.fused:
            s = torch.zeros_like(w)
            if comp.enabled and self._fusable_comp:
                # one pass: top-k + quantize + weight + sum, all leaves
                # bucketed into a single kernel launch
                out = kops.fused_plain_commit_tree(
                    [deltas[n] for n in names], w, s, 0.0,
                    bits=comp.quantize_bits, k=comp.topk_k, block=comp.block)
            else:
                # per-slot stages that need slot randomness stay unfused;
                # the accumulate still fuses (one bucketed launch)
                stacked = (self.compress_each(deltas, generator)
                           if comp.enabled else deltas)
                out = kops.fused_accum_tree([stacked[n] for n in names], w, s,
                                            0.0, block=comp.block)
            summed = dict(zip(names, out))
        else:
            stacked = (self.compress_each(deltas, generator)
                       if comp.enabled else deltas)
            summed = self.weighted_sum(stacked, w)
        return summed, w

    def combine(self, deltas: dict, weights, mask, losses, generator):
        """The full batched stack over [K, ...] slot deltas.
        Returns (delta, w)."""
        summed, w = self.combine_unnormalised(deltas, weights, mask, losses,
                                              generator)
        return self.normalise(summed, w.sum()), w


def build_update_pipeline(cfg: "FLConfig",
                          allow_fused: bool = True) -> UpdatePipeline:
    """Build the stage stack once from FLConfig.  ``allow_fused=False``
    forces the unfused stages."""
    return UpdatePipeline(cfg, allow_fused=allow_fused)
