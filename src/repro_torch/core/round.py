"""The federated round step — the paper's Algorithm 1 lines 5-12, mirroring
``repro/core/round.py`` in its parallel execution mode.

``build_fl_round_step`` closes over the model loss, client/server
optimizers, aggregation strategy, and compression config, and returns

    round_step(global_params, server_state, client_batches, weights, mask,
               generator) -> (new_params, new_server_state, metrics)

client_batches values are [C, H, ...] (C clients, H local steps).  ``mask``
[C] (0/1) carries the host-side deadline cutoff / fastest-k / dropouts.
``generator`` feeds the compression randomness (stochastic rounding,
federated dropout); local training draws none.

Parallel mode: ``torch.func.vmap`` over clients of a local-train function
that takes H steps of ``torch.func.grad_and_value``; then the update
pipeline (core/pipeline.py) folds the C deltas and the server optimizer
applies the result.  The sequential and pod_sequential modes, the fused
FedProx update kernel, and the other unported FLConfig values raise
NotImplementedError when the round is built
(core.pipeline.refuse_unported).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.pipeline import build_update_pipeline
from repro_torch.optim import Optimizer, ServerOptimizer


@dataclass(frozen=True)
class FLConfig:
    mode: str = "sync"                # sync (barrier rounds) | async (not
    #                                   ported yet)
    num_clients: int = 8              # clients per round (C)
    local_steps: int = 2              # H local epochs/steps per round
    client_lr: float = 0.05
    fedprox_mu: float = 0.0           # 0 -> FedAvg; >0 -> FedProx proximal term
    aggregation: str = "fedavg"       # fedavg | weighted | trimmed_mean
    client_exec: str = "parallel"     # parallel | sequential | pod_sequential
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    hierarchical: bool = False        # pod-local then compressed cross-pod agg
    accum_dtype: str = "float32"      # sequential-mode delta accumulator
    use_fused_update: bool = False    # fused fedprox_update kernel
    secure_agg: bool = False          # commit-keyed pairwise masking


def global_norm(tree: dict):
    return torch.sqrt(sum(torch.sum(tree[k].to(torch.float32).square())
                          for k in sorted(tree)))


def build_local_train(loss_fn: Callable, client_opt: Optimizer,
                      cfg: FLConfig):
    """Returns local_train(global_params, batches_H) -> (delta, mean_loss).

    FedProx (mu>0): the proximal term mu/2 ||w - w0||^2 enters as the exact
    gradient correction mu (w - w0)."""
    step_grad = grad_and_value(loss_fn, has_aux=True)

    def local_train(global_params: dict, batches: dict):
        w = dict(global_params)
        opt_state = client_opt.init(w)
        loss_sum = 0.0
        for h in range(cfg.local_steps):
            batch = {k: v[h] for k, v in batches.items()}
            grads, (loss, _) = step_grad(w, batch)
            if cfg.fedprox_mu:
                grads = {k: g + cfg.fedprox_mu * (w[k] - global_params[k]
                                                  ).to(g.dtype)
                         for k, g in grads.items()}
            w, opt_state = client_opt.update(grads, opt_state, w,
                                             cfg.client_lr)
            loss_sum = loss_sum + loss
        delta = {k: w[k] - global_params[k] for k in w}
        return delta, loss_sum / cfg.local_steps

    return local_train


class ParallelRound:
    """The parallel round step: ``train_clients`` then ``commit``.  The two
    halves are public so a caller can hold each against another device:
    local training is continuous in its inputs, while the commit's top-k and
    rounding are not, so the same deltas must enter both commits."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig):
        self.server_opt = server_opt
        self.pipe = build_update_pipeline(cfg)
        self.train_clients = vmap(build_local_train(loss_fn, client_opt, cfg),
                                  in_dims=(None, 0))

    def commit(self, global_params: dict, server_state, deltas: dict, losses,
               weights, mask, generator):
        delta, _ = self.pipe.combine(deltas, weights, mask, losses,
                                     generator)
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        metrics = {
            "client_loss": (losses * mask).sum() / torch.clamp(mask.sum(),
                                                               min=1),
            "delta_norm": global_norm(delta),
            "participation": mask.mean(),
        }
        return new_params, new_state, metrics

    def __call__(self, global_params: dict, server_state,
                 client_batches: dict, weights, mask, generator):
        deltas, losses = self.train_clients(global_params, client_batches)
        return self.commit(global_params, server_state, deltas, losses,
                           weights, mask, generator)


def build_fl_round_step(loss_fn: Callable, client_opt: Optimizer,
                        server_opt: ServerOptimizer,
                        cfg: FLConfig) -> ParallelRound:
    return ParallelRound(loss_fn, client_opt, server_opt, cfg)
