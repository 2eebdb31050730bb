"""The federated round step — the paper's Algorithm 1 lines 5-12, mirroring
``repro/core/round.py``.

``build_fl_round_step`` closes over the model loss, client/server
optimizers, aggregation strategy, and compression config, and returns

    round_step(global_params, server_state, client_batches, weights, mask,
               generator) -> (new_params, new_server_state, metrics)

client_batches values are [C, H, ...] (C clients, H local steps).  ``mask``
[C] (0/1) carries the host-side deadline cutoff / fastest-k / dropouts.
``generator`` feeds the commit's randomness (stochastic rounding, federated
dropout, the secure-aggregation commit key); local training draws none.

Client execution modes:
  * parallel — all C clients train together as one stacked [C, ...] copy
    of every leaf: each local step is one ``torch.func.vmap`` of
    ``grad_and_value`` over the stacked params, then one optimizer update
    (or one fused ``fedprox_update`` kernel launch) per leaf on the whole
    stack; the update pipeline's batched ``combine`` folds the C deltas.
  * sequential — one client at a time, each folded into a running sum by
    the pipeline's streaming ``contribution``/``accum_add``: memory for one
    model replica instead of C.
  * pod_sequential — clients pinned to ``n_pods`` pods (sites); each pod
    streams its own clients, compresses its partial sum, and the pipeline's
    ``combine_pods`` tail combines the pods.  One card has no mesh, so the
    pods run one after another.
All modes fold their client updates through the SAME stage stack
(``core.pipeline.build_update_pipeline``).

Under an active mesh (``models.sharding.use_mesh``) the parallel mode needs
``client_spmd_axes``, the mesh axes its stacked client dim is sharded
over, as the reference's does; the model's sharding constraints inside
the client body drop those axes (``exclude_axes``), the sequential body
drops ``pod``.  On one card the mesh is 1x1 and every constraint is the
identity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.pipeline import build_update_pipeline
from repro_torch.models import sharding as shd
from repro_torch.models.common import lane_exact
from repro_torch.optim import Optimizer, ServerOptimizer
from repro_torch.pytree import ordered


@dataclass(frozen=True)
class FLConfig:
    mode: str = "sync"                # sync (barrier rounds) | async (FedBuff
    #                                   buffered commits; core.async_round)
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
    secure_agg: bool = False          # commit-keyed pairwise masking: the
    #                                   server only sees masked updates whose
    #                                   masks cancel per commit (core.pipeline)


# Where clients train lane-exact (``models.common.lane_exact``: on the CPU)
# a stacked call trains at least this many lanes, padding with copies of
# lane 0 (discarded).  On the CPU a lone matrix product runs as one
# multi-threaded GEMM that splits its contraction across threads, while a
# batch of two or more runs each matrix on one thread: so a lane's result
# is the same for every lane count from two on, and differs at one.
MIN_LANES = 2


def global_norm(tree: dict):
    return torch.sqrt(sum(torch.sum(tree[k].to(torch.float32).square())
                          for k in ordered(tree)))


def build_local_train(loss_fn: Callable, client_opt: Optimizer,
                      cfg: FLConfig, stacked: bool = False):
    """Returns local_train(global_params, batches) -> (delta, mean_loss).

    ``stacked=False``: one client; batches are [H, ...].  ``stacked=True``:
    C clients at once; batches are [C, H, ...], every leaf of the clients'
    params is one [C, ...] tensor, each step's gradients are one ``vmap``
    of ``grad_and_value`` over it, and delta and loss come back [C, ...].
    Where clients train lane-exact, fewer than ``MIN_LANES`` clients are
    padded to it, so a client's result does not depend on how many share
    the call.  The optimizer
    update runs on the stacked leaves directly, so a kernel
    (which cannot run under ``vmap``) takes all C clients in one launch.

    FedProx (mu>0): the proximal term mu/2 ||w - w0||^2 enters as the exact
    gradient correction mu (w - w0).  With ``use_fused_update`` and the sgd
    client optimizer, the corrected step is the fused ``fedprox_update``
    kernel, once per leaf per step."""
    step_grad = grad_and_value(loss_fn, has_aux=True)
    if stacked:
        step_grad = vmap(step_grad, in_dims=(0, 0))
    fused = cfg.use_fused_update and client_opt.name == "sgd"

    def local_train(global_params: dict, batches: dict):
        if stacked:
            x0 = next(iter(batches.values()))
            C = x0.shape[0]
            if C < MIN_LANES and lane_exact(x0):
                pick = [0] * (MIN_LANES - C)
                delta, loss = local_train(global_params, {
                    k: torch.cat([v, v[pick]]) for k, v in batches.items()})
                return {k: d[:C] for k, d in delta.items()}, loss[:C]
            w = {k: p.expand((C,) + tuple(p.shape)).contiguous()
                 for k, p in global_params.items()}
            step_batch = lambda h: {k: v[:, h] for k, v in batches.items()}
        else:
            w = dict(global_params)
            step_batch = lambda h: {k: v[h] for k, v in batches.items()}
        opt_state = client_opt.init(w)
        loss_sum = 0.0
        for h in range(cfg.local_steps):
            grads, (loss, _) = step_grad(w, step_batch(h))
            if fused:
                from repro_torch.kernels import ops as kops
                w = {k: kops.fedprox_update(w[k], grads[k], global_params[k],
                                            lr=cfg.client_lr,
                                            mu=cfg.fedprox_mu)
                     for k in w}
            else:
                if cfg.fedprox_mu:
                    grads = {k: g + cfg.fedprox_mu * (
                        w[k] - global_params[k]).to(g.dtype)
                        for k, g in grads.items()}
                w, opt_state = client_opt.update(grads, opt_state, w,
                                                 cfg.client_lr)
            loss_sum = loss_sum + loss
        delta = {k: w[k] - global_params[k] for k in w}
        return delta, loss_sum / cfg.local_steps

    return local_train


def _metrics(delta: dict, loss_sum, mask) -> dict:
    return {
        "client_loss": loss_sum / torch.clamp(mask.sum(), min=1),
        "delta_norm": global_norm(delta),
        "participation": mask.mean(),
    }


class ParallelRound:
    """The parallel round step: ``train_clients`` then ``commit``.  The two
    halves are public so a caller can hold each against another device:
    local training is continuous in its inputs, while the commit's top-k and
    rounding are not, so the same deltas must enter both commits."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig, n_pods: int = 1,
                 client_spmd_axes=()):
        self.server_opt = server_opt
        self.pipe = build_update_pipeline(cfg, n_pods=n_pods)
        stacked = build_local_train(loss_fn, client_opt, cfg, stacked=True)

        def train_clients(global_params, client_batches):
            # the stacked client dim owns client_spmd_axes: constraints in
            # the vmapped body may not name them
            with shd.exclude_axes(*client_spmd_axes):
                return stacked(global_params, client_batches)

        self.train_clients = train_clients

    def commit(self, global_params: dict, server_state, deltas: dict, losses,
               weights, mask, generator):
        delta, _, _ = self.pipe.combine(deltas, weights, mask, losses,
                                        generator)
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        return new_params, new_state, _metrics(delta, (losses * mask).sum(),
                                               mask)

    def __call__(self, global_params: dict, server_state,
                 client_batches: dict, weights, mask, generator):
        deltas, losses = self.train_clients(global_params, client_batches)
        return self.commit(global_params, server_state, deltas, losses,
                           weights, mask, generator)


class SequentialRound:
    """The sequential round step: one client at a time, streamed into the
    pipeline's running sum (secure masks per slot under ``secure_agg``).
    ``commit`` folds an iterable of per-client ``(delta, loss)`` in client
    order; the round hands it a generator that trains each client as it
    is folded, so one client's delta is alive at a time.  A caller can
    hand it deltas trained elsewhere (another device) instead."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig, n_pods: int = 1,
                 client_spmd_axes=()):
        self.cfg = cfg
        self.server_opt = server_opt
        self.pipe = build_update_pipeline(cfg, n_pods=n_pods)
        local_train = build_local_train(loss_fn, client_opt, cfg)

        def train_one(global_params, batches):
            # the reference keeps activation constraints off the pod axis
            # in the sequential body (its backward miscompiles there)
            with shd.exclude_axes(shd.POD):
                return local_train(global_params, batches)

        self.local_train = train_one

    def commit(self, global_params: dict, server_state, updates, weights,
               mask, generator):
        pipe, C = self.pipe, self.cfg.num_clients
        acc = pipe.accum_init(global_params)
        key = pipe.mask_key(generator) if self.cfg.secure_agg else None
        ids = torch.arange(C, dtype=torch.int32)
        wsum = torch.zeros((), dtype=torch.float32, device=mask.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=mask.device)
        for c, (delta, loss) in enumerate(updates):
            wt = pipe.client_weight(weights[c], mask[c], loss)
            acc = pipe.accum_add(acc, pipe.contribution(
                delta, wt, generator, idx=c, ids=ids, participation=mask,
                key=key))
            wsum = wsum + wt
            loss_sum = loss_sum + loss * mask[c]
        delta = pipe.normalise(acc, wsum)
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        return new_params, new_state, _metrics(delta, loss_sum, mask)

    def __call__(self, global_params: dict, server_state,
                 client_batches: dict, weights, mask, generator):
        updates = (self.local_train(global_params,
                                    {k: v[c] for k, v in
                                     client_batches.items()})
                   for c in range(self.cfg.num_clients))
        return self.commit(global_params, server_state, updates, weights,
                           mask, generator)


class PodSequentialRound:
    """The pod_sequential round step: clients pinned to ``n_pods`` pods, the
    client dim split [P, C/P]; each pod streams its clients into a plain
    weighted sum and compresses it (what would cross the slow cross-pod
    link), then ``combine_pods`` masks (under ``secure_agg``), sums and
    normalises across pods."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig, n_pods: int = 1,
                 client_spmd_axes=()):
        self.cfg = cfg
        self.n_pods = n_pods
        self.server_opt = server_opt
        self.pipe = build_update_pipeline(cfg, n_pods=n_pods)
        self.local_train = build_local_train(loss_fn, client_opt, cfg)
        self.client_spmd_axes = client_spmd_axes

    def __call__(self, global_params: dict, server_state,
                 client_batches: dict, weights, mask, generator):
        pipe = self.pipe
        with shd.exclude_axes(*self.client_spmd_axes):
            accs, wsum, loss_sum = self._pods(global_params, client_batches,
                                              weights, mask, generator)
        pod_sums = {k: torch.stack([a[k] for a in accs]) for k in accs[0]}
        delta = pipe.combine_pods(pod_sums, wsum, generator, compressed=True)
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        return new_params, new_state, _metrics(delta, loss_sum, mask)

    def _pods(self, global_params, client_batches, weights, mask, generator):
        """Each pod streams its clients into a plain weighted sum and
        compresses it: (the pods' sums, the weight sum, the loss sum)."""
        pipe, P = self.pipe, self.n_pods
        Cp = self.cfg.num_clients // P
        dt = pipe.accum_dtype
        accs, wsum, loss_sum = [], 0.0, 0.0
        for p in range(P):
            acc = pipe.accum_init(global_params)
            wsum_p = torch.zeros((), dtype=torch.float32, device=mask.device)
            loss_p = torch.zeros((), dtype=torch.float32, device=mask.device)
            for c in range(p * Cp, (p + 1) * Cp):
                delta, loss = self.local_train(
                    global_params,
                    {k: v[c] for k, v in client_batches.items()})
                wt = pipe.client_weight(weights[c], mask[c], loss)
                acc = pipe.accum_add(acc, {k: wt.to(dt) * d.to(dt)
                                           for k, d in delta.items()})
                wsum_p = wsum_p + wt
                loss_p = loss_p + loss * mask[c]
            accs.append(pipe.compress(acc, generator))
            wsum, loss_sum = wsum + wsum_p, loss_sum + loss_p
        return accs, wsum, loss_sum


ROUNDS = {"parallel": ParallelRound, "sequential": SequentialRound,
          "pod_sequential": PodSequentialRound}


def build_fl_round_step(loss_fn: Callable, client_opt: Optimizer,
                        server_opt: ServerOptimizer, cfg: FLConfig,
                        n_pods: int = 1, client_spmd_axes=None):
    """The round step of ``cfg.client_exec``.  ``n_pods`` splits the
    clients into pods for pod_sequential and the hierarchical combine.
    ``client_spmd_axes``: the mesh axis name(s) the stacked client (or pod)
    dim is sharded over; parallel mode under an active mesh requires it,
    as the reference's does."""
    if (cfg.client_exec == "parallel" and client_spmd_axes is None
            and shd.get_mesh() is not None):
        raise ValueError(
            "client_exec='parallel' under an active mesh requires "
            "client_spmd_axes (the mesh axes the vmapped client dim is "
            "sharded over, e.g. ('pod', 'data')); vmap without "
            "spmd_axis_name over sharded params is numerically unsupported")
    axes = (client_spmd_axes,) if isinstance(client_spmd_axes, str) \
        else tuple(client_spmd_axes or ())
    return ROUNDS[cfg.client_exec](loss_fn, client_opt, server_opt, cfg,
                                   n_pods=n_pods, client_spmd_axes=axes)
