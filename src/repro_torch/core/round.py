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
``client_spmd_axes``, the mesh axes its stacked client dim is sharded over,
as the reference's does; the model's sharding constraints inside the
client body drop those axes (``exclude_axes``), the sequential body drops
``pod``.  On a mesh of processes (``launch.mesh.init_mesh``) the round
step runs SPMD, the reference's shardings executed: every process calls
it with the same whole batches, weights and mask, the same generator
state, and the params (and server state) as it holds them at rest: its
share over ``data`` and ``model`` (``launch.specs.shard_params``), whole
along ``pod``.  It returns the new params as it holds them.
  * parallel: the clients split over ``client_spmd_axes`` (C/n a process,
    contiguous, in ``flat_shard_index`` order), their batches over the
    batch axes left; the commit exchanges the client split for a row split
    (``core.pipeline``'s ``slot_axes``).  A client dim that owns ``data``
    trains on the params gathered whole over it, once a round, and the
    server step runs on the commit's result cut back to the shares.
  * sequential: every process streams every client, each client's batch
    split over ``data`` (``pod`` dropped: processes in different pods
    repeat the same work, as in the reference, and the gradients' mean
    runs over ``pod`` too, so that they take the same bits whatever their
    algorithms do).
  * pod_sequential: the pods split over ``client_spmd_axes``, each client's
    batch over the batch axes left; ``combine_pods`` takes the pods' sums
    split.
  * ``model``: inside every mode the client's forward and backward split
    its layers over ``model`` (tensor, expert and head parallelism,
    ``models.sharding``'s conjugate collectives, which run inside the
    transforms); the commit runs on the shares (``pipeline.model_commit``).
  * ``data`` (FSDP): where the client's batch splits over ``data``, each
    layer gathers its weights' ``data`` shares just before it runs and
    lets them go after it (``transformer.LM``); the gather's backward
    sums the gradient over ``data`` and cuts it to the rank's share.
Gradients are taken on the local batch; their mean over the processes that
split it (``sharding.batch_split_axes``) and those that repeat it
(``replica_axes``) sits between ``grad_and_value`` and the optimizer step,
outside every ``torch.func`` transform.  A leaf held whole over ``model``
is averaged over ``model`` too (its ranks hold equal values, and the mean
hands them the same bits whatever their algorithms do); a split leaf's
gradient is the rank's own; a leaf cut over ``data`` takes the gather's
sum over ``data`` divided by its count.  The loss is averaged over all of
these axes (an MoE's aux loss enters that mean per shard, where the
reference's ``shard_map`` returns it unchecked, ``out_specs=P()``).  A batch or a client count that its split does not
divide raises.  Params and server state end each round bit for bit the
same on every process that holds the same share
(``sharding.replica_checksums`` shows it): every process that holds a
client takes the same all-reduced gradient bits, and the commit's result
is gathered whole along every axis but ``data`` and ``model``.

Which leaves are cut over ``data`` and ``model`` (``ModelLayout``): the
sanitised specs of the model whose bound ``loss_fn`` the round gets
(``LM.leaf_cuts``), or the ``cuts`` given; a model without specs (the
CNN) is whole.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.compression import CompressionConfig
from repro_torch.core.pipeline import (build_update_pipeline, cuts_over,
                                      cuts_share, cuts_whole)
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


def global_norm(tree: dict, cuts: Optional[dict] = None):
    """The L2 norm of ``tree``'s leaves; where ``cuts`` (``ModelLayout``'s
    ``{leaf: {axis: dim}}``) marks leaves as this rank's shares, of the
    whole tree (each leaf's squares summed over the active axes that cut
    it)."""
    sq = lambda k: torch.sum(tree[k].to(torch.float32).square())
    by_axes = {}
    for k in ordered(tree):
        axes = tuple(a for a in (cuts or {}).get(k, {}) if shd.axis_live(a))
        by_axes.setdefault(tuple(sorted(axes)), []).append(k)
    total = sum(sq(k) for k in by_axes.pop((), []))
    for axes, keys in by_axes.items():
        total = total + shd.psum(sum(sq(k) for k in keys), axes)
    return torch.sqrt(total)


class ModelLayout:
    """Which param leaves are cut at rest, over which of ``data`` and
    ``model`` and along which dims: ``layout()`` -> ``{leaf: {axis:
    dim}}`` (flat names, the cut leaves only) on the active mesh, the
    layout at rest whatever body asks.  From ``cuts`` where given, else
    from the model that ``loss_fn`` is bound to (``LM.leaf_cuts``); a
    model without it has every leaf whole."""

    def __init__(self, loss_fn: Callable, cuts: Optional[dict] = None):
        self.owner = getattr(loss_fn, "__self__", None)
        self.cuts = cuts

    def __call__(self) -> dict:
        if self.cuts is not None:
            return self.cuts
        if not hasattr(self.owner, "leaf_cuts"):
            return {}
        return self.owner.leaf_cuts()


def build_local_train(loss_fn: Callable, client_opt: Optimizer,
                      cfg: FLConfig, stacked: bool = False,
                      replica_axes=(), layout: Optional[ModelLayout] = None):
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

    Under a mesh of processes the gradients and the loss are averaged over
    the batch split and over ``replica_axes``, the axes whose processes
    repeat this client's work: the mean of equal values, which hands every
    one of them the same bits.  The params are the rank's shares at rest
    (``layout``: ``ModelLayout`` of ``loss_fn`` by default).  A leaf held
    whole over ``model``, and the loss, are averaged over ``model`` too.
    A leaf cut over an active ``data`` axis takes its gradient from the
    gather's backward already summed over ``data`` (the batch split's
    ranks) and cut to the rank's share: it is divided by the ``data``
    count and averaged over the other axes only.

    FedProx (mu>0): the proximal term mu/2 ||w - w0||^2 enters as the exact
    gradient correction mu (w - w0).  With ``use_fused_update`` and the sgd
    client optimizer, the corrected step is the fused ``fedprox_update``
    kernel, once per leaf per step."""
    step_grad = grad_and_value(loss_fn, has_aux=True)
    if stacked:
        step_grad = vmap(step_grad, in_dims=(0, 0))
    fused = cfg.use_fused_update and client_opt.name == "sgd"
    layout = layout or ModelLayout(loss_fn)

    def local_train(global_params: dict, batches: dict):
        # the processes that split this client's batch or repeat its work
        # (none off a mesh); with them those of `model` for a leaf every
        # rank of it holds whole, and without `data` for a leaf cut over
        # it, whose gather's backward summed its gradient there
        mesh = shd.get_mesh()
        split = () if mesh is None else mesh.live(
            shd.batch_split_axes() + tuple(replica_axes))
        cuts = layout()
        n_data = shd.shard_count(shd.DATA) if shd.data_live() else 1
        loss_axes = mesh.live(split + (shd.MODEL,)) if shd.model_live() \
            else split

        def reduce(k, g):
            c = cuts.get(k, {})
            axes = split if shd.MODEL in c else loss_axes
            if n_data > 1 and shd.DATA in c:
                return shd.pmean(g / n_data, tuple(a for a in axes
                                                   if a != shd.DATA))
            return shd.pmean(g, axes)

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
            if loss_axes:
                # the gradient of the whole batch's mean loss: the mean of
                # the shares' gradients (and of the replicas' equal ones),
                # reduced between the transforms
                grads = {k: reduce(k, g) for k, g in grads.items()}
                loss = shd.pmean(loss, loss_axes)
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


def _metrics(delta: dict, loss_sum, mask, cuts=None) -> dict:
    return {
        "client_loss": loss_sum / torch.clamp(mask.sum(), min=1),
        "delta_norm": global_norm(delta, cuts),
        "participation": mask.mean(),
    }


def _held(cuts: dict, owned) -> dict:
    """The cut of the deltas a client dim that owns ``owned`` trains:
    ``cuts`` without those axes (the leaves are whole over them)."""
    return cuts_over(cuts, [a for a in (shd.DATA, shd.MODEL)
                            if a not in owned])


def _spmd_axes(client_spmd_axes) -> tuple:
    """The client axes of the active mesh (size > 1, mesh order)."""
    mesh = shd.get_mesh()
    return () if mesh is None else mesh.live(client_spmd_axes)


def _batch_share(batches: dict, dim: int) -> dict:
    """Each leaf's share of its batch dim ``dim`` over the batch axes left
    here (``sharding.batch_split_axes``)."""
    axes = shd.batch_split_axes()
    return {k: shd.local_share(v, axes, dim, f"the batch of {k!r}")
            for k, v in batches.items()}


class ParallelRound:
    """The parallel round step: ``train_clients`` then ``commit``.  The two
    halves are public so a caller can hold each against another device:
    local training is continuous in its inputs, while the commit's top-k and
    rounding are not, so the same deltas must enter both commits.  Under a
    mesh of processes both halves take this process's clients
    (``client_share``): ``train_clients`` their whole batches,
    ``commit`` their deltas, weights, mask and losses; the commit's result
    is whole (the rank's share of a leaf split over ``model``).  Where the
    client dim owns ``data`` (the reference's ``exclude_axes``), the
    clients train on the global params gathered whole over ``data``, once
    a round, their deltas come back whole over it, and the commit's
    result is cut back to the rank's ``data`` shares for the server step,
    which runs on the shares as the params and the server state rest."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig, n_pods: int = 1,
                 client_spmd_axes=(), cuts=None):
        self.server_opt = server_opt
        self.client_spmd_axes = client_spmd_axes
        self.pipe = build_update_pipeline(cfg, n_pods=n_pods)
        self.layout = ModelLayout(loss_fn, cuts)
        stacked = build_local_train(loss_fn, client_opt, cfg, stacked=True,
                                    layout=self.layout)

        def train_clients(global_params, client_batches):
            # the stacked client dim owns client_spmd_axes: constraints in
            # the vmapped body may not name them, and a leaf cut over one
            # of them is taken whole; each client's batch [C, H, B, ...] is
            # split over the batch axes left
            if shd.DATA in self.owned():
                global_params = cuts_whole(global_params, cuts_over(
                    self.layout(), (shd.DATA,)))
            with shd.exclude_axes(*client_spmd_axes):
                return stacked(global_params,
                               _batch_share(client_batches, 2))

        self.train_clients = train_clients

    def client_share(self, x, what: str = "the client dim"):
        """This process's clients of a [C, ...] tensor (all of them off a
        mesh)."""
        return shd.local_share(x, _spmd_axes(self.client_spmd_axes), 0, what)

    def owned(self) -> tuple:
        """The active mesh's axes (size > 1) that the client dim owns."""
        return _spmd_axes(self.client_spmd_axes)

    def commit(self, global_params: dict, server_state, deltas: dict, losses,
               weights, mask, generator):
        axes = self.owned()
        cuts = self.layout()
        held = _held(cuts, axes)             # the deltas' cut
        delta, _, _, (mask, losses) = self.pipe.model_commit(
            lambda d: self.pipe.combine(d, weights, mask, losses, generator,
                                        slot_axes=axes), deltas, held)
        metrics = _metrics(delta, (losses * mask).sum(), mask, held)
        if shd.DATA in axes:
            delta = cuts_share(delta, cuts_over(cuts, (shd.DATA,)))
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        return new_params, new_state, metrics

    def __call__(self, global_params: dict, server_state,
                 client_batches: dict, weights, mask, generator):
        share = self.client_share
        deltas, losses = self.train_clients(
            global_params, {k: share(v, f"the clients of {k!r}")
                            for k, v in client_batches.items()})
        return self.commit(global_params, server_state, deltas, losses,
                           share(weights), share(mask), generator)


class SequentialRound:
    """The sequential round step: one client at a time, streamed into the
    pipeline's running sum (secure masks per slot under ``secure_agg``).
    ``commit`` folds an iterable of per-client ``(delta, loss)`` in client
    order; the round hands it a generator that trains each client as it
    is folded, so one client's delta is alive at a time.  A caller can
    hand it deltas trained elsewhere (another device) instead.  Under a
    mesh of processes each process trains every client on its share of
    the client's batch (``local_train`` takes the whole [H, B, ...])."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig, n_pods: int = 1,
                 client_spmd_axes=(), cuts=None):
        self.cfg = cfg
        self.server_opt = server_opt
        self.pipe = build_update_pipeline(cfg, n_pods=n_pods)
        self.layout = ModelLayout(loss_fn, cuts)
        # the pods repeat every client's work
        local_train = build_local_train(loss_fn, client_opt, cfg,
                                        replica_axes=(shd.POD,),
                                        layout=self.layout)

        def train_one(global_params, batches):
            # the reference keeps activation constraints off the pod axis
            # in the sequential body (its backward miscompiles there): the
            # batch splits over data alone
            with shd.exclude_axes(shd.POD):
                return local_train(global_params, _batch_share(batches, 1))

        self.local_train = train_one

    def commit(self, global_params: dict, server_state, updates, weights,
               mask, generator):
        pipe, C = self.pipe, self.cfg.num_clients
        cuts = self.layout()
        acc = pipe.accum_init(global_params)
        key = pipe.mask_key(generator) if self.cfg.secure_agg else None
        ids = torch.arange(C, dtype=torch.int32)
        wsum = torch.zeros((), dtype=torch.float32, device=mask.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=mask.device)
        for c, (delta, loss) in enumerate(updates):
            wt = pipe.client_weight(weights[c], mask[c], loss)
            acc = pipe.accum_add(acc, pipe.model_commit(
                lambda d: pipe.contribution(
                    d, wt, generator, idx=c, ids=ids, participation=mask,
                    key=key), delta, cuts, lead=0))
            wsum = wsum + wt
            loss_sum = loss_sum + loss * mask[c]
        delta = pipe.normalise(acc, wsum)
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        return new_params, new_state, _metrics(delta, loss_sum, mask, cuts)

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
    weighted sum, then the pods' sums are compressed (what would cross the
    slow cross-pod link) and ``combine_pods`` masks (under
    ``secure_agg``), sums and normalises across pods.  Under a mesh of
    processes the pods split over ``client_spmd_axes``; each process
    streams its pods' clients, each client's batch split over the batch
    axes left.  Pods that own ``data`` train on the params gathered whole
    over it, as ``ParallelRound``'s clients do."""

    def __init__(self, loss_fn: Callable, client_opt: Optimizer,
                 server_opt: ServerOptimizer, cfg: FLConfig, n_pods: int = 1,
                 client_spmd_axes=(), cuts=None):
        self.cfg = cfg
        self.n_pods = n_pods
        self.server_opt = server_opt
        self.pipe = build_update_pipeline(cfg, n_pods=n_pods)
        self.layout = ModelLayout(loss_fn, cuts)
        self.local_train = build_local_train(loss_fn, client_opt, cfg,
                                             layout=self.layout)
        self.client_spmd_axes = client_spmd_axes

    def __call__(self, global_params: dict, server_state,
                 client_batches: dict, weights, mask, generator):
        pipe, P = self.pipe, self.n_pods
        axes = _spmd_axes(self.client_spmd_axes)
        n = shd.shard_count(axes)
        if P % n:
            raise ValueError(f"{P} pods do not split over the mesh axes "
                             f"{axes} ({n} shards)")
        pods = range(shd.shard_index(axes) * (P // n),
                     (shd.shard_index(axes) + 1) * (P // n))
        # pods over `data` train on the params gathered whole over it
        cuts = self.layout()
        held = _held(cuts, axes)
        train_params = (cuts_whole(global_params, cuts_over(
            cuts, (shd.DATA,))) if shd.DATA in axes else global_params)
        with shd.exclude_axes(*self.client_spmd_axes):
            accs, wsums, loss_sums = self._pods(
                train_params, client_batches, weights, mask, pods)
            del train_params
            # the sums move into the stack leaf by leaf, so the uncompressed
            # sums are held once, then beside their compressed copy
            stacked = {k: torch.stack([a.pop(k) for a in accs])
                       for k in list(accs[0])}
            del accs
        # the round's sums in pod order, as one process would add them
        wsums, loss_sums = pipe.gather_slots(torch.stack(wsums),
                                             torch.stack(loss_sums),
                                             slot_axes=axes)
        wsum, loss_sum = 0.0, 0.0
        for p in range(P):
            wsum, loss_sum = wsum + wsums[p], loss_sum + loss_sums[p]

        def cross_pod(stacked):
            # what crosses the cross-pod link: each pod's compressed sum
            with shd.exclude_axes(*self.client_spmd_axes):
                pod_sums = pipe.compress_each(stacked, generator, axes)
            return pipe.combine_pods(pod_sums, wsum, generator,
                                     compressed=True, slot_axes=axes)

        delta = pipe.model_commit(cross_pod, stacked, held)
        del stacked
        metrics = _metrics(delta, loss_sum, mask, held)
        if shd.DATA in axes:
            delta = cuts_share(delta, cuts_over(cuts, (shd.DATA,)))
        new_params, new_state = self.server_opt.apply(global_params, delta,
                                                      server_state)
        return new_params, new_state, metrics

    def _pods(self, global_params, client_batches, weights, mask, pods):
        """Each of ``pods`` streams its clients into a plain weighted sum:
        (the pods' sums, their weight sums, their loss sums)."""
        pipe = self.pipe
        Cp = self.cfg.num_clients // self.n_pods
        dt = pipe.accum_dtype
        accs, wsums, loss_sums = [], [], []
        for p in pods:
            acc = pipe.accum_init(global_params)
            wsum_p = torch.zeros((), dtype=torch.float32, device=mask.device)
            loss_p = torch.zeros((), dtype=torch.float32, device=mask.device)
            for c in range(p * Cp, (p + 1) * Cp):
                delta, loss = self.local_train(global_params, _batch_share(
                    {k: v[c] for k, v in client_batches.items()}, 1))
                wt = pipe.client_weight(weights[c], mask[c], loss)
                acc = pipe.accum_add(acc, {k: wt.to(dt) * d.to(dt)
                                           for k, d in delta.items()})
                wsum_p = wsum_p + wt
                loss_p = loss_p + loss * mask[c]
            accs.append(acc)
            wsums.append(wsum_p)
            loss_sums.append(loss_p)
        return accs, wsums, loss_sums


ROUNDS = {"parallel": ParallelRound, "sequential": SequentialRound,
          "pod_sequential": PodSequentialRound}


def build_fl_round_step(loss_fn: Callable, client_opt: Optimizer,
                        server_opt: ServerOptimizer, cfg: FLConfig,
                        n_pods: int = 1, client_spmd_axes=None,
                        cuts: Optional[dict] = None):
    """The round step of ``cfg.client_exec``.  ``n_pods`` splits the
    clients into pods for pod_sequential and the hierarchical combine.
    ``client_spmd_axes``: the mesh axis name(s) the stacked client (or pod)
    dim is sharded over; parallel mode under an active mesh requires it,
    as the reference's does.  ``cuts``: ``{leaf: {axis: dim}}`` of the
    params cut at rest (``launch.specs.leaf_cuts``' form), where
    ``loss_fn`` is not an ``LM``'s, which gives its own
    (``LM.leaf_cuts``)."""
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
                                   n_pods=n_pods, client_spmd_axes=axes,
                                   cuts=cuts)
