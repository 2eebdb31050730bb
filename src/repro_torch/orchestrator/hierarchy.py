"""Two-tier cross-facility federation, mirroring
``repro/orchestrator/hierarchy.py``.

A ``Facility`` is one self-contained federation site: its own client
sub-fleet, its own ``ExecutionBackend`` (one SLURM pool, one K8s pool, ...),
its own per-client data samplers, and a tier-1 aggregator running either
the synchronous barrier loop (``Orchestrator``) or the buffered-async
regime (``AsyncOrchestrator``).  One *epoch* of a facility is
``local_rounds`` tier-1 rounds or commits from the tier-2 params snapshot
it was handed; the facility returns the resulting params *delta*.

``HierarchicalOrchestrator`` federates those facility deltas through the
same buffered commit the flat async regime uses
(``core.async_round.build_buffer_commit_step``: compress, staleness
discount, secure masks, aggregate, normalise), so the tier-2 commit runs
the commit kernels with one slot per facility delta.  Its randomness
(stochastic rounding, federated dropout, the mask keys) comes from
``generator``, a ``torch.Generator`` on ``device`` seeded with ``seed``, in
place of the reference's jax key.  Inter-facility transfers cross the WAN:
every params broadcast and delta upload is charged over
``comm.WANTopology`` (the DCN link class by default, per-pair overrides,
optional exponential jitter drawn from ``rng``) and lands in the comm
ledger under the ``inter_facility`` direction with the facility index as
the cid.

Two inter-facility modes:

  sync  - a tier-2 barrier: every facility runs one epoch against the
          same snapshot, the commit applies all F deltas with staleness 0,
          and the tier-2 clock advances by the slowest facility's
          WAN-down + epoch + WAN-up leg.
  async - FedBuff at facility granularity: facilities run free, deltas
          arrive on a tier-2 event heap, the server commits every
          ``buffer_size`` arrivals discounting by commits-elapsed
          staleness, and a committed or dropped facility is re-dispatched
          at once against the live params.

Every random draw flows from seeded generators owned by this object or
its facilities, and ``checkpoint.async_state`` serialises the full two-tier
state (the tier-2 heap, buffer and RNGs and each facility's
sub-orchestrator) for a bit-identical kill/``--resume``
(``tests/test_torch_hierarchy.py``).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm.transport import CommAccountant, WANTopology
from repro_torch.core.async_round import (AsyncConfig,
                                          build_buffer_commit_step)
from repro_torch.core.compression import payload_bytes
from repro_torch.core.round import FLConfig
from repro_torch.core.secure_agg import masked_payload_bytes
from repro_torch.data.federated import FederatedDataset
from repro_torch.optim import get_server_optimizer
from repro_torch.orchestrator.async_server import (AsyncOrchestrator,
                                                   CommitLog, stack_slots)
from repro_torch.orchestrator.registry import ClientInfo
from repro_torch.orchestrator.server import Orchestrator

SERVER_NODE = "server"      # the tier-2 hub's name in the WAN topology


@dataclass
class FacilityResult:
    """What one facility epoch hands the tier-2 server."""
    delta: object               # params dict: p_after_epoch - p_snapshot
    weight: float               # facility data weight (sum of client sizes)
    loss: float                 # last tier-1 round/commit client loss
    wall_s: float               # facility sim-time the epoch consumed


@dataclass
class FacilityUpdate:
    """One facility delta travelling through the tier-2 event queue."""
    seq: int                    # tier-2 dispatch order (heap tie-break)
    fac: int                    # facility index
    dispatch_version: int       # tier-2 commit counter at dispatch
    dispatch_time: float
    wall_s: float               # facility epoch duration
    up_seconds: float           # WAN upload leg (drawn at dispatch)
    weight: float = 1.0
    loss: float = float("nan")
    delta: object = None


class Facility:
    """One federation site: a named sub-orchestrator and its local regime.

    The wrapped orchestrator keeps ITS OWN clock, RNG streams, logs, comm
    ledger and backend across epochs: an async facility's in-flight
    clients carry over from one tier-2 epoch to the next (that is where
    real cross-epoch staleness comes from)."""

    def __init__(self, name: str, orch, local_rounds: int = 1):
        if isinstance(orch, AsyncOrchestrator):
            self.mode = "async"
        elif isinstance(orch, Orchestrator):
            self.mode = "sync"
        else:
            raise TypeError(f"unsupported facility orchestrator {type(orch)}")
        if orch.checkpoint_mgr is not None:
            raise ValueError(
                "facility orchestrators must not own a checkpoint manager; "
                "hierarchy state is snapshotted by the tier-2 server")
        self.name = name
        self.orch = orch
        self.local_rounds = int(local_rounds)

    @property
    def clock(self) -> float:
        return (self.orch.clock if self.mode == "async"
                else self.orch.virtual_clock)

    def data_weight(self) -> float:
        return float(sum(max(c.data_size, 1) for c in self.orch.fleet))

    def run_epoch(self, params) -> FacilityResult:
        """Run ``local_rounds`` tier-1 rounds or commits from ``params``.

        The tier-1 server-optimizer state is fresh each epoch: the facility
        aggregates *within* the epoch, while cross-epoch momentum belongs
        to the tier-2 server optimizer."""
        t0 = self.clock
        server_state = self.orch.init_server_state(params)
        if self.mode == "sync":
            p = params
            for _ in range(self.local_rounds):
                rnd = len(self.orch.logs)
                p, server_state, _ = self.orch.run_round(rnd, p, server_state)
        else:
            p, _ = self.orch.run(params, self.orch.version + self.local_rounds,
                                 server_state=server_state)
        delta = {k: p[k] - params[k] for k in params}
        loss = (self.orch.logs[-1].client_loss if self.orch.logs
                else float("nan"))
        return FacilityResult(delta=delta, weight=self.data_weight(),
                              loss=loss, wall_s=self.clock - t0)


class HierarchicalOrchestrator:
    """Tier-2 server federating facility deltas over modelled WAN links."""

    def __init__(self, facilities: list[Facility], fl: FLConfig,
                 inter_mode: str = "sync",
                 async_cfg: AsyncConfig | None = None,
                 wan: WANTopology | None = None,
                 server_opt_name: str = "fedavg",
                 server_opt_kw: dict | None = None,
                 eval_fn: Optional[Callable] = None, eval_every: int = 1,
                 checkpoint_mgr=None, checkpoint_every: int = 0,
                 seed: int = 0, device: str = "cuda"):
        if inter_mode not in ("sync", "async"):
            raise ValueError(f"inter_mode must be sync|async, got {inter_mode!r}")
        if not facilities:
            raise ValueError("need at least one facility")
        self.facilities = facilities
        self.fl = fl
        self.inter_mode = inter_mode
        if async_cfg is None:
            async_cfg = AsyncConfig(buffer_size=1)
        if inter_mode == "sync":
            # the tier-2 barrier commits exactly one delta per facility
            async_cfg = replace(async_cfg, buffer_size=len(facilities))
        self.async_cfg = async_cfg
        self.wan = wan if wan is not None else WANTopology()
        self.eval_fn, self.eval_every = eval_fn, eval_every
        self.checkpoint_mgr = checkpoint_mgr
        self.checkpoint_every = checkpoint_every
        self.seed = seed
        self.device = device
        self.rng = np.random.default_rng(seed)      # WAN jitter stream
        # tier-2 commit randomness, checkpointed with the run
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.comm = CommAccountant()                # inter-facility ledger
        self.logs: list[CommitLog] = []
        server_opt = get_server_optimizer(server_opt_name,
                                          **(server_opt_kw or {}))
        self._server_opt = server_opt
        self._commit_step = build_buffer_commit_step(server_opt, fl,
                                                     self.async_cfg)
        self._alpha = self.async_cfg.initial_exponent()
        self.clock = 0.0
        self.version = 0            # tier-2 commit counter
        self.dropped_stale = 0
        self._seq = 0
        self._events: list = []     # heap of (arrival, seq, FacilityUpdate)
        self._buffer: list[tuple] = []   # [(FacilityUpdate, arrival_time)]
        self._buffer_bytes = 0

    # ------------------------------------------------------------------
    def init_server_state(self, params):
        return self._server_opt.init(params)

    def _payload_bytes_cache(self, params):
        """(down, up) WAN bytes one facility leg costs: the params broadcast
        down, the (masked, under secure_agg) facility delta up."""
        if not hasattr(self, "_pb"):
            down = payload_bytes(params, self.fl.compression)
            up = (masked_payload_bytes(params, self.fl.compression,
                                       n_slots=self.async_cfg.buffer_size)
                  if self.fl.secure_agg else down)
            self._pb = (down, up)
        return self._pb

    def _wan_seconds(self, a: str, b: str, nbytes: int) -> float:
        return self.wan.transfer_time(a, b, nbytes, rng=self.rng)

    # --------------------------------------------------------------- tier 2
    def _dispatch(self, fac_idx: int, params, now: float) -> FacilityUpdate:
        """Broadcast params to one facility, run its epoch eagerly, and
        price both WAN legs.  The upload leg is drawn now (so the WAN
        jitter stream stays in dispatch order) but logged at arrival."""
        fac = self.facilities[fac_idx]
        down_b, up_b = self._payload_bytes_cache(params)
        down_s = self._wan_seconds(SERVER_NODE, fac.name, down_b)
        self.comm.log(self.version, fac_idx, "inter_facility", down_b,
                      self.wan.link(SERVER_NODE, fac.name), seconds=down_s)
        res = fac.run_epoch(params)
        up_s = self._wan_seconds(fac.name, SERVER_NODE, up_b)
        upd = FacilityUpdate(seq=self._seq, fac=fac_idx,
                             dispatch_version=self.version,
                             dispatch_time=now, wall_s=res.wall_s,
                             up_seconds=up_s, weight=res.weight,
                             loss=res.loss, delta=res.delta)
        self._seq += 1
        heapq.heappush(self._events,
                       (now + down_s + res.wall_s + up_s, upd.seq, upd))
        return upd

    def _log_arrival(self, upd: FacilityUpdate, params):
        up_b = self._payload_bytes_cache(params)[1]
        fac = self.facilities[upd.fac]
        self.comm.log(self.version, upd.fac, "inter_facility", up_b,
                      self.wan.link(fac.name, SERVER_NODE),
                      seconds=upd.up_seconds)
        return up_b

    def _commit(self, params, server_state, at_time: float):
        """One tier-2 commit over the buffered facility deltas, through the
        buffered commit the flat async regime uses."""
        ups = [u for u, _ in self._buffer]
        stal = [self.version - u.dispatch_version for u in ups]
        stacked, weights, staleness, losses, mask, ids = stack_slots(
            ups, stal, self.async_cfg.buffer_size, self.device)
        params, server_state, metrics = self._commit_step(
            params, server_state, stacked, weights, staleness, losses,
            mask, ids, self._alpha, self.generator)
        self.version += 1
        losses_f = [u.loss for u in ups if np.isfinite(u.loss)]
        log = CommitLog(
            commit=self.version, sim_time=at_time, n_updates=len(ups),
            mean_staleness=float(np.mean(stal)) if stal else 0.0,
            max_staleness=int(max(stal)) if stal else 0,
            client_loss=float(np.mean(losses_f)) if losses_f else float("nan"),
            delta_norm=float(metrics["delta_norm"]),
            bytes_up=self._buffer_bytes,
            staleness_alpha=self._alpha,
            inter_facility_bytes=self._buffer_bytes)
        if self.eval_fn and (self.version % self.eval_every == 0):
            log.eval_metric = float(self.eval_fn(params))
        self.logs.append(log)
        self._buffer = []
        self._buffer_bytes = 0
        return params, server_state

    # ------------------------------------------------------------------ run
    def save_checkpoint(self, params, server_state):
        if self.checkpoint_mgr is None:
            raise ValueError("no checkpoint_mgr configured")
        self.checkpoint_mgr.save_hier(self, params, server_state)

    def _maybe_checkpoint(self, params, server_state, last_ckpt: int) -> int:
        if (self.checkpoint_mgr and self.checkpoint_every
                and self.version != last_ckpt
                and self.version % self.checkpoint_every == 0):
            self.save_checkpoint(params, server_state)
            return self.version
        return last_ckpt

    def run(self, params, num_commits: int, server_state=None,
            verbose: bool = False):
        """Run until ``num_commits`` tier-2 commits (epochs, in sync mode)."""
        if server_state is None:
            server_state = self.init_server_state(params)
        if self.inter_mode == "sync":
            params, server_state = self._run_sync(params, server_state,
                                                  num_commits, verbose)
        else:
            params, server_state = self._run_async(params, server_state,
                                                   num_commits, verbose)
        if self.checkpoint_mgr is not None:
            self.save_checkpoint(params, server_state)
        if self.eval_fn and self.logs and not np.isfinite(
                self.logs[-1].eval_metric):
            self.logs[-1].eval_metric = float(self.eval_fn(params))
        return params, server_state

    def _run_sync(self, params, server_state, num_commits, verbose):
        last_ckpt = self.version
        for _ in range(self.version, num_commits):
            now = self.clock
            legs = []
            for i in range(len(self.facilities)):
                self._dispatch(i, params, now)
            # the barrier: drain every arrival this epoch produced
            while self._events:
                t, _, upd = heapq.heappop(self._events)
                legs.append(t - now)
                up_b = self._log_arrival(upd, params)
                self._buffer.append((upd, t))
                self._buffer_bytes += up_b
            self.clock = now + max(legs)
            params, server_state = self._commit(params, server_state,
                                                self.clock)
            if verbose and self.logs:
                lg = self.logs[-1]
                print(f"t2-epoch {lg.commit:4d} t={lg.sim_time:9.1f}s "
                      f"loss={lg.client_loss:.4f} "
                      f"wan_B={lg.inter_facility_bytes} "
                      f"eval={lg.eval_metric:.4f}")
            last_ckpt = self._maybe_checkpoint(params, server_state,
                                               last_ckpt)
        return params, server_state

    def _run_async(self, params, server_state, num_commits, verbose):
        if not self._events:
            for i in range(len(self.facilities)):
                self._dispatch(i, params, self.clock)
        last_ckpt = self.version
        while self._events and self.version < num_commits:
            t, seq, upd = heapq.heappop(self._events)
            self.clock = max(self.clock, t)
            up_b = self._log_arrival(upd, params)
            staleness = self.version - upd.dispatch_version
            if staleness > self.async_cfg.max_staleness:
                self.dropped_stale += 1
            else:
                self._buffer.append((upd, t))
                self._buffer_bytes += up_b
            if len(self._buffer) >= self.async_cfg.buffer_size:
                params, server_state = self._commit(params, server_state, t)
                if verbose and self.logs:
                    lg = self.logs[-1]
                    print(f"t2-commit {lg.commit:4d} t={lg.sim_time:9.1f}s "
                          f"loss={lg.client_loss:.4f} "
                          f"stale={lg.mean_staleness:.1f} "
                          f"eval={lg.eval_metric:.4f}")
            # the facility is free again: hand it the live params
            self._dispatch(upd.fac, params, self.clock)
            last_ckpt = self._maybe_checkpoint(params, server_state,
                                               last_ckpt)
        return params, server_state

    # ------------------------------------------------------------- metrics
    @property
    def inter_facility_bytes(self) -> int:
        return sum(r.nbytes for r in self.comm.records
                   if r.direction == "inter_facility")

    def total_bytes(self) -> int:
        """WAN bytes plus every facility's intra-site ledger."""
        return self.inter_facility_bytes + sum(
            f.orch.comm.total_bytes() for f in self.facilities)


# ----------------------------------------------------------------- builders
def split_fleet(fleet: list[ClientInfo], n_facilities: int):
    """Contiguous near-equal split into per-facility sub-fleets.

    Sub-fleet clients get LOCAL cids (0..n_f-1), so each facility is
    exactly a flat federation over its own fleet: selection, checkpoint and
    data indexing inside a facility all keep the cid == index invariant the
    flat orchestrators assume.  Profiles are shared by reference (never
    mutated); histories are per-facility copies."""
    if not 1 <= n_facilities <= len(fleet):
        raise ValueError(f"cannot split {len(fleet)} clients into "
                         f"{n_facilities} facilities")
    bounds = np.linspace(0, len(fleet), n_facilities + 1).astype(int)
    subs, ranges = [], []
    for f in range(n_facilities):
        lo, hi = int(bounds[f]), int(bounds[f + 1])
        subs.append([ClientInfo(cid=i, site=c.site, profile=c.profile,
                                data_size=c.data_size)
                     for i, c in enumerate(fleet[lo:hi])])
        ranges.append((lo, hi))
    return subs, ranges


def make_facilities(n_facilities: int, fleet: list[ClientInfo],
                    fed_data: FederatedDataset, loss_fn: Callable,
                    fl: FLConfig, *, local_mode: str = "sync",
                    async_cfg: AsyncConfig | None = None,
                    local_rounds: int = 1, backend_factory=None,
                    seed: int = 0, orch_kw: dict | None = None,
                    device: str = "cuda") -> list[Facility]:
    """Build N facilities over a contiguous split of ``fleet``/``fed_data``,
    each orchestrator on ``device``.

    Facility f runs ``local_mode`` over its sub-fleet with its own
    ``FederatedDataset`` view (the same underlying data, its slice of the
    client shards) and its own backend (``backend_factory(f)``; None gives
    each facility a private closed-form backend).  Seeds are offset per
    facility EXCEPT for facility 0, which keeps the caller's seeds, so the
    degenerate 1-facility hierarchy reproduces the flat federation
    (``tests/test_torch_hierarchy.py`` pins this to 1e-6)."""
    subs, ranges = split_fleet(fleet, n_facilities)
    orch_kw = dict(orch_kw or {})
    facs = []
    for f, (sub, (lo, hi)) in enumerate(zip(subs, ranges)):
        fed_f = FederatedDataset(fed_data.data,
                                 list(fed_data.client_indices[lo:hi]),
                                 seed=fed_data.seed + 7919 * f)
        fl_f = replace(fl, mode=local_mode,
                       num_clients=min(fl.num_clients, len(sub)))
        seed_f = seed + 1000 * f
        backend = backend_factory(f) if backend_factory else None
        if local_mode == "sync":
            orch = Orchestrator(fleet=sub, fed_data=fed_f, loss_fn=loss_fn,
                                fl=fl_f, backend=backend, seed=seed_f,
                                device=device, **orch_kw)
        else:
            orch = AsyncOrchestrator(fleet=sub, fed_data=fed_f,
                                     loss_fn=loss_fn, fl=fl_f,
                                     async_cfg=async_cfg or AsyncConfig(),
                                     backend=backend, seed=seed_f,
                                     device=device, **orch_kw)
        facs.append(Facility(name=f"fac{f}", orch=orch,
                             local_rounds=local_rounds))
    return facs
