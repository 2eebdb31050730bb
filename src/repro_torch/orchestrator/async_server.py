"""Event-driven asynchronous orchestrator (the FedBuff execution regime),
mirroring ``repro/orchestrator/async_server.py``.

Replaces the per-round barrier of ``Orchestrator`` with a simulated event
queue: up to ``max_concurrency`` clients train concurrently, each against
the params snapshot current at its dispatch; finish times come from the
pluggable ``ExecutionBackend`` (``repro_torch.exec``), so fast HPC nodes lap
slow cloud VMs instead of waiting.  Updates land in a bounded buffer; the
server commits every K arrivals or after ``commit_timeout_s`` sim-seconds
of buffered quiet, discounting each update by its staleness (commits
elapsed since dispatch).

Host-side bookkeeping, deterministic under a fixed seed: the heap is
ordered by (arrival_time, dispatch_seq) and every random draw flows from
the seeded numpy generators, the same streams as the reference, so the
event trace replays it exactly.  The heavy math is the pair of steps from
``repro_torch.core.async_round`` on ``device``.  Local training draws no
randomness; the commits' randomness (stochastic rounding, federated
dropout, the secure-aggregation mask keys) comes from ``generator``, a
``torch.Generator`` on ``device`` seeded with ``seed``, as the sync
``Orchestrator`` makes its own.  Every device-to-host read goes through
``_host_fetch``, which counts it; each ``CommitLog`` carries the host
wall-clock per engine phase since the previous commit (``phase_wall``).
"""
from __future__ import annotations

import heapq
from contextlib import contextmanager
from dataclasses import dataclass, field
from time import perf_counter
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm.transport import CommAccountant, link_for_site
from repro_torch.core.async_round import (AdaptiveStalenessController,
                                          AsyncConfig,
                                          build_buffer_commit_step,
                                          build_chunked_commit_steps,
                                          build_client_update_step)
from repro_torch.core.compression import payload_bytes
from repro_torch.core.round import FLConfig
from repro_torch.core.secure_agg import masked_payload_bytes
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.orchestrator.fault import (RECOVERABLE_FAULTS, FaultConfig,
                                            FaultInjector)
from repro_torch.orchestrator.selection import get_selection
from repro_torch.orchestrator.server import to_device
from repro_torch.orchestrator.straggler import StragglerPolicy


@dataclass
class PendingUpdate:
    """One in-flight client update travelling through the event queue."""
    seq: int                    # dispatch order (heap tie-break)
    cid: int
    client_idx: int             # index into the fleet list
    dispatch_version: int       # server commit counter at dispatch
    dispatch_time: float
    duration_s: float           # fault-free attempt duration (recovery base)
    delta: object = None        # update dict (None if the client faulted)
    loss: float = float("nan")
    weight: float = 1.0
    failed: bool = False
    fault: str = ""             # dropout | preempt | partition ("" = none)
    steps_done: int = 0         # local steps checkpointed before the fault
    retries: int = 0            # recovery attempts consumed so far
    recovery_s: float = 0.0     # arrival delay vs. the fault-free attempt
    work_s: float = 0.0         # closed-form work (scheduler: sans queue)
    queue_wait_s: float = 0.0   # time spent queued before the node started
    site: str = ""              # placement site the attempt ran on
    job_id: str = ""            # scheduler-backend job backing the attempt


@dataclass
class CommitLog:
    commit: int
    sim_time: float
    n_updates: int
    mean_staleness: float
    max_staleness: int
    client_loss: float
    delta_norm: float
    bytes_up: int
    timeout_commit: bool = False
    eval_metric: float = float("nan")
    n_recovered: int = 0               # committed updates that survived a fault
    recovery_time_s: float = 0.0       # mean extra latency those updates paid
    staleness_alpha: float = 0.5       # discount exponent used BY this commit
    mask_overhead_bytes: int = 0       # uplink bytes masking added over the
    #                                    plain (compressed) wire payload
    queue_wait_s: float = 0.0          # mean scheduler queue wait of the
    #                                    committed updates (scheduler backend)
    n_overflow: int = 0                # committed updates that ran off their
    #                                    home site (elastic HPC->cloud burst)
    inter_facility_bytes: int = 0      # WAN bytes of tier-2 facility commits
    #                                    (0 in flat runs)
    recovery_actions: list = field(default_factory=list)
    #                                  # "fault:policy" decisions the adaptive
    #                                    recovery policy took since the
    #                                    previous commit
    phase_wall: dict = field(default_factory=dict)
    #                                  # host wall-clock seconds per engine
    #                                    phase (dispatch/train/commit/
    #                                    host_sync) plus the host-sync count
    #                                    since the previous commit.  Profiling
    #                                    only: excluded from every trajectory
    #                                    comparison.


def stack_slots(ups, stal, K: int, device):
    """Stack the updates ``ups`` (staleness ``stal``) into K slots for the
    commit step, padding with zero deltas, weight 0 and mask 0 (a padding
    slot contributes nothing, and every pair mask touching it is unwound).
    ``ids`` are per-commit SLOT indices, not cids: mask cancellation needs
    unique participant ids, and one fast client can land two updates in
    one commit.  The hierarchy's tier-2 commit stacks facility deltas the
    same way."""
    pad = K - len(ups)
    first = ups[0].delta
    stacked = {k: torch.stack([u.delta[k] for u in ups]
                              + [torch.zeros_like(first[k])] * pad)
               for k in first}

    def vec(vals):
        return torch.tensor(vals, dtype=torch.float32, device=device)

    weights = vec([u.weight for u in ups] + [0.0] * pad)
    staleness = vec(list(stal) + [0] * pad)
    # a loss the window engine left on the device is stacked there, not
    # read back: the commit's only read is _commit_host_fetch
    vals = [u.loss for u in ups] + [0.0] * pad
    losses = vec([0.0 if torch.is_tensor(v) else v for v in vals])
    if any(torch.is_tensor(v) for v in vals):
        losses = torch.stack([v.to(losses.dtype) if torch.is_tensor(v)
                              else losses[i] for i, v in enumerate(vals)])
    mask = vec([1.0] * len(ups) + [0.0] * pad)
    ids = torch.arange(K, dtype=torch.int32)
    return stacked, weights, staleness, losses, mask, ids


@dataclass
class AsyncOrchestrator:
    fleet: list                       # list[ClientInfo]
    fed_data: object                  # FederatedDataset
    loss_fn: Callable                 # (params, batch) -> (loss, aux)
    fl: FLConfig
    async_cfg: AsyncConfig = field(default_factory=AsyncConfig)
    client_opt_name: str = "sgd"
    server_opt_name: str = "fedavg"
    server_opt_kw: dict = field(default_factory=dict)
    selection_name: str = "adaptive"
    straggler: StragglerPolicy = field(default_factory=StragglerPolicy)
    faults: FaultConfig = field(default_factory=FaultConfig)
    batch_size: int = 16
    flops_per_client_round: float = 1e12
    eval_fn: Optional[Callable] = None     # (params) -> scalar tensor
    eval_every: int = 10                   # in commits
    checkpoint_mgr: object = None          # AsyncCheckpointManager (or None)
    checkpoint_every: int = 0              # in commits (0 = only at run end)
    backend: object = None                 # ExecutionBackend (None -> closed)
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.fl.mode != "async":
            raise ValueError(
                f"AsyncOrchestrator requires FLConfig(mode='async'), got "
                f"mode={self.fl.mode!r}; use Orchestrator for the "
                f"synchronous barrier loop")
        self.rng = np.random.default_rng(self.seed)
        # commit randomness (stochastic rounding, federated dropout, the
        # secure-aggregation mask keys), checkpointed with the run
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        if self.backend is None:
            # local import: repro_torch.exec consumes the straggler model
            # from this package, so a module-level import would be circular
            from repro_torch.exec.backend import ClosedFormBackend
            self.backend = ClosedFormBackend()
        self.backend.bind(self.rng, self.straggler)
        self.selection = get_selection(self.selection_name, seed=self.seed)
        self.fault_injector = FaultInjector(self.faults, seed=self.seed + 1)
        self.comm = CommAccountant()
        self.logs: list[CommitLog] = []
        client_opt = get_client_optimizer(self.client_opt_name)
        server_opt = get_server_optimizer(self.server_opt_name,
                                          **self.server_opt_kw)
        self._server_opt = server_opt
        self._client_update = build_client_update_step(self.loss_fn,
                                                       client_opt, self.fl)
        self._commit_step = build_buffer_commit_step(server_opt, self.fl,
                                                     self.async_cfg)
        # chunked commit: only when the chunk is smaller than the buffer;
        # otherwise the single-shot step is the same commit
        self._chunk_steps = None
        if 0 < self.async_cfg.commit_chunk < self.async_cfg.buffer_size:
            self._chunk_steps = build_chunked_commit_steps(
                server_opt, self.fl, self.async_cfg)
        # staleness exponent: a constant, or an online controller whose
        # alpha the commit step takes as a runtime float
        self._staleness_ctrl = (AdaptiveStalenessController()
                                if self.async_cfg.adaptive_staleness else None)
        self._alpha = self.async_cfg.initial_exponent()
        # simulation state
        self.clock = 0.0
        self.version = 0              # server commit counter
        self.updates_applied = 0      # accepted client updates committed
        self.dropped_stale = 0
        self.recovered_updates = 0    # updates that arrived after >=1 fault
        self.lost_to_faults = 0       # attempts abandoned (no recovery)
        self.recovery_time_total = 0.0
        self._seq = 0
        self._recovery_actions: list[str] = []  # adaptive-policy decisions
        #                               accrued since the last commit
        self._events: list = []       # heap of (arrival_time, seq, PendingUpdate)
        self._inflight: set[int] = set()   # cids currently training
        self._buffer: list[tuple] = []     # [(PendingUpdate, arrival_time)]
        self._buffer_bytes = 0
        # array mirror of the buffered arrival times: the timeout flush
        # tests its head in O(1)
        self._buffer_t = np.empty(0)
        # per-phase host wall-clock accounting, flushed into each CommitLog
        self._phase = {"dispatch": 0.0, "train": 0.0, "commit": 0.0,
                       "host_sync": 0.0}
        self._host_syncs = 0
        # processed-event trace: (t, seq, cid, failed, fault) per heap pop
        self.events_processed: list[tuple] = []

    # ------------------------------------------------------------------
    def init_server_state(self, params):
        return self._server_opt.init(params)

    def _payload_bytes_cache(self, params):
        """(down_bytes, up_bytes) one dispatch/arrival costs on the wire.
        Under secure_agg the uplink is the MASKED update: dense f32 without
        quantization, finite-ring words of quantize_bits +
        ceil(log2(buffer_size)) bits with it."""
        if not hasattr(self, "_pb"):
            down = payload_bytes(params, self.fl.compression)
            up = (masked_payload_bytes(params, self.fl.compression,
                                       n_slots=self.async_cfg.buffer_size)
                  if self.fl.secure_agg else down)
            self._pb = (down, up)
        return self._pb

    # --------------------------------------------------------- phase timers
    @contextmanager
    def _timed(self, phase: str):
        """Attribute elapsed host wall-clock to ``phase``.  Nested phases
        book their own time; the outer phase gets elapsed minus whatever
        inner phases accrued, so the four counters partition the wall
        clock."""
        snap = dict(self._phase)
        t0 = perf_counter()
        try:
            yield
        finally:
            inner = sum(self._phase[k] - snap[k] for k in snap)
            self._phase[phase] += perf_counter() - t0 - inner

    def _host_fetch(self, x):
        """Device-to-host read (``.item()`` of a scalar, ``.cpu()`` of the
        rest), counted and billed to the host_sync phase.  Every engine
        sync point goes through here, so ``phase_wall['host_syncs']`` counts
        them all."""
        with self._timed("host_sync"):
            self._host_syncs += 1
            return x.item() if x.ndim == 0 else x.cpu()

    # ---------------------------------------------------- engine extension
    # The event-window engine (orchestrator.eventwindow) substitutes the
    # structure behind these seams; the per-event baseline keeps the plain
    # heapq semantics they wrap.
    def _push_event(self, t: float, seq: int, upd: PendingUpdate):
        heapq.heappush(self._events, (t, seq, upd))

    def _pop_event(self):
        return heapq.heappop(self._events)

    def _abandon_update(self, upd: PendingUpdate):
        """``upd`` will never be committed (dropped as stale, or lost to an
        unrecovered fault): engines that defer work for it may cancel the
        pending job.  No-op in the eager per-event engine."""

    # ------------------------------------------------------------- dispatch
    def _sample_batches(self, client) -> dict:
        """The client's [H, b, ...] numpy batches for one attempt."""
        batches = self.fed_data.sample_round([client.cid],
                                             self.fl.local_steps,
                                             self.batch_size)
        return {k: v[0] for k, v in batches.items()}

    def _train_client(self, upd: PendingUpdate, client, params):
        """Run the client's local training against the given params
        snapshot; one host read for its loss."""
        batches = to_device(self._sample_batches(client), self.device)
        with self._timed("train"):
            delta, loss = self._client_update(params, batches)
            upd.delta = delta
            upd.loss = float(self._host_fetch(loss))
        upd.weight = float(max(self.fed_data.client_size(client.cid), 1))

    def _pick_client(self, rnd: int):
        """Select one idle client: (client_idx, client), or None when every
        client is in flight.  ``rnd`` is the dispatch counter the selection
        strategy scores aging against (the seq the dispatch will get)."""
        avail = [c for c in self.fleet if c.cid not in self._inflight]
        if not avail:
            return None
        sel = self.selection.select(avail, 1, rnd)
        client_idx = next(i for i, c in enumerate(self.fleet)
                          if c.cid == sel[0])
        return client_idx, self.fleet[client_idx]

    def _execute_attempt(self, client, params, now: float):
        """Price one attempt through the execution backend."""
        up_bytes = self._payload_bytes_cache(params)[1]
        return self.backend.execute(client, self.flops_per_client_round,
                                    up_bytes, now)

    def _draw_attempt_fault(self, client):
        # the injector's round clock advances per COMMIT (_do_commit), so
        # FaultConfig partition probabilities and durations keep their
        # sync-round units; the fault dice roll per dispatch.  When the
        # backend's own event stream produces spot preemptions, the injector
        # must not also reclaim the instance.
        return self.fault_injector.draw_fault(
            client, include_preempt=not self.backend.handles_preemption)

    def _dispatch_one(self, params, now: float):
        """Hand the current params to one idle client; schedule its arrival."""
        with self._timed("dispatch"):
            picked = self._pick_client(self._seq)
            if picked is None:
                return False
            client_idx, client = picked
            ex = self._execute_attempt(client, params, now)
            self._finish_dispatch(client_idx, client, ex, params, now)
        return True

    def _finish_dispatch(self, client_idx, client, ex, params, now: float):
        """Everything after the attempt is priced: fault dice, optional
        local training, comm ledger, and the arrival event."""
        down_bytes, up_bytes = self._payload_bytes_cache(params)
        failed, fault, frac = self._draw_attempt_fault(client)

        upd = PendingUpdate(seq=self._seq, cid=client.cid,
                            client_idx=client_idx,
                            dispatch_version=self.version,
                            dispatch_time=now, duration_s=ex.fault_free_s,
                            failed=failed, fault=fault, work_s=ex.work_s,
                            queue_wait_s=ex.queue_wait_s, site=ex.site,
                            job_id=ex.job_id)
        arrival = now + ex.fault_free_s
        if failed:
            # the injector fault strikes at frac of the attempt's node time
            # (queue wait already paid)
            arrival = now + ex.queue_wait_s + frac * ex.full_run_s
            upd.steps_done = int(frac * self.fl.local_steps)
        elif ex.preempted:
            # scheduler-origin spot reclaim: the strike time comes from the
            # K8s adapter's event stream
            upd.failed, upd.fault = True, "preempt"
            arrival = now + ex.duration_s
            upd.steps_done = int(ex.frac_done * self.fl.local_steps)
        if (not upd.failed) or (upd.fault in RECOVERABLE_FAULTS
                                and self.faults.recovery_policy
                                in ("resume", "adaptive")):
            # the client trains against the params snapshot it is handed
            # NOW; under the resume policy a preempted/partitioned client
            # keeps a local step checkpoint, so its delta is computed up
            # front and survives the fault
            self._train_client(upd, client, params)
        link = link_for_site(ex.site or client.site)
        self.comm.log(self.version, client.cid, "down", down_bytes, link)
        self._inflight.add(client.cid)
        self._push_event(arrival, self._seq, upd)
        self._seq += 1

    def _top_up(self, params):
        """Dispatch until max_concurrency clients are in flight (a
        continuation or restored run may already have some)."""
        target = min(self.async_cfg.max_concurrency, len(self.fleet))
        for _ in range(max(0, target - len(self._inflight))):
            self._dispatch_one(params, self.clock)

    # ------------------------------------------------------------- recovery
    def _choose_recovery(self, upd: PendingUpdate, t: float) -> str:
        """Adaptive per-fault policy from the update's observed staleness
        and its remaining work: discard when the recovered update would
        exceed ``max_staleness`` anyway, resume when most of the work is
        checkpointed locally, restart otherwise (which also resets the
        accrued staleness)."""
        L = max(self.fl.local_steps, 1)
        remaining_frac = (L - upd.steps_done) / L
        base = upd.work_s or upd.duration_s
        remaining_s = (base * remaining_frac
                       + self.faults.recovery_overhead_s)
        staleness_now = self.version - upd.dispatch_version
        commit_rate = self.version / self.clock if self.clock > 0 else 0.0
        projected = staleness_now + commit_rate * remaining_s
        if projected > self.async_cfg.max_staleness:
            return "discard"
        return "resume" if remaining_frac <= 0.5 else "restart"

    def _handle_fault_arrival(self, upd: PendingUpdate, t: float, params):
        """A fault just struck ``upd``'s client at sim-time ``t``.  Returns
        True when a recovery attempt was scheduled (the slot stays busy);
        False when the attempt's work is lost and the slot frees."""
        client = self.fleet[upd.client_idx]
        # the faulted attempt's backing job produces nothing further
        self.backend.release(upd.job_id, t)
        upd.job_id = ""
        policy = self.faults.recovery_policy
        if (policy == "adaptive" and upd.fault in RECOVERABLE_FAULTS
                and upd.retries < self.faults.max_retries):
            policy = self._choose_recovery(upd, t)
            self._recovery_actions.append(f"{upd.fault}:{policy}")
        if (upd.fault not in RECOVERABLE_FAULTS or policy == "discard"
                or upd.retries >= self.faults.max_retries):
            return False
        L = max(self.fl.local_steps, 1)
        start = t + self.faults.recovery_overhead_s
        if policy == "restart":
            # retry from scratch against the CURRENT global params: fresh
            # downlink, fresh batches, staleness resets to the live version
            upd.steps_done = 0
            down_bytes, up_bytes = self._payload_bytes_cache(params)
            ex = self.backend.execute(client, self.flops_per_client_round,
                                      up_bytes, start)
            # duration_s is the recovery baseline: the fault-free duration
            # of the attempt that will actually land
            upd.duration_s = ex.fault_free_s
            upd.work_s, upd.queue_wait_s = ex.work_s, ex.queue_wait_s
            self._train_client(upd, client, params)
            upd.dispatch_version = self.version
            self.comm.log(self.version, client.cid, "down", down_bytes,
                          link_for_site(ex.site or client.site))
        else:  # resume: re-run only the steps after the local checkpoint
            base = upd.work_s or upd.duration_s
            ex = self.backend.resume(client,
                                     base * (L - upd.steps_done) / L, start)
        upd.site, upd.job_id = (ex.site or upd.site), ex.job_id
        failed, fault, frac = self.fault_injector.draw_fault(
            client, include_preempt=not self.backend.handles_preemption)
        upd.retries += 1
        if failed and ex.full_run_s > 0:
            upd.failed, upd.fault = True, fault
            if policy == "resume":
                upd.steps_done += int(frac * (L - upd.steps_done))
            self._push_event(start + ex.queue_wait_s + frac * ex.full_run_s,
                             upd.seq, upd)
        elif ex.preempted:
            # the scheduler reclaimed the RETRY's spot instance too
            upd.failed, upd.fault = True, "preempt"
            if policy == "resume":
                upd.steps_done += int(ex.frac_done * (L - upd.steps_done))
            else:
                upd.steps_done = int(ex.frac_done * L)
            self._push_event(start + ex.duration_s, upd.seq, upd)
        else:
            upd.failed, upd.fault = False, ""
            self._push_event(start + ex.duration_s, upd.seq, upd)
        return True

    # --------------------------------------------------------------- commit
    def _materialize(self):
        """Deferred-training hook: engines that defer the client update at
        dispatch (BatchedAsyncOrchestrator) compute every pending delta
        here.  Called before any code that reads ``upd.delta``/``upd.loss``:
        the commit and the checkpoint serializer.  No-op here (deltas are
        computed eagerly at dispatch)."""

    def _materialize_for_commit(self):
        """Materialise only what the imminent commit reads.  The baseline
        delegates to the full hook; the event-window engine narrows it to
        the buffered updates."""
        self._materialize()

    def _commit_host_fetch(self, metrics, ups):
        """The commit's one host read: its delta norm, plus the losses the
        CommitLog needs.  Returns (delta_norm, losses as host floats).  The
        baseline's losses are host floats already; the event-window engine
        bundles its deferred loss buckets into the same read."""
        return (float(self._host_fetch(metrics["delta_norm"])),
                [float(u.loss) for u in ups])

    def engine_state(self) -> dict:
        """Engine-private checkpoint payload beyond the shared serializer's
        fields.  The per-event engine has none."""
        return {}

    def _after_restore(self):
        """Called by the checkpoint loader after all shared state is in
        place, so engines can rebuild derived structures.  The baseline
        rebuilds the buffered-arrival mirror the timeout flush reads."""
        self._buffer_t = np.asarray([a for _, a in self._buffer], np.float64)

    def _commit_chunked(self, params, server_state, ups, stal, alpha):
        """Accumulate the buffer C slots at a time: one call per chunk plus
        one finalize.  Each chunk draws its own randomness and mask key from
        the generator and uses arange(C) slot ids, so secure-aggregation
        masks cancel chunk by chunk."""
        C = self.async_cfg.commit_chunk
        acc_step, fin_step = self._chunk_steps
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        wsum = torch.zeros((), dtype=torch.float32, device=self.device)
        for lo in range(0, len(ups), C):
            stacked, weights, staleness, losses, mask, ids = \
                stack_slots(ups[lo:lo + C], stal[lo:lo + C], C, self.device)
            acc, wsum = acc_step(acc, wsum, stacked, weights, staleness,
                                 losses, mask, ids, alpha, self.generator)
        return fin_step(params, server_state, acc, wsum)

    def _do_commit(self, params, server_state, at_time: float,
                   timeout: bool = False):
        t0 = perf_counter()
        snap = dict(self._phase)
        self._materialize_for_commit()
        ups = [u for u, _ in self._buffer]
        stal = [self.version - u.dispatch_version for u in ups]
        alpha = self._alpha
        if self._chunk_steps is not None:
            params, server_state, metrics = self._commit_chunked(
                params, server_state, ups, stal, alpha)
        else:
            stacked, weights, staleness, losses, mask, ids = \
                stack_slots(ups, stal, self.async_cfg.buffer_size,
                            self.device)
            params, server_state, metrics = self._commit_step(
                params, server_state, stacked, weights, staleness, losses,
                mask, ids, alpha, self.generator)
        self.version += 1
        self.fault_injector.step_round()
        self.updates_applied += len(ups)
        delta_norm, up_losses = self._commit_host_fetch(metrics, ups)
        if self._staleness_ctrl is not None:
            # feed the controller AFTER the commit: alpha moves for the next
            # one, deterministically from observed staleness + norm drift
            self._alpha = self._staleness_ctrl.update(stal, delta_norm)
        down_b, up_b = self._payload_bytes_cache(params)
        losses = [l for l in up_losses if np.isfinite(l)]
        rec = [u.recovery_s for u in ups if u.retries]
        log = CommitLog(
            commit=self.version, sim_time=at_time, n_updates=len(ups),
            mean_staleness=float(np.mean(stal)) if stal else 0.0,
            max_staleness=int(max(stal)) if stal else 0,
            client_loss=float(np.mean(losses)) if losses else float("nan"),
            delta_norm=delta_norm,
            bytes_up=self._buffer_bytes, timeout_commit=timeout,
            n_recovered=len(rec),
            recovery_time_s=float(np.mean(rec)) if rec else 0.0,
            staleness_alpha=alpha,
            mask_overhead_bytes=(up_b - down_b) * len(ups)
            if self.fl.secure_agg else 0,
            queue_wait_s=(float(np.mean([u.queue_wait_s for u in ups]))
                          if ups else 0.0),
            n_overflow=sum(1 for u in ups
                           if u.site and u.site
                           != self.fleet[u.client_idx].site),
            recovery_actions=self._recovery_actions)
        self._recovery_actions = []
        if self.eval_fn and (self.version % self.eval_every == 0):
            log.eval_metric = float(self._host_fetch(self.eval_fn(params)))
        self.logs.append(log)
        self._buffer = []
        self._buffer_bytes = 0
        self._buffer_t = np.empty(0)
        # everything since the previous commit not booked to an inner phase
        # is commit work; flush the window's phase accounting into the log
        inner = sum(self._phase[k] - snap[k] for k in snap)
        self._phase["commit"] += perf_counter() - t0 - inner
        log.phase_wall = {k: round(v, 6) for k, v in self._phase.items()}
        log.phase_wall["host_syncs"] = self._host_syncs
        self._phase = {k: 0.0 for k in self._phase}
        self._host_syncs = 0
        return params, server_state

    def _flush_timeouts(self, params, server_state, now: float):
        """Commit a partial buffer whose oldest update has waited >= T.  The
        deadline is (oldest buffered arrival + T), so a commit is never
        stamped before the buffer's first update arrived."""
        T = self.async_cfg.commit_timeout_s
        if (not T or self._buffer_t.size == 0
                or self._buffer_t[0] + T > now):
            return params, server_state
        while self._buffer_t.size and self._buffer_t[0] + T <= now:
            params, server_state = self._do_commit(
                params, server_state, float(self._buffer_t[0] + T),
                timeout=True)
        return params, server_state

    # ------------------------------------------------------------------ run
    def save_checkpoint(self, params, server_state):
        """Snapshot the FULL orchestrator state through the checkpoint
        manager; a fresh orchestrator restored from it replays the exact
        trajectory an uninterrupted run would have taken."""
        if self.checkpoint_mgr is None:
            raise ValueError("no checkpoint_mgr configured")
        self.checkpoint_mgr.save_async(self, params, server_state)

    def run(self, params, num_commits: int, server_state=None,
            max_sim_time: float = 0.0, verbose: bool = False):
        """Run until `num_commits` server commits (or `max_sim_time`)."""
        if server_state is None:
            server_state = self.init_server_state(params)
        self._top_up(params)

        last_ckpt = self.version
        while self._events and self.version < num_commits:
            t, seq, upd = self._pop_event()
            if max_sim_time and t > max_sim_time:
                # budget exhausted before this arrival: flush the timeout
                # deadlines inside the budget, put the event back for a
                # continuation run, and pin the clock to the budget
                params, server_state = self._flush_timeouts(
                    params, server_state, max_sim_time)
                self._push_event(t, seq, upd)
                self.clock = max_sim_time
                break
            params, server_state = self._flush_timeouts(params, server_state, t)
            if self.version >= num_commits:
                self._push_event(t, seq, upd)
                break
            self.clock = max(self.clock, t)
            client = self.fleet[upd.client_idx]
            self.events_processed.append(
                (round(t, 9), upd.seq, upd.cid, bool(upd.failed), upd.fault))
            if upd.failed:
                if self._handle_fault_arrival(upd, t, params):
                    continue            # slot stays busy with the retry
                self.lost_to_faults += 1
                self._abandon_update(upd)
                self._inflight.discard(upd.cid)
                # history in dispatch-counter units, matching select()'s view
                client.record(False, t - upd.dispatch_time, self._seq)
            else:
                self._inflight.discard(upd.cid)
                elapsed = t - upd.dispatch_time
                client.record(True, elapsed, self._seq)
                if upd.retries:
                    upd.recovery_s = elapsed - upd.duration_s
                    self.recovered_updates += 1
                    self.recovery_time_total += upd.recovery_s
                # the client transmitted whatever the server does with the
                # update (dropped-as-stale still paid the uplink, the MASKED
                # size under secure_agg), over the link of the site the
                # attempt was PLACED on
                up_bytes = self._payload_bytes_cache(params)[1]
                self.comm.log(self.version, upd.cid, "up", up_bytes,
                              link_for_site(upd.site or client.site))
                staleness = self.version - upd.dispatch_version
                if staleness > self.async_cfg.max_staleness:
                    self.dropped_stale += 1
                    self._abandon_update(upd)
                else:
                    self._buffer.append((upd, t))
                    self._buffer_bytes += up_bytes
                    self._buffer_t = np.append(self._buffer_t, t)
            if len(self._buffer) >= self.async_cfg.buffer_size:
                params, server_state = self._do_commit(params, server_state, t)
                if verbose and self.logs:
                    lg = self.logs[-1]
                    print(f"commit {lg.commit:4d} t={lg.sim_time:8.1f}s "
                          f"loss={lg.client_loss:.4f} "
                          f"stale={lg.mean_staleness:.1f} "
                          f"eval={lg.eval_metric:.4f}")
            self._dispatch_one(params, self.clock)
            # checkpoint only here: the popped event is fully processed and
            # its freed slot re-dispatched, so restore + continue == never
            # stopped
            if (self.checkpoint_mgr and self.checkpoint_every
                    and self.version != last_ckpt
                    and self.version % self.checkpoint_every == 0):
                self.save_checkpoint(params, server_state)
                last_ckpt = self.version
        if self.checkpoint_mgr is not None:
            # terminal snapshot, taken BEFORE the eval backfill below (which
            # is presentation only and must not leak into a resumed run)
            self.save_checkpoint(params, server_state)
        # the terminal commit always carries a real metric, as the sync
        # run's final round does
        if self.eval_fn and self.logs and not np.isfinite(
                self.logs[-1].eval_metric):
            self.logs[-1].eval_metric = float(self.eval_fn(params))
        return params, server_state

    # ------------------------------------------------------------- metrics
    @property
    def commits_per_sim_second(self) -> float:
        return self.version / self.clock if self.clock else 0.0

    @property
    def updates_per_sim_second(self) -> float:
        return self.updates_applied / self.clock if self.clock else 0.0
