"""Batched async engine for large fleets, mirroring
``repro/orchestrator/megafleet.py``.

``AsyncOrchestrator`` trains one client per dispatch and reads its loss back
at once (one host sync per update).  This engine keeps the event-exact
semantics (heap order, RNG streams, commit policy, checkpoint format) and
changes only WHERE the work happens:

  * deferred training: ``_train_client`` records a ``_TrainJob`` (params
    snapshot, host batches) instead of training; jobs are materialised at
    the next commit or checkpoint in power-of-two buckets grouped by params
    snapshot, each one stacked local training (``build_local_train(...,
    stacked=True)``: one ``vmap`` of the gradient over the bucket's
    clients), with ONE host sync per bucket for the losses.  Every host
    draw (selection, work time, fault dice, batch sampling) still happens at
    dispatch in the per-event order, so each stream is untouched; a bucket's
    clients train on the same batches as one at a time, the gradients
    batched, so params agree with the per-event engine to float32 rounding.
  * batched top-up: the initial concurrency fill prices all dispatches
    through ``ExecutionBackend.execute_batch``.
  * cohort fleet model (``CohortFleet``, populations >= 10k):
    ``ClientInfo`` objects exist only once a client first dispatches,
    dispatch picks uniformly over IDLE clients in O(#cohorts), and
    identically-profiled clients SHARE duration and fault draws in blocks of
    ``cohort_share_draws``.  An explicit modelling approximation, so not
    equal to the per-event engine; deterministic and resume-exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.round import build_local_train
from repro_torch.optim import get_client_optimizer
from repro_torch.orchestrator.async_server import AsyncOrchestrator
from repro_torch.orchestrator.registry import ClientInfo, ResourceProfile
from repro_torch.orchestrator.server import to_device
from repro_torch.orchestrator.straggler import attempt_time


# ---------------------------------------------------------------- cohorts
@dataclass(frozen=True)
class CohortSpec:
    """One block of identically-provisioned clients."""
    name: str
    site: str                      # "hpc" | "cloud"
    count: int
    profile: ResourceProfile


class CohortFleet:
    """A lazy, list-like fleet: ``len``/indexing like ``list[ClientInfo]``,
    but a client object exists only once it has dispatched.  Client ids are
    contiguous per cohort (cohort j owns [offset(j), offset(j)+count))."""

    def __init__(self, cohorts: list[CohortSpec]):
        self.cohorts = [c for c in cohorts if c.count > 0]
        if not self.cohorts:
            raise ValueError("CohortFleet needs at least one non-empty cohort")
        self._offsets = np.cumsum([0] + [c.count for c in self.cohorts])
        self._live: dict[int, ClientInfo] = {}

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _check(self, cid: int):
        if not 0 <= cid < len(self):
            raise IndexError(cid)

    def cohort_of(self, cid: int) -> int:
        self._check(cid)
        return int(np.searchsorted(self._offsets, cid, side="right") - 1)

    def offset(self, j: int) -> int:
        return int(self._offsets[j])

    def __getitem__(self, cid: int) -> ClientInfo:
        self._check(cid)
        c = self._live.get(cid)
        if c is None:
            spec = self.cohorts[self.cohort_of(cid)]
            c = self._live[cid] = ClientInfo(cid, spec.site, spec.profile)
        return c

    @property
    def live(self) -> dict[int, ClientInfo]:
        """Materialised clients (those that ever dispatched): what the
        checkpoint serialises instead of the full population."""
        return self._live


def make_mega_fleet(n_clients: int, seed: int = 0,
                    spot_frac: float = 0.4) -> CohortFleet:
    """The paper's hybrid testbed scaled to ``n_clients``, as cohorts: half
    HPC with a 70% GPU split, half cloud with a 50% GPU split and
    ``spot_frac`` preemptible, each cohort drawing ONE representative
    profile from ``make_hybrid_fleet``'s distributions."""
    rng = np.random.default_rng(seed)
    n_hpc = n_clients // 2
    n_cloud = n_clients - n_hpc
    n_hpc_gpu = int(0.7 * n_hpc)
    n_cloud_gpu = int(0.5 * n_cloud)
    n_cloud_cpu = n_cloud - n_cloud_gpu

    def cloud_prof(tf_mu, tf_sd, mem, spot):
        return ResourceProfile(
            compute_tflops=float(rng.normal(tf_mu, tf_sd)),
            bandwidth_gbps=float(rng.uniform(0.5, 1.25)),
            latency_ms=float(rng.uniform(5, 40)),
            memory_gb=mem, reliability=0.98, spot=spot)

    hpc_gpu = ResourceProfile(float(rng.normal(16.3, 1.0)), 12.5, 0.05,
                              24.0, reliability=0.995)
    hpc_cpu = ResourceProfile(float(rng.normal(1.0, 0.1)), 12.5, 0.05,
                              8.0, reliability=0.995)
    n_gpu_spot = int(round(spot_frac * n_cloud_gpu))
    n_cpu_spot = int(round(spot_frac * n_cloud_cpu))
    return CohortFleet([
        CohortSpec("hpc-gpu", "hpc", n_hpc_gpu, hpc_gpu),
        CohortSpec("hpc-cpu", "hpc", n_hpc - n_hpc_gpu, hpc_cpu),
        CohortSpec("cloud-gpu", "cloud", n_cloud_gpu - n_gpu_spot,
                   cloud_prof(15.7, 1.5, 16.0, False)),
        CohortSpec("cloud-gpu-spot", "cloud", n_gpu_spot,
                   cloud_prof(15.7, 1.5, 16.0, True)),
        CohortSpec("cloud-cpu", "cloud", n_cloud_cpu - n_cpu_spot,
                   cloud_prof(0.4, 0.05, 8.0, False)),
        CohortSpec("cloud-cpu-spot", "cloud", n_cpu_spot,
                   cloud_prof(0.4, 0.05, 8.0, True)),
    ])


class _CohortInflight(set):
    """The in-flight cid set, with an O(1) per-cohort busy counter so cohort
    dispatch never walks the set."""

    def __init__(self, fleet: CohortFleet):
        super().__init__()
        self._fleet = fleet
        self.by_cohort = np.zeros(len(fleet.cohorts), np.int64)

    def add(self, cid):
        if cid not in self:
            self.by_cohort[self._fleet.cohort_of(cid)] += 1
        super().add(cid)

    def discard(self, cid):
        if cid in self:
            self.by_cohort[self._fleet.cohort_of(cid)] -= 1
        super().discard(cid)


# ----------------------------------------------------------------- engine
@dataclass
class _TrainJob:
    """One deferred local-training call, fixed at dispatch time."""
    upd: object                    # the PendingUpdate awaiting delta/loss
    params: object                 # params snapshot REF (replaced per commit,
    #                                never mutated, so holding it is free)
    batches: dict                  # host-side sampled batches [H, b, ...]


@dataclass
class BatchedAsyncOrchestrator(AsyncOrchestrator):
    """``AsyncOrchestrator`` with deferred, bucketed training, batched top-up
    dispatch, and the cohort fleet model when ``fleet`` is a
    ``CohortFleet``.  On flat (list) fleets its events, logs and comm ledger
    equal the per-event engine's; params agree to float32 rounding."""

    train_chunk: int = 32          # max clients per training bucket
    cohort_share_draws: int = 8    # dispatches per shared duration/fault draw

    def __post_init__(self):
        super().__post_init__()
        if self.train_chunk < 1:
            raise ValueError(
                f"train_chunk must be >= 1, got {self.train_chunk}")
        if self.cohort_share_draws < 1:
            raise ValueError(f"cohort_share_draws must be >= 1, got "
                             f"{self.cohort_share_draws}")
        self._jobs: dict[int, _TrainJob] = {}     # seq -> deferred training
        self._stacked_update = build_local_train(
            self.loss_fn, get_client_optimizer(self.client_opt_name),
            self.fl, stacked=True)
        self._cohort_mode = isinstance(self.fleet, CohortFleet)
        self._cohort_draws: dict[int, dict] = {}  # cohort -> shared block
        if self._cohort_mode:
            self._inflight = _CohortInflight(self.fleet)
            self._cohort_counts = np.array(
                [c.count for c in self.fleet.cohorts], np.int64)

    # --------------------------------------------------- deferred training
    def _train_client(self, upd, client, params):
        """Record the training call; it runs at materialise time.  The batch
        draw happens HERE, in dispatch order, as in the eager engine."""
        batches = self._sample_batches(client)
        upd.weight = float(max(self.fed_data.client_size(client.cid), 1))
        # a restart retry re-enters here with the same seq: the stale job is
        # replaced
        self._jobs[upd.seq] = _TrainJob(upd, params, batches)

    def _materialize(self, seqs=None):
        """Materialise the deferred jobs: all of them, or (``seqs`` given)
        only that subset, leaving the rest queued for a later call."""
        pending = (sorted(self._jobs) if seqs is None
                   else sorted(s for s in self._jobs if s in seqs))
        if not pending:
            return
        # group by params snapshot, seq order within each group; chunk each
        # group into buckets
        with self._timed("train"):
            groups: dict[int, list[_TrainJob]] = {}
            for seq in pending:
                job = self._jobs[seq]
                groups.setdefault(id(job.params), []).append(job)
            for jobs in groups.values():
                for lo in range(0, len(jobs), self.train_chunk):
                    self._run_chunk(jobs[lo:lo + self.train_chunk])
        for seq in pending:
            del self._jobs[seq]

    def _run_chunk(self, jobs: list[_TrainJob]):
        """Train one bucket of same-snapshot jobs as one stacked call.
        Buckets are padded to the next power of two by repeating lane 0
        (padded lanes are discarded), so a run sees log2(train_chunk)
        bucket sizes, not one per length."""
        n = len(jobs)
        lanes = 1 << max(n - 1, 0).bit_length()
        pick = list(range(n)) + [0] * (lanes - n)
        batches = to_device(
            {k: np.stack([jobs[i].batches[k] for i in pick])
             for k in jobs[0].batches}, self.device)
        deltas, losses = self._stacked_update(jobs[0].params, batches)
        self._finish_chunk(jobs, deltas, losses)

    def _finish_chunk(self, jobs, deltas, losses):
        """Assign a bucket's results to its updates: one host sync (the loss
        read) for the bucket.  The event-window engine defers even that to
        the commit's bundled read."""
        lv = self._host_fetch(losses).numpy()
        for i, job in enumerate(jobs):
            job.upd.delta = {k: d[i] for k, d in deltas.items()}
            job.upd.loss = float(lv[i])

    # ----------------------------------------------------- batched top-up
    def _top_up(self, params):
        if self._cohort_mode:
            # cohort dispatch is O(#cohorts) with amortised shared draws;
            # the shared-draw cache must interleave as in steady state
            return super()._top_up(params)
        with self._timed("dispatch"):
            target = min(self.async_cfg.max_concurrency, len(self.fleet))
            picks = []
            for _ in range(max(0, target - len(self._inflight))):
                picked = self._pick_client(self._seq + len(picks))
                if picked is None:
                    break
                # claim the slot now so the next pick's availability view
                # matches the sequential engine's
                self._inflight.add(picked[1].cid)
                picks.append(picked)
            if not picks:
                return
            up_bytes = self._payload_bytes_cache(params)[1]
            exs = self.backend.execute_batch(
                [c for _, c in picks], self.flops_per_client_round, up_bytes,
                self.clock)
            for (client_idx, client), ex in zip(picks, exs):
                self._finish_dispatch(client_idx, client, ex, params,
                                      self.clock)

    # ----------------------------------------------------- cohort dispatch
    def _cohort_draw(self, client) -> dict:
        """The cohort's current shared draw block: one contention noise and
        one fault fate reused for ``cohort_share_draws`` dispatches."""
        j = self.fleet.cohort_of(client.cid)
        e = self._cohort_draws.get(j)
        if e is None or e["left"] <= 0:
            e = self._cohort_draws[j] = {
                "noise": float(self.rng.lognormal(
                    0.0, self.straggler.contention_sigma)),
                "fate": list(self.fault_injector.draw_fault(
                    client,
                    include_preempt=not self.backend.handles_preemption)),
                "left": int(self.cohort_share_draws)}
        return e

    def _pick_client(self, rnd: int):
        if not self._cohort_mode:
            return super()._pick_client(rnd)
        idle = self._cohort_counts - self._inflight.by_cohort
        total = int(idle.sum())
        if total <= 0:
            return None
        # cohort proportional to its idle count, then a uniform idle member:
        # exactly uniform over idle clients
        rng = self.selection.rng
        j = int(rng.choice(len(idle), p=idle / total))
        base, count = self.fleet.offset(j), int(self._cohort_counts[j])
        for _ in range(64):                        # rejection: P(hit) = idle/count
            cid = base + int(rng.integers(count))
            if cid not in self._inflight:
                break
        else:  # nearly-saturated cohort: enumerate its idle members once
            free = [c for c in range(base, base + count)
                    if c not in self._inflight]
            cid = int(free[int(rng.integers(len(free)))])
        return cid, self.fleet[cid]

    def _execute_attempt(self, client, params, now):
        if self._cohort_mode and not self.backend.handles_preemption:
            # closed-form pricing with the cohort's shared noise draw (local
            # import: repro_torch.exec depends on this package's straggler
            # model)
            from repro_torch.exec.backend import ClientExecution
            up_bytes = self._payload_bytes_cache(params)[1]
            w = attempt_time(client.profile, self.flops_per_client_round,
                             up_bytes, self._cohort_draw(client)["noise"])
            return ClientExecution(work_s=w, run_s=w, site=client.site)
        return super()._execute_attempt(client, params, now)

    def _draw_attempt_fault(self, client):
        if not self._cohort_mode:
            return super()._draw_attempt_fault(client)
        e = self._cohort_draw(client)
        e["left"] -= 1
        failed, kind, frac = e["fate"]
        return bool(failed), str(kind), float(frac)

    # ------------------------------------------------ checkpointable state
    def engine_state(self) -> dict:
        """Engine-private state beyond the base serializer's reach.  Pending
        train jobs are materialised before any save, so only the cohort
        shared-draw blocks remain."""
        if not self._cohort_draws:
            return {}
        return {"cohort_draws": {str(j): dict(e)
                                 for j, e in self._cohort_draws.items()}}

    def load_engine_state(self, s: dict):
        self._cohort_draws = {
            int(j): {"noise": float(e["noise"]), "fate": list(e["fate"]),
                     "left": int(e["left"])}
            for j, e in s.get("cohort_draws", {}).items()}

    def _abandon_update(self, upd):
        # the update's delta will never be read: cancel its deferred job
        self._jobs.pop(upd.seq, None)

    def _after_restore(self):
        # restored deltas are eager; cohort draw blocks were already loaded
        # by load_engine_state (or stay empty on a flat-fleet snapshot)
        super()._after_restore()
        self._jobs.clear()
        if self._cohort_mode:
            infl = _CohortInflight(self.fleet)
            for cid in self._inflight:
                infl.add(cid)
            self._inflight = infl
