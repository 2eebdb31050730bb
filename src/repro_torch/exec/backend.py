"""Execution backends: ONE source of simulated time for client training.

Both orchestrators used to derive every client round time straight from the
closed-form lognormal model in ``orchestrator.straggler`` while the
SLURM/K8s scheduler simulation sat in a silo, and spot preemptions were an
independent ``FaultInjector`` coin flip.  The ``ExecutionBackend`` interface
makes timing/placement pluggable:

  * ``ClosedFormBackend`` — wraps ``simulate_round_times`` (compute +
    transfer + lognormal contention).  Zero queue wait, clients always run
    on their home site.  The fast default; bit-identical to the pre-backend
    behaviour.
  * ``SchedulerBackend`` — dispatches each client attempt as a ``JobSpec``
    through a ``HybridAdapter``, so the attempt's wall time additionally
    includes queue wait behind a finite SLURM partition, elastic HPC→cloud
    overflow, K8s autoscaling, and spot preemptions that ORIGINATE FROM THE
    ADAPTER's reclaim events (``handles_preemption``) instead of an injector
    draw.  Placement (the site the job actually ran on) feeds the comm
    ledger and the RoundLog/CommitLog queue-wait/overflow columns.

Both backends draw the underlying work duration from the SAME
``simulate_round_times`` call against the orchestrator's RNG, so with an
uncontended pool, zero queue noise and no preemption the two backends
produce identical times — the equivalence ``tests/test_exec_backend.py``
pins to 1e-6.

Determinism/checkpointing: the scheduler adapters fix every random draw at
submit time and stamp exact terminal deadlines, so a job's trajectory is
fully determined by the already-submitted job set.  ``SchedulerBackend``
exploits that twice — arrival lookahead steps a *clone* of the pool through
its exact event times (the real pool replays the same trajectory as the
orchestrator clock catches up), and ``state()``/``set_state()`` serialise
the pool for bit-identical kill/``--resume``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np

from repro_torch.orchestrator.straggler import StragglerPolicy, simulate_round_times
from repro_torch.sched.adapter import JobState, TERMINAL_STATES, JobSpec
from repro_torch.sched.hybrid import HybridAdapter

BACKEND_NAMES = ("closed-form", "scheduler")


@dataclass
class ClientExecution:
    """Where and when one client-training attempt actually ran.

    ``work_s`` is the fault-free closed-form attempt duration (the recovery
    baseline); ``run_s`` is the time the job actually held its node — equal
    to the scheduled runtime for completed jobs, truncated at the strike for
    preempted ones."""
    work_s: float
    run_s: float
    queue_wait_s: float = 0.0
    full_run_s: float = 0.0        # scheduled runtime had nothing struck it
    site: str = ""                 # placement site ("hpc" | "cloud")
    job_id: str = ""
    preempted: bool = False        # adapter-origin spot reclaim
    overflowed: bool = False       # placed off its requested site

    def __post_init__(self):
        if not self.full_run_s:
            self.full_run_s = self.run_s

    @property
    def duration_s(self) -> float:
        """Dispatch -> arrival (completion, or the preemption strike)."""
        return self.queue_wait_s + self.run_s

    @property
    def fault_free_s(self) -> float:
        """Dispatch -> arrival had the attempt not been preempted."""
        return self.queue_wait_s + self.full_run_s

    @property
    def frac_done(self) -> float:
        """Fraction of the attempt's work completed at the strike."""
        if not self.preempted:
            return 1.0
        return self.run_s / self.full_run_s if self.full_run_s else 0.0


class ExecutionBackend(abc.ABC):
    """Pluggable simulated-execution layer shared by both orchestrators."""

    name: str = "?"
    #: True when spot preemptions are produced by this backend's event
    #: stream — the FaultInjector must then NOT draw its own preempt dice.
    handles_preemption: bool = False

    def bind(self, rng: np.random.Generator, straggler: StragglerPolicy):
        """Attach the orchestrator's RNG + straggler policy.  Called once in
        ``__post_init__``; both backends draw the base work duration from
        this stream so their draws stay aligned."""
        self.rng = rng
        self.straggler = straggler
        return self

    def _work_s(self, client, flops_per_client: float,
                payload_bytes: int) -> float:
        return float(simulate_round_times(
            [client], flops_per_client, payload_bytes, self.rng,
            self.straggler)[0])

    def begin_window(self, n: int):
        """Window hint: the orchestrator expects up to ``n`` dispatches
        before the next commit.  The base behaviour reserves an ``n``-sized
        block on the bound RNG (when it supports block reservation — the
        event-window engine's ``BlockedGenerator``), so all of the window's
        contention-noise draws come from ONE vectorized call.  Backends may
        additionally amortize per-dispatch bookkeeping across the window."""
        r = getattr(self, "rng", None)
        if hasattr(r, "reserve"):
            r.reserve(n)

    @abc.abstractmethod
    def execute(self, client, flops_per_client: float, payload_bytes: int,
                now: float) -> ClientExecution:
        """One async dispatch: simulate a full client attempt starting at
        sim-time ``now``."""

    @abc.abstractmethod
    def resume(self, client, remaining_work_s: float,
               now: float) -> ClientExecution:
        """Re-enqueue only the REMAINING work of a faulted attempt (the
        partial-progress recovery path).  Draws no new work randomness."""

    def execute_round(self, clients: list, flops_per_client: float,
                      payload_bytes: int, now: float) -> list[ClientExecution]:
        """One sync barrier round: all ``clients`` dispatch at ``now``."""
        return [self.execute(c, flops_per_client, payload_bytes, now)
                for c in clients]

    def execute_batch(self, clients: list, flops_per_client: float,
                      payload_bytes: int, now: float) -> list[ClientExecution]:
        """N async dispatches at the same instant (the concurrency top-up of
        the batched mega-fleet engine).  Must consume every RNG stream in
        the same per-client order as N sequential ``execute`` calls — the
        engine-equivalence suite pins batched == per-event bit-identically.
        The base implementation IS the sequential loop; backends override it
        to amortise the per-dispatch overhead."""
        return [self.execute(c, flops_per_client, payload_bytes, now)
                for c in clients]

    def release(self, job_id: str, t: float):
        """The orchestrator observed this attempt's fate at sim-time ``t``
        and is done with it (fault arrivals cancel the backing job)."""

    def end_round(self, t: float):
        """Sync barrier closed at sim-time ``t``: straggler jobs cut off by
        the mitigation are abandoned."""

    # ------------------------------------------------- checkpointable state
    def state(self) -> dict:
        return {}

    def set_state(self, s: dict):
        if s:
            raise ValueError(f"{self.name} backend carries no state but the "
                             f"checkpoint holds {sorted(s)}")


class ClosedFormBackend(ExecutionBackend):
    """The pre-backend behaviour: pure closed-form times, no pool."""

    name = "closed-form"
    handles_preemption = False

    def execute(self, client, flops_per_client, payload_bytes, now):
        w = self._work_s(client, flops_per_client, payload_bytes)
        return ClientExecution(work_s=w, run_s=w, site=client.site)

    def execute_round(self, clients, flops_per_client, payload_bytes, now):
        # one vectorised call for the whole cohort: consumes the RNG exactly
        # as the legacy `simulate_round_times(clients, ...)` did
        times = simulate_round_times(clients, flops_per_client, payload_bytes,
                                     self.rng, self.straggler)
        return [ClientExecution(work_s=float(t), run_s=float(t), site=c.site)
                for c, t in zip(clients, times)]

    def execute_batch(self, clients, flops_per_client, payload_bytes, now):
        # one vectorised draw for the whole batch: `simulate_round_times`
        # draws one lognormal per client in list order, exactly what N
        # sequential execute() calls would have pulled from the stream
        times = simulate_round_times(clients, flops_per_client, payload_bytes,
                                     self.rng, self.straggler)
        return [ClientExecution(work_s=float(t), run_s=float(t), site=c.site)
                for c, t in zip(clients, times)]

    def resume(self, client, remaining_work_s, now):
        return ClientExecution(work_s=remaining_work_s,
                               run_s=remaining_work_s, site=client.site)


class SchedulerBackend(ExecutionBackend):
    """Client attempts become jobs in a simulated SLURM+K8s hybrid pool."""

    name = "scheduler"
    handles_preemption = True

    def __init__(self, hybrid: HybridAdapter | None = None):
        self.hybrid = hybrid or HybridAdapter()
        self._open_round_jobs: list[str] = []
        self._prune_credit = 0

    # ------------------------------------------------------------- dispatch
    def _spec_for(self, client) -> JobSpec:
        return JobSpec(
            name=f"fl-client-{client.cid}",
            command=f"python -m repro_torch.worker --client-id {client.cid}",
            gpus_per_node=1 if client.profile.compute_tflops > 4 else 0,
            mem_gb=int(client.profile.memory_gb),
            site=client.site,
            preemptible=client.profile.spot)

    def begin_window(self, n: int):
        """One terminal-job GC for the whole window instead of one per
        submit.  ``prune_terminal`` only deletes TERMINAL jobs from the
        adapters' tables — it never changes a scheduling decision — so
        deferring it is trajectory-invariant (a mid-window checkpoint may
        carry a few extra terminal jobs; they are pruned on first use)."""
        super().begin_window(n)
        self.hybrid.prune_terminal()
        self._prune_credit = int(n)

    def _submit(self, client, work_s: float, now: float):
        if self._prune_credit > 0:
            self._prune_credit -= 1
        else:
            self.hybrid.prune_terminal()
        self.hybrid.advance_to(now)
        h = self.hybrid.submit(self._spec_for(client), work_s=work_s)
        self.hybrid.advance_to(self.hybrid.clock)   # settle: start if room
        return h

    def _read(self, twin: HybridAdapter, job_id: str, work_s: float,
              submit_t: float) -> ClientExecution:
        adapter = twin._route[job_id]
        h = adapter.jobs[job_id]
        full_run = adapter._runtime_s(h)
        preempted = h.state == JobState.PREEMPTED
        return ClientExecution(
            work_s=work_s,
            run_s=(h.end_time - h.start_time) if preempted else full_run,
            queue_wait_s=h.start_time - submit_t,
            full_run_s=full_run,
            site=twin.site_of(job_id),
            job_id=job_id,
            preempted=preempted,
            overflowed=twin.site_of(job_id) != h.spec.site)

    @staticmethod
    def _step_until(twin: HybridAdapter, job_ids: list[str]):
        """Advance the clone through its exact event times until every
        listed job is terminal."""
        def alive():
            return [j for j in job_ids
                    if twin.poll(j) not in TERMINAL_STATES]
        while alive():
            nxt = twin.next_event_time()
            if nxt is None:
                raise RuntimeError(
                    f"jobs {alive()} can never start: the pool is idle but "
                    f"too small for their node requests")
            twin.advance_to(nxt)

    def _lookahead(self, job_ids: list[str], works: list[float],
                   now: float) -> list[ClientExecution]:
        # the adapters fix all randomness at submit and start strictly FIFO,
        # so this clone's trajectory IS the real pool's future for these jobs
        twin = self.hybrid.clone()
        self._step_until(twin, job_ids)
        return [self._read(twin, jid, w, now)
                for jid, w in zip(job_ids, works)]

    def execute(self, client, flops_per_client, payload_bytes, now):
        w = self._work_s(client, flops_per_client, payload_bytes)
        h = self._submit(client, w, now)
        # queue wait is measured from the DISPATCH instant: if the pool
        # clock had already drifted past `now` the extra lag is queue wait
        return self._lookahead([h.job_id], [w], now)[0]

    def resume(self, client, remaining_work_s, now):
        h = self._submit(client, remaining_work_s, now)
        return self._lookahead([h.job_id], [remaining_work_s], now)[0]

    def execute_batch(self, clients, flops_per_client, payload_bytes, now):
        """N dispatches at ``now`` with ONE pool-clone lookahead.

        Work draws are batched (same per-client stream order as sequential
        execute calls); each job still goes through the exact per-job
        submit+settle sequence, so the adapters' submit-time randomness and
        FIFO start decisions are byte-for-byte those of the per-event loop.
        The lookahead clone is read-only and starts are strictly FIFO with
        all randomness fixed at submit, so reading job i from a twin that
        also carries the later-submitted jobs i+1..N yields the same
        trajectory as N separate single-job lookaheads — that equivalence
        is pinned by the engine-equivalence suite."""
        works = [float(t) for t in simulate_round_times(
            clients, flops_per_client, payload_bytes, self.rng,
            self.straggler)]
        handles = [self._submit(c, w, now) for c, w in zip(clients, works)]
        return self._lookahead([h.job_id for h in handles], works, now)

    def execute_round(self, clients, flops_per_client, payload_bytes, now):
        works = [float(t) for t in simulate_round_times(
            clients, flops_per_client, payload_bytes, self.rng,
            self.straggler)]
        self.hybrid.prune_terminal()
        self.hybrid.advance_to(now)
        handles = [self.hybrid.submit(self._spec_for(c), work_s=w)
                   for c, w in zip(clients, works)]
        self.hybrid.advance_to(self.hybrid.clock)
        self._open_round_jobs = [h.job_id for h in handles]
        return self._lookahead(self._open_round_jobs, works, now)

    # ------------------------------------------------------------- teardown
    def release(self, job_id: str, t: float):
        if not job_id:
            return
        self.hybrid.advance_to(t)
        # the job may have gone terminal on its own (e.g. pool-preempted
        # before an injector fault's strike time) and been pruned since
        if job_id in self.hybrid._route \
                and self.hybrid.poll(job_id) not in TERMINAL_STATES:
            self.hybrid.cancel(job_id)

    def end_round(self, t: float):
        self.hybrid.advance_to(t)
        for jid in self._open_round_jobs:
            if jid in self.hybrid._route \
                    and self.hybrid.poll(jid) not in TERMINAL_STATES:
                self.hybrid.cancel(jid)
        self._open_round_jobs = []

    # ------------------------------------------------- checkpointable state
    def state(self) -> dict:
        return {"hybrid": self.hybrid.state_dict(),
                "config": self.hybrid.config_dict(),
                "open_round_jobs": list(self._open_round_jobs)}

    def set_state(self, s: dict):
        if not s:
            raise ValueError(
                "checkpoint carries no scheduler-backend state; it was "
                "written under --exec-backend closed-form")
        cfg = s.get("config")
        if cfg is not None and cfg != self.hybrid.config_dict():
            raise ValueError(
                f"checkpoint pool config {cfg} != this backend's "
                f"{self.hybrid.config_dict()}; restore requires an "
                f"identically configured pool")
        self.hybrid.load_state(s["hybrid"])
        self._open_round_jobs = list(s.get("open_round_jobs", []))


def make_backend(name: str, hybrid: HybridAdapter | None = None,
                 **hybrid_kw) -> ExecutionBackend:
    """Factory for ``--exec-backend``.  ``hybrid_kw`` (``slurm=``, ``k8s=``,
    ``overflow_to_cloud=``) builds the pool when one isn't passed."""
    if name == "closed-form":
        return ClosedFormBackend()
    if name == "scheduler":
        return SchedulerBackend(hybrid or HybridAdapter(**hybrid_kw))
    raise ValueError(f"unknown execution backend {name!r}; "
                     f"expected one of {BACKEND_NAMES}")
