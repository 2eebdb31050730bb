"""Scheduler adapter (paper §3.2): one abstraction over SLURM (HPC),
Kubernetes (cloud) and hybrid combinations.

Adapters *generate real artifacts* (sbatch scripts / pod manifests) so the
framework is deployable, and execute them against a simulated backend with a
virtual clock in this offline container (DESIGN.md §2 hardware adaptation).

The simulation is event-exact and replayable: every random draw a job needs
(queue noise, spot-preemption delay) happens at ``submit`` time, terminal
timestamps are the exact deadlines (``start + runtime``) rather than the
clock at which they were observed, and pending jobs start strictly FIFO.  A
job's whole trajectory is therefore fixed the moment it is submitted — which
is what lets the ``SchedulerBackend`` compute arrival times by stepping a
clone, and lets ``state_dict``/``load_state`` checkpoint mid-flight pools
for bit-identical ``--resume``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class JobState(str, Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    PREEMPTED = "PREEMPTED"
    CANCELLED = "CANCELLED"


TERMINAL_STATES = (JobState.COMPLETED, JobState.FAILED, JobState.PREEMPTED,
                   JobState.CANCELLED)


@dataclass
class JobSpec:
    name: str
    command: str
    nodes: int = 1
    gpus_per_node: int = 0
    cpus_per_node: int = 4
    mem_gb: int = 16
    time_limit_s: int = 3600
    site: str = "hpc"              # routing hint for the hybrid adapter
    preemptible: bool = False


@dataclass
class JobHandle:
    job_id: str
    spec: JobSpec
    state: JobState = JobState.PENDING
    submit_time: float = 0.0
    start_time: float = -1.0
    end_time: float = -1.0
    artifact: str = ""             # generated sbatch script / manifest
    work_s: float = 60.0           # workload, attached at submit time


class SchedulerAdapter(abc.ABC):
    """submit/poll/cancel + virtual-clock advance."""

    def __init__(self, seed: int = 0):
        self._next_id = 1
        self.jobs: dict[str, JobHandle] = {}
        self.clock: float = 0.0
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    @abc.abstractmethod
    def render_artifact(self, spec: JobSpec) -> str: ...

    @abc.abstractmethod
    def _try_start(self, handle: JobHandle) -> bool: ...

    @abc.abstractmethod
    def _runtime_s(self, handle: JobHandle) -> float: ...

    def _finish_deadline(self, h: JobHandle) -> tuple[float, JobState]:
        """(exact sim-time the running job leaves the node, terminal state)."""
        return h.start_time + self._runtime_s(h), JobState.COMPLETED

    def _on_submit(self, h: JobHandle):
        """Hook: draw any per-job randomness NOW so replay is order-exact."""

    # ------------------------------------------------------------ public API
    def submit(self, spec: JobSpec, work_s: float | None = None) -> JobHandle:
        h = JobHandle(job_id=f"{self.prefix}{self._next_id}", spec=spec,
                      submit_time=self.clock,
                      artifact=self.render_artifact(spec))
        self._next_id += 1
        if work_s is not None:
            h.work_s = float(work_s)
        self.jobs[h.job_id] = h
        self._on_submit(h)
        return h

    def set_workload(self, job_id: str, seconds: float):
        self.jobs[job_id].work_s = float(seconds)

    def poll(self, job_id: str) -> JobState:
        return self.jobs[job_id].state

    def cancel(self, job_id: str):
        h = self.jobs[job_id]
        if h.state in (JobState.PENDING, JobState.RUNNING):
            h.state = JobState.CANCELLED
            h.end_time = self.clock

    def advance(self, dt: float):
        """Advance the virtual clock; start pending jobs, finish running."""
        self.advance_to(self.clock + dt)

    def advance_to(self, t: float):
        """Advance to absolute sim-time ``t`` (no-op move if in the past),
        stepping through every intermediate job-state transition so PENDING
        jobs start at the exact instant capacity frees — not quantised to
        the destination time.  This is what keeps the real pool's
        trajectory identical to the ``SchedulerBackend`` lookahead clone's
        (and makes queue-wait accounting exact under contention)."""
        while True:
            nxt = self.next_event_time()
            if nxt is None or nxt > t or nxt <= self.clock:
                break
            self.clock = nxt
            self._settle()
        self.clock = max(self.clock, t)
        self._settle()

    def _settle(self):
        for h in self.jobs.values():
            if h.state == JobState.RUNNING:
                self._maybe_finish(h)
        # strict FIFO: a pending job can start only once every job submitted
        # before it has started — later submissions never backfill ahead,
        # which is what makes start times computable at submit time
        for h in self.jobs.values():
            if h.state == JobState.PENDING:
                if self._try_start(h):
                    h.state = JobState.RUNNING
                    h.start_time = self.clock
                    self._maybe_finish(h)
                else:
                    break

    def _maybe_finish(self, h: JobHandle):
        t, state = self._finish_deadline(h)
        if self.clock >= t:
            h.state = state
            h.end_time = t

    def next_event_time(self) -> float | None:
        """Earliest future job-state transition (None when nothing runs)."""
        deadlines = [self._finish_deadline(h)[0] for h in self.jobs.values()
                     if h.state == JobState.RUNNING]
        deadlines = [t for t in deadlines if t > self.clock]
        return min(deadlines) if deadlines else None

    # ---------------------------------------------------------- capacity API
    def running(self) -> list[JobHandle]:
        return [h for h in self.jobs.values() if h.state == JobState.RUNNING]

    def pending(self) -> list[JobHandle]:
        return [h for h in self.jobs.values() if h.state == JobState.PENDING]

    def nodes_in_use(self) -> int:
        return sum(h.spec.nodes for h in self.running())

    def committed_nodes(self) -> int:
        """Nodes claimed by running AND queued work (overflow decisions)."""
        return self.nodes_in_use() + sum(h.spec.nodes for h in self.pending())

    @abc.abstractmethod
    def total_capacity(self) -> int:
        """Node budget this pool can ever offer."""

    def prune_terminal(self) -> int:
        """Drop finished jobs from the active table (they no longer affect
        the simulation); returns how many were pruned."""
        gone = [jid for jid, h in self.jobs.items()
                if h.state in TERMINAL_STATES]
        for jid in gone:
            del self.jobs[jid]
        return len(gone)

    # -------------------------------------------------- checkpointable state
    _SPEC_FIELDS = ("name", "command", "nodes", "gpus_per_node",
                    "cpus_per_node", "mem_gb", "time_limit_s", "site",
                    "preemptible")
    _JOB_FIELDS = ("job_id", "state", "submit_time", "start_time", "end_time",
                   "work_s")

    def state_dict(self) -> dict:
        return {
            "clock": self.clock,
            "next_id": self._next_id,
            "rng": self.rng.bit_generator.state,
            "jobs": [{**{f: getattr(h, f) for f in self._JOB_FIELDS},
                      "state": h.state.value,
                      "spec": {f: getattr(h.spec, f)
                               for f in self._SPEC_FIELDS}}
                     for h in self.jobs.values()],
        }

    def load_state(self, s: dict, render_artifacts: bool = True):
        """``render_artifacts=False`` skips re-rendering sbatch/manifest
        strings — lookahead clones never read them."""
        self.clock = float(s["clock"])
        self._next_id = int(s["next_id"])
        self.rng.bit_generator.state = s["rng"]
        self.jobs = {}
        for j in s["jobs"]:
            spec = JobSpec(**j["spec"])
            h = JobHandle(job_id=j["job_id"], spec=spec,
                          state=JobState(j["state"]),
                          submit_time=j["submit_time"],
                          start_time=j["start_time"], end_time=j["end_time"],
                          artifact=(self.render_artifact(spec)
                                    if render_artifacts else ""),
                          work_s=j["work_s"])
            self.jobs[h.job_id] = h
