"""Hybrid adapter: routes jobs across SLURM (HPC) + K8s (cloud) and provides
the elastic mixed-infrastructure coordination of paper §3.2."""
from __future__ import annotations

from repro_torch.sched.adapter import JobHandle, JobSpec, JobState, SchedulerAdapter
from repro_torch.sched.k8s import K8sAdapter
from repro_torch.sched.slurm import SlurmAdapter


class HybridAdapter:
    """Not a SchedulerAdapter subclass — it owns one adapter per site and
    presents the same submit/poll/cancel/advance surface."""

    def __init__(self, slurm: SlurmAdapter | None = None,
                 k8s: K8sAdapter | None = None,
                 overflow_to_cloud: bool = True):
        self.slurm = slurm or SlurmAdapter()
        self.k8s = k8s or K8sAdapter()
        self.overflow_to_cloud = overflow_to_cloud
        self._route: dict[str, SchedulerAdapter] = {}

    @property
    def clock(self) -> float:
        return max(self.slurm.clock, self.k8s.clock)

    def site_of(self, job_id: str) -> str:
        """Site the job was actually PLACED on (after elastic overflow)."""
        return "hpc" if self._route[job_id] is self.slurm else "cloud"

    def submit(self, spec: JobSpec, work_s: float | None = None) -> JobHandle:
        target = self.slurm if spec.site == "hpc" else self.k8s
        # elastic overflow: if the HPC partition cannot absorb the job —
        # counting queued work, not just running jobs — burst to cloud
        if (target is self.slurm and self.overflow_to_cloud
                and self.slurm.committed_nodes() + spec.nodes
                > self.slurm.total_capacity()):
            target = self.k8s
        h = target.submit(spec, work_s=work_s)
        self._route[h.job_id] = target
        return h

    def set_workload(self, job_id: str, seconds: float):
        self._route[job_id].set_workload(job_id, seconds)

    def poll(self, job_id: str) -> JobState:
        return self._route[job_id].poll(job_id)

    def cancel(self, job_id: str):
        self._route[job_id].cancel(job_id)

    def advance(self, dt: float):
        self.advance_to(self.clock + dt)

    def advance_to(self, t: float):
        self.slurm.advance_to(t)
        self.k8s.advance_to(t)

    def next_event_time(self) -> float | None:
        ts = [t for t in (self.slurm.next_event_time(),
                          self.k8s.next_event_time()) if t is not None]
        return min(ts) if ts else None

    def running(self):
        return self.slurm.running() + self.k8s.running()

    def prune_terminal(self) -> int:
        n = self.slurm.prune_terminal() + self.k8s.prune_terminal()
        live = set(self.slurm.jobs) | set(self.k8s.jobs)
        self._route = {jid: a for jid, a in self._route.items()
                       if jid in live}
        return n

    # -------------------------------------------------- checkpointable state
    def state_dict(self) -> dict:
        return {"slurm": self.slurm.state_dict(),
                "k8s": self.k8s.state_dict(),
                "route": {jid: ("hpc" if a is self.slurm else "cloud")
                          for jid, a in self._route.items()}}

    def load_state(self, s: dict, render_artifacts: bool = True):
        self.slurm.load_state(s["slurm"], render_artifacts)
        self.k8s.load_state(s["k8s"], render_artifacts)
        self._route = {jid: (self.slurm if site == "hpc" else self.k8s)
                       for jid, site in s["route"].items()}

    def config_dict(self) -> dict:
        """Constructor arguments that rebuild an identically-shaped pool —
        the SchedulerBackend's clone()/checkpoint-compat key."""
        return {
            "slurm": {"total_nodes": self.slurm.total_nodes,
                      "speed_tflops": self.slurm.speed_tflops,
                      "queue_noise": self.slurm.queue_noise,
                      "seed": self.slurm.seed},
            "k8s": {"initial_nodes": self.k8s.initial_nodes,
                    "max_nodes": self.k8s.max_nodes,
                    "scale_step": self.k8s.scale_step,
                    "preempt_prob_per_min": self.k8s.preempt_prob_per_min,
                    "seed": self.k8s.seed},
            "overflow_to_cloud": self.overflow_to_cloud,
        }

    def clone(self) -> "HybridAdapter":
        cfg = self.config_dict()
        twin = HybridAdapter(slurm=SlurmAdapter(**cfg["slurm"]),
                             k8s=K8sAdapter(**cfg["k8s"]),
                             overflow_to_cloud=cfg["overflow_to_cloud"])
        twin.load_state(self.state_dict(), render_artifacts=False)
        return twin
