"""Kubernetes adapter: renders pod manifests (JSON form of the YAML);
simulates a cluster with autoscaling node groups and spot preemption.

Spot preemption is modelled as a memoryless reclaim: each preemptible pod
draws an exponential time-to-preemption (rate ``preempt_prob_per_min`` per
minute) at SUBMIT time, applied from the moment the pod starts.  In the
small-step limit this is the same process as a per-tick Bernoulli draw, but
the strike time is an exact, replayable event — which is what lets the
``SchedulerBackend`` surface adapter preemptions into the orchestrator's
fault stream and checkpoint mid-flight pools."""
from __future__ import annotations

import json

from repro_torch.sched.adapter import JobHandle, JobSpec, JobState, SchedulerAdapter


def pod_manifest(spec: JobSpec) -> dict:
    res = {"cpu": str(spec.cpus_per_node), "memory": f"{spec.mem_gb}Gi"}
    if spec.gpus_per_node:
        res["nvidia.com/gpu"] = str(spec.gpus_per_node)
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": spec.name,
                     "labels": {"app": "fl-client",
                                "preemptible": str(spec.preemptible).lower()}},
        "spec": {
            "restartPolicy": "OnFailure",
            "containers": [{
                "name": "fl-worker",
                "image": "repro/fl-worker:latest",
                "command": ["/bin/sh", "-c", spec.command],
                "resources": {"requests": res, "limits": res},
            }],
            **({"tolerations": [{"key": "cloud.google.com/gke-spot",
                                 "operator": "Equal", "value": "true",
                                 "effect": "NoSchedule"}]}
               if spec.preemptible else {}),
        },
    }


class K8sAdapter(SchedulerAdapter):
    prefix = "pod-"

    def __init__(self, initial_nodes: int = 10, max_nodes: int = 60,
                 scale_step: int = 5, preempt_prob_per_min: float = 0.0,
                 seed: int = 0):
        super().__init__(seed=seed)
        self.initial_nodes = initial_nodes   # construction-time level (the
        #                                      checkpoint-compat config key)
        self.nodes = initial_nodes           # current autoscaled level
        self.max_nodes = max_nodes
        self.scale_step = scale_step
        self.preempt_prob_per_min = preempt_prob_per_min
        self._preempt_delay: dict[str, float] = {}  # job_id -> s after start

    def render_artifact(self, spec: JobSpec) -> str:
        return json.dumps(pod_manifest(spec), indent=2)

    def _on_submit(self, h: JobHandle):
        if self.preempt_prob_per_min and h.spec.preemptible:
            self._preempt_delay[h.job_id] = float(
                self.rng.exponential(60.0 / self.preempt_prob_per_min))

    def _pods_running(self) -> int:
        return len(self.running())

    def total_capacity(self) -> int:
        return self.max_nodes

    def nodes_in_use(self) -> int:
        return self._pods_running()

    def committed_nodes(self) -> int:
        return self._pods_running() + len(self.pending())

    def _try_start(self, handle: JobHandle) -> bool:
        # autoscale as far as needed (and allowed) in one step, so a start
        # is never delayed purely by scale-step quantisation
        while self._pods_running() >= self.nodes and self.nodes < self.max_nodes:
            self.nodes = min(self.nodes + self.scale_step, self.max_nodes)
        return self._pods_running() < self.nodes

    def _runtime_s(self, handle: JobHandle) -> float:
        return min(handle.work_s, handle.spec.time_limit_s)

    def _finish_deadline(self, h: JobHandle) -> tuple[float, JobState]:
        done = h.start_time + self._runtime_s(h)
        strike = self._preempt_delay.get(h.job_id)
        if strike is not None and h.start_time + strike < done:
            return h.start_time + strike, JobState.PREEMPTED
        return done, JobState.COMPLETED

    def prune_terminal(self) -> int:
        n = super().prune_terminal()
        self._preempt_delay = {jid: v
                               for jid, v in self._preempt_delay.items()
                               if jid in self.jobs}
        return n

    def state_dict(self) -> dict:
        return {**super().state_dict(), "nodes": self.nodes,
                "preempt_delay": self._preempt_delay}

    def load_state(self, s: dict, render_artifacts: bool = True):
        super().load_state(s, render_artifacts)
        self.nodes = int(s.get("nodes", self.nodes))
        self._preempt_delay = {jid: float(v)
                               for jid, v in s.get("preempt_delay",
                                                   {}).items()}
