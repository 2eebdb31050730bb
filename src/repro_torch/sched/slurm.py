"""SLURM adapter: renders real sbatch scripts; simulates a partition with a
fixed node pool and a strict-FIFO start policy.

Queue noise (shared-filesystem / co-tenant jitter) is a single lognormal
factor drawn per job at submit time — not re-drawn every clock tick — so a
job's runtime is fixed the moment it is submitted and replays identically
from a checkpoint."""
from __future__ import annotations

from repro_torch.sched.adapter import JobHandle, JobSpec, SchedulerAdapter

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={cpus}
#SBATCH --mem={mem}G
{gpu_line}#SBATCH --time={time_min}
#SBATCH --output=logs/%x-%j.out

srun {command}
"""


class SlurmAdapter(SchedulerAdapter):
    prefix = "slurm-"

    def __init__(self, total_nodes: int = 30, speed_tflops: float = 16.0,
                 queue_noise: float = 0.0, seed: int = 0):
        super().__init__(seed=seed)
        self.total_nodes = total_nodes
        self.speed_tflops = speed_tflops
        self.queue_noise = queue_noise
        self._noise: dict[str, float] = {}    # job_id -> runtime multiplier

    def render_artifact(self, spec: JobSpec) -> str:
        gpu_line = (f"#SBATCH --gres=gpu:{spec.gpus_per_node}\n"
                    if spec.gpus_per_node else "")
        return SBATCH_TEMPLATE.format(
            name=spec.name, nodes=spec.nodes, cpus=spec.cpus_per_node,
            mem=spec.mem_gb, gpu_line=gpu_line,
            time_min=max(1, spec.time_limit_s // 60), command=spec.command)

    def _on_submit(self, h: JobHandle):
        if self.queue_noise:
            self._noise[h.job_id] = float(
                self.rng.lognormal(0, self.queue_noise))

    def total_capacity(self) -> int:
        return self.total_nodes

    def _try_start(self, handle: JobHandle) -> bool:
        return self.nodes_in_use() + handle.spec.nodes <= self.total_nodes

    def _runtime_s(self, handle: JobHandle) -> float:
        noise = self._noise.get(handle.job_id, 1.0)
        return min(handle.work_s * noise, handle.spec.time_limit_s)

    def prune_terminal(self) -> int:
        n = super().prune_terminal()
        self._noise = {jid: v for jid, v in self._noise.items()
                       if jid in self.jobs}
        return n

    def state_dict(self) -> dict:
        return {**super().state_dict(), "noise": self._noise}

    def load_state(self, s: dict, render_artifacts: bool = True):
        super().load_state(s, render_artifacts)
        self._noise = {jid: float(v)
                       for jid, v in s.get("noise", {}).items()}
