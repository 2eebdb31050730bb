"""Client registry + resource profiles (paper §4.1 "resource profiling").

A client is one federated participant: an HPC compute node (SLURM-managed,
Infiniband/ICI class links, high reliability) or a cloud VM (gRPC/DCN class
links, possibly a preemptible spot instance).  Profiles are what the
adaptive selection, straggler model and comm accounting consume.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ResourceProfile:
    compute_tflops: float          # effective local-training throughput
    bandwidth_gbps: float          # uplink to orchestrator
    latency_ms: float
    memory_gb: float
    reliability: float = 0.99      # P(finish round | selected)
    spot: bool = False             # preemptible (cloud spot) instance


@dataclass
class ClientInfo:
    cid: int
    site: str                      # "hpc" | "cloud"
    profile: ResourceProfile
    data_size: int = 0
    # rolling history (paper §4.1 "performance history")
    completions: int = 0
    failures: int = 0
    ema_round_time: float = 0.0
    last_selected_round: int = -1

    def record(self, ok: bool, round_time: float, rnd: int, ema: float = 0.3):
        if ok:
            self.completions += 1
            self.ema_round_time = (round_time if self.ema_round_time == 0
                                   else (1 - ema) * self.ema_round_time
                                   + ema * round_time)
        else:
            self.failures += 1
        self.last_selected_round = rnd

    @property
    def success_rate(self) -> float:
        n = self.completions + self.failures
        return self.completions / n if n else 1.0


def make_hybrid_fleet(n_hpc: int = 30, n_cloud: int = 30, seed: int = 0,
                      data_sizes=None) -> list[ClientInfo]:
    """The paper's testbed (§5.1): 30 SLURM nodes (Quadro RTX 6000 class) +
    30 AWS EC2 VMs (mix of p3.2xlarge GPU and t3.large CPU-only)."""
    rng = np.random.default_rng(seed)
    fleet = []
    for i in range(n_hpc):
        gpu = i < int(0.7 * n_hpc)
        prof = ResourceProfile(
            compute_tflops=float(rng.normal(16.3, 1.0)) if gpu
            else float(rng.normal(1.0, 0.1)),          # RTX6000 ~16.3 TF fp32
            bandwidth_gbps=12.5,                        # 100 Gb Infiniband
            latency_ms=0.05,
            memory_gb=24.0 if gpu else 8.0,
            reliability=0.995,
        )
        fleet.append(ClientInfo(len(fleet), "hpc", prof))
    for i in range(n_cloud):
        gpu = i < int(0.5 * n_cloud)
        prof = ResourceProfile(
            compute_tflops=float(rng.normal(15.7, 1.5)) if gpu
            else float(rng.normal(0.4, 0.05)),         # p3.2xlarge V100 / t3.large
            bandwidth_gbps=float(rng.uniform(0.5, 1.25)),
            latency_ms=float(rng.uniform(5, 40)),
            memory_gb=16.0 if gpu else 8.0,
            reliability=0.98,
            spot=bool(rng.random() < 0.4),
        )
        fleet.append(ClientInfo(len(fleet), "cloud", prof))
    if data_sizes is not None:
        for c, s in zip(fleet, data_sizes):
            c.data_size = int(s)
    return fleet
