"""Straggler model + mitigation (paper §4.2).

``simulate_round_times`` produces each selected client's wall time for one
round from its resource profile (compute + transfer + queueing noise); the
two mitigations turn those times into a participation mask + round duration:

  * deadline cutoff: clients missing the budget are skipped this round,
  * partial (fastest-k) aggregation: stop once k updates have arrived.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.orchestrator.registry import ClientInfo


@dataclass
class StragglerPolicy:
    deadline_s: float = 0.0       # 0 -> no deadline
    fastest_k: int = 0            # 0 -> wait for all
    contention_sigma: float = 0.25  # lognormal compute-noise (shared nodes)


def attempt_time(profile, flops_per_client: float, payload_bytes: int,
                 noise: float) -> float:
    """One attempt's wall time given an already-drawn contention noise.

    Factored out of ``simulate_round_times`` so callers that SHARE a noise
    draw across identically-profiled clients (the cohort-level mega-fleet
    model) price an attempt with the exact same arithmetic."""
    compute = flops_per_client / (profile.compute_tflops * 1e12) * noise
    transfer = (2 * payload_bytes) / (profile.bandwidth_gbps * 1e9 / 8)
    return float(compute + transfer + 2 * profile.latency_ms * 1e-3)


def expected_attempt_s(clients: list[ClientInfo], flops_per_client: float,
                       payload_bytes: int, policy: StragglerPolicy) -> float:
    """Fleet-mean closed-form attempt duration, in expectation over the
    contention noise: E[lognormal(0, sigma)] = exp(sigma^2 / 2).  This is
    the duration scale that converts the injector's per-ATTEMPT fault
    probabilities into per-minute rates (fault.equivalent_preempt_rate_per_min)."""
    noise = float(np.exp(policy.contention_sigma ** 2 / 2.0))
    return float(np.mean([attempt_time(c.profile, flops_per_client,
                                       payload_bytes, noise)
                          for c in clients]))


def simulate_round_times(clients: list[ClientInfo], flops_per_client: float,
                         payload_bytes: int, rng: np.random.Generator,
                         policy: StragglerPolicy) -> np.ndarray:
    times = [attempt_time(c.profile, flops_per_client, payload_bytes,
                          rng.lognormal(0.0, policy.contention_sigma))
             for c in clients]
    return np.asarray(times)


def apply_mitigation(times: np.ndarray, policy: StragglerPolicy):
    """Returns (mask [C] float, round_duration_s)."""
    mask = np.ones_like(times)
    duration = times.max() if len(times) else 0.0
    if policy.fastest_k and policy.fastest_k < len(times):
        # exactly-k semantics: a `times <= kth` threshold admits every
        # client tied at the k-th time, so ties could over-fill the round.
        # Stable argsort keeps exactly k, breaking ties by client position.
        k = policy.fastest_k
        fastest = np.argsort(times, kind="stable")[:k]
        mask = np.zeros_like(times)
        mask[fastest] = 1.0
        duration = times[fastest].max()
    if policy.deadline_s:
        dl_mask = (times <= policy.deadline_s).astype(np.float64)
        mask = mask * dl_mask
        duration = min(duration, policy.deadline_s)
    return mask, float(duration)
