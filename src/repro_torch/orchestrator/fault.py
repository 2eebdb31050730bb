"""Fault injection (paper §5.3/§5.4: dropouts, spot preemption, partitions).

Synchronous path: faults zero a client's mask entry for the round; the round
step's mask-normalised aggregation (partial aggregation) makes the system
tolerate them — the property Table "Straggler Resilience" measures (20%
dropout -> <1.8% accuracy loss).

Asynchronous path: faults are *typed events with a strike time*.
``draw_fault`` attributes each failure to a cause — plain ``dropout``
(client gone for the attempt), ``preempt`` (spot instance reclaimed
mid-training) or ``partition`` (whole site unreachable) — plus the fraction
of the attempt completed when the fault strikes.  Transient infrastructure
faults (preempt/partition) are recoverable under ``recovery_policy``:

  restart — the client retries the assignment from local step 0 against the
            CURRENT global params (fresh downlink, staleness resets),
  resume  — the client checkpointed locally at its last completed local step
            and re-enqueues with only the remaining work (paper §5.4
            partial-progress recovery; staleness keeps accruing from the
            original dispatch),
  discard — the attempt's work is lost and the slot is freed (the pre-PR-3
            behaviour),
  adaptive — choose restart/resume/discard PER FAULT online from the
            update's observed staleness and remaining work (discard when the
            recovered update would exceed max_staleness anyway); the chosen
            action is logged in ``CommitLog.recovery_actions``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.orchestrator.registry import ClientInfo

RECOVERABLE_FAULTS = ("preempt", "partition")
RECOVERY_POLICIES = ("restart", "resume", "discard", "adaptive")


def equivalent_preempt_rate_per_min(p_attempt: float,
                                    mean_attempt_s: float) -> float:
    """Map ``FaultConfig.spot_preempt_prob`` (per-ATTEMPT Bernoulli) onto the
    memoryless reclaim rate (per minute) of ``K8sAdapter.preempt_prob_per_min``.

    The K8s adapter reclaims a preemptible pod at an exponential
    time-to-preemption with rate ``lam`` per minute, so an attempt holding
    its node for ``d`` seconds is struck with probability
    ``1 - exp(-lam * d / 60)``.  Equating that to the injector's per-attempt
    ``p`` at the fleet's mean attempt duration gives

        lam = -ln(1 - p) * 60 / mean_attempt_s

    which lets ``--exec-backend scheduler`` reproduce injector-era fault
    tables from the same ``--spot-preempt-prob`` knob instead of demanding a
    hand-retuned ``--spot-preempt-per-min``.  Use
    ``straggler.expected_attempt_s`` for ``mean_attempt_s``."""
    if p_attempt <= 0.0:
        return 0.0
    if p_attempt >= 1.0:
        raise ValueError(
            f"spot_preempt_prob must be < 1 to map onto a finite reclaim "
            f"rate, got {p_attempt}")
    if mean_attempt_s <= 0.0:
        raise ValueError(
            f"mean_attempt_s must be positive, got {mean_attempt_s}")
    return float(-np.log1p(-p_attempt) * 60.0 / mean_attempt_s)


@dataclass
class FaultConfig:
    dropout_prob: float = 0.0       # uniform per-round client dropout
    spot_preempt_prob: float = 0.0  # extra dropout for spot instances
    partition_prob: float = 0.0     # whole-site network partition
    partition_len: int = 2          # rounds a partition lasts
    recovery_policy: str = "restart"   # restart|resume|discard|adaptive (async)
    recovery_overhead_s: float = 0.0   # restart/reschedule delay per retry
    max_retries: int = 2               # recovery attempts before giving up

    def __post_init__(self):
        if self.recovery_policy not in RECOVERY_POLICIES:
            raise ValueError(
                f"recovery_policy must be one of {RECOVERY_POLICIES}, got "
                f"{self.recovery_policy!r}")
        if self.max_retries < 0 or self.recovery_overhead_s < 0:
            raise ValueError("max_retries and recovery_overhead_s must be "
                             "non-negative")


class FaultInjector:
    def __init__(self, cfg: FaultConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self._partitioned_site: str | None = None
        self._partition_left = 0

    # ------------------------------------------------- checkpointable state
    def state(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "partitioned_site": self._partitioned_site,
                "partition_left": self._partition_left}

    def set_state(self, s: dict):
        self.rng.bit_generator.state = s["rng"]
        self._partitioned_site = s["partitioned_site"]
        self._partition_left = int(s["partition_left"])

    def step_round(self):
        if self._partition_left > 0:
            self._partition_left -= 1
            if self._partition_left == 0:
                self._partitioned_site = None
        elif self.cfg.partition_prob and self.rng.random() < self.cfg.partition_prob:
            self._partitioned_site = "cloud" if self.rng.random() < 0.5 else "hpc"
            self._partition_left = self.cfg.partition_len

    def draw_fault(self, c: ClientInfo,
                   include_preempt: bool = True) -> tuple[bool, str, float]:
        """One attempt's fate: ``(failed, kind, frac_completed_at_strike)``.

        Same total failure probability as one ``survive_mask`` entry —
        dropout folds in (1 - reliability), spot instances additionally risk
        preemption — but the cause is attributed and a strike time drawn so
        the async event stream reflects WHEN the fault lands, not just that
        the attempt was doomed at dispatch.

        ``include_preempt=False`` removes the spot-preemption component:
        used when the execution backend's OWN event stream produces
        preemptions (``SchedulerBackend.handles_preemption``), so the same
        spot instance is not reclaimed by two independent processes."""
        if self._partitioned_site and c.site == self._partitioned_site:
            return True, "partition", float(self.rng.uniform(0.05, 0.95))
        p_drop = 1 - (1 - self.cfg.dropout_prob) * c.profile.reliability
        p_pre = (self.cfg.spot_preempt_prob
                 if c.profile.spot and include_preempt else 0.0)
        u = self.rng.random()
        if u >= 1 - (1 - p_drop) * (1 - p_pre):
            return False, "", 1.0
        kind = "preempt" if (p_pre and u < p_pre) else "dropout"
        return True, kind, float(self.rng.uniform(0.05, 0.95))

    def survive_mask(self, clients: list[ClientInfo],
                     include_preempt: bool = True) -> np.ndarray:
        mask = np.ones(len(clients))
        for i, c in enumerate(clients):
            p = self.cfg.dropout_prob
            if c.profile.spot and include_preempt:
                p = 1 - (1 - p) * (1 - self.cfg.spot_preempt_prob)
            p = 1 - (1 - p) * c.profile.reliability
            if self.rng.random() < p:
                mask[i] = 0.0
            if self._partitioned_site and c.site == self._partitioned_site:
                mask[i] = 0.0
        return mask
