"""Client selection strategies (paper §4.1 Adaptive Client Selection)."""
from __future__ import annotations

import numpy as np

from repro_torch.orchestrator.registry import ClientInfo


class RandomSelection:
    """Uniform sampling (the FedAvg default; the paper's ablation baseline)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def select(self, fleet: list[ClientInfo], k: int, rnd: int) -> list[int]:
        avail = [c.cid for c in fleet]
        return list(self.rng.choice(avail, min(k, len(avail)), replace=False))


class AdaptiveSelection:
    """Scores clients by resource profile x history, with load balancing and
    a fairness/aging term (so slow-but-unique data still participates).

      score = compute^a * bandwidth^b * success_rate^c * aging
    Load balancing: the slowest `exclude_frac` quantile (by EMA round time)
    is temporarily excluded (paper: "underperforming or slower nodes may be
    temporarily excluded")."""

    def __init__(self, seed: int = 0, exclude_frac: float = 0.2,
                 a: float = 0.5, b: float = 0.3, c: float = 2.0,
                 aging_boost: float = 0.15, softmax_temp: float = 1.0):
        self.rng = np.random.default_rng(seed)
        self.exclude_frac = exclude_frac
        self.a, self.b, self.c = a, b, c
        self.aging_boost = aging_boost
        self.temp = softmax_temp

    def select(self, fleet: list[ClientInfo], k: int, rnd: int) -> list[int]:
        """One vectorised numpy scoring pass over the candidate arrays.

        The original per-client Python loop (a pow/log call per client per
        dispatch) was the profile-confirmed reason the legacy async engine
        died at 10k clients; the field gather stays O(population) but the
        arithmetic is a handful of array ops.  Probabilities are computed
        with the exact expression structure of the scalar loop so the
        rng.choice draw — and therefore every selection trajectory — is
        bitwise unchanged (pinned in tests/test_orchestrator.py)."""
        cands = list(fleet)
        ema = np.fromiter((c.ema_round_time for c in cands), np.float64,
                          len(cands))
        # load balancing: drop the slowest quantile among profiled clients
        timed = ema > 0
        if int(timed.sum()) > 4 and self.exclude_frac:
            cutoff = np.quantile(ema[timed], 1.0 - self.exclude_frac)
            keep = ~(timed & (ema > cutoff))
            if int(keep.sum()) >= k:
                cands = [c for c, m in zip(cands, keep) if m]
        ct = np.fromiter((c.profile.compute_tflops for c in cands),
                         np.float64, len(cands))
        bw = np.fromiter((c.profile.bandwidth_gbps for c in cands),
                         np.float64, len(cands))
        sr = np.fromiter((c.success_rate for c in cands), np.float64,
                         len(cands))
        last = np.fromiter((c.last_selected_round for c in cands),
                           np.float64, len(cands))
        scores = (np.maximum(ct, 1e-3) ** self.a
                  * np.maximum(bw, 1e-3) ** self.b
                  * np.maximum(sr, 0.05) ** self.c)
        scores = scores * (1.0 + self.aging_boost
                           * np.log1p(np.maximum(rnd - last, 0.0)))
        p = np.exp(np.log(scores + 1e-12) / self.temp)
        p /= p.sum()
        pick = self.rng.choice([c.cid for c in cands], min(k, len(cands)),
                               replace=False, p=p)
        return list(pick)


def get_selection(name: str, **kw):
    return {"random": RandomSelection, "adaptive": AdaptiveSelection}[name](**kw)
