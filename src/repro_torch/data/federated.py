"""Federated dataset: per-client data shards + round-batch sampling.

The jit'd round step consumes stacked client batches [C, H, b, ...]; this
module owns the host-side sampling that produces them, keeping raw data
"local" to each client shard (the privacy boundary of the paper: only model
updates cross client boundaries — batches never leave this object except to
the local-train step of the owning client)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.synthetic import Dataset


@dataclass
class FederatedDataset:
    data: Dataset
    client_indices: list[np.ndarray]
    seed: int = 0
    _rngs: list = field(default_factory=list)

    def __post_init__(self):
        self._rngs = [np.random.default_rng(self.seed + 31 * c)
                      for c in range(self.num_clients)]

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def _indices(self, c: int) -> np.ndarray:
        """The data shard client ``c`` owns (overridden by the virtual
        mega-fleet dataset, which maps many clients onto few shards)."""
        return self.client_indices[c]

    def _rng_for(self, c: int) -> np.random.Generator:
        return self._rngs[c]

    def client_size(self, c: int) -> int:
        return len(self._indices(c))

    @property
    def sizes(self) -> np.ndarray:
        return np.array([self.client_size(c) for c in range(self.num_clients)],
                        np.float32)

    def sample_round(self, client_ids: list[int], local_steps: int,
                     batch_size: int) -> dict:
        """Stacked batches for the round: leaves [C, H, b, ...]."""
        xs, ys = [], []
        for c in client_ids:
            idx = self._indices(c)
            take = self._rng_for(c).choice(
                idx, (local_steps, batch_size),
                replace=len(idx) < local_steps * batch_size)
            xs.append(self.data.x[take])
            ys.append(self.data.y[take] if self.data.y is not None else None)
        x = np.stack(xs)
        if self.data.kind == "text":
            return {"tokens": x[..., :-1].astype(np.int32),
                    "targets": x[..., 1:].astype(np.int32)}
        return {"image": x.astype(np.float32),
                "label": np.stack(ys).astype(np.int32)}

    def eval_batch(self, n: int = 2048, seed: int = 123) -> dict:
        """Centralised held-out evaluation batch (paper §5.3 'Model Accuracy:
        test accuracy on a centralized evaluation dataset')."""
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(self.data.x), n, replace=False)
        x = self.data.x[idx]
        if self.data.kind == "text":
            return {"tokens": x[..., :-1].astype(np.int32),
                    "targets": x[..., 1:].astype(np.int32)}
        return {"image": x.astype(np.float32),
                "label": self.data.y[idx].astype(np.int32)}


@dataclass
class VirtualFederatedDataset(FederatedDataset):
    """A mega-fleet view over a small set of base shards.

    ``n_virtual`` clients share ``len(client_indices)`` underlying data
    shards (client ``c`` samples from shard ``c % n_shards``), and the
    per-client sampling generators are materialized LAZILY — only clients
    that actually dispatch ever own a Generator, so a 100k-client fleet
    costs memory proportional to the in-flight set, not the population.
    Each lazy generator is seeded ``seed + 31 * c`` exactly like the eager
    list, so a virtual client's batch stream is identical to what a fully
    materialized dataset would have produced."""

    n_virtual: int = 0

    def __post_init__(self):
        if self.n_virtual < 1:
            raise ValueError(
                f"n_virtual must be >= 1, got {self.n_virtual}")
        self._rngs = {}                       # lazy: cid -> Generator

    @property
    def num_clients(self) -> int:
        return self.n_virtual

    def _indices(self, c: int) -> np.ndarray:
        return self.client_indices[c % len(self.client_indices)]

    def _rng_for(self, c: int) -> np.random.Generator:
        g = self._rngs.get(c)
        if g is None:
            g = self._rngs[c] = np.random.default_rng(self.seed + 31 * c)
        return g

    # ---------------------------------------------- checkpointable rng state
    def rng_states(self) -> dict:
        """Only the touched generators — the untouched ones are recomputable
        from the seed, so the checkpoint stays O(clients ever dispatched)."""
        return {str(c): g.bit_generator.state for c, g in self._rngs.items()}

    def load_rng_states(self, states: dict):
        self._rngs = {}
        for c, s in states.items():
            g = np.random.default_rng(self.seed + 31 * int(c))
            g.bit_generator.state = s
            self._rngs[int(c)] = g
