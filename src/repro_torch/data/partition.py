"""Non-IID partitioners (paper §5.2: "Each client receives samples from only
2-3 classes"; plus Dirichlet and quantity skew used in the ablations)."""
from __future__ import annotations

import numpy as np


def partition_by_class(y: np.ndarray, n_clients: int, classes_per_client: int = 2,
                       seed: int = 0) -> list[np.ndarray]:
    """LEAF/McMahan-style pathological non-IID: sort by label, deal shards."""
    rng = np.random.default_rng(seed)
    n_shards = n_clients * classes_per_client
    order = np.argsort(y, kind="stable")
    shards = np.array_split(order, n_shards)
    shard_ids = rng.permutation(n_shards)
    out = []
    for c in range(n_clients):
        take = shard_ids[c * classes_per_client:(c + 1) * classes_per_client]
        out.append(np.concatenate([shards[s] for s in take]))
    return out


def partition_dirichlet(y: np.ndarray, n_clients: int, alpha: float = 0.3,
                        seed: int = 0, min_size: int = 8) -> list[np.ndarray]:
    """Label-Dirichlet partition (Hsu et al.): smaller alpha -> more skew."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    while True:
        idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in classes:
            idx = np.where(y == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx, cuts)):
                idx_per_client[cid].extend(part.tolist())
        sizes = [len(i) for i in idx_per_client]
        if min(sizes) >= min_size:
            return [np.array(sorted(i)) for i in idx_per_client]


def partition_by_group(groups: np.ndarray, n_clients: int,
                       seed: int = 0) -> list[np.ndarray]:
    """Natural non-IID: whole groups (e.g. Shakespeare speakers) per client."""
    rng = np.random.default_rng(seed)
    uniq = rng.permutation(np.unique(groups))
    buckets = np.array_split(uniq, n_clients)
    return [np.where(np.isin(groups, b))[0] for b in buckets]


def partition_quantity_skew(n: int, n_clients: int, alpha: float = 2.0,
                            seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(np.full(n_clients, alpha))
    order = rng.permutation(n)
    cuts = (np.cumsum(props) * n).astype(int)[:-1]
    return list(np.split(order, cuts))
