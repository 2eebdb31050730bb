"""Synthetic stand-ins for the paper's datasets (offline container).

The paper evaluates the FL *system* (scalability, fault tolerance, comm
volume) on CIFAR-10, Shakespeare (LEAF) and MedMNIST.  We reproduce the
protocol with synthetic datasets of identical shape/cardinality statistics
that are genuinely *learnable* (class-prototype images; n-gram text), so
accuracy/convergence curves are meaningful:

  * cifar10-like : 32x32x3, 10 classes — images are class prototypes +
                   structured noise.
  * medmnist-like: 28x28x1, 9 classes (PathMNIST cardinality), same recipe.
  * shakespeare-like: character stream sampled from a random-but-fixed
                   2nd-order Markov chain over a 128-char alphabet, split
                   into "speaker" shards (LEAF's natural non-IID unit).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    name: str
    x: np.ndarray          # images [N, ...] or token stream [N, S+1]
    y: np.ndarray          # labels [N] (classification) or None-like for LM
    num_classes: int
    kind: str              # image | text


def make_image_dataset(name: str, n: int, shape, num_classes: int,
                       noise: float = 0.35, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (num_classes,) + tuple(shape)).astype(np.float32)
    # low-frequency structure: smooth prototypes along spatial dims
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, axis=1) + np.roll(protos, 1, axis=2)) / 3
    y = rng.integers(0, num_classes, n)
    x = protos[y] + noise * rng.normal(0, 1, (n,) + tuple(shape)).astype(np.float32)
    return Dataset(name, x.astype(np.float32), y.astype(np.int32),
                   num_classes, "image")


def cifar10_like(n: int = 20_000, seed: int = 0,
                 noise: float = 1.7) -> Dataset:
    """Noise calibrated so a small CNN lands mid-80s% — leaving headroom for
    the FedAvg/FedProx gap to be visible (not saturated)."""
    return make_image_dataset("cifar10-like", n, (32, 32, 3), 10,
                              noise=noise, seed=seed)


def medmnist_like(n: int = 12_000, seed: int = 1,
                  noise: float = 1.5) -> Dataset:
    return make_image_dataset("medmnist-like", n, (28, 28, 1), 9,
                              noise=noise, seed=seed)


def shakespeare_like(n_seqs: int = 8_000, seq_len: int = 64, vocab: int = 128,
                     n_speakers: int = 40, seed: int = 2) -> Dataset:
    """First-order Markov text with speaker-biased continuations; y holds
    the speaker id used as the natural non-IID unit (LEAF protocol).  Each
    char admits 4 continuations; speakers prefer one of them 70% of the
    time, so next-char accuracy is learnable to ~0.7 but requires modelling
    both the chain and the (client-specific) speaker style — the non-IID
    difficulty the paper evaluates."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, (vocab, 4))
    speaker_pref = rng.integers(0, 4, n_speakers)
    seqs = np.zeros((n_seqs, seq_len + 1), np.int32)
    speakers = rng.integers(0, n_speakers, n_seqs)
    a = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len + 1):
        col = np.where(rng.random(n_seqs) < 0.7,
                       speaker_pref[speakers],
                       rng.integers(0, 4, n_seqs))
        c = nxt[a, col]
        seqs[:, t] = c
        a = c
    return Dataset("shakespeare-like", seqs, speakers.astype(np.int32),
                   n_speakers, "text")


def lm_token_batch(rng: np.random.Generator, shape, vocab: int):
    """Random token batches for large-arch throughput/dry-run workloads."""
    toks = rng.integers(0, vocab, tuple(shape) + (1,))[..., 0]
    return toks.astype(np.int32)
