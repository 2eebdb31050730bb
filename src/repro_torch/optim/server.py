"""Server-side optimizers applied to the aggregated federated delta,
mirroring ``repro/optim/server.py``.

FedAvg:  M_{r+1} = M_r + eta * Delta            (paper Algorithm 1, line 12)
FedAdam / FedYogi (Reddi et al. 2021): adaptive server updates.
The state of the adaptive two is ``{"m": dict, "v": dict}`` in float32,
the reference's layout (``convert.server_state_from_jax`` copies it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class ServerOptimizer:
    name: str
    init: Callable            # params -> state
    apply: Callable           # (params, delta, state) -> (params, state)


def fedavg_server(lr: float = 1.0) -> ServerOptimizer:
    def init(params):
        return ()

    def apply(params, delta, state):
        return {k: p + lr * delta[k].to(p.dtype) for k, p in params.items()}, \
            state

    return ServerOptimizer("fedavg", init, apply)


def _adaptive(name: str, lr: float, b1: float, b2: float, tau: float):
    def init(params):
        return {
            "m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.full_like(p, tau ** 2, dtype=torch.float32)
                  for k, p in params.items()},
        }

    def apply(params, delta, state):
        d32 = {k: d.to(torch.float32) for k, d in delta.items()}
        m = {k: b1 * m_ + (1 - b1) * d32[k] for k, m_ in state["m"].items()}
        if name == "fedadam":
            v = {k: b2 * v_ + (1 - b2) * d32[k].square()
                 for k, v_ in state["v"].items()}
        else:  # fedyogi
            v = {}
            for k, v_ in state["v"].items():
                d2 = d32[k].square()
                v[k] = v_ - (1 - b2) * d2 * torch.sign(v_ - d2)
        new_p = {k: p + (lr * m[k] / (torch.sqrt(v[k]) + tau)).to(p.dtype)
                 for k, p in params.items()}
        return new_p, {"m": m, "v": v}

    return ServerOptimizer(name, init, apply)


def fedadam_server(lr: float = 0.01, b1: float = 0.9, b2: float = 0.99,
                   tau: float = 1e-3) -> ServerOptimizer:
    return _adaptive("fedadam", lr, b1, b2, tau)


def fedyogi_server(lr: float = 0.01, b1: float = 0.9, b2: float = 0.99,
                   tau: float = 1e-3) -> ServerOptimizer:
    return _adaptive("fedyogi", lr, b1, b2, tau)


def get_server_optimizer(name: str, **kw) -> ServerOptimizer:
    return {"fedavg": fedavg_server, "fedadam": fedadam_server,
            "fedyogi": fedyogi_server}[name](**kw)
