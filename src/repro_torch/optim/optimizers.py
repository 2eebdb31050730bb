"""Client-side optimizers over ``dict[str, Tensor]`` params, mirroring
``repro/optim/optimizers.py``.

An Optimizer is a pair of pure functions (they return new tensors and
never update in place, so they run under ``torch.func.vmap`` and ``grad``):
    init(params)                     -> opt_state
    update(grads, state, params, lr) -> (new_params, new_state)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return {k: p - lr * grads[k].to(p.dtype) for k, p in params.items()}, \
            state

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, state, params, lr):
        new_m = {k: beta * m + grads[k].to(m.dtype) for k, m in state.items()}
        return {k: p - lr * new_m[k] for k, p in params.items()}, new_m

    return Optimizer("momentum", init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {
            "m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "t": 0,
        }

    def update(grads, state, params, lr):
        t = state["t"] + 1
        g32 = {k: g.to(torch.float32) for k, g in grads.items()}
        m = {k: b1 * m_ + (1 - b1) * g32[k] for k, m_ in state["m"].items()}
        v = {k: b2 * v_ + (1 - b2) * g32[k].square()
             for k, v_ in state["v"].items()}
        # bias corrections in float32, as the reference computes them
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        new_p = {k: p - (lr * (m[k] / bc1.to(p.device))
                         / (torch.sqrt(v[k] / bc2.to(p.device)) + eps)
                         ).to(p.dtype)
                 for k, p in params.items()}
        return new_p, {"m": m, "v": v, "t": t}

    return Optimizer("adam", init, update)


def get_client_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name](**kw)
