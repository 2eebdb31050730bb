"""Copies between the reference package's numpy views and the port's
tensors.

The port keeps the reference's layouts (conv HWIO, dense ``[in, out]``) and
leaf names, so a conversion is a copy: ``{name: np.ndarray}`` (for example
``{k: np.asarray(v) for k, v in jax_params.items()}``) becomes ``{name:
float32 Tensor}`` on the chosen device, in sorted-key order, and back.
The same holds for the fedadam/fedyogi server state ``{"m": ..., "v": ...}``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, device="cpu") -> dict:
    """``{name: array}`` -> ``{name: float32 Tensor on device}``."""
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
            for k in sorted(params)}


def params_to_numpy(params: dict) -> dict:
    """``{name: Tensor}`` -> ``{name: float32 np.ndarray}``."""
    return {k: params[k].detach().to("cpu", torch.float32).numpy()
            for k in sorted(params)}


def server_state_from_jax(state, device="cpu"):
    """Server-optimizer state: ``()`` for fedavg, ``{"m", "v"}`` dicts for
    fedadam/fedyogi."""
    if not state:
        return ()
    return {part: params_from_jax(state[part], device) for part in ("m", "v")}


def server_state_to_numpy(state):
    if not state:
        return ()
    return {part: params_to_numpy(state[part]) for part in ("m", "v")}
