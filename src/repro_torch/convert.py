"""Copies between the reference package's numpy views and the port's
tensors.

The port keeps the reference's layouts (conv HWIO, dense ``[in, out]``) and
leaf names, so a conversion is a copy: ``{name: np.ndarray}`` (for example
``{k: np.asarray(v) for k, v in jax_params.items()}``) becomes ``{name:
float32 Tensor}`` on the chosen device, in ``jax.tree`` order, and back.
The same holds for the fedadam/fedyogi server state ``{"m": ..., "v": ...}``.
The LM zoo's params and decode states are nested dicts;
``tree_from_jax``/``tree_to_numpy`` copy those leaf by leaf and keep each
leaf's dtype, and ``tree_from_jax(..., flat=True)`` gives the params' flat
view, the layout the training round takes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pytree import flat_dict, ordered


def params_from_jax(params: dict, device="cpu") -> dict:
    """``{name: array}`` -> ``{name: float32 Tensor on device}``."""
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
            for k in ordered(params)}


def params_to_numpy(params: dict) -> dict:
    """``{name: Tensor}`` -> ``{name: float32 np.ndarray}``."""
    return {k: params[k].detach().to("cpu", torch.float32).numpy()
            for k in ordered(params)}


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


def _leaf_from_jax(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # JAX's bfloat16 reaches numpy as ml_dtypes.bfloat16, which torch
        # does not read: go through float32 (exact) and cast back
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_from_jax(tree, device="cpu", dtype=None, flat: bool = False):
    """A nested dict of arrays -> the same dict of Tensors on ``device``.
    Each leaf keeps its dtype (bfloat16 included); a ``dtype`` casts the
    floating-point leaves to it.  ``flat`` returns the flat view instead:
    ``{"/"-joined leaf path: Tensor}`` in ``jax.tree`` order
    (``repro_torch.pytree.flat_dict``)."""
    out = {k: tree_from_jax(v, device, dtype) if isinstance(v, dict)
           else _leaf_from_jax(v, device, dtype) for k, v in tree.items()}
    return flat_dict(out) if flat else out


def tree_to_numpy(tree):
    """A nested dict of Tensors -> the same dict of numpy arrays, floats as
    float32."""
    def leaf(t):
        t = t.detach().to("cpu")
        return (t.to(torch.float32) if t.is_floating_point() else t).numpy()
    return {k: tree_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}
