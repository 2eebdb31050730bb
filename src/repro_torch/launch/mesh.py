"""Mesh construction, mirroring ``repro/launch/mesh.py``.

Functions, never module-level constants, so importing this module reads no
device state.  Mesh semantics: ``pod`` = site (HPC cluster / cloud
region), ``data`` = federated-client / batch axis inside a site, ``model``
= tensor / expert / sequence parallel axis inside a client.

A mesh here is ``models.sharding.Mesh``, a record of axis names, sizes and
devices.  The production meshes name 256 or 512 placeholder devices
(integers): they size the dry run (``launch/dryrun.py``) and nothing runs
on them.  ``make_test_mesh`` names the card(s) this process sees; on one
card it is 1x1 ("data", "model"), the mesh that ``chip_smoke.py``'s
``mesh`` phase runs under.
"""
from __future__ import annotations

import math

from repro_torch.models.sharding import Mesh


def _mesh(sizes: tuple, axes: tuple, devices=None) -> Mesh:
    n = math.prod(sizes)
    return Mesh(tuple(axes), tuple(sizes),
                tuple(devices) if devices is not None else tuple(range(n)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(n_devices: int | None = None, device: str = "cuda"
                   ) -> Mesh:
    """The reference's small mesh: 2x2x2 from 8 devices, 2x2 from 4, else
    1x1.  ``n_devices`` defaults to the cards this process sees, or one
    device with ``device="cpu"``."""
    n = n_devices
    if n is None:
        import torch
        n = 1 if device == "cpu" else torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("make_test_mesh: no CUDA device (pass "
                           "device='cpu' for a CPU mesh)")
    if n >= 8:
        sizes, axes = (2, 2, 2), ("pod", "data", "model")
    elif n >= 4:
        sizes, axes = (2, 2), ("data", "model")
    else:
        sizes, axes = (1, 1), ("data", "model")
    return _mesh(sizes, axes, [f"{device}:{i}"
                               for i in range(math.prod(sizes))])
