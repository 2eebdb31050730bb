"""Mesh construction, mirroring ``repro/launch/mesh.py``.

Functions, never module-level constants, so importing this module reads no
device state.  Mesh semantics: ``pod`` = site (HPC cluster / cloud
region), ``data`` = federated-client / batch axis inside a site, ``model``
= tensor / expert / sequence parallel axis inside a client.

A mesh here is ``models.sharding.Mesh``.  The production meshes name 256
or 512 placeholder devices (integers): they size the dry run
(``launch/dryrun.py``) and nothing runs on them.  ``make_test_mesh`` names
the card(s) this process sees; on one card it is 1x1 ("data", "model").
``init_mesh`` makes a mesh of processes, one a device: it initialises the
``torch.distributed`` process group, then one sub-group for every set of
axes of size > 1, and returns the mesh with this process's rank (its
coordinates follow, row-major).  ``launch/spmd.py`` starts such processes.
``dry_mesh`` is the same mesh as one rank sees it with no processes: its
groups are placeholders on which the collectives take ``meta`` tensors
and move nothing (the dry run counts a rank's collectives on it).

Devices and backends are explicit, and nothing falls back: a rank's device
is ``cuda:{rank % device_count}`` unless the caller asks for the CPU; the
backend is ``nccl`` where every rank has a card of its own and ``gloo``
where ranks share a card or run on the CPU (NCCL refuses two ranks on one
card), unless the caller names one.  Every process group has a timeout, so
a lost rank fails the others instead of hanging them.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math

from repro_torch.models.sharding import DryGroup, Mesh, group_members

GROUP_TIMEOUT_S = 180.0
FEDERATED_AXES = ("pod", "data", "model")


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


def rank_devices(world_size: int, device: str = "cuda") -> list:
    """Each rank's device: ``cuda:{rank % device_count}``, or the CPU."""
    if device == "cpu":
        return ["cpu"] * world_size
    import torch
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device: pass device='cpu' for ranks on "
                           "the CPU")
    return [f"cuda:{r % n}" for r in range(world_size)]


def default_backend(world_size: int, device: str = "cuda") -> str:
    """``nccl`` where each of ``world_size`` ranks has a card of its own,
    else ``gloo`` (ranks on the CPU, or sharing a card)."""
    if device == "cpu":
        return "gloo"
    import torch
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def init_mesh(init_method: str, rank: int, world_size: int,
              sizes: tuple = (2, 2, 1), axes: tuple = FEDERATED_AXES,
              backend: str | None = None, device: str = "cuda",
              timeout_s: float = GROUP_TIMEOUT_S) -> Mesh:
    """Initialise the process group of this process (``rank`` of
    ``world_size``, rendezvous at ``init_method``: ``tcp://127.0.0.1:PORT``
    or ``file://PATH``) and return its mesh of ``sizes`` over ``axes``,
    with one sub-group per set of axes of size > 1.  Every process of the
    group must call this with the same arguments but its rank."""
    import torch
    import torch.distributed as dist
    if math.prod(sizes) != world_size:
        raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} ranks, "
                         f"got world_size {world_size}")
    devices = rank_devices(world_size, device)
    backend = backend or default_backend(world_size, device)
    if devices[rank].startswith("cuda"):
        torch.cuda.set_device(torch.device(devices[rank]))
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=timeout,
        device_id=torch.device(devices[rank]) if backend == "nccl" else None)
    coords = [Mesh(tuple(axes), tuple(sizes), tuple(devices), rank=r).coords
              for r in range(world_size)]
    shape = dict(zip(axes, sizes))
    live = [a for a in axes if shape[a] > 1]
    groups = {}
    # every process creates every group, in the same order, as new_group
    # requires; a group holds the ranks that share all other coordinates
    for n in range(1, len(live) + 1):
        for span in itertools.combinations(live, n):
            rest = [a for a in axes if a not in span]
            for fixed in itertools.product(*(range(shape[a]) for a in rest)):
                members = [r for r in range(world_size)
                           if all(coords[r][a] == v
                                  for a, v in zip(rest, fixed))]
                g = dist.new_group(members, timeout=timeout,
                                   backend=backend)
                if rank in members:
                    groups[span] = g
    return Mesh(tuple(axes), tuple(sizes), tuple(devices), rank=rank,
                groups=groups)


def dry_mesh(sizes: tuple, axes: tuple = FEDERATED_AXES, rank: int = 0
             ) -> Mesh:
    """The mesh of ``sizes`` over ``axes`` as process ``rank`` of it sees
    it, with no processes: one placeholder group (``sharding.DryGroup``,
    its members the ranks ``init_mesh`` would put in it) per set of axes
    of size > 1.  The collectives on it take ``meta`` tensors and move
    nothing, so a step run on it under ``sharding.count_collectives``
    counts the bytes the rank's collectives would move (the dry run's
    ``collective_bytes``)."""
    mesh = dataclasses.replace(_mesh(sizes, axes), rank=rank)
    live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    return dataclasses.replace(mesh, groups={
        span: DryGroup(group_members(mesh, span))
        for n in range(1, len(live) + 1)
        for span in itertools.combinations(live, n)})


def close_mesh() -> None:
    """Destroy this process's process group, if one is up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
