"""Mesh context and sharding helpers, mirroring ``repro/models/sharding.py``.

The model code is written once for three regimes:
  * no mesh                               -> constraints are no-ops
  * single-pod mesh ("data", "model")     -> production single pod
  * multi-pod mesh ("pod", "data", "model")

Logical axes used by the model code:
  BATCH  -> ("pod", "data") when pod present, else ("data",)
  DATA   -> "data"  (FSDP / weight-gather axis)
  MODEL  -> "model" (tensor/expert parallel axis)

The port runs on one card.  Its ``Mesh`` is a record of axis names, sizes
and devices: a ``torch.distributed.device_mesh.DeviceMesh`` needs an
initialised process group, and the production meshes' 256 or 512 devices
do not exist here.  Every pure function of a mesh (``resolve``,
``batch_axes``, ``pspec``, ``axis_size``, ``fusion_axes``,
``flat_shard_index``) reads only ``axis_names`` and ``shape``, as the
reference's do, so they run on any mesh.  ``shard`` is the identity
without a mesh or on a one-device mesh, and raises on a larger one:
execution across devices (process groups, collectives) is ROADMAP's
multi-device item, and nothing is quietly replicated.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

BATCH = "__batch__"   # data-parallel batch axis (pod+data in multi-pod)
DATA = "data"
MODEL = "model"
POD = "pod"

MULTI_DEVICE = ("execution across more than one device (ROADMAP: "
                "multi-device execution) is not ported")


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of names, or None.  A
    tuple, so it compares equal to the reference's ``PartitionSpec`` with
    the same entries; entries are normalised as JAX does (a one-name tuple
    to the name, an empty one to None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


@dataclass(frozen=True)
class Mesh:
    """A device mesh as a record: ``axis_names``, their sizes in
    ``shape`` (name -> size, in axis order, as ``jax.sharding.Mesh.shape``)
    and the row-major device list."""
    axis_names: tuple
    sizes: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} against sizes "
                             f"{self.sizes}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(f"a {self.sizes} mesh needs "
                             f"{math.prod(self.sizes)} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` of this record, where a
        process group of the mesh's size exists."""
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("a DeviceMesh needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        from torch.distributed.device_mesh import init_device_mesh
        kind = str(self.devices[0]).split(":")[0]
        return init_device_mesh(kind, self.sizes, mesh_dim_names=tuple(
            self.axis_names))


_state = threading.local()


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def excluded_axes() -> frozenset:
    return getattr(_state, "exclude", frozenset())


@contextlib.contextmanager
def exclude_axes(*axes: str):
    """Drop the given mesh axes from constraint resolution: used inside a
    vmapped client body, whose mapped dim owns those axes."""
    prev = excluded_axes()
    _state.exclude = prev | set(axes)
    try:
        yield
    finally:
        _state.exclude = prev


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def batch_axes(mesh: Optional[Mesh] = None):
    """Mesh axes that together shard the global batch."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return ()
    axes = (POD, DATA) if POD in mesh.axis_names else (DATA,)
    return tuple(a for a in axes if a not in excluded_axes())


def resolve(spec_entry, mesh):
    """Map a logical axis entry to concrete mesh axes (or None)."""
    excl = excluded_axes()
    if spec_entry is None:
        return None
    if spec_entry == BATCH:
        ax = batch_axes(mesh)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    if isinstance(spec_entry, (tuple, list)):
        kept = tuple(a for a in spec_entry
                     if a in mesh.axis_names and a not in excl)
        return kept if kept else None
    return (spec_entry if spec_entry in mesh.axis_names
            and spec_entry not in excl else None)


def pspec(*logical) -> PartitionSpec:
    mesh = get_mesh()
    if mesh is None:
        return P()
    return P(*(resolve(e, mesh) for e in logical))


def shard(x, *logical):
    """The sharding constraint of ``x`` against the active mesh: the
    identity without a mesh or on one device; a larger mesh raises."""
    mesh = get_mesh()
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError(f"shard{tuple(pspec(*logical))} on a "
                              f"{mesh.shape} mesh: {MULTI_DEVICE}")


def axis_size(name: str) -> int:
    mesh = get_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def fusion_axes() -> tuple:
    """Mesh axes the fused commit's row (block) dim is split over
    (``kernels.ops.shard_rows_reduce``): every active axis of size > 1 that
    ``exclude_axes`` has not dropped.  Empty on one device: the kernels
    run unsharded."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    excl = excluded_axes()
    return tuple(a for a in mesh.axis_names
                 if a not in excl and mesh.shape[a] > 1)


def flat_shard_index(axes: Sequence[str], coords: dict,
                     mesh: Optional[Mesh] = None) -> int:
    """Row-major flat index of the shard at ``coords`` (axis name -> this
    device's index along it) over ``axes``: the reference's
    ``flat_shard_index`` with the device's coordinates given, where the
    reference reads ``lax.axis_index`` inside a shard_map."""
    mesh = mesh or get_mesh()
    flat = 0
    for a in axes:
        flat = flat * mesh.shape[a] + int(coords[a])
    return flat
