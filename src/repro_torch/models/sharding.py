"""Mesh context, sharding helpers and collectives over named mesh axes,
mirroring ``repro/models/sharding.py``.

The model code is written once for three regimes:
  * no mesh                               -> constraints are no-ops
  * single-pod mesh ("data", "model")     -> production single pod
  * multi-pod mesh ("pod", "data", "model")

Logical axes used by the model code:
  BATCH  -> ("pod", "data") when pod present, else ("data",)
  DATA   -> "data"  (FSDP / weight-gather axis)
  MODEL  -> "model" (tensor/expert parallel axis)

A ``Mesh`` is a record of axis names, sizes and devices.  Every pure
function of a mesh (``resolve``, ``batch_axes``, ``pspec``, ``axis_size``,
``fusion_axes``, ``flat_shard_index``) reads only ``axis_names`` and
``shape``, as the reference's do, so they run on any mesh: the production
meshes' 256 or 512 devices are placeholders that size the dry run.  A mesh
that ``launch.mesh.init_mesh`` built also carries this process's ``rank``
(one process per device, row-major over the axes), its ``coords`` and one
``torch.distributed`` process group per set of axes of size > 1; the
collectives below (``psum``, ``pmean``, ``all_gather``, ``all_to_all``,
named after the reference's lax ops) run over those groups.

SPMD convention (the reference's semantics without GSPMD).  Each rank runs
the same program.  Inside a client's computation a tensor is the rank's
local share along the batch axes that ``exclude_axes`` has not dropped
(``batch_split_axes``).  A parameter (and its optimizer and server state)
is held at rest as ``launch.specs.shard_params`` cuts it: its contiguous
share along the dim whose sanitised spec names ``model`` and along the one
that names ``data`` (``model_split`` and ``data_split`` decide, as
``sanitize_entry`` does: a dim the axis does not divide stays whole),
whole along ``pod``.  Activations are whole along ``model``, the same bits
on every rank of a ``model`` group, except where a layer splits them
explicitly: tensor, expert and head parallelism run through the conjugate
collectives below (``copy_to_model``, ``reduce_from_model``,
``gather_from_model``, ``scatter_to_model``, ``gather_to_model``), each an
``autograd.Function`` with a ``vmap`` rule, so they run inside the round's
``torch.func`` transforms.  A weight's ``data`` shares are gathered just
before the layer that uses it and let go after it (FSDP:
``gather_from_data``, whose backward is the reduce-scatter); a client
body whose client dim owns ``data`` (``exclude_axes``) takes the weights
whole over it.  So
``shard(x, *logical)`` is the identity: a tensor already is its rank's
share.  Serving holds the decode state as ``state_logical_specs`` cuts it
(the attention cache's sequence over ``model`` where the axis divides it,
``model_slice``), and decode attention joins the shards' partial softmaxes
with one gather over ``model`` (``merge_partials``: flash-decoding).  The
rounds reduce gradients between the transforms (``core/round.py``), and
the commit exchanges its rows between the client split and the row split
(``kernels/ops.py``).

Every collective runs through one hook (``_run``), where
``timed_collectives`` times it and ``count_collectives`` counts its
output bytes by the reference's kind (``KINDS``), with a cross-pod entry
where its group spans a pod (``crosses_pods`` of ``group_members``).  On
a dry mesh (``launch.mesh.dry_mesh``) the groups are ``DryGroup``s: the
same three ops take ``meta`` tensors and move nothing, so a rank's step
run there counts what it would move (the dry run's
``collective_bytes``).

Group order: a group over ``axes`` holds the ranks that share every other
coordinate; ``torch.distributed.new_group`` sorts its ranks, and on a
row-major mesh the sorted order is the row-major order over ``axes`` taken
in mesh order, so a group's member ``j`` is the shard ``flat_shard_index``
calls ``j``.  Every function here takes its axes in any order and uses
them in mesh order.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math
import time
import types
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

BATCH = "__batch__"   # data-parallel batch axis (pod+data in multi-pod)
DATA = "data"
MODEL = "model"
POD = "pod"

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
    and the row-major device list.  A mesh of processes
    (``launch.mesh.init_mesh``) also has this process's ``rank`` and the
    process groups of its axes, keyed by the tuple of axes (of size > 1,
    in mesh order) each group spans."""
    axis_names: tuple
    sizes: tuple
    devices: tuple
    rank: Optional[int] = None
    groups: dict = field(default=None, compare=False, hash=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} against sizes "
                             f"{self.sizes}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(f"a {self.sizes} mesh needs "
                             f"{math.prod(self.sizes)} devices, got "
                             f"{len(self.devices)}")
        if self.rank is not None and not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} on a mesh of {self.size}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> dict:
        """This process's index along each axis (row-major rank)."""
        if self.rank is None:
            raise RuntimeError("a mesh record has no coordinates: a mesh "
                               "of processes comes from "
                               "launch.mesh.init_mesh")
        out, r = {}, self.rank
        for a, n in reversed(tuple(zip(self.axis_names, self.sizes))):
            out[a] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    @property
    def device(self):
        """This process's device."""
        return self.devices[self.rank or 0]

    def live(self, axes) -> tuple:
        """``axes`` (a name or names) that this mesh has with size > 1, in
        mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axes):
        """The process group over ``axes``, or None where they span one
        process."""
        axes = self.live(axes)
        if not axes:
            return None
        if self.groups is None:
            raise RuntimeError(f"a collective over {axes} needs a mesh of "
                               f"processes (launch.mesh.init_mesh); this "
                               f"{self.shape} mesh is a record only")
        return self.groups[axes]

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


# One state for the process, not one a thread: the autograd engine runs a
# CUDA tensor's backward on a device thread of its own, and the backward of
# a collective, or a layer group's recompute (``transformer._GroupRemat``),
# must see the mesh and the excluded axes that the forward saw.  The
# backward runs while the caller waits in ``torch.func.grad``, inside the
# same ``use_mesh``/``exclude_axes`` blocks.
_state = types.SimpleNamespace()


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def excluded_axes() -> frozenset:
    return getattr(_state, "exclude", frozenset())


@contextlib.contextmanager
def exclude_axes(*axes: str):
    """Drop the given mesh axes from constraint resolution: used inside a
    client body whose client (or pod) dim owns those axes."""
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


def batch_split_axes() -> tuple:
    """The axes a client's batch is split over here: ``batch_axes`` of
    size > 1 (empty without a mesh)."""
    mesh = get_mesh()
    return mesh.live(batch_axes(mesh)) if mesh is not None else ()


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


@contextlib.contextmanager
def at_rest():
    """No axis excluded inside the block: the layout that params and
    server state keep at rest (``launch.specs.shard_params``), whatever
    client body the caller runs in."""
    prev = excluded_axes()
    _state.exclude = frozenset()
    try:
        yield
    finally:
        _state.exclude = prev


def axis_live(axis: str) -> bool:
    """Whether ``axis`` is larger than 1 on the active mesh and not
    dropped by ``exclude_axes``."""
    mesh = get_mesh()
    return (mesh is not None and axis not in excluded_axes()
            and mesh.shape.get(axis, 1) > 1)


def model_live() -> bool:
    """Whether a ``model`` axis larger than 1 is active here (not dropped
    by ``exclude_axes``)."""
    return axis_live(MODEL)


def data_live() -> bool:
    """Whether a ``data`` axis larger than 1 is active here (not dropped
    by ``exclude_axes``: a parallel round's client dim owns it)."""
    return axis_live(DATA)


def shard(x, *logical):
    """The sharding constraint of ``x`` against the active mesh.  Under the
    SPMD convention a tensor already is its rank's share along the batch
    axes and along ``model`` where a layer split it, so this is the
    identity."""
    return x


def model_split(*sizes) -> int:
    """The shards a dim (or each of several dims) of whole size ``sizes``
    is cut into over ``model``: the active ``model`` axis's size where it
    is larger than 1, not excluded, and divides every size; else 1 (the
    dim stays whole, as ``launch.specs.sanitize_entry`` decides)."""
    return _split(MODEL, sizes)


def data_split(*sizes) -> int:
    """``model_split`` for ``data``: the shards a dim of whole size
    ``sizes`` is cut into over an active ``data`` axis, else 1."""
    return _split(DATA, sizes)


def _split(axis: str, sizes) -> int:
    if not axis_live(axis):
        return 1
    n = get_mesh().shape[axis]
    return n if all(s % n == 0 for s in sizes) else 1


def _index(axis: str) -> int:
    mesh = get_mesh()
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return 0
    return mesh.coords[axis]


def model_index() -> int:
    """This process's index along ``model`` (0 without one)."""
    return _index(MODEL)


def data_index() -> int:
    """This process's index along ``data`` (0 without one)."""
    return _index(DATA)


def model_slice(size: int) -> tuple:
    """(offset, length) of this process's share of a dim of whole size
    ``size`` cut over ``model`` (``model_split``): ``(0, size)`` where the
    dim stays whole."""
    n = model_split(size)
    return (model_index() * (size // n), size // n) if n > 1 else (0, size)


def axis_size(name: str) -> int:
    mesh = get_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def fusion_axes() -> tuple:
    """Mesh axes the fused commit's row (block) dim is split over
    (``kernels.ops``): every active axis of size > 1 that
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


def shard_count(axes) -> int:
    """Shards over ``axes`` on the active mesh (1 without one)."""
    mesh = get_mesh()
    return 1 if mesh is None else math.prod(mesh.shape[a]
                                            for a in mesh.live(axes))


def shard_index(axes) -> int:
    """This process's flat shard index over ``axes`` (in mesh order)."""
    mesh = get_mesh()
    if mesh is None:
        return 0
    axes = mesh.live(axes)
    return flat_shard_index(axes, mesh.coords, mesh) if axes else 0


def shard_cut(axes, dim: int = 0) -> tuple:
    """This process's share of ``dim`` split over ``axes`` as a cut,
    ``((dim, shard_index(axes), shard_count(axes)),)``, or ``()`` on one
    shard.  A cut is a tuple of ``(dim, index, count)``: a tensor that is
    share ``index`` of ``count`` along each ``dim`` of a whole one
    (``whole_shape``, ``take_share``)."""
    n = shard_count(axes)
    return ((dim, shard_index(axes), n),) if n > 1 else ()


def whole_shape(shape, cut) -> tuple:
    """The shape of the whole tensor that one of ``shape`` is the share
    ``cut`` of."""
    out = list(shape)
    for d, _, n in cut:
        out[d] *= n
    return tuple(out)


def take_share(x, cut):
    """The share ``cut`` of the whole ``x``: along each cut dim, part
    ``index`` of ``count`` equal parts (a view)."""
    for d, i, n in cut:
        m = x.shape[d] // n
        x = x.narrow(d, i * m, m)
    return x


@contextlib.contextmanager
def leaf_shares(shares: dict):
    """Inside the block the commit stages take each leaf named in
    ``shares`` as a share of the whole leaf: ``shares[name]`` is its cut
    in the leaf's own dims, after any slot dims.  A random draw over such
    a leaf is made over the whole leaf and cut to the share, and the
    secure commit indexes its mask stream by the whole leaf's elements
    (``core.pipeline.UpdatePipeline.model_commit`` sets it)."""
    prev = current_shares()
    _state.shares = dict(shares)
    try:
        yield
    finally:
        _state.shares = prev


def current_shares() -> dict:
    """The ``leaf_shares`` in force here (empty outside every block)."""
    return getattr(_state, "shares", {})


@contextlib.contextmanager
def count_commit_gathers():
    """Record the leaves that ``core.pipeline``'s ``model_commit`` gathers
    inside the block (whole along their last dim, where its blocks
    straddle a shard): yields a list of their names, one entry a
    gather."""
    prev = getattr(_state, "commit_gathers", None)
    names = []
    _state.commit_gathers = names
    try:
        yield names
    finally:
        _state.commit_gathers = prev


def note_commit_gather(name: str) -> None:
    names = getattr(_state, "commit_gathers", None)
    if names is not None:
        names.append(name)


def local_share(x, axes, dim: int = 0, what: str = "a tensor"):
    """This process's contiguous share of ``x`` along ``dim`` when that dim
    is split over ``axes``: share ``shard_index(axes)`` of
    ``shard_count(axes)``.  A size the count does not divide raises."""
    n = shard_count(axes)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what}: dim {dim} of size {size} does not split "
                         f"over the mesh axes {get_mesh().live(axes)} "
                         f"({n} shards)")
    m = size // n
    return x.narrow(dim, shard_index(axes) * m, m)


# ---------------------------------------------------------------------------
# collectives over named axes (between torch.func transforms, never inside)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_collectives():
    """Time every collective run inside the block on the host clock, the
    device synchronised before and after it: yields
    ``{"seconds": Counter, "calls": Counter}`` keyed by the op's name."""
    prev = getattr(_state, "timed", None)
    stats = {"seconds": Counter(), "calls": Counter()}
    _state.timed = stats
    try:
        yield stats
    finally:
        _state.timed = prev


# the reference's names of the collectives (``repro/launch/dryrun.py``'s
# ``COLLECTIVE_OPS``) for the ops here
KINDS = {"psum": "all-reduce", "all_gather": "all-gather",
         "all_to_all": "all-to-all"}
POD_STRIDE = 256      # the reference's: devices in a production pod


@contextlib.contextmanager
def count_collectives():
    """Count the bytes of every collective run inside the block, live or
    on a dry mesh (``launch.mesh.dry_mesh``): yields a Counter of
    ``{kind: bytes}`` under the reference's kinds (``KINDS``), each the
    op's output bytes on this process (the gathered tensor of a gather,
    the tensor itself of a reduction or an exchange; under ``vmap`` the
    batched tensor the op moves), as ``collective_bytes`` of the
    reference's dry run counts them, with ``<kind>/cross_pod`` beside a
    kind for the ops whose group crosses a pod (``crosses_pods``).
    Counting reads shapes only: it neither synchronises nor changes a
    result."""
    prev = getattr(_state, "counted", None)
    counts = Counter()
    _state.counted = counts
    try:
        yield counts
    finally:
        _state.counted = prev


def crosses_pods(members, pod_stride: int = POD_STRIDE) -> bool:
    """Whether a group of the row-major device indices ``members`` spans
    devices ``pod_stride`` or more apart: the reference's rule
    (``repro/launch/dryrun.py``'s ``crosses_pods``) for traffic that
    crosses the pod boundary (the data-center network, not the pod's own
    links)."""
    return bool(members) and max(members) - min(members) >= pod_stride


def pod_stride(mesh: Mesh) -> int:
    """Devices in one pod of ``mesh``: the devices of the axes after
    ``pod`` (256 on the production multi-pod mesh), or the whole mesh
    where it has no ``pod`` axis."""
    if POD not in mesh.axis_names:
        return mesh.size
    return math.prod(mesh.sizes[mesh.axis_names.index(POD) + 1:])


@functools.lru_cache(maxsize=1024)
def group_members(mesh: Mesh, axes: tuple) -> tuple:
    """The row-major ranks of this process's group over ``axes`` (the
    ranks that share every other coordinate with it), in order."""
    span = mesh.live(axes)
    coords = mesh.coords
    stride = {a: math.prod(mesh.sizes[i + 1:])
              for i, a in enumerate(mesh.axis_names)}
    base = mesh.rank - sum(coords[a] * stride[a] for a in span)
    return tuple(sorted(base + sum(i * stride[a] for i, a in zip(idx, span))
                        for idx in itertools.product(
                            *(range(mesh.shape[a]) for a in span))))


def _count(name, axes, out) -> None:
    counts = getattr(_state, "counted", None)
    if counts is None:
        return
    mesh = get_mesh()
    kind = KINDS[name]
    size = out.numel() * out.element_size()
    counts[kind] += size
    if crosses_pods(group_members(mesh, mesh.live(axes)), pod_stride(mesh)):
        counts[kind + "/cross_pod"] += size


class DryGroup:
    """A process group of a dry mesh (``launch.mesh.dry_mesh``): its
    ``size()`` and member ranks, and no processes.  The collectives on it
    move nothing: each op's output is a ``meta`` tensor of its shape and
    dtype, which ``count_collectives`` counts.  A tensor that is not on
    ``meta`` raises, so a dry mesh never stands in for a live one."""

    def __init__(self, members):
        self.members = tuple(members)

    def size(self) -> int:
        return len(self.members)

    def _check(self, *tensors):
        for t in tensors:
            if t.device.type != "meta":
                raise RuntimeError(f"a collective on a dry mesh got a "
                                   f"tensor on {t.device}: a dry mesh "
                                   f"counts meta tensors only")

    def all_reduce(self, t, group=None):
        self._check(t)

    def all_gather(self, parts, t, group=None):
        self._check(t, *parts)

    def all_to_all_single(self, recv, send, group=None):
        self._check(recv, send)


def _comm(group):
    """What runs the collectives on ``group``: ``torch.distributed``, or
    the dry group itself."""
    if isinstance(group, DryGroup):
        return group
    import torch.distributed as dist
    return dist


def _run(name, x, axes, op):
    stats = getattr(_state, "timed", None)
    if stats is None:
        out = op()
    else:
        sync = (torch.cuda.synchronize if x.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        out = op()
        sync()
        stats["seconds"][name] += time.perf_counter() - t0
        stats["calls"][name] += 1
    _count(name, axes, out)
    return out


def psum(x, axes):
    """The sum of ``x`` over the processes of ``axes`` (``lax.psum``)."""
    mesh = get_mesh()
    group = mesh.group(axes) if mesh is not None else None
    if group is None:
        return x

    def op():
        y = x.contiguous().clone()
        _comm(group).all_reduce(y, group=group)
        return y
    return _run("psum", x, axes, op)


def pmean(x, axes):
    """The mean of ``x`` over the processes of ``axes``."""
    n = shard_count(axes)
    return x if n == 1 else psum(x, axes) / n


def all_gather(x, axes, dim: int = 0):
    """``lax.all_gather`` (tiled) over ``axes``: the members' ``x`` in
    shard order, concatenated along ``dim``."""
    mesh = get_mesh()
    group = mesh.group(axes) if mesh is not None else None
    if group is None:
        return x

    def op():
        xc = x.contiguous()
        parts = [torch.empty_like(xc) for _ in range(group.size())]
        _comm(group).all_gather(parts, xc, group=group)
        return torch.cat(parts, dim)
    return _run("all_gather", x, axes, op)


def all_to_all(x, axes, split_dim: int, concat_dim: int):
    """``lax.all_to_all`` (tiled) over ``axes``: ``x`` split along
    ``split_dim`` into one chunk per member, chunk ``j`` sent to member
    ``j``, and the chunks received concatenated along ``concat_dim`` in
    shard order."""
    mesh = get_mesh()
    group = mesh.group(axes) if mesh is not None else None
    if group is None:
        return x
    n = group.size()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split into {n}")

    def op():
        send = x.movedim(split_dim, 0)
        chunk = tuple(send.shape)
        send = send.reshape((n, chunk[0] // n) + chunk[1:]).contiguous()
        recv = torch.empty_like(send)
        _comm(group).all_to_all_single(recv, send, group=group)
        return torch.cat([recv[j].movedim(0, split_dim) for j in range(n)],
                         concat_dim)
    return _run("all_to_all", x, axes, op)


def combine_partials(m, l, o):
    """The softmax-weighted sum from the partials of its shards, stacked on
    a leading dim: each shard's running max ``m`` [n, ...], denominator
    ``l = sum exp(s - m)`` [n, ...] and unnormalised numerator ``o = sum
    exp(s - m) v`` [n, ..., d], all float32.  Each shard is rescaled by
    ``exp(m - max m)``, the shards summed in order, and the numerator
    divided once.  A shard with no valid score has ``m`` at the mask's
    finite -1e30, so its weight underflows to 0 (an infinite mask would
    give NaN)."""
    w = torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / (l * w).sum(0)[..., None]


def merge_partials(m, l, o):
    """Flash-decoding's merge over ``model``: every rank's partials
    gathered (one ``all_gather``) and ``combine_partials`` run on them, in
    shard order, so every rank holds the same bits.  Serving only: no
    gradient passes."""
    flat = torch.cat([m.reshape(-1), l.reshape(-1), o.reshape(-1)])
    parts = all_gather(flat[None], MODEL, 0)
    n, k = parts.shape[0], m.numel()
    return combine_partials(parts[:, :k].reshape(n, *m.shape),
                            parts[:, k:2 * k].reshape(n, *l.shape),
                            parts[:, 2 * k:].reshape(n, *o.shape))


def replica_checksums(tree: dict, axes=None, chunk: int = 1 << 24) -> dict:
    """Per leaf of ``tree`` (a flat dict), every process's integer checksum
    of the leaf's bits, gathered over ``axes`` (every axis of size > 1 by
    default): {name: [checksum of shard 0, of shard 1, ...]}.  Equal lists
    mean the leaf is bit for bit the same on every process (a replica that
    diverged shows, where a broadcast would have hidden it)."""
    import torch
    mesh = get_mesh()
    axes = mesh.axis_names if axes is None and mesh is not None else axes
    out = {}
    for name in sorted(tree):
        x = tree[name].detach().contiguous().reshape(-1)
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]
        v = x.view(ints)
        total = torch.zeros(2, dtype=torch.int64, device=x.device)
        for lo in range(0, v.numel(), chunk):
            c = v[lo:lo + chunk].to(torch.int64)
            pos = torch.arange(lo + 1, lo + 1 + c.numel(), device=x.device)
            total[0] += c.sum()
            total[1] += (c * pos).sum()
        out[name] = [tuple(t) for t in
                     all_gather(total[None], axes or (), 0).tolist()]
    return out


# ---------------------------------------------------------------------------
# collectives over ``model`` inside torch.func transforms: conjugate pairs
# ---------------------------------------------------------------------------
#
# Each is an autograd.Function in the setup_context style whose backward is
# its conjugate's ``apply`` (so a backward under ``vmap`` batches too) and
# whose ``vmap`` rule moves the vmapped dim to 0 and runs the collective on
# the physical tensor: every rank of a ``model`` group holds the same
# clients, so the batched tensors line up.  Dims are taken negative, so a
# leading batch dim leaves them as they are.  The pairing decides the
# gradient: a collective whose output feeds the same computation on every
# rank has a backward that keeps the rank's own share of the (equal)
# cotangents; one whose output feeds a different computation on each rank
# sums the ranks' cotangents.  The wrong pair scales a gradient by the
# axis size.  Off a ``model`` axis larger than 1 each is the identity.

def _own(x, dim, axis=MODEL):
    n = shard_count(axis)
    m = x.shape[dim] // n
    return x.narrow(dim, _index(axis) * m, m).contiguous()


def _batched(cls, in_dims, x, *rest):
    """The vmap rule of a one-tensor collective: the vmapped dim moved to
    0, the collective run once on the physical tensor."""
    bdim = in_dims[0]
    if bdim is None:
        return cls.apply(x, *rest), None
    return cls.apply(x.movedim(bdim, 0), *rest), 0


class _CopyToModel(torch.autograd.Function):
    """Forward the identity; backward the sum over ``model``: the input of
    a split computation (a column-parallel product)."""

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g)

    @staticmethod
    def vmap(info, in_dims, x):
        return _batched(_CopyToModel, in_dims, x)


class _ReduceFromModel(torch.autograd.Function):
    """Forward the sum over ``model``; backward the identity: the partial
    sums of a split computation (a row-parallel product) joined for a
    computation that every rank repeats."""

    @staticmethod
    def forward(x):
        return psum(x, MODEL)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g)

    @staticmethod
    def vmap(info, in_dims, x):
        return _batched(_ReduceFromModel, in_dims, x)


class _GatherFromModel(torch.autograd.Function):
    """Forward the ranks' shares concatenated along ``dim``; backward the
    rank's own share of the cotangent: the gathered tensor feeds the same
    computation on every rank."""

    @staticmethod
    def forward(x, dim):
        return all_gather(x, MODEL, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ScatterToModel.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _batched(_GatherFromModel, in_dims, x, dim)


class _ScatterToModel(torch.autograd.Function):
    """Forward the rank's own share along ``dim`` of a tensor every rank
    holds whole; backward the ranks' cotangent shares gathered: each rank
    feeds its share to a computation of its own."""

    @staticmethod
    def forward(x, dim):
        return _own(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GatherFromModel.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _batched(_ScatterToModel, in_dims, x, dim)


class _GatherToModel(torch.autograd.Function):
    """Forward the ranks' shares concatenated along ``dim``; backward the
    ranks' cotangents summed and cut to the rank's share (a reduce-scatter,
    as an all-reduce and a cut, which every backend runs): the gathered
    tensor feeds a different computation on each rank."""

    @staticmethod
    def forward(x, dim):
        return all_gather(x, MODEL, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterModel.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _batched(_GatherToModel, in_dims, x, dim)


class _ReduceScatterModel(torch.autograd.Function):
    """The sum over ``model`` cut to the rank's share along ``dim``:
    ``_GatherToModel``'s backward (its own backward is the gather)."""

    @staticmethod
    def forward(x, dim):
        return _own(psum(x, MODEL), dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GatherToModel.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _batched(_ReduceScatterModel, in_dims, x, dim)


def _neg(x, dim: int) -> int:
    return dim - x.ndim if dim >= 0 else dim


def copy_to_model(x):
    """``x`` into a computation split over ``model``: forward the identity,
    backward the sum over ``model``."""
    return _CopyToModel.apply(x) if model_live() else x


def reduce_from_model(x):
    """The sum over ``model`` of a split computation's partial sums, for a
    computation every rank repeats: backward the identity."""
    return _ReduceFromModel.apply(x) if model_live() else x


def gather_from_model(x, dim: int = -1):
    """The shares along ``dim`` gathered over ``model``, for a computation
    every rank repeats: backward the rank's own share."""
    return _GatherFromModel.apply(x, _neg(x, dim)) if model_live() else x


def scatter_to_model(x, dim: int = -1):
    """The rank's share along ``dim`` of a tensor every rank holds whole,
    for a computation of its own: backward the shares gathered."""
    return _ScatterToModel.apply(x, _neg(x, dim)) if model_live() else x


def gather_to_model(x, dim: int = -1):
    """The shares along ``dim`` gathered over ``model``, for a computation
    of each rank's own (a weight held split, used whole): backward the
    ranks' cotangents summed and cut to the share."""
    return _GatherToModel.apply(x, _neg(x, dim)) if model_live() else x


# ---------------------------------------------------------------------------
# collectives over ``data`` inside torch.func transforms: FSDP
# ---------------------------------------------------------------------------
#
# A weight held cut over ``data`` at rest is gathered whole just before the
# layer that uses it (``gather_from_data``).  Each ``data`` rank feeds the
# gathered weight its own share of the batch, so the backward sums the
# ranks' cotangents over ``data`` and keeps the rank's share: the reduce is
# the ``psum`` before the cut, so a gradient share carries the bits of the
# summed whole gradient, cut.  The MoE's decode sums its partial products
# over the expert F dim it holds cut (``reduce_from_data``).

def _note_gather(out):
    stats = getattr(_state, "gathers", None)
    if stats is not None:
        size = out.numel() * out.element_size()
        stats["calls"] += 1
        stats["live"] += size
        stats["peak"] = max(stats["peak"], stats["live"])

        def freed(stats=stats, size=size):
            stats["live"] -= size
        weakref.finalize(out, freed)
    return out


@contextlib.contextmanager
def count_gathers():
    """Count ``gather_from_data``'s gathers inside the block: yields
    ``{"calls", "live", "peak"}``, the gathers made, the bytes of gathered
    weights alive now and the most alive at once (a gathered tensor is
    dead once nothing holds it: not a caller, a view nor autograd)."""
    prev = getattr(_state, "gathers", None)
    stats = {"calls": 0, "live": 0, "peak": 0}
    _state.gathers = stats
    try:
        yield stats
    finally:
        _state.gathers = prev


class _GatherFromData(torch.autograd.Function):
    """Forward the ranks' shares concatenated along ``dim`` over ``data``;
    backward the ranks' cotangents summed and cut to the rank's share."""

    @staticmethod
    def forward(x, dim):
        return _note_gather(all_gather(x, DATA, dim))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterData.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _batched(_GatherFromData, in_dims, x, dim)


class _ReduceScatterData(torch.autograd.Function):
    """The sum over ``data`` cut to the rank's share along ``dim``:
    ``_GatherFromData``'s backward (its own backward is the gather)."""

    @staticmethod
    def forward(x, dim):
        return _own(psum(x, DATA), dim, DATA)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GatherFromData.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        return _batched(_ReduceScatterData, in_dims, x, dim)


class _ReduceFromData(torch.autograd.Function):
    """Forward the sum over ``data``; backward the identity: partial sums
    joined for a computation that every ``data`` rank repeats."""

    @staticmethod
    def forward(x):
        return psum(x, DATA)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g

    @staticmethod
    def vmap(info, in_dims, x):
        return _batched(_ReduceFromData, in_dims, x)


def gather_from_data(x, dim: int):
    """A weight's shares along ``dim`` gathered over ``data`` (FSDP's
    gather): backward, the ranks' cotangents summed and cut to the
    rank's share.  The identity off an active ``data`` axis."""
    return _GatherFromData.apply(x, _neg(x, dim)) if data_live() else x


def reduce_from_data(x):
    """The sum over ``data`` of partial sums (the MoE's decode over its
    expert F shares), for a computation every rank repeats."""
    return _ReduceFromData.apply(x) if data_live() else x


def pair_shares(x, w, n: int):
    """The rank's channels of both halves of ``x @ w``, where ``w``'s
    columns are two halves ``[a | b]`` of ``n`` channels each and ``w`` is
    held as its spec's contiguous share over ``model``, which is not the
    rank's channels of each half (Mamba's ``in_proj``, the mLSTM's
    ``up``).  Each rank multiplies its share of the columns, the products
    are gathered (``gather_to_model``: backward, the ranks' cotangents
    summed and cut to the share) and each half is cut to the rank's
    ``model_slice(n)``.  Returns (a, b)."""
    y = gather_to_model(copy_to_model(x) @ w, -1)
    off, dl = model_slice(n)
    return y[..., off:off + dl], y[..., n + off:n + off + dl]
