"""Input stand-ins and sharding-spec plumbing for the dry run, mirroring
``repro/launch/specs.py``: ``meta`` tensors take the place of
``jax.ShapeDtypeStruct``, so nothing is allocated.

``sanitize_specs`` is the single divisibility gate: any dim whose size does
not divide by the mesh extent of its logical axes falls back to replicated
(e.g. batch=1 in long_500k, kv_heads < 16, the 36-head starcoder2
attention).  Its trees hold ``sharding.PartitionSpec``s where the
reference's hold ``NamedSharding``s of the same specs.

Params at rest on a mesh of processes: ``shard_params`` cuts each leaf to
this rank's contiguous share along the dim its sanitised spec puts on
``model`` and along the one it puts on ``data`` (the reference's placement
by ``sanitize_specs``: ``wq`` [G, D, H*hd] is held [G, D/data,
H*hd/model]; FSDP over ``data``), whole along ``pod``, and
``gather_params`` puts the shares back together, bit for bit.  The layout
is the one at rest whatever client body asks (``sharding.at_rest``).  The
trees may be nested or the flat ``/``-joined view; the specs are the
model's ``logical_specs``, nested or flat.  Server optimizer state of the
sharded params (``server_opt.init`` of them) is sharded alike.
``shard_leaf`` cuts one leaf as it is drawn (``LM.init``'s ``keep``), so a
rank never holds the whole model.  A rank's bytes are
``launch.dryrun.per_device_bytes`` of the params on its mesh.

The decode state at rest: ``shard_state`` cuts a whole state by
``state_logical_specs`` after ``sanitize_specs``, the batch over the batch
axes and the attention cache's slots and Mamba's channels over ``model``:
the shares that ``LM.prefill`` makes on a rank under the mesh, whose bytes
are ``launch.dryrun.per_device_bytes`` of the state."""
from __future__ import annotations

import math

import torch

from repro_torch.configs import InputShape
from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as sh
from repro_torch.models.common import DTYPES
from repro_torch.models.transformer import LM
from repro_torch.pytree import flat_dict, nest

TOKENS = torch.int32


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def resolve_logical(logical, mesh):
    return tuple(sh.resolve(e, mesh) for e in logical)


def sanitize_entry(shape, logical, mesh) -> sh.PartitionSpec:
    entries = []
    for dim, ent in enumerate(logical):
        r = sh.resolve(ent, mesh)
        if r is None:
            entries.append(None)
            continue
        axes = (r,) if isinstance(r, str) else tuple(r)
        extent = math.prod(mesh.shape[a] for a in axes)
        entries.append(r if shape[dim] % extent == 0 else None)
    return sh.P(*entries)


def sanitize_specs(shape_tree, logical_tree, mesh):
    """A tree of specs with ``shape_tree``'s structure: each tensor leaf's
    logical tuple sanitised against its shape."""
    if isinstance(shape_tree, dict):
        if set(shape_tree) != set(logical_tree):
            raise ValueError(f"trees differ: {sorted(shape_tree)} against "
                             f"{sorted(logical_tree)}")
        return {k: sanitize_specs(v, logical_tree[k], mesh)
                for k, v in shape_tree.items()}
    return sanitize_entry(tuple(shape_tree.shape), logical_tree, mesh)


def flat_logical(tree, prefix: str = "") -> dict:
    """A (nested or flat) tree of logical tuples as ``{path: tuple}``: the
    tuples are leaves, where ``pytree.flat_dict`` would walk them."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_logical(v, path + "/"))
        else:
            out[path] = v
    return out


SPLIT_AXES = (sh.DATA, sh.MODEL)     # the axes params are cut over at rest


def leaf_cut(shape, logical, mesh) -> dict:
    """``{axis: dim}``: the dim of a whole ``shape`` that its sanitised
    spec cuts over each of ``data`` and ``model`` on ``mesh`` (axes of
    size 1 left out), at rest."""
    if mesh is None:
        return {}
    with sh.at_rest():
        spec = sanitize_entry(tuple(shape), logical, mesh)
    out = {}
    for dim, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else tuple(e or ())):
            if a in SPLIT_AXES and mesh.shape[a] > 1:
                out[a] = dim
    return out


def shard_leaf(v, logical, mesh=None):
    """This rank's share of the whole leaf ``v`` under its logical spec:
    cut along the dims its sanitised spec puts on ``data`` and ``model``
    to the share at this rank's index along each, or ``v`` itself where
    nothing is cut.  The share is a copy with storage of its own: a cut
    that is contiguous as it stands (the experts of a [1, E, D, F] leaf)
    would otherwise be a view that keeps the whole leaf alive."""
    mesh = mesh or sh.get_mesh()
    cut = leaf_cut(v.shape, logical, mesh)
    if not cut:
        return v
    for a, d in cut.items():
        n = v.shape[d] // mesh.shape[a]
        v = v.narrow(d, mesh.coords[a] * n, n)
    return v.clone(memory_format=torch.contiguous_format)


def leaf_cuts(shapes: dict, logical: dict, mesh=None) -> dict:
    """``{leaf: {axis: dim}}`` for the flat ``{leaf: shape}`` dict
    ``shapes`` (whole shapes) and the logical specs (nested or flat), on
    ``mesh`` (the active one by default): ``leaf_cut`` of each leaf that
    is cut at rest (the rest left out)."""
    mesh = mesh or sh.get_mesh()
    logical = flat_logical(logical)
    out = {name: leaf_cut(shape, logical[name], mesh)
           for name, shape in shapes.items()}
    return {k: c for k, c in out.items() if c}


def shard_params(whole, specs, mesh=None):
    """This rank's share of ``whole`` (nested or flat) under ``specs`` (the
    logical tree): each leaf cut as ``shard_leaf`` cuts it.  Returns the
    same structure; a leaf not cut is the tensor itself."""
    mesh = mesh or sh.get_mesh()
    logical = flat_logical(specs)
    return _like(whole, {k: shard_leaf(v, logical[k], mesh)
                         for k, v in flat_dict(whole).items()})


def gather_params(local, specs, whole_shapes, mesh=None):
    """``shard_params``' inverse: every rank's shares of ``local`` gathered
    over ``data`` and ``model`` along their cut dims.  ``whole_shapes``:
    the params' tree of whole tensors (``LM.param_specs()``, on ``meta``),
    from which the cut is decided as ``shard_params`` decided it."""
    mesh = mesh or sh.get_mesh()
    flat = flat_dict(local)
    shapes = {k: tuple(v.shape) for k, v in flat_dict(whole_shapes).items()}
    cuts = leaf_cuts(shapes, specs, mesh)
    out = {}
    for k, v in flat.items():
        for a, d in cuts.get(k, {}).items():
            v = sh.all_gather(v, a, d)
        out[k] = v
    return _like(local, out)


def shard_state(whole, logical, mesh=None) -> dict:
    """This process's share of the whole decode state ``whole`` (``LM.
    init_decode_state`` of the global batch, with no mesh) under its
    logical specs (``LM.state_logical_specs``): each leaf cut along every
    dim whose sanitised spec names mesh axes, to the share at this
    process's flat index over them (the batch over ``pod`` and ``data``,
    slots and channels over ``model``).  Returns the nested structure."""
    mesh = mesh or sh.get_mesh()
    spec = sanitize_specs(whole, logical, mesh)

    def cut(v, s):
        if isinstance(v, dict):
            return {k: cut(v[k], s[k]) for k in v}
        for dim, e in enumerate(s):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n = math.prod(mesh.shape[a] for a in axes)
            if n > 1:
                i = sh.flat_shard_index(axes, mesh.coords, mesh)
                size = v.shape[dim] // n
                v = v.narrow(dim, i * size, size)
        return v
    return cut(whole, spec)


def _like(tree, flat: dict):
    """``flat`` in ``tree``'s structure (flat or nested)."""
    if all(not isinstance(v, dict) for v in tree.values()):
        return flat
    return nest(flat)


def param_bytes(tree) -> int:
    """The bytes of a (nested or flat) tree's tensors."""
    return sum(v.numel() * v.element_size() for v in flat_dict(tree).values())


def train_client_batch_specs(cfg: ModelConfig, shape: InputShape,
                             num_clients: int, local_steps: int):
    """[C, H, b, ...] stacked client batches, and their logical shardings
    for the parallel (client dim over BATCH) and sequential (within-client
    batch over BATCH) modes."""
    C, H = num_clients, local_steps
    b = shape.global_batch // C
    S = shape.seq_len
    tok_shape = (C, H, b, S, cfg.n_codebooks) if cfg.n_codebooks \
        else (C, H, b, S)
    specs = {"tokens": meta(tok_shape, TOKENS),
             "targets": meta(tok_shape, TOKENS)}
    tail = (None,) * (len(tok_shape) - 3)
    tok_logical = (sh.BATCH, None, None) + tail
    seq_logical = (None, None, sh.BATCH) + tail
    logical = {"tokens": tok_logical, "targets": tok_logical}
    logical_seq = {"tokens": seq_logical, "targets": seq_logical}
    if cfg.cross_attn_every:
        specs["patches"] = meta((C, H, b, cfg.n_patches, cfg.d_model),
                                DTYPES[cfg.dtype])
        logical["patches"] = (sh.BATCH, None, None, None, sh.MODEL)
        logical_seq["patches"] = (None, None, sh.BATCH, None, sh.MODEL)
    return specs, logical, logical_seq


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape):
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    specs = {"tokens": meta(tok_shape, TOKENS)}
    logical = {"tokens": (sh.BATCH,) + (None,) * (len(tok_shape) - 1)}
    if cfg.cross_attn_every:
        specs["patches"] = meta((B, cfg.n_patches, cfg.d_model),
                                DTYPES[cfg.dtype])
        logical["patches"] = (sh.BATCH, None, sh.MODEL)
    return specs, logical


def decode_inputs_specs(cfg: ModelConfig, shape: InputShape, model: LM):
    """(token, token logical, state, state logical, patches?, patches
    logical?) for one decode step; the state as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    token = meta(tok_shape, TOKENS)
    token_logical = (sh.BATCH,) + (None,) * (len(tok_shape) - 1)
    with sh.use_mesh(None):                 # the whole state, not a share
        state = model.init_decode_state(B, S, device="meta")
    state_logical = model.state_logical_specs(B, S)
    patches = patches_logical = None
    if cfg.cross_attn_every:
        patches = meta((B, cfg.n_patches, cfg.d_model), DTYPES[cfg.dtype])
        patches_logical = (sh.BATCH, None, sh.MODEL)
    return (token, token_logical, state, state_logical, patches,
            patches_logical)
