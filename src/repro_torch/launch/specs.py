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
``model`` (the reference's placement by ``sanitize_specs``), and
``gather_params`` puts the shares back together, bit for bit.  ``data``
entries stay whole (FSDP over ``data`` is ROADMAP item 9c).  The trees may
be nested or the flat ``/``-joined view; the specs are the model's
``logical_specs``, nested or flat.  Server optimizer state of the
sharded params (``server_opt.init`` of them) is sharded alike."""
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


def model_dims(shapes: dict, logical: dict, mesh=None) -> dict:
    """``{leaf: the dim its sanitised spec splits over model, or None}``
    for the flat ``{leaf: shape}`` dict ``shapes`` (whole shapes) and the
    logical specs (nested or flat), on ``mesh`` (the active one by
    default).  Without a ``model`` axis larger than 1 every entry is
    None."""
    mesh = mesh or sh.get_mesh()
    out = dict.fromkeys(shapes)
    if mesh is None or mesh.shape.get(sh.MODEL, 1) == 1:
        return out
    logical = flat_logical(logical)
    for name, shape in shapes.items():
        spec = sanitize_entry(tuple(shape), logical[name], mesh)
        for dim, e in enumerate(spec):
            if sh.MODEL in ((e,) if isinstance(e, str) else tuple(e or ())):
                out[name] = dim
    return out


def shard_params(whole, specs, mesh=None):
    """This rank's share of ``whole`` (nested or flat) under ``specs`` (the
    logical tree): each leaf cut along the dim its sanitised spec puts on
    ``model`` to share ``model`` index of ``model`` size, the rest whole.
    Returns the same structure; a leaf not split is the tensor itself."""
    mesh = mesh or sh.get_mesh()
    flat = flat_dict(whole)
    dims = model_dims({k: tuple(v.shape) for k, v in flat.items()}, specs,
                      mesh)
    m = 1 if mesh is None else mesh.shape.get(sh.MODEL, 1)
    i = 0 if m == 1 else mesh.coords[sh.MODEL]
    out = {}
    for k, v in flat.items():
        d = dims[k]
        if d is None:
            out[k] = v
        else:
            n = v.shape[d] // m
            out[k] = v.narrow(d, i * n, n).contiguous()
    return _like(whole, out)


def gather_params(local, specs, whole_shapes, mesh=None):
    """``shard_params``' inverse: every rank's shares of ``local`` gathered
    over ``model`` along their split dims.  ``whole_shapes``: the params'
    tree of whole tensors (``LM.param_specs()``, on ``meta``), from which
    the split is decided as ``shard_params`` decided it."""
    mesh = mesh or sh.get_mesh()
    flat = flat_dict(local)
    shapes = {k: tuple(v.shape) for k, v in flat_dict(whole_shapes).items()}
    dims = model_dims(shapes, specs, mesh)
    out = {k: v if dims[k] is None else sh.all_gather(v, sh.MODEL, dims[k])
           for k, v in flat.items()}
    return _like(local, out)


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
    state = {key: {name: meta(shp, dt) for name, (shp, dt) in leaves.items()}
             for key, leaves in model.decode_state_specs(B, S).items()}
    state_logical = model.state_logical_specs(B, S)
    patches = patches_logical = None
    if cfg.cross_attn_every:
        patches = meta((B, cfg.n_patches, cfg.d_model), DTYPES[cfg.dtype])
        patches_logical = (sh.BATCH, None, sh.MODEL)
    return (token, token_logical, state, state_logical, patches,
            patches_logical)
