"""Input stand-ins and sharding-spec plumbing for the dry run, mirroring
``repro/launch/specs.py``: ``meta`` tensors take the place of
``jax.ShapeDtypeStruct``, so nothing is allocated.

``sanitize_specs`` is the single divisibility gate: any dim whose size does
not divide by the mesh extent of its logical axes falls back to replicated
(e.g. batch=1 in long_500k, kv_heads < 16, the 36-head starcoder2
attention).  Its trees hold ``sharding.PartitionSpec``s where the
reference's hold ``NamedSharding``s of the same specs."""
from __future__ import annotations

import math

import torch

from repro_torch.configs import InputShape
from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as sh
from repro_torch.models.common import DTYPES
from repro_torch.models.transformer import LM

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
