"""Pytree payload serialization (wire format and checkpoint substrate),
mirroring ``repro/comm/payload.py`` byte for byte.

Flat binary layout: an 8-byte little-endian header length, a JSON header
(``keys``: the leaves' ``/``-joined paths, ``shapes``, ``dtypes`` as
``numpy.dtype.str``), then every leaf's raw little-endian bytes, in
``jax.tree`` order (``repro_torch.pytree``).  For the same numpy tree the
port writes the reference's bytes, and a flat dict whose keys are paths
(the LM's flat view) writes the bytes of the nested tree it stands for, so
files load in either package.  Tensors on the card are copied to the host;
with ``like``, leaves come back on ``like``'s device and dtype.
"""
from __future__ import annotations

import io
import json

import numpy as np
import torch

from repro_torch.pytree import leaves_with_paths, unflatten_like


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def serialize_tree(tree) -> bytes:
    flat = leaves_with_paths(tree)
    arrays = [_to_numpy(leaf) for _, leaf in flat]
    header = {
        "keys": [k for k, _ in flat],
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [a.dtype.str for a in arrays],
    }
    hb = json.dumps(header).encode()
    buf = io.BytesIO()
    buf.write(len(hb).to_bytes(8, "little"))
    buf.write(hb)
    for a in arrays:
        buf.write(np.ascontiguousarray(a).tobytes())
    return buf.getvalue()


def _restore(like_leaf, a: np.ndarray):
    """A stored array as ``like_leaf`` holds it: a tensor on its device and
    dtype, anything else as the numpy array (as the reference returns)."""
    if torch.is_tensor(like_leaf):
        return torch.from_numpy(np.array(a)).to(device=like_leaf.device,
                                                dtype=like_leaf.dtype)
    return a


def deserialize_tree(data: bytes, like=None):
    """The stored tree: shaped like ``like`` (matched by position), or a
    ``{path: numpy array}`` dict without it."""
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n].decode())
    off = 8 + n
    arrays = []
    for shape, dtype in zip(header["shapes"], header["dtypes"]):
        dt = np.dtype(dtype)
        count = int(np.prod(shape)) if shape else 1
        nb = count * dt.itemsize
        arrays.append(np.frombuffer(data[off:off + nb], dt).reshape(shape))
        off += nb
    if like is not None:
        assert len(leaves_with_paths(like)) == len(arrays), \
            "structure mismatch"
        return unflatten_like(like, arrays, _restore)
    return dict(zip(header["keys"], arrays))


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size() if torch.is_tensor(leaf)
               else np.asarray(leaf).nbytes
               for _, leaf in leaves_with_paths(tree))
