"""Leaf paths of the port's parameter trees, in ``jax.tree`` order.

The reference walks a pytree with ``jax.tree_util.tree_flatten_with_path``:
a dict in sorted-key order, a list or tuple in index order, ``None`` with no
leaves.  Its checkpoint format (``comm/payload.py``) names each leaf by its
path joined with ``/``, a dict key as itself and a sequence index as
``[i]``.  The port flattens the same way, sorting level by level: sorting
the joined strings would put ``a.b`` before ``a/x``, where the levels put
``a`` first.

A flat dict whose keys are such paths (the LM's flat view,
``layers/slot0/wq``) sorts by its keys' levels too, so it flattens in the
order, and under the names, of the nested tree it stands for.  The round,
the update pipeline and the optimizers walk their ``{name: tensor}`` dicts
in this order (``ordered``), so the LM's leaves are blocked, bucketed and
masked in the reference's order.
"""
from __future__ import annotations

import re

_INDEX = re.compile(r"\[(\d+)\]")


def _level(part: str):
    m = _INDEX.fullmatch(part)
    return (0, int(m.group(1)), "") if m else (1, 0, part)


def path_order(key: str):
    """The sort key of a ``/``-joined path: each level as JAX orders it (a
    dict key as a string, a sequence index as a number)."""
    return tuple(_level(p) for p in str(key).split("/"))


def ordered(tree: dict) -> list:
    """The keys of a (flat or nested) dict in ``jax.tree`` order."""
    return sorted(tree, key=path_order)


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in ``jax.tree`` order; a leaf is anything that is
    not a dict, list, tuple or None."""
    if isinstance(tree, dict):
        return [kv for k in ordered(tree)
                for kv in leaves_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_paths(v, prefix + (f"[{i}]",))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def flat_dict(tree) -> dict:
    """A nested tree as one ``{path: leaf}`` dict, in ``jax.tree`` order.
    The leaves are the tree's own objects: nothing is copied."""
    return dict(leaves_with_paths(tree))


def nest(flat: dict) -> dict:
    """A ``{path: leaf}`` dict of dict levels back as nested dicts (the
    leaves themselves, not copies)."""
    out: dict = {}
    for key, leaf in flat.items():
        *parents, name = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def unflatten_like(like, leaves, convert=lambda like_leaf, leaf: leaf):
    """A tree shaped like ``like`` whose leaves, in ``jax.tree`` order, are
    ``convert(like's leaf, next of leaves)``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in ordered(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return convert(node, next(it))

    return build(like)
