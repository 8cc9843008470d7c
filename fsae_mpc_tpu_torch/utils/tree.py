"""Nested containers of tensors: the port's counterpart of JAX's pytrees.

A tree is a tensor, a tuple or list, a dict, a dataclass instance, or any
other value (a float, an int, a string, ``None``), which is a leaf that the
functions here carry along unchanged.  Dataclasses (``VehicleParams``,
``Track``, ``SimOutputs``, the solvers' results) are rebuilt field by field
with :func:`dataclasses.replace`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _children(tree):
    """``(keys, values, rebuild)`` of a container, or None for a leaf."""
    if isinstance(tree, dict):
        keys = list(tree)
        return keys, [tree[k] for k in keys], \
            lambda vs: type(tree)(zip(keys, vs))
    if isinstance(tree, (tuple, list)):
        keys = list(range(len(tree)))
        if hasattr(tree, "_fields"):            # a named tuple
            return keys, list(tree), lambda vs: type(tree)(*vs)
        return keys, list(tree), lambda vs: type(tree)(vs)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        keys = [f.name for f in dataclasses.fields(tree)]
        return keys, [getattr(tree, k) for k in keys], \
            lambda vs: dataclasses.replace(tree, **dict(zip(keys, vs)))
    return None


def flatten(tree, prefix: str = "") -> dict:
    """The leaves of ``tree`` by path (``"state.3.0"``, ``"traces.x"``),
    in the tree's own order."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in zip(kids[0], kids[1]):
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(like, flat: dict, prefix: str = ""):
    """``like`` with each leaf replaced by ``flat``'s at its path."""
    kids = _children(like)
    if kids is None:
        return flat[prefix]
    keys, values, rebuild = kids
    return rebuild([unflatten(v, flat, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in zip(keys, values)])


def leaves(tree) -> list:
    return list(flatten(tree).values())


def map(fn: Callable, *trees) -> Any:           # noqa: A001
    """``fn`` applied to the tensor leaves of ``trees`` (one structure),
    leaf by leaf; every other leaf is the first tree's."""
    flats = [flatten(t) for t in trees]
    out = {k: (fn(*(f[k] for f in flats)) if torch.is_tensor(v) else v)
           for k, v in flats[0].items()}
    return unflatten(trees[0], out)
