"""Checkpoint / resume for long batched simulation campaigns (port of
``fsae_mpc_tpu.sim.checkpoint``).

The JAX package persists pytrees with orbax.  Here a tree (a sim carry,
batched metrics, a solver result: tensors inside tuples, dicts and
dataclasses) is flattened to a dict of tensors and plain numbers keyed by
path (``utils.tree``) and written with ``torch.save``.  ``torch.load``
reads it back with its default ``weights_only=True``, which refuses
arbitrary classes, so no class is ever stored: :func:`restore` takes the
structure from ``like`` and each tensor's device from its counterpart
there.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch

from ..utils import tree as tree_util

_SCALARS = (bool, int, float, str, type(None))


def chunk_path(ckpt_dir: str, k: int) -> str:
    """The file :func:`run_chunked` writes after chunk ``k``."""
    return os.path.join(ckpt_dir, f"chunk_{k:05d}.pt")


def save(path: str, tree: Any) -> str:
    """Save ``tree`` to ``path`` (overwrites; the file appears whole or
    not at all).  Tensors are stored on the CPU."""
    flat = {}
    for k, v in tree_util.flatten(tree).items():
        if torch.is_tensor(v):
            # a copy of its own: torch.save writes a view's whole storage
            flat[k] = (v.detach().clone() if v.device.type == "cpu"
                       else v.detach().cpu())
        elif isinstance(v, _SCALARS):
            flat[k] = v
        else:
            raise TypeError(f"cannot checkpoint leaf {k!r} of type "
                            f"{type(v).__name__}")
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str, like: Any):
    """Restore a checkpoint in the structure of ``like``: the same
    containers and leaf paths, each tensor of the same dtype and rank (its
    extent is the file's: a sim carry's traces grow chunk by chunk), put
    on the device of its counterpart in ``like``."""
    flat = torch.load(os.path.abspath(path), map_location="cpu")
    ref = tree_util.flatten(like)
    if flat.keys() != ref.keys():
        raise ValueError(f"{path}: leaves {sorted(set(flat) ^ set(ref))} "
                         "differ from the structure given")
    out = {}
    for k, r in ref.items():
        v = flat[k]
        if torch.is_tensor(r):
            if not (torch.is_tensor(v) and v.dtype == r.dtype
                    and v.ndim == r.ndim):
                raise ValueError(f"{path}: leaf {k!r} is not a "
                                 f"{r.ndim}-d {r.dtype} tensor")
            v = v.to(r.device)
        out[k] = v
    return tree_util.unflatten(like, out)


def run_chunked(step_fn: Callable, carry, n_chunks: int,
                ckpt_dir: str | None = None, start_chunk: int = 0):
    """Run ``carry = step_fn(carry)`` for chunks ``start_chunk`` to
    ``n_chunks - 1``, checkpointing the carry after each into
    :func:`chunk_path` ``(ckpt_dir, k)``.

    Resume by passing ``start_chunk`` = the index of the first chunk still
    to run and the carry restored from the chunk before it.
    """
    for k in range(start_chunk, n_chunks):
        carry = step_fn(carry)
        if ckpt_dir is not None:
            save(chunk_path(ckpt_dir, k), carry)
    return carry
