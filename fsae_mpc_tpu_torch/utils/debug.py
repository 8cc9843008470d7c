"""Numerical-debugging helpers (port of ``fsae_mpc_tpu.utils.debug``): NaN
tracing, finiteness of a result tree, and a cross-shard determinism
check."""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import tree as tree_util


def _has_nan(t) -> bool:
    return (torch.is_tensor(t) and t.is_floating_point()
            and bool(torch.isnan(t).any()))


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # an uninitialised buffer may hold any bits: not a result
        if not func.__name__.startswith(("empty", "new_empty")):
            if any(_has_nan(t) for t in tree_util.leaves(out)):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_checking():
    """Raise ``FloatingPointError`` at the first operation inside the
    block whose floating-point output holds a NaN (``jax_debug_nans``'
    meaning; ``torch.autograd.detect_anomaly`` watches only the backward
    pass).  Every operation is checked as it runs, and on the card each
    check waits for the card: for debugging only."""
    with _NanCheck():
        yield


def assert_finite(tree, name: str = "tree"):
    """Raise ``FloatingPointError`` naming every floating-point tensor leaf
    of ``tree`` that holds a NaN or an infinity."""
    bad = [path for path, leaf in tree_util.flatten(tree).items()
           if torch.is_tensor(leaf) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")


def _deviation(a, b):
    """Per instance, max |a - b| over its elements (float64, (B,)): equal
    values (infinities too) and NaNs in the same places count 0, a NaN
    against a number infinite."""
    a, b = a.double(), b.to(a.device).double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, 0.0, (a - b).abs())
    d = torch.nan_to_num(d, nan=float("inf"))
    return d.reshape(d.shape[0], -1).amax(1)


def check_shard_determinism(fn, args_batch, mesh):
    """The deviation between ``fn(*args_batch)`` on the whole batch and the
    same batch split over ``mesh`` (``parallel.mesh.sharded_batch_apply``),
    leaf by leaf of the output: each instance's largest deviation, a (B,)
    float64 tensor (``.max()`` is the JAX package's figure).  The
    deterministic data-parallel check: shards are solved as smaller
    batches, so agreement is to floating-point tolerance, not necessarily
    bitwise (on the card, a batched product's per-matrix result can depend
    on its place in the batch)."""
    from ..parallel import mesh as pm

    whole = fn(*args_batch)
    sharded = pm.sharded_batch_apply(fn, mesh, args_batch)
    return tree_util.map(_deviation, whole, sharded)
