"""Per-instance data under ``torch.func.vmap``.

The models, constraint rows and steppers are written per instance and
batched with ``vmap`` over the leading (B, N, ...) dimensions of the
linearisation points.  ``vmap`` maps its arguments, not what a function
captures, so per-instance data -- a ``VehicleParams`` with (B,) fields, a
batched ``Track`` -- enters as mapped arguments: :func:`vmap_instances`
passes each data object's fields to the outermost ``vmap`` (the batch
axis) with in-dim 0 where the object holds one value per instance and
None where the batch shares it (``instance_dims``), and rebuilds the
objects inside, where each instance sees its own values.  Data that the
whole batch shares is captured as it is, so that path computes what it
computed before data could be per instance.
"""

from __future__ import annotations

import dataclasses

from torch.func import vmap


def is_per_instance(data) -> bool:
    """Whether any of the data objects holds a value per instance."""
    return any(d is not None for obj in data for d in obj.instance_dims())


def vmap_instances(fn, args, levels: int, data=()):
    """``fn(*args_i, *data_i)`` at every index i of the ``levels`` leading
    dimensions of the tensors ``args``, stacked.

    ``data``: objects with ``instance_dims()`` (``VehicleParams``,
    ``Track``).  The first of the ``levels`` dimensions is the batch, the
    one a per-instance field maps over; the others (the horizon's stages)
    share their instance's data.
    """
    if not is_per_instance(data):
        g = lambda *a: fn(*a, *data)
        for _ in range(levels):
            g = vmap(g)
        return g(*args)
    if levels < 1:
        raise ValueError("per-instance data needs a batch dimension")
    names = [[f.name for f in dataclasses.fields(obj)] for obj in data]
    flat = [getattr(obj, n) for obj, ns in zip(data, names) for n in ns]
    dims = tuple(d for obj in data for d in obj.instance_dims())
    n_args = len(args)

    def rebuild(values):
        out, k = [], 0
        for obj, ns in zip(data, names):
            out.append(dataclasses.replace(
                obj, **dict(zip(ns, values[k:k + len(ns)]))))
            k += len(ns)
        return out

    g = lambda *a: fn(*a[:n_args], *rebuild(a[n_args:]))
    for _ in range(levels - 1):
        g = vmap(g, in_dims=(0,) * n_args + (None,) * len(flat))
    g = vmap(g, in_dims=(0,) * n_args + dims)
    return g(*args, *flat)
