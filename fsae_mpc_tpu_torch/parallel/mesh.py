"""Device mesh + sharded batched solving (port of
``fsae_mpc_tpu.parallel.mesh``).

The scaling model is the JAX package's: the scenario batch is the
parallel axis, split into contiguous shards, one per entry of the mesh;
the solves never communicate, and only metric summaries are reduced
across shards.  The port's functions are batch-first, so a shard is
passed to them as it is, and the shards run one after another from this
process, each on its device (on the card, each shard's work is queued
without waiting for the previous one's).  A mesh is an ordered list of
``torch.device``s; a device may repeat, which splits one card's batch
into shards.  Several processes (one per host or card) join through
:func:`initialize_distributed`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..utils import tree as tree_util


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The mesh: ``devices`` (default: every CUDA device), the first
    ``n_devices`` of them when given.  Without a card and without
    ``devices`` it raises: a mesh on the CPU is asked for
    (``devices=["cpu"] * 4``)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"n_devices={n_devices} but only "
                             f"{len(devices)} devices were given")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no CUDA device: pass devices=[...] (e.g. "
                         "['cpu'] * 4) for a mesh on the CPU")
    return devices


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Join a multi-process run (no-op when single-process): NCCL, with
    the coordinator's address (``"tcp://host:port"``), the world size and
    this process's rank given explicitly."""
    if num_processes is None or num_processes <= 1:
        return
    torch.distributed.init_process_group(
        "nccl", init_method=coordinator, world_size=num_processes,
        rank=process_id)


def shard_batch(tree: Any, mesh) -> list:
    """``tree``'s tensor leaves split along their first (batch) axis into
    ``len(mesh)`` contiguous shards, shard k on ``mesh[k]``: a list of
    trees.  Every tensor leaf must carry the batch axis (pass what the
    shards share to :func:`replicate`); other leaves are shared."""
    flat = tree_util.flatten(tree)
    parts = {k: torch.tensor_split(v, len(mesh)) for k, v in flat.items()
             if torch.is_tensor(v)}
    return [tree_util.unflatten(tree, {
        k: (parts[k][i].to(dev) if k in parts else v)
        for k, v in flat.items()}) for i, dev in enumerate(mesh)]


def replicate(tree: Any, mesh) -> list:
    """One copy of ``tree`` on each device of the mesh."""
    return [tree_util.map(lambda t: t.to(dev), tree) for dev in mesh]


def sharded_batch_apply(fn: Callable, mesh, batched_args: Any,
                        replicated_args: Any = ()):
    """``fn(*batched_shard, *replicated_args)`` shard by shard, each on
    its device, the outputs concatenated along the batch axis on
    ``mesh[0]``.  ``fn`` is batch-first: it takes a shard of every
    batched argument as it is."""
    shards = shard_batch(tuple(batched_args), mesh)
    reps = replicate(tuple(replicated_args), mesh)
    outs = [fn(*s, *r) for s, r in zip(shards, reps)]
    return tree_util.map(lambda *ts: torch.cat([t.to(mesh[0]) for t in ts]),
                         *outs)


def _sum0(t):
    if not t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    return t.sum(0)


def pmean_metrics(metrics: Any, mesh):
    """The global mean over the batch of per-scenario metrics (B, ...):
    each shard's sum on its device, the sums gathered and divided on
    ``mesh[0]``.  Booleans and counts average in the default float
    dtype."""
    sums = [tree_util.map(_sum0, s) for s in shard_batch(metrics, mesh)]
    return tree_util.map(
        lambda t, *ps: sum(p.to(mesh[0]) for p in ps) / t.shape[0],
        metrics, *sums)
