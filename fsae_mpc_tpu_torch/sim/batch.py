"""Batched / sharded lap simulation: the scenario-sweep entry point (port
of ``fsae_mpc_tpu.sim.batch``).

The JAX package vmaps its per-instance simulator over perturbed vehicles
and initial states.  The port's :func:`sim.closed_loop.simulate` is batch
first already and takes per-instance vehicle parameters and tracks, so a
sweep is one call: :func:`perturbed_params` draws the vehicles, a batched
``Track`` (``track.stack_tracks``) gives each instance its track, and
:func:`simulate_batch` runs them, on one device or split over a mesh
(``parallel.mesh``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import VehicleParams
from ..parallel import mesh as pm
from .closed_loop import SimConfig, simulate

_PERTURBED = ("m", "Iz", "pD")


def perturbed_params(base: VehicleParams, generator: torch.Generator,
                     batch: int, rel_sigma: float = 0.02,
                     dtype=torch.float32, device="cuda") -> VehicleParams:
    """A batch of vehicles: mass, yaw inertia and tyre grip (``m``,
    ``Iz``, ``pD``, drawn in that order from ``generator``) each times
    ``exp(rel_sigma * N(0, 1))``, every other field of ``base`` repeated;
    (B,) tensors on ``device``.  The draws are made on the generator's
    device (``torch.Generator("cuda")`` on the card): the streams are
    torch's, not ``jax.random``'s."""
    def field(name):
        val = float(getattr(base, name))
        if name not in _PERTURBED:
            return torch.full((batch,), val, dtype=dtype, device=device)
        z = torch.randn((batch,), generator=generator, dtype=dtype,
                        device=generator.device)
        return val * torch.exp(rel_sigma * z).to(device)

    return VehicleParams(**{f.name: field(f.name)
                            for f in dataclasses.fields(VehicleParams)})


def _batch_size(params: VehicleParams, track) -> int:
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if torch.is_tensor(v) and v.ndim:
            return v.shape[0]
    if track.batched:
        return track.px.shape[0]
    raise ValueError("nothing here is per instance: pass x_init_batch")


def simulate_batch(track, params_batch: VehicleParams, cfg: SimConfig,
                   x_init_batch=None, mesh=None):
    """:func:`simulate` of a scenario batch: per-instance ``params_batch``
    (and ``track``, when batched), from ``x_init_batch`` (B, 7) (default:
    every instance at rest at the origin).  With a ``mesh`` the batch is
    split into one shard per entry (``parallel.mesh.sharded_batch_apply``)
    and the outputs come back on the mesh's first device."""
    if x_init_batch is None:
        x_init_batch = torch.zeros((_batch_size(params_batch, track), 7),
                                   dtype=track.px.dtype,
                                   device=track.px.device)
    if mesh is None:
        return simulate(track, params_batch, cfg, x_init_batch)
    fn = lambda p, x, t: simulate(t, p, cfg, x)
    batched = (params_batch, x_init_batch)
    if track.batched:
        return pm.sharded_batch_apply(fn, mesh, batched + (track,))
    return pm.sharded_batch_apply(fn, mesh, batched, (track,))
