"""Carry data across from the JAX package, given as numpy arrays.

The JAX package's containers are plain dataclasses of arrays; pass their
fields as a mapping of numpy arrays (``{f: np.asarray(getattr(obj, f))}``
or ``dataclasses.asdict``) and get the port's counterpart on a device, in
a dtype (by default on the CUDA device, like every entry point of the
port: a caller without a card asks for ``device="cpu"``).  Batched JAX
data (``vmap`` outputs) already has the port's batch-first layout.
Nothing here imports ``jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import MPCParams, VehicleParams
from .ops.ipm import IpmResult
from .ops.riccati import StageIpmResult, StageQP
from .track.track import Track


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _fields(cls, src: Mapping, dtype, device):
    return cls(**{f.name: _tensor(src[f.name], dtype, device)
                  for f in dataclasses.fields(cls)})


def track(px, py, dl, L, dtype=torch.float64, device="cuda") -> Track:
    """Track coefficients ``(px (M, 4), py (M, 4), dl, L)``."""
    return Track(px=_tensor(px, dtype, device), py=_tensor(py, dtype, device),
                 dl=_tensor(dl, dtype, device), L=_tensor(L, dtype, device))


def vehicle_params(src: Mapping) -> VehicleParams:
    return VehicleParams(**{f.name: float(np.asarray(src[f.name]))
                            for f in dataclasses.fields(VehicleParams)})


def mpc_params(src: Mapping) -> MPCParams:
    return MPCParams(**{f.name: type(f.default)(np.asarray(src[f.name]))
                        for f in dataclasses.fields(MPCParams)})


def stage_qp(src: Mapping, dtype=torch.float64, device="cuda") -> StageQP:
    """A (batched) ``fsae_mpc_tpu.ops.riccati.StageQP``."""
    return _fields(StageQP, src, dtype, device)


def stage_ipm_result(src: Mapping, dtype=torch.float64,
                     device="cuda") -> StageIpmResult:
    """A (batched) ``StageIpmResult`` -- the solver state one tick hands to
    the next as its warm start."""
    return _fields(StageIpmResult, src, dtype, device)


def ipm_result(src: Mapping, dtype=torch.float64,
               device="cuda") -> IpmResult:
    """A (batched) ``fsae_mpc_tpu.ops.ipm.IpmResult`` -- the dense
    solver's state one tick hands to the next as its warm start."""
    return _fields(IpmResult, src, dtype, device)


def to_numpy(obj) -> dict:
    """The port's dataclass of tensors as a dict of numpy arrays."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
