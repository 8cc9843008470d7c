"""Carry data across from the JAX package, given as numpy arrays.

The JAX package's containers are plain dataclasses of arrays; pass their
fields as a mapping of numpy arrays (``{f: np.asarray(getattr(obj, f))}``
or ``dataclasses.asdict``) and get the port's counterpart on a device, in
a dtype.  By default the data goes to the CUDA device, like every entry
point of the port (a caller without a card asks for ``device="cpu"``),
and its dtype follows the device (:func:`default_dtype`): float32 on the
card, whose kernels take nothing else, float64 on the CPU, where the
plain versions run the JAX package's f64 reference.  Batched JAX data
(``vmap`` outputs) already has the port's batch-first layout.  Nothing
here imports ``jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import MPCParams, VehicleParams
from .ops.ipm import IpmOptions, IpmResult
from .ops.riccati import StageIpmResult, StageQP
from .ops.structured import GenRows
from .planner.min_time import PlannerResult
from .sim.closed_loop import SimConfig, SimOutputs
from .track.track import Track


def default_dtype(device) -> torch.dtype:
    """The dtype a converter picks when given none: float32 on a CUDA
    device, float64 anywhere else."""
    return (torch.float32 if torch.device(device).type == "cuda"
            else torch.float64)


def _tensor(a, dtype, device):
    if dtype is None:
        dtype = default_dtype(device)
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _fields(cls, src: Mapping, dtype, device):
    return cls(**{f.name: _tensor(src[f.name], dtype, device)
                  for f in dataclasses.fields(cls)})


def track(px, py, dl, L, dtype=None, device="cuda") -> Track:
    """Track coefficients ``(px (M, 4), py (M, 4), dl, L)``, or a stacked
    batch of tracks (px, py (B, M, 4), dl and L (B,))."""
    return Track(px=_tensor(px, dtype, device), py=_tensor(py, dtype, device),
                 dl=_tensor(dl, dtype, device), L=_tensor(L, dtype, device))


def vehicle_params(src: Mapping, dtype=None, device="cuda") -> VehicleParams:
    """Vehicle parameters: a 0-d field as a Python float (shared by the
    batch), a (B,) field (``perturbed_params``) as a tensor."""
    def field(a):
        a = np.asarray(a)
        return float(a) if a.ndim == 0 else _tensor(a, dtype, device)

    return VehicleParams(**{f.name: field(src[f.name])
                            for f in dataclasses.fields(VehicleParams)})


def mpc_params(src: Mapping) -> MPCParams:
    return MPCParams(**{f.name: type(f.default)(np.asarray(src[f.name]))
                        for f in dataclasses.fields(MPCParams)})


def ipm_options(src: Mapping) -> IpmOptions:
    return IpmOptions(**{f.name: src[f.name]
                         for f in dataclasses.fields(IpmOptions)})


def sim_config(src: Mapping) -> SimConfig:
    """A ``fsae_mpc_tpu.sim.closed_loop.SimConfig`` given by its fields
    (``dataclasses.asdict``: ``mpc`` and ``ipm`` as mappings too)."""
    kw = {f.name: src[f.name] for f in dataclasses.fields(SimConfig)}
    kw.update(mpc=mpc_params(src["mpc"]), ipm=ipm_options(src["ipm"]))
    return SimConfig(**kw)


def sim_outputs(src: Mapping, dtype=None, device="cuda") -> SimOutputs:
    """A (batched: traces (B, T, ...), summaries (B,)) ``SimOutputs``;
    boolean and integer fields keep their kind."""
    return _fields(SimOutputs, src, dtype, device)


def stage_qp(src: Mapping, dtype=None, device="cuda") -> StageQP:
    """A (batched) ``fsae_mpc_tpu.ops.riccati.StageQP``."""
    return _fields(StageQP, src, dtype, device)


def stage_ipm_result(src: Mapping, dtype=None,
                     device="cuda") -> StageIpmResult:
    """A (batched) ``StageIpmResult`` -- the solver state one tick hands to
    the next as its warm start."""
    return _fields(StageIpmResult, src, dtype, device)


def ipm_result(src: Mapping, dtype=None,
               device="cuda") -> IpmResult:
    """A (batched) ``fsae_mpc_tpu.ops.ipm.IpmResult`` -- the dense
    solver's state one tick hands to the next as its warm start."""
    return _fields(IpmResult, src, dtype, device)


def gen_rows(src: Mapping, dtype=None, device="cuda") -> GenRows:
    """A (batched) ``fsae_mpc_tpu.ops.structured.GenRows``: the
    generator-factored constraint matrix of ``build_qp_dynamic(...,
    structured="gen")``, fields Ag (B, S, G, n), W (B, S, R, G) and
    Ws (B, S, R, ns)."""
    return _fields(GenRows, src, dtype, device)


def planner_result(src: Mapping, dtype=torch.float64,
                   device="cuda") -> PlannerResult:
    """A ``fsae_mpc_tpu.planner.PlannerResult``.  The plan stays float64
    on any device by default: the planners run in f64 and the closed loop
    resamples the plan in its own dtype (``reference="raceline"``)."""
    return _fields(PlannerResult, src, dtype, device)


def to_numpy(obj) -> dict:
    """The port's dataclass of tensors as a dict of numpy arrays."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
