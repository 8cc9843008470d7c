"""Raceline CSV IO (numpy only; ``fsae_mpc_tpu.utils.io`` without its
native fast path)."""

from __future__ import annotations

import numpy as np

_COLUMNS = ["x", "y", "vx", "vy", "ax", "ay", "dt", "rx", "ry", "lx", "ly"]


def read_raceline_csv(path: str) -> dict:
    """Read a raceline CSV into a dict of float64 column vectors.

    Columns: centreline X,Y, velocity vX,vY, accel aX,aY, segment dt, and
    right/left cone lines rX,rY,lX,lY.
    """
    data = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)
    if data.ndim != 2 or data.shape[1] < len(_COLUMNS):
        raise ValueError(f"bad raceline CSV {path}: shape {data.shape}")
    return {name: np.ascontiguousarray(data[:, i])
            for i, name in enumerate(_COLUMNS)}
