"""Native (C++) runtime components, loaded through ctypes (port of
``fsae_mpc_tpu.runtime``).

A Goldfarb-Idnani active-set QP solver in f64, an oracle for the dense
IPM that shares none of its code, and a CSV reader.  The sources under
``runtime/native/`` are built with ``g++`` at first use into
``fsae_mpc_tpu_torch/build/`` (listed in ``.gitignore``); nothing is
built at import.
"""

from . import native_lib
from .native_lib import (load_native, native_available, qp_solve_activeset,
                         read_matrix)
