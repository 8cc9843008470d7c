"""Fused horizon condensing: a hand-written Hopper kernel + its plain
version.

Port of ``fsae_mpc_tpu/ops/pallas/condense.py``: ``condense_lanes``
(``_condense_kernel``) becomes ``condense_f32`` in ``csrc/condense.cu``.
:func:`condense` dispatches on batch-first tensors in the layouts of
``ops/condense.py:condense``:

  * a tensor on the CPU goes to the plain version, ``ops/condense.py``'s
    loop over stages (:data:`condense_ref`);
  * a CUDA tensor goes to the kernel, or the call raises.  Nothing falls
    back from the card to the plain version.

The kernel is built with ``nvcc`` at its first launch (``build.py``) and
launched on ``torch.cuda.current_stream()``; ``KERNELS["condense"]``
counts its launches.
"""

from __future__ import annotations

import ctypes

from ..condense import condense as condense_ref
from .build import Kernel, Library, check_tensors, empty, route

SUPPORTED_NX = (5, 7)

KERNELS = {
    "condense": Kernel("condense", "condense_f32",
                       "fsae_mpc_tpu/ops/pallas/condense.py:112"),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = Library("condense.cu", {"condense_f32": [_P] * 6 + [_I] * 4 + [_P]})


def condense_cuda(Ad, Bd, dd):
    """The kernel: (A_bar, B_bar, d_bar) as :data:`condense_ref` returns
    them, for float32 CUDA tensors with nx in :data:`SUPPORTED_NX`."""
    Bsz, N, nx, nu = Bd.shape
    check_tensors(dict(Ad=Ad, Bd=Bd, dd=dd),
                  dict(Ad=(Bsz, N, nx, nx), Bd=(Bsz, N, nx, nu),
                       dd=(Bsz, N, nx)))
    if nx not in SUPPORTED_NX:
        raise ValueError(f"nx={nx} unsupported by the kernel (supported: "
                         f"{SUPPORTED_NX})")
    A_bar, B_bar, d_bar = (empty(Ad, Bsz, N, nx, nx),
                           empty(Ad, Bsz, N, nx, N * nu),
                           empty(Ad, Bsz, N, nx))
    _LIB.launch(KERNELS["condense"], Ad, Bd, dd, A_bar, B_bar, d_bar, Bsz,
                N, nx, nu)
    return A_bar, B_bar, d_bar


def condense(Ad, Bd, dd):
    if route(Ad, "condense") == "ref":
        return condense_ref(Ad, Bd, dd)
    return condense_cuda(Ad, Bd, dd)
