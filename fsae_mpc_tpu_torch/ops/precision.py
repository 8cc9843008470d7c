"""True-f32 matmul precision and double-f32 error-free transforms (port of
``fsae_mpc_tpu.ops.precision``).

The KKT products mix magnitudes up to the soft-constraint weights and the
condensing products compound over the horizon, so reduced-precision
matmuls (bf16 passes on a TPU, TF32 on an NVIDIA card) floor the control
accuracy.  :func:`highest` is the counterpart of JAX's
``default_matmul_precision("highest")``: inside it, float32 matmuls and
convolutions run in full float32 -- ``torch.backends.cuda.matmul.
allow_tf32 = False``, ``torch.backends.cudnn.allow_tf32 = False`` and
``torch.set_float32_matmul_precision("highest")`` -- and the previous
settings come back on exit.

The Dekker splits below rely on every product and difference being
rounded on its own.  Eager PyTorch runs each operation as its own kernel,
so nothing contracts them into FMAs; do not put these functions under
``torch.compile`` or into a kernel built with FMA contraction.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def highest_precision():
    """Full-f32 matmuls/convolutions (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def highest(fn):
    """Decorator: run ``fn`` under :func:`highest_precision`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with highest_precision():
            return fn(*args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# double-f32 (error-free transform) helpers
# ---------------------------------------------------------------------------

_SPLIT = 4097.0        # 2**12 + 1: Dekker split constant for f32 (24-bit)


def _split(a):
    """Exact split a = hi + lo with <=12-bit mantissas each."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _dd_add(a, b):
    """Add two double-f32 numbers (hi, lo) -> (hi, lo) (Knuth two-sum)."""
    ah, al = a
    bh, bl = b
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    e = e + (al + bl)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def fma_add(a, b, c):
    """Elementwise ``a * b + c`` to ~double-f32 accuracy (broadcasting):
    Dekker two-product for the rounding error of ``a * b`` plus a Knuth
    two-sum against ``c``."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    p = a * b
    err = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    return s + (e + err)


def residual_affine(M, x, b):
    """``b + M @ x`` to ~double-f32 accuracy, batched over leading dims.

    ``M (..., m, n)``, ``x (..., n)``, ``b (..., m)``; returns ``(hi, lo)``
    of shape (..., m).  The four Dekker-split partial products are exact in
    f32; each row is reduced pairwise in double-f32, in the JAX package's
    column order.
    """
    n = M.shape[-1]
    M1, M2 = _split(M)
    x1, x2 = _split(x)
    x1 = x1.unsqueeze(-2)
    x2 = x2.unsqueeze(-2)
    hi = torch.cat([b.unsqueeze(-1), M1 * x1, M1 * x2, M2 * x1, M2 * x2],
                   dim=-1)                                   # (..., m, 4n+1)
    T = 4 * n + 1
    P = 1 << (T - 1).bit_length()
    hi = torch.nn.functional.pad(hi, (0, P - T))
    lo = torch.zeros_like(hi)
    while P > 1:
        P //= 2
        hi, lo = _dd_add((hi[..., :P], lo[..., :P]), (hi[..., P:], lo[..., P:]))
    return hi[..., 0], lo[..., 0]
