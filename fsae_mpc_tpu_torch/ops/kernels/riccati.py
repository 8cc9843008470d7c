"""Block-Riccati sweeps: hand-written Hopper kernels + their plain versions.

Port of ``fsae_mpc_tpu/ops/pallas/riccati.py``.  Four CUDA kernels in
``csrc/riccati.cu`` carry the stage-wise IPM's KKT solves:

  ==================  ==================================================
  kernel              replaces (TPU Pallas kernel)
  ==================  ==================================================
  assemble_factor     ``assemble_factor_lanes`` / ``_assemble_factor_kernel``
  apply_bwd           ``apply_lanes`` backward sweep / ``_bwd_kernel``
  apply_fwd           ``apply_lanes`` forward sweep / ``_fwd_kernel``
  factor              ``factor_lanes`` / ``_factor_kernel``
  ==================  ==================================================

Each public function here is a dispatcher on batch-first tensors in the
JAX package's layouts (``apply`` takes right-hand sides as (B, K, N, n)):

  * a tensor on the CPU goes to the plain PyTorch version beside it
    (``factor_ref``, ``assemble_factor_ref``, ``apply_ref``: a Python loop
    over stages, the batch written out -- the counterparts of
    ``ops/riccati.py``'s ``_factor_scan``, ``_assemble_factor_scan`` and
    ``_apply_scan`` under ``vmap``);
  * a CUDA tensor goes to the kernel, or the call raises.  Nothing falls
    back from the card to the plain version.

The kernels are built from ``csrc/riccati.cu`` with ``nvcc`` into a plain
C-ABI shared library the first time a kernel is launched (never at import;
``build.py``), and loaded with ``ctypes``.  Every
launch goes onto ``torch.cuda.current_stream()``; outputs are allocated
here with ``torch.empty``.  ``KERNELS[name].launches`` counts the launches
of each kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .build import Kernel, Library, check_tensors, empty, route

SUPPORTED_NX = (5, 7, 9)
SUPPORTED_NS = (1, 4)


# ---------------------------------------------------------------------------
# tiny SPD helpers (static n, unrolled), batched over leading dims
# ---------------------------------------------------------------------------


def _spd_inv_small(A):
    """Inverse of tiny SPD matrices (..., n, n); closed form for n=2,
    unrolled Cholesky otherwise.  A non-positive pivot poisons that
    instance with NaN (the solver's finite-iterate rejection picks it
    up)."""
    n = A.shape[-1]
    if n == 2:
        a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
        det = a * c - b * b
        det = torch.where((det > 0) & (a > 0), det,
                          torch.full_like(det, float("nan")))
        inv = torch.stack([torch.stack([c, -b], -1),
                           torch.stack([-b, a], -1)], -2)
        return inv / det[..., None, None]
    L = _chol_small(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return _cho_solve_small(L, eye)


def _chol_small(A):
    """Unrolled Cholesky of (..., n, n) for static tiny n."""
    n = A.shape[-1]
    rows = [[None] * n for _ in range(n)]
    zero = torch.zeros_like(A[..., 0, 0])
    for j in range(n):
        c = A[..., j, j] - sum((rows[j][k] * rows[j][k] for k in range(j)),
                               start=zero)
        piv = torch.where(c > 0, c, torch.full_like(c, float("nan")))
        d = torch.rsqrt(piv)
        rows[j][j] = c * d
        for i in range(j + 1, n):
            s = A[..., i, j] - sum((rows[i][k] * rows[j][k]
                                    for k in range(j)), start=zero)
            rows[i][j] = s * d
    return torch.stack([torch.stack([rows[i][j] if j <= i else zero
                                     for j in range(n)], -1)
                        for i in range(n)], -2)


def _cho_solve_small(L, B):
    """Solve L L' X = B, unrolled.  ``L`` (..., n, n); ``B`` (..., n) or
    (..., n, m)."""
    n = L.shape[-1]
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    ys = []
    for j in range(n):
        acc = B[..., j, :]
        for k in range(j):
            acc = acc - L[..., j, k, None] * ys[k]
        ys.append(acc / L[..., j, j, None])
    xs = [None] * n
    for j in reversed(range(n)):
        acc = ys[j]
        for k in range(j + 1, n):
            acc = acc - L[..., k, j, None] * xs[k]
        xs[j] = acc / L[..., j, j, None]
    X = torch.stack(xs, -2)
    return X[..., 0] if vec else X


# ---------------------------------------------------------------------------
# plain PyTorch versions (batch-first, Python loop over stages)
# ---------------------------------------------------------------------------


def _t(x):
    return x.transpose(-1, -2)


def factor_ref(Ad, Bd, Qb, Rb, M):
    """Backward block-Riccati factorisation of the equality-constrained
    Newton KKT system with stage quadratics on (x_{k+1}, u_k):

        W_k  = Qb_k + P_{k+1}
        Hu_k = Rb_k + B'W B + B'M + M'B
        G_k  = (B'W + M') A
        P_k  = sym(A'W A - G' Huinv G)        (P_N = 0)

    All inputs (B, N, ...); returns (Huinv (B,N,nu,nu), G (B,N,nu,nx),
    W (B,N,nx,nx))."""
    Bsz, N, nx = Ad.shape[:3]
    P = torch.zeros((Bsz, nx, nx), dtype=Ad.dtype, device=Ad.device)
    Huinv, G, W = [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        A, B, Mk = Ad[:, k], Bd[:, k], M[:, k]
        Wk = Qb[:, k] + P
        WB = Wk @ B
        Hu = Rb[:, k] + _t(B) @ WB + _t(B) @ Mk + _t(Mk) @ B
        Hi = _spd_inv_small(Hu)
        Gk = _t(WB + Mk) @ A
        P = _t(A) @ (Wk @ A) - _t(Gk) @ (Hi @ Gk)
        P = 0.5 * (P + _t(P))
        Huinv[k], G[k], W[k] = Hi, Gk, Wk
    return (torch.stack(Huinv, 1), torch.stack(G, 1), torch.stack(W, 1))


def assemble_factor_ref(C, D, Ws, Dr, qb_diag, rb_diag, Ad, Bd):
    """Quadform assembly + Riccati factorisation: Qb = diag(qb_diag) +
    C'diag(Dr)C, Rb = diag(rb_diag) + D'diag(Dr)D, Mq = C'diag(Dr)D, then
    :func:`factor_ref`; returns (Huinv, G, W, Mq, Lx = C'diag(Dr)Ws,
    Lu = D'diag(Dr)Ws, Hss = Ws'diag(Dr)Ws per stage)."""
    Xq = torch.einsum("bnri,bnr,bnrj->bnij", C, Dr, C)
    Uq = torch.einsum("bnrk,bnr,bnrl->bnkl", D, Dr, D)
    Mq = torch.einsum("bnri,bnr,bnrk->bnik", C, Dr, D)
    Qb = Xq + torch.diag_embed(qb_diag)
    Rb = Uq + torch.diag_embed(rb_diag)
    Huinv, G, W = factor_ref(Ad, Bd, Qb, Rb, Mq)
    Lx = torch.einsum("bnri,bnr,bnrj->bnij", C, Dr, Ws)
    Lu = torch.einsum("bnrk,bnr,bnrj->bnkj", D, Dr, Ws)
    Hss = torch.einsum("bnri,bnr,bnrj->bnij", Ws, Dr, Ws)
    return Huinv, G, W, Mq, Lx, Lu, Hss


def apply_bwd_ref(Huinv, G, W, Ad, Bd, M, rx, ru, re):
    """Backward linear-term sweep of :func:`apply_ref`: w = rx + p,
    h = (re W' - w) B + re M - ru, p <- h Huinv G + (w - re W') A.
    Returns (h (B, K, N, nu), w (B, K, N, nx))."""
    Bsz, K, N, nx = rx.shape
    p = torch.zeros((Bsz, K, nx), dtype=rx.dtype, device=rx.device)
    h_all, w_all = [None] * N, [None] * N
    for k in reversed(range(N)):
        rek = re[:, :, k]
        w = rx[:, :, k] + p
        Wd = rek @ _t(W[:, k])
        h = (Wd - w) @ Bd[:, k] + rek @ M[:, k] - ru[:, :, k]
        Kg = Huinv[:, k] @ G[:, k]
        p = h @ Kg + (w - Wd) @ Ad[:, k]
        h_all[k], w_all[k] = h, w
    return torch.stack(h_all, 2), torch.stack(w_all, 2)


def apply_fwd_ref(Huinv, G, W, Ad, Bd, M, re, h, w):
    """Forward rollout of :func:`apply_ref` from dx_0 = 0:
    du = -(dx G' + h) Huinv', dx <- dx A' + du B' + re,
    dlam = dx W' + du M' - w.  Returns (du, dx, dlam)."""
    Bsz, K, N, nx = re.shape
    dx = torch.zeros((Bsz, K, nx), dtype=re.dtype, device=re.device)
    du_all, dx_all, dl_all = [], [], []
    for k in range(N):
        du = -(dx @ _t(G[:, k]) + h[:, :, k]) @ _t(Huinv[:, k])
        dx = dx @ _t(Ad[:, k]) + du @ _t(Bd[:, k]) + re[:, :, k]
        dlam = dx @ _t(W[:, k]) + du @ _t(M[:, k]) - w[:, :, k]
        du_all.append(du)
        dx_all.append(dx)
        dl_all.append(dlam)
    return (torch.stack(du_all, 2), torch.stack(dx_all, 2),
            torch.stack(dl_all, 2))


def apply_ref(Huinv, G, W, Ad, Bd, M, rx, ru, re):
    """Solve the factored KKT system for K right-hand sides.

    ``rx``/``re`` (B, K, N, nx), ``ru`` (B, K, N, nu): stationarity rhs on
    x_{k+1} and u_k, and the equality rhs (dx_{k+1} = Ad dx_k + Bd du_k +
    re_k with dx_0 = 0).  Returns (du, dx, dlam) in the same layout.
    """
    h, w = apply_bwd_ref(Huinv, G, W, Ad, Bd, M, rx, ru, re)
    return apply_fwd_ref(Huinv, G, W, Ad, Bd, M, re, h, w)


# ---------------------------------------------------------------------------
# the CUDA library: built at first launch (``build.py``), bound with ctypes
# ---------------------------------------------------------------------------


KERNELS = {
    "assemble_factor": Kernel(
        "assemble_factor", "riccati_assemble_factor_f32",
        "fsae_mpc_tpu/ops/pallas/riccati.py:277"),
    "apply_bwd": Kernel(
        "apply_bwd", "riccati_apply_bwd_f32",
        "fsae_mpc_tpu/ops/pallas/riccati.py:386"),
    "apply_fwd": Kernel(
        "apply_fwd", "riccati_apply_fwd_f32",
        "fsae_mpc_tpu/ops/pallas/riccati.py:386"),
    "factor": Kernel(
        "factor", "riccati_factor_f32",
        "fsae_mpc_tpu/ops/pallas/riccati.py:140"),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = Library("riccati.cu", {
    "riccati_factor_f32": [_P] * 8 + [_I] * 3 + [_P],
    "riccati_assemble_factor_f32": [_P] * 15 + [_I] * 5 + [_P],
    "riccati_apply_bwd_f32": [_P] * 11 + [_I] * 4 + [_P],
    "riccati_apply_fwd_f32": [_P] * 12 + [_I] * 4 + [_P],
})


def _check(tensors: dict, shapes: dict, nx: int, ns: int | None = None):
    """Validate what the kernels accept; raise on anything else."""
    check_tensors(tensors, shapes)
    if nx not in SUPPORTED_NX:
        raise ValueError(f"nx={nx} unsupported by the kernels "
                         f"(supported: {SUPPORTED_NX})")
    if ns is not None and ns not in SUPPORTED_NS:
        raise ValueError(f"ns={ns} unsupported by the kernels "
                         f"(supported: {SUPPORTED_NS})")


def _nu_check(nu):
    if nu != 2:
        raise ValueError(f"the kernels take nu == 2, got nu={nu}")


def factor_cuda(Ad, Bd, Qb, Rb, M):
    Bsz, N, nx, nu = Bd.shape
    _nu_check(nu)
    _check(dict(Ad=Ad, Bd=Bd, Qb=Qb, Rb=Rb, M=M),
           dict(Ad=(Bsz, N, nx, nx), Bd=(Bsz, N, nx, nu),
                Qb=(Bsz, N, nx, nx), Rb=(Bsz, N, nu, nu),
                M=(Bsz, N, nx, nu)), nx)
    Huinv, G, W = (empty(Ad, Bsz, N, nu, nu), empty(Ad, Bsz, N, nu, nx),
                   empty(Ad, Bsz, N, nx, nx))
    _LIB.launch(KERNELS["factor"], Ad, Bd, Qb, Rb, M, Huinv, G, W, Bsz, N,
                nx)
    return Huinv, G, W


def assemble_factor_cuda(C, D, Ws, Dr, qb_diag, rb_diag, Ad, Bd):
    Bsz, N, r, nx = C.shape
    nu, ns = D.shape[-1], Ws.shape[-1]
    _nu_check(nu)
    _check(dict(C=C, D=D, Ws=Ws, Dr=Dr, qb_diag=qb_diag, rb_diag=rb_diag,
                Ad=Ad, Bd=Bd),
           dict(C=(Bsz, N, r, nx), D=(Bsz, N, r, nu), Ws=(Bsz, N, r, ns),
                Dr=(Bsz, N, r), qb_diag=(Bsz, N, nx), rb_diag=(Bsz, N, nu),
                Ad=(Bsz, N, nx, nx), Bd=(Bsz, N, nx, nu)), nx, ns)
    outs = (empty(C, Bsz, N, nu, nu), empty(C, Bsz, N, nu, nx),
            empty(C, Bsz, N, nx, nx), empty(C, Bsz, N, nx, nu),
            empty(C, Bsz, N, nx, ns), empty(C, Bsz, N, nu, ns),
            empty(C, Bsz, N, ns, ns))
    _LIB.launch(KERNELS["assemble_factor"], C, D, Ws, Dr, qb_diag, rb_diag,
                Ad, Bd, *outs, Bsz, N, r, nx, ns)
    return outs


def _apply_shapes(Huinv, G, W, Ad, Bd, M, **rhs):
    Bsz, N, nx, nu = Bd.shape
    _nu_check(nu)
    K = next(iter(rhs.values())).shape[1]
    shapes = dict(Huinv=(Bsz, N, nu, nu), G=(Bsz, N, nu, nx),
                  W=(Bsz, N, nx, nx), Ad=(Bsz, N, nx, nx),
                  Bd=(Bsz, N, nx, nu), M=(Bsz, N, nx, nu))
    shapes.update({k: (Bsz, K, N, nu if k in ("ru", "h") else nx)
                   for k in rhs})
    _check(dict(Huinv=Huinv, G=G, W=W, Ad=Ad, Bd=Bd, M=M, **rhs), shapes,
           nx)
    return Bsz, K, N, nx, nu


def apply_bwd_cuda(Huinv, G, W, Ad, Bd, M, rx, ru, re):
    Bsz, K, N, nx, nu = _apply_shapes(Huinv, G, W, Ad, Bd, M, rx=rx, ru=ru,
                                      re=re)
    h, w = empty(rx, Bsz, K, N, nu), empty(rx, Bsz, K, N, nx)
    _LIB.launch(KERNELS["apply_bwd"], Huinv, G, W, Ad, Bd, M, rx, ru, re, h,
                w, Bsz, K, N, nx)
    return h, w


def apply_fwd_cuda(Huinv, G, W, Ad, Bd, M, re, h, w):
    Bsz, K, N, nx, nu = _apply_shapes(Huinv, G, W, Ad, Bd, M, re=re, h=h,
                                      w=w)
    du, dx, dlam = (empty(re, Bsz, K, N, nu), empty(re, Bsz, K, N, nx),
                    empty(re, Bsz, K, N, nx))
    _LIB.launch(KERNELS["apply_fwd"], Huinv, G, W, Ad, Bd, M, re, h, w, du,
                dx, dlam, Bsz, K, N, nx)
    return du, dx, dlam


def apply_cuda(Huinv, G, W, Ad, Bd, M, rx, ru, re):
    h, w = apply_bwd_cuda(Huinv, G, W, Ad, Bd, M, rx, ru, re)
    return apply_fwd_cuda(Huinv, G, W, Ad, Bd, M, re, h, w)


# ---------------------------------------------------------------------------
# dispatchers: CPU tensor -> plain version, CUDA tensor -> kernel or raise
# ---------------------------------------------------------------------------


def factor(Ad, Bd, Qb, Rb, M):
    if route(Ad, "Riccati") == "ref":
        return factor_ref(Ad, Bd, Qb, Rb, M)
    return factor_cuda(Ad, Bd, Qb, Rb, M)


def assemble_factor(C, D, Ws, Dr, qb_diag, rb_diag, Ad, Bd):
    if route(C, "Riccati") == "ref":
        return assemble_factor_ref(C, D, Ws, Dr, qb_diag, rb_diag, Ad, Bd)
    return assemble_factor_cuda(C, D, Ws, Dr, qb_diag, rb_diag, Ad, Bd)


def apply(Huinv, G, W, Ad, Bd, M, rx, ru, re):
    if route(rx, "Riccati") == "ref":
        return apply_ref(Huinv, G, W, Ad, Bd, M, rx, ru, re)
    return apply_cuda(Huinv, G, W, Ad, Bd, M, rx, ru, re)
