"""Generator-factored constraint matrix of the condensed MPC QP (port of
``fsae_mpc_tpu.ops.structured``).

The dynamic LTV QP has 800 general rows (20 a stage at N=40,
``dynamic_state_constraints.m``, ``dynamic_tyre_linearise_constraints.m:18``),
but every stage's rows are static combinations of a small per-stage
generator basis.  :class:`GenRows` stores that factorisation and stands in
for the dense A wherever ``ops.ipm.solve_qp`` needs it: matvec, rmatvec,
quadform, row norms, row and column scaling, and the compensated
(error-free-transform) products.  Every field carries a leading batch
dimension B, and ``shape`` is the dense A's, (B, S*R, n).
"""

from __future__ import annotations

import dataclasses

import torch

from .precision import _dd_add, _split, highest, residual_affine


def _dd_contract_g(W, T_hi, T_lo):
    """Compensated contraction sum_g W[..., g] * (T_hi + T_lo)[..., g] over
    the short generator axis: Dekker two-products accumulated in double-f32,
    g by g in the JAX package's order.  W (B, S, R, G); T_* (B, S, G),
    broadcast over R.  Returns (hi, lo) (B, S, R)."""
    acc = (torch.zeros(W.shape[:-1], dtype=W.dtype, device=W.device),
           torch.zeros(W.shape[:-1], dtype=W.dtype, device=W.device))
    for g in range(W.shape[-1]):
        w = W[..., g]
        t = T_hi[:, :, None, g]
        p = w * t
        w1, w2 = _split(w)
        t1, t2 = _split(t)
        e = ((w1 * t1 - p) + w1 * t2 + w2 * t1) + w2 * t2
        if T_lo is not None:
            e = e + w * T_lo[:, :, None, g]
        acc = _dd_add(acc, (p, e))
    return acc


def is_structured(A) -> bool:
    return isinstance(A, GenRows)


@dataclasses.dataclass(frozen=True)
class GenRows:
    """Generator-factored constraint matrix, batch first.

    Every stage's R emitted rows are static combinations of G << R
    per-stage generator rows already expressed in the full variable space
    (for the dynamic LTV QP G = 7: track offset, the v and delta boxes,
    two slip gradients, the friction-ellipse force gradient and the
    stage's own-control direction, against R = 20 emitted rows, of which
    the 12-gon contributes 12 combinations of two generators and every
    soft two-sided pair is a duplicate).  Row (s, r) of instance b:

        a_{b,s,r} = W[b, s, r, :] @ Ag[b, s]  +  Ws[b, s, r, :] @ E_sigma

    with ``E_sigma`` the static slack-column basis.  The hot products are
    batched matmuls on the (S*G, n) generators instead of the (S*R, n)
    rows: 40*7*84*4 = 94 KB against 800*84*4 = 269 KB an instance in f32
    at the reference shape.

    Rows are ordered stage-major ((s, r) flattened); the bounds of the
    matching assembly carry the same order.
    """

    Ag: torch.Tensor    # (B, S, G, n)  generator rows (slack columns zero)
    W: torch.Tensor     # (B, S, R, G)  row coefficients over the generators
                        #               (may be an expanded view of one
                        #               (S, R, G) constant)
    Ws: torch.Tensor    # (B, S, R, ns) row coefficients over the slacks

    @property
    def shape(self):
        Bsz, S, R, _ = self.W.shape
        return (Bsz, S * R, self.Ag.shape[-1])

    @property
    def dtype(self):
        return self.Ag.dtype

    @property
    def device(self):
        return self.Ag.device

    def _dims(self):
        Bsz, S, R, G = self.W.shape
        return Bsz, S, R, G, self.Ws.shape[-1], self.Ag.shape[-1]

    def to(self, device=None, dtype=None) -> "GenRows":
        return self.map(lambda t: t.to(device=device, dtype=dtype))

    def map(self, fn) -> "GenRows":
        """``fn`` applied to each field."""
        return GenRows(Ag=fn(self.Ag), W=fn(self.W), Ws=fn(self.Ws))

    # ---- products ---------------------------------------------------------

    @highest
    def matvec(self, x):
        """A @ x -> (B, m), stage-major."""
        Bsz, S, R, G, ns, n = self._dims()
        t = torch.einsum("bsgn,bn->bsg", self.Ag, x)
        y = (torch.einsum("bsrg,bsg->bsr", self.W, t)
             + torch.einsum("bsrj,bj->bsr", self.Ws, x[:, n - ns:]))
        return y.reshape(Bsz, S * R)

    @highest
    def rmatvec(self, z):
        """A' @ z -> (B, n)."""
        Bsz, S, R, G, ns, n = self._dims()
        zs = z.reshape(Bsz, S, R)
        c = torch.einsum("bsrg,bsr->bsg", self.W, zs)
        out = torch.einsum("bsgn,bsg->bn", self.Ag, c)
        s_part = torch.einsum("bsrj,bsr->bj", self.Ws, zs)
        return torch.cat([out[:, :n - ns], out[:, n - ns:] + s_part], 1)

    @highest
    def quadform(self, d):
        """A' diag(d) A -> (B, n, n) through the (S*G, n) generators."""
        Bsz, S, R, G, ns, n = self._dims()
        ds = d.reshape(Bsz, S, R)
        Wd = self.W * ds[..., None]                           # (B, S, R, G)
        Mgg = torch.einsum("bsrg,bsrh->bsgh", Wd, self.W)     # (B, S, G, G)
        P = (Mgg @ self.Ag).reshape(Bsz, S * G, n)
        K = self.Ag.reshape(Bsz, S * G, n).mT @ P             # (B, n, n)
        if ns:
            Mgs = torch.einsum("bsrg,bsrj->bsgj", Wd, self.Ws)
            Ks = torch.einsum("bsgn,bsgj->bnj", self.Ag, Mgs)  # (B, n, ns)
            Mss = torch.einsum("bsrj,bsrl->bjl", self.Ws * ds[..., None],
                               self.Ws)
            K[:, :, n - ns:] += Ks
            K[:, n - ns:, :] += Ks.mT
            K[:, n - ns:, n - ns:] += Mss
        return K

    # ---- compensated (double-f32) products --------------------------------

    @highest
    def rmatvec_compensated(self, z, base):
        """(hi, lo) of base + A' z to ~double-f32: an error-free transform
        of the large contraction; the short W' pre-contraction accumulated
        with Dekker two-products row by row, its residual folded through
        the hi/lo output."""
        Bsz, S, R, G, ns, n = self._dims()
        dtype, dev = self.dtype, self.device
        zs = z.reshape(Bsz, S, R)
        # c = W' z over the short row axis, in double-f32
        c = (torch.zeros((Bsz, S, G), dtype=dtype, device=dev),
             torch.zeros((Bsz, S, G), dtype=dtype, device=dev))
        for r in range(R):
            w = self.W[:, :, r, :]                      # (B, S, G)
            t = zs[:, :, r:r + 1]                       # (B, S, 1)
            p = w * t
            w1, w2 = _split(w)
            t1, t2 = _split(t)
            e = ((w1 * t1 - p) + w1 * t2 + w2 * t1) + w2 * t2
            c = _dd_add(c, (p, e))
        c_hi, c_lo = c[0].reshape(Bsz, S * G), c[1].reshape(Bsz, S * G)
        AgT = self.Ag.reshape(Bsz, S * G, n).mT          # (B, n, S*G)
        hi, lo = residual_affine(AgT, c_hi, base)
        # the slack-column part (~480 +-z terms for the polygon slack, which
        # a plain f32 sum re-rounds) through the same compensated reduction
        WsT = self.Ws.reshape(Bsz, S * R, ns).mT         # (B, ns, S*R)
        ws_hi, ws_lo = residual_affine(
            WsT, z, torch.zeros((Bsz, ns), dtype=dtype, device=dev))
        head = torch.zeros((Bsz, n - ns), dtype=dtype, device=dev)
        pad = lambda v: torch.cat([head, v], 1)
        out = _dd_add((hi, lo), (pad(ws_hi), pad(ws_lo)))
        return _dd_add(out, (torch.einsum("bnk,bk->bn", AgT, c_lo),
                             torch.zeros_like(hi)))

    @highest
    def matvec_compensated(self, x):
        """(hi, lo) of A @ x to ~double-f32: the large Ag @ x contraction
        error-free-transformed and the short W recombination accumulated
        with Dekker two-products (a plain f32 recombination re-rounds at
        row magnitude * eps32, which would defeat the delta-form restart's
        f32^2 residuals)."""
        Bsz, S, R, G, ns, n = self._dims()
        Af = self.Ag.reshape(Bsz, S * G, n)
        t_hi, t_lo = residual_affine(
            Af, x, torch.zeros((Bsz, S * G), dtype=self.dtype,
                               device=self.device))
        y = _dd_contract_g(self.W, t_hi.reshape(Bsz, S, G),
                           t_lo.reshape(Bsz, S, G))
        ws = torch.einsum("bsrj,bj->bsr", self.Ws, x[:, n - ns:])
        y_hi, y_lo = _dd_add(y, (ws, torch.zeros_like(ws)))
        return y_hi.reshape(Bsz, S * R), y_lo.reshape(Bsz, S * R)

    # ---- scaling / norms --------------------------------------------------

    @highest
    def row_sq_norms(self):
        """||a_r||_2^2 per row, (B, m) (the slack columns of Ag are zero,
        so the cross term with Ws vanishes)."""
        Bsz, S, R, G, ns, n = self._dims()
        Gram = self.Ag @ self.Ag.mT                        # (B, S, G, G)
        n2 = ((self.W @ Gram) * self.W).sum(-1) + (self.Ws ** 2).sum(-1)
        return n2.reshape(Bsz, S * R)

    def scale_rows(self, r):
        """diag(r) A for r (B, m)."""
        Bsz, S, R, _ = self.W.shape
        rs = r.reshape(Bsz, S, R)[..., None]
        return dataclasses.replace(self, W=self.W * rs, Ws=self.Ws * rs)

    def scale_cols(self, vs):
        """A diag(vs) for vs (B, n)."""
        Bsz, S, R, G, ns, n = self._dims()
        return dataclasses.replace(
            self, Ag=self.Ag * vs[:, None, None, :],
            Ws=self.Ws * vs[:, n - ns:].reshape(Bsz, 1, 1, ns))

    @highest
    def materialize(self):
        """The dense (B, m, n) A -- tests and one-off uses only."""
        Bsz, S, R, G, ns, n = self._dims()
        A = torch.einsum("bsrg,bsgn->bsrn", self.W, self.Ag)
        A[..., n - ns:] += self.Ws
        return A.reshape(Bsz, S * R, n)
