"""Block-Riccati sweeps: the port's plain versions against the JAX package.

On the CPU the port's kernel wrappers route to their plain PyTorch
versions (``factor_ref``, ``assemble_factor_ref``, ``apply_ref``); here
they are held, in f64 at the slice's widths (nx=7, nu=2, r=20, ns=4,
K=5, and K=1 as its first column) with B=3, N=5, against

  * the JAX scans ``_factor_scan`` / ``_assemble_factor_scan`` /
    ``_apply_scan`` under ``jax.vmap``, and
  * the Pallas TPU kernels ``factor_lanes`` / ``assemble_factor_lanes`` /
    ``apply_lanes`` in interpret mode (as ``tests/test_riccati.py`` runs
    them on the CPU).

Tolerance 1e-10 (relative and absolute): the same f64 recursions in
another summation order over five well-conditioned stages.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsae_mpc_tpu.ops import riccati as jriccati
from fsae_mpc_tpu.ops.pallas import riccati as jpallas

from fsae_mpc_tpu_torch.ops.kernels import riccati as kr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread keeps this file's
    PyTorch work off the cores that the suite's other files share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, N, NX, NU, R, NS, K = 3, 5, 7, 2, 20, 4, 5
TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    eye = np.eye(NX)
    Ad = 0.8 * (eye + 0.1 * rng.standard_normal((B, N, NX, NX)))
    Bd = rng.standard_normal((B, N, NX, NU))
    C = rng.standard_normal((B, N, R, NX))
    D = rng.standard_normal((B, N, R, NU))
    Ws = np.zeros((B, N, R, NS))
    Ws[:, :, np.arange(NS), np.arange(NS)] = 1.0
    Ws[:, :, NS + np.arange(NS), np.arange(NS)] = -1.0
    Dr = rng.uniform(0.01, 2.0, (B, N, R))
    qbd = rng.uniform(0.5, 2.0, (B, N, NX))
    rbd = rng.uniform(0.5, 2.0, (B, N, NU))
    L = 0.3 * rng.standard_normal((B, N, NX, NX))
    Qb = np.einsum("bnij,bnkj->bnik", L, L) + np.diag(rng.uniform(0.5, 2.0,
                                                                  NX))
    Rb = np.einsum("bnij,bnkj->bnik", *(2 * [0.3 * rng.standard_normal(
        (B, N, NU, NU))])) + np.eye(NU)
    M = 0.1 * rng.standard_normal((B, N, NX, NU))
    rx = rng.standard_normal((B, K, N, NX))
    ru = rng.standard_normal((B, K, N, NU))
    re = 0.1 * rng.standard_normal((B, K, N, NX))
    return dict(Ad=Ad, Bd=Bd, C=C, D=D, Ws=Ws, Dr=Dr, qbd=qbd, rbd=rbd,
                Qb=Qb, Rb=Rb, M=M, rx=rx, ru=ru, re=re)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(inputs):
    def scans(a):
        fac = jax.vmap(jriccati._factor_scan)(a["Ad"], a["Bd"], a["Qb"],
                                              a["Rb"], a["M"])
        asm = jax.vmap(jriccati._assemble_factor_scan)(
            a["C"], a["D"], a["Ws"], a["Dr"], a["qbd"], a["rbd"], a["Ad"],
            a["Bd"])
        app = jax.vmap(
            lambda hu, g, w, ad, bd, m, rx_, ru_, re_:
            jriccati._apply_scan((hu, g, w), ad, bd, m, rx_, ru_, re_))(
                *asm[:3], a["Ad"], a["Bd"], asm[3], a["rx"], a["ru"],
                a["re"])
        return dict(factor=fac, assemble=asm, apply=app)

    lanes = dict(
        factor=lambda a: jpallas.factor_lanes(a["Ad"], a["Bd"], a["Qb"],
                                              a["Rb"], a["M"]),
        assemble=lambda a: jpallas.assemble_factor_lanes(
            a["C"], a["D"], a["Ws"], a["Dr"], a["qbd"], a["rbd"], a["Ad"],
            a["Bd"]),
        apply=lambda a, asm: jpallas.apply_lanes(
            *asm[:3], a["Ad"], a["Bd"], asm[3], a["rx"], a["ru"], a["re"]))

    args = {k: jnp.asarray(v, jnp.float64) for k, v in inputs.items()}
    # one executable each (XLA:CPU compiles on one thread), each compiled
    # on a worker thread while the next one is traced; the scans' trace
    # gives the shapes the lanes' apply takes
    compile_ = lambda low: low.compile(compiler_options=FAST_COMPILE)
    with ThreadPoolExecutor(len(lanes) + 1) as pool:
        scans_t = jax.jit(scans).trace(args)
        asm_s = scans_t.out_info["assemble"]
        futs = [pool.submit(compile_, scans_t.lower())] + [
            pool.submit(compile_, jax.jit(fn).trace(
                args, *([asm_s] if k == "apply" else [])).lower())
            for k, fn in lanes.items()]
        compiled = [f.result() for f in futs]
    out = compiled[0](args)
    out["lanes"] = {k: c(args, *([out["assemble"]] if k == "apply" else []))
                    for k, c in zip(lanes, compiled[1:])}
    return jax.tree_util.tree_map(np.asarray, out)


def _t(inputs):
    return {k: torch.as_tensor(v, dtype=torch.float64)
            for k, v in inputs.items()}


def _close(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), r, rtol=TOL, atol=TOL)


def test_factor_matches_scan_and_lanes(inputs, jax_out):
    a = _t(inputs)
    out = kr.factor_ref(a["Ad"], a["Bd"], a["Qb"], a["Rb"], a["M"])
    _close(out, jax_out["factor"])
    _close(out, jax_out["lanes"]["factor"])
    # the dispatcher routes a CPU tensor to the plain version
    _close(kr.factor(a["Ad"], a["Bd"], a["Qb"], a["Rb"], a["M"]),
           jax_out["factor"])


def test_assemble_factor_matches_scan_and_lanes(inputs, jax_out):
    a = _t(inputs)
    out = kr.assemble_factor_ref(a["C"], a["D"], a["Ws"], a["Dr"], a["qbd"],
                                 a["rbd"], a["Ad"], a["Bd"])
    _close(out, jax_out["assemble"])
    _close(out, jax_out["lanes"]["assemble"])
    _close(kr.assemble_factor(a["C"], a["D"], a["Ws"], a["Dr"], a["qbd"],
                              a["rbd"], a["Ad"], a["Bd"]),
           jax_out["assemble"])


@pytest.mark.parametrize("k", [K, 1])
def test_apply_matches_scan_and_lanes(k, inputs, jax_out):
    a = _t(inputs)
    fac = [torch.tensor(v) for v in jax_out["assemble"]]
    rhs = [a[n][:, :k].contiguous() for n in ("rx", "ru", "re")]
    out = kr.apply_ref(*fac[:3], a["Ad"], a["Bd"], fac[3], *rhs)
    # the K right-hand sides are independent columns: K=1 is the first
    _close(out, [v[:, :k] for v in jax_out["apply"]])
    _close(out, [v[:, :k] for v in jax_out["lanes"]["apply"]])
    _close(kr.apply(*fac[:3], a["Ad"], a["Bd"], fac[3], *rhs),
           [v[:, :k] for v in jax_out["apply"]])
