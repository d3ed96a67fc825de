"""Solver pieces of the PyTorch port vs the JAX reference (float64 unless
stated, CPU, inputs from a numpy seed): block Hessian algebra, Gram
assembly, SPD solves, chain block placement, and the dogleg loop on a
dense toy problem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.core.state import \
    TangentLayout as JLayout
from rtk_visual_inertial_navigation_tpu.factors.base import \
    FactorBatch as JFactorBatch
from rtk_visual_inertial_navigation_tpu.ops.smallinv import \
    spd_inv_small as j_spd_inv_small
from rtk_visual_inertial_navigation_tpu.solver import block_hessian as jbh
from rtk_visual_inertial_navigation_tpu.solver import gauss_newton as jgn
from rtk_visual_inertial_navigation_tpu.solver import marginalization as jmg
from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.factors.base import \
    FactorBatch
from rtk_visual_inertial_navigation_tpu_torch.ops.smallinv import \
    spd_inv_small
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    block_hessian as tbh
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    gauss_newton as tgn
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    marginalization as tmg

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)

B, NL, DR = 2, 5, 12
T = torch.from_numpy


def _close(got, ref, tol=1e-10):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _block_hessians(seed=0):
    """(B, ...) Schur-structured SPD Hessians: landmark rows touch one
    landmark each; landmark 1 is seen by one row only (rank-deficient
    3x3 block, exercising the guard)."""
    rng = np.random.default_rng(seed)
    Hll = np.zeros((B, NL, 3, 3))
    Hlr = np.zeros((B, NL, 3, DR))
    Hrr = np.zeros((B, DR, DR))
    for b in range(B):
        for l in range(NL):
            rows = 1 if l == 1 else 4
            Jl = rng.normal(size=(rows, 3))
            K = rng.normal(size=(rows, DR))
            Hll[b, l] = Jl.T @ Jl
            Hlr[b, l] = Jl.T @ K
            Hrr[b] += K.T @ K
        Jr = rng.normal(size=(DR + 3, DR))
        Hrr[b] += Jr.T @ Jr
    g = rng.normal(size=(B, 3 * NL + DR))
    free = np.ones((B, 3 * NL + DR), dtype=bool)
    free[:, 3 * NL + 2] = False
    free[1, 4] = False
    return (Hll, Hlr, Hrr), g, free


@pytest.mark.parametrize("step_dtype,keep", [
    ("same", ()), ("float32", ()), ("same", tuple(range(0, DR, 2)))])
def test_block_hessian_step_and_cov_match_jax(step_dtype, keep):
    H, g, free = _block_hessians()
    th = tbh.BlockHess(*map(T, H))
    cols = np.tile(3 * NL + np.arange(DR - 3, DR), (B, 1))
    tm, tg, tfree = th.mask(T(g), T(free))
    t_step = tm.gn_step(tg, torch.tensor(keep) if keep else None, step_dtype)
    t_cov = th.tail_cov(T(free), T(cols))
    t_mv = th.matvec(T(g))
    tol = 1e-4 if step_dtype == "float32" else 1e-10

    # the JAX reference per window, vmapped and compiled once (eager JAX
    # dispatch costs seconds of the test clock)
    def ref(Hll, Hlr, Hrr, gb, fb, cb):
        jh = jbh.BlockHess(Hll, Hlr, Hrr)
        jm, jg, jfree = jh.mask(gb, fb)
        return (jm, jfree, jm.gn_step(jg, keep, step_dtype),
                jh.tail_cov(fb, cb), jh.matvec(gb), jh.diagonal())

    jm, jfree, j_step, j_cov, j_mv, j_diag = jax.jit(jax.vmap(ref))(
        *map(jnp.asarray, (*H, g, free, cols)))
    for k in range(3):
        _close(tm[k], jm[k])
    np.testing.assert_array_equal(tfree, np.asarray(jfree))
    _close(t_step, j_step, tol)
    _close(t_cov, j_cov)
    _close(t_mv, j_mv)
    _close(th.diagonal(), j_diag)


def test_assemble_gram_matches_jax():
    rng = np.random.default_rng(1)
    dim = 9
    specs = [(6, 2, 4), (5, 1, 3)]                 # (rows, r, d)
    tb, jb = [], []
    for rows, r, d in specs:
        res = rng.normal(size=(B, rows, r))
        jac = rng.normal(size=(B, rows, r, d))
        gidx = rng.integers(-3, dim + 2, size=(B, rows, d))  # some out
        valid = np.ones((B, rows), dtype=bool)
        tb.append(FactorBatch(T(res), T(jac), T(gidx), T(valid)))
        jb.append((res, jac, gidx, valid))
    H, g, cost = tgn.assemble_gram(tb, dim)
    jH, jg, jc = jax.jit(jax.vmap(lambda bs: jgn.assemble_gram(bs, dim)))(
        [JFactorBatch(*map(jnp.asarray, spec)) for spec in jb])
    _close(H, jH)
    _close(g, jg)
    _close(cost, jc)


@pytest.mark.parametrize("d,dtype", [(15, "float64"), (20, "float64"),
                                     (20, "float32")])
def test_spd_solve_matches_jax(d, dtype):
    rng = np.random.default_rng(2)
    A = rng.normal(size=(B, d + 4, d))
    M = (A.transpose(0, 2, 1) @ A * np.logspace(0, 4, d)).astype(dtype)
    M = 0.5 * (M + M.transpose(0, 2, 1))
    rhs = rng.normal(size=(B, d, 3)).astype(dtype)
    got = tmg.spd_solve(T(M), T(rhs))
    ref, ref_inv = jax.jit(lambda m, r: (
        jax.vmap(jmg.spd_solve)(m, r),
        j_spd_inv_small(m) if d <= 16 else None))(jnp.asarray(M),
                                                   jnp.asarray(rhs))
    _close(got, ref, 1e-4 if dtype == "float32" else 1e-9)
    if d <= 16:
        _close(spd_inv_small(T(M)), ref_inv, 1e-9)
    _close(tgn.inv33(T(M[..., :3, :3])), jgn.inv33(jnp.asarray(
        M[..., :3, :3])), 1e-9)


def test_chain_blocks_into_matches_jax():
    rng = np.random.default_rng(3)
    nf, nb, nch = 4, 3, 3
    lay = TangentLayout(nf=nf, nl=NL, nb=nb, nc=2)
    jlay = JLayout(nf=nf, nl=NL, nb=nb, nc=2)
    S = 30 + nb
    Hb = rng.normal(size=(B, nch, S, S))
    gb = rng.normal(size=(B, nch, S))
    left = np.array([[0, 1, 2], [0, 2, 1]])
    right = left + 1
    Dr = lay.dim - 3 * NL
    H0 = tbh.BlockHess(T(np.zeros((B, NL, 3, 3))),
                       T(np.zeros((B, NL, 3, Dr))),
                       T(rng.normal(size=(B, Dr, Dr))))
    g0 = rng.normal(size=(B, lay.dim))
    bh, g = tbh.chain_blocks_into(H0, T(g0), T(Hb), T(gb), T(left),
                                  T(right), lay)
    jb, jg = jax.jit(jax.vmap(
        lambda h0, *a: jbh.chain_blocks_into(jbh.BlockHess(*h0), *a,
                                             jlay)))(
        tuple(jnp.asarray(x.numpy()) for x in H0),
        *map(jnp.asarray, (g0, Hb, gb, left, right)))
    _close(bh.Hrr, jb.Hrr)
    _close(g, jg)


def _toy(A, c, x, lib):
    """Residual r = A (x + 0.1 sin x) - c and its (H, g, cost)."""
    r = A @ (x + 0.1 * lib.sin(x)) - c
    J = A * (1.0 + 0.1 * lib.cos(x))
    return J.T @ J, J.T @ r, 0.5 * r @ r


@pytest.mark.parametrize("f_tol", [0.0, 1e-3])
def test_dense_dogleg_and_cov_match_jax(f_tol):
    rng = np.random.default_rng(4)
    n = 6
    A = rng.normal(size=(B, n + 2, n))
    c = rng.normal(size=(B, n + 2))
    x0 = rng.normal(size=(B, n))
    free = np.ones((B, n), dtype=bool)
    free[0, 2] = False
    cols = np.tile([4, 5], (B, 1))

    def t_eval(x):
        out = [_toy(T(A[b]), T(c[b]), x[b], torch) for b in range(B)]
        return tuple(torch.stack(v) for v in zip(*out))

    cfg = dict(max_iters=5, initial_radius=0.3, f_tol=f_tol)
    res = tgn.dogleg_solve(t_eval, lambda x, dx: x + dx, T(x0), T(free),
                           tgn.DoglegConfig(**cfg))
    t_cov = tmg.masked_cov_cols(res.H, T(free), T(cols))

    def one(Ab, cb, xb, fb, cl):
        r = jgn.dogleg_solve(lambda x: _toy(Ab, cb, x, jnp),
                             lambda x, dx: x + dx, xb, fb,
                             jgn.DoglegConfig(**cfg))
        return r, jmg.masked_cov_cols(r.H, fb, cl)

    ref, j_cov = jax.jit(jax.vmap(one))(*map(jnp.asarray,
                                            (A, c, x0, free, cols)))
    _close(res.state, ref.state)
    _close(res.cost, ref.cost)
    _close(res.radius, ref.radius)
    np.testing.assert_array_equal(res.n_accepted, np.asarray(ref.n_accepted))
    _close(t_cov, j_cov)
