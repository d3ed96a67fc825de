"""Solver pieces of the PyTorch port vs the JAX reference (float64 unless
stated, CPU, inputs from a numpy seed): block Hessian algebra, Gram
assembly, SPD solves, chain block placement, and the dogleg loop on a
dense toy problem."""

import threading

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


def _rosenbrock(x):
    """Two Rosenbrock valleys per window: residuals (B, 4), Jacobian."""
    z, o = torch.zeros_like(x[:, 0]), torch.ones_like(x[:, 0])
    r = torch.stack([10 * (x[:, 1] - x[:, 0] ** 2), 1 - x[:, 0],
                     10 * (x[:, 3] - x[:, 2] ** 2), 1 - x[:, 2]], -1)
    J = torch.stack([torch.stack([-20 * x[:, 0], 10 * o, z, z], -1),
                     torch.stack([-o, z, z, z], -1),
                     torch.stack([z, z, -20 * x[:, 2], 10 * o], -1),
                     torch.stack([z, z, -o, z], -1)], -2)
    return r, J


def test_dogleg_reduce_keeps_peers_in_step():
    """Two peers of an fp group (threads here, the hook a MIN over both)
    solve the same windows, one with its H off by a relative 1e-3, as
    replicated arithmetic that differs between peers would leave it.  With
    the reduce hook they accept, grow or shrink the radius and stop
    together: equal accepted counts, radii and states apart by the
    perturbation's effect only (a radius branch taken by one peer alone
    would set the radii a factor 2 apart)."""
    nb = 512
    x0 = T(np.random.default_rng(0).uniform(-2, 2, (nb, 4)))
    free = torch.ones((nb, 4), dtype=torch.bool)
    cfg = tgn.DoglegConfig(max_iters=30, initial_radius=0.5, f_tol=1e-12)
    slots = [None, None]
    barrier = threading.Barrier(2, timeout=60)

    def min_hook(i):
        def reduce(flags):
            slots[i] = flags.clone()
            barrier.wait()
            out = torch.minimum(slots[0], slots[1])
            barrier.wait()
            return out
        return reduce

    out = [None, None]

    def peer(i):
        def eval_fn(x):
            r, J = _rosenbrock(x)
            Jt = J.transpose(-1, -2)
            return ((Jt @ J) * (1.0 + 1e-3 * i), (Jt @ r[..., None])[..., 0],
                    0.5 * (r * r).sum(-1))
        out[i] = tgn.dogleg_solve(eval_fn, lambda x, dx: x + dx, x0, free,
                                  cfg, reduce=min_hook(i))

    threads = [threading.Thread(target=peer, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    a, b = out
    assert a is not None and b is not None, "a peer failed"
    np.testing.assert_array_equal(a.n_accepted, b.n_accepted)
    assert (a.radius / b.radius).log().abs().max().item() < 0.1
    np.testing.assert_allclose(a.state, b.state, rtol=0, atol=1e-3)


def test_prior_block_contrib_matches_jax():
    """The block-structured prior: bh0 (split by BlockHess.from_dense), g
    and the cost at a moved state, against block_hessian.py's; and from a
    prior that carries its information form."""
    from rtk_visual_inertial_navigation_tpu.core.state import \
        WindowState as JWindowState
    from rtk_visual_inertial_navigation_tpu.core.state import \
        window_boxminus as j_boxminus
    from rtk_visual_inertial_navigation_tpu.factors.priors import \
        MargPrior as JMargPrior
    from rtk_visual_inertial_navigation_tpu_torch.core.state import (
        WindowState, window_boxminus)
    from rtk_visual_inertial_navigation_tpu_torch.factors.priors import \
        MargPrior
    rng = np.random.default_rng(6)
    nf, nl, nb = 3, 4, 2
    lay = TangentLayout(nf=nf, nl=nl, nb=nb, nc=2)
    D, R = lay.dim, 12
    J = rng.normal(size=(B, R, D))
    # landmark columns: one 3-block per row, so JᵀJ is block-diagonal there
    for r in range(R):
        keep = 3 * (r % nl)
        J[:, r, :3 * nl] = 0.0
        J[:, r, keep:keep + 3] = rng.normal(size=(B, 3))
    r0 = rng.normal(size=(B, R))
    valid = rng.random((B, R)) < 0.8
    x0 = WindowState.zeros(nf, nl, nb, dtype=torch.float64,
                           batch_shape=(B,))
    state = x0._replace(p=T(rng.normal(size=(B, nf, 3))),
                        landmarks=T(rng.normal(size=(B, nl, 3))),
                        phase_bias=T(rng.normal(size=(B, nb))))
    prior = MargPrior(J=T(J), r0=T(r0), x0=x0, valid_rows=T(valid))
    bh0, contrib = tbh.prior_block_contrib(prior, nl, window_boxminus)
    g, cost = contrib(state)
    jx0 = JWindowState.zeros(nf, nl, nb)
    for b in range(B):
        jprior = JMargPrior(J=jnp.asarray(J[b]), r0=jnp.asarray(r0[b]),
                            x0=jx0, valid_rows=jnp.asarray(valid[b]))
        jbh0, jcontrib = jbh.prior_block_contrib(jprior, nl, j_boxminus)
        jst = jx0._replace(p=jnp.asarray(state.p[b].numpy()),
                           landmarks=jnp.asarray(state.landmarks[b].numpy()),
                           phase_bias=jnp.asarray(
                               state.phase_bias[b].numpy()))
        jg, jcost = jcontrib(jst)
        for k in ("Hll", "Hlr", "Hrr"):
            _close(getattr(bh0, k)[b], getattr(jbh0, k))
        _close(g[b], jg)
        _close(cost[b], jcost)
    # a prior in information form gives the same contribution
    Jm = T(J) * T(valid)[..., None]
    rm = T(r0) * T(valid)
    informed = prior._replace(H0=Jm.transpose(-1, -2) @ Jm,
                              g0=(Jm.transpose(-1, -2) @ rm[..., None])[
                                  ..., 0], c0=(rm * rm).sum(-1))
    g2, cost2 = tbh.prior_block_contrib(informed, nl, window_boxminus)[1](
        state)
    _close(g2, g.numpy())
    _close(cost2, cost.numpy())


def test_dense_rtk_solve_matches_block_path_and_jax():
    """The dense use_blocks=False flagship solve (JAX's test oracle)
    against the port's block path and JAX's dense path, at
    tests/test_parallel_rtk.py's shapes and tolerances."""
    from test_torch_jax_ref import per_window
    from test_torch_jax_ref import to_numpy as _np

    from rtk_visual_inertial_navigation_tpu.parallel import \
        make_synthetic_rtk_windows
    from rtk_visual_inertial_navigation_tpu.parallel.problems_gnss import \
        _solve_one_rtk
    from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss \
        import batched_rtk_solve, problem_from_numpy
    nf, nl, nobs, nsamp, cap, ns, nb = 5, 12, 40, 6, 4, 6, 8
    jp = make_synthetic_rtk_windows(jax.random.PRNGKey(7), B, nf=nf, nl=nl,
                                    nobs=nobs, nsamp=nsamp, cap=cap, ns=ns,
                                    nb=nb)
    jlay = JLayout(nf=nf, nl=nl, nb=nb, nc=2)
    jcfg = jgn.DoglegConfig(max_iters=4)
    jwin, _, jcost, _, jX = per_window(lambda p: _solve_one_rtk(
        p, jlay, jcfg, cap, use_blocks=False), (jp,), B)
    tp = problem_from_numpy(_np(jp), device="cpu")
    lay = TangentLayout(nf=nf, nl=nl, nb=nb, nc=2)
    cfg = tgn.DoglegConfig(max_iters=4)
    dense = batched_rtk_solve(tp, lay, cfg, cap, device="cpu",
                              use_blocks=False)
    block = batched_rtk_solve(tp, lay, cfg, cap, device="cpu")
    for ref in ((jwin, jcost, jX), (block[0], block[2], block[4])):
        win, cost, X = dense[0], dense[2], dense[4]
        np.testing.assert_allclose(cost.numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(win.p.numpy(), np.asarray(ref[0].p),
                                   atol=1e-8)
        np.testing.assert_allclose(win.phase_bias.numpy(),
                                   np.asarray(ref[0].phase_bias), atol=1e-8)
        np.testing.assert_allclose(X.numpy(), np.asarray(ref[2]), atol=1e-8)
