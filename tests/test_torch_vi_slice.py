"""The ported VI slice (``bench.py --vi``) against the JAX reference
(float64, CPU, the shapes of tests/test_parallel.py):

  - the pieces the VI solve adds: ``MargPrior``, the scatter ``assemble``,
    the dense ``projection_assemble`` and the dense-H Schur step
    ``_gn_step_schur`` (with a rank-deficient landmark, with and without
    ``reduced_keep``), each on inputs from a numpy seed;
  - the whole slice: the JAX generator's problem through
    ``vi_problem_from_numpy`` and the port's ``batched_vi_solve`` matches
    the JAX ``batched_vi_solve`` at the tolerances of
    tests/test_parallel.py:39-40;
  - the port's own generator is recovered to truth at the thresholds of
    tests/test_parallel.py:26-27.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_ref import per_window
from test_torch_jax_ref import to_numpy as _np

from rtk_visual_inertial_navigation_tpu.core.state import \
    TangentLayout as JLayout
from rtk_visual_inertial_navigation_tpu.factors.base import \
    FactorBatch as JFactorBatch
from rtk_visual_inertial_navigation_tpu.factors.priors import \
    MargPrior as JMargPrior
from rtk_visual_inertial_navigation_tpu.parallel import \
    make_synthetic_windows as jax_make_synthetic_windows
from rtk_visual_inertial_navigation_tpu.parallel.mesh import \
    _solve_one as jax_solve_one
from rtk_visual_inertial_navigation_tpu.solver import gauss_newton as jgn
from rtk_visual_inertial_navigation_tpu.solver import structured as jst
from rtk_visual_inertial_navigation_tpu_torch.core.state import (
    TangentLayout, WindowState)
from rtk_visual_inertial_navigation_tpu_torch.factors.base import \
    FactorBatch
from rtk_visual_inertial_navigation_tpu_torch.factors.priors import (
    MargPrior, initial_prior)
from rtk_visual_inertial_navigation_tpu_torch.parallel import (
    batched_vi_solve, make_synthetic_windows, vi_problem_from_numpy)
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss import \
    tree_from_numpy
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    gauss_newton as tgn
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    structured as tst

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)

NF, NL, NOBS, NSAMP = 4, 8, 24, 8
B = 4
LAY = TangentLayout(nf=NF, nl=NL, nb=1, nc=2)
JLAY = JLayout(nf=NF, nl=NL, nb=1, nc=2)
KEEP = tuple(range(15 * NF))
T = torch.from_numpy


def _close(got, ref, tol=1e-10):
    """Roundoff relative to the largest entry."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX problem and its JAX solve (tests/test_parallel.py:16-22):
    ``batched_vi_solve`` is a vmap of ``_solve_one``."""
    probs = jax_make_synthetic_windows(jax.random.PRNGKey(0), B, NF, NL,
                                       NOBS, NSAMP)
    cfg = jgn.DoglegConfig(max_iters=4, schur_nl=NL)
    return probs, per_window(lambda p: jax_solve_one(p, JLAY, cfg),
                             (probs,), B)


@pytest.mark.parametrize("keep", [(), KEEP], ids=["all", "keep"])
def test_port_matches_jax_batched_vi_solve(jax_run, keep):
    """``reduced_keep`` leaves only structurally empty slots (unit diagonal,
    zero rhs after the free mask) out of the reduced Cholesky, so the one
    JAX solve is the reference for both configurations (each JAX compile
    costs seconds of the test clock); the JAX step's own ``reduced_keep``
    path is held in test_gn_step_schur_matches_jax."""
    probs, (st_j, cost_j, nacc_j) = jax_run
    tp = vi_problem_from_numpy(_np(probs), device="cpu")
    cfg = tgn.DoglegConfig(max_iters=4, schur_nl=NL, reduced_keep=keep)
    st, cost, nacc = batched_vi_solve(tp, LAY, cfg, device="cpu")
    # tests/test_parallel.py:39-40
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_j), atol=1e-10)
    np.testing.assert_allclose(st.p.numpy(), np.asarray(st_j.p), atol=1e-8)
    np.testing.assert_allclose(st.landmarks.numpy(),
                               np.asarray(st_j.landmarks), atol=1e-8)
    np.testing.assert_array_equal(nacc.numpy(), np.asarray(nacc_j))


def test_port_generator_solve_recovers_truth():
    probs = make_synthetic_windows(0, B, NF, NL, NOBS, NSAMP, device="cpu")
    cfg = tgn.DoglegConfig(max_iters=4, schur_nl=NL)
    st, cost, nacc = batched_vi_solve(probs, LAY, cfg, device="cpu")
    perr = (st.p - probs.truth.p).norm(dim=-1)
    # tests/test_parallel.py:26-27
    assert perr.max() < 1e-4, perr.max()
    assert bool((cost < 1e-6).all()), cost
    assert bool((nacc > 0).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_synthetic_windows(0, 1, NF, NL, NOBS, NSAMP)


def test_marg_prior_matches_jax(jax_run):
    probs, _ = jax_run
    rng = np.random.default_rng(0)
    R, D = 7, JLAY.dim
    J = rng.normal(size=(B, R, D))
    r0 = rng.normal(size=(B, R))
    valid = np.arange(R) % 3 != 1
    valid = np.broadcast_to(valid, (B, R)).copy()
    tx0 = tree_from_numpy(WindowState, _np(probs.truth), "cpu")
    tstate = tree_from_numpy(WindowState, _np(probs.state0), "cpu")
    tp = MargPrior(J=T(J), r0=T(r0), x0=tx0, valid_rows=T(valid))
    H, g, c = tp.hessian_contrib(tstate)
    Hp, gp, cp = tp.precompute()(tstate)
    tr = tp.residual(tstate)
    jr, jhc, jpc = jax.jit(jax.vmap(lambda J_, r_, v_, x0, st: (
        lambda jp: (jp.residual(st), jp.hessian_contrib(st),
                    jp.precompute()(st)))(
            JMargPrior(J=J_, r0=r_, x0=x0, valid_rows=v_))))(
        jnp.asarray(J), jnp.asarray(r0), jnp.asarray(valid), probs.truth,
        probs.state0)
    _close(tr, jr)
    for got, ref in zip((H, g, c, Hp, gp, cp), jhc + jpc):
        _close(got, ref)
    # the information form, when given, is used as is
    tpi = tp._replace(H0=Hp, g0=T(rng.normal(size=(B, D))),
                      c0=T(rng.normal(size=B)))
    Hi, gi, ci = tpi.precompute()(tx0)
    assert Hi is Hp
    torch.testing.assert_close(gi, tpi.g0)
    torch.testing.assert_close(ci, 0.5 * tpi.c0)
    # a diagonal bootstrap prior pins the listed directions only
    pri = initial_prior(LAY, tx0, [(5, 2.0), (40, 3.0)], rows=4)
    Hd, _, _ = pri.hessian_contrib(tstate)
    expect = torch.zeros(D, dtype=torch.float64)
    expect[5], expect[40] = 4.0, 9.0
    torch.testing.assert_close(Hd, torch.diag(expect).expand(B, D, D))


def test_assemble_matches_jax():
    rng = np.random.default_rng(1)
    dim, rows, r, d = 11, 6, 3, 4
    batches = []
    for _ in range(2):
        jac = rng.normal(size=(B, rows, r, d))
        res = rng.normal(size=(B, rows, r))
        gidx = rng.integers(0, dim, size=(B, rows, d))
        gidx[:, 0, 1] = gidx[:, 0, 0]       # repeated within a row
        gidx[:, 1] = gidx[:, 0]             # and across rows
        batches.append((jac, res, gidx))
    valid = np.ones((B, rows), dtype=bool)
    got = tgn.assemble(
        [FactorBatch(res=T(rs), jac=T(j), gidx=T(gi), valid=T(valid))
         for j, rs, gi in batches], dim)
    ref = jax.jit(jax.vmap(lambda bs: jgn.assemble(bs, dim)))(
        [JFactorBatch(res=jnp.asarray(rs), jac=jnp.asarray(j),
                      gidx=jnp.asarray(gi), valid=jnp.asarray(valid))
         for j, rs, gi in batches])
    for t, r in zip(got, ref):
        _close(t, r)


def test_projection_assemble_matches_jax():
    rng = np.random.default_rng(2)
    nobs = 30
    f_ids = rng.integers(0, NF, size=(B, nobs))
    c_ids = rng.integers(0, 2, size=(B, nobs))
    l_ids = rng.integers(0, NL, size=(B, nobs))
    res = rng.normal(size=(B, nobs, 2))
    jac = rng.normal(size=(B, nobs, 2, 15))
    got = tst.projection_assemble(LAY, T(f_ids), T(c_ids), T(l_ids),
                                  T(res), T(jac))
    ref = jax.jit(jax.vmap(lambda *a: jst.projection_assemble(JLAY, *a)))(
        *map(jnp.asarray, (f_ids, c_ids, l_ids, res, jac)))
    for t, r in zip(got, ref):
        _close(t, r)


@pytest.mark.parametrize("keep", [(), (0, 1, 3, 4, 6, 8, 9, 10)],
                         ids=["all", "keep"])
def test_gn_step_schur_matches_jax(keep):
    """Dense H with a 3x3-block-diagonal landmark group; landmark 1 is seen
    by one row only (rank-deficient block, held by the guard); slots left
    out of ``keep`` are decoupled unit rows, as after the free mask."""
    rng = np.random.default_rng(3)
    nl, dr = 4, 12
    n3 = 3 * nl
    D = n3 + dr
    H = np.zeros((B, D, D))
    for b in range(B):
        for l in range(nl):
            rows = 1 if l == 1 else 4
            Jrow = np.zeros((rows, D))
            Jrow[:, 3 * l:3 * l + 3] = rng.normal(size=(rows, 3))
            Jrow[:, n3:] = rng.normal(size=(rows, dr))
            H[b] += Jrow.T @ Jrow
        Jr = rng.normal(size=(dr + 3, dr))
        H[b, n3:, n3:] += Jr.T @ Jr
    g = rng.normal(size=(B, D))
    if keep:
        out = [n3 + i for i in range(dr) if i not in keep]
        H[:, out, :] = 0.0
        H[:, :, out] = 0.0
        H[:, out, out] = 1.0
        g[:, out] = 0.0
    step = tgn._gn_step_schur(T(H), T(g), nl,
                              torch.tensor(keep) if keep else None)
    assert bool(torch.isfinite(step).all())
    ref = jax.jit(jax.vmap(lambda h, v: jgn._gn_step_schur(h, v, nl, keep)))(
        jnp.asarray(H), jnp.asarray(g))
    _close(step, ref, 1e-9)
