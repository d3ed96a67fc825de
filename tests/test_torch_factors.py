"""PyTorch port vs JAX reference, float64 on the CPU: IMU and GNSS factor
batches (res, jac, gidx) on the JAX synthetic RTK problem; the fixed
integer, inverse-depth and Cauchy pieces and the factor helpers on inputs
from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_ref import to_numpy as _np

from rtk_visual_inertial_navigation_tpu.factors import gnss as jgnss
from rtk_visual_inertial_navigation_tpu.factors.inertial import \
    imu_factor_batch as j_imu
from rtk_visual_inertial_navigation_tpu.parallel import \
    make_synthetic_rtk_windows
from rtk_visual_inertial_navigation_tpu.parallel.problems_gnss import \
    _anchor_frame
from rtk_visual_inertial_navigation_tpu_torch.factors import gnss as tgnss
from rtk_visual_inertial_navigation_tpu_torch.factors.inertial import \
    imu_factor_batch as t_imu
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss import \
    problem_from_numpy

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)

NF, NL, NOBS, NSAMP, CAP, NS, NB = 5, 12, 40, 6, 4, 6, 8
B = 2


@pytest.fixture(scope="module")
def probs():
    jp = make_synthetic_rtk_windows(
        jax.random.PRNGKey(3), B, nf=NF, nl=NL, nobs=NOBS, nsamp=NSAMP,
        cap=CAP, ns=NS, nb=NB)
    return jp, problem_from_numpy(_np(jp), device="cpu")


def _check(got, ref):
    for k in ("res", "jac"):
        r = np.asarray(getattr(ref, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), r, rtol=0,
                                   atol=1e-10 * max(np.abs(r).max(), 1.0),
                                   err_msg=k)
    np.testing.assert_array_equal(got.gidx.numpy(), np.asarray(ref.gidx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_imu_factor_batch_matches_jax(probs):
    jp, tp = probs
    pbg = np.array([0.02, -0.01, 0.03])
    g = np.array([0.0, 0.0, 9.81])
    valid = np.ones((B, NF - 1), dtype=bool)
    valid[1, 2] = False
    ref = jax.jit(jax.vmap(lambda s, pr, v: j_imu(s, pr, jnp.asarray(pbg),
                                                  jnp.asarray(g), v)))(
        jp.state0, jp.pre, jnp.asarray(valid))
    got = t_imu(tp.state0, tp.pre, torch.from_numpy(pbg),
                torch.from_numpy(g), torch.from_numpy(valid))
    _check(got, ref)


@pytest.mark.parametrize("name,field", [
    ("spp_pseudorange_batch", "b_pr"),
    ("spp_carrier_phase_batch", "b_cp"),
    ("doppler_batch", "b_dopp"),
    ("rtk_pseudorange_batch", "b_pr"),
    ("rtk_carrier_phase_batch", "b_cp")])
def test_gnss_batches_match_jax(probs, name, field):
    jp, tp = probs
    _, R_e = _anchor_frame()
    # evaluate away from the truth so residuals are not ~0
    jstate = jp.state0._replace(p=jp.state0.p + 0.3, v=jp.state0.v - 0.2)
    tstate = tp.state0._replace(p=tp.state0.p + 0.3, v=tp.state0.v - 0.2)
    ref = jax.jit(jax.vmap(lambda s, b: getattr(jgnss, name)(s, b, R_e)))(
        jstate, getattr(jp, field))
    got = getattr(tgnss, name)(tstate, getattr(tp, field),
                               torch.from_numpy(np.array(R_e)))
    _check(got, ref)


def test_fixed_integer_batch_matches_jax():
    """tests/test_solver.py:295-322's factor, batched over two windows."""
    from rtk_visual_inertial_navigation_tpu.core import \
        WindowState as JWindowState
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        WindowState, layout_of
    pb = np.array([[10.2, 3.1, 7.0, 0.0, 0.0, 0.0],
                   [1.0, -2.5, 0.5, 4.0, 0.0, 0.0]])
    rows = dict(pb_slot=np.array([[0, 1], [3, 1]]),
                datum_slot=np.array([[2, 2], [2, 0]]),
                n_fixed=np.array([[3.0, -4.0], [3.0, -3.0]]),
                weight=np.full((2, 2), 1 / 0.03),
                valid=np.array([[True, True], [True, False]]))
    jref = jax.vmap(lambda p_, r: jgnss.fixed_integer_batch(
        JWindowState.zeros(2, 2, 6)._replace(phase_bias=p_),
        jgnss.FixedIntegerBatch(**r)))(
        jnp.asarray(pb), {k: jnp.asarray(v) for k, v in rows.items()})
    state = WindowState.zeros(2, 2, 6, dtype=torch.float64,
                              batch_shape=(2,))._replace(
        phase_bias=torch.from_numpy(pb))
    got = tgnss.fixed_integer_batch(state, tgnss.FixedIntegerBatch(
        **{k: torch.from_numpy(v) for k, v in rows.items()}))
    _check(got, jref)
    # r = w·((N_j − N_datum) − n): (10.2−7.0−3) = 0.2; (3.1−7.0+4) = 0.1
    np.testing.assert_allclose(got.res[0, :, 0].numpy() * 0.03, [0.2, 0.1],
                               atol=1e-9)
    np.testing.assert_allclose(got.jac[0, 0, 0].numpy(),
                               [1 / 0.03, -1 / 0.03], atol=1e-9)
    lay = layout_of(state)
    np.testing.assert_array_equal(got.gidx[0, 0].numpy(),
                                  [lay.pb_idx(0), lay.pb_idx(2)])
    assert got.res[1, 1].abs().max() == 0.0       # the invalid row


def test_cauchy_cost_matches_jax():
    """tests/test_robust.py:24-48: ½Σ|r̃|² + delta = ½Σρ(s), and J̃ᵀr̃ is
    the gradient of the robust cost, with cauchy_cost equal to JAX's."""
    from rtk_visual_inertial_navigation_tpu.factors import robust as jrob
    from rtk_visual_inertial_navigation_tpu_torch.factors import \
        robust as trob
    rng = np.random.default_rng(0)
    res = rng.normal(size=(3, 32, 2)) * 2.0
    jac = rng.normal(size=(3, 32, 2, 5))
    for a in (1.0, 2.5):
        cost = trob.cauchy_cost(torch.from_numpy(res), a)
        ref = [float(jrob.cauchy_cost(jnp.asarray(r), a)) for r in res]
        np.testing.assert_allclose(cost.numpy(), ref, rtol=1e-12)
        r2, _, delta = trob.cauchy_correct(torch.from_numpy(res),
                                           torch.from_numpy(jac), a)
        np.testing.assert_allclose(
            (0.5 * (r2 * r2).sum((-2, -1)) + delta).numpy(), cost.numpy(),
            rtol=1e-12)

    R, J = torch.from_numpy(res[0]), torch.from_numpy(jac[0])
    g_auto = torch.func.grad(lambda x: trob.cauchy_cost(
        R + torch.einsum("brt,t->br", J, x)))(torch.zeros(5,
                                                           dtype=R.dtype))
    r2, j2, _ = trob.cauchy_correct(R, J)
    np.testing.assert_allclose(torch.einsum("brt,br->t", j2, r2).numpy(),
                               g_auto.numpy(), rtol=1e-10, atol=1e-12)


def test_factor_helpers_match_jax():
    """manifold_res_jac / res_jac_of (forward-mode Jacobians), mask_batch
    and concat_indices against factors/base.py's."""
    from rtk_visual_inertial_navigation_tpu.factors import base as jbase
    from rtk_visual_inertial_navigation_tpu.ops import lie as jlie
    from rtk_visual_inertial_navigation_tpu_torch.factors import \
        base as tbase
    from rtk_visual_inertial_navigation_tpu_torch.ops import lie as tlie
    rng = np.random.default_rng(1)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    v, w = rng.normal(size=3), rng.normal(size=3)

    def res(lie, lib, t):
        qq = lie.quat_boxplus(lib.asarray(q), t[3:6])
        return lie.quat_rotate(qq, lib.asarray(v) + t[0:3]) - lib.asarray(w)

    for name in ("manifold_res_jac", "res_jac_of"):
        jr, jj = getattr(jbase, name)(lambda t: res(jlie, jnp, t), 6)
        tr, tj = getattr(tbase, name)(lambda t: res(tlie, torch, t), 6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-14)
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-14)

    fb = dict(res=rng.normal(size=(4, 2)), jac=rng.normal(size=(4, 2, 3)),
              gidx=rng.integers(0, 9, size=(4, 3)),
              valid=np.array([True, False, True, False]))
    jm = jbase.mask_batch(jbase.FactorBatch(**{k: jnp.asarray(v)
                                               for k, v in fb.items()}))
    tm = tbase.mask_batch(tbase.FactorBatch(**{k: torch.from_numpy(v)
                                               for k, v in fb.items()}))
    _check(tm, jm)
    parts = (np.array([4, 5, 6]), 9, np.array([[1, 2]]))
    np.testing.assert_array_equal(
        tbase.concat_indices(*parts).numpy(),
        np.asarray(jbase.concat_indices(*parts)))


def test_invdepth_factor_batch_matches_jax(probs):
    """The two-frame-one-camera inverse-depth factor on the problem's
    states, rows from a numpy seed (one invalid)."""
    from rtk_visual_inertial_navigation_tpu.factors import visual as jvis
    from rtk_visual_inertial_navigation_tpu_torch.factors import \
        visual as tvis
    jp, tp = probs
    rng = np.random.default_rng(2)
    n = 7
    rows = dict(host=rng.integers(0, NF, size=(B, n)),
                obs=rng.integers(0, NF, size=(B, n)),
                cam=np.zeros((B, n), dtype=np.int64),
                idep=rng.uniform(0.05, 0.5, size=(B, n)),
                pts=np.concatenate([rng.uniform(-0.5, 0.5, size=(B, n, 2)),
                                    np.ones((B, n, 1))], -1),
                meas=rng.uniform(-0.5, 0.5, size=(B, n, 2)),
                valid=rng.random((B, n)) < 0.8)
    pbg = np.array([0.02, -0.01, 0.03])
    jres, jjac = jax.jit(jax.vmap(lambda s, *r: jvis.invdepth_factor_batch(
        s, *r, jnp.asarray(pbg))))(
        jp.state0, *[jnp.asarray(v) for v in rows.values()])
    res, jac = tvis.invdepth_factor_batch(
        tp.state0, *[torch.from_numpy(v) for v in rows.values()],
        torch.from_numpy(pbg))
    for got, r in ((res, jres), (jac, jjac)):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, rtol=0,
                                   atol=1e-10 * max(np.abs(r).max(), 1.0))
