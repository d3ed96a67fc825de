"""PyTorch port vs JAX reference: IMU and GNSS factor batches (res, jac,
gidx) on the JAX synthetic RTK problem, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _np(x):
    if hasattr(x, "_asdict"):
        return {k: _np(v) for k, v in x._asdict().items()}
    return np.asarray(x)


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
    ("doppler_batch", "b_dopp")])
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
