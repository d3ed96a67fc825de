"""PyTorch port vs JAX reference: lie ops, window retraction/boxminus and
IMU preintegration (float64, CPU, inputs from a numpy seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.core import state as jstate
from rtk_visual_inertial_navigation_tpu.ops import lie as jlie
from rtk_visual_inertial_navigation_tpu.preintegration import \
    preintegrate as jpreintegrate
from rtk_visual_inertial_navigation_tpu_torch.core import state as tstate
from rtk_visual_inertial_navigation_tpu_torch.ops import lie as tlie
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems import \
    IMU_NOISE
from rtk_visual_inertial_navigation_tpu_torch.preintegration.midpoint \
    import preintegrate as tpreintegrate

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)

ATOL = 1e-12
RNG = np.random.default_rng(0)


def _quats(n):
    q = RNG.normal(size=(n, 4))
    q[:2] = [[1, 0, 0, 0], [1, 1e-6, -2e-6, 0]]     # identity + near it
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


Q1, Q2 = _quats(16), _quats(16)
V3 = RNG.normal(size=(16, 3))
V3[0] = 0.0                                        # zero rotation vector
V3[1] = 1e-5 * V3[1]                               # Taylor branch
R3 = np.stack([np.asarray(jlie.quat_to_rot(jnp.asarray(q))) for q in
               _quats(16)])
R3[2] = np.diag([1.0, -1.0, -1.0])                 # x-pivot (pi about x)
R3[3] = np.diag([-1.0, 1.0, -1.0])                 # y-pivot
R3[4] = np.diag([-1.0, -1.0, 1.0])                 # z-pivot

CASES = {
    "quat_mul": (Q1, Q2), "quat_conj": (Q1,), "quat_normalize": (3 * Q1,),
    "quat_rotate": (Q1, V3), "quat_rotate_inv": (Q1, V3),
    "quat_to_rot": (Q1,), "rot_to_quat": (R3,), "skew": (V3,),
    "quat_exp": (V3,), "quat_log": (Q1,), "delta_q_first_order": (V3,),
    "quat_boxplus": (Q1, V3), "quat_boxminus": (Q1, Q2), "qleft": (Q1,),
    "qright": (Q1,), "ypr_to_rot": (100 * V3,), "rot_to_ypr": (R3,),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_matches_jax(name):
    args = CASES[name]
    ref = np.asarray(getattr(jlie, name)(*map(jnp.asarray, args)))
    got = getattr(tlie, name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _np_state(nf=4, nl=5, nb=3, nc=2):
    return dict(
        p=RNG.normal(size=(nf, 3)), q=_quats(nf), v=RNG.normal(size=(nf, 3)),
        ba=RNG.normal(size=(nf, 3)), bg=RNG.normal(size=(nf, 3)),
        clk=RNG.normal(size=(nf, 13)), tic=RNG.normal(size=(nc, 3)),
        qic=_quats(nc), mag_bias=RNG.normal(size=3),
        landmarks=RNG.normal(size=(nl, 3)), phase_bias=RNG.normal(size=nb))


def test_retract_and_boxminus_match_jax():
    x0 = _np_state()
    jx0 = jstate.WindowState(**{k: jnp.asarray(v) for k, v in x0.items()})
    dim = jstate.layout_of(jx0).dim
    dx = 0.1 * RNG.normal(size=(2, dim))
    tx0 = tstate.WindowState(**{k: torch.from_numpy(np.stack([v, v]))
                                for k, v in x0.items()})
    tx1 = tstate.retract_window(tx0, torch.from_numpy(dx))
    assert tstate.layout_of(tx0) == tuple(jstate.layout_of(jx0))
    for b in range(2):
        jx1 = jstate.retract_window(jx0, jnp.asarray(dx[b]))
        for k in x0:
            np.testing.assert_allclose(getattr(tx1, k)[b].numpy(),
                                       np.asarray(getattr(jx1, k)),
                                       rtol=0, atol=ATOL, err_msg=k)
        ref = np.asarray(jstate.window_boxminus(jx1, jx0))
        got = tstate.window_boxminus(tx1, tx0)[b].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, dx[b], rtol=0, atol=1e-10)


def test_preintegrate_matches_jax():
    n, S = 5, 9
    dts = np.full((n, S), 0.005) + 1e-3 * RNG.random((n, S))
    accs = RNG.normal(size=(n, S, 3)) + np.array([0, 0, 9.81])
    gyrs = 0.5 * RNG.normal(size=(n, S, 3))
    valid = np.ones((n, S), dtype=bool)
    valid[1, 6:] = False                           # a short interval
    ba, bg = 0.1 * RNG.normal(size=(n, 3)), 0.01 * RNG.normal(size=(n, 3))
    ref = jax.vmap(jpreintegrate, in_axes=(0,) * 6 + (None,))(
        *map(jnp.asarray, (dts, accs, gyrs, valid, ba, bg)), IMU_NOISE)
    got = tpreintegrate(*map(torch.from_numpy, (dts, accs, gyrs, valid, ba,
                                                bg)), IMU_NOISE)
    for k in got._fields:
        r = np.asarray(getattr(ref, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), r, rtol=0,
                                   atol=ATOL * max(np.abs(r).max(), 1.0),
                                   err_msg=k)
