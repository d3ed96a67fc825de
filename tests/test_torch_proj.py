"""Projection segments of the PyTorch port vs the JAX oracle and the Pallas
kernel in interpret mode.

On the CPU ``proj_segments_pallas`` of the port runs its plain version;
the CUDA kernel is held against that plain version by
tests/test_torch_kernels.py (on a GPU) and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_proj import _oracle, _rand_problem

from rtk_visual_inertial_navigation_tpu.ops.pallas_proj import \
    proj_segments_pallas as jax_proj_segments_pallas
from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.factors.visual import \
    PROJ_SQRT_INFO
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
    proj_segments_pallas, proj_segments_plain)

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)


# the JAX oracle, jitted: eager op-by-op dispatch of its vmapped jacrev is
# several times slower on the CPU
_jit_oracle = jax.jit(_oracle, static_argnums=(0, 8))


def _port_args(prob, dtype):
    """The JAX test problem as batched (B=1) torch inputs."""
    lay, state, pbg, f_ids, cam_ids, l_ids, xy, valid = prob
    t = lambda x: torch.from_numpy(np.array(x)).to(dtype)[None]
    i = lambda x: torch.from_numpy(np.array(x)).long()[None]
    return (TangentLayout(*lay), t(state.p), t(state.q), t(state.tic),
            t(state.qic), t(state.landmarks), t(pbg)[0], i(f_ids),
            i(cam_ids), i(l_ids), t(xy), torch.from_numpy(
                np.array(valid))[None])


def _assert_segments(S1, c1, S0, c0, eps, rtol, cost_rtol):
    for k in S0:
        ref = np.asarray(S0[k])
        atol = eps * max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(S1[k][0].double().numpy(), ref,
                                   rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(c1[0].double().numpy(), np.asarray(c0),
                               rtol=cost_rtol)


@pytest.mark.parametrize("cauchy_a", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_jax_oracle(dtype, cauchy_a):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    prob = _rand_problem(jax.random.PRNGKey(0), dtype=jdt,
                         near_plane_frac=0.15)
    S0, c0 = _jit_oracle(*prob, cauchy_a)
    S1, c1 = proj_segments_pallas(*_port_args(prob, tdt), PROJ_SQRT_INFO,
                                  cauchy_a=cauchy_a)
    # tolerances of tests/test_pallas_proj.py:79-80 and :86
    eps = 3e-13 if dtype == "float64" else 2e-4
    rtol = 1e-9 if dtype == "float64" else 2e-3
    _assert_segments(S1, c1, S0, c0, eps, rtol, 1e-5)


def test_plain_matches_pallas_interpret():
    prob = _rand_problem(jax.random.PRNGKey(4), near_plane_frac=0.15)
    lay, state, pbg, f_ids, cam_ids, l_ids, xy, valid = prob
    S0, c0 = jax_proj_segments_pallas(
        lay, state.p, state.q, state.tic, state.qic, state.landmarks, pbg,
        f_ids, cam_ids, l_ids, xy, valid, PROJ_SQRT_INFO, cauchy_a=1.0,
        tile=16, interpret=True)
    S1, c1 = proj_segments_plain(*_port_args(prob, torch.float64),
                                 PROJ_SQRT_INFO, cauchy_a=1.0)
    _assert_segments(S1, c1, S0, c0, 3e-13, 1e-9, 1e-9)


def test_plain_ragged_obs_matches_oracle():
    # the ragged case of tests/test_pallas_proj.py:89-101, same tolerances
    prob = _rand_problem(jax.random.PRNGKey(1), nobs=37)
    S0, c0 = _jit_oracle(*prob, 0.0)
    S1, c1 = proj_segments_pallas(*_port_args(prob, torch.float64),
                                  PROJ_SQRT_INFO)
    for k in S0:
        np.testing.assert_allclose(S1[k][0].numpy(), np.asarray(S0[k]),
                                   rtol=1e-9, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(c1[0].numpy(), np.asarray(c0), rtol=1e-9)

