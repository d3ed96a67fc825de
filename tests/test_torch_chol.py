"""The batched Cholesky solve of the PyTorch port (``chol_solve_lanes``)
against the JAX package's Pallas kernel in interpret mode (CPU, float32).

On the CPU the port's wrapper runs its plain version, the same column
recurrence as the kernel; the CUDA kernel itself is held against that
plain version in tests/test_torch_kernels.py on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.ops.pallas_chol_lanes import \
    chol_solve_lanes as jax_chol_solve_lanes
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_chol_lanes import (
    chol_solve_lanes, chol_solve_lanes_plain)

torch.set_num_threads(1)

B, N = 2, 48


def make_spd(rng, B, n, dtype=np.float32):
    """The recipe of tests/test_pallas_chol.py:15-18."""
    A = rng.normal(size=(B, n, 3 * n)).astype(dtype)
    return A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n, dtype=dtype)


@pytest.fixture(scope="module")
def systems():
    """SPD systems, and the same with a negative last pivot (not SPD: the
    1e-30 pivot floor keeps the factor finite), with the JAX kernel's x.
    Both sets go through one interpreted kernel call (the kernel pads the
    batch to 128 systems anyway, and each call costs seconds)."""
    rng = np.random.default_rng(3)
    S = make_spd(rng, B, N)
    rhs = rng.normal(size=(B, N)).astype(np.float32)
    S_bad = S.copy()
    S_bad[:, -1, -1] = -1.0
    x = np.asarray(jax_chol_solve_lanes(
        jnp.asarray(np.concatenate([S, S_bad])),
        jnp.asarray(np.concatenate([rhs, rhs])), interpret=True))
    return {"spd": (S, rhs, x[:B]), "not_spd": (S_bad, rhs, x[B:])}


@pytest.mark.parametrize("case", ["spd", "not_spd"])
def test_chol_plain_matches_jax_kernel(systems, case):
    S, rhs, xj = systems[case]
    x = chol_solve_lanes_plain(torch.from_numpy(S), torch.from_numpy(rhs))
    assert x.dtype == torch.float32
    assert bool(torch.isfinite(x).all())
    # same recurrence, f32 sums in another order: roundoff relative to the
    # largest entry (a few ulps times the condition, ~10 here)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0,
                               atol=1e-5 * max(np.abs(xj).max(), 1.0))
    if case == "spd":
        # residual check of tests/test_pallas_chol.py:27-31
        r = np.einsum("bij,bj->bi", S, x.numpy().astype(np.float64)) - rhs
        rel = np.linalg.norm(r, axis=1) / np.linalg.norm(rhs, axis=1)
        assert rel.max() < 1e-4, rel


def test_chol_wrapper_on_cpu_is_plain_and_checks_inputs():
    rng = np.random.default_rng(4)
    # n not a multiple of 8, B not a multiple of 128: no padding needed
    S = torch.from_numpy(make_spd(rng, 3, 13))
    rhs = torch.from_numpy(rng.normal(size=(3, 13)).astype(np.float32))
    torch.testing.assert_close(chol_solve_lanes(S, rhs),
                               chol_solve_lanes_plain(S, rhs), rtol=0, atol=0)
    with pytest.raises(TypeError):
        chol_solve_lanes(S.double(), rhs.double())
    with pytest.raises(ValueError):
        chol_solve_lanes(S, rhs[:, :-1])
    with pytest.raises(ValueError):
        chol_solve_lanes(S[:, :, :-1], rhs)
