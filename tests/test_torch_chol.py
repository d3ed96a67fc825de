"""The batched Cholesky of the PyTorch port (``chol_factor_lanes``,
``chol_solve_factored`` and ``chol_solve_lanes``) against the JAX package's
Pallas kernel in interpret mode (CPU, float32) and numpy (float64), and the
f32 step solve routed through it.

On the CPU the port's wrappers run their plain versions, the same blocked
recurrence as the kernels; the CUDA kernels themselves are held against
those plain versions in tests/test_torch_kernels.py on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.ops.pallas_chol_lanes import \
    chol_solve_lanes as jax_chol_solve_lanes
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_chol_lanes import (
    chol_factor_lanes, chol_factor_lanes_plain, chol_solve_factored,
    chol_solve_factored_plain, chol_solve_lanes, chol_solve_lanes_plain)
from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton import \
    _chol_solve_scaled

torch.set_num_threads(1)

B, N = 2, 24


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


@pytest.mark.parametrize("n", [13, 45, 70])
def test_chol_factor_plain_matches_numpy(n):
    """The blocked recurrence (panels of 32, ragged last panel) in float64
    against LAPACK's factor; info on non-SPD systems (a negative pivot
    inside the first panel, a zero one in the last) equals cholesky_ex's."""
    rng = np.random.default_rng(n)
    S = make_spd(rng, 3, n, np.float64)
    L, info = chol_factor_lanes_plain(torch.from_numpy(S))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(S), rtol=0,
                               atol=1e-13)
    assert info.dtype == torch.int32 and not info.any()
    S_bad = S.astype(np.float32)
    S_bad[1, n // 3, n // 3] = -1.0
    S_bad[2, -1, -1] = 0.0
    S_bad = torch.from_numpy(S_bad)
    L, info = chol_factor_lanes(S_bad)
    # the 1e-30 pivot floor: no NaN from the square root; a failure in the
    # last column leaves the factor finite (an earlier one may overflow)
    assert bool(torch.isfinite(L[[0, 2]]).all())
    torch.testing.assert_close(info, torch.linalg.cholesky_ex(S_bad)[1])
    assert info.tolist()[0] == 0


@pytest.mark.parametrize("k", [1, 3])
def test_chol_solve_factored_plain_matches_numpy(k):
    rng = np.random.default_rng(10 + k)
    n = 45
    S = make_spd(rng, 3, n, np.float64)
    b = rng.normal(size=(3, n) if k == 1 else (3, n, k))
    L = torch.from_numpy(np.linalg.cholesky(S))
    x = chol_solve_factored_plain(L, torch.from_numpy(b))
    ref = np.linalg.solve(S, b[..., None] if k == 1 else b)
    np.testing.assert_allclose(x.numpy(), ref[..., 0] if k == 1 else ref,
                               rtol=0, atol=1e-12)
    # the f32 wrapper on CPU tensors is the plain version
    L32, b32 = L.float(), torch.from_numpy(b).float()
    torch.testing.assert_close(chol_solve_factored(L32, b32),
                               chol_solve_factored_plain(L32, b32), rtol=0,
                               atol=0)


def test_chol_solve_scaled_f32_nan_where_the_shifted_factor_fails():
    """The routed f32 step: a system whose shifted factor fails comes back
    NaN (the dogleg's NaN guard relies on it), the other one solved."""
    rng = np.random.default_rng(12)
    n = 40
    A = make_spd(rng, 2, n, np.float64)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", A))
    A = A * d[:, :, None] * d[:, None, :]          # Jacobi-scaled
    A[1, 5, 5] = -1.0
    b = rng.normal(size=(2, n, 2))
    x = _chol_solve_scaled(torch.from_numpy(A).float(),
                           torch.from_numpy(b).float())
    assert bool(torch.isnan(x[1]).all())
    ref = np.linalg.solve(A[0] + 1e-5 * np.eye(n), b[0])
    np.testing.assert_allclose(x[0].numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
