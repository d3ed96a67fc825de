"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; on the CPU the wrappers run the plain
versions, which tests/test_torch_proj.py and tests/test_torch_chol.py hold
against the JAX reference).
This file imports neither jax nor the JAX package, so it also runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.factors.visual import \
    PROJ_SQRT_INFO
from rtk_visual_inertial_navigation_tpu_torch.ops import lie
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_chol_lanes import (
    chol_solve_lanes, chol_solve_lanes_plain)
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
    proj_segments_pallas, proj_segments_plain)


def _rand_proj_problem(seed, dtype, B=2, nf=4, nl=12, nc=2, nobs=37):
    """Random ids (ragged nobs), every 5th row invalid, 15 % of the
    landmarks dragged onto the camera plane (exercises the safe-z clamp)."""
    rng = np.random.default_rng(seed)
    off = np.array([4.0, 0, 0, 0])
    unit = lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(B, nf, 3))
    lm = rng.normal(size=(B, nl, 3)) * 3.0 + np.array([0, 0, 8.0])
    lm[:, :max(1, int(0.15 * nl)), 2] = p[:, :1, 2] + 1e-4
    f = lambda a: torch.from_numpy(a).to(dtype).cuda()
    i = lambda n: torch.from_numpy(rng.integers(0, n, (B, nobs))).cuda()
    return (TangentLayout(nf=nf, nl=nl, nb=4, nc=nc), f(p),
            f(unit(rng.normal(size=(B, nf, 4)) + off)),
            f(0.05 * rng.normal(size=(B, nc, 3))),
            f(unit(rng.normal(size=(B, nc, 4)) + off)), f(lm),
            f(0.01 * rng.normal(size=3)), i(nf), i(nc), i(nl),
            f(0.3 * rng.normal(size=(B, nobs, 2))),
            torch.from_numpy(np.arange(nobs) % 5 != 3).expand(
                B, nobs).contiguous().cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("cauchy_a", [0.0, 1.0])
@pytest.mark.parametrize("want_ext", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_segments_kernel_matches_plain(dtype, want_ext, cauchy_a):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _rand_proj_problem(5, getattr(torch, dtype))
    S1, c1 = proj_segments_pallas(*args, PROJ_SQRT_INFO, cauchy_a=cauchy_a,
                                  want_ext=want_ext)
    S0, c0 = proj_segments_plain(*args, PROJ_SQRT_INFO, cauchy_a=cauchy_a)
    # tolerances of tests/test_pallas_proj.py:79-80 (scale-aware: the
    # kernel's atomics sum in another order), the cost held to the same rule
    eps = 3e-13 if dtype == "float64" else 2e-4
    rtol = 1e-9 if dtype == "float64" else 2e-3
    ext = ("PE", "EE", "LE", "GE")
    keys = list(S0) if want_ext else [k for k in S0 if k not in ext]
    for k in keys + ["cost"]:
        ref = (c0 if k == "cost" else S0[k]).double().cpu()
        got = (c1 if k == "cost" else S1[k]).double().cpu()
        atol = eps * max(ref.abs().max().item(), 1.0)
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=k)
    if not want_ext:
        assert not any(bool(S1[k].any()) for k in ext)


def _spd_systems(seed, B, n, not_spd=False):
    """The recipe of tests/test_pallas_chol.py:15-18; ``not_spd`` makes the
    last pivot negative (the 1e-30 pivot floor keeps x finite)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, 3 * n)).astype(np.float32)
    S = A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n, dtype=np.float32)
    if not_spd:
        S[:, -1, -1] = -1.0
    rhs = rng.normal(size=(B, n)).astype(np.float32)
    return torch.from_numpy(S).cuda(), torch.from_numpy(rhs).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,not_spd", [
    (256, 120, False), (2, 48, False), (300, 37, False), (4, 40, True)])
def test_chol_lanes_kernel_matches_plain(B, n, not_spd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    S, rhs = _spd_systems(6, B, n, not_spd)
    x1 = chol_solve_lanes(S, rhs)
    x0 = chol_solve_lanes_plain(S, rhs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x1).all())
    # same recurrence, f32 sums in another order: roundoff relative to the
    # largest entry
    torch.testing.assert_close(x1, x0, rtol=0,
                               atol=1e-5 * max(x0.abs().max().item(), 1.0))
    if not not_spd:
        r = torch.einsum("bij,bj->bi", S.double(), x1.double()) - rhs
        rel = r.norm(dim=1) / rhs.double().norm(dim=1)
        assert rel.max().item() < 1e-4


@pytest.mark.cuda
def test_chol_lanes_kernel_refuses_too_large_n():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    S, rhs = _spd_systems(7, 1, 300)
    with pytest.raises(ValueError, match="shared memory"):
        chol_solve_lanes(S, rhs)
