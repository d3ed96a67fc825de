"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; on the CPU the wrappers run the plain
versions, which tests/test_torch_proj.py holds against the JAX reference).
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
