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
from rtk_visual_inertial_navigation_tpu_torch.ops.launches import LAUNCHES
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_chol_lanes import (
    _factor_cuda, chol_factor_lanes, chol_factor_lanes_plain,
    chol_solve_factored, chol_solve_factored_plain, chol_solve_lanes,
    chol_solve_lanes_plain)
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
    proj_plan, proj_segments_pallas, proj_segments_plain)

EXT = ("PE", "EE", "LE", "GE")


def _rand_proj_problem(seed, dtype, B=2, nf=4, nl=12, nc=2, nobs=37,
                       layout="random"):
    """Random frames, landmarks and extrinsics, every 5th row invalid, 15 %
    of the landmarks dragged onto the camera plane (exercises the safe-z
    clamp).  Ids by ``layout``: "random" (ragged nobs, repeated (f, l)
    pairs wherever the draw gives them), "flagship" (landmark-contiguous,
    observation o = nf·l + f, as make_synthetic_rtk_windows lays them out:
    landmarks past nobs / nf have none) or "repeats" (every observation
    of a row given twice, then landmarks past nl / 2 left out)."""
    rng = np.random.default_rng(seed)
    off = np.array([4.0, 0, 0, 0])
    unit = lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(B, nf, 3))
    lm = rng.normal(size=(B, nl, 3)) * 3.0 + np.array([0, 0, 8.0])
    lm[:, :max(1, int(0.15 * nl)), 2] = p[:, :1, 2] + 1e-4
    f = lambda a: torch.from_numpy(a).to(dtype).cuda()
    ids = {n: rng.integers(0, m, (B, nobs))
           for n, m in (("f", nf), ("c", nc), ("l", nl))}
    o = np.arange(nobs)
    if layout == "flagship":
        ids["f"], ids["l"] = np.broadcast_to(o % nf, (B, nobs)), \
            np.broadcast_to(o // nf, (B, nobs))
    elif layout == "repeats":
        ids["f"] = ids["f"][:, o // 2]
        ids["l"] = ids["l"][:, o // 2] % max(1, nl // 2)
    i = lambda a: torch.from_numpy(np.array(a)).cuda()
    return (TangentLayout(nf=nf, nl=nl, nb=4, nc=nc), f(p),
            f(unit(rng.normal(size=(B, nf, 4)) + off)),
            f(0.05 * rng.normal(size=(B, nc, 3))),
            f(unit(rng.normal(size=(B, nc, 4)) + off)), f(lm),
            f(0.01 * rng.normal(size=3)), i(ids["f"]), i(ids["c"]),
            i(ids["l"]), f(0.3 * rng.normal(size=(B, nobs, 2))),
            torch.from_numpy(o % 5 != 3).expand(B, nobs).contiguous().cuda())


def _assert_matches_plain(S1, c1, S0, c0, dtype, want_ext):
    """Tolerances of tests/test_pallas_proj.py:79-80 (scale-aware: the
    kernel sums in another order than the plain version), the cost held to
    the same rule."""
    eps = 3e-13 if dtype == torch.float64 else 2e-4
    rtol = 1e-9 if dtype == torch.float64 else 2e-3
    keys = list(S0) if want_ext else [k for k in S0 if k not in EXT]
    for k in keys + ["cost"]:
        ref = (c0 if k == "cost" else S0[k]).double().cpu()
        got = (c1 if k == "cost" else S1[k]).double().cpu()
        atol = eps * max(ref.abs().max().item(), 1.0)
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=k)
    if not want_ext:
        assert not any(bool(S1[k].any()) for k in EXT)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cauchy_a", [0.0, 1.0])
@pytest.mark.parametrize("want_ext", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_segments_kernel_matches_plain(dtype, want_ext, cauchy_a):
    _needs_cuda()
    dt = getattr(torch, dtype)
    args = _rand_proj_problem(5, dt)
    S1, c1 = proj_segments_pallas(*args, PROJ_SQRT_INFO, cauchy_a=cauchy_a,
                                  want_ext=want_ext)
    S0, c0 = proj_segments_plain(*args, PROJ_SQRT_INFO, cauchy_a=cauchy_a)
    _assert_matches_plain(S1, c1, S0, c0, dt, want_ext)


# (B, nf, nl, nc, nobs, layout): the flagship's layout with landmarks left
# unobserved; repeated pairs; nobs below and above one 128-row chunk, a
# frame and a landmark with more rows than a chunk, nl over several ragged
# 32-landmark tiles; B = 1; nf = 11 in f64 (a block above 48 KB of shared
# memory)
LAYOUTS = [(3, 11, 40, 1, 330, "flagship"), (2, 4, 12, 2, 60, "repeats"),
           (2, 3, 70, 2, 37, "random"), (2, 2, 70, 2, 300, "random"),
           (2, 3, 2, 1, 300, "random"), (1, 5, 60, 2, 200, "flagship"),
           (1, 11, 100, 2, 500, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("want_ext", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", LAYOUTS, ids=lambda c: "-".join(map(str, c)))
def test_proj_segments_kernel_layouts(case, dtype, want_ext):
    _needs_cuda()
    B, nf, nl, nc, nobs, layout = case
    dt = getattr(torch, dtype)
    args = _rand_proj_problem(sum(case[:5]), dt, B, nf, nl, nc, nobs, layout)
    S1, c1 = proj_segments_pallas(*args, PROJ_SQRT_INFO, cauchy_a=1.0,
                                  want_ext=want_ext)
    S0, c0 = proj_segments_plain(*args, PROJ_SQRT_INFO, cauchy_a=1.0)
    _assert_matches_plain(S1, c1, S0, c0, dt, want_ext)
    # landmarks no valid row observes: exactly zero
    l_ids, valid = args[9], args[11]
    seen = torch.zeros((B, nl), dtype=torch.int64, device="cuda")
    seen.scatter_add_(1, l_ids, valid.long())
    unseen = seen == 0
    assert bool(unseen.any()) or layout == "random"
    for k in ("LL", "GL"):
        assert not bool(S1[k][unseen].any()), k
    assert not bool(S1["PL"].transpose(1, 2)[unseen].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_segments_kernel_is_deterministic_and_takes_a_plan(dtype):
    _needs_cuda()
    args = _rand_proj_problem(8, getattr(torch, dtype), 4, 11, 64, 2, 600,
                              "random")
    lay, ids = args[0], (args[7], args[8], args[9], args[11])
    plan = proj_plan(lay, *ids)
    runs = [proj_segments_pallas(*args, PROJ_SQRT_INFO, cauchy_a=1.0,
                                 plan=pl) for pl in (None, plan, plan)]
    for S, c in runs[1:]:
        assert torch.equal(c, runs[0][1])
        for k in S:
            assert torch.equal(S[k], runs[0][0][k]), k
    # a plan of other (equal) ids is refused
    with pytest.raises(ValueError, match="plan"):
        proj_segments_pallas(*args[:7], args[7].clone(), *args[8:],
                             PROJ_SQRT_INFO, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_segments_kernel_frames_without_rows_are_zero(dtype):
    """A frame no valid row observes has zero PP and GP in every call; the
    frame block that owns it must not read shared memory that another warp
    has not yet zeroed (a race that showed only in an occasional call)."""
    _needs_cuda()
    dt = getattr(torch, dtype)
    B, nf = 32, 11
    args = _rand_proj_problem(9, dt, B, nf, 64, 2, 400, "random")
    f_ids, valid = args[7], args[11].clone()
    valid[B // 2:] &= f_ids[B // 2:] < nf - 3     # frames 8-10 left empty
    args = args[:11] + (valid,)
    lay, ids = args[0], (args[7], args[8], args[9], args[11])
    plan = proj_plan(lay, *ids)
    empty = torch.zeros((B, nf), dtype=torch.bool, device="cuda")
    empty[B // 2:, nf - 3:] = True
    S0, c0 = proj_segments_pallas(*args, PROJ_SQRT_INFO, want_ext=False,
                                  plan=plan)
    for _ in range(200):
        torch.randn(1 << 20, device="cuda")   # other data in the memory
        S, c = proj_segments_pallas(*args, PROJ_SQRT_INFO, want_ext=False,
                                    plan=plan)
        assert not bool(S["PP"][empty].any())
        assert not bool(S["GP"][empty].any())
        assert torch.equal(c, c0)
        for k in S:
            assert torch.equal(S[k], S0[k]), k


@pytest.mark.cuda
def test_proj_segments_kernel_refuses_too_large_nf():
    _needs_cuda()
    args = _rand_proj_problem(9, torch.float64, 1, 2000, 4, 1, 10)
    with pytest.raises(ValueError, match="shared memory"):
        proj_segments_pallas(*args, PROJ_SQRT_INFO)


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
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("B,n,not_spd", [
    (256, 120, False), (32, 339, False), (1, 327, False), (300, 37, False),
    (3, 400, False), (4, 40, True)])
def test_chol_factor_and_solve_kernels_match_plain(B, n, not_spd, k):
    """The factor kernel (L, info) and the solve kernel (x, k right-hand
    sides) against their plain versions, at the shapes of the VI step
    (256, 120), the flagship step and covariance (32, 339) and the
    estimator pipeline's one-window step (1, 327), a ragged n, an n above
    the flagship's, and a non-SPD input (last pivot negative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    S, _ = _spd_systems(8, B, n, not_spd)
    rng = np.random.default_rng(9)
    b = torch.from_numpy(rng.normal(size=(B, n) if k == 1 else (B, n, k))
                         .astype(np.float32)).cuda()
    L1, info1 = chol_factor_lanes(S)
    L0, info0 = chol_factor_lanes_plain(S)
    torch.cuda.synchronize()
    assert info1.dtype == torch.int32
    torch.testing.assert_close(info1, info0, rtol=0, atol=0)
    assert bool((info1 != 0).all()) if not_spd else not bool(info1.any())
    assert bool(torch.isfinite(L1).all())
    assert not bool(torch.triu(L1, 1).any())
    # same recurrence, f32 sums in another order
    torch.testing.assert_close(L1, L0, rtol=0,
                               atol=1e-5 * L0.abs().max().item())
    x1 = chol_solve_factored(L1, b)
    x0 = chol_solve_factored_plain(L1, b)
    torch.cuda.synchronize()
    assert x1.shape == b.shape and bool(torch.isfinite(x1).all())
    torch.testing.assert_close(x1, x0, rtol=0,
                               atol=1e-5 * max(x0.abs().max().item(), 1.0))
    if not not_spd:       # the residual rule of tests/test_pallas_chol.py:31
        bb = b if k > 1 else b[..., None]
        xx = x1 if k > 1 else x1[..., None]
        r = S.double() @ xx.double() - bb.double()
        rel = r.norm(dim=1) / bb.double().norm(dim=1)
        assert rel.max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [2, 3, 4, 8])
def test_chol_factor_kernel_cluster_sizes_agree(cluster):
    """At the flagship shape every cluster size gives the same factor (the
    per-tile arithmetic does not depend on which CTA owns a tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    S, _ = _spd_systems(10, 32, 339)
    L, info = _factor_cuda(S, cluster)
    L0, _ = chol_factor_lanes(S)
    torch.cuda.synchronize()
    assert not bool(info.any())
    torch.testing.assert_close(L, L0, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, 9))
def test_chol_factor_kernel_cluster_sizes_at_one_window(cluster):
    """At the estimator pipeline's one-window shape (B=1, n=327) every
    cluster size either is refused (its CTAs do not fit the shared memory)
    or gives the launcher's factor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    S, _ = _spd_systems(13, 1, 327)
    L0, _ = chol_factor_lanes(S)
    try:
        L, info = _factor_cuda(S, cluster)
    except ValueError:
        return
    torch.cuda.synchronize()
    assert not bool(info.any())
    torch.testing.assert_close(L, L0, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 16])
def test_chol_solve_scaled_on_cuda_uses_the_kernels(monkeypatch, k):
    """The routed f32 step solve (k = 0: one right-hand side, as the step;
    k = 16: tail_cov's columns) at the flagship's reduced shape calls no
    torch.linalg Cholesky: both library calls raise here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import _chol_solve_scaled

    def refuse(*a, **kw):
        raise AssertionError("torch.linalg Cholesky called on the f32 path")

    S, _ = _spd_systems(11, 32, 339)
    s = torch.rsqrt(torch.diagonal(S, dim1=-2, dim2=-1))
    A = S * s[:, :, None] * s[:, None, :]
    rng = np.random.default_rng(12)
    b = torch.from_numpy(rng.normal(size=(32, 339) if k == 0 else
                                    (32, 339, k)).astype(np.float32)).cuda()
    A[3, 7, 7] = -1.0                       # this system's factor fails
    monkeypatch.setattr(torch.linalg, "cholesky_ex", refuse)
    monkeypatch.setattr(torch, "cholesky_solve", refuse)
    LAUNCHES.clear()
    x = _chol_solve_scaled(A, b)
    torch.cuda.synchronize()
    assert LAUNCHES["chol_lanes"] == 1 and LAUNCHES["chol_lanes_solve"] == 3
    assert bool(torch.isnan(x[3]).all())
    ok = [i for i in range(32) if i != 3]
    Ad = A[ok].double() + 1e-5 * torch.eye(339, device="cuda",
                                           dtype=torch.float64)
    bd = b[ok].double()
    ref = torch.linalg.solve(Ad, bd if k else bd[..., None])
    ref = ref if k else ref[..., 0]
    err = (x[ok].double() - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item(), err