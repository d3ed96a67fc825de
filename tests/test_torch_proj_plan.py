"""The projection kernel's observation grouping (``proj_plan``) against a
numpy stable sort, and the wrapper's plan checks, on the CPU.

The plan is plain torch, so it runs here; the kernel that reads it is held
against its plain version by tests/test_torch_kernels.py on a GPU.  This
file imports neither jax nor the JAX package.
"""

import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.factors.visual import \
    PROJ_SQRT_INFO
from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
    proj_plan, proj_segments_pallas, proj_segments_plain)


def _ids(seed, B, nobs, nf, nl, nc):
    """Random ids with repeats of (f, l) pairs, a few out of range on
    either side, and about a quarter of the rows invalid."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-1, nf + 1, (B, nobs))
    c = rng.integers(0, nc + 1, (B, nobs))
    l = rng.integers(-2, nl + 2, (B, nobs))
    l[:, 1::7] = l[:, 0::7][:, :l[:, 1::7].shape[1]]      # repeated pairs
    f[:, 1::7] = f[:, 0::7][:, :f[:, 1::7].shape[1]]
    valid = rng.random((B, nobs)) > 0.25
    return f, c, l, valid


def _reference(key, live, n, step):
    """Stable sort of each window's live rows by ``key`` < n·step: the
    permutation and where keys 0, step, .., n·step start."""
    perm, off = [], []
    for b in range(key.shape[0]):
        k = np.where(live[b], key[b], n * step)
        order = np.argsort(k, kind="stable")
        perm.append(order[k[order] < n * step])
        off.append(np.searchsorted(k[order], np.arange(n + 1) * step))
    return perm, np.stack(off)


@pytest.mark.parametrize("B,nobs,nf,nl,nc", [
    (3, 37, 4, 12, 2), (1, 300, 11, 40, 1), (2, 5, 3, 50, 2),
    (2, 0, 3, 4, 1)])
def test_plan_matches_numpy_stable_sort(B, nobs, nf, nl, nc):
    f, c, l, valid = _ids(B * 100 + nobs, B, nobs, nf, nl, nc)
    lay = TangentLayout(nf=nf, nl=nl, nb=1, nc=nc)
    t = lambda a: torch.from_numpy(a)
    plan = proj_plan(lay, t(f), t(c), t(l), t(valid))
    live = valid & (f >= 0) & (f < nf) & (c >= 0) & (c < nc) & (l >= 0) \
        & (l < nl)
    # by (landmark, frame), offsets per landmark; by frame
    for key, n, step, rows, off in (
            (l * nf + f, nl, nf, plan.rows_l, plan.off_l),
            (f, nf, 1, plan.rows_f, plan.off_f)):
        ref_perm, ref_off = _reference(key, live, n, step)
        assert rows.dtype == off.dtype == torch.int32
        assert tuple(rows.shape) == (B, nobs, 4)
        assert tuple(off.shape) == (B, n + 1)
        np.testing.assert_array_equal(off.numpy(), ref_off)
        for b in range(B):
            n_live = int(off[b, n])
            assert n_live == int(live[b].sum())
            o = ref_perm[b]
            ref_rows = np.stack([o, f[b, o], c[b, o], l[b, o]], axis=-1)
            np.testing.assert_array_equal(rows[b, :n_live].numpy(),
                                          ref_rows.reshape(-1, 4))
    assert not bool(plan.counter.any())


def test_plan_is_checked_against_the_ids():
    B, nobs, nf, nl, nc = 2, 20, 3, 6, 2
    rng = np.random.default_rng(4)
    # in range: the plain version gathers by id
    f, c, l = (torch.from_numpy(rng.integers(0, n, (B, nobs)))
               for n in (nf, nc, nl))
    valid = torch.from_numpy(rng.random((B, nobs)) > 0.25)
    lay = TangentLayout(nf=nf, nl=nl, nb=1, nc=nc)
    fl = lambda *s: torch.from_numpy(rng.normal(size=s))
    q = torch.tensor([1.0, 0, 0, 0]).expand(B, nf, 4).contiguous()
    qic = torch.tensor([1.0, 0, 0, 0]).expand(B, nc, 4).contiguous()
    lm = fl(B, nl, 3) + torch.tensor([0, 0, 8.0], dtype=torch.float64)
    args = (lay, fl(B, nf, 3), q.double(), 0.05 * fl(B, nc, 3),
            qic.double(), lm, 0.01 * fl(3))
    xy = 0.3 * fl(B, nobs, 2)
    plan = proj_plan(lay, f, c, l, valid)
    # the plan of these ids: the plain version's result, unchanged
    S1, c1 = proj_segments_pallas(*args, f, c, l, xy, valid, PROJ_SQRT_INFO,
                                  plan=plan)
    S0, c0 = proj_segments_plain(*args, f, c, l, xy, valid, PROJ_SQRT_INFO)
    for k in S0:
        torch.testing.assert_close(S1[k], S0[k], rtol=0, atol=0)
    torch.testing.assert_close(c1, c0, rtol=0, atol=0)
    # equal ids in another tensor, ids changed in place, another layout
    with pytest.raises(ValueError, match="plan"):
        proj_segments_pallas(*args, f.clone(), c, l, xy, valid,
                             PROJ_SQRT_INFO, plan=plan)
    lay2 = TangentLayout(nf=nf, nl=nl + 1, nb=1, nc=nc)
    with pytest.raises(ValueError, match="plan"):
        proj_segments_pallas(lay2, *args[1:], f, c, l, xy, valid,
                             PROJ_SQRT_INFO, plan=plan)
    l[0, 0] = 1
    with pytest.raises(ValueError, match="plan"):
        proj_segments_pallas(*args, f, c, l, xy, valid, PROJ_SQRT_INFO,
                             plan=plan)


def test_plan_refuses_mismatched_ids():
    lay = TangentLayout(nf=3, nl=4, nb=1, nc=1)
    f = torch.zeros((2, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="l_ids"):
        proj_plan(lay, f, f, f[:, :4], torch.ones((2, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match="valid"):
        proj_plan(lay, f, f, f, torch.ones((2, 5), dtype=torch.int64))
