"""IMU preintegration factors, batched over windows and intervals.

15-dim [P,R,V,BA,BG] residual between consecutive states, antenna lever arm
``pbg`` included, whitened by the preintegration sqrt-information;
tangent-space Jacobians from reverse-mode autodiff.
"""

from __future__ import annotations

import torch

from ..core.state import POSE_DIM, WindowState, layout_of
from ..ops import lie
from ..ops.linalg import cholesky_nan
from ..preintegration.midpoint import Preintegrated, imu_residual
from .base import FactorBatch, block_indices, rowwise_res_jac


def sqrt_info_of_cov(cov, jitter=1e-12):
    """Lower-triangular W with Wᵀ W = cov⁻¹ (whitening by L⁻¹ of cov=LLᵀ)."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    L = cholesky_nan(cov + jitter * eye)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _imu_res(t, row, pbg, g_world):
    """tangent = [pose_i6, sb_i9, pose_j6, sb_j9] -> whitened 15-residual."""
    pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, W = row
    r = imu_residual(
        pre, g_world,
        p_i + t[0:3], lie.quat_boxplus(q_i, t[3:6]),
        v_i + t[6:9], ba_i + t[9:12], bg_i + t[12:15],
        p_j + t[15:18], lie.quat_boxplus(q_j, t[18:21]),
        v_j + t[21:24], ba_j + t[24:27], bg_j + t[27:30],
        pbg)
    return W @ r


def _single_imu(pre: Preintegrated, p_i, q_i, v_i, ba_i, bg_i,
                p_j, q_j, v_j, ba_j, bg_j, pbg, g_world, W):
    """(res (..., 15), jac (..., 15, 30)) over any leading row dims."""
    return rowwise_res_jac(
        _imu_res, 30,
        (pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, W),
        p_i.dim() - 1, (pbg, g_world))


def imu_factor_batch(state: WindowState, pre: Preintegrated, pbg, g_world,
                     valid, W=None) -> FactorBatch:
    """Evaluate all NF-1 consecutive-frame IMU factors of every window.

    Args:
      state: WindowState with leading window dim B.
      pre: Preintegrated with leading dims (B, NF-1) (interval k spans
        frames k -> k+1).
      valid: (B, NF-1) mask.
      W: optional precomputed (B, NF-1, 15, 15) sqrt-information (pass it
        when solving in float32 with a covariance derived in f64).
    """
    lay = layout_of(state)
    nf = lay.nf
    if W is None:
        W = sqrt_info_of_cov(pre.covariance)
    i, j = slice(0, nf - 1), slice(1, nf)
    res, jac = _single_imu(
        pre, state.p[:, i], state.q[:, i], state.v[:, i], state.ba[:, i],
        state.bg[:, i], state.p[:, j], state.q[:, j], state.v[:, j],
        state.ba[:, j], state.bg[:, j], pbg, g_world, W)

    frame_ids = torch.arange(nf - 1, device=res.device)
    gidx = torch.cat(
        [
            block_indices(lay.pose_idx(frame_ids), POSE_DIM),
            block_indices(lay.sb_idx(frame_ids), 9),
            block_indices(lay.pose_idx(frame_ids + 1), POSE_DIM),
            block_indices(lay.sb_idx(frame_ids + 1), 9),
        ],
        dim=-1,
    ).expand(res.shape[:-1] + (30,))
    m = valid.to(res.dtype)
    return FactorBatch(res * m[..., None], jac * m[..., None, None], gidx,
                       valid)
