"""Visual reprojection factors, batched over windows and observations.

World-point parameterization with the antenna lever arm: state P is the
*antenna* position, so the point in the camera frame is
  X_cam = R_icᵀ (R_bodyᵀ (X_world - P) + Pbg - t_ic).

Whitening: sqrt_info = (FOCAL_LENGTH / FEATURE_WEIGHT_INV) · I₂ —
residuals are unit-plane errors scaled to ~pixels.
"""

from __future__ import annotations

import torch

from ..core.state import POSE_DIM, WindowState, layout_of
from ..ops import lie
from .base import FactorBatch, block_indices, rowwise_res_jac, take_rows

FOCAL_LENGTH = 1000.0
FEATURE_WEIGHT_INV = 1.5
PROJ_SQRT_INFO = FOCAL_LENGTH / FEATURE_WEIGHT_INV


def project_world_point(p_f, q_f, tic, qic, lm, pbg):
    """Camera-frame coordinates of world point lm seen from frame (p_f,q_f)."""
    pts_imu = lie.quat_rotate_inv(q_f, lm - p_f)
    return lie.quat_rotate_inv(qic, pts_imu + pbg - tic)


def _safe_z(z, eps=1e-3):
    """Clamp |z| away from 0 so masked/degenerate observations cannot inject
    NaN into the batch (NaN * 0 mask = NaN would poison the Hessian)."""
    e = torch.full_like(z, eps)   # a scalar-only where() would be f32
    return torch.where(z.abs() < eps, torch.where(z < 0, -e, e), z)


def _proj_res(t, row, pbg, weight):
    """tangent = [pose6, ext6, lm3] -> whitened 2-residual of one row."""
    p_f, q_f, tic, qic, lm, meas_xy = row
    pc = project_world_point(
        p_f + t[0:3], lie.quat_boxplus(q_f, t[3:6]),
        tic + t[6:9], lie.quat_boxplus(qic, t[9:12]),
        lm + t[12:15], pbg)
    return weight * (pc[0:2] / _safe_z(pc[2]) - meas_xy)


def _single_proj(p_f, q_f, tic, qic, lm, meas_xy, pbg, weight):
    """(res (..., 2), jac (..., 2, 15)) over any leading row dims."""
    return rowwise_res_jac(_proj_res, 15, (p_f, q_f, tic, qic, lm, meas_xy),
                           p_f.dim() - 1, (pbg, weight))


def projection_factor_batch(state: WindowState, frame_ids, cam_ids, lm_ids,
                            meas_xy, valid, pbg,
                            weight=PROJ_SQRT_INFO) -> FactorBatch:
    """Evaluate world-point reprojection factors for a batch of windows.

    Args:
      state: WindowState with leading window dim B.
      frame_ids, cam_ids, lm_ids: (B, nobs) integer slots.
      meas_xy: (B, nobs, 2) measured unit-plane coordinates.
      valid: (B, nobs) bool.
      pbg: (3,) antenna lever arm.
    """
    lay = layout_of(state)
    res, jac = _single_proj(
        take_rows(state.p, frame_ids), take_rows(state.q, frame_ids),
        take_rows(state.tic, cam_ids), take_rows(state.qic, cam_ids),
        take_rows(state.landmarks, lm_ids), meas_xy, pbg, weight)
    gidx = torch.cat(
        [
            block_indices(lay.pose_idx(frame_ids), POSE_DIM),
            block_indices(lay.ext_idx(cam_ids), POSE_DIM),
            block_indices(lay.lm_idx(lm_ids), 3),
        ],
        dim=-1,
    )
    m = valid.to(res.dtype)
    return FactorBatch(res * m[..., None], jac * m[..., None, None], gidx,
                       valid)
