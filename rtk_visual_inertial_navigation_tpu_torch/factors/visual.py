"""Visual reprojection factors, batched over windows and observations.

World-point parameterization with the antenna lever arm: state P is the
*antenna* position, so the point in the camera frame is
  X_cam = R_icᵀ (R_bodyᵀ (X_world - P) + Pbg - t_ic).
The inverse-depth parameterization (``invdepth_projection_batch``) hosts
each landmark's depth in the camera of its first observing frame.

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


def _invdepth_transform(p_i, q_i, p_j, q_j, te_i, qe_i, te_j, qe_j,
                        inv_dep, pts_i, pbg):
    """Inverse-depth point hosted in camera (te_i,qe_i) at frame i, observed
    by camera (te_j,qe_j) at frame j."""
    pts_cam_i = pts_i / inv_dep
    pts_imu_i = lie.quat_rotate(qe_i, pts_cam_i) + te_i - pbg
    pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.quat_rotate_inv(q_j, pts_w - p_j)
    return lie.quat_rotate_inv(qe_j, pts_imu_j + pbg - te_j)


def _invdepth_res(t, row, pbg, weight):
    """Two frames, two cameras (host cam0 at i, observed by cam c at j);
    tangent = [pose_i6, pose_j6, ext0_6, ext_c6, invdepth1] —
    ProjectionTwoFrameTwoCamFactor (projection_factor.cpp:77-168)."""
    p_i, q_i, p_j, q_j, tic, qic, tic2, qic2, inv_dep, pts_i, pts_j_xy = row
    qi = lie.quat_boxplus(q_i, t[3:6])
    qj = lie.quat_boxplus(q_j, t[9:12])
    te0, qe0 = tic + t[12:15], lie.quat_boxplus(qic, t[15:18])
    te1, qe1 = tic2 + t[18:21], lie.quat_boxplus(qic2, t[21:24])
    pc = _invdepth_transform(p_i + t[0:3], qi, p_j + t[6:9], qj,
                             te0, qe0, te1, qe1, inv_dep + t[24], pts_i, pbg)
    return weight * (pc[0:2] / _safe_z(pc[2]) - pts_j_xy)


def invdepth_projection_batch(state: WindowState, host_ids, obs_ids,
                              cam_ids, slot_ids, pts_host_xy, meas_xy,
                              valid, pbg, weight=PROJ_SQRT_INFO
                              ) -> FactorBatch:
    """Inverse-depth projection factors (ids (B, nobs)) as one uniform
    batch covering all three reference parameterizations
    (projection_factor.cpp):

      - mono cross-frame (TwoFrameOneCam):   cam_ids == 0, host != obs
      - stereo cross-frame (TwoFrameTwoCam): cam_ids == 1, host != obs
      - stereo same-frame (OneFrameTwoCam):  cam_ids == 1, host == obs

    One evaluator (the two-cam cross form) serves all rows; shared
    variables are handled by INDEX ALIASING in ``gidx``: for mono rows the
    observer-extrinsic block points at ext0 so both partials scatter-add
    into the same columns (= the total derivative), and for same-frame rows
    the two pose blocks alias (their partials cancel analytically).

    The inverse depth lives in ``state.landmarks[slot, 0]`` (slots keep the
    3-wide world-point layout; columns 1-2 stay masked).
    """
    lay = layout_of(state)
    pts_i = torch.cat([pts_host_xy, torch.ones_like(pts_host_xy[..., :1])],
                      dim=-1)
    idep = take_rows(state.landmarks[..., 0:1], slot_ids)[..., 0]
    idep = torch.where(idep.abs() > 1e-6, idep, 1.0)    # masked-row guard
    zeros = torch.zeros_like(cam_ids)
    rows = (take_rows(state.p, host_ids), take_rows(state.q, host_ids),
            take_rows(state.p, obs_ids), take_rows(state.q, obs_ids),
            take_rows(state.tic, zeros), take_rows(state.qic, zeros),
            take_rows(state.tic, cam_ids), take_rows(state.qic, cam_ids),
            idep, pts_i, meas_xy)
    res, jac = rowwise_res_jac(_invdepth_res, 25, rows, host_ids.dim(),
                               (pbg, weight))
    gidx = torch.cat([
        block_indices(lay.pose_idx(host_ids), POSE_DIM),
        block_indices(lay.pose_idx(obs_ids), POSE_DIM),
        block_indices(lay.ext_idx(zeros), POSE_DIM),
        block_indices(lay.ext_idx(cam_ids), POSE_DIM),
        lay.lm_idx(slot_ids)[..., None],
    ], dim=-1)
    m = valid.to(res.dtype)
    return FactorBatch(res * m[..., None], jac * m[..., None, None], gidx,
                       valid)


def _invdepth_one_cam_res(t, row, pbg, weight):
    """Two frames, one camera; tangent = [pose_i6, pose_j6, ext6,
    invdepth1] — ProjectionTwoFrameOneCamFactor."""
    p_i, q_i, p_j, q_j, tic, qic, inv_dep, pts_i, pts_j_xy = row
    qi = lie.quat_boxplus(q_i, t[3:6])
    qj = lie.quat_boxplus(q_j, t[9:12])
    te, qe = tic + t[12:15], lie.quat_boxplus(qic, t[15:18])
    pc = _invdepth_transform(p_i + t[0:3], qi, p_j + t[6:9], qj, te, qe,
                             te, qe, inv_dep + t[18], pts_i, pbg)
    return weight * (pc[0:2] / _safe_z(pc[2]) - pts_j_xy)


def invdepth_factor_batch(state: WindowState, host_ids, obs_ids, cam_ids,
                          inv_depths, pts_host, meas_xy, valid, pbg,
                          weight=PROJ_SQRT_INFO):
    """Two-frame-one-camera inverse-depth factors (ids (B, n)):
    ``inv_depths`` (B, n) is the caller's gather of each row's inverse
    depth, ``pts_host`` (B, n, 3) the host bearing.  Returns (res (B, n,
    2), jac (B, n, 2, 19)), zero for invalid rows; the last Jacobian column
    is the inverse depth's, and the caller places the columns."""
    rows = (take_rows(state.p, host_ids), take_rows(state.q, host_ids),
            take_rows(state.p, obs_ids), take_rows(state.q, obs_ids),
            take_rows(state.tic, cam_ids), take_rows(state.qic, cam_ids),
            inv_depths, pts_host, meas_xy)
    res, jac = rowwise_res_jac(_invdepth_one_cam_res, 19, rows,
                               host_ids.dim(), (pbg, weight))
    m = valid.to(res.dtype)
    return res * m[..., None], jac * m[..., None, None]
