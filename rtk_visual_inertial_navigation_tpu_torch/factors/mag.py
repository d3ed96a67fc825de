"""Magnetometer yaw factor, batched over windows and frames.

Semantics of MAGFactor (rvi/factor/mag_factor.cpp:5-33): the world-frame
magnetic field must point north — residual = 20 · east-component of the
normalized horizontal world mag:

    m_w = R_wb (m_body + b_mag);   r = MAGSQRTINFO · m_w[0] / |m_w[0:2]|

(the world frame is ENU, so "east" is axis 0, matching the reference's
Rwgwᵀ-rotated frame).  Parameters: frame pose (attitude part) and the
global 3-vector mag bias.
"""

from __future__ import annotations

import torch

from ..core.state import WindowState, layout_of
from ..ops import lie
from .base import FactorBatch, block_indices, rowwise_res_jac, take_rows

MAG_SQRT_INFO = 20.0


def _mag_res(t, row):
    """tangent = [attitude3, mag bias3]."""
    q, bmg, m = row
    mw = lie.quat_rotate(lie.quat_boxplus(q, t[0:3]), m + bmg + t[3:6])
    horiz = torch.sqrt(torch.clamp_min(mw[0] ** 2 + mw[1] ** 2, 1e-12))
    return (MAG_SQRT_INFO * mw[0] / horiz)[None]


def mag_factor_batch(state: WindowState, frame_ids, mag_body, valid
                     ) -> FactorBatch:
    """Evaluate magnetometer factors of every window.

    Args:
      state: WindowState with leading window dim B.
      frame_ids: (B, n) window frame index.
      mag_body: (B, n, 3) magnetometer reading (calibration applied).
      valid: (B, n) bool.
    """
    lay = layout_of(state)
    q = take_rows(state.q, frame_ids)
    bmg = state.mag_bias[:, None, :].expand(q.shape[:-1] + (3,))
    res, jac = rowwise_res_jac(_mag_res, 6, (q, bmg, mag_body), 2)
    # tangent = [frame attitude (3), mag bias (3)]; attitude slots are the
    # last 3 of the pose block
    mag_cols = torch.arange(lay.mag_off, lay.mag_off + 3,
                            device=frame_ids.device)
    gidx = torch.cat([
        block_indices(lay.pose_idx(frame_ids) + 3, 3),
        mag_cols.expand(frame_ids.shape + (3,)),
    ], dim=-1)
    m = valid.to(res.dtype)
    return FactorBatch(res * m[..., None], jac * m[..., None, None], gidx,
                       valid)


def yaw_from_mag(mean_acc, mean_mag, mag_bias=None):
    """TRIAD-style attitude from averaged accelerometer + magnetometer
    (InitializePos, rvi/swf/swf_imu.cpp:5-37 + MagProcess yaw extraction):
    rows of R_wb are [east; north; up] expressed in body coordinates.
    Returns the body->world quaternion.
    """
    if mag_bias is None:
        mag_bias = torch.zeros(3, dtype=mean_acc.dtype,
                               device=mean_acc.device)
    z0 = mean_acc / torch.linalg.norm(mean_acc)                   # up
    east = lie.cross(mean_mag + mag_bias, z0)
    x0 = east / torch.clamp_min(torch.linalg.norm(east), 1e-12)   # east
    y0 = lie.cross(z0, x0)
    y0 = y0 / torch.clamp_min(torch.linalg.norm(y0), 1e-12)       # north
    R_wb = torch.stack([x0, y0, z0])                              # world<-body
    return lie.rot_to_quat(R_wb)
