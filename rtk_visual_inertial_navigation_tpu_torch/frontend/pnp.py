"""Perspective-n-Point pose bootstrap.

The reference initializes a new frame's pose from 2D-3D correspondences
with cv::solvePnPRansac when IMU prediction is unavailable
(FeatureManager::initFramePoseByPnP, rvi/feature/feature_manager.cpp:164-243).
Here: fixed-iteration Gauss-Newton on the 6-dof body pose with Huber
reweighting and a residual-gated second pass (the RANSAC role — reject
gross outliers between passes).
"""

from __future__ import annotations

import torch

from ..factors.visual import project_world_point
from ..ops import lie


def _reproj_residuals(p, q, tic, qic, landmarks, obs_xy, pbg):
    """(K,2) unit-plane reprojection errors + (K,) depths."""
    pc = project_world_point(p, q, tic, qic, landmarks, pbg)
    z = torch.clamp_min(pc[..., 2:3], 1e-3)
    return pc[..., :2] / z - obs_xy, pc[..., 2]


def pnp_pose(landmarks, obs_xy, valid, p0, q0, tic, qic, pbg,
             iters: int = 10, huber: float = 5.0 / 460.0,
             gate: float = 10.0 / 460.0):
    """Refine (p, q) from 2D-3D matches.

    Args:
      landmarks: (K,3) world points; obs_xy: (K,2) unit-plane obs;
      valid: (K,) mask; p0/q0: initial body pose guess.
    Returns (p, q, ok): ok False when <6 usable correspondences
    (feature_manager.cpp:236: >5 points required).
    """
    ok0 = valid.sum() >= 6
    eye6 = torch.eye(6, dtype=p0.dtype, device=p0.device)

    def gn_round(p, q, use):
        for _ in range(iters):
            def res_fn(t):
                r, _ = _reproj_residuals(p + t[0:3],
                                         lie.quat_boxplus(q, t[3:6]), tic,
                                         qic, landmarks, obs_xy, pbg)
                return r

            zero = torch.zeros(6, dtype=p.dtype, device=p.device)
            r = res_fn(zero)                                  # (K,2)
            J = torch.func.jacrev(res_fn)(zero)               # (K,2,6)
            # Huber weights on the residual norm
            rn = torch.linalg.norm(r, dim=-1)
            w = torch.where(rn > huber, huber / torch.clamp_min(rn, 1e-12),
                            1.0)
            w = w * use.to(r.dtype)
            Jw = J * w[:, None, None]
            H = torch.einsum("kri,krj->ij", Jw, J) + 1e-8 * eye6
            g = torch.einsum("kri,kr->i", Jw, r)
            dx = -torch.linalg.solve(H, g)
            p, q = p + dx[0:3], lie.quat_boxplus(q, dx[3:6])
        return p, q

    p1, q1 = gn_round(p0, q0, valid)
    # outlier gate between passes (the solvePnPRansac role)
    r1, depth = _reproj_residuals(p1, q1, tic, qic, landmarks, obs_xy, pbg)
    inl = valid & (torch.linalg.norm(r1, dim=-1) < gate) & (depth > 0.1)
    enough = inl.sum() >= 6
    p2, q2 = gn_round(p1, q1, inl)
    p_out = torch.where(enough, p2, p1)
    q_out = torch.where(enough, q2, q1)
    return p_out, lie.quat_normalize(q_out), ok0
