"""Batched multi-view triangulation.

Replaces FeatureManager's per-feature SVD triangulation loops
(rvi/feature/feature_manager.cpp:245-359) with one masked batched
linear solve: for landmark l with observations (frame f, unit-plane (x,y)),
each observation contributes two DLT rows

    [x·P₃ᵀ - P₁ᵀ ;  y·P₃ᵀ - P₂ᵀ] · [X; 1] = 0

where P = [R_cw | t_cw] maps world→camera.  The normal equations AᵀA (4x4)
are accumulated per landmark over a fixed observation capacity with
validity weights, and the homogeneous system is solved by ``eigh`` for all
landmarks at once (no per-feature control flow).
"""

from __future__ import annotations

import torch

from ..ops import lie


def _camera_matrices(p_frames, q_frames, tic, qic, pbg):
    """World->camera P = [R_cw | t_cw] (..., 3, 4) of body poses (p, q)
    with extrinsic (tic, qic) and antenna lever arm pbg, as projection
    factors (X_cam = R_icᵀ(R_bᵀ(X_w - P) + pbg - tic))."""
    R_bT = lie.quat_to_rot(q_frames).transpose(-1, -2)
    R_icT = lie.quat_to_rot(qic).transpose(-1, -2)
    R_cw = R_icT @ R_bT
    t_cw = (R_icT @ ((-R_bT @ p_frames[..., None])[..., 0]
                     + pbg - tic)[..., None])[..., 0]
    return torch.cat([R_cw, t_cw[..., None]], dim=-1)


def triangulate_dlt(p_frames, q_frames, tic, qic, obs_xy, obs_valid, pbg):
    """Triangulate landmarks from up to K observations each.

    Args:
      p_frames, q_frames: (K,3),(K,4) body poses of the observing frames.
      obs_xy: (..., K, 2) unit-plane measurements; obs_valid: (..., K)
        bool.
    Returns (point (..., 3), ok flag (...)).
    """
    P = _camera_matrices(p_frames, q_frames, tic, qic, pbg)    # (K,3,4)
    x, y = obs_xy[..., 0:1], obs_xy[..., 1:2]
    rows = torch.stack([x * P[:, 2] - P[:, 0],
                        y * P[:, 2] - P[:, 1]], dim=-2)       # (...,K,2,4)
    w = obs_valid.to(rows.dtype)[..., None, None]
    A = (rows * w).flatten(-3, -2)                             # (...,2K,4)
    N = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(N)
    h = V[..., :, 0]
    big = h[..., 3].abs() > 1e-10
    ok = (obs_valid.sum(-1) >= 2) & big
    pt = h[..., 0:3] / torch.where(big, h[..., 3], 1.0)[..., None]
    return pt, ok


def triangulate_landmarks(p_frames, q_frames, tic, qic, obs_xy, obs_valid,
                          pbg):
    """Every landmark slot at once: obs_xy (NL, NF, 2), obs_valid (NL, NF)
    -> (points (NL, 3), ok (NL,))."""
    return triangulate_dlt(p_frames, q_frames, tic, qic, obs_xy, obs_valid,
                           pbg)
