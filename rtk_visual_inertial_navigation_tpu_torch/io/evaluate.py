"""Trajectory scoring with the reference's metrics (evaluate/evaluate.py):

  - SPP modes: plane RMSE (x,y) + height RMSE (z), mean-aligned
    (evaluate.py:58-61);
  - RTK: 3-D MAE, not aligned (evaluate.py:63-65);
  - association by nearest timestamp with 1/400 s tolerance (evaluate.py:42);
  - optional prism lever-arm correction from estimated attitude
    (evaluate.py:24-25, ptg calibration at :70);
  - VI-only mode: 4-DoF (yaw + translation) alignment before RMSE — the
    reference's VI mode has no global reference, so its output lives in an
    arbitrary local frame; yaw+translation is the standard VIO evaluation
    gauge (the reference scores only spp/rtk outputs in evaluate.py; its
    VI numbers come from externally-aligned trajectory comparison).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..ops import lie

ASSOC_TOL_S = 1.0 / 400.0


@dataclass
class TrajectoryMetrics:
    plane_rmse: float
    height_rmse: float
    mae_3d: float
    n_associated: int


def yaw_align(est: np.ndarray, gt: np.ndarray):
    """Closed-form 4-DoF alignment: find yaw ψ and translation t minimizing
    Σ|R_z(ψ)·p_est + t − p_gt|².  With centered points the optimal yaw is
    atan2(Σ(x_e y_g − y_e x_g), Σ(x_e x_g + y_e y_g))."""
    ce, cg = est.mean(axis=0), gt.mean(axis=0)
    e, g = est - ce, gt - cg
    num = float((e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0]).sum())
    den = float((e[:, 0] * g[:, 0] + e[:, 1] * g[:, 1]).sum())
    psi = np.arctan2(num, den)
    c, s = np.cos(psi), np.sin(psi)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = cg - Rz @ ce
    return est @ Rz.T + t


def evaluate_trajectory(est_t, est_p, gt_t, gt_p,
                        align: Union[bool, str] = True,
                        est_ypr_deg: Optional[np.ndarray] = None,
                        prism_offset: Optional[np.ndarray] = None
                        ) -> TrajectoryMetrics:
    """Score an estimated trajectory against ground truth.

    Args:
      est_t, est_p: (N,), (N,3) estimated times/positions.
      gt_t, gt_p: (M,), (M,3) ground truth.
      align: False = none (RTK convention); True = subtract the mean error
        (reference's SPP convention); "yaw" = 4-DoF yaw+translation
        alignment (VI-only convention — no global reference exists).
      est_ypr_deg + prism_offset: apply p -= R(ypr) @ prism_offset first.
    """
    est_t = np.asarray(est_t)
    est_p = np.asarray(est_p, dtype=float).copy()
    if est_ypr_deg is not None and prism_offset is not None:
        R = lie.ypr_to_rot(torch.as_tensor(
            np.asarray(est_ypr_deg, dtype=np.float64))).numpy()
        est_p -= np.einsum("nij,j->ni", R, prism_offset)

    pairs_e, pairs_g = [], []
    for tg, pg in zip(np.asarray(gt_t), np.asarray(gt_p)):
        k = int(np.abs(tg - est_t).argmin())
        if abs(tg - est_t[k]) > ASSOC_TOL_S:
            continue
        pairs_e.append(est_p[k])
        pairs_g.append(pg)
    if not pairs_e:
        return TrajectoryMetrics(np.nan, np.nan, np.nan, 0)
    pe, pg_ = np.asarray(pairs_e), np.asarray(pairs_g)
    if align == "yaw":
        pe = yaw_align(pe, pg_)
    errors = pe - pg_
    mae_3d = float(np.sqrt((errors ** 2).sum(axis=1)).mean())
    if align is True:
        errors = errors - errors.mean(axis=0)
    plane = float(np.sqrt((errors[:, 0] ** 2 + errors[:, 1] ** 2).mean()))
    height = float(np.sqrt((errors[:, 2] ** 2).mean()))
    return TrajectoryMetrics(plane, height, mae_3d, len(errors))
