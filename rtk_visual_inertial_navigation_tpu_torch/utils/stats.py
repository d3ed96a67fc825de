"""Console statistics, the printStatistics analog
(rvi/utility/visualization.cpp:103-159): per-frame pose/velocity/bias
summary plus solve health counters."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie


class RunningStats:
    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def std(self):
        return float(np.sqrt(self.m2 / max(self.n - 1, 1)))


def print_statistics(est, every: int = 25) -> str:
    """One-line status from a pipeline.Estimator (returned, also printable)."""
    if est.frame_count == 0:
        return "uninitialized"
    i = est.frame_count - 1
    p = np.asarray(est.x.p[i])
    v = np.asarray(est.x.v[i])
    q = torch.as_tensor(np.asarray(est.x.q[i], dtype=np.float64))
    ypr = lie.rot_to_ypr(lie.quat_to_rot(q)).numpy()
    ba = np.asarray(est.x.ba[i])
    bg = np.asarray(est.x.bg[i])
    cost = float(est.last_solve.cost) if hasattr(est, "last_solve") else -1.0
    fix = "FIX" if getattr(est, "rtk_fixed", False) else "float"
    return (f"t={est.frame_times[i]:9.3f} p=[{p[0]:8.3f},{p[1]:8.3f},"
            f"{p[2]:7.3f}] |v|={np.linalg.norm(v):6.3f} "
            f"ypr=[{ypr[0]:6.1f},{ypr[1]:5.1f},{ypr[2]:5.1f}] "
            f"|ba|={np.linalg.norm(ba):.4f} |bg|={np.linalg.norm(bg):.5f} "
            f"cost={cost:9.3e} {fix}")
