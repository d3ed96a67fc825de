"""Lightweight output publishing — the rviz/ROS-topic replacement.

The reference publishes odometry/path/point-cloud/camera-pose topics for
rviz (registerPub/pubOdometry/pubPointCloud, rvi/utility/visualization.h:
13-37).  Here a ``Publisher`` accumulates the same streams in memory and
flushes them to a single ``.npz`` (plus an optional quick matplotlib figure)
for offline inspection — no ROS dependency, works headless.
"""

from __future__ import annotations

import numpy as np


class Publisher:
    def __init__(self):
        self.odom: list = []        # (t, p(3), q(4), v(3))
        self.keyframes: list = []   # (t, p(3), q(4))
        self.points: dict = {}      # landmark id -> last position

    def pub_odometry(self, t, p, q, v):
        self.odom.append((float(t), np.asarray(p), np.asarray(q),
                          np.asarray(v)))

    def pub_keyframe(self, t, p, q):
        self.keyframes.append((float(t), np.asarray(p), np.asarray(q)))

    def pub_point_cloud(self, ids, points):
        for i, pt in zip(np.asarray(ids), np.asarray(points)):
            self.points[int(i)] = np.asarray(pt)

    def pub_from_estimator(self, est):
        """Publish the estimator's newest frame + solved landmarks."""
        i = est.frame_count - 1
        if i < 0:
            return
        self.pub_odometry(est.frame_times[i], est.x.p[i], est.x.q[i],
                          est.x.v[i])
        ft = est.features
        live = ft.active & ft.solved
        if np.any(live):
            self.pub_point_cloud(ft.feature_id[live],
                                 np.asarray(est.x.landmarks)[live])

    def save(self, path: str):
        odom_t = np.asarray([o[0] for o in self.odom])
        odom_p = np.asarray([o[1] for o in self.odom]).reshape(-1, 3)
        odom_q = np.asarray([o[2] for o in self.odom]).reshape(-1, 4)
        odom_v = np.asarray([o[3] for o in self.odom]).reshape(-1, 3)
        ids = np.asarray(sorted(self.points), dtype=np.int64)
        pts = np.asarray([self.points[int(i)] for i in ids]).reshape(-1, 3)
        np.savez_compressed(path, odom_t=odom_t, odom_p=odom_p,
                            odom_q=odom_q, odom_v=odom_v,
                            point_ids=ids, points=pts)

    def plot(self, path: str):
        """Top-down trajectory + landmark figure (headless backend)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        if self.odom:
            p = np.asarray([o[1] for o in self.odom])
            ax.plot(p[:, 0], p[:, 1], "-", lw=1.2, label="trajectory")
        if self.points:
            pts = np.asarray(list(self.points.values()))
            ax.scatter(pts[:, 0], pts[:, 1], s=4, alpha=0.5,
                       label="landmarks")
        ax.set_aspect("equal")
        ax.legend()
        ax.set_xlabel("east [m]")
        ax.set_ylabel("north [m]")
        fig.savefig(path, dpi=120)
        plt.close(fig)
