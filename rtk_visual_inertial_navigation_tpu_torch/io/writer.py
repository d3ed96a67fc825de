"""Result CSV writer, column-compatible with the reference's save_result
(rvi/utility/visualization.cpp:222-277) so its evaluate.py runs unmodified.

Columns: time,px,py,pz,vx,vy,vz,yaw,pitch,roll,ax,ay,az,bax,bay,baz,
bgx,bgy,bgz,rtk_fix,mag_yaw,havegps,trajectory_sum,lat,lon,pbgx,pbgy,pbgz.
Position/velocity/ypr are reported in the initial-gravity-aligned frame
(InitRwgwᵀ · …); our estimator's world frame is already ENU at the anchor,
so the transform is identity when the anchor matches.  ``trajectory_sum``
is written as 0 — exact parity: the reference hardcodes ``distance = 0``
(visualization.cpp:257).

The reference writes one row per 400 Hz IMU sample (save_result called from
IMUProcess, rvi/swf/swf_imu.cpp:213) — this writer is pure numpy with a
persistent file handle so the per-sample cost is microseconds.
"""

from __future__ import annotations

import numpy as np

from ..ops import lie_np

FE_WGS84 = 1.0 / 298.257223563
RE_WGS84 = 6378137.0

HEADER = ("time,px,py,pz,vx,vy,vz,yaw,pitch,roll,ax,ay,az,bax,bay,baz,"
          "bgx,bgy,bgz,rtk_fix,mag_yaw,havegps,trajectory_sum,lat,lon,"
          "pbgx,pbgy,pbgz")


def ecef_to_geodetic_np(r, iters: int = 8):
    """Numpy mirror of geodesy.earth.ecef_to_geodetic (lat, lon, h)."""
    r = np.asarray(r, dtype=float)
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    r2 = r[0] ** 2 + r[1] ** 2
    z = r[2]
    v = RE_WGS84
    for _ in range(iters):
        zk = z
        sinp = zk / np.sqrt(r2 + zk * zk)
        v = RE_WGS84 / np.sqrt(1.0 - e2 * sinp * sinp)
        z = r[2] + v * e2 * sinp
    lat = np.arctan(z / np.sqrt(max(r2, 1e-12))) if r2 > 1e-12 \
        else (np.pi / 2 if r[2] > 0 else -np.pi / 2)
    lon = np.arctan2(r[1], r[0]) if r2 > 1e-12 else 0.0
    h = np.sqrt(r2 + z * z) - v
    return np.array([lat, lon, h])


class ResultWriter:
    def __init__(self, path: str, anchor_ecef=None, enu_to_ecef=None):
        self.path = path
        self.anchor = None if anchor_ecef is None \
            else np.asarray(anchor_ecef, dtype=float)
        self.R_e = None if enu_to_ecef is None \
            else np.asarray(enu_to_ecef, dtype=float)
        self._f = open(path, "w", buffering=1 << 16)
        self._f.write(HEADER + "\n")
        self.rows = 0

    def write(self, t, p, q, v, ba, bg, acc_w=None, rtk_fix=0, mag_yaw=0.0,
              havegps=0, pbg=None):
        q = np.asarray(q, dtype=float)
        ypr = lie_np.rot_to_ypr_deg(lie_np.quat_to_rot(q))
        acc_w = np.zeros(3) if acc_w is None else np.asarray(acc_w)
        pbg_w = np.zeros(3)
        if pbg is not None:
            pbg_w = lie_np.quat_rotate(q, np.asarray(pbg, dtype=float))
        lat = lon = 0.0
        if self.anchor is not None and self.R_e is not None:
            ecef = self.anchor + self.R_e @ np.asarray(p, dtype=float)
            llh = ecef_to_geodetic_np(ecef)
            lat, lon = np.rad2deg(llh[0]), np.rad2deg(llh[1])
        row = [f"{t * 1e9:.0f}"]
        for vals in (p, v, ypr, acc_w, ba, bg):
            row += [f"{x:.10f}" for x in np.asarray(vals)]
        row += [str(int(rtk_fix)), f"{mag_yaw:.10f}", str(int(havegps)),
                "0", f"{lat:.10f}", f"{lon:.10f}"]
        row += [f"{x:.10f}" for x in pbg_w]
        self._f.write(",".join(row) + "\n")
        self.rows += 1

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def save_extrinsic_yaml(path: str, tic, qic):
    """Persist online-calibrated camera extrinsics as OpenCV-FileStorage
    yaml, format-compatible with the reference's printStatistics output
    (rvi/utility/visualization.cpp:130-145: 4x4 body_T_cam{i} matrices)."""
    tic = np.asarray(tic).reshape(-1, 3)
    qic = np.asarray(qic).reshape(-1, 4)
    lines = ["%YAML:1.0", "---"]
    for i in range(tic.shape[0]):
        R = lie_np.quat_to_rot(qic[i])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = tic[i]
        flat = ", ".join(f"{v:.12e}" for v in T.reshape(-1))
        lines += [f"body_T_cam{i}: !!opencv-matrix", "   rows: 4",
                  "   cols: 4", "   dt: d", f"   data: [ {flat} ]"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_extrinsic_yaml(path: str):
    """Read back body_T_cam matrices written by save_extrinsic_yaml (or the
    reference).  Returns (tic (N,3), qic (N,4))."""
    import re

    import torch

    from ..ops import lie
    with open(path) as f:
        text = f.read()
    mats = re.findall(
        r"body_T_cam(\d+):.*?data:\s*\[([^\]]+)\]", text, re.S)
    tic, qic = [], []
    for _, data in sorted(mats, key=lambda m: int(m[0])):
        vals = np.asarray([float(v) for v in data.replace("\n", " ")
                           .split(",")]).reshape(4, 4)
        tic.append(vals[:3, 3])
        qic.append(lie.rot_to_quat(torch.from_numpy(vals[:3, :3])).numpy())
    return np.asarray(tic), np.asarray(qic)
