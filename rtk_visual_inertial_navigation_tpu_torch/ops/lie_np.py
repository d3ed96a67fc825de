"""Host-side (numpy) quaternion helpers for the pipeline driver.

The estimator's per-frame bookkeeping runs on the host in numpy: a torch
op per 4-vector would cost more in dispatch than the arithmetic.  These
mirror ops/lie.py semantics (Hamilton convention, w-first) exactly.
"""

from __future__ import annotations

import numpy as np


def quat_identity():
    return np.array([1.0, 0.0, 0.0, 0.0])


def quat_mul(q, p):
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return np.stack([
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
    ], axis=-1)


def quat_normalize(q):
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(n, 1e-300)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_exp(theta):
    """so(3) tangent -> unit quaternion."""
    theta = np.asarray(theta, dtype=float)
    ang = np.linalg.norm(theta, axis=-1, keepdims=True)
    half = 0.5 * ang
    small = ang < 1e-12
    s = np.where(small, 0.5, np.sin(half) / np.maximum(ang, 1e-300))
    w = np.cos(half)
    return np.concatenate([w, s * theta], axis=-1)


def quat_to_rot(q):
    """Unit quaternion (w-first) -> rotation matrix (numpy mirror of
    ops/lie.quat_to_rot)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def rot_to_ypr_deg(R):
    """Rotation matrix -> yaw/pitch/roll in degrees (Utility::R2ypr
    convention, rvi/utility/utility.h; matches ops/lie.rot_to_ypr)."""
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = np.arcsin(-np.clip(R[..., 2, 0], -1.0, 1.0))
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    return np.rad2deg(np.stack([yaw, pitch, roll], -1))
