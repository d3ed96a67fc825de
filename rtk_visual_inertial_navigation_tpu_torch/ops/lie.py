"""Batched quaternion / SO(3) operations.

Quaternions are stored as ``[w, x, y, z]`` (Hamilton convention).  All
functions broadcast over leading batch dimensions and are safe under
``torch.func`` transforms, including at the identity, where the naive
``exp``/``log`` formulas have 0/0 singularities (Taylor branches selected
with ``torch.where`` on both operand and result keep derivatives finite).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_identity(batch_shape=(), dtype=torch.float64, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(q, p):
    """Hamilton product q ⊗ p, wxyz layout."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_normalize(q):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, _EPS)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_rot(q):
    """Rotation matrix from quaternion, (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """Quaternion (wxyz) from a rotation matrix (Shepperd, branchless)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 0.0))

    def inv4(x):
        return 1.0 / torch.clamp_min(4.0 * x, _EPS)

    # four candidate constructions, pick the numerically largest pivot
    qw0 = safe_sqrt(1.0 + tr) / 2.0
    s0 = inv4(qw0)
    q0 = torch.stack([qw0, (m21 - m12) * s0, (m02 - m20) * s0,
                      (m10 - m01) * s0], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    s1 = inv4(qx1)
    q1 = torch.stack([(m21 - m12) * s1, qx1, (m01 + m10) * s1,
                      (m02 + m20) * s1], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    s2 = inv4(qy2)
    q2 = torch.stack([(m02 - m20) * s2, (m01 + m10) * s2, qy2,
                      (m12 + m21) * s2], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    s3 = inv4(qz3)
    q3 = torch.stack([(m10 - m01) * s3, (m02 + m20) * s3,
                      (m12 + m21) * s3, qz3], dim=-1)

    # pivot selection
    cs = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                      m22 - m00 - m11], dim=-1)
    idx = torch.argmax(cs, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    # canonical sign: w >= 0
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def skew(v):
    """Skew-symmetric matrix [v]_x, (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    r = torch.stack(
        [z, -v[..., 2], v[..., 1],
         v[..., 2], z, -v[..., 0],
         -v[..., 1], v[..., 0], z],
        dim=-1,
    )
    return r.reshape(v.shape[:-1] + (3, 3))


def quat_exp(theta):
    """Exact SO(3) exponential map to quaternion of a rotation vector."""
    n2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp_min(n2, _EPS * _EPS))
    half = 0.5 * n
    small = n2 < _EPS
    # sin(x/2)/x with Taylor fallback
    k = torch.where(small, 0.5 - n2 / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, n))
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def quat_log(q):
    """SO(3) log map: rotation vector (...,3) from unit quaternion."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # take the short path
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:4] ** 2, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp_min(vn2, _EPS * _EPS))
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < _EPS
    k = torch.where(small, 2.0 / torch.clamp_min(w, _EPS),
                    angle / torch.where(small, 1.0, vn))
    return k * q[..., 1:4]


def delta_q_first_order(theta):
    """First-order quaternion increment [1, theta/2] (UNNORMALIZED); the
    caller normalizes after composing (midpoint preintegration)."""
    one = torch.ones_like(theta[..., 0:1])
    return torch.cat([one, 0.5 * theta], dim=-1)


def quat_boxplus(q, dtheta):
    """Right-multiplicative retraction: q ⊞ dθ = q ⊗ exp(dθ)."""
    return quat_normalize(quat_mul(q, quat_exp(dtheta)))


def quat_boxminus(q1, q0):
    """Tangent s.t. q0 ⊞ t = q1, i.e. log(q0^{-1} ⊗ q1)."""
    return quat_log(quat_mul(quat_conj(q0), q1))


def _mult_matrix(q, sign):
    w = q[..., 0]
    v = q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bot = torch.cat([v[..., :, None],
                     w[..., None, None] * eye + sign * skew(v)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def qleft(q):
    """Left-multiplication matrix (...,4,4): qleft(q) @ p == q ⊗ p."""
    return _mult_matrix(q, 1.0)


def qright(p):
    """Right-multiplication matrix (...,4,4): qright(p) @ q == q ⊗ p."""
    return _mult_matrix(p, -1.0)


def ypr_to_rot(ypr_deg):
    """Z-Y-X Euler (yaw,pitch,roll in degrees) to rotation matrix."""
    y, p, r = (torch.deg2rad(ypr_deg[..., i]) for i in range(3))
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_to_ypr(R):
    """Rotation matrix to yaw-pitch-roll degrees (Utility::R2ypr semantics)."""
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y)
                    + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.rad2deg(torch.stack([y, p, r], dim=-1))
