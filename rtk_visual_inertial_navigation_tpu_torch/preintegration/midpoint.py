"""IMU midpoint preintegration, batched over intervals.

Midpoint integration of (Δp, Δq, Δv), the 15x15 bias Jacobian and the
15x15 covariance driven by an 18-dim noise model [na0, ng0, na1, ng1, nba,
nbg].  State ordering is [P(0:3), R(3:6), V(6:9), BA(9:12), BG(12:15)].

A fixed-capacity sample buffer with a validity mask (variable-length
intervals become masked steps with dt=0); the sample loop is a Python loop
over the buffer, every step batched over all leading interval dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie


class ImuNoise(NamedTuple):
    acc_n: float
    gyr_n: float
    acc_w: float
    gyr_w: float


class Preintegrated(NamedTuple):
    """Result of preintegrating one IMU interval (leading batch dims)."""

    delta_p: torch.Tensor      # (...,3)
    delta_q: torch.Tensor      # (...,4) wxyz
    delta_v: torch.Tensor      # (...,3)
    jacobian: torch.Tensor     # (...,15,15) d(state)/d(state0, biases)
    covariance: torch.Tensor   # (...,15,15)
    sum_dt: torch.Tensor       # (...,)
    linearized_ba: torch.Tensor  # (...,3) bias linearization point
    linearized_bg: torch.Tensor  # (...,3)
    gyr_i: torch.Tensor        # (...,3) first gyro sample (lever-arm terms)
    gyr_j: torch.Tensor        # (...,3) last gyro sample


def _noise_matrix(noise: ImuNoise, dtype, device=None):
    d = torch.tensor(
        [noise.acc_n ** 2] * 3 + [noise.gyr_n ** 2] * 3
        + [noise.acc_n ** 2] * 3 + [noise.gyr_n ** 2] * 3
        + [noise.acc_w ** 2] * 3 + [noise.gyr_w ** 2] * 3,
        dtype=dtype, device=device)
    return torch.diag(d)


def _midpoint_step(carry, inp, noise_mat):
    """One midpoint step; inp = (dt, acc1, gyr1, valid), each with the
    carry's batch dims."""
    (p, q, v, J, P, sum_dt, acc0, gyr0) = carry
    dt, acc1, gyr1, valid = inp
    dt = torch.where(valid, dt, 0.0)
    d1 = dt[..., None]
    d2 = dt[..., None, None]

    # the caller already subtracted the linearization biases from the
    # samples, so biases are zero inside the loop carry
    un_acc0 = lie.quat_rotate(q, acc0)
    un_gyr = 0.5 * (gyr0 + gyr1)
    q_new = lie.quat_normalize(
        lie.quat_mul(q, lie.delta_q_first_order(un_gyr * d1)))
    un_acc1 = lie.quat_rotate(q_new, acc1)
    un_acc = 0.5 * (un_acc0 + un_acc1)
    p_new = p + v * d1 + 0.5 * un_acc * d1 * d1
    v_new = v + un_acc * d1

    # Jacobian/covariance propagation
    R0 = lie.quat_to_rot(q)
    R1 = lie.quat_to_rot(q_new)
    wx = lie.skew(un_gyr)
    a0x = lie.skew(acc0)
    a1x = lie.skew(acc1)
    I3 = torch.eye(3, dtype=p.dtype, device=p.device)
    batch = p.shape[:-1]

    F = torch.zeros(batch + (15, 15), dtype=p.dtype, device=p.device)
    R1a1 = R1 @ a1x
    ImwX = I3 - wx * d2
    R0a0 = R0 @ a0x
    F[..., 0:3, 0:3] = I3
    F[..., 0:3, 3:6] = (-0.25 * R0a0 * d2 * d2
                        - 0.25 * (R1a1 @ ImwX) * d2 * d2)
    F[..., 0:3, 6:9] = I3 * d2
    F[..., 0:3, 9:12] = -0.25 * (R0 + R1) * d2 * d2
    F[..., 0:3, 12:15] = 0.25 * R1a1 * d2 * d2 * d2
    F[..., 3:6, 3:6] = ImwX
    F[..., 3:6, 12:15] = -I3 * d2
    F[..., 6:9, 3:6] = -0.5 * R0a0 * d2 - 0.5 * (R1a1 @ ImwX) * d2
    F[..., 6:9, 6:9] = I3
    F[..., 6:9, 9:12] = -0.5 * (R0 + R1) * d2
    F[..., 6:9, 12:15] = 0.5 * R1a1 * d2 * d2
    F[..., 9:12, 9:12] = I3
    F[..., 12:15, 12:15] = I3

    V = torch.zeros(batch + (15, 18), dtype=p.dtype, device=p.device)
    V[..., 0:3, 0:3] = 0.25 * R0 * d2 * d2
    v03 = -0.125 * R1a1 * d2 * d2 * d2
    V[..., 0:3, 3:6] = v03
    V[..., 0:3, 6:9] = 0.25 * R1 * d2 * d2
    V[..., 0:3, 9:12] = v03
    V[..., 3:6, 3:6] = 0.5 * I3 * d2
    V[..., 3:6, 9:12] = 0.5 * I3 * d2
    V[..., 6:9, 0:3] = 0.5 * R0 * d2
    v63 = -0.25 * R1a1 * d2 * d2
    V[..., 6:9, 3:6] = v63
    V[..., 6:9, 6:9] = 0.5 * R1 * d2
    V[..., 6:9, 9:12] = v63
    V[..., 9:12, 12:15] = I3 * d2
    V[..., 12:15, 15:18] = I3 * d2

    J_new = F @ J
    P_new = F @ P @ F.transpose(-1, -2) + V @ noise_mat @ V.transpose(-1, -2)

    # masked step: freeze everything if invalid
    v1 = valid[..., None]
    v2 = valid[..., None, None]
    return (
        torch.where(v1, p_new, p), torch.where(v1, q_new, q),
        torch.where(v1, v_new, v), torch.where(v2, J_new, J),
        torch.where(v2, P_new, P), sum_dt + dt,
        torch.where(v1, acc1, acc0), torch.where(v1, gyr1, gyr0),
    )


def preintegrate(dts, accs, gyrs, valid, linearized_ba, linearized_bg,
                 noise: ImuNoise) -> Preintegrated:
    """Preintegrate intervals (leading batch dims ``...``).

    Args:
      dts:  (..., S) per-sample dt; dts[k] spans samples k-1 -> k (dts[0]
        unused).
      accs: (..., S, 3) accelerometer samples (calibration already applied).
      gyrs: (..., S, 3) gyro samples.
      valid: (..., S) bool; sample 0 must be valid (it seeds acc0/gyr0).
      linearized_ba/bg: (..., 3) bias linearization point.
    """
    dtype, device = accs.dtype, accs.device
    batch = accs.shape[:-2]
    accs = accs - linearized_ba[..., None, :]
    gyrs = gyrs - linearized_bg[..., None, :]
    noise_mat = _noise_matrix(noise, dtype, device)

    eye15 = torch.eye(15, dtype=dtype, device=device)
    carry = (
        torch.zeros(batch + (3,), dtype=dtype, device=device),
        lie.quat_identity(batch, dtype, device),
        torch.zeros(batch + (3,), dtype=dtype, device=device),
        eye15.expand(batch + (15, 15)),
        torch.zeros(batch + (15, 15), dtype=dtype, device=device),
        torch.zeros(batch, dtype=dtype, device=device),
        accs[..., 0, :], gyrs[..., 0, :],
    )
    for k in range(1, accs.shape[-2]):
        carry = _midpoint_step(
            carry, (dts[..., k], accs[..., k, :], gyrs[..., k, :],
                    valid[..., k]), noise_mat)
    p, q, v, J, P, sum_dt, _, _ = carry

    # last valid gyro sample (for lever-arm terms in the IMU residual)
    idx_last = torch.clamp_min(valid.long().sum(-1) - 1, 0)
    gyr_j = torch.gather(
        gyrs, -2, idx_last[..., None, None].expand(batch + (1, 3)))[..., 0, :]
    gyr_j = gyr_j + linearized_bg
    gyr_i = gyrs[..., 0, :] + linearized_bg
    return Preintegrated(p, q, v, J, P, sum_dt, linearized_ba, linearized_bg,
                         gyr_i, gyr_j)


def preintegrate_sequence(dts, accs, gyrs, valid, linearized_ba,
                          linearized_bg, noise: ImuNoise) -> Preintegrated:
    """Preintegrate a sequence of intervals: every input but ``noise``
    carries a leading interval axis, ``noise`` is shared (the JAX package's
    ``vmap(preintegrate, in_axes=(0, 0, 0, 0, 0, 0, None))``)."""
    return preintegrate(dts, accs, gyrs, valid, linearized_ba,
                        linearized_bg, noise)


def imu_residual(pre: Preintegrated, g_world,
                 p_i, q_i, v_i, ba_i, bg_i,
                 p_j, q_j, v_j, ba_j, bg_j, pbg):
    """15-dim preintegration residual with antenna lever arm Pbg.

    The state position P is the *antenna* position and V the antenna
    velocity; body<->antenna conversion uses Pbg plus gyro-rate terms.
    g_world = Rwgw @ [0,0,G] (world gravity).
    """
    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg
    J = pre.jacobian
    dp_dba, dp_dbg = J[..., 0:3, 9:12], J[..., 0:3, 12:15]
    dq_dbg = J[..., 3:6, 12:15]
    dv_dba, dv_dbg = J[..., 6:9, 9:12], J[..., 6:9, 12:15]

    mv = lambda M, x: (M @ x[..., None])[..., 0]

    corr_q = lie.quat_mul(pre.delta_q, lie.quat_exp(mv(dq_dbg, dbg)))
    corr_v = pre.delta_v + mv(dv_dba, dba) + mv(dv_dbg, dbg)
    corr_p = pre.delta_p + mv(dp_dba, dba) + mv(dp_dbg, dbg)
    sdt = pre.sum_dt[..., None]

    wi = pre.gyr_i - bg_i
    wj = pre.gyr_j - bg_j
    r_p = (
        lie.quat_rotate_inv(
            q_i,
            0.5 * g_world * sdt * sdt + (p_j - p_i)
            - lie.quat_rotate(q_j, pbg) - v_i * sdt)
        - corr_p + pbg + lie.cross(wi, pbg) * sdt
    )
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(corr_q),
                             lie.quat_mul(lie.quat_conj(q_i), q_j))[..., 1:4]
    r_v = (
        lie.quat_rotate_inv(
            q_i,
            g_world * sdt
            + (v_j - lie.quat_rotate(q_j, lie.cross(wj, pbg))) - v_i)
        - corr_v + lie.cross(wi, pbg)
    )
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)
