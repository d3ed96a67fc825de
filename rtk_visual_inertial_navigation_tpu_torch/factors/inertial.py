"""IMU preintegration factors, batched over windows and intervals.

15-dim [P,R,V,BA,BG] residual between consecutive states, antenna lever arm
``pbg`` included, whitened by the preintegration sqrt-information;
tangent-space Jacobians from reverse-mode autodiff.
"""

from __future__ import annotations

import torch

from ..core.state import POSE_DIM, WindowState, layout_of
from ..ops import lie
from ..ops.linalg import cholesky_nan
from ..preintegration.midpoint import Preintegrated, imu_residual
from .base import FactorBatch, block_indices, rowwise_res_jac


def sqrt_info_of_cov(cov, jitter=1e-12):
    """Lower-triangular W with Wᵀ W = cov⁻¹ (whitening by L⁻¹ of cov=LLᵀ)."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    L = cholesky_nan(cov + jitter * eye)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _imu_res(t, row, pbg, g_world):
    """tangent = [pose_i6, sb_i9, pose_j6, sb_j9] -> whitened 15-residual."""
    pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, W = row
    r = imu_residual(
        pre, g_world,
        p_i + t[0:3], lie.quat_boxplus(q_i, t[3:6]),
        v_i + t[6:9], ba_i + t[9:12], bg_i + t[12:15],
        p_j + t[15:18], lie.quat_boxplus(q_j, t[18:21]),
        v_j + t[21:24], ba_j + t[24:27], bg_j + t[27:30],
        pbg)
    return W @ r


def _single_imu(pre: Preintegrated, p_i, q_i, v_i, ba_i, bg_i,
                p_j, q_j, v_j, ba_j, bg_j, pbg, g_world, W):
    """(res (..., 15), jac (..., 15, 30)) over any leading row dims."""
    return rowwise_res_jac(
        _imu_res, 30,
        (pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, W),
        p_i.dim() - 1, (pbg, g_world))


def imu_factor_batch(state: WindowState, pre: Preintegrated, pbg, g_world,
                     valid, W=None) -> FactorBatch:
    """Evaluate all NF-1 consecutive-frame IMU factors of every window.

    Args:
      state: WindowState with leading window dim B.
      pre: Preintegrated with leading dims (B, NF-1) (interval k spans
        frames k -> k+1).
      valid: (B, NF-1) mask.
      W: optional precomputed (B, NF-1, 15, 15) sqrt-information (pass it
        when solving in float32 with a covariance derived in f64).
    """
    lay = layout_of(state)
    nf = lay.nf
    if W is None:
        W = sqrt_info_of_cov(pre.covariance)
    i, j = slice(0, nf - 1), slice(1, nf)
    res, jac = _single_imu(
        pre, state.p[:, i], state.q[:, i], state.v[:, i], state.ba[:, i],
        state.bg[:, i], state.p[:, j], state.q[:, j], state.v[:, j],
        state.ba[:, j], state.bg[:, j], pbg, g_world, W)

    frame_ids = torch.arange(nf - 1, device=res.device)
    gidx = torch.cat(
        [
            block_indices(lay.pose_idx(frame_ids), POSE_DIM),
            block_indices(lay.sb_idx(frame_ids), 9),
            block_indices(lay.pose_idx(frame_ids + 1), POSE_DIM),
            block_indices(lay.sb_idx(frame_ids + 1), 9),
        ],
        dim=-1,
    ).expand(res.shape[:-1] + (30,))
    m = valid.to(res.dtype)
    return FactorBatch(res * m[..., None], jac * m[..., None, None], gidx,
                       valid)


def merge_preintegrations(pre_a: Preintegrated, pre_b: Preintegrated
                          ) -> Preintegrated:
    """Compose two consecutive preintegrated intervals a (i->m) and b (m->j)
    (leading batch dims allowed).

    Used when the sliding window drops a middle frame and its two IMU
    intervals must fuse (SlideWindowFrame, rvi/swf/swf.cpp:239-295 — the
    reference re-propagates raw samples; this composes in closed form).

    Composition rules (after correcting b's deltas to a's linearization
    biases via b's bias Jacobian):
      Δq = Δq_a ⊗ Δq_b
      Δp = Δp_a + Δv_a T_b + R(Δq_a) Δp_b
      Δv = Δv_a + R(Δq_a) Δv_b
    Error/Jacobian/covariance compose via the block chain rule with
    right-multiplicative (body-frame) rotation errors, the convention of the
    midpoint propagation (F[3:6,3:6] = I - [w]x dt).
    """
    mv = lambda M, x: (M @ x[..., None])[..., 0]

    # 1) re-center b at a's linearization biases
    dba = pre_a.linearized_ba - pre_b.linearized_ba
    dbg = pre_a.linearized_bg - pre_b.linearized_bg
    Jb = pre_b.jacobian
    pb = (pre_b.delta_p + mv(Jb[..., 0:3, 9:12], dba)
          + mv(Jb[..., 0:3, 12:15], dbg))
    vb = (pre_b.delta_v + mv(Jb[..., 6:9, 9:12], dba)
          + mv(Jb[..., 6:9, 12:15], dbg))
    qb = lie.quat_normalize(lie.quat_mul(
        pre_b.delta_q, lie.quat_exp(mv(Jb[..., 3:6, 12:15], dbg))))

    Ra = lie.quat_to_rot(pre_a.delta_q)
    Tb = pre_b.sum_dt[..., None]

    delta_q = lie.quat_normalize(lie.quat_mul(pre_a.delta_q, qb))
    delta_p = pre_a.delta_p + pre_a.delta_v * Tb + mv(Ra, pb)
    delta_v = pre_a.delta_v + mv(Ra, vb)

    I3 = torch.eye(3, dtype=Ra.dtype, device=Ra.device).expand(Ra.shape)
    Z3 = torch.zeros_like(Ra)
    Rb_T = lie.quat_to_rot(qb).transpose(-1, -2)

    def bmat(rows):
        return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)

    # F: sensitivity of composed errors to interval-a errors.  Right-mult
    # rotation error: R(q ⊞ δθ) = R (I + [δθ]x), so d(R_a x)/dδθ_a = -R_a [x]x.
    Tb_s = pre_b.sum_dt[..., None, None]
    F = bmat([
        [I3, -Ra @ lie.skew(pb), I3 * Tb_s, Z3, Z3],
        [Z3, Rb_T, Z3, Z3, Z3],
        [Z3, -Ra @ lie.skew(vb), I3, Z3, Z3],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])
    # G maps interval-b delta errors into the composed error.  For the
    # deterministic bias-sensitivity Jacobian the shared bias enters through
    # F's bias columns only (G bias rows = 0, to not double count); for the
    # covariance, b's independently-accumulated bias random walk must be
    # added (G_cov bias rows = I).
    G_jac = bmat([
        [Ra, Z3, Z3, Z3, Z3],
        [Z3, I3, Z3, Z3, Z3],
        [Z3, Z3, Ra, Z3, Z3],
        [Z3, Z3, Z3, Z3, Z3],
        [Z3, Z3, Z3, Z3, Z3],
    ])
    G_cov = bmat([
        [Ra, Z3, Z3, Z3, Z3],
        [Z3, I3, Z3, Z3, Z3],
        [Z3, Z3, Ra, Z3, Z3],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])
    tr = lambda M: M.transpose(-1, -2)
    jac = F @ pre_a.jacobian + G_jac @ pre_b.jacobian
    cov = (F @ pre_a.covariance @ tr(F)
           + G_cov @ pre_b.covariance @ tr(G_cov))

    return Preintegrated(
        delta_p=delta_p,
        delta_q=delta_q,
        delta_v=delta_v,
        jacobian=jac,
        covariance=cov,
        sum_dt=pre_a.sum_dt + pre_b.sum_dt,
        linearized_ba=pre_a.linearized_ba,
        linearized_bg=pre_a.linearized_bg,
        gyr_i=pre_a.gyr_i,
        gyr_j=pre_b.gyr_j,
    )
