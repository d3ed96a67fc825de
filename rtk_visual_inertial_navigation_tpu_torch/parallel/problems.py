"""Batched, self-consistent VI-only window problems (the VI sub-bench).

Construction, batched over windows and made from one ``torch.Generator``:

  1. random IMU samples per interval are preintegrated;
  2. window states are built from the preintegration deltas, so the IMU
     factors are exactly consistent;
  3. landmarks are placed in front of the identity-extrinsic cameras and
     projected into consistent measurements; a landmark with fewer than 2
     valid observations is not triangulable and is dropped and pinned;
  4. a diagonal prior pins frame 0 (gauge), and the initial guess perturbs
     frames 1+ and the landmarks.

The prior is landmark-free, which keeps the landmark block 3x3-block-
diagonal and the dense Schur elimination exact.  The random streams
differ from the JAX generator's; ``vi_problem_from_numpy`` takes a
JAX-made problem instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._pytree import tree_map

from ..core.state import FRAME_DIM, POSE_DIM, TangentLayout, WindowState
from ..device import resolve_device
from ..factors.base import take_rows
from ..factors.inertial import sqrt_info_of_cov
from ..ops import lie
from ..preintegration.midpoint import ImuNoise, Preintegrated, preintegrate

IMU_NOISE = ImuNoise(0.05, 0.005, 5e-4, 5e-5)


class VIWindowProblem(NamedTuple):
    """A batch of VI window problems (leading dim B everywhere)."""

    state0: WindowState        # initial guess (perturbed)
    pre: Preintegrated         # (B, NF-1, ...)
    imu_W: torch.Tensor        # (B, NF-1, 15, 15) sqrt-information
    pre_valid: torch.Tensor    # (B, NF-1)
    f_ids: torch.Tensor        # (B, nobs)
    l_ids: torch.Tensor        # (B, nobs)
    obs_xy: torch.Tensor       # (B, nobs, 2)
    obs_valid: torch.Tensor    # (B, nobs)
    prior_J: torch.Tensor      # (B, D, D) diagonal gauge prior
    prior_r0: torch.Tensor     # (B, D)
    prior_x0: WindowState
    free_mask: torch.Tensor    # (B, D)
    truth: WindowState         # for accuracy checks


def make_synthetic_windows(seed: int, batch: int, nf: int = 8, nl: int = 64,
                           nobs: int = 448, n_samples: int = 16,
                           dtype=torch.float64, device=None
                           ) -> VIWindowProblem:
    """Synthesize ``batch`` VI windows in f64 on ``device`` (default
    ``cuda``), then cast floating fields to ``dtype``.  Random numbers come
    from one CPU ``torch.Generator`` seeded with ``seed``, so a seed draws
    the same numbers on every device."""
    dev = resolve_device(device)
    f64 = torch.float64
    gen = torch.Generator().manual_seed(seed)
    B, ni = batch, nf - 1
    lay = TangentLayout(nf=nf, nl=nl, nb=1, nc=2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=f64).to(dev)

    def randu(lo, hi, *shape):
        u = torch.rand(shape, generator=gen, dtype=f64).to(dev)
        return lo + (hi - lo) * u

    g_world = torch.tensor([0.0, 0.0, 9.81], dtype=f64, device=dev)

    # ---- IMU streams: constant random acceleration / rate per interval ----
    dt = 0.25 / (n_samples - 1)
    acc = 0.5 * randn(B, ni, 1, 3) + g_world
    gyr = 0.3 * randn(B, ni, 1, 3)
    zeros3 = torch.zeros((B, ni, 3), dtype=f64, device=dev)
    pre = preintegrate(
        torch.full((B, ni, n_samples), dt, dtype=f64, device=dev),
        acc.expand(B, ni, n_samples, 3), gyr.expand(B, ni, n_samples, 3),
        torch.ones((B, ni, n_samples), dtype=torch.bool, device=dev),
        zeros3, zeros3, IMU_NOISE)

    # ---- states propagated from the deltas ----
    p = torch.zeros((B, 3), dtype=f64, device=dev)
    q = lie.quat_identity((B,), f64, dev)
    v = 0.3 * randn(B, 3)
    ps, qs, vs = [p], [q], [v]
    for k in range(ni):
        T = pre.sum_dt[:, k, None]
        p, v, q = (p + v * T - 0.5 * g_world * T * T
                   + lie.quat_rotate(q, pre.delta_p[:, k]),
                   v - g_world * T + lie.quat_rotate(q, pre.delta_v[:, k]),
                   lie.quat_normalize(lie.quat_mul(q, pre.delta_q[:, k])))
        ps.append(p)
        qs.append(q)
        vs.append(v)
    ps, qs, vs = (torch.stack(x, dim=1) for x in (ps, qs, vs))

    # ---- landmarks in front of the (identity-extrinsic) cameras ----
    lm = torch.stack([randu(-6.0, 6.0, B, nl), randu(-4.0, 4.0, B, nl),
                      randu(8.0, 30.0, B, nl)], dim=-1)
    truth = WindowState.zeros(nf, nl, 1, dtype=f64, device=dev,
                              batch_shape=(B,))._replace(
        p=ps, q=qs, v=vs, landmarks=lm)

    # ---- observations: every (frame, landmark) pair, capped at nobs ----
    ar = lambda n: torch.arange(n, device=dev)
    f_ids = ar(nf).repeat(nl)[:nobs].expand(B, nobs)
    l_ids = ar(nl).repeat_interleave(nf)[:nobs].expand(B, nobs)
    pc = lie.quat_rotate_inv(take_rows(qs, f_ids),
                             take_rows(lm, l_ids) - take_rows(ps, f_ids))
    obs_xy = pc[..., 0:2] / pc[..., 2:3]
    obs_valid = ((pc[..., 2] > 1.0) & (obs_xy[..., 0].abs() < 2.0)
                 & (obs_xy[..., 1].abs() < 2.0))
    # a landmark with <2 valid observations is not triangulable (its 3x3
    # Schur block is rank-deficient): drop its observations, keep it at
    # truth, and pin it in the free mask
    lm_nobs = torch.zeros((B, nl), dtype=torch.int64, device=dev)
    lm_nobs.scatter_add_(1, l_ids, obs_valid.to(torch.int64))
    lm_ok = lm_nobs >= 2
    obs_valid = obs_valid & take_rows(lm_ok, l_ids)

    # ---- landmark-free diagonal prior pinning frame 0 (gauge) ----
    dvec = torch.zeros((B, lay.dim), dtype=f64, device=dev)
    i0, s0 = lay.pose_idx(0), lay.sb_idx(0)
    dvec[:, i0:i0 + POSE_DIM] = 2e2
    dvec[:, s0:s0 + 9] = 1e1

    # ---- perturbed initial guess (frame 0 stays at the prior) ----
    mask0 = (ar(nf) > 0).to(f64)[:, None]
    state0 = truth._replace(
        p=truth.p + 0.1 * randn(B, nf, 3) * mask0,
        q=lie.quat_boxplus(truth.q, 0.02 * randn(B, nf, 3) * mask0),
        v=truth.v + 0.1 * randn(B, nf, 3) * mask0,
        landmarks=truth.landmarks + 0.3 * randn(B, nl, 3)
        * lm_ok[..., None].to(f64))

    free = torch.zeros((B, lay.dim), dtype=torch.bool, device=dev)
    free[:, lay.lm_off:lay.lm_off + 3 * nl] = lm_ok.repeat_interleave(3, -1)
    free[:, lay.frame_off:lay.frame_off + FRAME_DIM * nf] = True

    probs = VIWindowProblem(
        state0=state0, pre=pre, imu_W=sqrt_info_of_cov(pre.covariance),
        pre_valid=torch.ones((B, ni), dtype=torch.bool, device=dev),
        f_ids=f_ids, l_ids=l_ids, obs_xy=obs_xy, obs_valid=obs_valid,
        prior_J=torch.diag_embed(dvec), prior_r0=torch.zeros_like(dvec),
        prior_x0=truth, free_mask=free, truth=truth)
    # contiguous copies: expanded views would alias across the batch
    return tree_map(lambda x: (x.to(dtype) if x.is_floating_point() else x)
                    .contiguous(), probs)


def vi_problem_from_numpy(tree, device=None, dtype=torch.float64
                          ) -> VIWindowProblem:
    """The port's VIWindowProblem from the JAX one as nested numpy dicts
    (``np.asarray`` over the JAX pytree's ``_asdict()``)."""
    # imported here: problems_gnss imports this module
    from .problems_gnss import tree_from_numpy
    return tree_from_numpy(VIWindowProblem, tree, device, dtype)
