"""Batched FLAGSHIP-mode window problems and their solve: RTK-VI windows
with GNSS observation rows, condensed IMU-GNSS chains between every pair
of frames, receiver clocks, carrier-phase ambiguities, and tail covariance
extraction for LAMBDA.

Construction (batched over windows, made from one ``torch.Generator``):
  1. every window interval (k, k+1) is covered by one chain of ``cap``
     sub-preintegrations; truth states propagate through all of them, so
     frame truths and hidden-epoch truths are exactly IMU-consistent;
  2. landmarks are projected from the frame truths (consistent vision);
  3. GNSS measurements (pseudorange / carrier phase / doppler) are
     synthesized by evaluating the factor models at the truth, so
     residuals are exactly zero at the truth;
  4. the initial guess perturbs frames, hidden states, landmarks, clocks
     and ambiguities; the solve must pull everything back.

The random streams differ from the JAX generator's (``jax.random`` cannot
be reproduced); ``problem_from_numpy`` takes a JAX-made problem instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..core.state import (FRAME_DIM, NCLOCK, POSE_DIM, TangentLayout,
                          WindowState, retract_window, window_boxminus)
from ..device import full_precision, resolve_device
from ..factors.base import take_rows
from ..factors.gnss import (GnssObsBatch, doppler_batch,
                            spp_carrier_phase_batch, spp_pseudorange_batch)
from ..factors.inertial import imu_factor_batch
from ..factors.visual import PROJ_SQRT_INFO
from ..geodesy.earth import _ecef_to_geodetic_np
from ..ops import lie
from ..ops.pallas_proj import proj_plan, proj_segments_pallas
from ..preintegration.midpoint import Preintegrated, preintegrate
from ..solver.block_hessian import BlockHess, chain_blocks_into
from ..solver.chain_factors import (ChainHidden, ChainMid, ChainRows,
                                    ChainStatic, _gnss_row_eval,
                                    chain_contrib, chain_imu_whitening,
                                    chain_retract_aux, empty_chain_mid)
from ..solver.gauss_newton import DoglegConfig, assemble_gram, dogleg_solve
from ..solver.marginalization import masked_cov_cols
from ..solver.structured import blocks_from_segments
from .problems import IMU_NOISE, VIWindowProblem


def _anchor_frame_np():
    """Fixed site of the synthetic constellation and its ENU->ECEF
    rotation (host numpy, f64)."""
    anchor = np.asarray([-2411798.13, 5380966.80, 2437762.98])
    lat, lon, _ = _ecef_to_geodetic_np(anchor)
    sl, cl = np.sin(lon), np.cos(lon)
    sp, cp = np.sin(lat), np.cos(lat)
    # rows of ENU rotation (E, N, U in ECEF); enu_to_ecef = transpose
    E = np.array([[-sl, cl, 0.0],
                  [-sp * cl, -sp * sl, cp],
                  [cp * cl, cp * sl, sp]])
    return anchor, E.T


_ANCHOR_NP, _R_E_NP = _anchor_frame_np()


def _anchor_frame(dtype=torch.float64, device=None):
    return (torch.tensor(_ANCHOR_NP, dtype=dtype, device=device),
            torch.tensor(_R_E_NP, dtype=dtype, device=device))


class RTKWindowProblem(NamedTuple):
    """A batch of flagship window problems (leading dim B everywhere)."""

    state0: WindowState      # initial guess (perturbed), incl. clk/pb
    hid0: ChainHidden        # (B, NCH, cap-1, ...) hidden initial guess
    st: ChainStatic          # (B, NCH, ...) chain static data
    pre: Preintegrated       # window-interval preintegrations (unused: all
    #                          intervals are chain-covered; kept for shape)
    pre_valid: torch.Tensor  # (B, NF-1) all False
    f_ids: torch.Tensor
    l_ids: torch.Tensor
    obs_xy: torch.Tensor
    obs_valid: torch.Tensor
    b_pr: GnssObsBatch       # window-frame pseudorange rows
    b_cp: GnssObsBatch       # window-frame carrier-phase rows
    b_dopp: GnssObsBatch     # window-frame doppler rows
    prior_diag: torch.Tensor  # (B, D) sqrt-information diag of the gauge
    #                          prior (pins frame 0 only)
    prior_x0: WindowState
    free_mask: torch.Tensor
    cov_cols: torch.Tensor   # (B, nb) tangent indices of the ambiguity tail
    truth: WindowState
    hid_truth: ChainHidden


# which fields of each container are containers themselves
_NESTED = {
    RTKWindowProblem: dict(
        state0=WindowState, hid0=ChainHidden, st=ChainStatic,
        pre=Preintegrated, b_pr=GnssObsBatch, b_cp=GnssObsBatch,
        b_dopp=GnssObsBatch, prior_x0=WindowState, truth=WindowState,
        hid_truth=ChainHidden),
    ChainStatic: dict(pre=Preintegrated, rows=ChainRows, mid=ChainMid),
    VIWindowProblem: dict(state0=WindowState, pre=Preintegrated,
                          prior_x0=WindowState, truth=WindowState),
}


def tree_from_numpy(cls, tree, device=None, dtype=torch.float64):
    """Build container ``cls`` — ``RTKWindowProblem``, ``VIWindowProblem``,
    ``WindowState``, ``ChainStatic``, ``ChainHidden``, ``Preintegrated`` or
    any other NamedTuple of this package — from nested dicts of numpy
    arrays keyed by field name, e.g. the JAX package's pytree of the same
    name after
    ``np.asarray`` over ``_asdict()``.  Floating arrays become ``dtype``,
    integer arrays int64, bools stay."""
    dev = resolve_device(device)
    sub = _NESTED.get(cls, {})

    def leaf(a):
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype != torch.bool:
            t = t.to(torch.int64)
        return t.to(dev)

    return cls(**{k: tree_from_numpy(sub[k], tree[k], dev, dtype)
                  if k in sub else leaf(tree[k]) for k in cls._fields})


def problem_from_numpy(tree, device=None, dtype=torch.float64
                       ) -> RTKWindowProblem:
    """The port's RTKWindowProblem from the JAX one as nested numpy dicts."""
    return tree_from_numpy(RTKWindowProblem, tree, device, dtype)


def _sat_constellation(randu, B, ns, device):
    """ns satellites per window on a 2.66e7 m shell above the anchor."""
    anchor, R_e = _anchor_frame(device=device)
    up = anchor / torch.linalg.norm(anchor)
    e1 = R_e[:, 0]
    n1 = R_e[:, 1]
    az = randu(0.0, 2.0 * math.pi, B, ns)
    el = randu(math.radians(35.0), math.radians(80.0), B, ns)
    dirs = (torch.cos(el)[..., None]
            * (torch.sin(az)[..., None] * e1 + torch.cos(az)[..., None] * n1)
            + torch.sin(el)[..., None] * up)
    pos = anchor + dirs * (2.66e7 - torch.linalg.norm(anchor))
    pos = pos / torch.linalg.norm(pos, dim=-1, keepdim=True) * 2.66e7
    tang = lie.cross(up, pos)
    vel = tang / torch.linalg.norm(tang, dim=-1, keepdim=True) * 3874.0
    return pos, vel


def _geom_rows(sat_pos):
    anchor, _ = _anchor_frame(device=sat_pos.device)
    d0 = anchor - sat_pos
    r0 = torch.linalg.norm(d0, dim=-1)
    return d0 / r0[..., None], r0


def make_synthetic_rtk_windows(seed: int, batch: int, nf: int = 11,
                               nl: int = 352, nobs: int = 2816,
                               nsamp: int = 8, cap: int = 11, ns: int = 14,
                               nb: int = 16, dtype=torch.float64,
                               device=None) -> RTKWindowProblem:
    """Synthesize ``batch`` flagship windows in f64 on ``device``, then
    cast floating fields to ``dtype``.  Random numbers come from one CPU
    ``torch.Generator`` seeded with ``seed``, so a seed draws the same
    numbers on every device."""
    dev = resolve_device(device)
    f64 = torch.float64
    gen = torch.Generator().manual_seed(seed)
    B, nch, nh = batch, nf - 1, cap - 1
    ar = lambda *a: torch.arange(*a, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=f64).to(dev)

    def randu(lo, hi, *shape):
        u = torch.rand(shape, generator=gen, dtype=f64).to(dev)
        return lo + (hi - lo) * u

    lay = TangentLayout(nf=nf, nl=nl, nb=nb, nc=2)
    _, R_e = _anchor_frame(device=dev)
    g_world = torch.tensor([0.0, 0.0, 9.81], dtype=f64, device=dev)

    # ---- IMU: (nch, cap) sub-intervals, truth propagated through all ----
    dt = 0.1 / (nsamp - 1)         # each leaf ~0.1 s => interval ~cap/10 s
    acc = 0.5 * randn(B, nch, cap, 1, 3) + g_world
    gyr = 0.3 * randn(B, nch, cap, 1, 3)
    accs = acc.expand(B, nch, cap, nsamp, 3)
    gyrs = gyr.expand(B, nch, cap, nsamp, 3)
    dts = torch.full((B, nch, cap, nsamp), dt, dtype=f64, device=dev)
    valid = torch.ones((B, nch, cap, nsamp), dtype=torch.bool, device=dev)
    zeros3 = torch.zeros((B, nch, cap, 3), dtype=f64, device=dev)
    pre_leaf = preintegrate(dts, accs, gyrs, valid, zeros3, zeros3,
                            IMU_NOISE)
    flat = tree_map(lambda x: x.flatten(1, 2), pre_leaf)   # (B, nch*cap,..)

    p = torch.zeros((B, 3), dtype=f64, device=dev)
    q = lie.quat_identity((B,), f64, dev)
    v = 0.3 * randn(B, 3)
    ps, qs, vs = [p], [q], [v]
    for k in range(nch * cap):
        T = flat.sum_dt[:, k, None]
        p, v, q = (p + v * T - 0.5 * g_world * T * T
                   + lie.quat_rotate(q, flat.delta_p[:, k]),
                   v - g_world * T + lie.quat_rotate(q, flat.delta_v[:, k]),
                   lie.quat_normalize(lie.quat_mul(q, flat.delta_q[:, k])))
        ps.append(p)
        qs.append(q)
        vs.append(v)
    ps_all, qs_all, vs_all = (torch.stack(x, dim=1) for x in (ps, qs, vs))
    frame_idx = ar(nf) * cap
    fp, fq, fv = ps_all[:, frame_idx], qs_all[:, frame_idx], \
        vs_all[:, frame_idx]
    hid_idx = ar(nch)[:, None] * cap + ar(1, cap)[None, :]   # (nch, cap-1)
    hp, hq, hv = ps_all[:, hid_idx], qs_all[:, hid_idx], vs_all[:, hid_idx]

    # ---- truth states: clocks + integer ambiguities ----
    clk_truth = torch.zeros((B, nf, NCLOCK), dtype=f64, device=dev)
    clk_truth[..., 0] = 0.4                            # RTK dtur
    clk_truth[..., 6] = 1.2 + 0.01 * ar(nf)            # SPP dtgps
    clk_truth[..., 12] = 0.05                          # doppler drift
    pb_truth = torch.randint(-30, 30, (B, nb), generator=gen).to(f64).to(dev)
    lam = torch.full((nb,), 0.19029367279836487, dtype=f64, device=dev)

    truth = WindowState.zeros(nf, nl, nb, dtype=f64, device=dev,
                              batch_shape=(B,))._replace(
        p=fp, q=fq, v=fv, clk=clk_truth, phase_bias=pb_truth)
    zh = torch.zeros((B, nch, nh, 3), dtype=f64, device=dev)
    hid_truth = ChainHidden(
        p=hp, q=hq, v=hv, ba=zh, bg=zh,
        clk=clk_truth[:, 0, None, None, :].expand(B, nch, nh, NCLOCK))

    # ---- landmarks + projections ----
    lm = torch.stack([randu(-8.0, 8.0, B, nl), randu(-6.0, 6.0, B, nl),
                      randu(8.0, 35.0, B, nl)], dim=-1)
    truth = truth._replace(landmarks=lm)
    f_ids = ar(nf).repeat(nl)[:nobs].expand(B, nobs)
    l_ids = ar(nl).repeat_interleave(nf)[:nobs].expand(B, nobs)
    pc = lie.quat_rotate_inv(take_rows(fq, f_ids),
                             take_rows(lm, l_ids) - take_rows(fp, f_ids))
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

    # ---- satellites + WINDOW-frame GNSS rows (z from the model @truth) ----
    sat_pos, sat_vel = _sat_constellation(randu, B, ns, dev)
    r0u, r0 = _geom_rows(sat_pos)
    nrow = nf * ns
    row_f = ar(nf).repeat_interleave(ns).expand(B, nrow)
    row_s = ar(ns).repeat(nf)
    ones_b = torch.ones((B, nrow), dtype=torch.bool, device=dev)

    def full_i(val):
        return torch.full((B, nrow), val, dtype=torch.int64, device=dev)

    def mk_batch(clk_slot, pb, w):
        return GnssObsBatch(
            frame_ids=row_f, clk_slot=full_i(clk_slot), drift_slot=full_i(12),
            pb_slot=pb, r0_unit=r0u[:, row_s], r0=r0[:, row_s],
            sat_xy=sat_pos[:, row_s, :2], sat_vel=sat_vel[:, row_s],
            z=torch.zeros((B, nrow), dtype=f64, device=dev),
            wavelength=lam[row_s.clamp(0, nb - 1)].expand(B, nrow),
            weight=torch.full((B, nrow), w, dtype=f64, device=dev),
            valid=ones_b)

    # pseudorange and carrier phase SHARE clock slot 0: without a
    # pseudorange anchor on the carrier clock a common-mode (N, clk) shift
    # is a gauge freedom and the ambiguity tail covariance is singular
    b_pr = mk_batch(0, full_i(0), 1.0 / 0.8)
    b_cp = mk_batch(0, row_s.clamp(0, nb - 1).expand(B, nrow), 1.0 / 0.004)
    b_dopp = mk_batch(12, full_i(0), 1.0 / 0.1)

    # synthesize measurements: residual(z=0) = w·model  =>  z = model
    def z_of(fn, batch_):
        fb = fn(truth, batch_, R_e)
        return batch_._replace(z=fb.res[..., 0] / batch_.weight)

    b_pr = z_of(spp_pseudorange_batch, b_pr)
    b_cp = z_of(spp_carrier_phase_batch, b_cp)
    b_dopp = z_of(doppler_batch, b_dopp)

    # ---- chain static data: rows at every hidden epoch ----
    cr = nh * ns * 3
    h_si = ar(1, cap).repeat_interleave(ns * 3)
    h_sat = ar(ns).repeat_interleave(3).repeat(nh)
    h_kind = ar(3).repeat(nh * ns)
    h_clk = torch.where(h_kind == 2, 12, 0)
    h_pb = h_sat.clamp(0, nb - 1)
    h_w = torch.tensor([1.0 / 0.8, 1.0 / 0.004, 1.0 / 0.1], dtype=f64,
                       device=dev)[h_kind]
    per_chain = lambda x: x.expand(B, nch, cr)
    rows = ChainRows(
        state_idx=per_chain(h_si), kind=per_chain(h_kind),
        clk_slot=per_chain(h_clk), pb_slot=per_chain(h_pb),
        r0_unit=r0u[:, None, h_sat].expand(B, nch, cr, 3),
        r0=r0[:, None, h_sat].expand(B, nch, cr),
        sat_xy=sat_pos[:, None, h_sat, :2].expand(B, nch, cr, 2),
        sat_vel=sat_vel[:, None, h_sat].expand(B, nch, cr, 3),
        z=torch.zeros((B, nch, cr), dtype=f64, device=dev),
        wavelength=per_chain(lam[h_pb]), weight=per_chain(h_w),
        valid=torch.ones((B, nch, cr), dtype=torch.bool, device=dev))
    res, _ = _gnss_row_eval(hid_truth, pb_truth, rows, R_e)
    rows = rows._replace(z=res[..., 0] / rows.weight)
    st = ChainStatic(
        left=ar(nch).expand(B, nch), right=ar(1, nf).expand(B, nch),
        n_leaves=torch.full((B, nch), cap, dtype=torch.int64, device=dev),
        active=torch.ones((B, nch), dtype=torch.bool, device=dev),
        pre=pre_leaf,
        pre_valid=torch.ones((B, nch, cap), dtype=torch.bool, device=dev),
        rows=rows,
        mid=empty_chain_mid(nb, f64, dev, (B, nch)))

    # ---- prior: pin frame 0 (gauge; GNSS-mode bootstrap weights) ----
    dvec = torch.zeros((B, lay.dim), dtype=f64, device=dev)
    i0, s0 = lay.pose_idx(0), lay.sb_idx(0)
    dvec[:, i0:i0 + POSE_DIM] = 2e2
    dvec[:, s0:s0 + 9] = 1e1

    # ---- perturbed initial guess ----
    mask0 = (ar(nf) > 0).to(f64)[:, None]
    state0 = truth._replace(
        p=truth.p + 0.1 * randn(B, nf, 3) * mask0,
        q=lie.quat_boxplus(truth.q, 0.02 * randn(B, nf, 3) * mask0),
        v=truth.v + 0.1 * randn(B, nf, 3) * mask0,
        landmarks=truth.landmarks + 0.3 * randn(B, nl, 3)
        * lm_ok[..., None].to(f64),
        clk=truth.clk + 0.3 * randn(B, nf, NCLOCK),
        phase_bias=truth.phase_bias + 0.2 * randn(B, nb))
    hid0 = hid_truth._replace(
        p=hid_truth.p + 0.05 * randn(B, nch, nh, 3),
        q=lie.quat_boxplus(hid_truth.q, 0.01 * randn(B, nch, nh, 3)))

    free = torch.zeros((B, lay.dim), dtype=torch.bool, device=dev)
    free[:, lay.lm_off:lay.lm_off + 3 * nl] = lm_ok.repeat_interleave(3, -1)
    free[:, lay.frame_off:lay.frame_off + FRAME_DIM * nf] = True
    free[:, lay.clk_off:lay.clk_off + NCLOCK * nf] = True
    free[:, lay.pb_off:lay.pb_off + nb] = True

    probs = RTKWindowProblem(
        state0=state0, hid0=hid0, st=st,
        pre=tree_map(lambda x: x[:, :, 0], pre_leaf),
        pre_valid=torch.zeros((B, nf - 1), dtype=torch.bool, device=dev),
        f_ids=f_ids, l_ids=l_ids, obs_xy=obs_xy, obs_valid=obs_valid,
        b_pr=b_pr, b_cp=b_cp, b_dopp=b_dopp, prior_diag=dvec,
        prior_x0=truth, free_mask=free,
        cov_cols=(lay.pb_off + ar(nb)).expand(B, nb),
        truth=truth, hid_truth=hid_truth)
    # contiguous copies: expanded views would alias across the batch
    return tree_map(lambda x: (x.to(dtype) if x.is_floating_point() else x)
                    .contiguous(), probs)


# ---------------------------------------------------------------------------
# solve path
# ---------------------------------------------------------------------------
def _solve_one_rtk(prob: RTKWindowProblem, lay: TangentLayout,
                   cfg: DoglegConfig, cap: int):
    """The flagship window solve of every window of the batch ``prob``.

    The Hessian keeps its Schur block structure end to end
    (solver/block_hessian.py).  The projection rows go through
    ``proj_segments_pallas``: the CUDA kernel on the GPU, its plain
    version on the CPU.
    """
    dtype, dev = prob.state0.p.dtype, prob.state0.p.device
    B = prob.state0.p.shape[0]
    _, R_e = _anchor_frame(dtype, dev)
    pbg = torch.zeros(3, dtype=dtype, device=dev)
    g_world = torch.tensor([0.0, 0.0, 9.81], dtype=dtype, device=dev)
    n3 = 3 * lay.nl
    # diagonal gauge prior (r0 = 0): H0 = diag(d²), g = H0·dx — evaluated
    # directly, never materialized as a (D, D) jacobian
    d2 = prob.prior_diag * prob.prior_diag

    def prior_gc(win):
        dx = window_boxminus(win, prob.prior_x0)
        g = d2 * dx
        return g, 0.5 * torch.sum(dx * g, dim=-1)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    bh_prior = BlockHess(
        Hll=eye3 * d2[:, :n3].reshape(B, lay.nl, 3)[..., None],
        Hlr=torch.zeros((B, lay.nl, 3, lay.dim - n3), dtype=dtype,
                        device=dev),
        Hrr=torch.diag_embed(d2[:, n3:]))
    # per-solve constant: IMU whitening of every chain leaf
    imu_W = chain_imu_whitening(prob.st)
    # the kernel skips the extrinsic products unless some window frees an
    # extrinsic slot (one host read per solve, outside the iterations)
    ext = slice(lay.ext_off, lay.ext_off + POSE_DIM * lay.nc)
    want_ext = bool(prob.free_mask[:, ext].any())
    # per-solve constant: the observations grouped for the kernel (one
    # camera)
    cam_ids = torch.zeros_like(prob.f_ids)
    plan = proj_plan(lay, prob.f_ids, cam_ids, prob.l_ids, prob.obs_valid)

    def eval_fn(comp):
        win, hid = comp
        S, pcost = proj_segments_pallas(
            lay, win.p, win.q, win.tic, win.qic, win.landmarks, pbg,
            prob.f_ids, cam_ids, prob.l_ids, prob.obs_xy, prob.obs_valid,
            PROJ_SQRT_INFO, want_ext=want_ext, plan=plan)
        bh, g, cost = blocks_from_segments(lay, S, pcost)
        # chains touch frames/clk/pb only — entirely inside the reduced
        # block; the linearization aux is threaded to the retraction
        Hb, gb, _, ccost, aux = chain_contrib(
            win, hid, prob.st, lay, R_e, pbg, g_world, cap, want_aux=True,
            imu_W=imu_W)
        bh, g = chain_blocks_into(bh, g, Hb, gb, prob.st.left,
                                  prob.st.right, lay)
        batches = [
            imu_factor_batch(win, prob.pre, pbg, g_world, prob.pre_valid),
            spp_pseudorange_batch(win, prob.b_pr, R_e),
            spp_carrier_phase_batch(win, prob.b_cp, R_e),
            doppler_batch(win, prob.b_dopp, R_e),
        ]
        # window-frame GNSS + IMU rows touch only the reduced block: Gram
        # assembly into (Dr, Dr) with shifted indices
        shifted = [b._replace(gidx=b.gidx - n3) for b in batches]
        Hg, gg, cg = assemble_gram(shifted, lay.dim - n3)
        gp, cp = prior_gc(win)
        bh = bh._replace(Hrr=bh.Hrr + Hg).add(bh_prior)
        g = g + gp + torch.nn.functional.pad(gg, (n3, 0))
        return bh, g, cost + ccost + cg + cp, aux

    def retract_fn(comp, dx, aux):
        win, hid = comp
        h2 = chain_retract_aux(hid, prob.st, dx, aux, lay, cap)
        return (retract_window(win, dx), h2)

    res = dogleg_solve(eval_fn, retract_fn, (prob.state0, prob.hid0),
                       prob.free_mask, cfg, has_aux=True)
    # ambiguity tail covariance for LAMBDA, from the final Hessian
    X = masked_cov_cols(res.H, prob.free_mask, prob.cov_cols)
    win, hid = res.state
    return win, hid, res.cost, res.n_accepted, X


def batched_rtk_solve(probs: RTKWindowProblem, lay: TangentLayout,
                      cfg: DoglegConfig, cap: int, device=None):
    """Solve a batch of flagship windows on ``device`` (default ``cuda``;
    pass ``device="cpu"`` for the CPU).  Returns (win, hid, cost (B,),
    n_accepted (B,), X (B, D, nb))."""
    dev = resolve_device(device)
    full_precision()
    probs = tree_map(lambda x: x.to(dev), probs)
    return _solve_one_rtk(probs, lay, cfg, cap)
