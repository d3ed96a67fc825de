"""IMU-GNSS chain factors: hidden GNSS epochs between keyframes.

Runs of GNSS epochs between consecutive visual keyframes hide inside one
condensed factor:
  - hidden states live in a fixed-capacity container (`ChainHidden`)
    optimized jointly with the window by the same dogleg loop;
  - every iteration re-evaluates all chain factors at the current hidden
    linearization;
  - per-epoch clock elimination is a masked diagonal Schur step;
  - the chain condenses onto (frame_i 15, frame_j 15, N) by the prefix
    scan of solver.chain;
  - back-substitution recovers the interior given the endpoint/tail
    increments.

Every chain tensor has leading dims (B, nch): windows, then chains.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import FRAME_DIM, NCLOCK, WindowState
from ..factors.base import rowwise_res_jac, take_rows
from ..factors.gnss import _ecef_local, _rho_reduced
from ..factors.inertial import _single_imu, sqrt_info_of_cov
from ..geodesy.earth import CLIGHT, OMGE
from ..ops import lie
from ..preintegration.midpoint import Preintegrated
from .chain import (ChainTailElem, condense_chain_tail,
                    condensed_from_prefix, scan_chain_tail_prefix,
                    solve_chain_interior_affine)
from .gauss_newton import one_hot

D = FRAME_DIM            # 15: per-state tangent [p3, th3, v3, ba3, bg3]
NCLK = NCLOCK            # 13 per-epoch clock slots


class ChainRows(NamedTuple):
    """Flattened GNSS observation rows of one chain (capacity CR).

    One row = one (hidden-epoch, satellite, frequency) channel.  ``kind``:
    0 = pseudorange, 1 = carrier phase, 2 = doppler.  Geometry fields as
    factors.gnss.GnssObsBatch.
    """

    state_idx: torch.Tensor   # (..., CR) int chain state position (1..CAP-1)
    kind: torch.Tensor        # (..., CR) int
    clk_slot: torch.Tensor    # (..., CR) int 0..12 (doppler rows use 12)
    pb_slot: torch.Tensor     # (..., CR) int global phase-bias slot
    r0_unit: torch.Tensor     # (..., CR,3)
    r0: torch.Tensor          # (..., CR)
    sat_xy: torch.Tensor      # (..., CR,2)
    sat_vel: torch.Tensor     # (..., CR,3)
    z: torch.Tensor           # (..., CR) reduced measurement
    wavelength: torch.Tensor  # (..., CR)
    weight: torch.Tensor      # (..., CR)
    valid: torch.Tensor       # (..., CR) bool


class ChainHidden(NamedTuple):
    """Hidden interior states of one chain (positions 1..CAP-1)."""

    p: torch.Tensor           # (..., CAP-1, 3)
    q: torch.Tensor           # (..., CAP-1, 4)
    v: torch.Tensor           # (..., CAP-1, 3)
    ba: torch.Tensor          # (..., CAP-1, 3)
    bg: torch.Tensor          # (..., CAP-1, 3)
    clk: torch.Tensor         # (..., CAP-1, NCLK)


class ChainMid(NamedTuple):
    """Frozen mid-chain marginal prior over (state_k, state_{k+1}, N),
    evaluated to first order as the endpoints move:
    g(dx) = g0 + H·dx, dx = x ⊟ x0 over [state_k | state_{k+1} | N]."""

    H: torch.Tensor           # (..., 2D+dn, 2D+dn)
    g0: torch.Tensor          # (..., 2D+dn)
    c0: torch.Tensor          # (...) cost constant at linearization
    k: torch.Tensor           # (...) int gap leaf index
    valid: torch.Tensor       # (...) bool
    p0: torch.Tensor          # (..., 2, 3) linearization states (k, k+1)
    q0: torch.Tensor          # (..., 2, 4)
    v0: torch.Tensor          # (..., 2, 3)
    ba0: torch.Tensor         # (..., 2, 3)
    bg0: torch.Tensor         # (..., 2, 3)
    pb0: torch.Tensor         # (..., dn) phase-bias linearization


def empty_chain_mid(nb: int, dtype=torch.float64, device=None,
                    batch_shape=()) -> ChainMid:
    """A structurally-absent mid marginal (valid=False)."""
    S = 2 * D + nb
    b = tuple(batch_shape)
    z = lambda *s: torch.zeros(b + s, dtype=dtype, device=device)
    return ChainMid(H=z(S, S), g0=z(S), c0=z(),
                    k=torch.zeros(b, dtype=torch.int64, device=device),
                    valid=torch.zeros(b, dtype=torch.bool, device=device),
                    p0=z(2, 3), q0=lie.quat_identity(b + (2,), dtype, device),
                    v0=z(2, 3), ba0=z(2, 3), bg0=z(2, 3), pb0=z(nb))


class ChainStatic(NamedTuple):
    """Per-chain data that is constant during one solve."""

    left: torch.Tensor        # (...) int window frame id of state 0
    right: torch.Tensor       # (...) int window frame id of state n
    n_leaves: torch.Tensor    # (...) int (#states - 1), >= 1
    active: torch.Tensor      # (...) bool
    pre: Preintegrated        # (..., CAP, ...) per-leaf preintegrations
    pre_valid: torch.Tensor   # (..., CAP) bool
    rows: ChainRows
    mid: ChainMid             # frozen mid-chain marginal (valid=False if none)


def _gather_seq(win: WindowState, hid: ChainHidden, st: ChainStatic,
                cap: int):
    """Chain state sequences of length cap+1: position 0 = window frame
    ``left``, positions 1..cap-1 = hidden, position n = window frame
    ``right`` (written at the per-chain index n)."""
    pos = torch.arange(cap + 1, device=st.n_leaves.device)
    at_n = (pos == st.n_leaves[..., None])[..., None]

    def seq(w_arr, h_arr):
        s = torch.cat([take_rows(w_arr, st.left)[..., None, :], h_arr,
                       h_arr[..., -1:, :]], dim=-2)
        return torch.where(at_n, take_rows(w_arr, st.right)[..., None, :], s)
    return (seq(win.p, hid.p), seq(win.q, hid.q), seq(win.v, hid.v),
            seq(win.ba, hid.ba), seq(win.bg, hid.bg))


def _gnss_res(t, row, R_e):
    """Compact per-row tangent t = [dp(3), dv(3), dclk(1), dN(1)]."""
    r, p, v, clk, N = row
    x_e = _ecef_local(p + t[0:3], R_e)
    rho = _rho_reduced(x_e, r)
    r_pr = rho + clk + t[6] - r.z
    r_cp = rho + clk + t[6] - (N + t[7]) * r.wavelength - r.z
    v_e = _ecef_local(v + t[3:6], R_e)
    num = r.r0_unit * r.r0 + x_e
    e = num / (r.r0 + rho)
    rate = torch.sum(e * (v_e - r.sat_vel))
    sag = (OMGE / CLIGHT) * (
        r.sat_vel[1] * x_e[0] + r.sat_xy[1] * v_e[0]
        - r.sat_vel[0] * x_e[1] - r.sat_xy[0] * v_e[1])
    r_do = rate + sag + clk + t[6] - r.z
    res = torch.where(r.kind == 0, r_pr, torch.where(r.kind == 1, r_cp, r_do))
    return (r.weight * res)[None]


def _gnss_row_eval(hid: ChainHidden, phase_bias, rows: ChainRows, R_e,
                   gathered=None):
    """(res (..., CR, 1), jac (..., CR, 1, 8)) per row at the hidden
    linearization.  ``hid`` and ``rows`` lead with (B, nch); phase_bias is
    (B, nb).  ``gathered``: optional per-row (p, v, clk, N), pre-gathered
    by the caller."""
    if gathered is None:
        s = (rows.state_idx - 1)[..., None]               # hidden slot
        p = torch.gather(hid.p, -2, s.expand(s.shape[:-1] + (3,)))
        v = torch.gather(hid.v, -2, s.expand(s.shape[:-1] + (3,)))
        clk = torch.gather(hid.clk, -2, s.expand(s.shape[:-1] + (NCLK,)))
        clk = clk.gather(-1, rows.clk_slot[..., None])[..., 0]
        N = take_rows(phase_bias, rows.pb_slot)
        gathered = (p, v, clk, N)
    return rowwise_res_jac(_gnss_res, 8, (rows,) + tuple(gathered),
                           rows.state_idx.dim(), (R_e,))


def _epoch_unaries(hid: ChainHidden, phase_bias, rows: ChainRows, R_e,
                   cap: int, dn: int):
    """Per-hidden-state GNSS information with clocks eliminated.

    Returns:
      H_u:  (..., cap-1, D+dn, D+dn) unary information over [state15 | N]
      g_u:  (..., cap-1, D+dn) gradient (Jᵀr convention)
      clk_aux: (w_c, cols, g_c) for clock back-substitution —
        w_c (..., cap-1, NCLK) inverse clock diagonals, cols
        (..., cap-1, D+dn, NCLK) cross blocks, g_c (..., cap-1, NCLK)
      cost: (...) ½Σr²
    """
    m = cap - 1
    S = D + NCLK + dn
    dtype = hid.p.dtype
    # one-hot placements double as the state gather
    si = torch.clamp(rows.state_idx - 1, 0, m - 1)
    O_s = one_hot(si, m, dtype)                                # (..,CR,m)
    O_n = one_hot(rows.pb_slot, dn, dtype)                     # (..,CR,dn)
    O_sc = one_hot(si * NCLK + rows.clk_slot, m * NCLK, dtype)  # (..,CR,13m)
    gathered = (O_s @ hid.p, O_s @ hid.v,
                (O_sc @ hid.clk.flatten(-2)[..., None])[..., 0],
                (O_n @ phase_bias[:, None, :, None])[..., 0])
    res, jac = _gnss_row_eval(hid, phase_bias, rows, R_e, gathered)
    vm = rows.valid.to(dtype)
    res = res * vm[..., None]
    jac = jac * vm[..., None, None]

    # per-row compact tangent is [dp(3), dv(3), dclk(1), dN(1)]; the state
    # part always lands at slots [0:3, 6:9] of the 15-dim block — only
    # (state, clk_slot, pb_slot) vary: one-hot segment sums + static
    # placement
    J = jac[..., 0, :]                             # (..., CR, 8)
    r = res[..., 0]                                # (..., CR)
    Js = J[..., 0:6]                               # dp, dv
    Jc = J[..., 6]                                 # clk
    Jn = J[..., 7]                                 # N
    O_sn = (O_s[..., :, None] * O_n[..., None, :]).flatten(-2)

    ein = torch.einsum
    Hss = ein("...bs,...bi,...bj->...sij", O_s, Js, Js)        # (m,6,6)
    Hsc = ein("...bk,...bi->...ki", O_sc * Jc[..., None], Js) \
        .unflatten(-2, (m, NCLK))                              # (m,13,6)
    Hsn = ein("...bk,...bi->...ki", O_sn * Jn[..., None], Js) \
        .unflatten(-2, (m, dn))                                # (m,dn,6)
    Hcc = (O_sc * (Jc * Jc)[..., None]).sum(-2).unflatten(-1, (m, NCLK))
    Hnn = (O_sn * (Jn * Jn)[..., None]).sum(-2).unflatten(-1, (m, dn))
    Hcn = ein("...bk,...bp->...kp", O_sc * (Jc * Jn)[..., None], O_n) \
        .unflatten(-2, (m, NCLK))                              # (m,13,dn)
    gs = ein("...bs,...bi->...si", O_s * r[..., None], Js)     # (m,6)
    gc = (O_sc * (Jc * r)[..., None]).sum(-2).unflatten(-1, (m, NCLK))
    gn = (O_sn * (Jn * r)[..., None]).sum(-2).unflatten(-1, (m, dn))

    dev = hid.p.device
    # [0, 1, 2, 6, 7, 8], made on the device (a host list would be a
    # synchronizing copy every evaluation)
    sidx = torch.cat([torch.arange(3, device=dev),
                      torch.arange(6, 9, device=dev)])
    ckd = D + torch.arange(NCLK, device=dev)
    nnd = D + NCLK + torch.arange(dn, device=dev)
    H = torch.zeros(Hss.shape[:-2] + (S, S), dtype=dtype, device=dev)
    H[..., sidx[:, None], sidx[None, :]] = Hss
    H[..., sidx[:, None], ckd[None, :]] = Hsc.transpose(-1, -2)
    H[..., ckd[:, None], sidx[None, :]] = Hsc
    H[..., sidx[:, None], nnd[None, :]] = Hsn.transpose(-1, -2)
    H[..., nnd[:, None], sidx[None, :]] = Hsn
    H[..., ckd, ckd] = Hcc
    H[..., ckd[:, None], nnd[None, :]] = Hcn
    H[..., nnd[:, None], ckd[None, :]] = Hcn.transpose(-1, -2)
    H[..., nnd, nnd] = Hnn
    g = torch.zeros(gs.shape[:-1] + (S,), dtype=dtype, device=dev)
    g[..., sidx] = gs
    g[..., ckd] = gc
    g[..., nnd] = gn
    cost = 0.5 * torch.sum(res * res, dim=(-2, -1))

    # eliminate the NCLK clock slots (diagonal block: every row touches
    # exactly one clock slot)
    sn = torch.cat([torch.arange(D, device=dev),
                    torch.arange(D + NCLK, S, device=dev)])
    d_c = H[..., ckd, ckd]                                     # (m, NCLK)
    w_c = torch.where(d_c > 1e-12, 1.0 / torch.clamp_min(d_c, 1e-12), 0.0)
    cols = H[..., sn[:, None], ckd[None, :]]                   # (m,S',13)
    g_c = g[..., D:D + NCLK]
    H_u = (H[..., sn[:, None], sn[None, :]]
           - ein("...sik,...sk,...sjk->...sij", cols, w_c, cols))
    g_u = g[..., sn] - ein("...sik,...sk->...si", cols, w_c * g_c)
    return H_u, g_u, (w_c, cols, g_c), cost


def _imu_pair_blocks(seq, st: ChainStatic, pbg, g_world, cap: int, W=None):
    """Whitened-IMU H blocks per leaf + gradient + cost (leaves masked by
    pre_valid & k < n_leaves & active).

    ``W``: optional precomputed (..., cap, 15, 15) sqrt-information — the
    covariance is constant during a solve, so callers hoist it."""
    seq_p, seq_q, seq_v, seq_ba, seq_bg = seq
    if W is None:
        W = sqrt_info_of_cov(st.pre.covariance)
    i, j = slice(0, cap), slice(1, cap + 1)
    res, jac = _single_imu(
        st.pre, seq_p[..., i, :], seq_q[..., i, :], seq_v[..., i, :],
        seq_ba[..., i, :], seq_bg[..., i, :], seq_p[..., j, :],
        seq_q[..., j, :], seq_v[..., j, :], seq_ba[..., j, :],
        seq_bg[..., j, :], pbg, g_world, W)       # (..,cap,15) (..,cap,15,30)
    ks = torch.arange(cap, device=res.device)
    valid = (st.pre_valid & (ks < st.n_leaves[..., None])
             & st.active[..., None])
    vm = valid.to(res.dtype)
    res = res * vm[..., None]
    jac = jac * vm[..., None, None]
    Hf = jac.transpose(-1, -2) @ jac                # (..., cap, 30, 30)
    gf = (jac.transpose(-1, -2) @ res[..., None])[..., 0]
    cost = 0.5 * torch.sum(res * res, dim=(-2, -1))
    return (Hf[..., :D, :D], Hf[..., :D, D:], Hf[..., D:, D:],
            gf[..., :D], gf[..., D:], cost)


def chain_leaves(win: WindowState, hid: ChainHidden, st: ChainStatic,
                 R_e, pbg, g_world, cap: int, dn: int, imu_W=None):
    """Build the ChainTailElem leaves (..., cap, ...) of every chain at the
    current linearization.  Returns (leaves, clk_aux, cost (B, nch)).

    b-convention: leaves carry b = −g (minimizer of ½xᵀHx − bᵀx).
    """
    seq = _gather_seq(win, hid, st, cap)
    Hii, Hij, Hjj, gi, gj, cost_imu = _imu_pair_blocks(
        seq, st, pbg, g_world, cap, imu_W)
    H_u, g_u, clk_aux, cost_gnss = _epoch_unaries(
        hid, win.phase_bias, st.rows, R_e, cap, dn)
    am = st.active.to(H_u.dtype)
    H_u = H_u * am[..., None, None, None]
    g_u = g_u * am[..., None, None]
    # pad unaries to cap (state cap has none; the right endpoint's unary is
    # structurally zero because rows are masked to state_idx <= n_leaves-1)
    H_up = torch.cat([H_u, torch.zeros_like(H_u[..., :1, :, :])], dim=-3)
    g_up = torch.cat([g_u, torch.zeros_like(g_u[..., :1, :])], dim=-2)
    # fold state k+1's unary into leaf k's j-side
    leaves = ChainTailElem(
        Hii=Hii,
        Hij=Hij,
        Hjj=Hjj + H_up[..., :D, :D],
        HiN=torch.zeros(Hii.shape[:-1] + (dn,), dtype=Hii.dtype,
                        device=Hii.device),
        HjN=H_up[..., :D, D:],
        HNN=H_up[..., D:, D:],
        bi=-gi,
        bj=-(gj + g_up[..., :D]),
        bN=-g_up[..., D:],
    )
    leaves, cost_mid = _apply_mid(leaves, seq, win.phase_bias, st, cap)
    return leaves, clk_aux, (cost_imu + cost_gnss) * am + cost_mid


def _apply_mid(leaves: ChainTailElem, seq, phase_bias, st: ChainStatic,
               cap: int):
    """Fold the frozen mid-chain marginal into its gap leaf, first-order
    updated to the current states."""
    mid = st.mid
    ks = torch.stack([mid.k, mid.k + 1], dim=-1)           # (..., 2)

    def at_k(s):
        return torch.gather(s, -2, ks[..., None].expand(
            ks.shape + s.shape[-1:]))

    seq_p, seq_q, seq_v, seq_ba, seq_bg = (at_k(s) for s in seq)
    dx2 = torch.cat([
        seq_p - mid.p0,
        lie.quat_boxminus(seq_q, mid.q0),
        seq_v - mid.v0,
        seq_ba - mid.ba0,
        seq_bg - mid.bg0,
    ], dim=-1)                                    # (..., 2, D)
    dx = torch.cat([dx2.flatten(-2), phase_bias[:, None, :] - mid.pb0],
                   dim=-1)
    mv = (mid.valid & st.active).to(leaves.Hii.dtype)
    Hm = mid.H * mv[..., None, None]
    Hdx = (mid.H @ dx[..., None])[..., 0]
    g = (mid.g0 + Hdx) * mv[..., None]
    cost = (mid.c0 + torch.sum(mid.g0 * dx, -1)
            + 0.5 * torch.sum(dx * Hdx, -1)) * mv
    ok = one_hot(mid.k, cap, Hm.dtype)            # (..., cap) gap leaf

    def put(x, blk):
        ev = x.dim() - ok.dim()
        return x + ok.reshape(ok.shape + (1,) * ev) * blk.unsqueeze(-ev - 1)

    leaves = ChainTailElem(
        Hii=put(leaves.Hii, Hm[..., :D, :D]),
        Hij=put(leaves.Hij, Hm[..., :D, D:2 * D]),
        Hjj=put(leaves.Hjj, Hm[..., D:2 * D, D:2 * D]),
        HiN=put(leaves.HiN, Hm[..., :D, 2 * D:]),
        HjN=put(leaves.HjN, Hm[..., D:2 * D, 2 * D:]),
        HNN=put(leaves.HNN, Hm[..., 2 * D:, 2 * D:]),
        bi=put(leaves.bi, -g[..., :D]),
        bj=put(leaves.bj, -g[..., D:2 * D]),
        bN=put(leaves.bN, -g[..., 2 * D:]),
    )
    return leaves, cost


def chain_imu_whitening(sts: ChainStatic):
    """Per-leaf IMU sqrt-information of all chains — a per-solve constant
    (covariances do not move during iterations)."""
    return sqrt_info_of_cov(sts.pre.covariance)


def chain_contrib(win: WindowState, hids: ChainHidden, sts: ChainStatic,
                  lay, R_e, pbg, g_world, cap: int, want_aux: bool = False,
                  imu_W=None):
    """Condensed contribution of ALL chains (leading dims (B, NCH)).

    Returns (H_blocks (B, NCH, 30+dn, 30+dn), g_blocks (B, NCH, 30+dn),
    gidx (B, NCH, 30+dn), cost (B,)).

    ``want_aux=True`` additionally returns the per-chain linearization
    ((prefixes, leaves), clock elimination data) so the retraction of a
    step from the SAME state can back-substitute without rebuilding it.
    """
    dn = lay.nb
    if imu_W is None:
        imu_W = chain_imu_whitening(sts)
    leaves, clk_aux, cost = chain_leaves(win, hids, sts, R_e, pbg, g_world,
                                         cap, dn, imu_W)
    if want_aux:
        # one forward scan: the prefix at n-1 is the condensation; the
        # prefixes plus the raw leaves feed the affine backward recurrence
        F = scan_chain_tail_prefix(leaves, axis=sts.n_leaves.dim())
        c = condensed_from_prefix(F, sts.n_leaves)
    else:
        F = None
        c = condense_chain_tail(leaves, sts.n_leaves)
    am = sts.active.to(c.Hii.dtype)[..., None, None]
    tr = lambda x: x.transpose(-1, -2)
    Hb = torch.cat([
        torch.cat([c.Hii, c.Hij, c.HiN], dim=-1),
        torch.cat([tr(c.Hij), c.Hjj, c.HjN], dim=-1),
        torch.cat([tr(c.HiN), tr(c.HjN), c.HNN], dim=-1)], dim=-2) * am
    gb = -torch.cat([c.bi, c.bj, c.bN], dim=-1) * am[..., 0]
    d_off = torch.arange(D, device=Hb.device)
    gidx = torch.cat([
        (lay.frame_off + D * sts.left)[..., None] + d_off,
        (lay.frame_off + D * sts.right)[..., None] + d_off,
        (lay.pb_off + torch.arange(dn, device=Hb.device)).expand(
            sts.left.shape + (dn,)),
    ], dim=-1)
    if want_aux:
        return Hb, gb, gidx, cost.sum(-1), ((F, leaves), clk_aux)
    return Hb, gb, gidx, cost.sum(-1)


def chain_retract_aux(hids: ChainHidden, sts: ChainStatic, dx, aux,
                      lay, cap: int) -> ChainHidden:
    """Back-substitute hidden states + clocks given the outer step
    ``dx`` (B, D), reusing the linearization ``aux`` produced by
    ``chain_contrib(want_aux=True)`` at the state the step starts from."""
    (F, leaves), (w_c, cols, g_c) = aux
    dn = lay.nb
    d_off = torch.arange(D, device=dx.device)
    dx_N = dx[..., lay.pb_off:lay.pb_off + dn][:, None, :]    # (B, 1, dn)
    dx_i = take_rows(dx, lay.frame_off + D * sts.left[..., None] + d_off)
    dx_j = take_rows(dx, lay.frame_off + D * sts.right[..., None] + d_off)
    interior = solve_chain_interior_affine(
        F, leaves, sts.n_leaves, dx_i, dx_j, dx_N, cap)   # (B,nch,cap-1,D)
    am = sts.active.to(interior.dtype)[..., None, None]
    interior = interior * am
    # clock back-substitution: dclk = −w ⊙ (g_c + colsᵀ [dx_s | dx_N])
    dx_sn = torch.cat(
        [interior, dx_N[..., None, :].expand(interior.shape[:-1] + (dn,))],
        dim=-1)
    dclk = -w_c * (g_c + torch.einsum("...sik,...si->...sk", cols,
                                      dx_sn)) * am
    return ChainHidden(
        p=hids.p + interior[..., 0:3],
        q=lie.quat_boxplus(hids.q, interior[..., 3:6]),
        v=hids.v + interior[..., 6:9],
        ba=hids.ba + interior[..., 9:12],
        bg=hids.bg + interior[..., 12:15],
        clk=hids.clk + dclk,
    )
