"""Host-side bookkeeping of condensed IMU-GNSS chains.

The estimator moves runs of GNSS frames that lie between two visual frames
out of the sliding window and into `ChainRecord`s (the reference removes
them from the outer ceres::Problem into an IMUGNSSBase cost function,
SetLastImuFactor, rvi/factor/gnss_imu_factor.cpp:109-117; chain growth on
second-new frame drops mirrors ResetImuGnssFactor/UpdateImuGnssFactor,
rvi/swf/swf.cpp:578-616,669-730).

Records hold numpy state; `chain_device_inputs` packs every record into the
fixed-capacity ChainHidden/ChainStatic trees (numpy) that the estimator
moves to its device for the window solve.  `truncate_middle` runs on the
host in float64 torch on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..core.state import NCLOCK
from ..ops import lie
from ..solver.chain_factors import (ChainHidden, ChainMid, ChainRows,
                                    ChainStatic)

# PreparedEpoch kind -> chain row kind (0 pseudorange, 1 carrier, 2 doppler)
_KIND_MAP = {0: 0, 2: 0, 1: 1, 3: 1, 4: 2}

_ROW_FIELDS = ("kind", "clk_slot", "pb_slot", "r0_unit", "r0", "sat_xy",
               "sat_vel", "z", "wavelength", "weight", "gen")


@dataclass
class ChainRecord:
    """One condensed run of GNSS epochs between window frames left/right."""

    left: int
    right: int
    # hidden interior states, one row per epoch (numpy)
    p: np.ndarray            # (n_hidden, 3)
    q: np.ndarray            # (n_hidden, 4)
    v: np.ndarray
    ba: np.ndarray
    bg: np.ndarray
    clk: np.ndarray          # (n_hidden, NCLOCK)
    pres: list               # n_hidden+1 numpy Preintegrated pytrees
    rows: dict               # flat arrays over all epochs, + "state_idx"
    # ambiguity slots this record pinned in the PhaseBiasTable at creation
    # (multiset across merges; released on chain death)
    pinned_slots: np.ndarray = field(default_factory=lambda: np.zeros(
        0, dtype=np.int64))
    # frozen mid-chain marginal(s): dicts with keys k,H,g0,c0,p0,q0,v0,ba0,
    # bg0,pb0 (gnss_middle_marginfo analogs).  At most 1 after truncation;
    # transiently 2 right after a merge of two truncated chains (the caller
    # must truncate again before the record reaches the device).
    mids: list = field(default_factory=list)

    @property
    def n_hidden(self) -> int:
        return self.p.shape[0]

    @property
    def n_leaves(self) -> int:
        return self.n_hidden + 1


def prepared_to_chain_rows(prep, state_idx: int) -> dict:
    """Convert a PreparedEpoch's rows to chain-row arrays at ``state_idx``."""
    kind = np.asarray([_KIND_MAP[int(k)] for k in prep.kind],
                      dtype=np.int32)
    n = len(kind)
    gen = (prep.gen if prep.gen is not None and len(prep.gen) == n
           else np.zeros(n, dtype=np.int64))
    return dict(
        state_idx=np.full(n, state_idx, dtype=np.int32),
        kind=kind,
        clk_slot=prep.clk_slot.astype(np.int32),
        pb_slot=prep.pb_slot.astype(np.int32),
        r0_unit=np.asarray(prep.r0_unit, dtype=np.float64).reshape(n, 3),
        r0=np.asarray(prep.r0, dtype=np.float64),
        sat_xy=np.asarray(prep.sat_xy, dtype=np.float64).reshape(n, 2),
        sat_vel=np.asarray(prep.sat_vel, dtype=np.float64).reshape(n, 3),
        z=np.asarray(prep.z, dtype=np.float64),
        wavelength=np.asarray(prep.wavelength, dtype=np.float64),
        weight=np.asarray(prep.weight, dtype=np.float64),
        gen=np.asarray(gen, dtype=np.int64),
    )


def merge_rows(parts: list[dict]) -> dict:
    keys = ("state_idx",) + _ROW_FIELDS
    if not parts:
        return {k: np.zeros((0, 3) if k in ("r0_unit", "sat_vel") else
                            ((0, 2) if k == "sat_xy" else (0,)),
                            dtype=np.float64) for k in keys}
    return {k: np.concatenate([p[k] for p in parts]) for k in keys}


def splice_records(rec_l: Optional[ChainRecord], mid_state: dict,
                   rec_r: Optional[ChainRecord], pre_l, pre_r,
                   left: int, right: int) -> ChainRecord:
    """Merge [chain(left,d) | IMU interval] + dropped frame d's state +
    [chain(d,right) | IMU interval] into chain(left,right)
    (ResetImuGnssFactor merge semantics, rvi/swf/swf.cpp:578-616).

    ``mid_state``: dict p,q,v,ba,bg,clk (1, ·) arrays for frame d.
    ``pre_l``/``pre_r``: the window preintegrations used when the
    corresponding side has no chain.  The merged record may exceed the leaf
    capacity — the caller truncates with ``truncate_middle``.
    """
    pres = (list(rec_l.pres) if rec_l is not None else [pre_l]) + \
           (list(rec_r.pres) if rec_r is not None else [pre_r])
    parts = []
    rows_parts = []
    if rec_l is not None:
        parts.append({k: getattr(rec_l, k)
                      for k in ("p", "q", "v", "ba", "bg", "clk")})
        rows_parts.append(rec_l.rows)
    parts.append(mid_state)
    off = (rec_l.n_hidden if rec_l is not None else 0) + 1
    if rec_r is not None:
        parts.append({k: getattr(rec_r, k)
                      for k in ("p", "q", "v", "ba", "bg", "clk")})
        r = dict(rec_r.rows)
        r = {**r, "state_idx": r["state_idx"] + off}
        rows_parts.append(r)
    stacked = {k: np.concatenate([np.asarray(s[k]).reshape(
        -1, np.shape(s[k])[-1]) for s in parts]) for k in
        ("p", "q", "v", "ba", "bg", "clk")}
    pins = np.concatenate(
        [(rec_l.pinned_slots if rec_l is not None else np.zeros(0, int)),
         (rec_r.pinned_slots if rec_r is not None else np.zeros(0, int))])
    # mid-chain marginals ride along; the right side's gap leaf shifts by off
    mids = list(rec_l.mids) if rec_l is not None else []
    if rec_r is not None:
        mids += [{**m, "k": m["k"] + off} for m in rec_r.mids]
    return ChainRecord(left=left, right=right, pres=pres,
                       rows=merge_rows(rows_parts), pinned_slots=pins,
                       mids=mids, **stacked)


def _boxminus15(seq, s, x0p, x0q, x0v, x0ba, x0bg):
    """15-dim tangent of chain state ``s`` relative to a linearization point
    (ordering [p, th, v, ba, bg], matching the chain leaf tangent)."""
    p, q, v, ba, bg = seq
    dth = lie.quat_boxminus(torch.from_numpy(np.asarray(q[s])),
                            torch.from_numpy(np.asarray(x0q))).numpy()
    return np.concatenate([p[s] - x0p, dth, v[s] - x0v, ba[s] - x0ba,
                           bg[s] - x0bg])


def truncate_middle(rec: ChainRecord, left_state: dict, right_state: dict,
                    phase_bias: np.ndarray, nb: int, R_e, pbg, g_world,
                    target_leaves: int,
                    bias_table=None) -> ChainRecord:
    """Marginalize middle hidden states of an over-capacity chain into a
    frozen mid-chain marginal (MiddleMargGnssFrame semantics,
    rvi/swf/swf_core.cpp:569-648: chains with more than GNSS_MAX_NUM=30
    epochs lose their middle ``n-30`` frames to a dense prior over the two
    adjacent surviving states + ambiguities, MargGNSSFrames +
    gnss_middle_marginfo; any previous mid marginal folds into the new one).

    ``left_state``/``right_state``: dicts p,q,v,ba,bg of the chain's window
    endpoint frames (needed when the marginalized span touches them).
    Returns a new record with n_leaves == target (or fewer when old gaps
    force a wider span); the gap leaf carries pres[k] = None (no IMU factor
    across the gap — sum_dt invalidation analog, swf_core.cpp:625) and the
    new mid marginal supplies the coupling.
    """
    from ..factors.inertial import _single_imu, sqrt_info_of_cov
    from ..solver.chain import condense_chain_tail, make_tail_leaves
    from ..solver.chain_factors import _epoch_unaries

    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))

    D = 15
    n = rec.n_leaves
    drop = n - target_leaves
    assert drop >= 1, "nothing to truncate"
    lo = max(1, target_leaves // 2)
    hi = lo + drop - 1
    # the span must consume every existing gap so one mid remains
    for md in rec.mids:
        lo = min(lo, md["k"] + 1)
        hi = max(hi, md["k"])
    lo, hi = max(lo, 1), min(hi, n - 1)
    assert lo <= hi

    # full chain state sequence (n+1 states)
    def full(key):
        mid_arr = getattr(rec, key)
        return np.concatenate([np.asarray(left_state[key])[None],
                               np.asarray(mid_arr),
                               np.asarray(right_state[key])[None]])

    seq = tuple(full(k) for k in ("p", "q", "v", "ba", "bg"))
    seq_p, seq_q, seq_v, seq_ba, seq_bg = seq
    phase_bias = np.asarray(phase_bias, dtype=np.float64)

    # --- blanket leaves: global leaves lo-1..hi over local states 0..L-1
    L = hi - lo + 3
    nleaf = L - 1
    Hii = np.zeros((nleaf, D, D))
    Hij = np.zeros((nleaf, D, D))
    Hjj = np.zeros((nleaf, D, D))
    bi = np.zeros((nleaf, D))
    bj = np.zeros((nleaf, D))
    for lk in range(nleaf):
        gk = lo - 1 + lk
        pr = rec.pres[gk]
        if pr is None:
            continue
        pr_t = tree_map(T, pr)
        W = sqrt_info_of_cov(pr_t.covariance)
        res, jac = _single_imu(
            pr_t, *(T(a[gk]) for a in seq), *(T(a[gk + 1]) for a in seq),
            T(pbg), T(g_world), W)
        res, jac = res.numpy(), jac.numpy()
        Hf = jac.T @ jac
        gf = jac.T @ res
        Hii[lk] = Hf[:D, :D]
        Hij[lk] = Hf[:D, D:]
        Hjj[lk] = Hf[D:, D:]
        bi[lk] = -gf[:D]
        bj[lk] = -gf[D:]

    # --- clock-eliminated GNSS unaries of the DROPPED states lo..hi
    m_drop = hi - lo + 1
    hsl = slice(lo - 1, hi)                    # hidden rows of states lo..hi
    # one window, one chain: the leading (B, nch) dims of chain_factors
    hid_drop = ChainHidden(*(T(getattr(rec, k)[hsl])[None, None] for k in
                             ("p", "q", "v", "ba", "bg", "clk")))
    rw = rec.rows
    in_span = (rw["state_idx"] >= lo) & (rw["state_idx"] <= hi)
    keep_r = in_span.copy()
    if bias_table is not None:
        slots = rw["pb_slot"].astype(int)
        is_cp = rw["kind"] == 1
        keep_r &= (~is_cp | ((rw["gen"] == bias_table.generation[slots])
                             & bias_table.active[slots]))
    sel = np.flatnonzero(keep_r)
    I = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))[None, None]
    F = lambda a: T(a)[None, None]
    rows_loc = ChainRows(
        state_idx=I(rw["state_idx"][sel] - (lo - 1)),
        kind=I(rw["kind"][sel]), clk_slot=I(rw["clk_slot"][sel]),
        pb_slot=I(rw["pb_slot"][sel]), r0_unit=F(rw["r0_unit"][sel]),
        r0=F(rw["r0"][sel]), sat_xy=F(rw["sat_xy"][sel]),
        sat_vel=F(rw["sat_vel"][sel]), z=F(rw["z"][sel]),
        wavelength=F(rw["wavelength"][sel]), weight=F(rw["weight"][sel]),
        valid=torch.ones((1, 1, len(sel)), dtype=torch.bool))
    H_u, g_u, _, _ = _epoch_unaries(hid_drop, T(phase_bias)[None], rows_loc,
                                    T(R_e), m_drop + 1, nb)
    H_u, g_u = H_u[0, 0].numpy(), g_u[0, 0].numpy()

    H_unary = np.zeros((L, D, D))
    H_uN = np.zeros((L, D, nb))
    H_NN = np.zeros((L, nb, nb))
    b_unary = np.zeros((L, D))
    b_N = np.zeros((L, nb))
    H_unary[1:L - 1] = H_u[:, :D, :D]
    H_uN[1:L - 1] = H_u[:, :D, D:]
    H_NN[1:L - 1] = H_u[:, D:, D:]
    b_unary[1:L - 1] = -g_u[:, :D]
    b_N[1:L - 1] = -g_u[:, D:]

    leaves = make_tail_leaves(
        T(Hii), T(Hij), T(Hjj), T(bi), T(bj), T(H_unary), T(H_uN), T(H_NN),
        T(b_unary), T(b_N))
    # own storage: the folds below add into single leaves in place
    leaves = tree_map(torch.clone, leaves)

    # --- fold previous mid marginals (first-order updated) into their leaf
    for md in rec.mids:
        k_loc = md["k"] - (lo - 1)
        assert 0 <= k_loc < nleaf
        dx = np.concatenate([
            _boxminus15(seq, md["k"], md["p0"][0], md["q0"][0],
                        md["v0"][0], md["ba0"][0], md["bg0"][0]),
            _boxminus15(seq, md["k"] + 1, md["p0"][1], md["q0"][1],
                        md["v0"][1], md["ba0"][1], md["bg0"][1]),
            phase_bias - md["pb0"]])
        Hm = T(md["H"])
        g = T(md["g0"]) + Hm @ T(dx)
        leaves.Hii[k_loc] += Hm[:D, :D]
        leaves.Hij[k_loc] += Hm[:D, D:2 * D]
        leaves.Hjj[k_loc] += Hm[D:2 * D, D:2 * D]
        leaves.HiN[k_loc] += Hm[:D, 2 * D:]
        leaves.HjN[k_loc] += Hm[D:2 * D, 2 * D:]
        leaves.HNN[k_loc] += Hm[2 * D:, 2 * D:]
        leaves.bi[k_loc] -= g[:D]
        leaves.bj[k_loc] -= g[D:2 * D]
        leaves.bN[k_loc] -= g[2 * D:]

    c = tree_map(lambda x: x.numpy(),
                 condense_chain_tail(leaves, torch.tensor(nleaf)))
    Hnew = np.block([
        [c.Hii, c.Hij, c.HiN],
        [c.Hij.T, c.Hjj, c.HjN],
        [c.HiN.T, c.HjN.T, c.HNN]])
    gnew = -np.concatenate([c.bi, c.bj, c.bN])
    new_mid = dict(
        k=lo - 1, H=Hnew, g0=gnew, c0=0.0,
        p0=np.stack([seq_p[lo - 1], seq_p[hi + 1]]),
        q0=np.stack([seq_q[lo - 1], seq_q[hi + 1]]),
        v0=np.stack([seq_v[lo - 1], seq_v[hi + 1]]),
        ba0=np.stack([seq_ba[lo - 1], seq_ba[hi + 1]]),
        bg0=np.stack([seq_bg[lo - 1], seq_bg[hi + 1]]),
        pb0=phase_bias.copy())

    # --- shrink the record: drop hidden rows of states lo..hi, collapse
    # leaves lo-1..hi into one gap leaf (pres=None), remap rows above
    keep_h = np.r_[np.arange(0, lo - 1), np.arange(hi, n - 1)]
    rows_keep = np.flatnonzero(~in_span)
    new_rows = {k: rw[k][rows_keep] for k in rw}
    shift = hi - lo + 1
    si = new_rows["state_idx"].copy()
    si[si > hi] -= shift
    new_rows["state_idx"] = si
    return ChainRecord(
        left=rec.left, right=rec.right,
        p=rec.p[keep_h].copy(), q=rec.q[keep_h].copy(),
        v=rec.v[keep_h].copy(), ba=rec.ba[keep_h].copy(),
        bg=rec.bg[keep_h].copy(), clk=rec.clk[keep_h].copy(),
        pres=list(rec.pres[:lo - 1]) + [None] + list(rec.pres[hi + 1:]),
        rows=new_rows, pinned_slots=rec.pinned_slots.copy(),
        mids=[new_mid])


def chain_device_inputs(records: list[ChainRecord], nch: int, cap: int,
                        crows: int, nb: int, bias_table, dummy_pre,
                        left_mask: Optional[np.ndarray] = None):
    """Pack chain records into (ChainHidden, ChainStatic) batched pytrees.

    Rows referencing a recycled ambiguity slot (allocation generation
    mismatch, or slot inactive) are masked out.  ``dummy_pre`` pads unused
    leaf slots (and gap leaves with pres[k] is None); ``left_mask``
    optionally restricts active to given lefts.  ``nb`` = phase-bias table
    capacity (the mid-marginal tail dimension).
    """
    m = cap - 1
    D = 15
    S = 2 * D + nb
    mid_H = np.zeros((nch, S, S))
    mid_g0 = np.zeros((nch, S))
    mid_c0 = np.zeros(nch)
    mid_k = np.zeros(nch, dtype=np.int32)
    mid_valid = np.zeros(nch, dtype=bool)
    mid_p0 = np.zeros((nch, 2, 3))
    mid_q0 = np.zeros((nch, 2, 4))
    mid_q0[..., 0] = 1.0
    mid_v0 = np.zeros((nch, 2, 3))
    mid_ba0 = np.zeros((nch, 2, 3))
    mid_bg0 = np.zeros((nch, 2, 3))
    mid_pb0 = np.zeros((nch, nb))

    def pad2(a, n_rows, width=None):
        a = np.asarray(a, dtype=np.float64)
        shape = (n_rows,) + a.shape[1:] if width is None else (n_rows, width)
        out = np.zeros(shape)
        k = min(len(a), n_rows)
        out[:k] = a[:k]
        return out

    hid_p = np.zeros((nch, m, 3))
    hid_q = np.zeros((nch, m, 4))
    hid_q[..., 0] = 1.0
    hid_v = np.zeros((nch, m, 3))
    hid_ba = np.zeros((nch, m, 3))
    hid_bg = np.zeros((nch, m, 3))
    hid_clk = np.zeros((nch, m, NCLOCK))
    left = np.zeros(nch, dtype=np.int32)
    right = np.ones(nch, dtype=np.int32)
    n_leaves = np.ones(nch, dtype=np.int32)
    active = np.zeros(nch, dtype=bool)
    pre_valid = np.zeros((nch, cap), dtype=bool)
    pres_all = []
    rows_np = {k: [] for k in ("state_idx",) + _ROW_FIELDS}
    rows_valid = []

    for ci in range(nch):
        if ci < len(records):
            r = records[ci]
            nh = min(r.n_hidden, m)
            hid_p[ci, :nh] = r.p[:nh]
            hid_q[ci, :nh] = r.q[:nh]
            hid_v[ci, :nh] = r.v[:nh]
            hid_ba[ci, :nh] = r.ba[:nh]
            hid_bg[ci, :nh] = r.bg[:nh]
            hid_clk[ci, :nh] = r.clk[:nh]
            left[ci] = r.left
            right[ci] = r.right
            n_leaves[ci] = min(r.n_leaves, cap)
            active[ci] = True
            if left_mask is not None and not left_mask[ci]:
                active[ci] = False
            pres = list(r.pres)[:cap]
            for k_, pr in enumerate(pres):
                pre_valid[ci, k_] = pr is not None
            pres = [pr if pr is not None else dummy_pre for pr in pres]
            pres += [dummy_pre] * (cap - len(pres))
            pres_all.append(pres)
            assert len(r.mids) <= 1, "truncate before packing"
            if r.mids:
                md = r.mids[0]
                mid_H[ci] = md["H"]
                mid_g0[ci] = md["g0"]
                mid_c0[ci] = md["c0"]
                mid_k[ci] = md["k"]
                mid_valid[ci] = True
                mid_p0[ci] = md["p0"]
                mid_q0[ci] = md["q0"]
                mid_v0[ci] = md["v0"]
                mid_ba0[ci] = md["ba0"]
                mid_bg0[ci] = md["bg0"]
                mid_pb0[ci] = md["pb0"]
            # rows: mask stale bias references
            rw = r.rows
            n = len(rw["kind"])
            keep = np.ones(n, dtype=bool)
            is_cp = rw["kind"] == 1
            slots = rw["pb_slot"].astype(int)
            cur_gen = bias_table.generation[slots] if bias_table is not None \
                else rw["gen"]
            cur_act = bias_table.active[slots] if bias_table is not None \
                else np.ones(n, dtype=bool)
            keep &= ~is_cp | ((rw["gen"] == cur_gen) & cur_act)
            keep &= rw["state_idx"] <= n_leaves[ci] - 1
            nkeep = min(int(keep.sum()), crows)
            sel = np.flatnonzero(keep)[:nkeep]
            for k in rows_np:
                arr = np.zeros((crows,) + np.shape(rw[k])[1:])
                arr[:nkeep] = rw[k][sel]
                rows_np[k].append(arr)
            rv = np.zeros(crows, dtype=bool)
            rv[:nkeep] = True
            rows_valid.append(rv)
        else:
            pres_all.append([dummy_pre] * cap)
            for k in rows_np:
                shape = {"r0_unit": (crows, 3), "sat_vel": (crows, 3),
                         "sat_xy": (crows, 2)}.get(k, (crows,))
                rows_np[k].append(np.zeros(shape))
            rows_valid.append(np.zeros(crows, dtype=bool))

    # pure numpy packing: this runs on the host once or twice per frame;
    # the estimator moves the whole tree to its device in one batched copy
    stack = lambda trees: type(trees[0])(*(np.stack(x)
                                           for x in zip(*trees)))
    pre_stack = stack([stack(pres) for pres in pres_all])

    r0 = np.stack(rows_np["r0"])
    r0 = r0 + (r0 == 0) * 2.6e7
    lam = np.stack(rows_np["wavelength"])
    lam = lam + (lam == 0)
    rows = ChainRows(
        state_idx=np.maximum(np.stack(rows_np["state_idx"]), 1)
        .astype(np.int32),
        kind=np.stack(rows_np["kind"]).astype(np.int32),
        clk_slot=np.stack(rows_np["clk_slot"]).astype(np.int32),
        pb_slot=np.stack(rows_np["pb_slot"]).astype(np.int32),
        r0_unit=np.stack(rows_np["r0_unit"]),
        r0=r0,
        sat_xy=np.stack(rows_np["sat_xy"]),
        sat_vel=np.stack(rows_np["sat_vel"]),
        z=np.stack(rows_np["z"]),
        wavelength=lam,
        weight=np.stack(rows_np["weight"]),
        valid=np.stack(rows_valid),
    )
    hid = ChainHidden(p=hid_p, q=hid_q, v=hid_v, ba=hid_ba, bg=hid_bg,
                      clk=hid_clk)
    mid = ChainMid(H=mid_H, g0=mid_g0, c0=mid_c0, k=mid_k, valid=mid_valid,
                   p0=mid_p0, q0=mid_q0, v0=mid_v0, ba0=mid_ba0,
                   bg0=mid_bg0, pb0=mid_pb0)
    st = ChainStatic(left=left, right=right, n_leaves=n_leaves,
                     active=active, pre=pre_stack,
                     pre_valid=pre_valid, rows=rows, mid=mid)
    return hid, st


def writeback_hidden(records: list[ChainRecord], hid: ChainHidden):
    """Persist optimized hidden states back into the host records."""
    p = np.asarray(hid.p)
    q = np.asarray(hid.q)
    v = np.asarray(hid.v)
    ba = np.asarray(hid.ba)
    bg = np.asarray(hid.bg)
    clk = np.asarray(hid.clk)
    for ci, r in enumerate(records):
        nh = r.n_hidden
        r.p = p[ci, :nh].copy()
        r.q = q[ci, :nh].copy()
        r.v = v[ci, :nh].copy()
        r.ba = ba[ci, :nh].copy()
        r.bg = bg[ci, :nh].copy()
        r.clk = clk[ci, :nh].copy()
