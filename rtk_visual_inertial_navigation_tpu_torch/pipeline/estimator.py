"""Sliding-window estimator driver — the MeasurementProcess state machine.

Host-side orchestration (numpy bookkeeping) around torch device stages,
mirroring the reference's per-frame loop (SWFOptimization::MeasurementProcess,
rvi/swf/swf.cpp:745-892):

    buffer IMU -> preintegrate interval -> predict new frame ->
    frontend update (features / triangulation) -> optimize (dogleg GN) ->
    outlier rejection -> keyframe decision -> marginalize -> slide.

Differences from the reference by design:
  - no incremental ceres::Problem: every solve re-evaluates all factors from
    fixed-shape masked batches (relinearize-always);
  - marginalization & prior are dense over the global tangent layout; window
    shifts are index permutations of the prior columns.

Placement of the stages.  All mutable state (window, prior,
preintegrations, features, chains) lives on the host as numpy.  The window
solves (``_solve``, ``_solve_chains``) and the marginalization assembly
(``_marg``, ``_marg_chains``) run on ``self.device`` as one window (a
leading batch dim of 1) of the port's batched factors and dogleg loop;
their inputs go over in one copy per dtype class and their results come
back in one copy.  The small per-frame stages — preintegration,
triangulation and its depth check, the all-pairs camera points, the
inverse-depth world points, PnP and the integer-fix retraction — run on the
host CPU in float64 torch (``_host_stage``): they are short sequential
scans and tiny batches that a GPU would only add launches to.  The
preintegration merges run on ``self.device``, as JAX runs them on its
default device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..config import EstimatorConfig
from ..core.state import (FRAME_DIM, NCLOCK, POSE_DIM, TangentLayout,
                          WindowState, retract_window)
from ..device import full_precision, resolve_device
from ..factors.gnss import (GnssObsBatch, doppler_batch,
                            spp_carrier_phase_batch, spp_pseudorange_batch)
from ..factors.inertial import imu_factor_batch, merge_preintegrations
from ..factors.mag import mag_factor_batch
from ..factors.priors import MargPrior
from ..factors.robust import cauchy_correct
from ..factors.visual import (invdepth_projection_batch,
                              projection_factor_batch, project_world_point)
from ..frontend.features import FeatureTable
from ..frontend.pnp import pnp_pose
from ..frontend.triangulation import triangulate_landmarks
from ..gnss.preprocess import GnssEpoch, GnssPreprocessor, PreparedEpoch
from ..ops import lie, lie_np
from ..preintegration.midpoint import Preintegrated, preintegrate
from ..solver.chain_factors import (chain_contrib, chain_imu_whitening,
                                    chain_retract_aux)
from ..solver.gauss_newton import DoglegConfig, assemble, dogleg_solve
from ..solver.marginalization import (marginalize_dense_np,
                                      masked_cov_cols, masked_schur_np,
                                      prior_from_hessian_np)
from ..solver.structured import projection_assemble
from .chains import (ChainRecord, chain_device_inputs, merge_rows,
                     prepared_to_chain_rows, splice_records,
                     truncate_middle, writeback_hidden)

def _np_tree(tree):
    """A tree of host tensors as writable numpy arrays."""
    return tree_map(lambda a: a.numpy().copy() if torch.is_tensor(a) else a,
                    tree)


def _host_stage(fn, *args):
    """Run ``fn`` on the host CPU: numpy arguments in as float64/int/bool
    CPU tensors (no copy), numpy out."""
    targs = tree_map(lambda a: torch.from_numpy(np.asarray(a))
                     if isinstance(a, np.ndarray) else a, args)
    return _np_tree(fn(*targs))


def _to_device(tree, device):
    """Host numpy tree -> tensors on ``device`` with a leading window dim
    of 1.  One copy for all floating leaves (float64) and one for all
    integer and bool leaves (int64; bools come back as bool)."""
    leaves, spec = tree_flatten(tree)
    parts = {"f": [], "i": []}
    meta = []
    for a in leaves:
        if a is None:
            meta.append(None)
            continue
        a = np.asarray(a)
        kind = "f" if a.dtype.kind == "f" else "i"
        parts[kind].append(a.astype(np.float64 if kind == "f" else np.int64,
                                    copy=False).ravel())
        meta.append((kind, a.shape, a.dtype.kind == "b"))
    bufs = {}
    for kind, ps in parts.items():
        if ps:
            bufs[kind] = iter(torch.from_numpy(np.concatenate(ps)).to(
                device).split([p.size for p in ps]))
    out = []
    for m in meta:
        if m is None:
            out.append(None)
            continue
        kind, shape, is_bool = m
        t = next(bufs[kind]).reshape((1,) + shape)
        out.append(t.bool() if is_bool else t)
    return tree_unflatten(out, spec)


def _to_host(tree):
    """Device tree of one window -> numpy, in ONE device-to-host copy: the
    leaves travel as one float64 buffer and drop their window dim."""
    leaves, spec = tree_flatten(tree)
    idx = [i for i, a in enumerate(leaves) if torch.is_tensor(a)]
    if not idx:
        return tree
    flat = torch.cat([leaves[i].reshape(-1).to(torch.float64)
                      for i in idx]).cpu().numpy()
    out = list(leaves)
    off = 0
    for i in idx:
        t = leaves[i]
        a = flat[off:off + t.numel()].reshape(tuple(t.shape[1:]))
        off += t.numel()
        if t.dtype == torch.bool:
            a = a.astype(bool)
        elif not t.is_floating_point():
            a = a.astype(np.int64)
        else:
            a = a.copy()
        out[i] = a
    return tree_unflatten(out, spec)


def _stack_pre(pre_list):
    return Preintegrated(*(np.stack(x) for x in zip(*pre_list)))


def _all_pair_cam_points(p, q, tic, qic, landmarks, pbg):
    """Camera-frame coords of every landmark in every frame: (NL, NF, 3)."""
    return project_world_point(p[None], q[None], tic, qic,
                               landmarks[:, None, :], pbg)


def _invdepth_to_world(p, q, tic, qic, pbg, hosts, hxy, rho):
    """World points from (host frame, unit-plane obs, inverse depth) — the
    exact inverse of project_world_point."""
    rho = torch.where(rho.abs() > 1e-6, rho, 1.0)
    pc = torch.cat([hxy, torch.ones_like(hxy[..., :1])], dim=-1) \
        / rho[..., None]
    pim = lie.quat_rotate(qic, pc) + tic - pbg
    return lie.quat_rotate(q[hosts], pim) + p[hosts]


def _all_pair_depths(p, q, tic, qic, landmarks, pbg):
    return _all_pair_cam_points(p, q, tic, qic, landmarks, pbg)[..., 2]


def _robust_visual(fb, a: float):
    """Cauchy corrector on a visual FactorBatch (a <= 0: identity).

    Returns (res~, jac~, cost_delta) — see factors/robust.py; cost_delta
    makes ½Σ|r̃|² + delta equal the true robust cost ½Σρ(s)."""
    if a <= 0:
        return fb.res, fb.jac, torch.zeros(fb.res.shape[:-2],
                                           dtype=fb.res.dtype,
                                           device=fb.res.device)
    return cauchy_correct(fb.res, fb.jac, a)


def _add_chain_blocks(H, g, Hb, gb, gidx):
    """Scatter-add the condensed chain blocks (B, NCH, S, S) at their
    global indices gidx (B, NCH, S) into H (B, D, D) and g (B, D).  On
    CUDA the sums run by atomics: f64 roundoff may differ between runs."""
    b = torch.arange(H.shape[0], device=H.device)
    H = H.index_put((b[:, None, None, None], gidx[..., :, None],
                     gidx[..., None, :]), Hb, accumulate=True)
    g = g.index_put((b[:, None, None], gidx), gb, accumulate=True)
    return H, g


class Estimator:
    """VI / GNSS-VI sliding-window estimator (every mode of the config).

    ``device``: where the window solves and the marginalization assembly
    run — ``cuda`` unless ``device="cpu"`` is passed; raises without a GPU
    (``device.resolve_device``).  The small stages run on the host CPU
    either way (module docstring).
    """

    def __init__(self, cfg: EstimatorConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        full_precision()
        self.lay = TangentLayout(nf=cfg.nf, nl=cfg.nl, nb=cfg.nb, nc=2)
        self.x = _np_tree(WindowState.zeros(cfg.nf, cfg.nl, cfg.nb))
        self.x = self.x._replace(tic=np.asarray(cfg.tic, dtype=float),
                                 qic=np.asarray(cfg.qic, dtype=float))
        self.features = FeatureTable(cfg.nl, cfg.nf)
        self._n_feat_in = 0   # cumulative ingested feature observations
        self.frame_count = 0
        self.frame_times: list[float] = []
        self.initialized = False

        # per-interval preintegrations (a list of host numpy trees)
        self.pre: list[Optional[Preintegrated]] = [None] * (cfg.nf - 1)
        self._last_interval_bad = False
        # inverse-depth host bookkeeping: timestamp of each landmark's host
        # frame (timestamps are shift-immune, unlike frame indices)
        self._host_time = np.full(cfg.nl, np.nan)

        # IMU buffering
        self._imu_t: list[float] = []
        self._imu_acc: list[np.ndarray] = []
        self._imu_gyr: list[np.ndarray] = []
        self._init_acc: list[np.ndarray] = []
        self._init_gyr: list[np.ndarray] = []

        D = self.lay.dim
        self.prior = MargPrior(J=np.zeros((D, D)), r0=np.zeros(D), x0=self.x,
                               valid_rows=np.zeros(D, dtype=bool))
        self.g_world = np.asarray([0.0, 0.0, cfg.g])
        self._pbg = np.asarray(cfg.pbg, dtype=float)

        # GNSS: frame typing, per-frame prepared epochs, preprocessor
        self.frame_is_gnss = np.zeros(cfg.nf, dtype=bool)
        self.gnss_store: list[Optional[PreparedEpoch]] = [None] * cfg.nf
        self._R_e = np.asarray(cfg.enu_to_ecef, dtype=float)
        self.gnss: Optional[GnssPreprocessor] = None
        if cfg.use_gnss:
            self.gnss = GnssPreprocessor(
                cfg.anchor_ecef, cfg.nb, use_rtk=cfg.use_rtk,
                use_rtd=cfg.use_rtd, use_spp_phase=cfg.use_spp_phase,
                use_doppler=cfg.use_doppler,
                use_spp_correction=cfg.use_spp_correction,
                initial_deweight_epochs=cfg.initial_gnss_boost_epochs)

        # magnetometer (MagProcess buffering, rvi/swf/swf_imu.cpp:219-252)
        self._mag_buf: list[tuple[float, np.ndarray]] = []
        self.frame_mag = np.zeros((cfg.nf, 3))
        self.frame_mag_valid = np.zeros(cfg.nf, dtype=bool)
        self._init_mag: list[np.ndarray] = []

        # condensed IMU-GNSS chains (IMUGNSSBase analog, SURVEY.md §2.6)
        self.chains: list[ChainRecord] = []
        self._nch = cfg.max_chains or (cfg.nf - 1)
        self._chain_stats = {"created": 0, "merged": 0, "died": 0,
                             "truncated": 0}

        # integer-fix state (swf_lambda.cpp fix bookkeeping)
        self.rtk_fixed = False
        self._fix_streak = 0
        self._nofix_streak = 0
        self._last_fix: list = []
        self._last_fix_time = -np.inf      # last accepted fix (save_result
        #                                    rtk_fix flag, visualization.cpp:254)
        self._last_lambda_t = -np.inf      # 2 s outage fix-state reset
        #                                    (swf_lambda.cpp:84-91)

        # GNSS first-fix initialization state (GnssProcess init_gnss flag,
        # rvi/swf/swf_gnss.cpp:189-258): before the first usable epoch, the
        # window lives in an arbitrary local frame; the first epoch anchors
        # it to the GNSS frame via a single-epoch SPP solve
        self._gnss_initialized = not cfg.use_gnss

        # per-IMU-sample dead-reckoning output (IMUProcess propagation +
        # save_result per sample, rvi/swf/swf_imu.cpp:179-213)
        self.writer = None
        self._dr: Optional[dict] = None
        self.mag_yaw = 0.0
        self._last_gnss_frame_t = -np.inf
        self._recent_frame_times: list[float] = []

        self._consts_dev = None
        self._cov_cols_t = None
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray, np.ndarray]] = []

    def attach_writer(self, writer):
        """Attach a ResultWriter: one CSV row per IMU sample from then on
        (the reference's save_result-per-sample protocol that evaluate.py's
        2.5 ms ground-truth association relies on)."""
        self.writer = writer

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------
    def process_imu(self, t, acc, gyr):
        self._imu_t.append(float(t))
        self._imu_acc.append(np.asarray(acc, dtype=float))
        self._imu_gyr.append(np.asarray(gyr, dtype=float))
        if not self.initialized:
            self._init_acc.append(np.asarray(acc, dtype=float))
            self._init_gyr.append(np.asarray(gyr, dtype=float))
        elif self.writer is not None:
            self._dr_step(float(t), np.asarray(acc, dtype=float),
                          np.asarray(gyr, dtype=float))

    # ------------------------------------------------------------------
    # per-IMU-sample dead reckoning + CSV output (IMUProcess semantics,
    # rvi/swf/swf_imu.cpp:179-213: midpoint propagation of the newest frame
    # state per sample, one save_result row per sample)
    # ------------------------------------------------------------------
    def _dr_step(self, t, acc, gyr):
        d = self._dr
        if d is None:
            return
        dt = t - d["t"]
        g = self.g_world           # +z gravity magnitude; world accel −g
        if 0.0 < dt < 1.0:
            un_gyr = 0.5 * (d["gyr"] + gyr) - d["bg"]
            a0 = lie_np.quat_rotate(d["q"], d["acc"] - d["ba"]) - g
            d["q"] = lie_np.quat_normalize(
                lie_np.quat_mul(d["q"], lie_np.quat_exp(un_gyr * dt)))
            a1 = lie_np.quat_rotate(d["q"], acc - d["ba"]) - g
            a = 0.5 * (a0 + a1)
            d["p"] = d["p"] + d["v"] * dt + 0.5 * a * dt * dt
            d["v"] = d["v"] + a * dt
        d["t"], d["acc"], d["gyr"] = t, acc, gyr
        fc = self.frame_count
        # "a GNSS frame is among the newest 3" (visualization.cpp:250-252);
        # with chain condensation GNSS frames leave the window, so the
        # creation-time equivalent is used: the last GNSS frame was created
        # no earlier than the 3rd-newest frame
        rt = self._recent_frame_times
        havegps = (bool(self.frame_is_gnss[max(0, fc - 3):fc].any())
                   or (len(rt) >= 3 and self._last_gnss_frame_t >= rt[-3]))
        # acc_w written without bias subtraction, matching save_result
        # (visualization.cpp:244: InitRwgwᵀ(Rs·acc_0) − G)
        acc_w = lie_np.quat_rotate(d["q"], acc) - g
        self.writer.write(
            t, d["p"], d["q"], d["v"], d["ba"], d["bg"], acc_w=acc_w,
            rtk_fix=int(abs(t - self._last_fix_time) < 0.2),
            mag_yaw=self.mag_yaw, havegps=int(havegps), pbg=self._pbg)

    def _dr_rebase(self, t):
        """Re-base the dead-reckoning mirror on the newest solved frame."""
        if self.writer is None:
            return
        i = self.frame_count - 1
        acc = self._imu_acc[-1] if self._imu_acc else np.zeros(3)
        gyr = self._imu_gyr[-1] if self._imu_gyr else np.zeros(3)
        self._dr = dict(
            t=float(t), p=np.array(self.x.p[i]), q=np.array(self.x.q[i]),
            v=np.array(self.x.v[i]), ba=np.array(self.x.ba[i]),
            bg=np.array(self.x.bg[i]), acc=np.asarray(acc),
            gyr=np.asarray(gyr))

    def process_mag(self, t, mag):
        """Buffer magnetometer samples (nearest-to-frame selection,
        MagProcess semantics; 10 s retention)."""
        self._mag_buf.append((float(t), np.asarray(mag, dtype=float)))
        self._mag_buf = [(tt, mm) for tt, mm in self._mag_buf
                         if t - tt <= 10.0]
        if not self.initialized:
            self._init_mag.append(np.asarray(mag, dtype=float))

    def _select_mag(self, fidx: int, t: float):
        if not self._mag_buf:
            return
        tt, mm = min(self._mag_buf, key=lambda x: abs(x[0] - t))
        if abs(tt - t) < 0.5:
            self.frame_mag[fidx] = mm
            self.frame_mag_valid[fidx] = True
            self._update_mag_yaw(fidx, mm)

    def _update_mag_yaw(self, fidx: int, mag: np.ndarray):
        """TRIAD yaw from (estimated gravity direction, magnetometer): the
        reference's per-frame mag_yaw telemetry (MagProcess,
        rvi/swf/swf_imu.cpp:244-251)."""
        R = lie_np.quat_to_rot(np.asarray(self.x.q[fidx]))
        z0 = R.T @ np.array([0.0, 0.0, 1.0])
        x0 = np.cross(np.asarray(mag) + np.asarray(self.x.mag_bias), z0)
        nx = np.linalg.norm(x0)
        if nx < 1e-9:
            return
        x0 /= nx
        y0 = np.cross(z0, x0)
        y0 /= max(np.linalg.norm(y0), 1e-12)
        Rwb0 = np.stack([x0, y0, z0])
        self.mag_yaw = float(np.rad2deg(np.arctan2(Rwb0[1, 0], Rwb0[0, 0])))

    def process_image(self, t, ids, xys, ids_r=None, xys_r=None):
        """One camera frame with tracked features (id, unit-plane xy).
        ``ids_r``/``xys_r``: optional right-camera (stereo) observations."""
        if not self.initialized:
            if len(self._init_acc) < self.cfg.average_imu:
                return
            self._initialize(t)
        else:
            self._add_frame(t)
        fidx = self.frame_count - 1
        self._select_mag(fidx, t)
        self._n_feat_in += len(ids)
        self.features.add_frame(fidx, np.asarray(ids), np.asarray(xys),
                                ids_r, xys_r)
        if self._last_interval_bad:
            # IMU dead-reckoning unusable (overlong interval): bootstrap the
            # frame pose from 2D-3D matches instead (initFramePoseByPnP
            # role, rvi/feature/feature_manager.cpp:164-243)
            self._pnp_bootstrap(fidx)
        self._triangulate_new()
        if self.frame_count >= 3:
            self._optimize()
            self._reject_outliers()
            self._sync_prior_with_features()
        self._record(t)
        self._maybe_slide()

    def process_gnss(self, ep: GnssEpoch):
        """One GNSS epoch as a first-class frame (InputGnss/GnssProcess
        semantics, rvi/swf/swf_gnss.cpp:8-19,175-262; epoch gating at
        swf.cpp:732-742)."""
        if not self.initialized or self.gnss is None:
            return
        prep = self.gnss.prepare(ep)
        if prep.n_usable < self.cfg.min_sats_per_epoch:
            return
        self._add_frame(ep.t)
        fidx = self.frame_count - 1
        self._select_mag(fidx, ep.t)
        self.frame_is_gnss[fidx] = True
        self.gnss_store[fidx] = prep
        self._last_gnss_frame_t = float(ep.t)
        if not self._gnss_initialized:
            self._gnss_first_fix(fidx, prep)
            self._gnss_initialized = True
        self._detect_cycle_slips(fidx, prep)
        self._init_new_biases(fidx, prep)
        if self.frame_count >= 3:
            self._optimize()
            if self.cfg.use_rtk and self.cfg.use_n_resolve:
                self._integer_solve(fidx)
            self._sync_prior_with_features()
        self._record(ep.t)
        self._maybe_slide()

    def _maybe_slide(self):
        if self.cfg.use_gnss_chains:
            # condense completed interior GNSS runs into chains as soon as a
            # visual frame bounds them on the right (the reference forms
            # IMUGNSS factors whenever GNSS frames lie between consecutive
            # image frames, UpdateImuGnssFactor, rvi/swf/swf.cpp:713,
            # 669-730); this also restores visual-pair adjacency so the
            # keyframe decision below works with GNSS interleaved
            self._condense_gnss_runs(min_len=1)
        if self.frame_count < self.cfg.nf:
            return
        fidx = self.frame_count - 1
        # drop-second-newest only when both newest frames are visual and the
        # parallax test says non-keyframe; otherwise marginalize the oldest
        # (the reference's GNSS frames always leave by marginalization /
        # chain condensation, swf.cpp:535-651)
        both_visual = (not self.frame_is_gnss[fidx]
                       and not self.frame_is_gnss[fidx - 1])
        if both_visual and not self.features.keyframe_decision(fidx):
            self._drop_second_newest()
        else:
            self._marginalize_oldest()
        self._sync_prior_with_features()

    # ------------------------------------------------------------------
    # IMU-GNSS chain condensation (IMUGNSSBase analog, SURVEY.md §2.6/§5.7)
    # ------------------------------------------------------------------
    def _condense_gnss_runs(self, min_len: int = 2) -> bool:
        """Condense maximal runs of GNSS frames that lie strictly between
        two visual frames into ChainRecords, freeing their window slots."""
        did = False
        while True:
            run = self._find_interior_gnss_run(min_len)
            if run is None:
                return did
            self._condense_run(*run)
            did = True

    def _find_interior_gnss_run(self, min_len: int):
        fc = self.frame_count
        g = self.frame_is_gnss
        i = 1
        while i < fc - 1:
            if g[i] and not g[i - 1]:
                j = i
                while j + 1 < fc and g[j + 1]:
                    j += 1
                ok = (j < fc - 1 and not g[j + 1]
                      and (j - i + 1) >= min_len
                      and len(self.chains) < self._nch
                      and all(self.pre[k] is not None for k in range(i - 1,
                                                                     j + 1)))
                if ok:
                    return (i, j)
                i = j + 2
            else:
                i += 1
        return None

    def _condense_run(self, i: int, j: int):
        """Move GNSS frames i..j (bounded by visual frames i-1, j+1) out of
        the window into a ChainRecord."""
        a, b = i - 1, j + 1
        n_rm = j - i + 1
        sl = slice(i, j + 1)
        row_parts = []
        for f in range(i, j + 1):
            prep = self.gnss_store[f]
            if prep is not None and len(prep.kind):
                row_parts.append(prepared_to_chain_rows(prep, f - i + 1))
        rows = merge_rows(row_parts)
        pins = rows["pb_slot"][rows["kind"] == 1]
        if self.gnss is not None and len(pins):
            self.gnss.bias.pin(pins)
        rec = ChainRecord(
            left=a, right=b,
            p=np.array(self.x.p[sl]), q=np.array(self.x.q[sl]),
            v=np.array(self.x.v[sl]), ba=np.array(self.x.ba[sl]),
            bg=np.array(self.x.bg[sl]), clk=np.array(self.x.clk[sl]),
            pres=[self.pre[k] for k in range(a, b)],
            rows=rows, pinned_slots=np.asarray(pins, dtype=np.int64))
        if rec.n_leaves > self.cfg.chain_cap:
            rec = self._truncate_chain(rec)
            self._chain_stats["truncated"] = \
                self._chain_stats.get("truncated", 0) + 1
        # interval a now spans a -> b and is covered by the chain
        self.pre = (self.pre[:a] + [None]
                    + self.pre[b:self.cfg.nf - 1] + [None] * n_rm)
        self.chains.append(rec)     # its left/right adjust with the shifts
        self._chain_stats["created"] += 1
        for _ in range(n_rm):
            self.features.remove_frame(i, self.cfg.nf - 1)
            self._shift_prior_cols(i)
            self._shift_state_only(i)

    def _chain_inputs(self, left_mask=None):
        return chain_device_inputs(
            self.chains, self._nch, self.cfg.chain_cap,
            self.cfg.max_chain_rows, self.cfg.nb,
            self.gnss.bias if self.gnss is not None else None,
            self._dummy_pre(), left_mask)

    def _frame_state(self, f: int) -> dict:
        return dict(p=np.array(self.x.p[f]), q=np.array(self.x.q[f]),
                    v=np.array(self.x.v[f]), ba=np.array(self.x.ba[f]),
                    bg=np.array(self.x.bg[f]))

    def _truncate_chain(self, rec: ChainRecord) -> ChainRecord:
        """Mid-chain marginalization of an over-capacity chain
        (MiddleMargGnssFrame analog, rvi/swf/swf_core.cpp:569-648)."""
        return truncate_middle(
            rec, self._frame_state(rec.left), self._frame_state(rec.right),
            np.asarray(self.x.phase_bias), self.cfg.nb,
            np.asarray(self._R_e), np.asarray(self._pbg),
            np.asarray(self.g_world), self.cfg.chain_cap,
            self.gnss.bias if self.gnss is not None else None)

    def _rho_at(self, fidx: int, prep: PreparedEpoch, rows: np.ndarray):
        """Reduced range Δρ + local Sagnac at the predicted state (host)."""
        from ..geodesy.earth import CLIGHT, OMGE
        x_e = np.asarray(self.cfg.enu_to_ecef) @ np.asarray(self.x.p[fidx])
        proj = prep.r0_unit[rows] @ x_e
        t_ = 2.0 * proj + (x_e @ x_e) / prep.r0[rows]
        delta = t_ / (1.0 + np.sqrt(np.maximum(1.0 + t_ / prep.r0[rows],
                                               1e-12)))
        sag = OMGE * (prep.sat_xy[rows, 0] * x_e[1]
                      - prep.sat_xy[rows, 1] * x_e[0]) / CLIGHT
        return delta + sag

    def _detect_cycle_slips(self, fidx: int, prep: PreparedEpoch):
        """Median-residual cycle-slip / outlier test per (sys,freq) cohort
        (rvi/swf/swf_gnss.cpp:333-430): carrier-phase residuals at the
        predicted state, deviation beyond λ/2 (RTK) or λ (SPP) from the
        cohort median -> allocate a fresh bias slot."""
        if self.frame_count < 3 or self.gnss is None:
            return
        clk = np.asarray(self.x.clk[fidx])
        pb = np.asarray(self.x.phase_bias)
        cp_rows = np.flatnonzero((prep.kind == 1) | (prep.kind == 3))
        cp_rows = cp_rows[~prep.new_bias[cp_rows]]
        if len(cp_rows) < 3:
            return
        rho = self._rho_at(fidx, prep, cp_rows)
        resid = (rho + clk[prep.clk_slot[cp_rows]]
                 - pb[prep.pb_slot[cp_rows]] * prep.wavelength[cp_rows]
                 - prep.z[cp_rows])
        bias_tab = self.gnss.bias
        # cohorts keyed by (kind, sys*2+freq-ish clock slot)
        cohort = prep.kind[cp_rows] * 16 + prep.clk_slot[cp_rows]
        for c in np.unique(cohort):
            sel = cohort == c
            if sel.sum() < 2:
                continue
            med = np.median(resid[sel])
            lam = prep.wavelength[cp_rows[sel]]
            is_rtk = prep.kind[cp_rows[sel][0]] == 3
            thresh = lam * (0.5 if is_rtk else 1.0)
            bad = np.abs(resid[sel] - med) > thresh
            for r in cp_rows[sel][bad]:
                old = prep.pb_slot[r]
                new = bias_tab.reallocate(int(old), self.frame_times[fidx])
                if new >= 0:
                    prep.pb_slot[r] = new
                    prep.new_bias[r] = True

    def _init_new_biases(self, fidx: int, prep: PreparedEpoch):
        """Closed-form init of freshly-allocated ambiguities so their first
        residual is ~0 (the reference runs a tiny 2-iteration solve instead,
        swf_gnss.cpp:534-575)."""
        if len(prep.kind) == 0 or not np.any(prep.new_bias):
            return
        p = np.asarray(self.x.p[fidx])
        clk = np.asarray(self.x.clk[fidx])
        x_e = np.asarray(self.cfg.enu_to_ecef) @ p
        pb = np.array(self.x.phase_bias)
        from ..geodesy.earth import CLIGHT, OMGE
        for r in np.flatnonzero(prep.new_bias):
            proj = float(prep.r0_unit[r] @ x_e)
            t_ = 2.0 * proj + float(x_e @ x_e) / prep.r0[r]
            delta = t_ / (1.0 + np.sqrt(max(1.0 + t_ / prep.r0[r], 1e-12)))
            sag = OMGE * (prep.sat_xy[r, 0] * x_e[1]
                          - prep.sat_xy[r, 1] * x_e[0]) / CLIGHT
            rho = delta + sag
            c = clk[prep.clk_slot[r]]
            # residual = ρ + clk − N·λ − z  ⇒  N = (ρ + clk − z)/λ
            pb[prep.pb_slot[r]] = (rho + c - prep.z[r]) / prep.wavelength[r]
        self.x = self.x._replace(phase_bias=pb)

    # ------------------------------------------------------------------
    # GNSS first-fix initialization (GnssProcess !init_gnss branch,
    # rvi/swf/swf_gnss.cpp:189-258): single-epoch SPP least squares at the
    # newest frame, then a rigid transform of the whole window (states +
    # landmarks) onto the GNSS solution, then a rebuilt prior with the
    # GNSS-mode bootstrap weights (InitializeSqrtInfo rover>0 branch,
    # swf_core.cpp:500-513: pos/vel nearly free, attitude ~5°).
    # ------------------------------------------------------------------
    def _gnss_first_fix(self, fidx: int, prep: PreparedEpoch):
        sol = self._single_epoch_spp(fidx, prep)
        if sol is None:
            return
        p_new, v_new, clk_new, vel_ok = sol
        dp = p_new - np.asarray(self.x.p[fidx])
        # our world frame is already ENU at the anchor with mag-derived yaw
        # (when USE_MAG_INIT_YAW), so newR·oldRᵀ = I: the reference's
        # InitializePos(Rwgw) would reproduce the bootstrap attitude
        x = self.x
        p = x.p + dp[None, :]
        lms = x.landmarks.copy()
        if not self.cfg.use_inverse_depth:
            solved = self.features.active & self.features.solved
            lms[solved] = lms[solved] + dp[None, :]
        self.features.point[self.features.active] += dp[None, :]
        v = x.v.copy()
        if vel_ok:
            v[:self.frame_count] = v_new[None, :]
        # vel_ok False: keep the VI-propagated per-frame velocities — they
        # are at least self-consistent; broadcasting the arbitrary pre-fix
        # value of frame fidx to every frame was strictly worse
        clk = x.clk.copy()
        clk[:self.frame_count] = clk_new[None, :]
        self.x = x._replace(p=p, v=v, clk=clk, landmarks=lms)
        self._build_gnss_prior()

    def _single_epoch_spp(self, fidx: int, prep: PreparedEpoch):
        """Host GN least squares on one epoch's pseudorange (+RB-SD) rows
        for position+clocks, then a linear Doppler solve for velocity+drift
        (the reference runs a 20-iteration ceres solve over the same rows,
        swf_gnss.cpp:203-215).  Returns (p_enu, v_enu, clk[13]) or None."""
        from ..geodesy.earth import CLIGHT, OMGE
        pr_rows = np.flatnonzero((prep.kind == 0) | (prep.kind == 2))
        if len(pr_rows) < 4:
            return None
        R_e = np.asarray(self._R_e)
        p = np.array(self.x.p[fidx], dtype=float)
        clk = np.zeros(NCLOCK)
        slots = np.unique(prep.clk_slot[pr_rows])
        slot_of = {int(s): k for k, s in enumerate(slots)}
        nc = len(slots)
        w = prep.weight[pr_rows]
        for _ in range(12):
            x_e = R_e @ p
            proj = prep.r0_unit[pr_rows] @ x_e
            t_ = 2.0 * proj + (x_e @ x_e) / prep.r0[pr_rows]
            delta = t_ / (1.0 + np.sqrt(np.maximum(
                1.0 + t_ / prep.r0[pr_rows], 1e-12)))
            sag = OMGE * (prep.sat_xy[pr_rows, 0] * x_e[1]
                          - prep.sat_xy[pr_rows, 1] * x_e[0]) / CLIGHT
            res = delta + sag + clk[prep.clk_slot[pr_rows]] - prep.z[pr_rows]
            J = np.zeros((len(pr_rows), 3 + nc))
            J[:, :3] = prep.r0_unit[pr_rows] @ R_e     # ∂ρ/∂p_enu ≈ êᵀR_e
            for k, r in enumerate(pr_rows):
                J[k, 3 + slot_of[int(prep.clk_slot[r])]] = 1.0
            A = (J * w[:, None]).T @ (J * w[:, None])
            b = (J * w[:, None]).T @ (w * res)
            try:
                dx = np.linalg.solve(A + 1e-9 * np.eye(A.shape[0]), b)
            except np.linalg.LinAlgError:
                return None
            p -= dx[:3]
            for k, s in enumerate(slots):
                clk[int(s)] -= dx[3 + k]
            if np.linalg.norm(dx) < 1e-4:
                break
        if not np.isfinite(p).all():
            return None
        # velocity + clock drift from Doppler (linear given the geometry).
        # vel_ok is explicit: the reference solves position+velocity
        # jointly (20 iterations, swf_gnss.cpp:203-215) so a Doppler
        # failure there fails the whole fix; here the caller must know the
        # velocity was NOT solved rather than silently inherit the
        # arbitrary pre-fix value (VERDICT r3 weak #4)
        v = np.array(self.x.v[fidx], dtype=float)
        vel_ok = False
        dp_rows = np.flatnonzero(prep.kind == 4)
        if len(dp_rows) >= 4:
            x_e = R_e @ p
            num = prep.r0_unit[dp_rows] * prep.r0[dp_rows][:, None] \
                + x_e[None, :]
            e = num / np.linalg.norm(num, axis=1)[:, None]
            sag_v = (OMGE / CLIGHT) * (
                prep.sat_vel[dp_rows, 1] * x_e[0]
                - prep.sat_vel[dp_rows, 0] * x_e[1])
            wd = prep.weight[dp_rows]
            Jv = np.zeros((len(dp_rows), 4))
            # ∂rate/∂v_enu: sag term of v is tiny — absorbed in residual
            Jv[:, :3] = e @ R_e
            Jv[:, 3] = 1.0
            z = prep.z[dp_rows] - sag_v + np.einsum(
                "ij,ij->i", e, prep.sat_vel[dp_rows])
            A = (Jv * wd[:, None]).T @ (Jv * wd[:, None])
            b = (Jv * wd[:, None]).T @ (wd * z)
            try:
                sol = np.linalg.solve(A + 1e-9 * np.eye(4), b)
                if np.isfinite(sol).all():
                    v = sol[:3]
                    clk[12] = sol[3]
                    vel_ok = True
            except np.linalg.LinAlgError:
                pass
        return p, v, clk, vel_ok

    def _build_gnss_prior(self):
        """Replace the prior with the GNSS-mode bootstrap weights
        (InitializeSqrtInfo with rover_count > 0, swf_core.cpp:500-513:
        pos/vel 1e-3 = nearly free, attitude 180/π/5 ≈ 5° std, ba 1e1,
        bg 1e2)."""
        lay = self.lay
        J = np.zeros((lay.dim, lay.dim))
        d = np.zeros(lay.dim)
        i0 = lay.pose_idx(0)
        d[i0:i0 + 3] = 1e-3
        d[i0 + 3:i0 + 6] = 180.0 / np.pi / 5.0
        s0 = lay.sb_idx(0)
        d[s0:s0 + 3] = 1e-3
        d[s0 + 3:s0 + 6] = 1e1
        d[s0 + 6:s0 + 9] = 1e2
        if self.cfg.estimate_extrinsic:
            d[lay.ext_off:lay.ext_off + POSE_DIM * 2] = 1e3
        if self.cfg.use_mag_correct_yaw:
            d[lay.mag_off:lay.mag_off + 3] = 1.0
        np.fill_diagonal(J, d)
        self.prior = MargPrior(
            J=J, r0=np.zeros(lay.dim),
            x0=self.x, valid_rows=d > 0)

    # ------------------------------------------------------------------
    # initialization (InitializePos semantics, rvi/swf/swf_imu.cpp:5-37:
    # roll/pitch from mean specific force; yaw = 0 without mag)
    # ------------------------------------------------------------------
    def _initialize(self, t):
        mean_acc = np.mean(self._init_acc, axis=0)
        mean_gyr = np.mean(self._init_gyr, axis=0)
        if self.cfg.use_mag and self._init_mag:
            # TRIAD: roll/pitch from gravity, yaw from the magnetometer
            # (InitializePos, rvi/swf/swf_imu.cpp:5-37)
            from ..factors.mag import yaw_from_mag
            mean_mag = np.mean(self._init_mag, axis=0)
            q0 = _host_stage(yaw_from_mag, mean_acc, mean_mag)
        else:
            z_b = mean_acc / np.linalg.norm(mean_acc)  # body z, in body frame
            # rotation taking body z to world z (gravity-aligned), yaw-free
            w_z = np.array([0.0, 0.0, 1.0])
            v = np.cross(z_b, w_z)
            c = float(z_b @ w_z)
            if np.linalg.norm(v) < 1e-12:
                q0 = np.array([1.0, 0, 0, 0])
            else:
                axis = v / np.linalg.norm(v)
                ang = np.arctan2(np.linalg.norm(v), c)
                q0 = lie_np.quat_exp(axis * ang)
        q = self.x.q.copy()
        bg = self.x.bg.copy()
        q[0] = q0
        bg[0] = mean_gyr
        self.x = self.x._replace(q=q, bg=bg)
        self.frame_count = 1
        self.frame_times = [float(t)]
        self._reset_imu_buffer()
        self.initialized = True
        self._build_initial_prior()

    def _reset_imu_buffer(self):
        """Keep the boundary sample so the next interval integrates from the
        frame time (acc_0/gyr_0 seeding, as IntegrationBase's acc_0 carry —
        integration_base.cpp:115-141; dropping it loses one dt of motion)."""
        if self._imu_t:
            self._imu_t = [self._imu_t[-1]]
            self._imu_acc = [self._imu_acc[-1]]
            self._imu_gyr = [self._imu_gyr[-1]]

    def _build_initial_prior(self):
        """Pin frame-0 pose/velocity/bias with the reference's bootstrap
        weights (InitializeSqrtInfo, rvi/swf/swf_core.cpp:500-513, VI branch:
        pos 2e2, att 2e2, vel 1e1, ba 1e1, bg 1e2)."""
        lay = self.lay
        J = np.zeros((lay.dim, lay.dim))
        d = np.zeros(lay.dim)
        i0 = lay.pose_idx(0)
        d[i0:i0 + 3] = 2e2          # position
        d[i0 + 3:i0 + 6] = 2e2      # attitude
        s0 = lay.sb_idx(0)
        d[s0:s0 + 3] = 1e1          # velocity
        d[s0 + 3:s0 + 6] = 1e1      # ba
        d[s0 + 6:s0 + 9] = 1e2      # bg
        if self.cfg.estimate_extrinsic:
            # extrinsic bootstrap prior, weight 1e3 (InitializeSqrtInfo
            # ESTIMATE_EXTRINSIC branch, swf_core.cpp:516-528)
            d[lay.ext_off:lay.ext_off + POSE_DIM * 2] = 1e3
        if self.cfg.use_mag_correct_yaw:
            # mag-bias prior, weight 1 (InitialFactor33 via sqrt_info_pose4,
            # swf_core.cpp:531-537) — without it the (bias, yaw) pair drifts
            d[lay.mag_off:lay.mag_off + 3] = 1.0
        np.fill_diagonal(J, d)
        self.prior = MargPrior(
            J=J, r0=np.zeros(lay.dim),
            x0=self.x, valid_rows=d > 0)

    # ------------------------------------------------------------------
    # frame insertion + IMU propagation
    # ------------------------------------------------------------------
    def _interval_arrays(self, lo: int = 0):
        """(dts, accs, gyrs, valid) from buffer[lo:lo+cap], sized to the
        samples present (at least one slot).  The JAX estimator pads to
        the capacity; a padded sample is a masked step, which changes
        nothing, so the host loop skips them."""
        cap = self.cfg.imu_capacity
        n = min(len(self._imu_t) - lo, cap)
        size = max(n, 1)
        dts = np.zeros(size)
        accs = np.zeros((size, 3))
        gyrs = np.zeros((size, 3))
        valid = np.zeros(size, dtype=bool)
        ts = np.asarray(self._imu_t[lo:lo + n])
        dts[1:n] = np.diff(ts)
        accs[:n] = np.asarray(self._imu_acc[lo:lo + n])
        gyrs[:n] = np.asarray(self._imu_gyr[lo:lo + n])
        valid[:n] = True
        return dts, accs, gyrs, valid

    def _preintegrate_buffer(self, k):
        """Preintegrate the WHOLE IMU buffer, however long.

        The buffer usually holds ≤ imu_capacity samples, but long frame gaps
        happen (the AVERAGE_IMAGE=60 driver skip leaves ~1.4 s between the
        init frame and the first processed image, rvi/main3.cpp:180;
        outages can gap arbitrarily).  Longer buffers go in chunks of
        capacity that compose in closed form (merge_preintegrations, the
        composition SlideWindowFrame uses).  Consecutive chunks share one
        sample: chunk c+1 starts at the last sample of chunk c, so the gap
        between them is integrated like any other (a chunk's first dt is
        never used, so a chunk starting one past the boundary would lose
        that interval)."""
        ba, bg = self.x.ba[k], self.x.bg[k]
        cap = self.cfg.imu_capacity
        n = len(self._imu_t)
        pre = None
        lo = 0
        while True:
            chunk = _host_stage(preintegrate, *self._interval_arrays(lo), ba,
                                bg, self.cfg.imu_noise)
            pre = chunk if pre is None else _to_host(merge_preintegrations(
                *_to_device((pre, chunk), self.device)))
            if lo + cap >= n:
                return pre
            lo += cap - 1

    def _add_frame(self, t):
        k = self.frame_count - 1       # interval index: frame k -> k+1
        pre = self._preintegrate_buffer(k)
        self.pre[k] = pre
        self._last_interval_bad = \
            float(pre.sum_dt) > 10.0 or len(self._imu_t) == 0
        # dead-reckoning prediction (IMUProcess propagation semantics)
        p, q, v = self._predict(pre, k)
        xp, xq, xv = self.x.p.copy(), self.x.q.copy(), self.x.v.copy()
        xba, xbg = self.x.ba.copy(), self.x.bg.copy()
        xp[k + 1], xq[k + 1], xv[k + 1] = p, q, v
        xba[k + 1], xbg[k + 1] = self.x.ba[k], self.x.bg[k]
        self.x = self.x._replace(p=xp, q=xq, v=xv, ba=xba, bg=xbg)
        self.frame_count += 1
        self.frame_times.append(float(t))
        self._recent_frame_times = (self._recent_frame_times + [float(t)])[-4:]
        self._reset_imu_buffer()

    def _predict(self, pre: Preintegrated, k):
        dt = float(pre.sum_dt)
        q_i = self.x.q[k]
        g = -self.g_world  # world gravity vector (z-down acceleration)
        p = (self.x.p[k] + self.x.v[k] * dt
             + 0.5 * g * dt * dt + lie_np.quat_rotate(q_i, pre.delta_p))
        v = self.x.v[k] + g * dt + lie_np.quat_rotate(q_i, pre.delta_v)
        q = lie_np.quat_normalize(lie_np.quat_mul(q_i, pre.delta_q))
        return p, q, v

    # ------------------------------------------------------------------
    # frontend
    # ------------------------------------------------------------------
    def _pnp_bootstrap(self, fidx: int):
        ft = self.features
        live = ft.active & ft.solved & ft.obs_mask[:, fidx]
        if int(live.sum()) < 6:
            return
        lms = ft.point if self.cfg.use_inverse_depth else self.x.landmarks
        p, q, ok = _host_stage(
            pnp_pose, lms, ft.obs_xy[:, fidx], live, self.x.p[fidx],
            self.x.q[fidx], self.x.tic[0], self.x.qic[0], self._pbg)
        if bool(ok):
            xp, xq = self.x.p.copy(), self.x.q.copy()
            xp[fidx], xq[fidx] = np.asarray(p), np.asarray(q)
            self.x = self.x._replace(p=xp, q=xq)

    def _triangulate_new(self):
        ft = self.features
        cand = ft.active & ~ft.solved & (ft.obs_mask.sum(axis=1) >= 2)
        if not np.any(cand):
            return
        # parallax gate: max spread of observations
        for slot in np.flatnonzero(cand):
            frames = np.flatnonzero(ft.obs_mask[slot])
            xy = ft.obs_xy[slot, frames]
            if np.linalg.norm(xy.max(0) - xy.min(0)) < \
               self.cfg.min_triangulation_parallax:
                cand[slot] = False
        if not np.any(cand):
            return
        # fixed shape: always triangulate ALL slots, mask selects real work
        in_window = (np.arange(self.cfg.nf) < self.frame_count)[None, :]
        obs_mask = ft.obs_mask & in_window & cand[:, None]
        pts, ok = _host_stage(
            triangulate_landmarks, self.x.p, self.x.q, self.x.tic[0],
            self.x.qic[0], ft.obs_xy, obs_mask, self._pbg)
        ok = ok & cand
        if not np.any(ok):
            return
        # depth sanity: positive depth in every observing frame (batched)
        depths = _host_stage(
            _all_pair_depths, self.x.p, self.x.q, self.x.tic[0],
            self.x.qic[0], pts, self._pbg)          # (NL, NF)
        bad_depth = np.any((depths < 0.3) & obs_mask, axis=1)
        good = ok & ~bad_depth
        lms = self.x.landmarks.copy()
        if self.cfg.use_inverse_depth:
            for slot in np.flatnonzero(good):
                h = ft.host_frame(slot)
                if h < 0 or depths[slot, h] < 0.3:
                    good[slot] = False
                    continue
                lms[slot, 0] = 1.0 / depths[slot, h]
                lms[slot, 1:] = 0.0
                self._host_time[slot] = self.frame_times[h]
        else:
            lms[good] = pts[good]
        ft.point[good] = pts[good]
        ft.solved[good] = True
        self.x = self.x._replace(landmarks=lms)

    def _reject_outliers(self):
        """ImagePostprocess semantics (rvi/swf/swf_image.cpp:255-308).

        Fixed-shape: reprojection depths/errors for all (slot, frame) pairs
        at once; masks pick the live observations.
        """
        ft = self.features
        thresh = self.cfg.reproj_outlier_thresh
        live = ft.obs_mask & ft.active[:, None] & ft.solved[:, None]
        if not np.any(live):
            return
        lms = ft.point if self.cfg.use_inverse_depth else self.x.landmarks
        pcs = _host_stage(
            _all_pair_cam_points, self.x.p, self.x.q, self.x.tic[0],
            self.x.qic[0], lms, self._pbg)          # (NL, NF, 3)
        xy = pcs[..., :2] / np.maximum(pcs[..., 2:], 1e-6)
        err = np.linalg.norm(xy - ft.obs_xy, axis=-1)
        bad = live & ((err > thresh) | (pcs[..., 2] < 0.1))
        ft.obs_mask[bad] = False
        ft._prune()
        # landmarks left with <2 obs can't stay solved
        weak = ft.solved & (ft.obs_mask.sum(axis=1) < 2)
        ft.solved[weak] = False

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------
    def _factor_inputs(self):
        cfg = self.cfg
        pre_stack = _stack_pre([
            self.pre[k] if self.pre[k] is not None else self._dummy_pre()
            for k in range(cfg.nf - 1)])
        # interval exists, inside the window, and not overlong
        # (IMUINTEGRATIONTIMEMAX = 10 s, rvi/parameter/parameters.h:11)
        pre_valid = np.array(
            [self.pre[k] is not None and k + 1 < self.frame_count
             and float(self.pre[k].sum_dt) < 10.0
             for k in range(cfg.nf - 1)])
        return (pre_stack, pre_valid, self._vis_inputs())

    def _vis_inputs(self):
        """Visual factor rows in the active parameterization, as one tuple
        passed through to the solve."""
        cfg = self.cfg
        fc = self.frame_count
        if cfg.use_inverse_depth:
            host, obsf, cam, slot, hxy, mxy, valid = \
                self.features.invdepth_batch(cfg.max_obs, cfg.use_stereo)
            valid = valid & (host < fc) & (obsf < fc)
            return (host, obsf, cam, slot, hxy, mxy, valid)
        f_ids, cam_ids, l_ids, xy, valid = \
            self.features.observation_batch(cfg.max_obs, cfg.use_stereo)
        valid = valid & (f_ids < fc)
        return (f_ids, cam_ids, l_ids, xy, valid)

    def _vis_batch_fn(self, pbg):
        """The visual factor family of this estimator's mode."""
        if self.cfg.use_inverse_depth:
            return lambda win, vis: invdepth_projection_batch(
                win, *vis, pbg)
        return lambda win, vis: projection_factor_batch(
            win, vis[0], vis[1], vis[2], vis[3], vis[4], pbg)

    def _gnss_factor_inputs(self):
        """Concatenate per-frame prepared epochs into three fixed-capacity
        GnssObsBatch structures (pseudorange: SPP+RTD share a residual form;
        carrier phase: SPP-CP+RTK likewise; doppler separate)."""
        cfg = self.cfg
        rows = []
        for f in range(self.frame_count):
            prep = self.gnss_store[f]
            if prep is None or len(prep.kind) == 0:
                continue
            rows.append((f, prep))

        def build(kinds, cap):
            frame_ids = np.zeros(cap, dtype=np.int32)
            clk = np.zeros(cap, dtype=np.int32)
            drift = np.full(cap, 12, dtype=np.int32)
            pbs = np.zeros(cap, dtype=np.int32)
            r0u = np.tile(np.array([1.0, 0, 0]), (cap, 1))
            r0 = np.full(cap, 2.6e7)
            sxy = np.zeros((cap, 2))
            svel = np.zeros((cap, 3))
            z = np.zeros(cap)
            lam = np.ones(cap)
            w = np.zeros(cap)
            valid = np.zeros(cap, dtype=bool)
            n = 0
            for f, prep in rows:
                sel = np.isin(prep.kind, kinds)
                k = min(int(sel.sum()), cap - n)
                if k <= 0:
                    continue
                s = np.flatnonzero(sel)[:k]
                frame_ids[n:n + k] = f
                clk[n:n + k] = prep.clk_slot[s]
                pbs[n:n + k] = prep.pb_slot[s]
                r0u[n:n + k] = prep.r0_unit[s]
                r0[n:n + k] = prep.r0[s]
                sxy[n:n + k] = prep.sat_xy[s]
                svel[n:n + k] = prep.sat_vel[s]
                z[n:n + k] = prep.z[s]
                lam[n:n + k] = prep.wavelength[s]
                w[n:n + k] = prep.weight[s]
                valid[n:n + k] = True
                n += k
            return GnssObsBatch(
                frame_ids=frame_ids, clk_slot=clk, drift_slot=drift,
                pb_slot=pbs, r0_unit=r0u, r0=r0, sat_xy=sxy, sat_vel=svel,
                z=z, wavelength=lam, weight=w, valid=valid)

        return (build((0, 2), cfg.max_gnss_pr),
                build((1, 3), cfg.max_gnss_cp),
                build((4,), cfg.max_gnss_dopp))

    def _dummy_pre(self):
        eye = np.eye(15)
        return Preintegrated(
            delta_p=np.zeros(3), delta_q=lie_np.quat_identity(),
            delta_v=np.zeros(3), jacobian=eye,
            covariance=eye * 1e-6, sum_dt=np.zeros(()),
            linearized_ba=np.zeros(3), linearized_bg=np.zeros(3),
            gyr_i=np.zeros(3), gyr_j=np.zeros(3))

    def _free_mask(self):
        lay = self.lay
        m = np.zeros(lay.dim, dtype=bool)
        fc = self.frame_count
        for f in range(fc):
            m[lay.pose_idx(f):lay.pose_idx(f) + FRAME_DIM] = True
            if self.frame_is_gnss[f]:
                m[lay.clk_idx(f):lay.clk_idx(f) + NCLOCK] = True
        act = self.features.active & self.features.solved
        lm_cols = 1 if self.cfg.use_inverse_depth else 3
        for slot in np.flatnonzero(act):
            m[lay.lm_idx(slot):lay.lm_idx(slot) + lm_cols] = True
        if self.gnss is not None:
            for slot in np.flatnonzero(self.gnss.bias.active):
                m[lay.pb_idx(slot)] = True
        if self.cfg.estimate_extrinsic:
            m[lay.ext_off:lay.ext_off + 12] = True
        if self.cfg.use_mag_correct_yaw:
            m[lay.mag_off:lay.mag_off + 3] = True
        return m

    def _mag_inputs(self):
        use = self.cfg.use_mag_correct_yaw
        valid = self.frame_mag_valid.copy()
        valid[self.frame_count:] = False
        if not use:
            valid[:] = False
        return (np.arange(self.cfg.nf, dtype=np.int32),
                self.frame_mag, valid)

    def _optimize(self):
        inputs = self._factor_inputs()
        gnss_inputs = self._gnss_factor_inputs()
        free = self._free_mask()
        # the LAMBDA tail covariance is only consumed by _integer_solve,
        # which runs on GNSS frames — image-frame solves skip it
        want_cov = (self._cov_cols_const() is not None
                    and bool(self.frame_is_gnss[self.frame_count - 1]))

        def run():
            if self.cfg.use_gnss_chains:
                hid, st = self._chain_inputs()
                dev = _to_device((self.x, hid, st, free, *inputs,
                                  *gnss_inputs, *self._mag_inputs()),
                                 self.device)
                res, X = self._solve_chains(want_cov, *dev[:2],
                                            self._prior_device(), *dev[2:])
                (win, hid2), cost, n_acc, X = _to_host(
                    (res.state, res.cost, res.n_accepted, X))
                self.x = win
                writeback_hidden(self.chains, hid2)
            else:
                dev = _to_device((self.x, free, *inputs, *gnss_inputs,
                                  *self._mag_inputs()), self.device)
                res, X = self._solve(want_cov, dev[0], self._prior_device(),
                                     *dev[1:])
                win, cost, n_acc, X = _to_host(
                    (res.state, res.cost, res.n_accepted, X))
                self.x = win
            self._last_cov_cols = X
            # the final Hessian stays on the device (integer-fix fallback)
            return res._replace(state=self.x, cost=cost, n_accepted=n_acc)

        res = run()
        c = float(np.asarray(res.cost))
        if not np.isfinite(c) or c > 1e10:
            # re-solve-on-divergence guard (the reference re-runs the solve
            # when final_cost > 1e10, rvi/swf/swf_image.cpp:220-223) — the
            # second pass starts from the first pass's accepted iterates
            res = run()
        self.last_solve = res
        self._update_world_mirror()

    def _update_world_mirror(self):
        """Keep the host-side world-point mirror in sync with the state
        (used for depth gating, outlier rejection, PnP and re-hosting)."""
        ft = self.features
        solved = ft.solved & ft.active
        if not self.cfg.use_inverse_depth:
            ft.point[solved] = self.x.landmarks[solved]
            return
        if not solved.any():
            return
        hosts = np.zeros(self.cfg.nl, dtype=np.int32)
        for s in np.flatnonzero(solved):
            hosts[s] = max(ft.host_frame(s), 0)
        hxy = ft.obs_xy[np.arange(self.cfg.nl), hosts]
        world = _host_stage(
            _invdepth_to_world, self.x.p, self.x.q, self.x.tic[0],
            self.x.qic[0], self._pbg, hosts.astype(np.int64), hxy,
            self.x.landmarks[:, 0])
        ft.point[solved] = world[solved]

    def _rehost_invdepth(self):
        """Re-host landmarks whose host frame left the window: fresh inverse
        depth in the new host camera from the world mirror, stale prior
        columns marginalized out (removeBackShiftDepth semantics,
        rvi/feature/feature_manager.cpp:362-416)."""
        if not self.cfg.use_inverse_depth:
            return
        ft, lay = self.features, self.lay
        need = []
        for slot in np.flatnonzero(ft.active & ft.solved):
            h = ft.host_frame(slot)
            if h < 0 or h >= self.frame_count:
                ft.solved[slot] = False
                self._host_time[slot] = np.nan
                continue
            if self._host_time[slot] == self.frame_times[h]:
                continue
            need.append((slot, h))
        if not need:
            return
        pcs = _host_stage(
            _all_pair_cam_points, self.x.p, self.x.q, self.x.tic[0],
            self.x.qic[0], ft.point, self._pbg)     # (NL, NF, 3)
        stale = np.zeros(lay.dim, dtype=bool)
        Jcol = np.abs(self.prior.J).sum(axis=0)
        lms = self.x.landmarks.copy()
        for slot, h in need:
            depth = pcs[slot, h, 2]
            if depth < 0.1:
                ft.solved[slot] = False
                self._host_time[slot] = np.nan
                continue
            lms[slot, 0] = 1.0 / depth
            lms[slot, 1:] = 0.0
            self._host_time[slot] = self.frame_times[h]
            c = lay.lm_idx(slot)
            if Jcol[c:c + 3].sum() > 1e-12:
                stale[c:c + 3] = True
        self.x = self.x._replace(landmarks=lms)
        if stale.any():
            self._marginalize_prior_cols(stale)

    def _marginalize_prior_cols(self, mask: np.ndarray):
        """Schur-eliminate the masked tangent columns out of the prior
        (host LAPACK; uses the stored information form — no JᵀJ matmul)."""
        p = self.prior
        if p.H0 is not None:
            H, g = np.asarray(p.H0), np.asarray(p.g0)
        else:
            Jm = np.asarray(p.J) * np.asarray(p.valid_rows,
                                              dtype=float)[:, None]
            H = Jm.T @ Jm
            g = Jm.T @ (np.asarray(p.r0)
                        * np.asarray(p.valid_rows, dtype=float))
        J0, r0, Hs, gs = marginalize_dense_np(H, g, mask, return_info=True)
        self.prior = p._replace(
            J=J0, r0=r0, valid_rows=np.ones(self.lay.dim, dtype=bool),
            H0=Hs, g0=gs, c0=np.asarray(r0 @ r0))

    def _prior_couples_landmarks(self) -> bool:
        """MyOrdering guard (rvi/swf/swf_gnss.cpp:657-679): landmark blocks
        held by the marginalization prior must NOT be eliminated in Schur
        group 0 — the prior correlates them with the kept states, so the
        landmark block of H is no longer 3x3-block-diagonal and the group-0
        elimination would silently compute a wrong step.

        The MargImagOld flow consumes every landmark observed at the
        departing frame (same invariant the reference maintains,
        swf.cpp:310-325), so this never fires in the pipeline — it is the
        defensive analog of the reference's `mark_add` exclusion set, and
        any prior that does touch landmark columns drops the solve to the
        dense path (= all landmarks leave group 0).  Host-side, once per
        prior rebuild (the prior setter caches it).
        """
        cfg = self.cfg
        if cfg.use_inverse_depth or cfg.nl == 0:
            return False     # inverse-depth mode is already dense
        n3 = 3 * cfg.nl
        J = np.asarray(self.prior.J)
        rows = np.asarray(self.prior.valid_rows, dtype=bool)
        Jl = J[rows, :n3]
        touches_lm = np.abs(Jl).max(axis=1) > 0 if Jl.size else \
            np.zeros(0, dtype=bool)
        if not touches_lm.any():
            return False
        # rows touching a landmark: coupled if they also touch anything
        # outside that landmark's own 3 columns
        Jt = J[rows][touches_lm]
        for r in Jt:
            lm_cols = np.flatnonzero(np.abs(r[:n3]) > 0)
            if len(np.unique(lm_cols // 3)) > 1 or \
                    np.abs(r[n3:]).max(initial=0.0) > 0:
                return True
        return False

    def _dogleg_cfg(self) -> DoglegConfig:
        """Solver config for the pipeline solves.

        World-point mode uses the DENSE_SCHUR group-0 fast path: the prior
        never couples landmarks (see _marginalize_oldest), so the landmark
        block is 3x3-block-diagonal by construction.  Inverse-depth mode
        stays dense (rows hosted off the marginalized frame leave prior
        coupling on surviving inverse depths).  VI-only additionally keeps
        the structurally-empty clock/phase-bias slots out of the reduced
        Cholesky.
        """
        cfg = self.cfg
        schur_nl = 0 if (cfg.use_inverse_depth or self._prior_lm_coupled) \
            else cfg.nl
        keep = ()
        if schur_nl and not cfg.use_gnss:
            keep = tuple(range(FRAME_DIM * cfg.nf + POSE_DIM * 2 + 3))
        return DoglegConfig(max_iters=cfg.max_iters,
                            initial_radius=cfg.init_trust_radius,
                            schur_nl=schur_nl, reduced_keep=keep,
                            step_dtype=cfg.solve_step_dtype,
                            f_tol=cfg.solve_f_tol)

    def _cov_cols_const(self):
        if not (self.cfg.use_rtk and self.cfg.use_n_resolve):
            return None
        return np.asarray([self.lay.pb_idx(s) for s in range(self.cfg.nb)],
                          dtype=np.int32)

    def _dev_consts(self):
        """(pbg, g_world, R_e) as float64 tensors on the device (copied
        once per estimator)."""
        if self._consts_dev is None:
            self._consts_dev = tuple(t[0] for t in _to_device(
                (self._pbg, self.g_world, self._R_e), self.device))
        return self._consts_dev

    def _cov_cols_dev(self, want_cov: bool):
        cols = self._cov_cols_const() if want_cov else None
        if cols is None:
            return None
        if self._cov_cols_t is None:
            self._cov_cols_t = _to_device(cols, self.device)
        return self._cov_cols_t

    def _solve(self, want_cov, state, prior, free, pre_stack, pre_valid, vis,
               b_pr, b_cp, b_dopp, mag_f, mag_m, mag_v):
        """Window solve on the device (all inputs carry a window dim of 1):
        dogleg over the window state, then the phase-bias covariance
        columns for LAMBDA from the final Hessian while it is still on the
        device (IntegerSolve's exported-Schur covariance, SURVEY.md §3.4).
        ``want_cov=False`` skips the covariance (image frames never run
        the integer solve)."""
        hg = self._hg_fn()
        cov_cols = self._cov_cols_dev(want_cov)
        prior_contrib = prior.precompute()

        def eval_fn(win):
            H, g, cost = hg(win, pre_stack, pre_valid, vis,
                            b_pr, b_cp, b_dopp, mag_f, mag_m, mag_v)
            Hp, gp, cp = prior_contrib(win)
            return H + Hp, g + gp, cost + cp

        res = dogleg_solve(eval_fn, retract_window, state, free,
                           self._dogleg_cfg())
        if cov_cols is None:
            return res, None
        return res, masked_cov_cols(res.H, free, cov_cols)

    def _hg_fn(self):
        """Shared (H, g, cost) evaluator over all factor families.

        World-point mode on the GPU assembles the visual rows (the dominant
        row count) through the block-structured path (solver.structured):
        one-hot segment sums + static block placement instead of a
        (B,15,15) scatter into H.  On the CPU they take the generic
        scatter-add, whose FLOPs are far fewer (the segment sums are
        O(D·nobs·D))."""
        cfg, lay = self.cfg, self.lay
        pbg, g_world, R_e = self._dev_consts()
        use_struct = (not cfg.use_inverse_depth
                      and self.device.type != "cpu")
        vis_batch = self._vis_batch_fn(pbg)

        cauchy_a = float(cfg.cauchy_loss)

        def hg(win, pre_stack, pre_valid, vis, b_pr, b_cp, b_dopp,
               mag_f, mag_m, mag_v):
            batches = [
                imu_factor_batch(win, pre_stack, pbg, g_world, pre_valid),
                spp_pseudorange_batch(win, b_pr, R_e),
                spp_carrier_phase_batch(win, b_cp, R_e),
                doppler_batch(win, b_dopp, R_e),
                mag_factor_batch(win, mag_f, mag_m, mag_v),
            ]
            if use_struct:
                f_ids, cam_ids, l_ids, xy, valid = vis
                fb = projection_factor_batch(win, f_ids, cam_ids, l_ids,
                                             xy, valid, pbg)
                vres, vjac, vdelta = _robust_visual(fb, cauchy_a)
                H, g, cost = assemble(batches, lay.dim)
                Hv, gv, cv = projection_assemble(lay, f_ids, cam_ids,
                                                 l_ids, vres, vjac)
                return H + Hv, g + gv, cost + cv + vdelta
            fb = vis_batch(win, vis)
            vres, vjac, vdelta = _robust_visual(fb, cauchy_a)
            batches.insert(1, fb._replace(res=vres, jac=vjac))
            H, g, cost = assemble(batches, lay.dim)
            return H, g, cost + vdelta

        return hg

    def _solve_chains(self, want_cov, state, hid, prior, st, free, pre_stack,
                      pre_valid, vis, b_pr, b_cp, b_dopp, mag_f, mag_m,
                      mag_v):
        """Composite solve: window state + hidden chain states.  The chain
        contribution condenses per iteration at the current hidden
        linearization (relinearize-always); the retraction back-substitutes
        hidden states given the outer step (UpdateHiddenState).

        ``want_cov=False`` skips the LAMBDA tail-covariance export (a
        FULL-dimension dense Cholesky): image frames never run the integer
        solve.
        """
        lay = self.lay
        pbg, g_world, R_e = self._dev_consts()
        cap = self.cfg.chain_cap
        hg = self._hg_fn()
        cov_cols = self._cov_cols_dev(want_cov)
        prior_contrib = prior.precompute()
        imu_W = chain_imu_whitening(st)    # per-solve constant

        def eval_fn(comp):
            win, h = comp
            H, g, cost = hg(win, pre_stack, pre_valid, vis,
                            b_pr, b_cp, b_dopp, mag_f, mag_m, mag_v)
            Hb, gb, gidx, ccost, aux = chain_contrib(
                win, h, st, lay, R_e, pbg, g_world, cap,
                want_aux=True, imu_W=imu_W)
            H, g = _add_chain_blocks(H, g, Hb, gb, gidx)
            Hp, gp, cp = prior_contrib(win)
            return H + Hp, g + gp, cost + cp + ccost, aux

        def retract_fn(comp, dx, aux):
            win, h = comp
            h2 = chain_retract_aux(h, st, dx, aux, lay, cap)
            return (retract_window(win, dx), h2)

        res = dogleg_solve(eval_fn, retract_fn, (state, hid), free,
                           self._dogleg_cfg(), has_aux=True)
        if cov_cols is None:
            return res, None
        return res, masked_cov_cols(res.H, free, cov_cols)

    def _marg_chains(self, state, hid, st, prior, pre_stack, pre_valid0,
                     vis, b_pr, b_cp, b_dopp, mag_f, mag_m, mag_v):
        """Blanket (H, g) of frame 0 with the chains attached there."""
        lay = self.lay
        pbg, g_world, R_e = self._dev_consts()
        H, g, _ = self._hg_fn()(state, pre_stack, pre_valid0, vis,
                                b_pr, b_cp, b_dopp, mag_f, mag_m, mag_v)
        Hb, gb, gidx, _ = chain_contrib(
            state, hid, st, lay, R_e, pbg, g_world, self.cfg.chain_cap)
        H, g = _add_chain_blocks(H, g, Hb, gb, gidx)
        Hp, gp, _ = prior.precompute()(state)
        return H + Hp, g + gp

    # ------------------------------------------------------------------
    # integer ambiguity resolution (IntegerSolve/LambdaSearch flow,
    # rvi/swf/swf_gnss.cpp:128-171 + swf_lambda.cpp)
    # ------------------------------------------------------------------
    def _integer_solve(self, fidx: int):
        from ..ambiguity import (SearchOverflow, choose_reference,
                                 double_difference, lambda_ils,
                                 partial_ratio_test)

        cfg, lay = self.cfg, self.lay
        prep = self.gnss_store[fidx]
        if prep is None:
            return
        # 2 s GNSS-outage fix-state reset (swf_lambda.cpp:84-91): a gap in
        # epochs invalidates fix continuity and the not-fixed counter
        t_now = self.frame_times[fidx]
        if t_now - self._last_lambda_t > 2.0:
            self._fix_streak = 0
            self._nofix_streak = 0
            self.rtk_fixed = False
        self._last_lambda_t = t_now
        # RTK carrier-phase bias slots observed at the newest epoch AND
        # admissible to the fix set: Lstd/elevation/half-cycle gates applied
        # at preprocess time (UpdateNParameterHead, swf_gnss.cpp:105-121)
        k3 = prep.kind == 3
        if prep.fixable is not None and len(prep.fixable) == len(prep.kind):
            k3 = k3 & prep.fixable.astype(bool)
        newest_slots = np.unique(prep.pb_slot[k3])
        if len(newest_slots) < 4:
            return
        bias_tab = self.gnss.bias
        b_all = np.asarray(self.x.phase_bias)

        # covariance columns of the free system at the solution for all
        # phase-bias slots (tail-block covariance of the ordered
        # elimination — SURVEY.md §2.9).  Computed on-device from the
        # solve's final Hessian (which stays there): one Cholesky + nb
        # triangular solves instead of downloading H and inverting on host.
        pb_cols_all = self._cov_cols_const()
        if getattr(self, "_last_cov_cols", None) is not None:
            X = np.asarray(self._last_cov_cols)                  # (D, nb)
        else:
            free, cols = _to_device((self._free_mask(), pb_cols_all),
                                    self.device)
            X = _to_host(masked_cov_cols(self.last_solve.H, free, cols))
        if not np.isfinite(X).all():
            self._note_no_fix()
            return
        Cov_pb = X[pb_cols_all]                                  # (nb, nb)

        # group by (sys, freq); build DD per group
        groups: dict[tuple, list[int]] = {}
        for slot in newest_slots:
            key = bias_tab.key[slot]
            if key is None or key[0] != "rtk":
                continue
            if bias_tab.continuity[slot] < cfg.min_fix_continuity:
                continue
            groups.setdefault((bias_tab.sys[slot], key[2]), []).append(slot)

        D_rows = []
        dd_slots = []  # (slot_i, slot_ref) per row
        gate = 0.2 if self._fix_streak > 0 else 1.4
        for key, slots in groups.items():
            if len(slots) < 2:
                continue
            vals = b_all[slots]
            ref_local = choose_reference(vals)
            Dg, members = double_difference(vals, ref_local, gate)
            for mrow, mi in zip(Dg, members):
                D_rows.append((slots[mi], slots[ref_local]))
        if len(D_rows) < cfg.min_dd_for_fix:
            self._note_no_fix()
            return

        n_dd = len(D_rows)
        b_float = np.asarray([b_all[i] - b_all[r] for i, r in D_rows])
        # DD covariance via the phase-bias covariance block: D has ±1 only
        # at phase-bias slots, so Qdd = D_pb Cov_pb D_pbᵀ
        D_pb = np.zeros((n_dd, cfg.nb))
        for k, (i, r) in enumerate(D_rows):
            D_pb[k, i] = 1.0
            D_pb[k, r] = -1.0
        Qdd = D_pb @ Cov_pb @ D_pb.T
        Qdd = 0.5 * (Qdd + Qdd.T)
        if not (np.isfinite(Qdd).all() and np.isfinite(b_float).all()):
            self._note_no_fix()
            return
        try:
            F, s = lambda_ils(b_float, Qdd, m=2)
        except (SearchOverflow, np.linalg.LinAlgError, ValueError):
            self._note_no_fix()
            return
        # candidate-splitting partial ratio test (swf_lambda.cpp:204-244)
        if not partial_ratio_test(b_float, Qdd, F, s,
                                  cfg.fix_ratio_threshold):
            self._note_no_fix()
            return

        # conditioned (fixed) solution over the whole free tangent:
        # dx = Cov Dᵀ (D Cov Dᵀ)⁻¹ (D b − ň); Cov Dᵀ = X D_pbᵀ since D is
        # supported on the phase-bias columns
        innov = b_float - F[0]
        K = np.linalg.solve(Qdd, innov)
        dx = X @ (D_pb.T @ K)
        self.x = _host_stage(retract_window, self.x, -dx)
        self.rtk_fixed = True
        self._fix_streak += 1
        self._nofix_streak = 0
        self._last_fix_time = t_now
        self._last_fix = [(i, r, int(n)) for (i, r), n in zip(D_rows, F[0])]

        # after enough consecutive fixes, bake FixedInteger constraints into
        # the prior — then every accepted epoch re-bakes, as the reference
        # does (fixcount keeps growing past FIX_CONTINUE_THRESHOLD,
        # swf_lambda.cpp:249-355)
        if self._fix_streak >= cfg.fix_continue_threshold:
            self._bake_fixed_integers(D_rows, F[0])

    def _note_no_fix(self):
        self.rtk_fixed = False
        self._fix_streak = 0
        self._nofix_streak += 1
        # full phase reset after too long without a fix
        # (Phase_ALL_RESET_COUNT=100, swf_gnss.cpp:395,433)
        if self._nofix_streak >= self.cfg.phase_all_reset_count:
            for slot in np.flatnonzero(self.gnss.bias.active):
                self.gnss.bias._free(slot)
            self._nofix_streak = 0

    def _bake_fixed_integers(self, D_rows, n_fixed):
        """Fold FixedInteger constraints into the prior RELATIVE to a
        per-(sys,freq) datum and re-factorize (swf_lambda.cpp:249-355).

        The reference introduces one auxiliary datum scalar ``tf`` per
        (sys,f) group, adds w·((N_ref − tf) − 0) for the group's reference
        ambiguity and w·((N_i − tf) − ň_i) for each fixed one (weight
        w = 1/0.03, gnss_factor.h:137), then marginalizes the datums out —
        which correlates the per-group rows exactly as a common-mode-free
        constraint should (an absolute per-pair encoding would overweight
        the reference satellite)."""
        lay = self.lay
        w = 1.0 / 0.03
        # one datum per reference slot (D_rows groups share their ref slot
        # per (sys,freq), FindReferenceSatellites semantics)
        groups: dict[int, list] = {}
        for (i, r), n in zip(D_rows, n_fixed):
            groups.setdefault(int(r), []).append((int(i), int(n)))
        ng = len(groups)
        dim = lay.dim
        D = dim + ng
        H = np.zeros((D, D))
        g = np.zeros(D)
        H[:dim, :dim] = self.prior.J.T @ self.prior.J
        g[:dim] = self.prior.J.T @ self.prior.r0
        x0b = self.prior.x0.phase_bias
        for k, (r, members) in enumerate(groups.items()):
            tf_col = dim + k
            for slot, n in [(r, 0)] + members:
                row = np.zeros(D)
                row[lay.pb_idx(slot)] = w
                row[tf_col] = -w
                r0v = w * (x0b[slot] - n)      # tf linearized at 0
                H += np.outer(row, row)
                g += row * r0v
        mask = np.zeros(D, dtype=bool)
        mask[dim:] = True
        H_star, g_star = masked_schur_np(H, g, mask)
        J0, r0v = prior_from_hessian_np(H_star[:dim, :dim], g_star[:dim])
        self.prior = self.prior._replace(
            J=J0, r0=r0v, valid_rows=np.ones(lay.dim, dtype=bool),
            H0=H_star[:dim, :dim], g0=g_star[:dim],
            c0=np.asarray(r0v @ r0v))

    # ------------------------------------------------------------------
    # marginalization + slide
    # ------------------------------------------------------------------
    def _sync_prior_with_features(self):
        """Marginalize dead landmark slots OUT of the prior."""
        self._rehost_invdepth()
        self._sync_prior_dead_slots()

    def _sync_prior_dead_slots(self):
        """Marginalize dead landmark slots OUT of the prior.

        A freed slot can be reused by a new feature; stale prior columns
        would then constrain the new landmark against the old linearization
        point (a huge bogus residual).  Equivalent to the reference freeing
        the per-landmark parameter block on feature death
        (FeatureManager::removeOut + problem bookkeeping).
        """
        lay = self.lay
        dead_cols = np.zeros(lay.dim, dtype=bool)
        col_norm = np.abs(self.prior.J).sum(axis=0)
        for slot in range(self.cfg.nl):
            if not self.features.active[slot]:
                c = lay.lm_idx(slot)
                if col_norm[c:c + 3].sum() > 0:
                    dead_cols[c:c + 3] = True
        # same lifecycle for phase-bias slots (slip / staleness / eviction
        # recycles them; stale prior columns would corrupt the new ambiguity)
        if self.gnss is not None:
            for slot in range(self.cfg.nb):
                if not self.gnss.bias.active[slot]:
                    c = lay.pb_idx(slot)
                    if col_norm[c] > 0:
                        dead_cols[c] = True
        if not np.any(dead_cols):
            return
        self._marginalize_prior_cols(dead_cols)

    def _marg(self, state, prior, pre_stack, pre_valid0, vis, b_pr, b_cp,
              b_dopp, mag_f, mag_m, mag_v):
        """Blanket (H, g) of frame 0 for host marginalization: prior +
        IMU(0->1) + dying-landmark projections + frame-0 GNSS + frame-0 mag
        factors.  ``pre_valid0`` masks every interval except 0; the
        GNSS/mag batches arrive with validity restricted to frame 0."""
        H, g, _ = self._hg_fn()(state, pre_stack, pre_valid0, vis,
                                b_pr, b_cp, b_dopp, mag_f, mag_m, mag_v)
        Hp, gp, _ = prior.precompute()(state)
        return H + Hp, g + gp

    def _marginalize_oldest(self):
        """MargImagOld flow (rvi/swf/swf.cpp:535-651 + GlobalMarge).

        Reference semantics (rvi/swf/swf.cpp:310-325): EVERY feature observed
        at the departing oldest frame (start_frame == 0) is marginalized out
        with it — all of its observation rows are consumed into the prior and
        its landmark state leaves the problem; the track itself survives and
        re-triangulates from future observations (is_in_optimize flags keep
        consumed rows out of the problem, swf_image.cpp:75-78).  The payoff:
        the prior NEVER couples surviving landmarks, so the landmark block
        stays 3x3-block-diagonal and every pipeline solve can use the
        DENSE_SCHUR group-0 fast path.
        """
        cfg, lay, ft = self.cfg, self.lay, self.features

        live = ft.active & ft.solved
        # visual rows of the blanket: all rows of dying landmarks (world
        # mode) or all rows of landmarks hosted at frame 0 (inverse-depth
        # mode — their inverse depth leaves the problem with its host;
        # survivors re-host afterwards with a fresh depth,
        # removeBackShiftDepth semantics, feature_manager.cpp:362-416)
        vis = self._vis_inputs()
        if cfg.use_inverse_depth:
            hosted0 = live & ft.obs_mask[:, 0]
            vis = vis[:6] + (vis[6] & (vis[0] == 0),)
            dying = hosted0
            lm_cols = 1
        else:
            dying = live & ft.obs_mask[:, 0]
            vis = vis[:4] + (vis[4] & dying[vis[2]],)
            lm_cols = 3

        marg_mask = np.zeros(lay.dim, dtype=bool)
        marg_mask[lay.pose_idx(0):lay.pose_idx(0) + FRAME_DIM] = True
        marg_mask[lay.clk_idx(0):lay.clk_idx(0) + NCLOCK] = True
        for slot in np.flatnonzero(dying):
            marg_mask[lay.lm_idx(slot):lay.lm_idx(slot) + lm_cols] = True

        pre_stack = _stack_pre([
            self.pre[k] if self.pre[k] is not None else self._dummy_pre()
            for k in range(cfg.nf - 1)])
        pre_valid0 = (np.arange(cfg.nf - 1) == 0) \
            & (self.pre[0] is not None)
        b_pr, b_cp, b_dopp = self._gnss_factor_inputs()
        only0 = lambda b: b._replace(valid=b.valid & (b.frame_ids == 0))
        mag_f, mag_m, mag_v = self._mag_inputs()
        mag_v = mag_v & (mag_f == 0)
        if self.cfg.use_gnss_chains:
            # chains attached at the marginalized frame fold into the prior
            # with it (their left endpoint leaves the problem), then die —
            # the reference folds the IMUGNSS factor of the departing
            # keyframe the same way (GlobalMarge blanket)
            cl = np.array([c.left == 0 for c in self.chains], dtype=bool)
            hid, st = self._chain_inputs(left_mask=cl)
            dev = _to_device(
                (self.x, hid, st, pre_stack, pre_valid0, vis, only0(b_pr),
                 only0(b_cp), only0(b_dopp), mag_f, mag_m, mag_v),
                self.device)
            Hm, gm = _to_host(self._marg_chains(
                *dev[:3], self._prior_device(), *dev[3:]))
            dead_chains = [c for c in self.chains if c.left == 0]
            for c in dead_chains:
                if self.gnss is not None and len(c.pinned_slots):
                    self.gnss.bias.unpin(c.pinned_slots)
            self.chains = [c for c in self.chains if c.left != 0]
            self._chain_stats["died"] += len(dead_chains)
        else:
            dev = _to_device(
                (self.x, pre_stack, pre_valid0, vis, only0(b_pr),
                 only0(b_cp), only0(b_dopp), mag_f, mag_m, mag_v),
                self.device)
            Hm, gm = _to_host(self._marg(dev[0], self._prior_device(),
                                         *dev[1:]))
        # the Schur + eigenvalue square root runs on the HOST (LAPACK f64),
        # once per slide, off the per-iteration hot path
        J0, r0, Hs, gs = marginalize_dense_np(
            np.asarray(Hm), np.asarray(gm), marg_mask, return_info=True)
        self.prior = MargPrior(J=J0, r0=r0, x0=self.x,
                               valid_rows=np.ones(lay.dim, dtype=bool),
                               H0=Hs, g0=gs, c0=np.asarray(r0 @ r0))
        if not cfg.use_inverse_depth:
            # consumed tracks restart from scratch: their rows are in the
            # prior, the landmark state left the problem (RemoveParameterBlock
            # + is_in_optimize semantics); the tracker re-seeds the same id
            # into a fresh slot on its next observation
            ft.drop_slots(np.flatnonzero(dying))
        self._shift_window(0)
        self._rehost_invdepth()

    def _drop_second_newest(self):
        """MargImagSecondNew flow: discard the frame's observations, merge
        its preintegrations (SlideWindowFrame, swf.cpp:239-295).  With
        chains enabled, chains touching the dropped frame absorb it as a
        hidden state (ResetImuGnssFactor merge, swf.cpp:578-616)."""
        d = self.frame_count - 2
        # a frame carrying prior information cannot be silently discarded
        # (possible when chain information was folded into the prior at a
        # middle frame); retain it and slide by the oldest instead
        lay = self.lay
        col = np.abs(self.prior.J
                     [:, lay.pose_idx(d):lay.pose_idx(d) + FRAME_DIM]).sum()
        if col > 1e-9:
            self._marginalize_oldest()
            return
        chL = next((c for c in self.chains if c.right == d), None)
        chR = next((c for c in self.chains if c.left == d), None)
        if chL is not None or chR is not None:
            left = chL.left if chL is not None else d - 1
            mid = dict(p=np.asarray(self.x.p[d])[None],
                       q=np.asarray(self.x.q[d])[None],
                       v=np.asarray(self.x.v[d])[None],
                       ba=np.asarray(self.x.ba[d])[None],
                       bg=np.asarray(self.x.bg[d])[None],
                       clk=np.asarray(self.x.clk[d])[None])
            merged = splice_records(chL, mid, chR, self.pre[d - 1],
                                    self.pre[d], left, d + 1)
            if merged.n_leaves > self.cfg.chain_cap or len(merged.mids) > 1:
                # over capacity: marginalize the middle states into a frozen
                # mid-chain marginal (MiddleMargGnssFrame, swf_core.cpp:569)
                merged = self._truncate_chain(merged)
                self._chain_stats["truncated"] = \
                    self._chain_stats.get("truncated", 0) + 1
            self.chains = [c for c in self.chains
                           if c is not chL and c is not chR]
            self.features.remove_frame(d, self.cfg.nf - 1)
            self.pre = (self.pre[:left] + [None]
                        + self.pre[d + 1:self.cfg.nf - 1]
                        + [None] * (d - left))
            self.chains.append(merged)
            self._chain_stats["merged"] += 1
            self._shift_state_only(d)   # also remaps merged.right -> d
            return
        self.features.remove_frame(d, self.cfg.nf - 1)
        merged = _to_host(merge_preintegrations(
            *_to_device((self.pre[d - 1], self.pre[d]), self.device)))
        self.pre[d - 1] = merged
        # shift intervals left above d
        for k in range(d, self.cfg.nf - 2):
            self.pre[k] = self.pre[k + 1]
        self.pre[self.cfg.nf - 2] = None
        self._shift_state_only(d)

    # ------------------------------------------------------------------
    def _frame_perm(self, drop: int):
        """Tangent permutation sending old index -> new after dropping frame
        ``drop`` (frames above shift down; the freed last slot dies)."""
        lay = self.lay
        perm = np.arange(lay.dim)
        for f in range(drop, lay.nf - 1):
            src_p = lay.pose_idx(f + 1)
            dst_p = lay.pose_idx(f)
            perm[dst_p:dst_p + FRAME_DIM] = np.arange(src_p, src_p + FRAME_DIM)
            src_c = lay.clk_idx(f + 1)
            dst_c = lay.clk_idx(f)
            perm[dst_c:dst_c + NCLOCK] = np.arange(src_c, src_c + NCLOCK)
        return perm

    def _shift_arrays(self, state: WindowState, drop: int) -> WindowState:
        def sh(a):
            out = np.array(a)
            out[drop:-1] = out[drop + 1:].copy()
            return out
        return state._replace(p=sh(state.p), q=sh(state.q), v=sh(state.v),
                              ba=sh(state.ba), bg=sh(state.bg),
                              clk=sh(state.clk))

    def _shift_prior_cols(self, drop: int):
        """Permute prior columns after removing frame ``drop`` (the removed
        frame must carry no prior information — interior GNSS frames and
        non-keyframes never do; marginalized frames were Schur'd out)."""
        lay = self.lay
        perm = self._frame_perm(drop)
        # prior columns follow the moving states; freed last-frame slots get
        # zero columns (no info)
        J = self.prior.J[:, perm]
        last = lay.nf - 1
        dead = np.zeros(lay.dim, dtype=bool)
        dead[lay.pose_idx(last):lay.pose_idx(last) + FRAME_DIM] = True
        dead[lay.clk_idx(last):lay.clk_idx(last) + NCLOCK] = True
        J[:, dead] = 0.0
        x0 = self._shift_arrays(self.prior.x0, drop)
        kw = {}
        if self.prior.H0 is not None:
            # the information form permutes with the columns: JᵀJ is the
            # column Gram matrix; freed slots zero out
            H0 = self.prior.H0[np.ix_(perm, perm)]
            g0 = self.prior.g0[perm]
            H0[dead, :] = 0.0
            H0[:, dead] = 0.0
            g0[dead] = 0.0
            kw = dict(H0=H0, g0=g0)
        self.prior = self.prior._replace(J=J, x0=x0, **kw)

    def _shift_window(self, drop: int):
        """Shift state, prior and bookkeeping after marginalizing ``drop``."""
        self._shift_prior_cols(drop)
        self._shift_state_only(drop, shift_pre=True)

    def _shift_state_only(self, drop: int, shift_pre: bool = False):
        self.x = self._shift_arrays(self.x, drop)
        if shift_pre:
            for k in range(drop, self.cfg.nf - 2):
                self.pre[k] = self.pre[k + 1]
            self.pre[self.cfg.nf - 2] = None
            self.features.remove_frame(drop, self.cfg.nf - 1)
        # frame-type, mag, and GNSS-store bookkeeping follow the same shift
        self.frame_is_gnss[drop:-1] = self.frame_is_gnss[drop + 1:]
        self.frame_is_gnss[-1] = False
        self.frame_mag[drop:-1] = self.frame_mag[drop + 1:]
        self.frame_mag_valid[drop:-1] = self.frame_mag_valid[drop + 1:]
        self.frame_mag_valid[-1] = False
        self.gnss_store[drop:self.cfg.nf - 1] = \
            self.gnss_store[drop + 1:self.cfg.nf]
        self.gnss_store[self.cfg.nf - 1] = None
        del self.frame_times[drop]
        self.frame_count -= 1
        # chain endpoints follow the moving frames (chains attached TO the
        # dropped frame must be handled by the caller beforehand)
        for c in self.chains:
            if c.left > drop:
                c.left -= 1
            if c.right > drop:
                c.right -= 1
        # prior x0 and current x now agree on frame indexing

    # ------------------------------------------------------------------
    def _record(self, t):
        i = self.frame_count - 1
        self.trajectory.append(
            (float(t), np.asarray(self.x.p[i]), np.asarray(self.x.q[i]),
             np.asarray(self.x.v[i])))
        self._dr_rebase(t)

    # ------------------------------------------------------------------
    # prior storage: host numpy is the source of truth (host marginalization
    # + bookkeeping); a device copy is cached so the ~D² prior is NOT
    # re-uploaded on every per-frame solve — only after prior updates
    # (marg / bake / dead-slot sync / column shifts)
    @property
    def prior(self):
        return self._prior

    @prior.setter
    def prior(self, p):
        if p.H0 is None:
            # normalize: every prior the solves see carries the information
            # form (no JᵀJ product inside the solve).  Support-restricted:
            # prior rows/cols outside the blanket are structurally zero.
            J = np.asarray(p.J, dtype=np.float64)
            r0 = np.asarray(p.r0, dtype=np.float64)
            vr = np.asarray(p.valid_rows, dtype=bool)
            Jm = J * vr[:, None]
            rm = r0 * vr
            D = J.shape[1]
            sup_c = np.flatnonzero(np.abs(Jm).max(axis=0) > 0)
            sup_r = np.flatnonzero(np.abs(Jm).max(axis=1) > 0)
            H0 = np.zeros((D, D))
            g0 = np.zeros(D)
            if len(sup_r) and len(sup_c):
                Js = Jm[np.ix_(sup_r, sup_c)]
                H0[np.ix_(sup_c, sup_c)] = Js.T @ Js
                g0[sup_c] = Js.T @ rm[sup_r]
            p = p._replace(H0=H0, g0=g0, c0=np.asarray(rm @ rm))
        self._prior = p
        self._prior_dev_cache = None
        # MyOrdering guard, once per prior rebuild (_dogleg_cfg reads it)
        self._prior_lm_coupled = self._prior_couples_landmarks()

    def _prior_device(self):
        if self._prior_dev_cache is None:
            self._prior_dev_cache = _to_device(self._prior, self.device)
        return self._prior_dev_cache
