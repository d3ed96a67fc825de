"""Synthetic sensor simulation for tests and benchmarks.

The reference has no tests and relies on released rosbags we don't have
(SURVEY.md §4); this simulator is the framework's ground-truth data source:
an analytically-differentiable trajectory with *time-varying* twist (so IMU
biases are observable — constant-twist orbits have an exact bias null
space), IMU samples at 400 Hz, landmark projections through the pinhole
model, magnetometer readings, and GNSS observables (pseudorange / carrier
phase / Doppler for rover and rover-base single differences) from a
broadcast-like satellite constellation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..geodesy import earth
from ..ops import lie


@dataclass
class SimConfig:
    duration: float = 20.0
    imu_rate: float = 400.0
    cam_rate: float = 4.0          # keyframe-ish rate for compact tests
    gnss_rate: float = 10.0
    n_landmarks: int = 80
    n_sats: int = 12
    n_systems: int = 1           # GPS / +BDS / +GAL (round-robin over sats)
    dual_freq: bool = False      # add an f1 channel per satellite
    seed: int = 0
    g: float = 9.81
    # noise (0 = noiseless golden data); IMU noise in continuous-time units
    acc_noise: float = 0.0
    gyr_noise: float = 0.0
    pix_noise: float = 0.0         # unit-plane
    pr_noise: float = 0.0          # pseudorange [m]
    cp_noise: float = 0.0          # carrier phase [cycle]
    dop_noise: float = 0.0         # doppler [m/s]
    ba: np.ndarray = field(default_factory=lambda: np.zeros(3))
    bg: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # magnetometer: world field in ENU (north + down component) and noise
    mag_world: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.35, -0.25]))
    mag_noise: float = 0.0
    # constant initial yaw offset [rad] (tests mag-based yaw init)
    yaw0: float = 0.0
    # constant start offset from the anchor [m] (tests GNSS first-fix
    # initialization: the estimator boots at its local origin and must
    # recover the true absolute position from the first epoch's SPP solve)
    p0: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # receiver clock offset [m] and drift [m/s]
    clk0: float = 40.0
    clk_drift: float = 1.5
    anchor_llh: np.ndarray = field(
        default_factory=lambda: np.array([np.deg2rad(22.6), np.deg2rad(113.9), 20.0]))
    pbg: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # camera extrinsic rotation cam->body: optical axis (z_cam) = body x
    # (forward-looking camera; columns are cam axes expressed in body)
    r_ic: np.ndarray = field(default_factory=lambda: np.array(
        [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    t_ic: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # optional right camera (stereo): same rotation, baseline along cam x
    stereo: bool = False
    baseline: float = 0.12
    # rest period before the motion envelope ramps [s].  The reference's
    # initialization assumes a static start: InitializePos averages the
    # first AVERAGE_IMU=400 samples for attitude (rvi/swf/swf_imu.cpp:47-59)
    # and the driver skips the first AVERAGE_IMAGE=60 images = 2.4 s
    # (rvi/main3.cpp:180) — so the first processed frame must still be at
    # rest, as it is on the reference's own recordings.  Protocol bags use
    # 4.0; unit tests keep the compact 1.0 default.
    static_lead: float = 1.0


@dataclass
class SimData:
    cfg: SimConfig
    # IMU stream
    imu_t: np.ndarray     # (N,)
    acc: np.ndarray       # (N,3) body specific force + bias + noise
    gyr: np.ndarray       # (N,3)
    mag: np.ndarray       # (N,3) magnetometer in body frame
    # truth at IMU times
    p: np.ndarray         # (N,3) local frame (z-up, relative to anchor)
    q: np.ndarray         # (N,4)
    v: np.ndarray         # (N,3)
    # camera frames
    cam_t: np.ndarray     # (F,)
    cam_idx: np.ndarray   # (F,) index into imu stream
    landmarks: np.ndarray  # (L,3)
    obs_xy: np.ndarray    # (F,L,2) unit-plane observation
    obs_valid: np.ndarray  # (F,L) bool
    # GNSS epochs
    gnss_t: np.ndarray    # (E,)
    gnss_idx: np.ndarray  # (E,)
    sat_pos: np.ndarray   # (E,S,3) ECEF
    sat_vel: np.ndarray   # (E,S,3)
    pr: np.ndarray        # (E,S) rover pseudorange [m] (includes clock)
    cp_cycles: np.ndarray  # (E,S) rover carrier phase [cycle] with ambiguity
    dopp: np.ndarray      # (E,S) doppler range-rate [m/s] (includes drift)
    rtk_pr: np.ndarray    # (E,S) rover-base single-difference pseudorange
    rtk_cp: np.ndarray    # (E,S) RB-SD carrier phase [cycle]
    ambiguities: np.ndarray  # (S,) integer ambiguities [cycle] (rover)
    rtk_ambiguities: np.ndarray  # (S,) RB-SD integer ambiguities
    sat_valid: np.ndarray  # (E,C) channel validity
    wavelength: np.ndarray  # (C,) per channel
    anchor_ecef: np.ndarray  # (3,) base/anchor position (local frame origin)
    enu_to_ecef: np.ndarray  # (3,3) rotation from local(ENU) to ECEF
    clk: np.ndarray       # (E,) true clock offsets [m]
    clk_drift: float
    ch_sat: Optional[np.ndarray] = None   # (C,) satellite id per channel
    ch_sys: Optional[np.ndarray] = None   # (C,) system per channel
    ch_freq: Optional[np.ndarray] = None  # (C,) frequency per channel
    # right camera (stereo) observations
    obs_xy_r: np.ndarray = None
    obs_valid_r: np.ndarray = None


def _envelope(t, t0=1.0, ramp=3.0):
    """C² smootherstep envelope: 0 (at rest) for t<t0, 1 after t0+ramp.

    Returns (e, e', e'').  A rest period at the start matches the reference's
    quasi-static initialization assumption (InitializePos averages the first
    AVERAGE_IMU samples for attitude, rvi/swf/swf_imu.cpp:5-37).
    """
    u = np.clip((t - t0) / ramp, 0.0, 1.0)
    e = u**3 * (10 - 15 * u + 6 * u * u)
    de = 30.0 * u * u * (1 - u) ** 2 / ramp
    dde = (60.0 * u - 180.0 * u**2 + 120.0 * u**3) / ramp**2
    return e, de, dde


def _trajectory(t, rng, yaw0=0.0, static_lead=1.0):
    """Smooth, excitation-rich trajectory: enveloped Lissajous position +
    wobbling attitude, starting at rest.  Analytic p, v, a, R, w_body.
    """
    ax, ay, az = 12.0, 8.0, 1.5
    wx, wy, wz = 2 * np.pi / 17.0, 2 * np.pi / 11.0, 2 * np.pi / 7.0
    e, de, dde = _envelope(t, t0=static_lead)
    e, de, dde = e[:, None], de[:, None], dde[:, None]

    b = np.stack([ax * np.sin(wx * t), ay * np.sin(wy * t),
                  az * np.sin(wz * t)], -1)
    db = np.stack([ax * wx * np.cos(wx * t), ay * wy * np.cos(wy * t),
                   az * wz * np.cos(wz * t)], -1)
    ddb = np.stack([-ax * wx**2 * np.sin(wx * t), -ay * wy**2 * np.sin(wy * t),
                    -az * wz**2 * np.sin(wz * t)], -1)
    p = e * b
    v = de * b + e * db
    a = dde * b + 2 * de * db + e * ddb

    # attitude: enveloped Euler angles (ZYX), exact body rate from Euler rates
    amp = np.array([0.8, 0.25, 0.2])
    om = 2 * np.pi / np.array([13.0, 5.0, 6.5])
    ph = np.array([0.0, 0.3, 1.1])
    base = amp * np.sin(om * t[:, None] + ph)
    dbase = amp * om * np.cos(om * t[:, None] + ph)
    ypr = e * base
    ypr[:, 0] += yaw0
    dypr = de * base + e * dbase
    yaw, pitch, roll = ypr[:, 0], ypr[:, 1], ypr[:, 2]
    dyaw, dpitch, droll = dypr[:, 0], dypr[:, 1], dypr[:, 2]
    R = lie.ypr_to_rot(torch.from_numpy(np.rad2deg(ypr))).numpy()
    sp, cp_ = np.sin(pitch), np.cos(pitch)
    sr, cr = np.sin(roll), np.cos(roll)
    # ZYX convention: w_body = [droll - dyaw*sp,
    #                           dpitch*cr + dyaw*cp*sr,
    #                           -dpitch*sr + dyaw*cp*cr]
    w_body = np.stack([
        droll - dyaw * sp,
        dpitch * cr + dyaw * cp_ * sr,
        -dpitch * sr + dyaw * cp_ * cr,
    ], -1)
    return p, v, a, R, w_body


def gnss_epoch_of(sim: "SimData", ei: int, pr_std=0.8, cp_std=0.01,
                  dopp_std=0.1, pr0=None):
    """Adapter: one SimData epoch -> gnss.preprocess.GnssEpoch."""
    from ..gnss.preprocess import GnssEpoch

    ch_sat = sim.ch_sat if sim.ch_sat is not None \
        else np.arange(sim.cfg.n_sats)
    ch_sys = sim.ch_sys if sim.ch_sys is not None \
        else np.zeros_like(ch_sat)
    ch_freq = sim.ch_freq if sim.ch_freq is not None \
        else np.zeros_like(ch_sat)
    return GnssEpoch(
        pr0=pr0,
        t=float(sim.gnss_t[ei]),
        sat_id=ch_sat,
        sys=ch_sys.astype(np.int64),
        freq=ch_freq.astype(np.int64),
        sat_pos=sim.sat_pos[ei][ch_sat],
        sat_vel=sim.sat_vel[ei][ch_sat],
        pr=sim.pr[ei],
        cp=sim.cp_cycles[ei],
        dopp=sim.dopp[ei],
        rtk_pr=sim.rtk_pr[ei],
        rtk_cp=sim.rtk_cp[ei],
        pr_std=np.full(len(ch_sat), pr_std),
        cp_std=np.full(len(ch_sat), cp_std),
        dopp_std=np.full(len(ch_sat), dopp_std),
        slip=np.zeros(len(ch_sat), dtype=bool),
        br_time_diff=1.0,
    )


def simulate(cfg: SimConfig) -> SimData:
    """Generate a SimData sequence on the host: numpy, and float64 torch
    on the CPU for the rotation and range geometry.  The draws come from
    ``np.random.default_rng(cfg.seed)`` in a fixed order, so a seed gives
    the same sequence as the JAX package's simulator."""
    rng = np.random.default_rng(cfg.seed)
    n = int(cfg.duration * cfg.imu_rate) + 1
    t = np.arange(n) / cfg.imu_rate

    p, v, a, R, w_body = _trajectory(t, rng, cfg.yaw0, cfg.static_lead)
    p = p + np.asarray(cfg.p0)[None, :]
    q = lie.rot_to_quat(torch.from_numpy(R)).numpy()
    g_vec = np.array([0.0, 0.0, -cfg.g])

    # IMU: specific force in body = R^T (a - g)
    acc = np.einsum("nji,nj->ni", R, a - g_vec)
    gyr = w_body.copy()
    if cfg.acc_noise > 0:
        acc = acc + rng.normal(0, cfg.acc_noise * np.sqrt(cfg.imu_rate), acc.shape)
    if cfg.gyr_noise > 0:
        gyr = gyr + rng.normal(0, cfg.gyr_noise * np.sqrt(cfg.imu_rate), gyr.shape)
    acc = acc + cfg.ba
    gyr = gyr + cfg.bg

    # magnetometer: world field rotated into body (+ noise)
    mag = np.einsum("nji,j->ni", R, cfg.mag_world)
    if cfg.mag_noise > 0:
        mag = mag + rng.normal(0, cfg.mag_noise, mag.shape)

    # camera frames
    stride = max(1, int(round(cfg.imu_rate / cfg.cam_rate)))
    cam_idx = np.arange(0, n, stride)
    cam_t = t[cam_idx]
    F = len(cam_idx)

    # landmarks in a ring shell around the trajectory volume so a
    # forward-looking camera always sees a healthy subset.  The shell must
    # be centered on the (p0-displaced) trajectory — centering on the
    # origin left a p0=120 m sequence with ZERO visible landmarks, turning
    # every "VI" replay into pure IMU dead reckoning.
    az_lm = rng.uniform(0, 2 * np.pi, cfg.n_landmarks)
    rad_lm = rng.uniform(18, 45, cfg.n_landmarks)
    landmarks = np.asarray(cfg.p0)[None, :] + np.stack([
        rad_lm * np.cos(az_lm),
        rad_lm * np.sin(az_lm),
        rng.uniform(-5, 15, cfg.n_landmarks),
    ], -1)

    obs_xy = np.zeros((F, cfg.n_landmarks, 2))
    obs_valid = np.zeros((F, cfg.n_landmarks), dtype=bool)
    obs_xy_r = np.zeros((F, cfg.n_landmarks, 2))
    obs_valid_r = np.zeros((F, cfg.n_landmarks), dtype=bool)
    # right camera: same rotation, displaced by the baseline along cam x
    t_ic2 = cfg.t_ic + cfg.baseline * cfg.r_ic[:, 0]
    for fi, ni in enumerate(cam_idx):
        p_body = np.einsum("ji,lj->li", R[ni], landmarks - p[ni])
        pc = np.einsum("ji,lj->li", cfg.r_ic, p_body - cfg.t_ic)
        zok = pc[:, 2] > 1.0
        xy = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
        infov = zok & (np.abs(xy[:, 0]) < 1.2) & (np.abs(xy[:, 1]) < 0.9)
        if cfg.pix_noise > 0:
            xy = xy + rng.normal(0, cfg.pix_noise, xy.shape)
        obs_xy[fi] = xy
        obs_valid[fi] = infov
        if cfg.stereo:
            pc2 = np.einsum("ji,lj->li", cfg.r_ic, p_body - t_ic2)
            zok2 = pc2[:, 2] > 1.0
            xy2 = pc2[:, :2] / np.maximum(pc2[:, 2:3], 1e-6)
            infov2 = (zok2 & (np.abs(xy2[:, 0]) < 1.2)
                      & (np.abs(xy2[:, 1]) < 0.9))
            if cfg.pix_noise > 0:
                xy2 = xy2 + rng.normal(0, cfg.pix_noise, xy2.shape)
            obs_xy_r[fi] = xy2
            obs_valid_r[fi] = infov2

    # ---- GNSS ----
    anchor_ecef = earth.geodetic_to_ecef(
        cfg.anchor_llh[0], cfg.anchor_llh[1], cfg.anchor_llh[2]).numpy()
    E_enu = earth.enu_rotation(cfg.anchor_llh[0], cfg.anchor_llh[1]).numpy()
    enu_to_ecef = E_enu.T  # columns are E,N,U in ECEF

    stride_g = max(1, int(round(cfg.imu_rate / cfg.gnss_rate)))
    gnss_idx = np.arange(0, n, stride_g)
    gnss_t = t[gnss_idx]
    E = len(gnss_idx)
    S = cfg.n_sats

    # constellation: satellites on a 26.6e6 m shell, slow circular motion,
    # placed above the horizon at the anchor
    up = anchor_ecef / np.linalg.norm(anchor_ecef)
    sat_pos = np.zeros((E, S, 3))
    sat_vel = np.zeros((E, S, 3))
    r_orbit = 26.6e6
    az = rng.uniform(0, 2 * np.pi, S)
    el = rng.uniform(np.deg2rad(30), np.deg2rad(85), S)
    # basis at anchor
    e1 = enu_to_ecef[:, 0]
    n1 = enu_to_ecef[:, 1]
    for s in range(S):
        dir0 = (np.cos(el[s]) * (np.sin(az[s]) * e1 + np.cos(az[s]) * n1)
                + np.sin(el[s]) * up)
        pos0 = anchor_ecef + dir0 * (r_orbit - np.linalg.norm(anchor_ecef))
        pos0 = pos0 / np.linalg.norm(pos0) * r_orbit
        # orbital velocity ~3.9 km/s along a great-circle tangent
        tangent = np.cross(up, pos0)
        tangent /= np.linalg.norm(tangent)
        sat_vel[:, s] = tangent * 3874.0
        for ei, te in enumerate(gnss_t):
            sat_pos[ei, s] = pos0 + sat_vel[ei, s] * te

    # channels: one per (satellite, frequency); systems round-robin
    sat_sys = np.arange(S) % max(cfg.n_systems, 1)
    n_freq = 2 if cfg.dual_freq else 1
    ch_sat = np.tile(np.arange(S), n_freq)
    ch_sys = np.tile(sat_sys, n_freq)
    ch_freq = np.repeat(np.arange(n_freq), S)
    C = S * n_freq
    lam = earth.WAVELENGTHS[ch_sys, ch_freq]
    ambiguities = rng.integers(-50, 50, C).astype(float)
    rtk_ambiguities = rng.integers(-30, 30, C).astype(float)

    sat_valid = np.ones((E, C), dtype=bool)
    clk = cfg.clk0 + cfg.clk_drift * gnss_t

    # batched geometry over (epoch, channel), float64 on the host CPU
    rr_all = anchor_ecef[None, :] + p[gnss_idx] @ enu_to_ecef.T   # (E,3)
    vr_all = v[gnss_idx] @ enu_to_ecef.T                          # (E,3)
    sp_ch = torch.from_numpy(sat_pos[:, ch_sat])                  # (E,C,3)
    sv_ch = torch.from_numpy(sat_vel[:, ch_sat])                  # (E,C,3)
    rr_t = torch.from_numpy(rr_all)[:, None, :]
    r_all = earth.sagnac_range(rr_t, sp_ch)[0].numpy()
    rb_all = earth.sagnac_range(torch.from_numpy(anchor_ecef), sp_ch)[0] \
        .numpy()
    rate_all = earth.range_rate(rr_t, sp_ch,
                                torch.from_numpy(vr_all)[:, None, :],
                                sv_ch)[0].numpy()
    # carrier-phase sign convention follows the reference residual
    # ρ + dt − N·λ − L·λ = 0 (gnss_factor.cpp:57,119): the ambiguity
    # enters the modeled phase with a MINUS sign.
    pr = r_all + clk[:, None] + rng.normal(0, cfg.pr_noise, (E, C))
    cp_cycles = ((r_all + clk[:, None]) / lam[None, :] - ambiguities[None, :]
                 + rng.normal(0, cfg.cp_noise, (E, C)))
    dopp = rate_all + cfg.clk_drift + rng.normal(0, cfg.dop_noise, (E, C))
    rtk_pr = r_all - rb_all + rng.normal(0, cfg.pr_noise * 0.5, (E, C))
    rtk_cp = ((r_all - rb_all) / lam[None, :] - rtk_ambiguities[None, :]
              + rng.normal(0, cfg.cp_noise * 0.5, (E, C)))

    return SimData(
        cfg=cfg, imu_t=t, acc=acc, gyr=gyr, mag=mag, p=p, q=q, v=v,
        cam_t=cam_t, cam_idx=cam_idx, landmarks=landmarks,
        obs_xy=obs_xy, obs_valid=obs_valid,
        obs_xy_r=obs_xy_r, obs_valid_r=obs_valid_r,
        gnss_t=gnss_t, gnss_idx=gnss_idx, sat_pos=sat_pos, sat_vel=sat_vel,
        pr=pr, cp_cycles=cp_cycles, dopp=dopp, rtk_pr=rtk_pr, rtk_cp=rtk_cp,
        ambiguities=ambiguities, rtk_ambiguities=rtk_ambiguities,
        sat_valid=sat_valid, wavelength=lam, ch_sat=ch_sat, ch_sys=ch_sys,
        ch_freq=ch_freq, anchor_ecef=anchor_ecef,
        enu_to_ecef=enu_to_ecef, clk=clk, clk_drift=cfg.clk_drift)
