"""Drive an estimator through a simulated sequence, as ``bench.py
--pipeline`` and the JAX package's pipeline tests do.

``MODE_CASES`` holds the navigation modes of those tests, one case each:
the simulated sequence, the estimator's configuration and the test's
event loop.  ``tests/test_torch_modes.py`` holds the port to the JAX
estimator on every case, and ``chip_smoke.py`` runs each on the card."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops import lie
from ..sim.synthetic import gnss_epoch_of


def replay(est, sim, start: int = 0, stop=None, on_event=None,
           epoch_of=gnss_epoch_of, stereo: bool = False, mag_every: int = 0):
    """Feed IMU samples ``start..stop-1`` of ``sim`` to ``est`` in order;
    every ``mag_every``-th sample (0: none) also goes to ``process_mag``;
    at a sample with a GNSS epoch, ``process_gnss`` it, then at a sample
    with a camera frame, ``process_image`` every landmark in view (the
    order of bench.py:67-80), with the right camera's too when
    ``stereo``.  ``on_event(i)`` runs after each GNSS or image event at
    sample i.  ``epoch_of`` turns (sim, epoch index) into the estimator's
    ``GnssEpoch``; ``None`` feeds no epoch (the VI tests' loop).  Returns
    ``est``."""
    ids = np.arange(sim.landmarks.shape[0])
    stop = len(sim.imu_t) if stop is None else stop
    cam = int(np.searchsorted(sim.cam_idx, start))
    gps = int(np.searchsorted(sim.gnss_idx, start))
    for i in range(start, stop):
        t = sim.imu_t[i]
        est.process_imu(t, sim.acc[i], sim.gyr[i])
        if mag_every and i % mag_every == 0:
            est.process_mag(t, sim.mag[i])
        if (epoch_of is not None and gps < len(sim.gnss_idx)
                and sim.gnss_idx[gps] == i):
            est.process_gnss(epoch_of(sim, gps))
            gps += 1
            if on_event is not None:
                on_event(i)
        if cam < len(sim.cam_idx) and sim.cam_idx[cam] == i:
            vis = sim.obs_valid[cam]
            if stereo:
                vis_r = sim.obs_valid_r[cam]
                est.process_image(t, ids[vis], sim.obs_xy[cam][vis],
                                  ids[vis_r], sim.obs_xy_r[cam][vis_r])
            else:
                est.process_image(t, ids[vis], sim.obs_xy[cam][vis])
            cam += 1
            if on_event is not None:
                on_event(i)
    return est


@dataclass(frozen=True)
class ModeCase:
    """One navigation mode of the JAX package's pipeline tests.

    ``sim``: ``SimConfig`` fields besides the duration; ``cfg``:
    ``EstimatorConfig`` fields besides those ``mode_config_kwargs`` takes
    from the simulation; ``gnss``: the loop feeds the GNSS epochs;
    ``stereo``: the right camera's rows too, its extrinsic offset by the
    baseline along camera x; ``mag_every``: the magnetometer every this
    many IMU samples; ``pr0_seed``: the SPP_P0 channel is the pseudorange
    plus a per-satellite offset ~ U(-3, 3) m drawn from
    ``default_rng(pr0_seed)``; ``truth``: the JAX test's bounds against
    the truth (``mode_truth``)."""
    sim: dict
    cfg: dict
    gnss: bool = False
    stereo: bool = False
    mag_every: int = 0
    pr0_seed: Optional[int] = None
    truth: dict = field(default_factory=dict)


# tests/test_pipeline_vi.py:15-18 (tests/test_pipeline_invdepth.py:13-16
# adds the right camera) and :40-42
_VI_SIM = dict(imu_rate=200.0, cam_rate=4.0, n_landmarks=60, seed=0)
_VI_CFG = dict(nf=8, nl=48, nb=1, max_obs=320, imu_capacity=64,
               average_imu=40)
# tests/test_pipeline_gnss.py:14-19 and spp_cfg (:39-53), chains at the
# test tier's caps
_GNSS_SIM = dict(imu_rate=200.0, cam_rate=2.0, gnss_rate=2.0,
                 n_landmarks=60, n_sats=10, seed=0)
_GNSS_CFG = dict(nf=10, nl=48, nb=32, max_obs=256, imu_capacity=128,
                 average_imu=40, use_gnss=True, use_doppler=True,
                 max_gnss_pr=160, max_gnss_cp=160, max_gnss_dopp=160,
                 min_sats_per_epoch=6, initial_gnss_boost_epochs=5,
                 chain_cap=8, max_chain_rows=256)
_RTK_CFG = dict(use_rtk=True, use_rtd=True, use_n_resolve=True,
                min_fix_continuity=1, fix_continue_threshold=3)
# the JAX tests' bounds against the truth: the final and the largest
# position error (VI), or the largest over the second half (GNSS)
_VI_TRUTH = dict(final_m=0.05, max_m=0.10)
_GNSS_TRUTH = dict(second_half_m=0.05)

MODE_CASES = {
    # tests/test_pipeline_vi.py:40-42
    "vi": ModeCase(_VI_SIM, _VI_CFG, truth=_VI_TRUTH),
    # tests/test_pipeline_invdepth.py:43-45
    "vi_invdepth": ModeCase(_VI_SIM, dict(_VI_CFG, use_inverse_depth=True),
                            truth=_VI_TRUTH),
    # tests/test_pipeline_invdepth.py:65-72
    "stereo": ModeCase(dict(_VI_SIM, stereo=True),
                       dict(_VI_CFG, max_obs=448, use_stereo=True),
                       stereo=True, truth=_VI_TRUTH),
    # tests/test_pipeline_invdepth.py:79-85
    "stereo_invdepth": ModeCase(
        dict(_VI_SIM, stereo=True),
        dict(_VI_CFG, max_obs=448, use_stereo=True, use_inverse_depth=True),
        stereo=True, truth=_VI_TRUTH),
    # tests/test_pipeline_gnss.py:56-60
    "spp": ModeCase(_GNSS_SIM, dict(_GNSS_CFG, use_gnss_chains=False),
                    gnss=True,
                    truth=dict(_GNSS_TRUTH, clock_m=0.05, drift_m_s=0.05)),
    # tests/test_pipeline_gnss.py:84-86
    "spp_cp": ModeCase(_GNSS_SIM, dict(_GNSS_CFG, use_spp_phase=True),
                       gnss=True,
                       truth=dict(_GNSS_TRUTH, ambiguity_std_cyc=0.05)),
    # tests/test_pipeline_gnss.py:106-108
    "rtd": ModeCase(_GNSS_SIM, dict(_GNSS_CFG, use_rtd=True), gnss=True,
                    truth=_GNSS_TRUTH),
    # tests/test_pipeline_gnss.py:204-212
    "spp_correction": ModeCase(
        _GNSS_SIM, dict(_GNSS_CFG, use_spp_correction=True), gnss=True,
        pr0_seed=7, truth=dict(_GNSS_TRUTH, correction_m=0.05)),
    # tests/test_pipeline_gnss.py:140-160
    "mag": ModeCase(
        dict(_GNSS_SIM, seed=3, yaw0=0.7),
        dict(_GNSS_CFG, use_mag=True, use_mag_correct_yaw=True), gnss=True,
        mag_every=10, truth=dict(second_half_m=0.1, last_attitude_rad=0.02)),
    # tests/test_pipeline_gnss.py:117-138 at the bench's chain caps
    # (EstimatorConfig's defaults)
    "rtk_full_caps": ModeCase(
        _GNSS_SIM, dict(_GNSS_CFG, **_RTK_CFG, chain_cap=32,
                        max_chain_rows=512),
        gnss=True, truth=dict(last10_m=0.02)),
}


def mode_sim_kwargs(name: str, duration: float) -> dict:
    """``SimConfig`` keyword arguments of case ``name``."""
    return dict(MODE_CASES[name].sim, duration=duration)


def mode_config_kwargs(name: str, sim, **overrides) -> dict:
    """``EstimatorConfig`` keyword arguments of case ``name`` on ``sim``
    (the extrinsics, and for GNSS the anchor and the ENU frame, come from
    the simulation, as in the JAX tests)."""
    case = MODE_CASES[name]
    q_ic = lie.rot_to_quat(torch.from_numpy(np.asarray(
        sim.cfg.r_ic, dtype=np.float64))).numpy()
    tic = np.tile(np.asarray(sim.cfg.t_ic, dtype=np.float64), (2, 1))
    if case.stereo:
        tic[1] = sim.cfg.t_ic + sim.cfg.baseline * sim.cfg.r_ic[:, 0]
    kw = dict(case.cfg, qic=np.tile(q_ic, (2, 1)), tic=tic)
    if case.gnss:
        kw.update(anchor_ecef=sim.anchor_ecef, enu_to_ecef=sim.enu_to_ecef)
    kw.update(overrides)
    return kw


def mode_pr0_offsets(name: str, sim):
    """The SPP_P0 offsets of case ``name`` (m, per satellite), or None."""
    seed = MODE_CASES[name].pr0_seed
    if seed is None:
        return None
    return np.random.default_rng(seed).uniform(-3, 3, sim.cfg.n_sats)


def replay_mode(est, name: str, sim, on_event=None):
    """Replay ``sim`` into ``est`` through case ``name``'s event loop."""
    case = MODE_CASES[name]
    offsets = mode_pr0_offsets(name, sim)
    if not case.gnss:
        epoch_of = None
    elif offsets is None:
        epoch_of = gnss_epoch_of
    else:
        def epoch_of(s, k):
            return gnss_epoch_of(s, k, pr0=s.pr[k] + offsets)
    return replay(est, sim, on_event=on_event, epoch_of=epoch_of,
                  stereo=case.stereo, mag_every=case.mag_every)


# the SPP-correction channel's carrier wavelength (GPS L1,
# tests/test_pipeline_gnss.py:232)
_LAMBDA_L1 = 0.19029367279836487


def _nearest(sim, t):
    return int(np.argmin(np.abs(sim.imu_t - t)))


def mode_truth(name: str, est, sim):
    """The JAX test's bounds against the truth (``MODE_CASES[name].truth``)
    on ``est`` after a replay of ``sim``.  Returns (the measured errors,
    the list of bounds not met)."""
    bound = MODE_CASES[name].truth
    traj = est.trajectory
    errs = np.asarray([np.linalg.norm(p - sim.p[_nearest(sim, t)])
                       for (t, p, _, _) in traj])
    got, fails = {"frames": len(traj)}, []

    def check(key, value, limit, what):
        got[key] = value = float(value)
        if not value < limit:
            fails.append(f"{what} {value:.4g} (bound {limit:g})")

    if not est.initialized or not len(errs):
        return got, ["not initialized"]
    if "final_m" in bound:
        check("final_m", float(errs[-1]), bound["final_m"], "final error m")
        check("max_m", float(errs.max()), bound["max_m"], "largest error m")
    if "second_half_m" in bound:
        check("second_half_m", float(errs[len(errs) // 2:].max()),
              bound["second_half_m"], "second-half error m")
    if "clock_m" in bound:
        fc = est.frame_count
        gframes = np.flatnonzero(np.asarray(est.frame_is_gnss)[:fc])
        if not len(gframes):
            return got, fails + ["no GNSS frame in the window"]
        f = int(gframes[-1])
        ei = int(np.argmin(np.abs(sim.gnss_t - est.frame_times[f])))
        clk = np.asarray(est.x.clk)
        # the GPS f0 SPP clock slot and the drift slot
        check("clock_m", abs(float(clk[f, 6]) - sim.clk[ei]),
              bound["clock_m"], "clock error m")
        check("drift_m_s", abs(float(clk[f, 12]) - sim.clk_drift),
              bound["drift_m_s"], "drift error m/s")
    bias = est.gnss.bias if est.gnss is not None else None
    pb = np.asarray(est.x.phase_bias)
    if "ambiguity_std_cyc" in bound:
        slots = [s for s in range(est.cfg.nb)
                 if bias.active[s] and bias.key[s][0] == "spp"]
        got["ambiguities"] = len(slots)
        if len(slots) < 4:
            fails.append(f"{len(slots)} active ambiguities (at least 4)")
        else:
            d = pb[slots] - np.asarray([sim.ambiguities[bias.key[s][1]]
                                        for s in slots])
            check("ambiguity_std_cyc", float(np.std(d)),
                  bound["ambiguity_std_cyc"], "ambiguity spread cycles")
    if "correction_m" in bound:
        offsets = mode_pr0_offsets(name, sim)
        slots = [s for s in range(est.cfg.nb)
                 if bias.active[s] and bias.key[s]
                 and bias.key[s][0] == "cor"]
        got["corrections"] = len(slots)
        if len(slots) < 6:
            fails.append(f"{len(slots)} correction biases (at least 6)")
        else:
            check("correction_m", max(
                abs(-pb[s] * _LAMBDA_L1 - offsets[bias.key[s][1]])
                for s in slots), bound["correction_m"],
                "correction bias error m")
    if "last_attitude_rad" in bound:
        fi = est.frame_count - 1
        dth = lie.quat_boxminus(
            torch.from_numpy(np.asarray(est.x.q[fi], dtype=np.float64)),
            torch.from_numpy(sim.q[_nearest(sim, est.frame_times[fi])]))
        check("last_attitude_rad", float(torch.linalg.norm(dth)),
              bound["last_attitude_rad"], "last attitude error rad")
    if "last10_m" in bound:
        if not est.rtk_fixed:
            fails.append("no fixed solution at the end")
        wrong = [(i, r, n) for (i, r, n) in est._last_fix
                 if n != int(sim.rtk_ambiguities[bias.key[i][1]]
                             - sim.rtk_ambiguities[bias.key[r][1]])]
        if not est._last_fix or wrong:
            fails.append(f"fixed double differences {wrong or 'none'} are "
                         f"not the simulated integers")
        check("last10_m", float(errs[-10:].max()), bound["last10_m"],
              "last 10 frames' error m")
    return got, fails
