"""End-to-end demo: full RTK-VI replay on simulated data, on the GPU.

Runs the complete pipeline — IMU preintegration, feature tracking input,
GNSS preprocessing, sliding-window dogleg optimization, LAMBDA integer
ambiguity resolution, marginalization — and writes the same artifacts the
reference system produces:

  out/<mode>_result.csv   reference-schema CSV, one row per IMU sample
                          after initialization (the reference's
                          save_result protocol; its evaluate.py reads it)
  out/<mode>_viz.npz      trajectory + landmark cloud (rviz replacement)
  out/<mode>_viz.png      top-down plot, where matplotlib is installed
  stdout                  per-frame statistics + final accuracy metrics

Usage:
  python -m rtk_visual_inertial_navigation_tpu_torch.examples.run_sim_demo \\
      [--mode rtk|rtd|spp|spp_cp|vi] [--duration 10] [--noise] \\
      [--device cuda|cpu]

The window solves run on ``cuda`` unless ``--device cpu`` is given; without
a GPU the default raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import EstimatorConfig
from ..io import ResultWriter, evaluate_trajectory
from ..io.publish import Publisher
from ..ops import lie
from ..pipeline import Estimator
from ..sim import SimConfig, simulate
from ..sim.synthetic import gnss_epoch_of
from ..utils import StageTimer
from ..utils.stats import print_statistics

MODES = {
    "vi": dict(use_gnss=False),
    "spp": dict(use_gnss=True, use_doppler=True),
    "spp_cp": dict(use_gnss=True, use_doppler=True, use_spp_phase=True),
    "rtd": dict(use_gnss=True, use_doppler=True, use_rtd=True),
    "rtk": dict(use_gnss=True, use_doppler=True, use_rtd=True, use_rtk=True,
                use_n_resolve=True),
}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="rtk", choices=sorted(MODES))
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--noise", action="store_true")
    ap.add_argument("--chains", action="store_true",
                    help="condense GNSS runs between visual frames into "
                         "IMU-GNSS chains (IMUGNSSBase analog)")
    ap.add_argument("--gnss-rate", type=float, default=2.0)
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default=None,
                    help="where the window solves run (default cuda)")
    return ap


def main(argv=None) -> dict:
    """Run the demo with command-line arguments ``argv``; returns its
    results (mode, frames, CSV rows, metrics, timing report)."""
    args = _parser().parse_args(argv)

    noise = dict(pix_noise=1.0 / 460, acc_noise=0.02, gyr_noise=0.002,
                 pr_noise=0.5, cp_noise=0.01, dop_noise=0.1) \
        if args.noise else {}
    sim = simulate(SimConfig(duration=args.duration, imu_rate=200.0,
                             cam_rate=2.0, gnss_rate=args.gnss_rate,
                             n_landmarks=60,
                             n_sats=10, seed=0, **noise))

    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    cfg = EstimatorConfig(
        nf=10, nl=48, nb=32, max_obs=256, imu_capacity=128, average_imu=40,
        qic=np.tile(q_ic, (2, 1)), tic=np.tile(sim.cfg.t_ic, (2, 1)),
        anchor_ecef=sim.anchor_ecef, enu_to_ecef=sim.enu_to_ecef,
        max_gnss_pr=160, max_gnss_cp=160, max_gnss_dopp=160,
        min_sats_per_epoch=6, initial_gnss_boost_epochs=5,
        min_fix_continuity=1, fix_continue_threshold=3,
        use_gnss_chains=args.chains,
        **MODES[args.mode])
    est = Estimator(cfg, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    writer = ResultWriter(os.path.join(args.out, f"{args.mode}_result.csv"),
                          anchor_ecef=sim.anchor_ecef,
                          enu_to_ecef=sim.enu_to_ecef)
    est.attach_writer(writer)
    pub = Publisher()
    timer = StageTimer()

    ids = np.arange(sim.landmarks.shape[0])
    cam_ptr = g_ptr = 0
    n_frames = 0
    try:
        for i, t in enumerate(sim.imu_t):
            est.process_imu(t, sim.acc[i], sim.gyr[i])
            if i % 10 == 0:
                est.process_mag(t, sim.mag[i])
            if g_ptr < len(sim.gnss_idx) and sim.gnss_idx[g_ptr] == i:
                with timer.stage("gnss_frame"):
                    est.process_gnss(gnss_epoch_of(sim, g_ptr))
                g_ptr += 1
            if cam_ptr < len(sim.cam_idx) and sim.cam_idx[cam_ptr] == i:
                vis = sim.obs_valid[cam_ptr]
                with timer.stage("image_frame"):
                    est.process_image(t, ids[vis], sim.obs_xy[cam_ptr][vis])
                cam_ptr += 1
            if est.initialized and est.frame_count > 0 and \
                    len(est.trajectory) > n_frames:
                n_frames = len(est.trajectory)
                pub.pub_from_estimator(est)
                if n_frames % 10 == 0:
                    print(print_statistics(est))
    finally:
        writer.close()

    pub.save(os.path.join(args.out, f"{args.mode}_viz.npz"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {args.mode}_viz.png not "
              f"written")
    else:
        pub.plot(os.path.join(args.out, f"{args.mode}_viz.png"))

    est_t = np.asarray([o[0] for o in est.trajectory])
    est_p = np.asarray([o[1] for o in est.trajectory]).reshape(-1, 3)
    gt_idx = [np.argmin(np.abs(sim.imu_t - t)) for t in est_t]
    m = evaluate_trajectory(est_t, est_p, est_t, sim.p[gt_idx],
                            align=args.mode in ("vi", "spp", "spp_cp"))
    report = timer.report()
    print("\n=== timing ===")
    print(report)
    print(f"\n=== {args.mode.upper()} metrics over {len(est_t)} frames ===")
    print(f"plane RMSE : {m.plane_rmse:.4f} m")
    print(f"height RMSE: {m.height_rmse:.4f} m")
    print(f"3-D MAE    : {m.mae_3d:.4f} m")
    if args.mode == "rtk":
        print(f"rtk fixed  : {est.rtk_fixed}")
    if args.chains:
        print(f"chains     : {est._chain_stats} "
              f"(live {len(est.chains)})")
    print(f"artifacts in {args.out}/")
    # the IMU samples after the first solved frame: each has a CSV row
    n_after = int(np.sum(sim.imu_t > est_t[0])) if len(est_t) else 0
    return dict(mode=args.mode, initialized=bool(est.initialized),
                frames=int(len(est_t)), positions=est_p,
                csv_rows=int(writer.rows), imu_samples_after_first=n_after,
                plane_rmse=m.plane_rmse, height_rmse=m.height_rmse,
                mae_3d=m.mae_3d, rtk_fixed=bool(est.rtk_fixed),
                timing=report)


if __name__ == "__main__":
    main()
