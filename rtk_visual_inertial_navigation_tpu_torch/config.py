"""Typed configuration.

Collapses the reference's two config tiers — compile-time #defines
(rvi/parameter/parameters.h:13-29) and runtime YAML via cv::FileStorage
(parameters.cpp:80-230) — into one dataclass.  The five navigation modes
(README.md:60-66) are expressed as factor-enable flags so one estimator
covers all of them (mode matrix in SURVEY.md §2.10).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .preintegration.midpoint import ImuNoise


@dataclass
class EstimatorConfig:
    # window capacities (FEATURE_WINDOW_SIZE=10, GNSS_WINDOW_SIZE=500,
    # parameters.h:17-19; we fold GNSS frames into the same frame axis)
    nf: int = 11                 # frame capacity (visual window + 1)
    nl: int = 96                 # landmark slots (MAX_CNT=350 analog)
    nb: int = 64                 # phase-bias slots
    max_obs: int = 640           # projection-factor capacity
    imu_capacity: int = 128      # IMU samples per interval
    max_sats: int = 32           # satellites per epoch capacity (MAXOBS=64)

    # mode flags (yaml matrix, SURVEY.md §2.10)
    use_imu: bool = True
    use_gnss: bool = False
    use_rtk: bool = False        # RB-SD carrier phase
    use_rtd: bool = False        # RB-SD pseudorange
    use_spp_phase: bool = False
    use_spp_correction: bool = False
    use_doppler: bool = False
    use_n_resolve: bool = False  # integer ambiguity fixing
    use_mag: bool = False            # USE_MAG_INIT_YAW: yaw bootstrap
    use_mag_correct_yaw: bool = False  # mag factors during optimization

    # IMU (BMI088 defaults, yaml:49-52)
    imu_noise: ImuNoise = field(
        default_factory=lambda: ImuNoise(0.05, 0.005, 5e-4, 5e-5))
    g: float = 9.81
    pbg: np.ndarray = field(default_factory=lambda: np.zeros(3))

    # camera extrinsics (body->cam), fixed unless estimate_extrinsic
    tic: np.ndarray = field(default_factory=lambda: np.zeros((2, 3)))
    qic: np.ndarray = field(
        default_factory=lambda: np.tile(np.array([1.0, 0, 0, 0]), (2, 1)))
    estimate_extrinsic: bool = False

    # solver (yaml:45-46, swf.cpp:25-29)
    max_iters: int = 8
    init_trust_radius: float = 1e4
    # inner linear-solve dtype: "same" (ambient f64) or "float32" (runs the
    # Jacobi-scaled Schur/Cholesky in f32, on the GPU through the batched
    # Cholesky kernels of ops/pallas_chol_lanes.py; costs/trust region
    # stay f64 — see DoglegConfig.step_dtype)
    solve_step_dtype: str = "same"
    # dogleg early exit: stop once an accepted step's cost decrease falls
    # below f_tol·cost (ceres function_tolerance default; the reference
    # runs stock ceres convergence tests inside its ≤8 iterations)
    solve_f_tol: float = 1e-6

    # visual parameterization (USE_INVERSE_DEPTH, parameters.h:25): world
    # points (shipped default) or per-landmark inverse depth hosted at the
    # first observing frame; USE_STEREO adds right-camera observations
    use_inverse_depth: bool = False
    use_stereo: bool = False
    # robust loss on visual factors: ceres::CauchyLoss(a) scale — applied
    # in the solve AND marginalization, matching the reference
    # (rvi/swf/swf_image.cpp:80-102, marginalization_factor.cpp:23-45).
    # 0 disables (pure least squares).
    cauchy_loss: float = 1.0

    # frontend
    min_triangulation_parallax: float = 0.02   # unit-plane
    reproj_outlier_thresh: float = 3.0 / 460.0
    init_depth: float = 5.0                    # INIT_DEPTH (parameters.h:27)

    # initialization
    average_imu: int = 60        # samples for attitude init (AVERAGE_IMU=400)
    # skip the first N visual measurements at the driver level
    # (AVERAGE_IMAGE, consumed in rvi/main3.cpp:180 / swf_image.cpp:10 —
    # the camera warms up while the IMU attitude average settles)
    average_image: int = 0

    # GNSS gating (swf.cpp:732-742: ≥8 healthy sats or drop epoch)
    min_sats_per_epoch: int = 8
    # GNSS geometry anchor (base station / ANCHOR_POINT, yaml:95): local
    # frame is ENU at this ECEF point; enu_to_ecef columns are E,N,U
    anchor_ecef: np.ndarray = field(default_factory=lambda: np.zeros(3))
    enu_to_ecef: np.ndarray = field(default_factory=lambda: np.eye(3))
    # per-kind GNSS factor capacities (rows across the whole window)
    max_gnss_pr: int = 256
    max_gnss_cp: int = 256
    max_gnss_dopp: int = 256
    initial_gnss_boost_epochs: int = 100

    # IMU-GNSS chain condensation (IMUGNSSBase, SURVEY.md §2.6): runs of
    # GNSS frames between visual frames leave the window into condensed
    # chains, extending the effective GNSS window far beyond nf (the
    # reference holds up to GNSS_WINDOW_SIZE=500 epochs this way).  ON by
    # default — this IS the reference's GNSS window regime (the IMUGNSS
    # factor forms whenever ≥1 GNSS frame sits between keyframes,
    # rvi/swf/swf.cpp:669-730); no-op without GNSS frames
    use_gnss_chains: bool = True
    chain_cap: int = 32          # max leaves per chain (GNSS_MAX_NUM=30)
    max_chains: int = 0          # 0 -> nf - 1
    max_chain_rows: int = 512    # GNSS observation rows per chain

    # integer ambiguity resolution (swf_lambda.cpp)
    fix_ratio_threshold: float = 2.0       # RATIO_THRESHOLD (yaml:40)
    min_dd_for_fix: int = 4                # ≥4 DD rows (swf_lambda.cpp:178)
    min_fix_continuity: int = 2            # CARRIER_PHASE_CONTINUE_THRESHOLD
    fix_continue_threshold: int = 40       # FIX_CONTINUE_THRESHOLD
    phase_all_reset_count: int = 100       # Phase_ALL_RESET_COUNT

    dtype: str = "float64"
