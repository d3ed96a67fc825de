"""Load the reference's OpenCV-style YAML configs into EstimatorConfig.

A user of the reference can point this at any of the five shipped mode YAMLs
(yaml/*.yaml; readParameters semantics, rvi/parameter/parameters.cpp:80-230)
and get an equivalent EstimatorConfig.  Handles the ``%YAML:1.0`` header and
``!!opencv-matrix`` tags without OpenCV.  PyYAML is imported when a file is
loaded, so importing this module needs nothing beyond the port.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from ..config import EstimatorConfig
from ..geodesy import earth
from ..ops import lie
from ..preintegration.midpoint import ImuNoise


def _load_opencv_yaml(path: str) -> dict:
    import yaml

    text = Path(path).read_text()
    text = re.sub(r"^%YAML:1\.0\s*", "", text)
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text)


def _matrix(node, rows, cols):
    return np.asarray(node["data"], dtype=float).reshape(rows, cols)


def load_reference_config(path: str, **overrides) -> EstimatorConfig:
    """Build an EstimatorConfig from a reference-format YAML."""
    d = _load_opencv_yaml(path)

    anchor = _matrix(d["ANCHOR_POINT"], 3, 1).ravel() if "ANCHOR_POINT" in d \
        else np.zeros(3)
    llh = earth.ecef_to_geodetic(anchor).numpy()
    R_e = earth.enu_rotation(llh[0], llh[1]).numpy().T

    # camera extrinsics: body_T_cam (4x4) -> (tic, qic)
    tic = np.zeros((2, 3))
    qic = np.tile(np.array([1.0, 0, 0, 0]), (2, 1))
    for i, keyname in enumerate(("body_T_cam0", "body_T_cam1")):
        if keyname in d:
            T = _matrix(d[keyname], 4, 4)
            tic[i] = T[:3, 3]
            qic[i] = lie.rot_to_quat(torch.from_numpy(T[:3, :3])).numpy()

    pbg = _matrix(d["Pbg"], 3, 1).ravel() if "Pbg" in d else np.zeros(3)

    def flag(name, default=0):
        return bool(int(d.get(name, default)))

    cfg = EstimatorConfig(
        use_imu=flag("USE_IMU", 1),
        use_gnss=flag("USE_GNSS"),
        use_rtk=flag("USE_RTK"),
        use_rtd=flag("USE_RTD"),
        use_spp_phase=flag("USE_SPP_PHASE"),
        use_spp_correction=flag("USE_SPP_CORRECTION"),
        use_doppler=flag("USE_DOPPLER"),
        use_n_resolve=flag("USE_N_RESOLVE"),
        use_mag=flag("USE_MAG_INIT_YAW"),
        use_mag_correct_yaw=flag("USE_MAG_CORRECT_YAW"),
        estimate_extrinsic=flag("ESTIMATE_EXTRINSIC"),
        imu_noise=ImuNoise(
            acc_n=float(d.get("acc_n", 0.05)),
            gyr_n=float(d.get("gyr_n", 0.005)),
            acc_w=float(d.get("acc_w", 5e-4)),
            gyr_w=float(d.get("gyr_w", 5e-5))),
        g=float(d.get("g_norm", 9.8)),
        pbg=pbg, tic=tic, qic=qic,
        max_iters=int(d.get("MAX_NUM_ITERATIONS", 8)),
        init_trust_radius=float(d.get("MAX_TRUST_REGION_RADIUS", 1e4)),
        average_imu=int(d.get("AVERAGE_IMU", 400)),
        average_image=int(d.get("AVERAGE_IMAGE", 0)),
        anchor_ecef=anchor, enu_to_ecef=R_e,
        fix_continue_threshold=int(d.get("FIX_CONTINUE_THRESHOLD", 40)),
        min_fix_continuity=int(
            d.get("CARRIER_PHASE_CONTINUE_THRESHOLD", 10)),
        phase_all_reset_count=int(d.get("Phase_ALL_RESET_COUNT", 100)),
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
