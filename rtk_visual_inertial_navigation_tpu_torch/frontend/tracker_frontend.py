"""Image-in, features-out frontend: the USE_FEATURE=0 path.

Combines the tracker (Shi-Tomasi + pyramidal LK + FB check + essential
RANSAC, `frontend.tracker`) with the host-side id management the reference
does in FeatureTracker::trackImage (rvi/feature/feature_tracker.cpp:75-230):
track existing features forward, drop failures, re-detect into freed slots
with suppression disks around live tracks, undistort through the camera
model, and emit (ids, unit-plane xy) for `Estimator.process_image`.

The pyramids, tracking, detection, suppression mask and RANSAC run on the
frontend's device (``cuda`` unless ``device="cpu"`` is passed; raises
without a GPU); the slots, ids and the camera model's lifting stay on the
host.  A frame reads the device three times: the tracked points, the
RANSAC inliers and the detected corners (four with a right image).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.cameras import PinholeCamera
from .tracker import (build_pyramid, lk_track_fb, ransac_hypotheses,
                      ransac_score, select_features, shi_tomasi_response)


def _host(xy, ok):
    """(xy (K, 2), ok (K,)) of the device read back in one copy."""
    both = torch.cat([xy, ok[:, None].to(xy.dtype)], dim=1).cpu().numpy()
    return both[:, :2], both[:, 2] != 0


def _lift(cam, pts) -> np.ndarray:
    """The camera's rays of host pixel coordinates (N, 2), on the host."""
    return cam.lift_projective(
        torch.from_numpy(np.asarray(pts, dtype=np.float64))).numpy()


class GyroPredictor:
    """Rotation-only LK initial guess from integrated gyro.

    The reference predicts each feature's next-frame pixel by propagating
    the estimator state and calls FeatureTracker::setPrediction with it
    (predictPtsInNextFrame + setPrediction, feature_tracker.cpp:98-117);
    between two frames the dominant motion for nearby features is camera
    ROTATION, which the gyro alone gives: integrate body angular rate over
    the inter-frame gap, map it through the camera extrinsic rotation, and
    rotate the previous unit-plane rays into the new camera frame.

    Usage (the replay/image driver loop):
        pred = GyroPredictor(cam, qic)
        ...
        pred.feed_imu(t, gyr)                  # every IMU sample
        guess = pred.predict(frontend)         # at each new image
        ids, xy = frontend.process(img, predicted=guess)
    """

    def __init__(self, camera: PinholeCamera, qic=None):
        from ..ops import lie_np
        self.cam = camera
        # body->cam rotation (R_ic): rays rotate by R_icᵀ R_rel R_ic
        self.R_ic = (np.asarray(lie_np.quat_to_rot(np.asarray(qic)))
                     if qic is not None else np.eye(3))
        self._last_t = None
        self._dtheta = np.zeros(3)

    def feed_imu(self, t: float, gyr: np.ndarray):
        if self._last_t is not None:
            self._dtheta = self._dtheta + np.asarray(gyr, dtype=float) \
                * (t - self._last_t)
        self._last_t = t

    def reset(self):
        self._dtheta = np.zeros(3)

    def predict(self, frontend: "TrackerFrontend") -> dict:
        """{feature_id: (x, y) pixel} for every live track, from the gyro
        rotation accumulated since the last call; resets the accumulator."""
        from ..ops import lie_np
        th = self.R_ic.T @ self._dtheta     # body rotation seen in cam
        self.reset()
        if not frontend.ok.any():
            return {}
        R_rel = np.asarray(lie_np.quat_to_rot(lie_np.quat_exp(th)))
        live = np.flatnonzero(frontend.ok)
        rays = _lift(frontend.cam, frontend.pts[live])
        # new_cam_ray = R_relᵀ ray (camera rotated by R_rel => scene
        # rotates the other way)
        rays2 = rays @ R_rel                 # == (R_relᵀ @ rays.T).T
        px = frontend.cam.space_to_plane(torch.from_numpy(rays2)).numpy()
        return {int(frontend.ids[s]): px[k]
                for k, s in enumerate(live)
                if np.isfinite(px[k]).all()}


class TrackerFrontend:
    def __init__(self, camera: PinholeCamera, max_cnt: int = 80,
                 min_dist: int = 12, levels: int = 3, win: int = 9,
                 iters: int = 12, fb_thresh: float = 0.75,
                 use_ransac: bool = True,
                 ransac_thresh: float = 3.0 / 460.0,
                 camera_right: Optional[PinholeCamera] = None,
                 device=None):
        self.cam = camera
        self.cam_r = camera_right or camera
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.levels = levels
        self.win = win
        self.iters = iters
        self.fb_thresh = fb_thresh
        self.use_ransac = use_ransac
        self.ransac_thresh = ransac_thresh
        self.device = resolve_device(device)

        self.pts = np.zeros((max_cnt, 2))
        self.ok = np.zeros(max_cnt, dtype=bool)
        self.ids = np.full(max_cnt, -1, dtype=np.int64)
        self._next_id = 0
        self._pyr_prev = None
        self._frame_no = 0

    def _dev(self, a):
        return torch.as_tensor(a).to(self.device)

    def _pyramid(self, img):
        return build_pyramid(
            torch.as_tensor(np.asarray(img), dtype=torch.float32)
            .to(self.device), self.levels)

    def _refill_mask(self, H: int, W: int):
        """(H, W) mask of the pixels farther than ``min_dist`` from every
        live point (squared distance in float64, as a host loop over the
        points would compute it).  Only the pixels of a box around each
        point can lie inside its disk, so each point tests its box and the
        pixels inside the disk are cleared in one scatter; the others, and
        the pixels off the image, write to a spare element."""
        mask = torch.ones(H * W + 1, dtype=torch.bool, device=self.device)
        live = self.pts[self.ok]
        if len(live):
            md = int(np.ceil(self.min_dist))
            p = self._dev(live)                                   # (M, 2)
            off = torch.arange(-md - 1, md + 2, device=self.device)
            ys = torch.floor(p[:, 1, None, None]).long() + off[:, None]
            xs = torch.floor(p[:, 0, None, None]).long() + off[None, :]
            inside = ((ys - p[:, 1, None, None]) ** 2
                      + (xs - p[:, 0, None, None]) ** 2) <= self.min_dist ** 2
            inside &= (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
            flat = torch.where(inside, ys * W + xs, H * W)
            mask[flat.reshape(-1)] = False
        return mask[:H * W].reshape(H, W)

    def process(self, img: np.ndarray, predicted: Optional[dict] = None,
                img_right: Optional[np.ndarray] = None):
        """Track one frame. Returns (ids (M,), unit_plane_xy (M,2)), or —
        when ``img_right`` is given — (ids, xy, ids_r (K,), xy_r (K,2)) with
        the stereo left→right matches appended (the reference's stereo LK
        with back-check, rvi/feature/feature_tracker.cpp:171-207).

        ``predicted``: optional {feature_id: (x, y) pixel} map of predicted
        positions (e.g. gyro-propagated, the reference's setPrediction path,
        feature_tracker.cpp:98-117) used as the LK initial guess.
        """
        pyr = self._pyramid(img)

        if self._pyr_prev is not None and self.ok.any():
            guess = self.pts.copy()
            if predicted:
                for slot in np.flatnonzero(self.ok):
                    g = predicted.get(int(self.ids[slot]))
                    if g is not None:
                        guess[slot] = g
            prev_pts = self.pts.copy()
            new, ok = lk_track_fb(self._pyr_prev, pyr, self._dev(self.pts),
                                  self._dev(self.ok), self.win, self.iters,
                                  self.fb_thresh, guess=self._dev(guess))
            self.pts, self.ok = _host(new, ok)
            # epipolar outlier gate on unit-plane coords (rejectWithF,
            # feature_tracker.cpp:265); with ≥ 12 valid points the gate is
            # on, so its mask is the inlier mask
            if self.use_ransac and self.ok.sum() >= 12:
                r0 = _lift(self.cam, prev_pts)[:, :2]
                r1 = _lift(self.cam, self.pts)[:, :2]
                idx = ransac_hypotheses(self.ok, seed=self._frame_no)
                inl, _ = ransac_score(self._dev(r0), self._dev(r1),
                                      self._dev(self.ok), self._dev(idx),
                                      self.ransac_thresh)
                self.ok &= inl.cpu().numpy()
            self.ids[~self.ok] = -1
        self._frame_no += 1

        # refill dead slots by re-detection with suppression around live pts
        n_live = int(self.ok.sum())
        if n_live < self.max_cnt:
            resp = shi_tomasi_response(pyr[0])
            H, W = np.asarray(img).shape
            fresh, fok = select_features(resp, self.max_cnt, self.min_dist,
                                         mask=self._refill_mask(H, W))
            fresh, fok = _host(fresh, fok)
            fi = 0
            for slot in np.flatnonzero(~self.ok):
                while fi < self.max_cnt and not fok[fi]:
                    fi += 1
                if fi >= self.max_cnt:
                    break
                self.pts[slot] = fresh[fi]
                self.ok[slot] = True
                self.ids[slot] = self._next_id
                self._next_id += 1
                fi += 1

        self._pyr_prev = pyr
        live = self.ok & (self.ids >= 0)
        rays = _lift(self.cam, self.pts[live])
        if img_right is None:
            return self.ids[live], rays[:, :2]

        # stereo: left→right pyramidal LK with forward-backward check
        # (feature_tracker.cpp:171-207; lk_track_fb's FB pass IS the
        # reference's reverse-flow check); matches give cam-1 observations
        pyr_r = self._pyramid(img_right)
        pts_r, ok_r = lk_track_fb(pyr, pyr_r, self._dev(self.pts),
                                  self._dev(live), self.win, self.iters,
                                  self.fb_thresh, guess=self._dev(self.pts))
        pts_r, ok_r = _host(pts_r, ok_r)
        ok_r &= live
        rays_r = _lift(self.cam_r, pts_r[ok_r])
        return (self.ids[live], rays[:, :2],
                self.ids[ok_r], rays_r[:, :2])
