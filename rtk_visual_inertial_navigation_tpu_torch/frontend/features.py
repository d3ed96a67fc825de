"""Host-side landmark bookkeeping with fixed-capacity device views.

The fixed-capacity counterpart of FeatureManager's ``list<FeaturePerId>``
(rvi/feature/feature_manager.h:44-64): a slot table of NL landmarks whose
per-window observations live in dense masked arrays ``obs_xy (NL,NF,2)`` /
``obs_mask (NL,NF)``.  Slot allocation, track-length counting, the keyframe
parallax decision (addFeatureCheckParallax, feature_manager.cpp:40-101) and
window-shift compaction (removeBack/removeFront, cpp:362-416) are cheap
host-side numpy; everything the solves consume is a fixed-shape array.
"""

from __future__ import annotations

import numpy as np

# keyframe thresholds (parameters.h:22 FEATURE_CONTINUE=2;
# parameters.cpp MIN_PARALLAX ~10px/f on the unit plane)
MIN_PARALLAX = 10.0 / 460.0
FEATURE_CONTINUE = 2


class FeatureTable:
    def __init__(self, capacity: int, num_frames: int):
        self.nl = capacity
        self.nf = num_frames
        self.obs_xy = np.zeros((capacity, num_frames, 2))
        self.obs_mask = np.zeros((capacity, num_frames), dtype=bool)
        # right-camera (stereo) observations, cam id 1
        self.obs_xy_r = np.zeros((capacity, num_frames, 2))
        self.obs_mask_r = np.zeros((capacity, num_frames), dtype=bool)
        self.active = np.zeros(capacity, dtype=bool)      # slot in use
        self.solved = np.zeros(capacity, dtype=bool)      # has a valid 3-D point
        self.point = np.zeros((capacity, 3))
        # inverse-depth parameterization bookkeeping (USE_INVERSE_DEPTH=1):
        # host frame of each landmark = its first cam0 observation
        self.feature_id = np.full(capacity, -1, dtype=np.int64)
        self._id_to_slot: dict[int, int] = {}

    def host_frame(self, slot: int) -> int:
        """First cam0-observing frame of the slot (-1 if none)."""
        obs = np.flatnonzero(self.obs_mask[slot])
        return int(obs[0]) if len(obs) else -1

    # ------------------------------------------------------------------
    def add_frame(self, frame_idx: int, ids: np.ndarray, xys: np.ndarray,
                  ids_r=None, xys_r=None) -> int:
        """Insert one frame's observations. Returns #tracked (pre-existing).

        ``ids_r``/``xys_r``: optional right-camera (stereo) observations of
        the same frame."""
        tracked = 0
        for fid, xy in zip(ids, xys):
            slot = self._id_to_slot.get(int(fid))
            if slot is None:
                free = np.flatnonzero(~self.active)
                if len(free) == 0:
                    continue  # table full: drop new feature (MAX_CNT analog)
                slot = int(free[0])
                self.active[slot] = True
                self.solved[slot] = False
                self.feature_id[slot] = int(fid)
                self.obs_mask[slot] = False
                self.obs_mask_r[slot] = False
                self._id_to_slot[int(fid)] = slot
            else:
                tracked += 1
            self.obs_xy[slot, frame_idx] = xy[:2]
            self.obs_mask[slot, frame_idx] = True
        if ids_r is not None:
            for fid, xy in zip(ids_r, xys_r):
                slot = self._id_to_slot.get(int(fid))
                if slot is None:
                    continue          # stereo obs require a cam0 track
                self.obs_xy_r[slot, frame_idx] = xy[:2]
                self.obs_mask_r[slot, frame_idx] = True
        return tracked

    # ------------------------------------------------------------------
    def keyframe_decision(self, frame_idx: int) -> bool:
        """True -> marginalize-oldest; False -> drop-second-newest.

        Mirrors addFeatureCheckParallax: a frame is a keyframe when few
        features are tracked long, or when the parallax between the two
        previous frames is large.
        """
        if frame_idx < 2:
            return True
        f1, f2 = frame_idx - 2, frame_idx - 1
        both = self.obs_mask[:, f1] & self.obs_mask[:, f2] & self.active
        long_track = both & (self.obs_mask[:, :f1].sum(axis=1) >= FEATURE_CONTINUE)
        tracked_now = (self.obs_mask[:, frame_idx] & self.active).sum()
        if tracked_now < 20 or long_track.sum() < 20:
            return True
        if not np.any(both):
            return True
        par = np.linalg.norm(
            self.obs_xy[both, f2] - self.obs_xy[both, f1], axis=1)
        return float(np.mean(par)) >= MIN_PARALLAX

    # ------------------------------------------------------------------
    def remove_frame(self, frame_idx: int, last: int):
        """Delete observations of one frame and compact the window left of
        ``last`` (inclusive shift, removeBack/removeFront semantics)."""
        self.obs_xy[:, frame_idx:last] = self.obs_xy[:, frame_idx + 1:last + 1]
        self.obs_mask[:, frame_idx:last] = self.obs_mask[:, frame_idx + 1:last + 1]
        self.obs_mask[:, last] = False
        self.obs_xy_r[:, frame_idx:last] = \
            self.obs_xy_r[:, frame_idx + 1:last + 1]
        self.obs_mask_r[:, frame_idx:last] = \
            self.obs_mask_r[:, frame_idx + 1:last + 1]
        self.obs_mask_r[:, last] = False
        self._prune()

    def _prune(self):
        """Free slots whose tracks died (no observations left)."""
        dead = self.active & (self.obs_mask.sum(axis=1) == 0)
        for slot in np.flatnonzero(dead):
            self._id_to_slot.pop(int(self.feature_id[slot]), None)
        self.active[dead] = False
        self.solved[dead] = False
        self.feature_id[dead] = -1

    def drop_slots(self, slots: np.ndarray):
        for slot in np.atleast_1d(slots):
            if self.active[slot]:
                self._id_to_slot.pop(int(self.feature_id[slot]), None)
        self.active[slots] = False
        self.solved[slots] = False
        self.obs_mask[slots] = False
        self.obs_mask_r[slots] = False
        self.feature_id[slots] = -1

    # ------------------------------------------------------------------
    def observation_batch(self, max_obs: int, stereo: bool = False):
        """Flatten (slot, frame) observations of solved landmarks into fixed-
        capacity factor arrays (frame_ids, cam_ids, lm_ids, xy, valid).

        With ``stereo``, right-camera observations append as cam id 1 rows
        (world-point parameterization treats them as plain projection
        factors through the second extrinsic)."""
        live = self.active[:, None] & self.solved[:, None]
        lm, fr = np.nonzero(self.obs_mask & live)
        cams = [np.zeros(len(lm), dtype=np.int32)]
        lms, frs, xys = [lm], [fr], [self.obs_xy[lm, fr]]
        if stereo:
            lm2, fr2 = np.nonzero(self.obs_mask_r & live)
            lms.append(lm2)
            frs.append(fr2)
            cams.append(np.ones(len(lm2), dtype=np.int32))
            xys.append(self.obs_xy_r[lm2, fr2])
        lm = np.concatenate(lms)
        fr = np.concatenate(frs)
        cam = np.concatenate(cams)
        xy_all = np.concatenate(xys) if len(lm) else np.zeros((0, 2))
        n = min(len(lm), max_obs)
        frame_ids = np.zeros(max_obs, dtype=np.int32)
        cam_ids = np.zeros(max_obs, dtype=np.int32)
        lm_ids = np.zeros(max_obs, dtype=np.int32)
        xy = np.zeros((max_obs, 2))
        valid = np.zeros(max_obs, dtype=bool)
        frame_ids[:n] = fr[:n]
        cam_ids[:n] = cam[:n]
        lm_ids[:n] = lm[:n]
        xy[:n] = xy_all[:n]
        valid[:n] = True
        return frame_ids, cam_ids, lm_ids, xy, valid

    def invdepth_batch(self, max_obs: int, stereo: bool = False):
        """(host, obs, cam, slot, host_xy, meas_xy, valid) rows for the
        inverse-depth parameterization: host = first cam0 observation; one
        row per additional observation.  Stereo adds same-frame cam1 rows
        (host==obs, cam=1) and cross-frame cam1 rows."""
        rows = []
        for slot in np.flatnonzero(self.active & self.solved):
            obs = np.flatnonzero(self.obs_mask[slot])
            if len(obs) == 0:
                continue
            h = int(obs[0])
            hxy = self.obs_xy[slot, h]
            for j in obs[1:]:
                rows.append((h, int(j), 0, slot, hxy,
                             self.obs_xy[slot, j]))
            if stereo:
                for j in np.flatnonzero(self.obs_mask_r[slot]):
                    if j < h:
                        continue
                    rows.append((h, int(j), 1, slot, hxy,
                                 self.obs_xy_r[slot, j]))
        n = min(len(rows), max_obs)
        host = np.zeros(max_obs, dtype=np.int32)
        obs_f = np.zeros(max_obs, dtype=np.int32)
        cam = np.zeros(max_obs, dtype=np.int32)
        slot_ids = np.zeros(max_obs, dtype=np.int32)
        hxy = np.zeros((max_obs, 2))
        mxy = np.zeros((max_obs, 2))
        valid = np.zeros(max_obs, dtype=bool)
        for k in range(n):
            host[k], obs_f[k], cam[k], slot_ids[k], hxy[k], mxy[k] = rows[k]
        valid[:n] = True
        return host, obs_f, cam, slot_ids, hxy, mxy, valid
