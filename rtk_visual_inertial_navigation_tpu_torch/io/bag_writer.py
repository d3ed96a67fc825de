"""Reference-format rosbag writer: the exact inverse of io/reference_bag.py.

Produces rosbag-2.0 files carrying the reference's four topics
(rvi/main3.cpp:232-252):

  - ``/imu``      sensor_msgs/Imu
  - ``/mag``      sensor_msgs/MagneticField
  - ``/feature``  sensor_msgs/PointCloud with channels [id, cam, u, v, vx, vy]
    and unit-plane points (x, y, 1) — the USE_FEATURE=1 precomputed-feature
    path (main3.cpp:186-206)
  - ``/gnss``     std_msgs/ByteMultiArray whose payload is a memcpy of the
    C++ ``mea_t`` struct (main3.cpp:154-168; layout
    rvi/gnss/include/common_function.h:73-125, replicated as MEA_DTYPE)

This is what lets the framework prove the reference's full data protocol
end-to-end without the released bags: simulate -> write a reference-format
bag -> replay through the estimator exactly as a real bag would be.

``sim_to_bag`` converts a sim.synthetic.SimData into such a bag plus a
ground-truth CSV in the reference's evaluate.py format (columns time,px,py,pz
at the ground-truth rate, prism-offset applied so the reference's hardcoded
``ptg`` correction round-trips, evaluate/evaluate.py:70,24-25).
"""

from __future__ import annotations

import struct

import numpy as np

from .reference_bag import MAXOBS, MEA_DTYPE

# ---------------------------------------------------------------------------
# rosbag 2.0 container writing
# ---------------------------------------------------------------------------
_MAGIC = b"#ROSBAG V2.0\n"


def _header(fields: dict) -> bytes:
    out = b""
    for name, value in fields.items():
        field = name.encode() + b"=" + value
        out += struct.pack("<I", len(field)) + field
    return out


def _record(hdr_fields: dict, data: bytes) -> bytes:
    hdr = _header(hdr_fields)
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _time_bytes(t: float) -> bytes:
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return struct.pack("<II", sec, nsec)


class BagWriter:
    """Minimal rosbag-2.0 writer (uncompressed or bz2 chunks).

    Records go into chunks; connection records are emitted both inside the
    first chunk and ahead of it so naive readers that don't scan chunks
    still find them.  Both framework readers (io/reference_bag.read_bag and
    native/bag_reader.cpp) and rosbag's own format accept this layout.
    """

    def __init__(self, path: str, compression: str = "none",
                 chunk_size: int = 4 << 20):
        assert compression in ("none", "bz2")
        self.path = path
        self.compression = compression
        self.chunk_size = chunk_size
        self._conns: dict[str, int] = {}
        self._conn_records: list[bytes] = []
        self._chunk: list[bytes] = []
        self._chunk_bytes = 0
        self._chunks_out: list[bytes] = []
        self._closed = False

    def _conn_id(self, topic: str, msg_type: str) -> int:
        cid = self._conns.get(topic)
        if cid is None:
            cid = len(self._conns)
            self._conns[topic] = cid
            sub = _header({"topic": topic.encode(),
                           "type": msg_type.encode(),
                           "md5sum": b"*",
                           "message_definition": b""})
            rec = _record({"op": b"\x07",
                           "conn": struct.pack("<I", cid),
                           "topic": topic.encode()}, sub)
            self._conn_records.append(rec)
            self._chunk.append(rec)
            self._chunk_bytes += len(rec)
        return cid

    def write(self, topic: str, msg_type: str, t: float, raw: bytes):
        cid = self._conn_id(topic, msg_type)
        rec = _record({"op": b"\x02",
                       "conn": struct.pack("<I", cid),
                       "time": _time_bytes(t)}, raw)
        self._chunk.append(rec)
        self._chunk_bytes += len(rec)
        if self._chunk_bytes >= self.chunk_size:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._chunk:
            return
        payload = b"".join(self._chunk)
        usize = len(payload)
        if self.compression == "bz2":
            import bz2
            data = bz2.compress(payload)
        else:
            data = payload
        self._chunks_out.append(_record(
            {"op": b"\x05",
             "compression": self.compression.encode(),
             "size": struct.pack("<I", usize)}, data))
        self._chunk = []
        self._chunk_bytes = 0

    def close(self):
        if self._closed:
            return
        self._flush_chunk()
        self._closed = True
        with open(self.path, "wb") as f:
            f.write(_MAGIC)
            # bag header record (op=0x03); readers here skip it, rosbag
            # tools want the field names present
            f.write(_record({"op": b"\x03",
                             "index_pos": struct.pack("<Q", 0),
                             "conn_count": struct.pack(
                                 "<I", len(self._conns)),
                             "chunk_count": struct.pack(
                                 "<I", len(self._chunks_out))}, b""))
            for rec in self._conn_records:
                f.write(rec)
            for rec in self._chunks_out:
                f.write(rec)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# message serializers (inverses of io/reference_bag.py parsers)
# ---------------------------------------------------------------------------
def _ros_header(t: float, frame_id: bytes = b"") -> bytes:
    return (struct.pack("<I", 0) + _time_bytes(t)
            + struct.pack("<I", len(frame_id)) + frame_id)


def serialize_imu(t: float, acc, gyr) -> bytes:
    """sensor_msgs/Imu: header, quat(4), cov(9), gyr(3), cov(9), acc(3),
    cov(9)."""
    z9 = np.zeros(9)
    parts = [_ros_header(t),
             np.asarray([0.0, 0.0, 0.0, 1.0]).tobytes(), z9.tobytes(),
             np.asarray(gyr, dtype="<f8").tobytes(), z9.tobytes(),
             np.asarray(acc, dtype="<f8").tobytes(), z9.tobytes()]
    return b"".join(parts)


def serialize_mag(t: float, mag) -> bytes:
    return (_ros_header(t) + np.asarray(mag, dtype="<f8").tobytes()
            + np.zeros(9).tobytes())


def serialize_feature_cloud(t: float, ids, cams, xy, uv=None,
                            vel=None) -> bytes:
    """sensor_msgs/PointCloud with the reference feature-topic layout:
    points (x, y, 1) unit-plane, channels [id, cam, u, v, vx, vy]."""
    ids = np.asarray(ids, dtype=float)
    n = len(ids)
    cams = np.zeros(n) if cams is None else np.asarray(cams, dtype=float)
    xy = np.asarray(xy, dtype=float).reshape(n, 2)
    uv = np.zeros((n, 2)) if uv is None else np.asarray(uv, dtype=float)
    vel = np.zeros((n, 2)) if vel is None else np.asarray(vel, dtype=float)
    pts = np.concatenate([xy, np.ones((n, 1))], axis=1).astype("<f4")
    chans = [ids, cams, uv[:, 0], uv[:, 1], vel[:, 0], vel[:, 1]]
    names = [b"id", b"cam", b"u", b"v", b"vx", b"vy"]
    parts = [_ros_header(t), struct.pack("<I", n), pts.tobytes(),
             struct.pack("<I", len(chans))]
    for name, c in zip(names, chans):
        parts += [struct.pack("<I", len(name)), name,
                  struct.pack("<I", n), np.asarray(c, dtype="<f4").tobytes()]
    return b"".join(parts)


def serialize_byte_multi_array(payload: bytes) -> bytes:
    """std_msgs/ByteMultiArray: empty layout + length-prefixed bytes."""
    return (struct.pack("<I", 0)          # layout.dim count
            + struct.pack("<I", 0)        # layout.data_offset
            + struct.pack("<I", len(payload)) + payload)


def encode_mea(t: float, base_xyz, obs_rows: list[dict],
               br_time_diff: float = 1.0) -> bytes:
    """Build one mea_t blob from per-satellite observation dicts.

    Each row dict may carry: sat, sys, svh, freq-indexed arrays (length 2)
    or scalars for f=0: pr, cp, dopp_cyc (cycles/s, reference sign), stds,
    rtk_pr, rtk_cp, pr0, plus sat_pos, sat_vel, el, ion/trop/sat_var and
    cumulative slip counters rtk_slip / spp_slip.
    """
    rec = np.zeros(1, dtype=MEA_DTYPE)[0]
    rec["obs_count"] = min(len(obs_rows), MAXOBS)
    rec["ros_time"] = t
    rec["base_xyz"] = np.asarray(base_xyz, dtype=float)
    rec["br_time_diff"] = br_time_diff

    def pair(v):
        a = np.zeros(2)
        v = np.atleast_1d(np.asarray(v, dtype=float))
        a[:min(2, len(v))] = v[:2]
        return a

    for i, row in enumerate(obs_rows[:MAXOBS]):
        o = rec["obs"][i]
        o["sat"] = int(row["sat"])
        o["sys"] = int(row.get("sys", 0))
        o["svh"] = int(row.get("svh", 0))
        for name in ("rtk_slip", "spp_slip", "half_flag"):
            o[name] = np.asarray(
                pair(row.get(name, 0)), dtype=np.uint8)
        o["spp_p"] = pair(row.get("pr", 0.0))
        o["spp_l"] = pair(row.get("cp", 0.0))
        o["spp_d"] = pair(row.get("dopp_cyc", 0.0))
        o["spp_pstd"] = pair(row.get("pr_std", 0.0))
        o["spp_lstd"] = pair(row.get("cp_std", 0.0))
        o["spp_dstd"] = pair(row.get("dopp_std_cyc", 0.0))
        o["rtk_p"] = pair(row.get("rtk_pr", 0.0))
        o["rtk_l"] = pair(row.get("rtk_cp", 0.0))
        o["rtk_pstd"] = pair(row.get("rtk_pr_std", row.get("pr_std", 0.0)))
        o["rtk_lstd"] = pair(row.get("rtk_cp_std", row.get("cp_std", 0.0)))
        o["spp_p0"] = pair(row.get("pr0", 0.0))
        o["sat_pos"] = np.asarray(row["sat_pos"], dtype=float)
        o["sat_vel"] = np.asarray(row.get("sat_vel", np.zeros(3)),
                                  dtype=float)
        o["el"] = float(row.get("el", 0.0))
        o["sat_var"] = float(row.get("sat_var", 0.0))
        o["ion_var"] = float(row.get("ion_var", 0.0))
        o["trop_var"] = float(row.get("trop_var", 0.0))
    return rec.tobytes()


# ---------------------------------------------------------------------------
# SimData -> reference bag + ground truth
# ---------------------------------------------------------------------------
def sim_to_bag(sim, bag_path: str, gt_path: str | None = None,
               compression: str = "none", prism_offset=None,
               gt_rate: float = 10.0, focal: float = 460.0,
               pr_std: float = 0.8, cp_std: float = 0.01,
               dopp_std: float = 0.1):
    """Write a SimData sequence as a reference-format bag (+ GT CSV).

    Only frequency 0 is written: the reference zeroes the second frequency
    on ingest (main3.cpp:159-165), so its shipped pipeline is single-freq.

    GT rows are written at ``gt_rate`` as (time, px, py, pz) with the prism
    offset applied (p_prism = p − R·ptg), matching the total-station
    protocol the reference's evaluate.py expects (evaluate.py:24-25,70).
    """
    lam = np.asarray(sim.wavelength)
    ch_sat = sim.ch_sat if sim.ch_sat is not None \
        else np.arange(sim.cfg.n_sats)
    ch_sys = sim.ch_sys if sim.ch_sys is not None \
        else np.zeros_like(ch_sat)
    ch_freq = sim.ch_freq if sim.ch_freq is not None \
        else np.zeros_like(ch_sat)
    f0 = np.flatnonzero(np.asarray(ch_freq) == 0)

    # elevation of each channel at each epoch, from the anchor
    anchor = np.asarray(sim.anchor_ecef)
    up = anchor / np.linalg.norm(anchor)

    events = []
    for k in range(len(sim.imu_t)):
        events.append((float(sim.imu_t[k]), 0, k))   # IMU (+mag)
    for fi in range(len(sim.cam_t)):
        events.append((float(sim.cam_t[fi]), 1, fi))  # features
    for ei in range(len(sim.gnss_t)):
        events.append((float(sim.gnss_t[ei]), 2, ei))  # gnss
    events.sort(key=lambda e: (e[0], e[1]))

    slip_count = np.zeros(len(ch_sat), dtype=int)
    n_feature_points = 0

    with BagWriter(bag_path, compression=compression) as bag:
        for t, kind, idx in events:
            if kind == 0:
                bag.write("/imu", "sensor_msgs/Imu", t,
                          serialize_imu(t, sim.acc[idx], sim.gyr[idx]))
                bag.write("/mag", "sensor_msgs/MagneticField", t,
                          serialize_mag(t, sim.mag[idx]))
            elif kind == 1:
                valid = sim.obs_valid[idx]
                ids = np.flatnonzero(valid)
                xy = sim.obs_xy[idx, ids]
                cams = np.zeros(len(ids))
                if sim.obs_valid_r is not None and \
                        np.asarray(sim.obs_valid_r).size:
                    vr = sim.obs_valid_r[idx]
                    ids_r = np.flatnonzero(vr)
                    if len(ids_r):
                        ids = np.concatenate([ids, ids_r])
                        xy = np.concatenate([xy, sim.obs_xy_r[idx, ids_r]])
                        cams = np.concatenate(
                            [cams, np.ones(len(ids_r))])
                uv = xy * focal + np.array([376.0, 240.0])
                n_feature_points += len(ids)
                bag.write("/feature", "sensor_msgs/PointCloud", t,
                          serialize_feature_cloud(t, ids, cams, xy, uv))
            else:
                ei = idx
                rows = []
                for c in f0:
                    if not sim.sat_valid[ei, c]:
                        slip_count[c] += 1   # outage counts as slip
                        continue
                    sp = sim.sat_pos[ei, ch_sat[c]]
                    sv = sim.sat_vel[ei, ch_sat[c]]
                    rng = sp - anchor
                    rng_u = rng / np.linalg.norm(rng)
                    el = np.arcsin(np.clip(rng_u @ up, -1, 1))
                    rows.append(dict(
                        sat=int(ch_sat[c]), sys=int(ch_sys[c]),
                        pr=float(sim.pr[ei, c]),
                        cp=float(sim.cp_cycles[ei, c]),
                        # reference doppler: cycles/s with z = −D·λ
                        dopp_cyc=-float(sim.dopp[ei, c]) / lam[c],
                        pr_std=pr_std, cp_std=cp_std,
                        dopp_std_cyc=dopp_std / lam[c],
                        rtk_pr=float(sim.rtk_pr[ei, c]),
                        rtk_cp=float(sim.rtk_cp[ei, c]),
                        pr0=float(sim.pr[ei, c]),
                        sat_pos=sp, sat_vel=sv, el=el,
                        rtk_slip=slip_count[c], spp_slip=slip_count[c],
                        # half-cycle resolved on both channels (bits 8|2,
                        # swf_gnss.cpp:112-114) — the sim has no half-cycle
                        # ambiguity, so its observations are always eligible
                        half_flag=10))
                blob = encode_mea(t, anchor, rows)
                bag.write("/gnss", "std_msgs/ByteMultiArray", t,
                          serialize_byte_multi_array(blob))

    if n_feature_points == 0 and len(sim.cam_t):
        # an all-empty feature topic silently degrades every "VI" replay
        # to IMU dead reckoning — fail loudly instead
        raise ValueError(
            "sim_to_bag: no visible landmarks in any camera frame "
            "(check landmark placement vs the p0-displaced trajectory)")

    if gt_path is not None:
        write_ground_truth(sim, gt_path, prism_offset=prism_offset,
                           gt_rate=gt_rate)
    return bag_path


def write_ground_truth(sim, gt_path: str, prism_offset=None,
                       gt_rate: float = 10.0):
    """Ground-truth CSV in the reference evaluate.py format: columns
    time,px,py,pz at gt_rate, positions at the PRISM (antenna − R·ptg)."""
    stride = max(1, int(round(sim.cfg.imu_rate / gt_rate)))
    idx = np.arange(0, len(sim.imu_t), stride)
    ptg = np.zeros(3) if prism_offset is None \
        else np.asarray(prism_offset, dtype=float)
    from ..ops import lie_np
    with open(gt_path, "w") as f:
        f.write("time,px,py,pz\n")
        for k in idx:
            p = np.asarray(sim.p[k])
            if ptg.any():
                R = lie_np.quat_to_rot(np.asarray(sim.q[k]))
                p = p - R @ ptg
            f.write(f"{sim.imu_t[k]:.9f},{p[0]:.6f},{p[1]:.6f},"
                    f"{p[2]:.6f}\n")
    return gt_path
