"""Reference rosbag ingestion without ROS.

The reference node replays a rosbag directly (rvi/main3.cpp:232-252) with
four topics: IMU (sensor_msgs/Imu), magnetometer (sensor_msgs/MagneticField),
precomputed feature tracks (sensor_msgs/PointCloud, channels
[id, cam, u, v, vx, vy], main3.cpp:186-206) and GNSS epochs as a
std_msgs/ByteMultiArray whose payload is a raw memcpy of the C++ ``mea_t``
struct (main3.cpp:154-168; layout at rvi/gnss/include/common_function.h:73-125).

This module reads those bags with zero dependencies:
  - a minimal rosbag-2.0 container parser (records, connections, chunks;
    'none' and 'bz2' chunk compression — bz2 is stdlib; lz4 raises),
  - hand-rolled deserializers for the four message types,
  - a numpy structured dtype replicating the compiler layout of ``mea_t``
    (x86-64, natural alignment) to decode GNSS blobs,
  - conversion to the framework's GnssEpoch rows (frequency axis flattened,
    doppler converted from cycles/s to range-rate m/s with the reference's
    sign convention, slip booleans derived from the slip counters).
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..geodesy.earth import WAVELENGTHS
from ..gnss.preprocess import GnssEpoch

MAXOBS = 64
NFREQ = 2

# ---------------------------------------------------------------------------
# mea_t compiler layout (x86-64): 9 leading u8 fields pad to 16 before the
# first double; three trailing PBtype*[2] pointer arrays (48 bytes) are
# opaque; mea_t itself has 4 pad bytes after obs_count and two opaque
# pointers before br_time_diff.
# ---------------------------------------------------------------------------
OBS_DTYPE = np.dtype([
    ("sat", "u1"), ("sys", "u1"), ("svh", "u1"),
    ("rtk_slip", "u1", (NFREQ,)), ("spp_slip", "u1", (NFREQ,)),
    ("half_flag", "u1", (NFREQ,)),
    ("_pad0", "V7"),
    ("spp_p", "<f8", (NFREQ,)), ("spp_l", "<f8", (NFREQ,)),
    ("spp_d", "<f8", (NFREQ,)),
    # field order in the struct is Lstd then Pstd (common_function.h:85-87)
    ("spp_lstd", "<f8", (NFREQ,)), ("spp_pstd", "<f8", (NFREQ,)),
    ("spp_dstd", "<f8", (NFREQ,)),
    ("rtk_p", "<f8", (NFREQ,)), ("rtk_l", "<f8", (NFREQ,)),
    ("rtk_pstd", "<f8", (NFREQ,)), ("rtk_lstd", "<f8", (NFREQ,)),
    ("spp_p0", "<f8", (NFREQ,)),
    ("sat_pos", "<f8", (3,)), ("sat_vel", "<f8", (3,)),
    ("el", "<f8"), ("sat_var", "<f8"), ("ion_var", "<f8"),
    ("trop_var", "<f8"),
    ("_ptrs", "V48"),
])
assert OBS_DTYPE.itemsize == 320, OBS_DTYPE.itemsize

MEA_DTYPE = np.dtype([
    ("obs_count", "<i4"), ("_pad0", "V4"), ("ros_time", "<f8"),
    ("obs", OBS_DTYPE, (MAXOBS,)),
    ("base_xyz", "<f8", (3,)),
    ("_ptrs", "V16"),
    ("br_time_diff", "<f8"),
])
assert MEA_DTYPE.itemsize == 16 + 320 * MAXOBS + 24 + 16 + 8


def decode_mea_blob(blob: bytes) -> np.void:
    """Decode one ByteMultiArray payload into a mea_t record (short blobs
    zero-pad, mirroring the memset+partial-copy ingest at main3.cpp:154)."""
    buf = np.zeros(MEA_DTYPE.itemsize, dtype=np.uint8)
    n = min(len(blob), MEA_DTYPE.itemsize)
    buf[:n] = np.frombuffer(blob[:n], dtype=np.uint8)
    return buf.view(MEA_DTYPE)[0]


class SlipTracker:
    """Derive per-(sat,freq,kind) slip booleans from the cumulative slip
    counters carried in the struct."""

    def __init__(self):
        self.last: dict = {}

    def slipped(self, kind: str, sat: int, f: int, count: int) -> bool:
        key = (kind, sat, f)
        prev = self.last.get(key)
        self.last[key] = count
        return prev is not None and count != prev


def mea_to_epoch(rec: np.void, tracker: Optional[SlipTracker] = None,
                 single_freq: bool = True) -> GnssEpoch:
    """Flatten one mea_t record into GnssEpoch rows.

    ``single_freq``: the reference zeroes the second frequency on ingest
    (main3.cpp:159-164); set False to keep both.
    """
    tracker = tracker or SlipTracker()
    n = int(rec["obs_count"])
    n = max(0, min(n, MAXOBS))
    rows = {k: [] for k in
            ("sat_id", "sys", "freq", "sat_pos", "sat_vel", "pr", "cp",
             "dopp", "rtk_pr", "rtk_cp", "pr_std", "cp_std", "dopp_std",
             "slip", "pr0", "svh", "ion_var", "trop_var", "sat_var", "el",
             "rtk_pr_std", "rtk_cp_std", "half_flag")}
    nf = 1 if single_freq else NFREQ
    for i in range(n):
        o = rec["obs"][i]
        sat, sys = int(o["sat"]), int(o["sys"])
        if sys > 2:
            continue
        for f in range(nf):
            lam = float(WAVELENGTHS[sys, min(f, 1)])
            slip = (tracker.slipped("rtk", sat, f, int(o["rtk_slip"][f]))
                    or tracker.slipped("spp", sat, f, int(o["spp_slip"][f])))
            pr = float(o["spp_p"][f])
            cp = float(o["spp_l"][f])
            dopp_cyc = float(o["spp_d"][f])
            rows["sat_id"].append(sat)
            rows["sys"].append(sys)
            rows["freq"].append(f)
            rows["sat_pos"].append(np.asarray(o["sat_pos"]))
            rows["sat_vel"].append(np.asarray(o["sat_vel"]))
            rows["pr"].append(pr if pr != 0.0 else np.nan)
            rows["cp"].append(cp if cp != 0.0 else np.nan)
            # reference doppler is cycles/s with r = ρ̇ + dṫ + D·λ
            # (gnss_factor.cpp:174-212) => measured range-rate z = −D·λ
            rows["dopp"].append(-dopp_cyc * lam if dopp_cyc != 0.0
                                else np.nan)
            rtk_p = float(o["rtk_p"][f])
            rtk_l = float(o["rtk_l"][f])
            rows["rtk_pr"].append(rtk_p if rtk_p != 0.0 else np.nan)
            rows["rtk_cp"].append(rtk_l if rtk_l != 0.0 else np.nan)
            rows["pr_std"].append(float(o["spp_pstd"][f]))
            rows["cp_std"].append(float(o["spp_lstd"][f]))
            rows["dopp_std"].append(
                max(float(o["spp_dstd"][f]) * lam, 1e-3))
            rows["slip"].append(slip)
            p0 = float(o["spp_p0"][f])
            rows["pr0"].append(p0 if p0 != 0.0 else np.nan)
            rows["svh"].append(int(o["svh"]))
            rows["ion_var"].append(float(o["ion_var"]))
            rows["trop_var"].append(float(o["trop_var"]))
            rows["sat_var"].append(float(o["sat_var"]))
            rows["el"].append(float(o["el"]))
            rows["rtk_pr_std"].append(float(o["rtk_pstd"][f]))
            rows["rtk_cp_std"].append(float(o["rtk_lstd"][f]))
            rows["half_flag"].append(int(o["half_flag"][f]))

    def arr(k, dtype=float):
        v = np.asarray(rows[k], dtype=dtype)
        return v if v.ndim else v.reshape(0)

    return GnssEpoch(
        t=float(rec["ros_time"]),
        sat_id=arr("sat_id", np.int64), sys=arr("sys", np.int64),
        freq=arr("freq", np.int64),
        sat_pos=np.asarray(rows["sat_pos"], dtype=float).reshape(-1, 3),
        sat_vel=np.asarray(rows["sat_vel"], dtype=float).reshape(-1, 3),
        pr=arr("pr"), cp=arr("cp"), dopp=arr("dopp"),
        rtk_pr=arr("rtk_pr"), rtk_cp=arr("rtk_cp"),
        pr_std=arr("pr_std"), cp_std=arr("cp_std"),
        dopp_std=arr("dopp_std"), slip=arr("slip", bool),
        br_time_diff=float(rec["br_time_diff"]),
        pr0=arr("pr0"), svh=arr("svh", np.int64),
        ion_var=arr("ion_var"), trop_var=arr("trop_var"),
        sat_var=arr("sat_var"),
        rtk_pr_std=arr("rtk_pr_std"), rtk_cp_std=arr("rtk_cp_std"),
        half_flag=arr("half_flag", np.int64),
    )


# ---------------------------------------------------------------------------
# rosbag 2.0 container
# ---------------------------------------------------------------------------
_MAGIC = b"#ROSBAG V2.0\n"


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name.decode()] = value
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[tuple[dict, bytes]]:
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        hdr = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield hdr, data


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    t: float            # record (receive) time [s]
    raw: bytes          # serialized message body


def read_bag(path: str) -> list[BagMessage]:
    """Parse a rosbag 2.0 file into time-sorted raw messages."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise ValueError("not a rosbag 2.0 file")
    conns: dict[int, tuple[str, str]] = {}
    msgs: list[BagMessage] = []

    def handle(hdr: dict, data: bytes):
        op = hdr.get("op", b"\x00")[0]
        if op == 0x07:                      # connection
            cid = struct.unpack("<I", hdr["conn"])[0]
            sub = _parse_header(data)
            conns[cid] = (hdr["topic"].decode(),
                          sub.get("type", b"").decode())
        elif op == 0x02:                    # message data
            cid = struct.unpack("<I", hdr["conn"])[0]
            sec, nsec = struct.unpack("<II", hdr["time"])
            topic, mtype = conns.get(cid, ("?", "?"))
            msgs.append(BagMessage(topic, mtype, sec + 1e-9 * nsec, data))
        elif op == 0x05:                    # chunk
            comp = hdr.get("compression", b"none").decode()
            if comp == "none":
                payload = data
            elif comp == "bz2":
                payload = bz2.decompress(data)
            else:
                raise NotImplementedError(
                    f"chunk compression {comp!r} not supported "
                    "(only none/bz2)")
            for h2, d2 in _iter_records(payload):
                handle(h2, d2)

    for hdr, data in _iter_records(blob, len(_MAGIC)):
        handle(hdr, data)
    msgs.sort(key=lambda m: m.t)
    return msgs


# ---------------------------------------------------------------------------
# message deserializers (little-endian ROS serialization)
# ---------------------------------------------------------------------------
class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.buf, "<f8", n, self.off)
        self.off += 8 * n
        return v if n > 1 else float(v[0])

    def f32(self, n=1):
        v = np.frombuffer(self.buf, "<f4", n, self.off)
        self.off += 4 * n
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s

    def header(self):
        self.u32()                       # seq
        sec, nsec = self.u32(), self.u32()
        self.string()                    # frame_id
        return sec + 1e-9 * nsec


def parse_imu(raw: bytes):
    """sensor_msgs/Imu -> (stamp, acc (3,), gyr (3,))."""
    c = _Cursor(raw)
    t = c.header()
    c.f64(4)                             # orientation quaternion
    c.f64(9)
    gyr = np.asarray(c.f64(3))
    c.f64(9)
    acc = np.asarray(c.f64(3))
    return t, acc, gyr


def parse_mag(raw: bytes):
    """sensor_msgs/MagneticField -> (stamp, mag (3,))."""
    c = _Cursor(raw)
    t = c.header()
    mag = np.asarray(c.f64(3))
    return t, mag


def parse_byte_multi_array(raw: bytes) -> bytes:
    """std_msgs/ByteMultiArray -> payload bytes."""
    c = _Cursor(raw)
    ndim = c.u32()
    for _ in range(ndim):
        c.string()
        c.u32()
        c.u32()
    c.u32()                              # data_offset
    n = c.u32()
    return raw[c.off:c.off + n]


def parse_feature_cloud(raw: bytes):
    """sensor_msgs/PointCloud (feature topic) -> (stamp, ids, cams,
    unit_xy (N,2), uv (N,2), vel (N,2)); channel order [id, cam, u, v,
    vx, vy] per main3.cpp:186-206 (points carry x,y,1)."""
    c = _Cursor(raw)
    t = c.header()
    n = c.u32()
    pts = c.f32(3 * n).reshape(n, 3).astype(float) if n else \
        np.zeros((0, 3))
    nch = c.u32()
    chans = []
    for _ in range(nch):
        c.string()
        m = c.u32()
        chans.append(np.asarray(c.f32(m), dtype=float))
    ids = chans[0].astype(np.int64) if nch > 0 else np.zeros(0, np.int64)
    cams = chans[1].astype(np.int64) if nch > 1 else np.zeros(0, np.int64)
    uv = np.stack([chans[2], chans[3]], -1) if nch > 3 else np.zeros((n, 2))
    vel = np.stack([chans[4], chans[5]], -1) if nch > 5 else np.zeros((n, 2))
    return t, ids, cams, pts[:, :2], uv, vel


# ---------------------------------------------------------------------------
# high-level replay
# ---------------------------------------------------------------------------
def iter_bag_events(path: str, imu_topic="/imu", mag_topic="/mag",
                    gnss_topic="/gnss", feature_topic="/feature"):
    """Yield ('imu'|'mag'|'gnss'|'features', t, payload) in time order.

    Topic matching is by suffix so namespaced bags work; GNSS payloads are
    decoded mea_t records converted to GnssEpoch.  Container parsing + bz2
    go through the native C++ reader when it builds; falls back to the
    pure-Python parser otherwise."""
    def _read(p):
        try:
            from ..native import read_bag_native
            return read_bag_native(p)
        except ValueError:
            raise                # real parse error: both readers would fail
        except Exception:        # no toolchain: pure-Python container parse
            return read_bag(p)

    tracker = SlipTracker()
    for m in _read(path):
        if m.topic.endswith(imu_topic) or m.msg_type.endswith("Imu"):
            t, acc, gyr = parse_imu(m.raw)
            yield "imu", t, (acc, gyr)
        elif m.topic.endswith(mag_topic) or \
                m.msg_type.endswith("MagneticField"):
            t, mag = parse_mag(m.raw)
            yield "mag", t, mag
        elif m.topic.endswith(gnss_topic) or \
                m.msg_type.endswith("ByteMultiArray"):
            rec = decode_mea_blob(parse_byte_multi_array(m.raw))
            ep = mea_to_epoch(rec, tracker)
            yield "gnss", ep.t, ep
        elif m.topic.endswith(feature_topic) or \
                m.msg_type.endswith("PointCloud"):
            t, ids, cams, xy, uv, vel = parse_feature_cloud(m.raw)
            yield "features", t, (ids, cams, xy, uv, vel)


def replay_bag(path: str, est, **topics):
    """Feed a reference bag through an Estimator (the main3.cpp loop).

    Honors ``est.cfg.average_image``: the first N feature messages are
    dropped at the driver level while the IMU attitude average settles
    (the AVERAGE_IMAGE skip, rvi/main3.cpp:180 / swf_image.cpp:10)."""
    skip_images = int(getattr(est.cfg, "average_image", 0))
    n_images = 0
    for kind, t, payload in iter_bag_events(path, **topics):
        if kind == "imu":
            est.process_imu(t, payload[0], payload[1])
        elif kind == "mag":
            est.process_mag(t, payload)
        elif kind == "gnss":
            est.process_gnss(payload)
        elif kind == "features":
            n_images += 1
            if n_images <= skip_images:
                continue
            ids, cams, xy, uv, vel = payload
            sel = cams == 0
            sel_r = cams == 1
            est.process_image(t, ids[sel], xy[sel],
                              ids[sel_r] if sel_r.any() else None,
                              xy[sel_r] if sel_r.any() else None)
    return est
