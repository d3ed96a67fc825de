"""Native (C++) runtime components, bound via ctypes.

  - ``mea_codec.cpp`` — GNSS epoch wire codec replacing the reference's
    memcpy-into-struct ingest (rvi/main3.cpp:154-168);
  - ``bag_reader.cpp`` — rosbag-2.0 container parser / replay data-loader
    (the reference's rosbag::View replay, rvi/main3.cpp:232-252), with
    native bz2 chunk decompression and zero-copy message access.

The sources are the JAX package's, unchanged.  Each is compiled by ``g++``
at first use into ``build/native/<stem>-<hash>.so`` at the root of the
checkout (the hash of the source and flags keeps a stale library from being
loaded).  A failed build raises.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "mea_codec.cpp"
_BAG_SRC = _HERE / "bag_reader.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
NFREQ = 2


def _bz2_link_flag() -> str:
    """Link against the bz2 runtime by its versioned name: images ship the
    runtime ``.so`` without the development symlink."""
    found = ctypes.util.find_library("bz2")
    return f"-l:{found}" if found else "-lbz2"


def _build(src: Path, stem: str, ldflags: tuple = ()) -> Path:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src),
           *ldflags]
    tag = hashlib.sha256(src.read_bytes() + " ".join(cmd).encode())
    out = BUILD_DIR / f"{stem}-{tag.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_lib = None
_bag_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build(_SRC, "mea_codec")))
        lib.mea_count_epochs.restype = ctypes.c_longlong
        lib.mea_count_epochs.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.mea_decode.restype = ctypes.c_int
        lib.mea_encode_epoch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _get_bag_lib():
    global _bag_lib
    if _bag_lib is None:
        lib = ctypes.CDLL(str(_build(_BAG_SRC, "bag_reader",
                                     (_bz2_link_flag(),))))
        lib.rvi_bag_open.restype = ctypes.c_void_p
        lib.rvi_bag_open.argtypes = [ctypes.c_char_p]
        lib.rvi_bag_count.restype = ctypes.c_longlong
        lib.rvi_bag_count.argtypes = [ctypes.c_void_p]
        lib.rvi_bag_topic_count.restype = ctypes.c_int
        lib.rvi_bag_topic_count.argtypes = [ctypes.c_void_p]
        lib.rvi_bag_topic_name.restype = ctypes.c_int
        lib.rvi_bag_topic_name.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.rvi_bag_msg.restype = ctypes.c_int
        lib.rvi_bag_msg.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.rvi_bag_close.restype = None
        lib.rvi_bag_close.argtypes = [ctypes.c_void_p]
        _bag_lib = lib
    return _bag_lib


def read_bag_native(path: str):
    """Native-parsed rosbag 2.0 -> time-sorted BagMessage list (drop-in for
    io.reference_bag.read_bag; C++ does container parsing + bz2)."""
    from ..io.reference_bag import BagMessage

    lib = _get_bag_lib()
    h = lib.rvi_bag_open(os.fspath(path).encode())
    if not h:
        raise ValueError(f"failed to parse rosbag 2.0 file: {path}")
    try:
        topics = []
        buf = ctypes.create_string_buffer(4096)
        for tid in range(lib.rvi_bag_topic_count(h)):
            lib.rvi_bag_topic_name(h, tid, buf, len(buf))
            topic, _, mtype = buf.value.decode().partition("\t")
            topics.append((topic, mtype))
        msgs = []
        tid = ctypes.c_int()
        t = ctypes.c_double()
        data = ctypes.POINTER(ctypes.c_ubyte)()
        dlen = ctypes.c_longlong()
        for i in range(lib.rvi_bag_count(h)):
            lib.rvi_bag_msg(h, i, ctypes.byref(tid), ctypes.byref(t),
                            ctypes.byref(data), ctypes.byref(dlen))
            topic, mtype = (topics[tid.value] if 0 <= tid.value < len(topics)
                            else ("?", "?"))
            msgs.append(BagMessage(
                topic, mtype, t.value,
                ctypes.string_at(data, dlen.value)))
        return msgs
    finally:
        lib.rvi_bag_close(h)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode_epochs(buf: bytes, max_obs: int = 64) -> dict:
    """Decode a wire-format byte stream into struct-of-arrays numpy dict."""
    lib = _get_lib()
    n = lib.mea_count_epochs(buf, len(buf))
    if n < 0:
        raise ValueError("mea wire format error")
    E, O, F = int(n), max_obs, NFREQ
    out = {
        "ros_time": np.zeros(E), "base_xyz": np.zeros((E, 3)),
        "br_time_diff": np.zeros(E), "obs_count": np.zeros(E, np.int32),
        "sat": np.zeros((E, O), np.int32), "sys": np.zeros((E, O), np.int32),
        "svh": np.zeros((E, O), np.int32),
        "sat_pos": np.zeros((E, O, 3)), "sat_vel": np.zeros((E, O, 3)),
        "el": np.zeros((E, O)), "sat_var": np.zeros((E, O)),
        "ion_var": np.zeros((E, O)), "trop_var": np.zeros((E, O)),
    }
    for k in ("spp_p", "spp_l", "spp_d", "spp_pstd", "spp_lstd", "spp_dstd",
              "rtk_p", "rtk_l", "rtk_pstd", "rtk_lstd", "spp_p0"):
        out[k] = np.zeros((E, O, F))
    for k in ("rtk_slip", "spp_slip", "half_flag"):
        out[k] = np.zeros((E, O, F), np.int32)

    rc = lib.mea_decode(
        buf, len(buf), O,
        _ptr(out["ros_time"]), _ptr(out["base_xyz"]),
        _ptr(out["br_time_diff"]), _ptr(out["obs_count"]),
        _ptr(out["sat"]), _ptr(out["sys"]), _ptr(out["svh"]),
        _ptr(out["sat_pos"]), _ptr(out["sat_vel"]), _ptr(out["el"]),
        _ptr(out["sat_var"]), _ptr(out["ion_var"]), _ptr(out["trop_var"]),
        _ptr(out["spp_p"]), _ptr(out["spp_l"]), _ptr(out["spp_d"]),
        _ptr(out["spp_pstd"]), _ptr(out["spp_lstd"]), _ptr(out["spp_dstd"]),
        _ptr(out["rtk_p"]), _ptr(out["rtk_l"]), _ptr(out["rtk_pstd"]),
        _ptr(out["rtk_lstd"]), _ptr(out["spp_p0"]), _ptr(out["rtk_slip"]),
        _ptr(out["spp_slip"]), _ptr(out["half_flag"]))
    if rc != 0:
        raise ValueError("mea decode failed")
    return out


def encode_epoch(ros_time: float, base_xyz, br_time_diff: float,
                 obs: dict) -> bytes:
    """Encode one epoch. ``obs`` holds per-obs arrays matching decode's
    per-(epoch,obs[,freq]) fields without the epoch axis."""
    lib = _get_lib()
    n = int(len(obs["sat"]))
    cap = 64 + n * 400
    out = np.zeros(cap, np.uint8)

    def arr(name, dtype=np.float64):
        return np.ascontiguousarray(obs[name], dtype=dtype)

    written = lib.mea_encode_epoch(
        ctypes.c_double(ros_time),
        _ptr(np.ascontiguousarray(base_xyz, dtype=np.float64)),
        ctypes.c_double(br_time_diff), ctypes.c_int(n),
        _ptr(arr("sat", np.int32)), _ptr(arr("sys", np.int32)),
        _ptr(arr("svh", np.int32)), _ptr(arr("sat_pos")),
        _ptr(arr("sat_vel")), _ptr(arr("el")), _ptr(arr("sat_var")),
        _ptr(arr("ion_var")), _ptr(arr("trop_var")), _ptr(arr("spp_p")),
        _ptr(arr("spp_l")), _ptr(arr("spp_d")), _ptr(arr("spp_pstd")),
        _ptr(arr("spp_lstd")), _ptr(arr("spp_dstd")), _ptr(arr("rtk_p")),
        _ptr(arr("rtk_l")), _ptr(arr("rtk_pstd")), _ptr(arr("rtk_lstd")),
        _ptr(arr("spp_p0")), _ptr(arr("rtk_slip", np.int32)),
        _ptr(arr("spp_slip", np.int32)), _ptr(arr("half_flag", np.int32)),
        _ptr(out), ctypes.c_longlong(cap))
    if written < 0:
        raise ValueError("encode buffer too small")
    return bytes(out[:written].tobytes())
