"""Geodesy and GNSS geometry as batched torch functions.

Semantics follow the reference's RTKLIB-derived helpers
(rvi/gnss/src/common_function.cpp): WGS-84 constants, ECEF<->geodetic,
ENU rotation, azimuth/elevation, Sagnac-corrected range
(common_function.cpp:126-134) and Doppler range-rate with the Earth-rotation
term (common_function.cpp:411-421).  Every function broadcasts over leading
batch dims and takes float64 tensors; the host callers (the GNSS
preprocessor, the simulator) hand them CPU tensors.

The window solves never see 2.6e7 m numbers: ``factors/gnss.py`` works on
ranges reduced on the host against an f64 reference range
(``reduced_range``), so f32 keeps sub-mm accuracy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLIGHT = 299792458.0          # speed of light [m/s]
OMGE = 7.2921151467e-5        # earth angular velocity (IS-GPS) [rad/s]
RE_WGS84 = 6378137.0          # WGS84 semimajor axis [m]
FE_WGS84 = 1.0 / 298.257223563  # WGS84 flattening
AZELMIN = np.deg2rad(25.0)    # elevation mask (common_function.h:22)

# carrier wavelengths [m], rows = {GPS, BDS, GAL}, cols = 2 frequencies
# (values as common_function.cpp:4-8; these are physical constants c/f)
WAVELENGTHS = np.array(
    [
        [0.190293672798364871256993069437, 0.244210213424568250983881512184],
        [0.19203948631027648, 0.24834936958430670],
        [0.19029367279836487, 0.24834936958430670],
    ]
)

SYS_GPS, SYS_BDS, SYS_GAL = 0, 1, 2
MAXSATNUM = 39 + 37 + 31  # 107 (common_function.h:34-37)
NFREQ = 2
MAXOBS = 64


def _t(x):
    """A float64 tensor of ``x`` (tensors pass through; arrays are copied,
    so read-only ones are fine)."""
    return x if torch.is_tensor(x) else torch.tensor(
        np.asarray(x, dtype=np.float64))


def geodetic_to_ecef(lat, lon, h):
    """(lat, lon [rad], h [m]) -> ECEF xyz."""
    lat, lon, h = _t(lat), _t(lon), _t(h)
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    sinp, cosp = torch.sin(lat), torch.cos(lat)
    sinl, cosl = torch.sin(lon), torch.cos(lon)
    v = RE_WGS84 / torch.sqrt(1.0 - e2 * sinp * sinp)
    x = (v + h) * cosp * cosl
    y = (v + h) * cosp * sinl
    z = (v * (1.0 - e2) + h) * sinp
    return torch.stack([x, y, z], dim=-1)


def ecef_to_geodetic(r, iters: int = 8):
    """ECEF xyz -> (lat, lon, h).

    The reference iterates to 1e-4 convergence (common_function.cpp:111-123);
    a fixed iteration count converges the same (< 6 are needed).
    """
    r = _t(r)
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    r2 = r[..., 0] ** 2 + r[..., 1] ** 2
    z = r[..., 2]
    v = torch.full_like(z, RE_WGS84)
    for _ in range(iters):
        zk = z
        sinp = zk / torch.sqrt(r2 + zk * zk)
        v = RE_WGS84 / torch.sqrt(1.0 - e2 * sinp * sinp)
        z = r[..., 2] + v * e2 * sinp
    pole = torch.where(r[..., 2] > 0.0, math.pi / 2, -math.pi / 2).to(r)
    lat = torch.where(
        r2 > 1e-12, torch.arctan(z / torch.sqrt(torch.clamp_min(r2, 1e-12))),
        pole)
    lon = torch.where(r2 > 1e-12, torch.arctan2(r[..., 1], r[..., 0]),
                      torch.zeros_like(r2))
    h = torch.sqrt(r2 + z * z) - v
    return torch.stack([lat, lon, h], dim=-1)


def _ecef_to_geodetic_np(r, iters: int = 8):
    """(lat, lon, h) of one ECEF point, fixed-point iteration in numpy
    (the synthetic anchor frame of ``parallel/problems_gnss.py``)."""
    r = np.asarray(r, dtype=float)
    e2 = FE_WGS84 * (2.0 - FE_WGS84)
    r2 = r[0] ** 2 + r[1] ** 2
    z = r[2]
    v = RE_WGS84
    for _ in range(iters):
        zk = z
        sinp = zk / np.sqrt(r2 + zk * zk)
        v = RE_WGS84 / np.sqrt(1.0 - e2 * sinp * sinp)
        z = r[2] + v * e2 * sinp
    lat = np.arctan(z / np.sqrt(max(r2, 1e-12))) if r2 > 1e-12 \
        else (np.pi / 2 if r[2] > 0 else -np.pi / 2)
    lon = np.arctan2(r[1], r[0]) if r2 > 1e-12 else 0.0
    h = np.sqrt(r2 + z * z) - v
    return np.array([lat, lon, h])


def enu_rotation(lat, lon):
    """Rotation E s.t. enu = E @ ecef_vector (xyz2enu,
    common_function.cpp:150-162)."""
    lat, lon = _t(lat), _t(lon)
    sinp, cosp = torch.sin(lat), torch.cos(lat)
    sinl, cosl = torch.sin(lon), torch.cos(lon)
    row_e = torch.stack([-sinl, cosl, torch.zeros_like(sinl)], dim=-1)
    row_n = torch.stack([-sinp * cosl, -sinp * sinl, cosp], dim=-1)
    row_u = torch.stack([cosp * cosl, cosp * sinl, sinp], dim=-1)
    return torch.stack([row_e, row_n, row_u], dim=-2)


def ecef_to_enu(origin_llh, vec):
    """Rotate an ECEF displacement into ENU at geodetic origin (lat,lon,h)."""
    origin_llh, vec = _t(origin_llh), _t(vec)
    E = enu_rotation(origin_llh[..., 0], origin_llh[..., 1])
    return torch.einsum("...ij,...j->...i", E, vec)


def sat_azel(origin_llh, unit_rs):
    """Azimuth/elevation of the receiver->satellite unit vector.

    Semantics of satazel (common_function.cpp:86-100).
    Returns (az [0,2pi), el) stacked (..., 2).
    """
    enu = ecef_to_enu(origin_llh, unit_rs)
    horiz2 = enu[..., 0] ** 2 + enu[..., 1] ** 2
    az = torch.where(horiz2 < 1e-12, torch.zeros_like(horiz2),
                     torch.arctan2(enu[..., 0], enu[..., 1]))
    az = torch.where(az < 0, az + 2 * math.pi, az)
    el = torch.arcsin(torch.clamp(enu[..., 2], -1.0, 1.0))
    return torch.stack([az, el], dim=-1)


def sagnac_range(rr, rs):
    """Geometric range + Sagnac correction, and LOS unit vector e.

    distance() semantics (common_function.cpp:126-134): e points receiver-
    ward (rr - rs normalized), range r = |rr-rs| + OMGE*(xs*yr - ys*xr)/c.
    Returns (r, e).
    """
    rr, rs = _t(rr), _t(rs)
    d = rr - rs
    r = torch.linalg.norm(d, dim=-1)
    e = d / torch.clamp_min(r, 1e-9)[..., None]
    sag = OMGE * (rs[..., 0] * rr[..., 1] - rs[..., 1] * rr[..., 0]) / CLIGHT
    return r + sag, e


def reduced_range(x_local, d0, r0_unit, r0):
    """Range |(x_local + anchor) - rs| - r0, cancellation-free.

    d0 = anchor - rs, r0 = |d0| and r0_unit = d0/r0 are precomputed on the
    host in f64; x_local is the receiver relative to the anchor (O(km)).
    |d0+x| - r0 = (2 d0.x + |x|²) / (|d0+x| + r0), evaluated from O(km)
    terms only.  Also returns the LOS unit e = (d0+x)/|d0+x|.
    """
    proj = torch.sum(r0_unit * x_local, dim=-1)
    x2 = torch.sum(x_local * x_local, dim=-1)
    t = 2.0 * proj + x2 / r0
    delta = t / (1.0 + torch.sqrt(torch.clamp_min(1.0 + t / r0, 1e-12)))
    e = (r0_unit * r0[..., None] + x_local) / (r0 + delta)[..., None]
    return delta, e


def sagnac_term_local(x_local, anchor, rs):
    """The local part OMGE*(xs*y - ys*x)/c of the Sagnac correction at
    anchor + x; the anchor's own part is folded into the host-reduced
    measurement."""
    return OMGE * (rs[..., 0] * x_local[..., 1]
                   - rs[..., 1] * x_local[..., 0]) / CLIGHT


def range_rate(rr, rs, vr, vs):
    """Doppler range-rate with Earth-rotation term and LOS unit vector.

    velecitydistance semantics (common_function.cpp:411-421): rate =
    e.(vr - vs) + OMGE/c * (vs_y*x_r + y_s*vr_x - vs_x*y_r - x_s*vr_y),
    where e = (rr-rs)/|rr-rs|.
    """
    rr, rs, vr, vs = _t(rr), _t(rs), _t(vr), _t(vs)
    d = rr - rs
    r = torch.linalg.norm(d, dim=-1)
    e = d / torch.clamp_min(r, 1e-9)[..., None]
    rate = torch.sum(e * (vr - vs), dim=-1)
    sag = (OMGE / CLIGHT) * (
        vs[..., 1] * rr[..., 0] + rs[..., 1] * vr[..., 0]
        - vs[..., 0] * rr[..., 1] - rs[..., 0] * vr[..., 1]
    )
    return rate + sag, e
