"""Earth constants of the ported slice, and the anchor-frame helper.

Only what the flagship solve needs: the GNSS factors' speed of light and
earth rotation rate, and a numpy ECEF -> geodetic conversion for the
synthetic anchor frame (a private copy: the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import numpy as np

CLIGHT = 299792458.0          # speed of light [m/s]
OMGE = 7.2921151467e-5        # earth angular velocity (IS-GPS) [rad/s]
RE_WGS84 = 6378137.0          # WGS84 semimajor axis [m]
FE_WGS84 = 1.0 / 298.257223563  # WGS84 flattening


def _ecef_to_geodetic_np(r, iters: int = 8):
    """(lat, lon, h) of an ECEF point, fixed-point iteration in numpy."""
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
