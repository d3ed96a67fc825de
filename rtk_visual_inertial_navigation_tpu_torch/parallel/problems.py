"""Shared constants of the synthetic window problems.

Only the IMU noise model is ported so far; the VI-only sub-problem
generator of the JAX package is a later slice.
"""

from ..preintegration.midpoint import ImuNoise

IMU_NOISE = ImuNoise(0.05, 0.005, 5e-4, 5e-5)
