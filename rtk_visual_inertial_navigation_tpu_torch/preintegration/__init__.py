from .midpoint import (  # noqa: F401
    ImuNoise,
    Preintegrated,
    preintegrate,
    preintegrate_sequence,
    imu_residual,
)
