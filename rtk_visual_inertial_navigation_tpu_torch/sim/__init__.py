from .synthetic import SimConfig, SimData, simulate  # noqa: F401
