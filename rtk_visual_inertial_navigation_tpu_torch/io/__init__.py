from .writer import ResultWriter  # noqa: F401
from .evaluate import evaluate_trajectory, TrajectoryMetrics  # noqa: F401
