from .evaluate import evaluate_trajectory, TrajectoryMetrics  # noqa: F401
