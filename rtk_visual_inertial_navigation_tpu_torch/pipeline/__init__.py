from .estimator import Estimator  # noqa: F401
from .replay import replay  # noqa: F401
