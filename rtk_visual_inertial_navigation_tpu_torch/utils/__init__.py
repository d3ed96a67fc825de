from .timing import TicToc, StageTimer  # noqa: F401
from .stats import RunningStats, print_statistics  # noqa: F401
