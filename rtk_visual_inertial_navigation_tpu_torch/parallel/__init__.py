from .mesh import batched_vi_solve  # noqa: F401
from .problems import (VIWindowProblem, make_synthetic_windows,  # noqa: F401
                       vi_problem_from_numpy)
