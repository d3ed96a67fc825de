from .mesh import batched_vi_solve, sharded_vi_solve  # noqa: F401
from .multihost import (distribute_local_problems,  # noqa: F401
                        distribute_local_rtk_problems, gather_rtk_results,
                        gather_vi_results, global_mesh, initialize_from_env,
                        multihost_rtk_solve, multihost_vi_solve)
from .problems import (VIWindowProblem, make_synthetic_windows,  # noqa: F401
                       vi_problem_from_numpy)
from .problems_gnss import (RTKWindowProblem,  # noqa: F401
                            batched_rtk_solve, make_synthetic_rtk_windows,
                            sharded_rtk_solve)
