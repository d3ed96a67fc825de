from .gauss_newton import (  # noqa: F401
    assemble,
    assemble_gram,
    dogleg_solve,
    DoglegConfig,
)
from .marginalization import (marginalize_dense,  # noqa: F401
                              masked_cov_cols,
                              marginalize_dense_np, masked_schur_np,
                              prior_from_hessian,
                              prior_from_hessian_np, spd_solve)
