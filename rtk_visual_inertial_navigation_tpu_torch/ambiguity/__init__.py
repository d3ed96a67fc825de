from .lambda_ils import (  # noqa: F401
    SearchOverflow,
    ld_factorization,
    lambda_reduction,
    ils_search,
    lambda_ils,
    ratio_test,
    partial_ratio_test,
)
from .dd import (  # noqa: F401
    choose_reference,
    double_difference,
    conditioned_fix,
    fix_differences,
)
