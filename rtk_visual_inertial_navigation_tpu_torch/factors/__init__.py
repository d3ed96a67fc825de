from .base import FactorBatch, manifold_res_jac  # noqa: F401
from . import visual, inertial, priors  # noqa: F401
