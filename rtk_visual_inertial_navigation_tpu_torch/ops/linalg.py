"""Cholesky with JAX's failure semantics.

``jnp.linalg.cholesky`` returns a NaN factor for a non-SPD input, and the
solver's NaN guards (dogleg step, chain solves) rely on that.
``torch.linalg.cholesky`` raises instead and syncs the host, so the port
factors with ``cholesky_ex`` and masks failed factorizations to NaN.

On CUDA the f32 step of the window solves (and ``tail_cov``) no longer
reaches this module: ``solver/gauss_newton.py::_chol_solve_scaled`` factors
and solves f32 systems with the batched Cholesky kernels
(``ops/pallas_chol_lanes.py``).  The callers left are its f64 branch,
``solver/marginalization.py::spd_solve`` (f32 and f64, d > 16) and the
small covariance factor of ``factors/inertial.py``.
"""

from __future__ import annotations

import torch


def cholesky_nan(A):
    """Lower Cholesky factor of (..., n, n), NaN where factorization fails."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def cho_solve(L, b):
    """Solve (L Lᵀ) x = b for b (..., n) or (..., n, k)."""
    if b.dim() == L.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)
