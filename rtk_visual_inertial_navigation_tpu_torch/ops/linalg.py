"""Cholesky with JAX's failure semantics.

``jnp.linalg.cholesky`` returns a NaN factor for a non-SPD input, and the
solver's NaN guards (dogleg step, chain solves) rely on that.
``torch.linalg.cholesky`` raises instead and syncs the host, so the port
factors with ``cholesky_ex`` and masks failed factorizations to NaN.
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
