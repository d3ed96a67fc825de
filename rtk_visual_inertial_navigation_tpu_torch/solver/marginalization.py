"""SPD solves and covariance-column export of the ported slice.

Only ``spd_solve`` and ``masked_cov_cols``; the dense Schur
marginalization of the JAX package is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.linalg import cholesky_nan


def spd_solve(M, rhs):
    """Jacobi-scaled Cholesky solve for SPD systems; rhs (..., d) or
    (..., d, k).

    Small systems (d <= 16, the chain monoid's 15x15 blocks) use the
    recursive block-Schur explicit inverse with one refinement pass.  In
    f32 the scaled system can reach condition ~1e10, where a plain f32
    Cholesky fails: the shifted system is factored instead and two
    refinement passes run against the true operator.
    """
    if M.shape[-1] <= 16:
        from ..ops.smallinv import spd_solve_small
        return spd_solve_small(M, rhs, refine=1)
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp_min(d, 1e-300))
    Ms = M * s[..., :, None] * s[..., None, :]
    r = rhs if rhs.dim() == M.dim() else rhs[..., None]
    rs = s[..., :, None] * r
    if Ms.dtype == torch.float32:
        shift = 1e-5
        eye = torch.eye(Ms.shape[-1], dtype=Ms.dtype, device=Ms.device)
        L = cholesky_nan(Ms + shift * eye)
        x = torch.cholesky_solve(rs, L)
        for _ in range(2):
            resid = rs - Ms @ x - shift * x
            x = x + torch.cholesky_solve(resid, L)
    else:
        L = cholesky_nan(Ms)
        x = torch.cholesky_solve(rs, L)
    x = s[..., :, None] * x
    return x if rhs.dim() == M.dim() else x[..., 0]


def masked_cov_cols(H, free, cols):
    """Selected covariance columns (..., D, k) of the masked information
    matrix.

    Solves (H restricted to free slots, unit diagonal elsewhere) X = E[:,
    cols].  Block-structured Hessians (solver/block_hessian.BlockHess)
    dispatch to their Schur-eliminated ``tail_cov`` (columns must lie in
    the reduced region, which the ambiguity tail always does).
    """
    if hasattr(H, "tail_cov"):
        return H.tail_cov(free, cols)
    m = free & (torch.diagonal(H, dim1=-2, dim2=-1) > 0)
    md = m.to(H.dtype)
    Hm = H * md[..., :, None] * md[..., None, :] + torch.diag_embed(1.0 - md)
    E = torch.zeros(H.shape[:-1] + (cols.shape[-1],), dtype=H.dtype,
                    device=H.device)
    E.scatter_(-2, cols[..., None, :], 1.0)
    return spd_solve(Hm, E)
