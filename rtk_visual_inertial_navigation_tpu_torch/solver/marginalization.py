"""SPD solves, dense Schur marginalization and covariance-column export.

Inputs of the marginalization are the assembled (H, g) at the
linearization point and a boolean ``marg_mask`` over the global tangent.
Output is a square-root prior (J₀, r₀) over the full tangent with zero
columns at marginalized slots:

    H* = Hkk − Hkm Hmm⁻¹ Hmk,  g* = gk − Hkm Hmm⁻¹ gm
    eigh(H*) = V S Vᵀ;  J₀ = √S Vᵀ,  r₀ = √S⁻¹ Vᵀ g*

Eigenvalues below a threshold are truncated (rank-revealing pseudo-inverse,
matching marginalization_factor.cpp:335-349's eps=1e-8 treatment).  The
estimator marginalizes on the host in numpy (``*_np``): once per slide, on
the host-resident prior; the torch versions take any device.
"""

from __future__ import annotations

import numpy as np
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


def _masked_schur(H, g, marg_mask, jitter=1e-9):
    """Schur-complement away the masked slots without physical reordering
    (H (D, D), g (D,), marg_mask (D,) bool).

    Hmm is made unit-diagonal on non-marginalized slots so one dense solve
    against the full matrix implements the m-block inverse.
    """
    m = marg_mask.to(H.dtype)
    k = 1.0 - m
    Hmm_full = H * m[:, None] * m[None, :] + torch.diag(k) \
        + jitter * torch.diag(m)
    rhs = torch.cat([H * m[:, None] * k[None, :], (g * m)[:, None]], dim=1)
    sol = spd_solve(Hmm_full, rhs)                      # Hmm⁻¹ [Hmk, gm]
    Hmk_sol, gm_sol = sol[:, :-1], sol[:, -1]
    Hkm = H * k[:, None] * m[None, :]
    H_star = H * k[:, None] * k[None, :] - Hkm @ Hmk_sol
    g_star = g * k - Hkm @ gm_sol
    # exact symmetry (the solve introduces asymmetry at roundoff)
    return 0.5 * (H_star + H_star.T), g_star


def prior_from_hessian(H_star, g_star, eig_eps=1e-8):
    """Square-root factorization (J₀, r₀) of a PSD information pair by an
    f64 (or ambient-dtype) eigendecomposition."""
    S, V = torch.linalg.eigh(H_star)
    ok = S > eig_eps
    root = torch.sqrt(torch.where(ok, S, 1.0))
    sqrt_S = root * ok
    inv_sqrt_S = torch.where(ok, 1.0 / root, 0.0)
    return sqrt_S[:, None] * V.T, inv_sqrt_S * (V.T @ g_star)


def marginalize_dense(H, g, marg_mask, eig_eps=1e-8):
    """Schur + square root.  Returns (J₀, r₀) over the full tangent; J₀
    has zero columns at marginalized slots, rows beyond the numerical rank
    are zero."""
    H_star, g_star = _masked_schur(H, g, marg_mask)
    return prior_from_hessian(H_star, g_star, eig_eps)


def masked_schur_np(H, g, marg_mask):
    """Host (numpy) masked Schur complement: eliminate masked slots from
    (H, g) without reordering; returns (H*, g*) with zero rows/cols at the
    eliminated slots.  Only the marginalized support is factored."""
    H = np.asarray(H, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    mask = np.asarray(marg_mask, dtype=bool)
    mi = np.flatnonzero(mask)
    ki = np.flatnonzero(~mask)
    if len(mi) == 0:
        return H.copy(), g.copy()
    Hmm = H[np.ix_(mi, mi)] + 1e-9 * np.eye(len(mi))
    rhs = np.concatenate([H[np.ix_(mi, ki)], g[mi][:, None]], axis=1)
    sol = np.linalg.solve(Hmm, rhs)
    Hkm = H[np.ix_(ki, mi)]
    Hkk = H[np.ix_(ki, ki)] - Hkm @ sol[:, :-1]
    gk = g[ki] - Hkm @ sol[:, -1]
    H_star = np.zeros_like(H)
    H_star[np.ix_(ki, ki)] = 0.5 * (Hkk + Hkk.T)
    g_star = np.zeros_like(g)
    g_star[ki] = gk
    return H_star, g_star


def marginalize_dense_np(H, g, marg_mask, eig_eps=1e-8, return_info=False):
    """Host (numpy/LAPACK) ``marginalize_dense``.

    ``return_info=True`` additionally returns the information form
    (H*, g*), which lets the prior skip the JᵀJ product at every later
    solve (MargPrior.H0).
    """
    H_star, g_star = masked_schur_np(H, g, marg_mask)
    J0, r0 = prior_from_hessian_np(H_star, g_star, eig_eps)
    if return_info:
        return J0, r0, H_star, g_star
    return J0, r0


def prior_from_hessian_np(H_star, g_star, eig_eps=1e-8):
    """Host (numpy/LAPACK) ``prior_from_hessian``, on the prior's SUPPORT
    only (rows with any information; eigh is O(n³))."""
    H_star = np.asarray(H_star, dtype=np.float64)
    g_star = np.asarray(g_star, dtype=np.float64)
    D = H_star.shape[0]
    sup = (np.abs(H_star).max(axis=1) > 0) | (g_star != 0)
    idx = np.flatnonzero(sup)
    if len(idx) == 0:
        return np.zeros((D, D)), np.zeros(D)
    Hs = H_star[np.ix_(idx, idx)]
    S, V = np.linalg.eigh(Hs)
    ok = S > eig_eps
    sqrt_S = np.sqrt(np.where(ok, S, 1.0)) * ok
    inv_sqrt_S = np.where(ok, 1.0 / np.sqrt(np.where(ok, S, 1.0)), 0.0)
    J0 = np.zeros((D, D))
    J0[np.ix_(idx, idx)] = sqrt_S[:, None] * V.T
    r0 = np.zeros(D)
    r0[idx] = inv_sqrt_S * (V.T @ g_star[idx])
    return J0, r0
