"""Explicit SPD inverses for small static dimensions (d <= 32).

Recursive 2x2 block-Schur inversion, a handful of batched matmuls for the
15x15 systems the chain monoid solves thousands of ways:

    inv([[A, B], [Bᵀ, C]]) = [[A⁻¹ + W S⁻¹ Wᵀ, -W S⁻¹],
                              [-S⁻¹ Wᵀ,         S⁻¹   ]]
    with W = A⁻¹B,  S = C - Bᵀ W   (SPD Schur complement)

Base cases are closed-form adjugate inverses (d <= 3).  Like unpivoted
Cholesky this is fine for SPD inputs; callers pre-scale by 1/sqrt(diag)
(spd_solve_small), and the dogleg loop NaN-guards degenerate steps.
"""

from __future__ import annotations

import torch


def _inv1(M):
    return 1.0 / M


def _guard_det(det):
    tiny = torch.finfo(det.dtype).tiny
    return 1.0 / torch.where(det.abs() < tiny, tiny, det)


def _inv2(M):
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    inv_det = _guard_det(a * d - b * c)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def _inv3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = _guard_det(a * A + b * B + c * C)
    adj = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return adj * inv_det[..., None, None]


def spd_inv_small(M):
    """Explicit inverse of a batched SPD matrix with SMALL static last dims."""
    d = M.shape[-1]
    if d == 1:
        return _inv1(M)
    if d == 2:
        return _inv2(M)
    if d == 3:
        return _inv3(M)
    k = (d + 1) // 2
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    C = M[..., k:, k:]
    Ai = spd_inv_small(A)
    W = Ai @ B                                     # (…, k, d-k)
    S = C - B.transpose(-1, -2) @ W
    Si = spd_inv_small(S)
    WSi = W @ Si
    TL = Ai + WSi @ W.transpose(-1, -2)
    top = torch.cat([TL, -WSi], dim=-1)
    bot = torch.cat([-WSi.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_solve_small(M, rhs, refine: int = 0):
    """Jacobi-scaled explicit-inverse solve for small SPD systems.

    ``rhs`` is (..., d) or (..., d, k).  ``refine``: optional iterative-
    refinement steps (residual matvecs against M)."""
    d_ = torch.diagonal(M, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp_min(d_, 1e-300))
    Ms = M * s[..., :, None] * s[..., None, :]
    r = rhs if rhs.dim() == M.dim() else rhs[..., None]
    rs = s[..., :, None] * r
    Mi = spd_inv_small(Ms)
    x = Mi @ rs
    for _ in range(refine):
        x = x + Mi @ (rs - Ms @ x)
    x = s[..., :, None] * x
    return x if rhs.dim() == M.dim() else x[..., 0]
