"""Batched Gauss-Newton / dogleg over the ordered tangent space.

Factor batches assemble into (H, g, cost); the trust region is Powell
dogleg with the reference's iteration budget (≤8, MAX_TRUST_REGION_RADIUS =
1e15).  Every tensor carries the window batch as leading dims, and the
loop is a Python loop of fixed length whose accept/reject decisions are
``torch.where`` selects per window: nothing in it reads a device value on
the host.  Masked factors contribute zeros; masked parameters get unit
diagonal and zero gradient, so their step is zero.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_map

from ..factors.base import FactorBatch
from ..ops.linalg import cho_solve, cholesky_nan


def one_hot(ids, n: int, dtype):
    """One-hot over the last axis; out-of-range ids (e.g. masked rows
    shifted negative) give all-zero rows, as ``jax.nn.one_hot`` does."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def assemble_gram(batches: Sequence[FactorBatch], dim: int, dtype=None):
    """Scatter-free assemble: one-hot placement of each factor row's
    jacobian into a dense (rows·r, dim) expanded jacobian, then one Gram.

    Returns H (..., dim, dim), g (..., dim), cost (...,).  Rows whose gidx
    is out of range contribute nothing."""
    if dtype is None:
        dtype = batches[0].res.dtype
    Js, rs, cost = [], [], 0.0
    for b in batches:
        O = one_hot(b.gidx, dim, dtype)                 # (..., rows, d, dim)
        J = torch.einsum("...brd,...bdD->...brD", b.jac.to(dtype), O)
        Js.append(J.reshape(J.shape[:-3] + (-1, dim)))
        r = b.res.to(dtype)
        rs.append(r.reshape(r.shape[:-2] + (-1,)))
        cost = cost + 0.5 * torch.sum(r * b.res, dim=(-2, -1))
    J = torch.cat(Js, dim=-2)
    rv = torch.cat(rs, dim=-1)
    Jt = J.transpose(-1, -2)
    return Jt @ J, (Jt @ rv[..., None])[..., 0], cost


def _mv(A, x):
    """A @ x for x (..., n) or (..., n, k)."""
    if x.dim() == A.dim() - 1:
        return (A @ x[..., None])[..., 0]
    return A @ x


def _matvec(H, p):
    """H @ p for dense tensors OR block-structured Hessians (BlockHess)."""
    return H.matvec(p) if hasattr(H, "matvec") else _mv(H, p)


def apply_free_mask(H, g, free_mask):
    """Fix parameters: unit diagonal + zero gradient for non-free slots.

    Structurally-empty slots (zero diagonal) are regularized the same way,
    so the Cholesky never sees a singular pivot.  Dispatches to
    BlockHess.mask for block-structured Hessians.
    """
    if hasattr(H, "mask"):
        return H.mask(g, free_mask)
    free = free_mask & (torch.diagonal(H, dim1=-2, dim2=-1) > 0)
    m = free.to(H.dtype)
    H = H * m[..., :, None] * m[..., None, :] + torch.diag_embed(1.0 - m)
    return H, g * m, free


class DoglegConfig(NamedTuple):
    max_iters: int = 8
    initial_radius: float = 1e4
    max_radius: float = 1e15
    min_radius: float = 1e-12
    # ceres function_tolerance: a window stops after an accepted step whose
    # cost decrease is below f_tol·cost (it is then frozen while the rest
    # of the batch iterates).  0 runs every window max_iters times.
    f_tol: float = 0.0
    # static indices (within the reduced block of a BlockHess) that can
    # actually be nonzero; () = keep all.  (The JAX config's schur_nl —
    # the dense-H Schur step — has no caller in the port: a Schur-
    # structured Hessian is a BlockHess.)
    reduced_keep: tuple = ()
    # dtype of the inner linear solve ("same" | "float32")
    step_dtype: str = "same"


class SolveResult(NamedTuple):
    state: object
    H: object
    g: torch.Tensor
    cost: torch.Tensor
    radius: torch.Tensor
    n_accepted: torch.Tensor


def inv33(M):
    """Closed-form batched 3x3 inverse (adjugate/det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g_, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g_)
    C = d * h - e * g_
    det = a * A + b * B + c * C
    tiny = torch.finfo(M.dtype).tiny
    inv_det = 1.0 / torch.where(det.abs() < tiny, 1.0, det)
    adj = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g_), -(a * f - c * d),
        C, -(a * h - b * g_), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return adj * inv_det[..., None, None]


def _jacobi_scale(H):
    """1/√diag preconditioner (the Hessian mixes projection weights ~4e5
    with unit prior rows)."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return 1.0 / torch.sqrt(torch.clamp_min(d, 1e-12))


def _chol_solve_scaled(A, b, step_dtype: str = "same", shift: float = 1e-5,
                       refine: int = 2):
    """Solve A x = b for SPD, Jacobi-scaled (unit-diagonal) A.

    In f32 (ambient, or step_dtype="float32") a plain Cholesky of a scaled
    Hessian with condition ~1e10 is not even positive definite: factor the
    shifted A + shift·I in f32 instead and refine in the ambient dtype,
    which converges to the damped-GN step (A + shift·I)⁻¹b.
    """
    if step_dtype != "float32" and A.dtype != torch.float32:
        return cho_solve(cholesky_nan(A), b)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L = cholesky_nan((A + shift * eye).to(torch.float32))
    x = cho_solve(L, b.to(torch.float32)).to(A.dtype)
    for _ in range(refine):
        r = b - _mv(A, x) - shift * x
        x = x + cho_solve(L, r.to(torch.float32)).to(A.dtype)
    return x


def _gn_step_dense(H, g, step_dtype: str = "same"):
    s = _jacobi_scale(H)
    Hs = H * s[..., :, None] * s[..., None, :]
    return -s * _chol_solve_scaled(Hs, s * g, step_dtype)


def _norm(x):
    return torch.linalg.norm(x, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _dogleg_step(H, g, radius, reduced_keep: tuple = (),
                 step_dtype: str = "same"):
    """Powell dogleg step for min ½ pᵀHp + gᵀp s.t. |p| ≤ radius, per
    window (g (..., D), radius (...,))."""
    if hasattr(H, "gn_step"):      # block-structured: Schur by construction
        p_gn = H.gn_step(g, reduced_keep, step_dtype)
    else:
        p_gn = _gn_step_dense(H, g, step_dtype)
    # NaN/Inf-proofing: a failed factorization degrades to the
    # steepest-descent leg instead of locking the solve into reject-forever
    gn_finite = torch.isfinite(p_gn).all(dim=-1)
    p_gn = torch.where(gn_finite[..., None], p_gn, 0.0)
    gn_norm = torch.where(gn_finite, _norm(p_gn), torch.inf)

    gHg = _dot(g, _matvec(H, g))
    g2 = _dot(g, g)
    alpha = g2 / torch.clamp_min(gHg, 1e-300)
    p_sd = -alpha[..., None] * g
    sd_norm = _norm(p_sd)

    # p = p_sd + tau (p_gn - p_sd), |p| = radius
    d = p_gn - p_sd
    a = _dot(d, d)
    b = 2.0 * _dot(p_sd, d)
    c = sd_norm ** 2 - radius ** 2
    disc = torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))
    tau = (-b + disc) / torch.clamp_min(2 * a, 1e-300)
    p_int = p_sd + torch.clamp(tau, 0.0, 1.0)[..., None] * d

    p_cut = p_sd * (radius / torch.clamp_min(sd_norm, 1e-300))[..., None]
    return torch.where(
        (gn_norm <= radius)[..., None], p_gn,
        torch.where((sd_norm >= radius)[..., None], p_cut, p_int))


def _select(mask, a, b):
    """Per-window select over pytrees whose leaves lead with mask's dims."""
    def one(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)
    return tree_map(one, a, b)


def dogleg_solve(eval_fn: Callable, retract_fn: Callable, state0,
                 free_mask, cfg: DoglegConfig = DoglegConfig(),
                 has_aux: bool = False):
    """Minimize ½|r(x)|² per window with a dogleg trust region.

    Args:
      eval_fn: state -> (H, g, cost) — full relinearization; with
        ``has_aux=True`` state -> (H, g, cost, aux), where ``aux`` is a
        linearization byproduct the retraction of a step from that state
        reuses.
      retract_fn: (state, dx) -> state, or (state, dx, aux) -> state.
      state0: initial state pytree (leading window dims).
      free_mask: (..., D) bool — which tangent entries may move.

    Returns SolveResult with the final (H, g) evaluated at the final state.
    """
    if has_aux:
        H0, g0, cost0, aux0 = eval_fn(state0)
    else:
        H0, g0, cost0 = eval_fn(state0)
        aux0 = ()

    def body(res_c, aux):
        state, H, g, cost, radius, n_acc = res_c
        Hm, gm, _ = apply_free_mask(H, g, free_mask)
        p = _dogleg_step(Hm, gm, radius, cfg.reduced_keep, cfg.step_dtype)
        pred = -(_dot(gm, p) + 0.5 * _dot(p, _matvec(Hm, p)))
        if has_aux:
            cand = retract_fn(state, p, aux)
            Hc, gc, costc, auxc = eval_fn(cand)
        else:
            cand = retract_fn(state, p)
            Hc, gc, costc = eval_fn(cand)
            auxc = ()
        actual = cost - costc
        rho = actual / torch.clamp_min(pred, 1e-300)
        accept = (actual > 0) & (pred > 0)

        state = _select(accept, cand, state)
        aux = _select(accept, auxc, aux)
        H = _select(accept, Hc, H)
        g = _select(accept, gc, g)
        cost = torch.where(accept, costc, cost)
        step_norm = _norm(p)
        radius = torch.where(
            accept & (rho > 0.75) & (step_norm > 0.9 * radius),
            torch.clamp_max(2.0 * radius, cfg.max_radius),
            torch.where(rho < 0.25,
                        torch.clamp_min(0.5 * step_norm, cfg.min_radius),
                        radius))
        # ceres function_tolerance on accepted steps, plus a predicted-
        # decrease exit (the model itself cannot improve the cost)
        converged = ((accept & (actual <= cfg.f_tol * cost))
                     | (pred <= cfg.f_tol * cost))
        res_c = SolveResult(state, H, g, cost, radius,
                            n_acc + accept.to(torch.int32))
        return res_c, aux, converged

    carry = SolveResult(state0, H0, g0, cost0,
                        torch.full_like(cost0, cfg.initial_radius),
                        torch.zeros(cost0.shape, dtype=torch.int32,
                                    device=cost0.device))
    aux = aux0
    done = torch.zeros(cost0.shape, dtype=torch.bool, device=cost0.device)
    for _ in range(cfg.max_iters):
        new, new_aux, converged = body(carry, aux)
        if cfg.f_tol > 0:
            # a converged window keeps its result, like the early exit of
            # a per-window while loop
            carry = _select(~done, new, carry)
            aux = _select(~done, new_aux, aux)
            done = done | converged
        else:
            carry, aux = new, new_aux
    return carry
