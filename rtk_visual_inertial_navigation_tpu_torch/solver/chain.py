"""Prefix-scan elimination of IMU-GNSS chains with an ambiguity tail.

The Schur condensation of a chain segment onto its two endpoint states is
associative, so condensing an n-leaf chain is a prefix scan over batched
15x15 block algebra.  Element of the monoid: the quadratic form of a
segment [i..j] reduced onto (x_i, x_j, N), with N the ambiguity vector
shared by every epoch of the chain (never eliminated).  Composing [i..k]
with [k..j] eliminates the shared state x_k.

Layout: chain tensors are (*batch, n_leaves_capacity, *event) — the leaf
axis sits right after the batch dims, whose shape is that of the per-chain
``n_leaves``.  ``lax.associative_scan`` has no torch counterpart: the
prefix scan is a log-depth doubling (Hillis-Steele) scan, which reassociates
the sums, so results agree with the JAX scan to roundoff.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._pytree import tree_map

from .marginalization import spd_solve


class ChainTailElem(NamedTuple):
    """Quadratic form of a chain segment over (x_i, x_j, N).

    ½ [xi;xj;N]ᵀ [Hii Hij HiN; · Hjj HjN; · · HNN] [xi;xj;N]
      − [bi;bj;bN]ᵀ [xi;xj;N]   (constant term dropped).
    """

    Hii: torch.Tensor   # (..., d, d)
    Hij: torch.Tensor   # (..., d, d)
    Hjj: torch.Tensor   # (..., d, d)
    HiN: torch.Tensor   # (..., d, dn)
    HjN: torch.Tensor   # (..., d, dn)
    HNN: torch.Tensor   # (..., dn, dn)
    bi: torch.Tensor    # (..., d)
    bj: torch.Tensor    # (..., d)
    bN: torch.Tensor    # (..., dn)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _combine_tail(L: ChainTailElem, R: ChainTailElem) -> ChainTailElem:
    """Eliminate the shared middle state x_k of two adjacent segments.

    x_k couples to x_i through L.Hijᵀ, to x_j through R.Hij, to N through
    L.HjN + R.HiN, with information M = L.Hjj + R.Hii and rhs m = L.bj+R.bi.
    One factorization of M serves every Schur correction.
    """
    d = L.Hii.shape[-1]
    dn = L.HNN.shape[-1]
    M = L.Hjj + R.Hii + 1e-12 * torch.eye(d, dtype=L.Hii.dtype,
                                          device=L.Hii.device)
    m = L.bj + R.bi
    C_N = L.HjN + R.HiN                       # (d, dn) coupling x_k ↔ N
    rhs = torch.cat([L.Hij.transpose(-1, -2), R.Hij, C_N, m[..., None]],
                    dim=-1)
    sol = spd_solve(M, rhs)
    X_i = sol[..., :d]                        # M⁻¹ L.Hijᵀ
    X_j = sol[..., d:2 * d]                   # M⁻¹ R.Hij
    X_N = sol[..., 2 * d:2 * d + dn]          # M⁻¹ C_N
    x_m = sol[..., 2 * d + dn]                # M⁻¹ m
    LH = L.Hij                                # (i,k) block
    RHt = R.Hij.transpose(-1, -2)             # (j,k) block
    C_Nt = C_N.transpose(-1, -2)
    return ChainTailElem(
        Hii=L.Hii - LH @ X_i,
        Hij=-LH @ X_j,
        Hjj=R.Hjj - RHt @ X_j,
        HiN=L.HiN - LH @ X_N,
        HjN=R.HjN - RHt @ X_N,
        HNN=L.HNN + R.HNN - C_Nt @ X_N,
        bi=L.bi - _mv(LH, x_m),
        bj=R.bj - _mv(RHt, x_m),
        bN=L.bN + R.bN - _mv(C_Nt, x_m),
    )


def make_tail_leaves(H_pair_ii, H_pair_ij, H_pair_jj, b_pair_i, b_pair_j,
                     H_unary, H_uN, H_NN, b_unary, b_N) -> ChainTailElem:
    """Scan leaves from n-1 binary factors + n unary blocks coupling to N.

    Args (leaf axis right before the event dims):
      H_pair_*: (..., n-1, d, d) / b_pair_*: (..., n-1, d) — consecutive-
        state factors (whitened-IMU JᵀJ blocks).
      H_unary: (..., n, d, d), H_uN: (..., n, d, dn), H_NN: (..., n, dn,
        dn), b_unary: (..., n, d), b_N: (..., n, dn) — per-state GNSS epoch
        information coupling state k with the tail.
    State 0's unary folds into leaf 0's i-side; state k≥1's into leaf
    k-1's j-side.
    """
    first = lambda x: torch.cat(
        [x[..., :1, :, :], torch.zeros_like(x[..., 1:, :, :])], dim=-3)
    first_v = lambda x: torch.cat(
        [x[..., :1, :], torch.zeros_like(x[..., 1:, :])], dim=-2)
    n1 = H_pair_ii.shape[-3]
    Hii = H_pair_ii + first(H_unary[..., :n1, :, :])
    bi = b_pair_i + first_v(b_unary[..., :n1, :])
    return ChainTailElem(
        Hii=Hii, Hij=H_pair_ij, Hjj=H_pair_jj + H_unary[..., 1:, :, :],
        HiN=first(H_uN[..., :n1, :, :]), HjN=H_uN[..., 1:, :, :],
        HNN=first(H_NN[..., :n1, :, :]) + H_NN[..., 1:, :, :],
        bi=bi, bj=b_pair_j + b_unary[..., 1:, :],
        bN=first_v(b_N[..., :n1, :]) + b_N[..., 1:, :])


def _narrow(e, axis, start, length):
    return tree_map(lambda x: x.narrow(axis, start, length), e)


def scan_chain_tail_prefix(leaves: ChainTailElem, axis: int = 0
                           ) -> ChainTailElem:
    """All prefix condensations F[k] = segment [0..k+1] along the leaf
    ``axis``: a doubling scan, ceil(log2 n) levels of batched combines."""
    n = leaves.Hii.shape[axis]
    F = leaves
    s = 1
    while s < n:
        head = _narrow(F, axis, 0, s)
        comb = _combine_tail(_narrow(F, axis, 0, n - s),
                             _narrow(F, axis, s, n - s))
        F = tree_map(lambda h, c: torch.cat([h, c], dim=axis), head, comb)
        s *= 2
    return F


def _take_leaf(e: ChainTailElem, idx) -> ChainTailElem:
    """Leaf ``idx[...]`` of every chain; idx has the batch shape, so the
    leaf axis is ``idx.dim()``."""
    a = idx.dim()

    def one(x):
        ii = idx.reshape(idx.shape + (1,) * (x.dim() - a))
        ii = ii.expand(idx.shape + (1,) + x.shape[a + 1:])
        return x.gather(a, ii).squeeze(a)
    return tree_map(one, e)


def condensed_from_prefix(F: ChainTailElem, n_leaves) -> ChainTailElem:
    """The full-chain condensation = prefix at index n_leaves-1 (clipped
    into range, as ``jnp.take(mode="clip")``)."""
    cap = F.Hii.shape[n_leaves.dim()]
    return _take_leaf(F, torch.clamp(n_leaves - 1, 0, cap - 1))


def condense_chain_tail(leaves: ChainTailElem, n_leaves) -> ChainTailElem:
    """Reduce every chain onto (x_0, x_last, N); padding leaves beyond
    ``n_leaves`` never enter the prefix that is read."""
    F = scan_chain_tail_prefix(leaves, axis=n_leaves.dim())
    return condensed_from_prefix(F, n_leaves)


def solve_chain_interior_affine(F: ChainTailElem, leaves: ChainTailElem,
                                n_leaves, dx_i, dx_j, dx_N, cap: int):
    """Interior back-substitution as an affine backward recurrence.

    Conditioning state k on (x_0, x_{k+1}) and marginalizing interiors
    1..k-1 through the prefix F[k-1] gives

        M_k x_k = m_k − leaves.Hij[k] · x_{k+1}
        M_k = F[k-1].Hjj + leaves.Hii[k]
        m_k = F[k-1].bj + leaves.bi[k] − F[k-1].Hijᵀ dx_i
              − (F[k-1].HjN + leaves.HiN[k]) dx_N

    i.e. x_k = A_k x_{k+1} + b_k; padding positions k ≥ n are identity
    maps, so masked lengths are exact.  dx_i, dx_j (..., d), dx_N
    (..., dn) with the chain batch dims.  Returns (..., cap-1, d)
    increments of interior states 1..cap-1.
    """
    from ..ops.smallinv import spd_solve_small

    axis = n_leaves.dim()
    d = F.Hii.shape[-1]
    m = cap - 1
    k = torch.arange(1, cap, device=n_leaves.device)
    active = k <= n_leaves[..., None] - 1              # (..., m)
    Fk = _narrow(F, axis, 0, m)                        # F[k-1]
    Lk = _narrow(leaves, axis, 1, m)                   # leaf k

    eye = torch.eye(d, dtype=F.Hii.dtype, device=F.Hii.device)
    M = Fk.Hjj + Lk.Hii + 1e-12 * eye
    rhs_const = (Fk.bj + Lk.bi
                 - torch.einsum("...kba,...b->...ka", Fk.Hij, dx_i)
                 - torch.einsum("...kad,...d->...ka", Fk.HjN + Lk.HiN, dx_N))
    # solve M [Hij | m_k] in one shot: A_k = -M⁻¹ Hij, b_k = M⁻¹ m_k
    sol = spd_solve_small(
        M, torch.cat([Lk.Hij, rhs_const[..., None]], dim=-1), refine=1)
    A = torch.where(active[..., None, None], -sol[..., :d], eye)
    b = torch.where(active[..., None], sol[..., d], 0.0)

    # apply backwards: x_k = A_k x_{k+1} + b_k starting from x_{m+1} = dx_j
    xs = [None] * m
    x = dx_j
    for j in reversed(range(m)):
        x = _mv(A[..., j, :, :], x) + b[..., j, :]
        xs[j] = x
    return torch.where(active[..., None], torch.stack(xs, dim=-2), 0.0)
