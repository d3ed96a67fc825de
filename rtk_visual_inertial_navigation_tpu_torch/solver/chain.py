"""Prefix-scan elimination of IMU-GNSS chains with an ambiguity tail.

The Schur condensation of a chain segment onto its two endpoint states is
associative, so condensing an n-leaf chain is a prefix scan over batched
15x15 block algebra.  Element of the monoid: the quadratic form of a
segment [i..j] reduced onto (x_i, x_j, N), with N the ambiguity vector
shared by every epoch of the chain (never eliminated).  Composing [i..k]
with [k..j] eliminates the shared state x_k.  ``ChainElem`` is the same
monoid without the tail; the dense chain systems, the sequential fold and
the dense and bidirectional interior solves are the test oracles of the
JAX package.

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


def _eye(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


class ChainElem(NamedTuple):
    """Quadratic form of a chain segment over (x_i, x_j), no tail."""

    Hii: torch.Tensor   # (..., d, d)
    Hij: torch.Tensor
    Hjj: torch.Tensor
    bi: torch.Tensor    # (..., d)
    bj: torch.Tensor


def _combine(L: ChainElem, R: ChainElem) -> ChainElem:
    """Eliminate the shared middle state of two adjacent segments."""
    d = L.Hii.shape[-1]
    M = L.Hjj + R.Hii + 1e-12 * _eye(L.Hii)
    m = L.bj + R.bi
    # solve once against [L.Hijᵀ | R.Hij | m]
    sol = spd_solve(M, torch.cat([L.Hij.transpose(-1, -2), R.Hij,
                                  m[..., None]], dim=-1))
    X_L = sol[..., :d]             # M⁻¹ L.Hijᵀ
    X_R = sol[..., d:2 * d]        # M⁻¹ R.Hij
    x_m = sol[..., 2 * d]          # M⁻¹ m
    RHt = R.Hij.transpose(-1, -2)
    return ChainElem(L.Hii - L.Hij @ X_L, -L.Hij @ X_R, R.Hjj - RHt @ X_R,
                     L.bi - _mv(L.Hij, x_m), R.bj - _mv(RHt, x_m))


def _first(x, ev: int):
    """``x`` along its leaf axis (``ev`` event dims after it) with every
    leaf but the first zeroed."""
    n = x.dim() - ev - 1
    return torch.cat([x.narrow(n, 0, 1),
                      torch.zeros_like(x.narrow(n, 1, x.shape[n] - 1))],
                     dim=n)


def make_leaves(H_pair_ii, H_pair_ij, H_pair_jj, b_pair_i, b_pair_j,
                H_unary, b_unary) -> ChainElem:
    """Scan leaves from n-1 binary factors and n unary blocks.

    Args (leaf axis right before the event dims):
      H_pair_*: (..., n-1, d, d) blocks of each consecutive-state factor;
        b_pair_*: (..., n-1, d).
      H_unary: (..., n, d, d) per-state information; b_unary: (..., n, d).
    """
    n1 = H_pair_ii.shape[-3]
    return ChainElem(
        Hii=H_pair_ii + _first(H_unary[..., :n1, :, :], 2), Hij=H_pair_ij,
        Hjj=H_pair_jj + H_unary[..., 1:, :, :],
        bi=b_pair_i + _first(b_unary[..., :n1, :], 1),
        bj=b_pair_j + b_unary[..., 1:, :])


def _leaf_axis(e) -> int:
    return e.Hii.dim() - 3


def condense_chain(leaves: ChainElem) -> ChainElem:
    """Reduce the whole chain onto its endpoints (the last prefix of a
    doubling scan over the leaf axis)."""
    axis = _leaf_axis(leaves)
    F = _prefix_scan(_combine, leaves, axis)
    return tree_map(lambda x: x.select(axis, -1), F)


def condense_chain_sequential(leaves: ChainElem) -> ChainElem:
    """Reference implementation: the sequential left fold (the
    IMUGNSSBase ordering), which validates the scan."""
    axis = _leaf_axis(leaves)
    acc = tree_map(lambda x: x.select(axis, 0), leaves)
    for k in range(1, leaves.Hii.shape[axis]):
        acc = _combine(acc, tree_map(lambda x: x.select(axis, k), leaves))
    return acc


def _chain_system(leaves, n: int, d: int, dn: int = 0):
    """The dense (..., n·d + dn) system of a chain of n states (n-1
    leaves), with the tail N last when the leaves carry one."""
    lead = leaves.Hii.shape[:-3]
    D = n * d + dn
    H = leaves.Hii.new_zeros(lead + (D, D))
    b = leaves.Hii.new_zeros(lead + (D,))
    tN = slice(n * d, D)
    tr = lambda x: x.transpose(-1, -2)
    for k in range(n - 1):
        i = slice(k * d, (k + 1) * d)
        j = slice((k + 1) * d, (k + 2) * d)
        leaf = tree_map(lambda x: x[..., k, :, :] if x.dim() == len(lead) + 3
                        else x[..., k, :], leaves)
        H[..., i, i] += leaf.Hii
        H[..., i, j] += leaf.Hij
        H[..., j, i] += tr(leaf.Hij)
        H[..., j, j] += leaf.Hjj
        b[..., i] += leaf.bi
        b[..., j] += leaf.bj
        if dn:
            H[..., i, tN] += leaf.HiN
            H[..., tN, i] += tr(leaf.HiN)
            H[..., j, tN] += leaf.HjN
            H[..., tN, j] += tr(leaf.HjN)
            H[..., tN, tN] += leaf.HNN
            b[..., tN] += leaf.bN
    return H, b


def dense_chain_hessian(leaves: ChainElem, n: int, d: int):
    """Materialize the full (..., n·d, n·d) chain Hessian and rhs (test
    oracle)."""
    return _chain_system(leaves, n, d)


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


def dense_chain_tail_hessian(leaves: ChainTailElem, n: int, d: int,
                             dn: int):
    """Materialize the (..., n·d + dn) chain system, tail last (test
    oracle)."""
    return _chain_system(leaves, n, d, dn)


def transpose_tail_elem(e: ChainTailElem) -> ChainTailElem:
    """Swap a segment's endpoints: [i..j] viewed as [j..i]."""
    return ChainTailElem(
        Hii=e.Hjj, Hij=e.Hij.transpose(-1, -2), Hjj=e.Hii, HiN=e.HjN,
        HjN=e.HiN, HNN=e.HNN, bi=e.bj, bj=e.bi, bN=e.bN)


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
    n1 = H_pair_ii.shape[-3]
    Hii = H_pair_ii + _first(H_unary[..., :n1, :, :], 2)
    bi = b_pair_i + _first(b_unary[..., :n1, :], 1)
    return ChainTailElem(
        Hii=Hii, Hij=H_pair_ij, Hjj=H_pair_jj + H_unary[..., 1:, :, :],
        HiN=_first(H_uN[..., :n1, :, :], 2), HjN=H_uN[..., 1:, :, :],
        HNN=_first(H_NN[..., :n1, :, :], 2) + H_NN[..., 1:, :, :],
        bi=bi, bj=b_pair_j + b_unary[..., 1:, :],
        bN=_first(b_N[..., :n1, :], 1) + b_N[..., 1:, :])


def _narrow(e, axis, start, length):
    return tree_map(lambda x: x.narrow(axis, start, length), e)


def _prefix_scan(combine, leaves, axis: int):
    """All prefixes of ``combine`` along the leaf ``axis``: a doubling
    scan, ceil(log2 n) levels of batched combines."""
    n = leaves.Hii.shape[axis]
    F = leaves
    s = 1
    while s < n:
        head = _narrow(F, axis, 0, s)
        comb = combine(_narrow(F, axis, 0, n - s), _narrow(F, axis, s, n - s))
        F = tree_map(lambda h, c: torch.cat([h, c], dim=axis), head, comb)
        s *= 2
    return F


def scan_chain_tail_prefix(leaves: ChainTailElem, axis: int = 0
                           ) -> ChainTailElem:
    """All prefix condensations F[k] = segment [0..k+1] along the leaf
    ``axis``: a doubling scan, ceil(log2 n) levels of batched combines."""
    return _prefix_scan(_combine_tail, leaves, axis)


def _take_leaves(e, idx):
    """Leaves ``idx[..., m]`` of every chain; idx is (*batch, m), so the
    leaf axis is ``idx.dim() - 1``."""
    a = idx.dim() - 1

    def one(x):
        ii = idx.reshape(idx.shape + (1,) * (x.dim() - a - 1))
        return x.gather(a, ii.expand(idx.shape + x.shape[a + 1:]))
    return tree_map(one, e)


def _take_leaf(e: ChainTailElem, idx) -> ChainTailElem:
    """Leaf ``idx[...]`` of every chain; idx has the batch shape, so the
    leaf axis is ``idx.dim()``."""
    return tree_map(lambda x: x.squeeze(idx.dim()),
                    _take_leaves(e, idx[..., None]))


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


def scan_chain_tail_bidir(leaves: ChainTailElem, n_leaves, cap: int):
    """Prefix AND suffix condensations in one scan.

    Returns (F, G) with
      F[k] = segment [0 .. k+1]   (leaves 0..k condensed; prefix)
      G[k] = TRANSPOSED segment [n-1-k .. n]  (leaves n-1-k..n-1; suffix,
             stored endpoint-swapped: G[k].Hjj is the x_{n-1-k} block)

    The suffix sequence is the reversed and transposed leaf array, rolled
    per chain so that its padding leaves (k >= n_leaves) sit at the end:
    composing them is no identity, so they never enter a real prefix.
    Both directions ride one doubling scan, stacked on a batch axis.
    """
    axis = n_leaves.dim()
    revt = transpose_tail_elem(tree_map(lambda x: x.flip(axis), leaves))
    # real leaves sit at positions cap-n .. cap-1 after the flip: roll
    # them to the front (position k takes k + cap - n, modulo cap)
    k = torch.arange(cap, device=n_leaves.device)
    revt = _take_leaves(revt, (k + (cap - n_leaves)[..., None]) % cap)
    both = tree_map(lambda a, b: torch.stack([a, b], dim=axis), leaves, revt)
    scanned = scan_chain_tail_prefix(both, axis=axis + 1)
    return (tree_map(lambda x: x.select(axis, 0), scanned),
            tree_map(lambda x: x.select(axis, 1), scanned))


def solve_chain_interior_bidir(F: ChainTailElem, G: ChainTailElem,
                               n_leaves, dx_i, dx_j, dx_N, cap: int):
    """Interior back-substitution from the bidirectional scans.

    For interior state k (1..n-1): eliminate all other interiors via
    F[k-1] (= [0..k], endpoints x_0, x_k) and S_k = transpose(G[n-1-k])
    (= [k..n], endpoints x_k, x_n); stationarity in x_k given the endpoint
    and tail increments is one d×d solve:

        (F.Hjj + S.Hii) dx_k = (F.bj + S.bi) − F.Hijᵀ dx_i − S.Hij dx_j
                               − (F.HjN + S.HiN) dx_N

    Exact, as the dense ``solve_chain_interior``.  dx_i, dx_j (..., d),
    dx_N (..., dn).  Returns (..., cap-1, d) increments.
    """
    axis = n_leaves.dim()
    m = cap - 1
    k = torch.arange(1, cap, device=n_leaves.device)
    n = n_leaves[..., None]
    active = k <= n - 1                                  # (..., m)
    Fk = _narrow(F, axis, 0, m)                          # F[k-1]
    # S.Hii = G.Hjj, S.Hij = G.Hijᵀ, S.bi = G.bj, S.HiN = G.HjN
    Gk = _take_leaves(G, torch.clamp(n - 1 - k, 0, cap - 1))
    M = Fk.Hjj + Gk.Hjj + 1e-12 * _eye(F.Hii)
    rhs = (Fk.bj + Gk.bj
           - torch.einsum("...kba,...b->...ka", Fk.Hij, dx_i)
           - torch.einsum("...kba,...b->...ka", Gk.Hij, dx_j)
           - torch.einsum("...kad,...d->...ka", Fk.HjN + Gk.HjN, dx_N))
    sol = spd_solve(M, rhs[..., None])[..., 0]
    return torch.where(active[..., None], sol, 0.0)


def solve_chain_interior(leaves: ChainTailElem, n_leaves, dx_i, dx_j, dx_N,
                         cap: int):
    """Back-substitute the hidden interior states (UpdateHiddenState
    semantics) with one masked dense Cholesky of the block-tridiagonal
    interior system: the test oracle of the scan-based solves.

    Given endpoint increments dx_i (state 0), dx_j (state n) and the tail
    increment dx_N, solve for the increments of states 1..n-1 (``leaves``
    hold ``cap`` leaves, ``n_leaves`` of them real).  Returns (..., cap-1,
    d), zero beyond the real interior.
    """
    axis = n_leaves.dim()
    d = leaves.Hii.shape[-1]
    m = cap - 1
    lead = n_leaves.shape
    dev = n_leaves.device
    n = n_leaves[..., None]
    s_idx = torch.arange(1, cap, device=dev)            # interior states
    active = s_idx <= n - 1                              # (..., m)
    # leaf s is real for s < n: state s's block is Hjj[s-1] + Hii[s]
    real = s_idx < n
    L1 = _narrow(leaves, axis, 1, m)                     # leaves 1..cap-1
    L0 = _narrow(leaves, axis, 0, m)                     # leaves 0..cap-2
    diag = L0.Hjj + torch.where(real[..., None, None], L1.Hii, 0.0)
    rhs = L0.bj + torch.where(real[..., None], L1.bi, 0.0)
    # endpoint couplings: state 1 to x_0 through Hij[0]ᵀ, state n-1 to
    # x_n through Hij[n-1]
    first = leaves.Hij.select(axis, 0)
    rhs = torch.cat([rhs.narrow(-2, 0, 1)
                     - _mv(first.transpose(-1, -2), dx_i)[..., None, :],
                     rhs.narrow(-2, 1, m - 1)], dim=-2)
    last = _take_leaf(leaves, torch.clamp(n_leaves - 1, 0, cap - 1)).Hij
    rhs = rhs + torch.where((s_idx == n - 1)[..., None],
                            -_mv(last, dx_j)[..., None, :], 0.0)
    # tail coupling of state s: HjN[s-1] + HiN[s]
    C_N = L0.HjN + torch.where(real[..., None, None], L1.HiN, 0.0)
    rhs = rhs - torch.einsum("...sdk,...k->...sd", C_N, dx_N)

    # the dense (m·d)² system, as (m, m) blocks of d x d
    H = leaves.Hii.new_zeros(lead + (m, m, d, d))
    ar = torch.arange(m, device=dev)
    H[..., ar, ar, :, :] = diag
    if m > 1:
        # coupling of interior states s and s+1: Hij[s], real iff s+1 < n
        off = torch.where((s_idx[:-1] + 1 < n)[..., None, None],
                          _narrow(leaves, axis, 1, m - 1).Hij, 0.0)
        H[..., ar[:-1], ar[1:], :, :] = off
        H[..., ar[1:], ar[:-1], :, :] = off.transpose(-1, -2)
    H = H.transpose(-3, -2).reshape(lead + (m * d, m * d))
    mask = active.repeat_interleave(d, dim=-1).to(H.dtype)
    Hm = (H * mask[..., :, None] * mask[..., None, :]
          + torch.diag_embed(1.0 - mask))
    sol = spd_solve(Hm, rhs.reshape(lead + (m * d,)) * mask)
    return sol.reshape(lead + (m, d)) * active[..., None]
