"""Integer least-squares (LAMBDA / MLAMBDA) for ambiguity resolution.

Implements the published LAMBDA method (Teunissen 1995 decorrelation;
Chang-Yang-Zhou 2005 MLAMBDA m-best search).  Provenance note: the depth-
first search in ``ils_search`` follows the canonical MLAMBDA recursion as
published and as implemented in RTKLIB's ``search()`` (the reference vendors
RTKLIB verbatim at rvi/gnss/src/lambda.cpp:123-191); the control flow and
variable roles (conditional bounds zb, alternating step enumeration,
m-candidate replacement) are the algorithm itself and therefore match any
faithful implementation.  The LD factorization and reduction are written
from the papers.  Input/output contract matches the reference's
``lambda(n, m, a, Q, F, s)`` (lambda.cpp:204-235): given float ambiguities
``a`` (n,) and covariance ``Q`` (n,n), return the ``m`` best integer
candidates and their squared norms (a−ǎ)ᵀQ⁻¹(a−ǎ).

Problem sizes are tiny (n ≤ ~30) and the search is branch-heavy, so this
runs on the host in numpy — it is orchestration around the window solves,
not part of them.  The solver exports the ambiguity covariance (SURVEY.md
§2.9's tail-block covariance) and this module consumes it.
"""

from __future__ import annotations

import numpy as np


def ld_factorization(Q: np.ndarray):
    """Q = Lᵀ·diag(D)·L with unit lower-triangular L (lambda.cpp:58-76)."""
    n = Q.shape[0]
    A = Q.astype(float).copy()
    L = np.zeros((n, n))
    D = np.zeros(n)
    for i in range(n - 1, -1, -1):
        D[i] = A[i, i]
        if D[i] <= 0.0:
            raise np.linalg.LinAlgError("LD factorization: Q not PD")
        a = np.sqrt(D[i])
        L[i, : i + 1] = A[i, : i + 1] / a
        for j in range(i):
            A[j, : j + 1] -= L[i, : j + 1] * L[i, j]
        L[i, : i + 1] /= L[i, i]
    return L, D


def _gauss(L, Z, i, j):
    mu = round(L[i, j])
    if mu != 0:
        L[i:, j] -= mu * L[i:, i]
        Z[:, j] -= mu * Z[:, i]


def _perm(L, D, j, delta, Z):
    n = L.shape[0]
    eta = D[j] / delta
    lam = D[j + 1] * L[j + 1, j] / delta
    D[j] = eta * D[j + 1]
    D[j + 1] = delta
    a0 = L[j, :j].copy()
    a1 = L[j + 1, :j].copy()
    L[j, :j] = -L[j + 1, j] * a0 + a1
    L[j + 1, :j] = eta * a0 + lam * a1
    L[j + 1, j] = lam
    L[j + 2:, [j, j + 1]] = L[j + 2:, [j + 1, j]]
    Z[:, [j, j + 1]] = Z[:, [j + 1, j]]


def lambda_reduction(L, D):
    """LLL-style decorrelation; returns (L', D', Z) with Qz = Zᵀ Q Z
    (lambda.cpp:106-121)."""
    n = L.shape[0]
    L = L.copy()
    D = D.copy()
    Z = np.eye(n)
    j = k = n - 2
    while j >= 0:
        if j <= k:
            for i in range(j + 1, n):
                _gauss(L, Z, i, j)
        delta = D[j] + L[j + 1, j] ** 2 * D[j + 1]
        if delta + 1e-6 < D[j + 1]:
            _perm(L, D, j, delta, Z)
            k = j
            j = n - 2
        else:
            j -= 1
    return L, D, Z


class SearchOverflow(np.linalg.LinAlgError):
    """The m-best search exhausted its loop budget without terminating.

    The reference treats this as a hard failure (lambda.cpp:186-189 returns
    -1 and the epoch is not fixed) — silently returning best-so-far can mint
    false fixes on degenerate covariances."""


def ils_search(L, D, zs, m: int = 2, loop_max: int = 10000):
    """Depth-first m-best search in the reduced lattice (MLAMBDA; see module
    provenance note — mirrors lambda.cpp:123-191).

    Returns (candidates (m,n) ints, dists (m,)); candidates sorted by dist.
    Raises SearchOverflow if the loop budget is exhausted before the search
    space is pruned away (reference: error out, lambda.cpp:186-189).
    """
    n = len(zs)
    S = np.zeros((n, n))
    dist = np.zeros(n)
    zb = np.zeros(n)
    z = np.zeros(n)
    step = np.zeros(n)
    zn = np.zeros((m, n))
    s = np.zeros(m)
    nn = 0
    imax = 0
    maxdist = 1e99

    k = n - 1
    zb[k] = zs[k]
    z[k] = round(zb[k])
    y = zb[k] - z[k]
    step[k] = np.sign(y) if y != 0 else 1.0
    finished = False
    for _ in range(loop_max):
        newdist = dist[k] + y * y / D[k]
        if newdist < maxdist:
            if k != 0:
                k -= 1
                dist[k] = newdist
                S[k, : k + 1] = (S[k + 1, : k + 1]
                                 + (z[k + 1] - zb[k + 1]) * L[k + 1, : k + 1])
                zb[k] = zs[k] + S[k, k]
                z[k] = round(zb[k])
                y = zb[k] - z[k]
                step[k] = np.sign(y) if y != 0 else 1.0
            else:
                if nn < m:
                    if nn == 0 or newdist > s[imax]:
                        imax = nn
                    zn[nn] = z
                    s[nn] = newdist
                    nn += 1
                else:
                    if newdist < s[imax]:
                        zn[imax] = z
                        s[imax] = newdist
                        imax = int(np.argmax(s))
                    maxdist = s[imax]
                z[0] += step[0]
                y = zb[0] - z[0]
                step[0] = -step[0] - np.sign(step[0])
        else:
            if k == n - 1:
                finished = True
                break
            k += 1
            z[k] += step[k]
            y = zb[k] - z[k]
            step[k] = -step[k] - np.sign(step[k])
    if not finished:
        raise SearchOverflow(
            f"ILS search exceeded loop_max={loop_max} (n={n})")
    order = np.argsort(s[:nn])
    return zn[order].astype(np.int64), s[order]


def lambda_ils(a: np.ndarray, Q: np.ndarray, m: int = 2):
    """Full pipeline: LD -> reduction -> search -> back-transform.

    Returns (F (m,n) integer candidates in the ORIGINAL parameterization,
    s (m,) squared norms).
    """
    a = np.asarray(a, dtype=float)
    L, D = ld_factorization(Q)
    L, D, Z = lambda_reduction(L, D)
    zres = Z.T @ a
    E, s = ils_search(L, D, zres, m=m)
    # candidates satisfy z = Zᵀ ǎ  =>  ǎ = Z⁻ᵀ z ; entries are integers
    F = np.linalg.solve(Z.T, E.T).T
    return np.rint(F).astype(np.int64), s


def ratio_test(s: np.ndarray, threshold: float = 2.0) -> bool:
    """Classic acceptance test: s₂/s₁ ≥ threshold (reference uses the
    partial variant with cost splitting at swf_lambda.cpp:204-244; the full
    test is its m=2 special case with identical index sets)."""
    if len(s) < 2:
        return False
    if s[0] <= 0.0:
        # degenerate: the reference accepts s[0] <= 0 outright
        # (swf_lambda.cpp:238) — only because its costs come from a PD
        # solve; we keep the gate but require finite candidates upstream
        return True
    return s[1] / s[0] >= threshold


def partial_ratio_test(b_float: np.ndarray, Qb: np.ndarray,
                       F: np.ndarray, s: np.ndarray,
                       threshold: float = 2.0) -> bool:
    """The reference's candidate-splitting acceptance test
    (swf_lambda.cpp:204-244).

    Candidates 1 & 2 are split into entries where they agree vs differ; the
    cost attributable to the agreeing subset (with differing entries
    decoupled from the covariance) is removed from both costs, and the test
    accepts if EITHER the classic ratio OR the residual ratio passes:

        accept  ⇔  s₀ ≤ 0  ∨  s₁/s₀ ≥ τ  ∨  (s₁−c)/(s₀−c) ≥ τ

    where c = e₁ᵀ Q̃b⁻¹ e₁ over the agreeing entries.  On accept, the FULL
    first candidate is used (the reference applies F1 wholesale).
    """
    if len(s) < 2 or F.shape[0] < 2:
        return False
    s0, s1 = float(s[0]), float(s[1])
    if s0 <= 0.0:
        return True
    if s1 / s0 >= threshold:
        return True
    e1 = F[0] - b_float
    diff = np.abs(F[0] - F[1]) >= 1e-2
    Qb2 = np.asarray(Qb, dtype=float).copy()
    e1 = e1.astype(float).copy()
    e1[diff] = 0.0
    Qb2[diff, :] = 0.0
    Qb2[:, diff] = 0.0
    Qb2[diff, diff] = 1.0
    try:
        same_cost = float(e1 @ np.linalg.solve(Qb2, e1))
    except np.linalg.LinAlgError:
        return False
    s1c = s1 - same_cost
    s0c = s0 - same_cost
    if abs(s0c) < 1e-3:
        s0c = 1e-3
    return s1c / s0c >= threshold
