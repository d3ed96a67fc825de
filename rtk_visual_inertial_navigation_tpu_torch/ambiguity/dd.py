"""Double-difference construction and the fixed-solution update.

Semantics of swf_lambda.cpp:
  - reference satellite per (sys,freq) = the one whose float bias minimizes
    the summed distance-to-nearest-integer of all pairwise differences
    (FindReferenceSatellites, swf_lambda.cpp:8-53);
  - DD matrix rows are +1/−1 (bias_i − bias_ref), gated by fractional
    closeness (0.2 when previously fixed, 1.4 otherwise; swf_lambda.cpp:
    126-177);
  - the fixed solution conditions the full state on the fixed DD integers:
      x⁺ = x − Q_xb D ᵀ (D Q_bb Dᵀ)⁻¹ (D b − ň)
    which is what the reference achieves by re-solving with FixedInteger
    factors / baked priors.
"""

from __future__ import annotations

import numpy as np


def frac_dist(x):
    """Distance to nearest integer."""
    return np.abs(x - np.rint(x))


def choose_reference(biases: np.ndarray) -> int:
    """Index minimizing Σ_j frac(b_j − b_i) (FindReferenceSatellites)."""
    n = len(biases)
    if n == 0:
        return -1
    diffs = biases[None, :] - biases[:, None]     # [i,j] = b_j − b_i
    cost = frac_dist(diffs).sum(axis=1)
    return int(np.argmin(cost))


def double_difference(bias_values: np.ndarray, ref_idx: int,
                      gate: float = 1.4):
    """Build the DD selection matrix D (k, n) and keep mask.

    Row per non-reference bias i with frac(b_i − b_ref) < gate:
    D row = e_i − e_ref.
    """
    n = len(bias_values)
    rows = []
    members = []
    for i in range(n):
        if i == ref_idx:
            continue
        if frac_dist(bias_values[i] - bias_values[ref_idx]) < gate:
            r = np.zeros(n)
            r[i] = 1.0
            r[ref_idx] = -1.0
            rows.append(r)
            members.append(i)
    if not rows:
        return np.zeros((0, n)), np.asarray(members, dtype=int)
    return np.stack(rows), np.asarray(members, dtype=int)


def conditioned_fix(x: np.ndarray, Q_xx_cols: np.ndarray, b_float: np.ndarray,
                    Q_bb: np.ndarray, D: np.ndarray, n_fixed: np.ndarray):
    """Condition the state on fixed DD integers.

    Args:
      x: (P,) full float state (any subset the caller wants updated).
      Q_xx_cols: (P, n_b) cross-covariance between x and the float biases.
      b_float: (n_b,) float biases; Q_bb their covariance.
      D: (k, n_b) DD matrix; n_fixed: (k,) fixed integers.
    Returns updated x and the bias correction.
    """
    Qdd = D @ Q_bb @ D.T
    innov = D @ b_float - n_fixed
    K = np.linalg.solve(Qdd, innov)
    dx = Q_xx_cols @ (D.T @ K)
    return x - dx, -(Q_bb @ D.T @ K)


def fix_differences(fixes) -> dict:
    """A set of fixed double differences as reference-free integer
    differences: ``fixes`` holds (slot_i, slot_ref, n) for N_i − N_ref = n;
    the result maps every slot the fixes connect to (the smallest slot of
    its group, N_slot − N_smallest).  Two fixes against different reference
    satellites that constrain the same integers map to the same dict (on
    noiseless data ``choose_reference`` is a near-tie that roundoff
    decides)."""
    edges: dict[int, list] = {}
    for i, r, n in fixes:
        edges.setdefault(int(i), []).append((int(r), -int(n)))
        edges.setdefault(int(r), []).append((int(i), int(n)))
    out = {}
    for root in sorted(edges):
        if root in out:
            continue
        val, todo = {root: 0}, [root]
        while todo:
            a = todo.pop()
            for b, d in edges[a]:
                if b not in val:
                    val[b] = val[a] + d
                    todo.append(b)
        out.update({s: (root, v) for s, v in val.items()})
    return out
