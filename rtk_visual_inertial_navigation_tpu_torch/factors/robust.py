"""Robust loss corrector for batched factors (ceres CauchyLoss parity).

Ceres' Corrector takes its simple branch whenever ``rho'' <= 0``, which is
always true for the Cauchy loss, so the exact behaviour is the IRLS
square-root rescale with no rank-1 term:

    s   = |r|²,  ρ(s) = a² log(1 + s/a²),  ρ' = 1 / (1 + s/a²)
    r̃  = √ρ' · r,   J̃ = √ρ' · J

The cost is ½Σρ(s), not ½Σ|r̃|²; callers add the returned ``cost_delta``.
"""

from __future__ import annotations

import torch


def cauchy_correct(res, jac, a: float = 1.0):
    """Apply the Cauchy(a) corrector to a whitened factor batch.

    Args:
      res: (..., rows, R) whitened residuals (masked rows already zeroed:
        they have s = 0, ρ' = 1, and are untouched).
      jac: (..., rows, R, T) whitened jacobians.
      a: Cauchy scale.

    Returns (res~, jac~, cost_delta) with cost_delta (...,) =
    Σᵢ ½(ρ(sᵢ) − ρ'(sᵢ)·sᵢ), to be added to ½Σ|r̃|² to get ½Σρ(s).
    """
    a2 = a * a
    s = torch.sum(res * res, dim=-1)
    rho1 = 1.0 / (1.0 + s / a2)
    w = torch.sqrt(rho1)
    rho = a2 * torch.log1p(s / a2)
    cost_delta = 0.5 * torch.sum(rho - rho1 * s, dim=-1)
    return res * w[..., None], jac * w[..., None, None], cost_delta


def cauchy_cost(res, a: float = 1.0):
    """½Σρ(|rᵢ|²) over the rows of ``res`` (..., rows, R): the true robust
    cost of uncorrected residuals, per window (...,)."""
    a2 = a * a
    s = torch.sum(res * res, dim=-1)
    return 0.5 * torch.sum(a2 * torch.log1p(s / a2), dim=-1)
