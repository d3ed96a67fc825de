"""The linearized marginalization prior, batched over windows.

    r(x) = r₀ + J₀ · (x ⊟ x₀)

over the full window tangent (MarginalizationFactor::Evaluate semantics):
one (..., R, D) Jacobian, residual and linearization state per window, no
per-block bookkeeping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import WindowState, window_boxminus


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


class MargPrior(NamedTuple):
    """Linearized prior over the full window tangent (rows zero-padded).

    ``H0``/``g0``/``c0`` optionally carry its information form (H0 = JᵀJ,
    g0 = Jᵀr₀, c0 = |r₀|²); when present, evaluation needs no JᵀJ product.
    """

    J: torch.Tensor           # (..., R, D)
    r0: torch.Tensor          # (..., R)
    x0: WindowState           # linearization point
    valid_rows: torch.Tensor  # (..., R) bool
    H0: torch.Tensor = None   # optional (..., D, D) information matrix
    g0: torch.Tensor = None   # optional (..., D) information vector
    c0: torch.Tensor = None   # optional (...,) |r0|²

    def residual(self, state: WindowState):
        dx = window_boxminus(state, self.x0)
        return (self.r0 + _mv(self.J, dx)) * self.valid_rows

    def hessian_contrib(self, state: WindowState):
        """(H, g, cost_half) contribution at the current state."""
        r = self.residual(state)
        Jm = self.J * self.valid_rows[..., None]
        Jt = Jm.transpose(-1, -2)
        return Jt @ Jm, _mv(Jt, r), 0.5 * torch.sum(r * r, dim=-1)

    def precompute(self):
        """state -> (H, g, cost_half) with JᵀJ formed once per solve.

        The prior is linear, so within a solve H = JᵀJ is constant and
        only g and the cost move with the state:
            g(dx) = g₀ + H·dx,   2·cost(dx) = c₀ + 2 g₀ᵀdx + dxᵀH dx.
        """
        if self.H0 is not None:
            H0, g0, c0 = self.H0, self.g0, self.c0
        else:
            Jm = self.J * self.valid_rows[..., None]
            rm = self.r0 * self.valid_rows
            Jt = Jm.transpose(-1, -2)
            H0, g0, c0 = Jt @ Jm, _mv(Jt, rm), torch.sum(rm * rm, dim=-1)
        x0 = self.x0

        def contrib(state):
            dx = window_boxminus(state, x0)
            Hdx = _mv(H0, dx)
            g = g0 + Hdx
            cost = 0.5 * (c0 + 2.0 * torch.sum(g0 * dx, dim=-1)
                          + torch.sum(dx * Hdx, dim=-1))
            return H0, g, cost

        return contrib

    @staticmethod
    def empty(dim: int, rows: int, x0: WindowState, dtype=torch.float64):
        lead = x0.phase_bias.shape[:-1]
        dev = x0.p.device
        return MargPrior(
            J=torch.zeros(lead + (rows, dim), dtype=dtype, device=dev),
            r0=torch.zeros(lead + (rows,), dtype=dtype, device=dev),
            x0=x0,
            valid_rows=torch.zeros(lead + (rows,), dtype=torch.bool,
                                   device=dev))


def initial_prior(lay, x0: WindowState, entries, rows: int,
                  dtype=torch.float64) -> MargPrior:
    """A bootstrap prior as a diagonal MargPrior: each (tangent index,
    weight) of ``entries`` pins that direction at ``x0`` with residual
    weight·(x ⊟ x0)."""
    prior = MargPrior.empty(lay.dim, rows, x0, dtype)
    for row, (gi, w) in enumerate(entries):
        prior.J[..., row, gi] = w
        prior.valid_rows[..., row] = True
    return prior
