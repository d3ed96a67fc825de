"""Block-structured Hessian: the flagship solve without the dense (D,D).

The tangent layout is [landmarks(3·nl) | frames | ext | mag | clk | pb];
the landmark block is 3x3-block-DIAGONAL by construction (a projection row
touches one landmark; nothing else touches landmarks), so the Hessian is
kept in its Schur structure end to end:

    H  ~=  [[ Hll,   Hlr ],        Hll: (..., nl, 3, 3)   block diagonal
            [ Hlrᵀ,  Hrr ]]        Hlr: (..., nl, 3, Dr)  landmark-reduced
                                   Hrr: (..., Dr, Dr)     reduced dense

The gradient stays a flat (..., D) vector.  ``dogleg_solve`` uses this
object wherever it takes a dense H, through duck-typed ``matvec`` /
``mask`` / ``gn_step`` / ``tail_cov`` methods.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._pytree import tree_map

from ..core.state import FRAME_DIM
from .gauss_newton import _chol_solve_scaled, _jacobi_scale, inv33, one_hot


class BlockHess(NamedTuple):
    """Schur-structured Hessian of a batch of windows."""

    Hll: torch.Tensor   # (..., nl, 3, 3) landmark diagonal blocks
    Hlr: torch.Tensor   # (..., nl, 3, Dr) landmark-to-reduced coupling
    Hrr: torch.Tensor   # (..., Dr, Dr) reduced (frames|ext|mag|clk|pb) block

    @property
    def nl(self):
        return self.Hll.shape[-3]

    @property
    def n3(self):
        return 3 * self.nl

    @property
    def Dr(self):
        return self.Hrr.shape[-1]

    @property
    def dim(self):
        return self.n3 + self.Dr

    def diagonal(self) -> torch.Tensor:
        dl = torch.diagonal(self.Hll, dim1=-2, dim2=-1).flatten(-2)
        return torch.cat(
            [dl, torch.diagonal(self.Hrr, dim1=-2, dim2=-1)], dim=-1)

    def matvec(self, p: torch.Tensor) -> torch.Tensor:
        pl = p[..., :self.n3].unflatten(-1, (self.nl, 3))
        pr = p[..., self.n3:]
        ol = (torch.einsum("...lij,...lj->...li", self.Hll, pl)
              + torch.einsum("...lir,...r->...li", self.Hlr, pr))
        orr = (torch.einsum("...lir,...li->...r", self.Hlr, pl)
               + (self.Hrr @ pr[..., None])[..., 0])
        return torch.cat([ol.flatten(-2), orr], dim=-1)

    def add(self, other: "BlockHess") -> "BlockHess":
        return BlockHess(*tree_map(torch.add, tuple(self), tuple(other)))

    def mask(self, g, free_mask):
        """Dense ``apply_free_mask`` semantics, per block: fixed or
        structurally-empty slots get unit diagonal, zero coupling, zero
        gradient."""
        free = free_mask & (self.diagonal() > 0)
        m = free.to(self.Hrr.dtype)
        ml = m[..., :self.n3].unflatten(-1, (self.nl, 3))
        mr = m[..., self.n3:]
        eye3 = torch.eye(3, dtype=m.dtype, device=m.device)
        Hll = (self.Hll * ml[..., :, None] * ml[..., None, :]
               + eye3 * (1.0 - ml)[..., :, None])
        Hlr = self.Hlr * ml[..., :, None] * mr[..., None, None, :]
        Hrr = (self.Hrr * mr[..., :, None] * mr[..., None, :]
               + torch.diag_embed(1.0 - mr))
        return BlockHess(Hll, Hlr, Hrr), g * m, free

    def _schur(self):
        """Guarded landmark elimination: (Hll⁻¹, Hll⁻¹Hlr, S).

        A landmark whose 3x3 block is (near-)singular is held, not
        inverted: the determinant of the trace-normalized block is tested
        (scale-free, safe in f32), and bad blocks get Hll⁻¹ = 0, which
        zeroes their step and their Schur coupling."""
        Hll = self.Hll
        tiny = torch.finfo(Hll.dtype).tiny
        tr3 = torch.clamp_min(
            (Hll[..., 0, 0] + Hll[..., 1, 1] + Hll[..., 2, 2]) / 3.0, tiny)
        Hn = Hll / tr3[..., None, None]
        det_n = (
            Hn[..., 0, 0] * (Hn[..., 1, 1] * Hn[..., 2, 2]
                             - Hn[..., 1, 2] * Hn[..., 2, 1])
            - Hn[..., 0, 1] * (Hn[..., 1, 0] * Hn[..., 2, 2]
                               - Hn[..., 1, 2] * Hn[..., 2, 0])
            + Hn[..., 0, 2] * (Hn[..., 1, 0] * Hn[..., 2, 1]
                               - Hn[..., 1, 1] * Hn[..., 2, 0]))
        blk_ok = det_n > 256.0 * torch.finfo(Hll.dtype).eps
        Hll_inv = torch.where(blk_ok[..., None, None], inv33(Hll), 0.0)
        HinvHlr = Hll_inv @ self.Hlr
        S = self.Hrr - torch.einsum("...lir,...lik->...rk", self.Hlr,
                                    HinvHlr)
        return Hll_inv, HinvHlr, S

    def gn_step(self, g, keep=None, step_dtype: str = "same") -> torch.Tensor:
        """Gauss-Newton step via landmark Schur elimination.  With ``keep``
        (an int64 index tensor of reduced slots, on g's device), only those
        slots enter the Cholesky; None keeps all."""
        Hll_inv, HinvHlr, S = self._schur()
        gl = g[..., :self.n3].unflatten(-1, (self.nl, 3))
        gr = g[..., self.n3:]
        Hinv_gl = (Hll_inv @ gl[..., None])[..., 0]
        rhs = gr - torch.einsum("...lir,...li->...r", self.Hlr, Hinv_gl)
        if keep is not None:
            Sk = S[..., keep, :][..., keep]
            rk = rhs[..., keep]
            sk = _jacobi_scale(Sk)
            drk = -sk * _chol_solve_scaled(
                Sk * sk[..., :, None] * sk[..., None, :], sk * rk,
                step_dtype)
            dr = torch.zeros_like(rhs)
            dr[..., keep] = drk
        else:
            s = _jacobi_scale(S)
            dr = -s * _chol_solve_scaled(
                S * s[..., :, None] * s[..., None, :], s * rhs, step_dtype)
        dl = -(Hinv_gl + torch.einsum("...lir,...r->...li", HinvHlr, dr))
        return torch.cat([dl.flatten(-2), dr], dim=-1)

    def tail_cov(self, free_mask, cols) -> torch.Tensor:
        """(..., D, k) covariance columns of the masked system for columns
        in the REDUCED region (cols (..., k) are global tangent indices
        ≥ 3·nl):

            X_r = S⁻¹ E_r,   X_l = -Hll⁻¹ Hlr X_r

        through the same guarded elimination as the step (a frozen
        landmark contributes zero covariance columns)."""
        bh, _, _ = self.mask(torch.zeros_like(free_mask, dtype=self.Hrr.dtype),
                             free_mask)
        _, HinvHlr, S = bh._schur()
        E = torch.zeros(S.shape[:-1] + (cols.shape[-1],), dtype=S.dtype,
                        device=S.device)
        E.scatter_(-2, (cols - self.n3)[..., None, :], 1.0)
        s = _jacobi_scale(S)
        Xr = s[..., :, None] * _chol_solve_scaled(
            S * s[..., :, None] * s[..., None, :], s[..., :, None] * E)
        Xl = -torch.einsum("...lir,...rk->...lik", HinvHlr, Xr)
        return torch.cat([Xl.flatten(-3, -2), Xr], dim=-2)


def chain_blocks_into(bh: BlockHess, g, Hb, gb, left, right, lay):
    """Scatter-free accumulation of condensed chain blocks into (bh, g).

    ``Hb``: (B, nch, 2·15+dn, 2·15+dn) per-chain condensed Hessians over
    [left-frame 15 | right-frame 15 | ambiguity tail dn]; ``left/right``:
    (B, nch) window frame ids.  Placement is by one-hot contractions
    (deterministic, unlike an atomic index_add on the GPU).
    """
    dtype = Hb.dtype
    nf, dn = lay.nf, lay.nb
    n3 = 3 * lay.nl
    d = FRAME_DIM
    nfr = nf * d
    pbr = lay.pb_off - n3

    # P[..., c, r, u]: block row r (0..29) of chain c lands at reduced-frame
    # column u = 15·frame + (r mod 15)
    dcol = torch.arange(d, device=left.device)
    rows_u = torch.cat([left[..., None] * d + dcol,
                        right[..., None] * d + dcol], dim=-1)
    P = one_hot(rows_u, nfr, dtype)                        # (B,nch,30,nfr)
    Pt = P.transpose(-1, -2)
    Hff = Hb[..., :2 * d, :2 * d]
    grid = (Pt @ Hff @ P).sum(-3)                          # (B, nfr, nfr)
    colN = (Pt @ Hb[..., :2 * d, 2 * d:]).sum(-3)          # (B, nfr, dn)
    gf = (Pt @ gb[..., :2 * d, None]).sum(-3)[..., 0]      # (B, nfr)

    Hrr = bh.Hrr.clone()
    Hrr[..., 0:nfr, 0:nfr] += grid
    Hrr[..., 0:nfr, pbr:pbr + dn] += colN
    Hrr[..., pbr:pbr + dn, 0:nfr] += colN.transpose(-1, -2)
    Hrr[..., pbr:pbr + dn, pbr:pbr + dn] += Hb[..., 2 * d:, 2 * d:].sum(-3)
    g = g.clone()
    g[..., lay.frame_off:lay.frame_off + nfr] += gf
    g[..., lay.pb_off:lay.pb_off + dn] += gb[..., 2 * d:].sum(-2)
    return bh._replace(Hrr=Hrr), g
