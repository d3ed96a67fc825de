"""Block-structured Hessian assembly of the projection rows.

Per-row outer products are reduced into per-frame / per-landmark /
per-(frame, landmark) blocks by one-hot segment sums, and the blocks land
in the Schur-structured Hessian (``blocks_from_segments``) or in a dense
(D, D) one (``projection_assemble``) by static slice placement.  This is
the plain PyTorch path; on CUDA the fused kernel of ``ops/pallas_proj.py``
produces the same segment dict ``S`` for the flagship solve.
"""

from __future__ import annotations

import torch

from ..core.state import FRAME_DIM, POSE_DIM, TangentLayout
from .gauss_newton import one_hot


def _seg(O, x):
    """Σ_b O[..., b, s] x[..., b, ...] -> (..., s, ...)."""
    lead = x.shape[:O.dim() - 1]
    xf = x.reshape(lead + (-1,))
    out = O.transpose(-1, -2) @ xf
    return out.reshape(out.shape[:-1] + x.shape[O.dim() - 1:])


def _seg2(Oa, Ob, x):
    """Σ_b Oa[..., b, a] Ob[..., b, c] x[..., b, ...] -> (..., a, c, ...)."""
    lead = x.shape[:Oa.dim() - 1]
    ev = x.shape[Oa.dim() - 1:]
    xf = x.reshape(lead + (-1,))
    k = xf.shape[-1]
    # (Oa ⊗ x) first, then one matmul over b: never the (b, a, c) cube
    ax = (Oa[..., :, :, None] * xf[..., :, None, :]).flatten(-2)
    out = (ax.transpose(-1, -2) @ Ob)                # (..., a*k, c)
    out = out.unflatten(-2, (Oa.shape[-1], k)).transpose(-1, -2)
    return out.reshape(out.shape[:-1] + ev)


def _proj_segments(lay: TangentLayout, f_ids, cam_ids, l_ids, res, jac):
    """Per-frame/landmark/ext Gram blocks of a projection batch.

    res (..., nobs, 2), jac (..., nobs, 2, 15) [pose6 | ext6 | lm3]; ids
    (..., nobs).  Returns S with PP (..., nf,6,6), LL (..., nl,3,3), EE
    (..., nc,6,6), PL (..., nf,nl,6,3), PE (..., nf,nc,6,6), LE
    (..., nl,nc,6,3), GP (..., nf,6), GL (..., nl,3), GE (..., nc,6).
    """
    dtype = res.dtype
    Jp = jac[..., 0:6]
    Je = jac[..., 6:12]
    Jl = jac[..., 12:15]
    gram = lambda A, B: torch.einsum("...ri,...rj->...ij", A, B)
    grad = lambda A: torch.einsum("...ri,...r->...i", A, res)

    Of = one_hot(f_ids, lay.nf, dtype)
    Ol = one_hot(l_ids, lay.nl, dtype)
    Oc = one_hot(cam_ids, lay.nc, dtype)
    return dict(
        PP=_seg(Of, gram(Jp, Jp)), LL=_seg(Ol, gram(Jl, Jl)),
        EE=_seg(Oc, gram(Je, Je)),
        PL=_seg2(Of, Ol, gram(Jp, Jl)), PE=_seg2(Of, Oc, gram(Jp, Je)),
        LE=_seg2(Ol, Oc, gram(Je, Jl)),
        GP=_seg(Of, grad(Jp)), GL=_seg(Ol, grad(Jl)), GE=_seg(Oc, grad(Je)))


def projection_assemble_blocks(lay: TangentLayout, f_ids, cam_ids, l_ids,
                               res, jac):
    """(BlockHess, g, cost) for a projection batch — no dense (D, D)."""
    S = _proj_segments(lay, f_ids, cam_ids, l_ids, res, jac)
    cost = 0.5 * torch.sum(res * res, dim=(-2, -1))
    return blocks_from_segments(lay, S, cost)


def blocks_from_segments(lay: TangentLayout, S: dict, cost):
    """Place projection segment blocks S (as produced by ``_proj_segments``
    or the CUDA kernel ``ops.pallas_proj.proj_segments_pallas``) into
    (BlockHess, g, cost) for a batch of windows (leading dim B)."""
    from .block_hessian import BlockHess

    LL = S["LL"]
    dtype, device = LL.dtype, LL.device
    B = LL.shape[0]
    nf, nl, nc = lay.nf, lay.nl, lay.nc
    n3 = 3 * nl
    Dr = lay.dim - n3
    rfo = lay.frame_off - n3          # = 0: frames lead the reduced block
    reo = lay.ext_off - n3
    zeros = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=device)

    # landmark-reduced coupling: (nl,3,Dr) via padded grids
    PLg = zeros(nl, 3, nf, FRAME_DIM)
    PLg[..., 0:6] = S["PL"].permute(0, 2, 4, 1, 3)
    LEg = S["LE"].permute(0, 1, 4, 2, 3)             # (B, nl, 3, nc, 6)
    Hlr = zeros(nl, 3, Dr)
    Hlr[..., rfo:rfo + nf * FRAME_DIM] = PLg.reshape(B, nl, 3, -1)
    Hlr[..., reo:reo + nc * POSE_DIM] = LEg.reshape(B, nl, 3, -1)

    # reduced block: per-frame pose 6x6 + per-cam ext 6x6 + pose-ext grid
    Hrr = zeros(Dr, Dr)
    for f in range(nf):
        i = rfo + FRAME_DIM * f
        Hrr[:, i:i + 6, i:i + 6] += S["PP"][:, f]
    for c in range(nc):
        i = reo + POSE_DIM * c
        Hrr[:, i:i + 6, i:i + 6] += S["EE"][:, c]
    PEg = zeros(nf, FRAME_DIM, nc, POSE_DIM)
    PEg[:, :, 0:6] = S["PE"].permute(0, 1, 3, 2, 4)
    block = PEg.reshape(B, nf * FRAME_DIM, nc * POSE_DIM)
    Hrr[:, rfo:rfo + nf * FRAME_DIM, reo:reo + nc * POSE_DIM] += block
    Hrr[:, reo:reo + nc * POSE_DIM, rfo:rfo + nf * FRAME_DIM] += \
        block.transpose(-1, -2)

    g = zeros(lay.dim)
    g[:, 0:n3] = S["GL"].reshape(B, -1)
    for f in range(nf):
        i = lay.frame_off + FRAME_DIM * f
        g[:, i:i + 6] += S["GP"][:, f]
    for c in range(nc):
        i = lay.ext_off + POSE_DIM * c
        g[:, i:i + 6] += S["GE"][:, c]

    return BlockHess(LL, Hlr, Hrr), g, cost


def projection_assemble(lay: TangentLayout, f_ids, cam_ids, l_ids, res, jac):
    """Dense (H (..., D, D), g (..., D), cost (...,)) of a projection batch:
    the segment blocks of ``_proj_segments`` placed by static slices, no
    scatter into (D, D)."""
    S = _proj_segments(lay, f_ids, cam_ids, l_ids, res, jac)
    dtype, device = res.dtype, res.device
    lead = res.shape[:-2]
    nf, nl, nc = lay.nf, lay.nl, lay.nc
    n3, D = 3 * nl, lay.dim
    fo, eo = lay.frame_off, lay.ext_off
    nfr, ncr = nf * FRAME_DIM, nc * POSE_DIM
    zeros = lambda *s: torch.zeros(lead + s, dtype=dtype, device=device)
    H, g = zeros(D, D), zeros(D)

    for f in range(nf):
        i = fo + FRAME_DIM * f
        H[..., i:i + 6, i:i + 6] += S["PP"][..., f, :, :]
        g[..., i:i + 6] += S["GP"][..., f, :]
    for c in range(nc):
        i = eo + POSE_DIM * c
        H[..., i:i + 6, i:i + 6] += S["EE"][..., c, :, :]
        g[..., i:i + 6] += S["GE"][..., c, :]

    # landmark 3x3 blocks on the diagonal of the (nl, 3, nl, 3) view
    Hl = H[..., :n3, :n3].unflatten(-1, (nl, 3)).unflatten(-3, (nl, 3))
    torch.diagonal(Hl, dim1=-4, dim2=-2).add_(S["LL"].movedim(-3, -1))
    g[..., :n3] += S["GL"].flatten(-2)

    # pose-landmark grid: (nf, 6, nl, 3) padded to (nf, 15, nl, 3)
    PLg = zeros(nf, FRAME_DIM, nl, 3)
    PLg[..., 0:6, :, :] = S["PL"].transpose(-3, -2)
    block = PLg.reshape(lead + (nfr, n3))
    H[..., fo:fo + nfr, :n3] += block
    H[..., :n3, fo:fo + nfr] += block.transpose(-1, -2)

    # pose-extrinsic grid: (nf, 6, nc, 6) padded to (nf, 15, nc, 6)
    PEg = zeros(nf, FRAME_DIM, nc, POSE_DIM)
    PEg[..., 0:6, :, :] = S["PE"].transpose(-3, -2)
    block = PEg.reshape(lead + (nfr, ncr))
    H[..., fo:fo + nfr, eo:eo + ncr] += block
    H[..., eo:eo + ncr, fo:fo + nfr] += block.transpose(-1, -2)

    # landmark-extrinsic grid: (nl, nc, 6, 3) -> (nl·3, nc·6)
    LEg = S["LE"].permute(*range(len(lead)), -4, -1, -3, -2).reshape(
        lead + (n3, ncr))
    H[..., :n3, eo:eo + ncr] += LEg
    H[..., eo:eo + ncr, :n3] += LEg.transpose(-1, -2)

    return H, g, 0.5 * torch.sum(res * res, dim=(-2, -1))
