"""Factor evaluation machinery.

Every factor is a plain residual function of a local tangent; its Jacobian
comes from ``torch.func.jacrev`` of ``res(retract(x, t))`` at ``t = 0``,
vmapped over all rows of a batch.

A ``FactorBatch`` is the interchange format the solver consumes: whitened
residuals, whitened Jacobian w.r.t. the factor's stacked local tangent,
global tangent column indices, and a validity mask.  All fields carry the
window batch as leading dims.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map


class FactorBatch(NamedTuple):
    res: torch.Tensor    # (..., rows, R) whitened residuals (0 if invalid)
    jac: torch.Tensor    # (..., rows, R, D) whitened d res / d tangent
    gidx: torch.Tensor   # (..., rows, D) int64 global tangent indices
    valid: torch.Tensor  # (..., rows) bool


def block_indices(start, dim):
    """Global indices [start, start+dim) (start may be an index tensor)."""
    start = torch.as_tensor(start)
    return start[..., None] + torch.arange(dim, device=start.device)


def take_rows(x, idx):
    """Per-batch gather: ``out[b, ...] = x[b, idx[b, ...]]``.

    x is (B, n, ...), idx is (B, ...) integer; the result has shape
    idx.shape + x.shape[2:]."""
    b = torch.arange(x.shape[0], device=x.device)
    return x[b.view((-1,) + (1,) * (idx.dim() - 1)), idx]


def rowwise_res_jac(res_fn: Callable, tangent_dim: int, rows, lead_ndim: int,
                    consts=()):
    """(res, jac) of ``res_fn(t, row, *consts)`` at ``t = 0`` for every row.

    ``rows`` is a pytree of tensors whose first ``lead_ndim`` dims index
    the rows; they are flattened, vmapped, and restored.  ``consts`` are
    passed unbatched to every row.  Returns res (..., R) and jac
    (..., R, tangent_dim).
    """
    leaves = tree_leaves(rows)
    lead = tuple(leaves[0].shape[:lead_ndim])
    n = math.prod(lead)
    flat = tree_map(lambda x: x.reshape((n,) + x.shape[lead_ndim:]), rows)
    ref = next(x for x in leaves if x.is_floating_point())
    zero = torch.zeros(tangent_dim, dtype=ref.dtype, device=ref.device)

    def one(row):
        return (res_fn(zero, row, *consts),
                torch.func.jacrev(res_fn)(zero, row, *consts))

    res, jac = torch.func.vmap(one)(flat)
    return (res.reshape(lead + res.shape[1:]),
            jac.reshape(lead + jac.shape[1:]))
