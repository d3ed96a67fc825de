"""Batched f32 Cholesky: factor and multi-RHS solve kernels, and their plain
PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_chol_lanes.py``, whose
Pallas kernel factored 128 systems at once with the batch in the TPU's
lanes (writing L into its aliased output) and then solved.  Here the
factor and the solves are two kernels, so that the window solves factor
once and solve three times (the f32 step refines twice):

  - ``chol_factor_lanes(S) -> (L, info)``: S (B, n, n) float32, lower
    triangle read; L lower, zero above the diagonal; info (B,) int32 as
    ``torch.linalg.cholesky_ex`` gives it (0, or 1 + the first column whose
    pivot a was ≤ 0 or not finite).  The pivot is a·rsqrt(max(a, 1e-30)),
    as in the TPU kernel, so the factor of a non-SPD input stays finite;
  - ``chol_solve_factored(L, b)``: x with L Lᵀ x = b, b (B, n) or
    (B, n, k), dividing by L_jj as the TPU kernel does;
  - ``chol_solve_lanes(S, rhs)``: the TPU kernel's contract, x only.

Each runs:

  - on CUDA tensors: the hand-written kernels ``csrc/chol_lanes.cu``
    (blocked factor, one thread-block cluster per system) and
    ``csrc/chol_lanes_solve.cu``, counted in ``ops.launches.LAUNCHES``
    under ``chol_lanes`` and ``chol_lanes_solve``;
  - on CPU tensors: the plain versions (``*_plain``), the same blocked
    recurrence in batched torch.

Any other device or dtype raises, and so does an n whose tiles fit no
cluster's shared memory; there is no fallback.  The plain versions also
take float64, which the tests use to check the algorithm exactly.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .launches import LAUNCHES

PIVOT_FLOOR = 1e-30
NB = 32          # the kernels' tile edge


def _check_factor(S):
    if S.dim() != 3 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"S must be (B, n, n), not {tuple(S.shape)}")
    if S.dtype != torch.float32:
        raise TypeError(f"the Cholesky kernels take float32, not {S.dtype}")


def _check_solve(L, b):
    _check_factor(L)
    if b.dim() not in (2, 3) or tuple(b.shape[:2]) != tuple(L.shape[:2]):
        raise ValueError(f"b must be {tuple(L.shape[:2])} or "
                         f"{tuple(L.shape[:2])} + (k,), not "
                         f"{tuple(b.shape)}")
    if b.dtype != torch.float32:
        raise TypeError(f"the Cholesky kernels take float32, not {b.dtype}")
    if L.device != b.device:
        raise ValueError(f"L on {L.device}, b on {b.device}")


def chol_factor_lanes_plain(S):
    """The factor kernel's blocked recurrence in batched torch: panels of
    32 columns, each column scaled by its pivot's d, then the rank-32
    update of the trailing lower block."""
    B, n, _ = S.shape
    A = torch.tril(S)
    info = torch.zeros(B, dtype=torch.int32, device=S.device)
    for p0 in range(0, n, NB):
        p1 = min(p0 + NB, n)
        for j in range(p0, p1):
            a = A[:, j, j]
            bad = ~((a > 0) & (a < float("inf")))
            info = torch.where((info == 0) & bad, j + 1, info)
            d = torch.rsqrt(torch.where(a < PIVOT_FLOOR, PIVOT_FLOOR, a))
            A[:, j:, j] *= d[:, None]
            A[:, j + 1:, j + 1:p1] -= A[:, j + 1:, j, None] \
                * A[:, None, j + 1:p1, j]
        P = A[:, p1:, p0:p1]
        A[:, p1:, p1:] -= torch.tril(P @ P.transpose(-1, -2))
    # the in-panel updates also wrote above the diagonal, which no step reads
    return torch.tril(A), info


def chol_solve_factored_plain(L, b):
    """The solve kernel's blocked substitutions in batched torch."""
    n = L.shape[-1]
    Y = (b[..., None] if b.dim() == 2 else b).clone()
    for p0 in range(0, n, NB):                      # L y = b
        p1 = min(p0 + NB, n)
        for j in range(p0, p1):
            Y[:, j] /= L[:, j, j, None]
            Y[:, j + 1:p1] -= L[:, j + 1:p1, j, None] * Y[:, j, None]
        Y[:, p1:] -= L[:, p1:, p0:p1] @ Y[:, p0:p1]
    for p0 in reversed(range(0, n, NB)):            # Lᵀ x = y
        p1 = min(p0 + NB, n)
        for j in range(p1 - 1, p0 - 1, -1):
            Y[:, j] /= L[:, j, j, None]
            Y[:, p0:j] -= L[:, j, p0:j, None] * Y[:, j, None]
        Y[:, :p0] -= L[:, p0:p1, :p0].transpose(-1, -2) @ Y[:, p0:p1]
    return Y[..., 0] if b.dim() == 2 else Y


def chol_solve_lanes_plain(S, rhs):
    """x (B, n) with S x = rhs: the plain factor, then the plain solve."""
    return chol_solve_factored_plain(chol_factor_lanes_plain(S)[0], rhs)


def _lib(name, fn_name, nargs_ptr, nargs_int, defines=()):
    fn = getattr(load(name, tuple(defines)), fn_name)
    fn.argtypes = [ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _factor_cluster(B, n):
    """CTAs per system the factor launcher takes for (B, n) on the current
    CUDA device (0: no cluster size fits)."""
    fn = load("chol_lanes").chol_lanes_factor_cluster
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(B, n)


def _raise(rc, what, n):
    if rc == 1:        # cudaErrorInvalidValue: the kernel refused this n
        raise ValueError(f"{what}: n={n} does not fit the shared memory of "
                         f"a thread-block cluster of this device")
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _factor_cuda(S, cluster=0, defines=()):
    """The factor launch.  ``cluster`` (CTAs per system, 1 to 8; 0 lets the
    launcher choose) and ``defines`` (a build of the kernel with other
    preprocessor defines) serve measurements."""
    B, n, _ = S.shape
    S = S.contiguous()
    L = torch.empty_like(S)
    info = torch.empty(B, dtype=torch.int32, device=S.device)
    if B == 0:
        return L, info
    fn = _lib("chol_lanes", "chol_lanes_factor_f32", 3, 3, defines)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    rc = fn(S.data_ptr(), L.data_ptr(), info.data_ptr(), B, n, cluster,
            stream)
    if rc != 0:
        _raise(rc, "chol_lanes", n)
    LAUNCHES["chol_lanes"] += 1
    return L, info


def _solve_cuda(L, b, defines=()):
    """The solve launch; ``defines`` as for ``_factor_cuda``."""
    B, n, _ = L.shape
    L, b = L.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    k = 1 if b.dim() == 2 else b.shape[-1]
    if B == 0 or k == 0:
        return x
    fn = _lib("chol_lanes_solve", "chol_lanes_solve_f32", 3, 3, defines)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    rc = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, k, stream)
    if rc != 0:
        _raise(rc, "chol_lanes_solve", n)
    LAUNCHES["chol_lanes_solve"] += 1
    return x


def _on(t, name):
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def chol_factor_lanes(S):
    """(L, info) of (B, n, n) SPD float32 S."""
    _check_factor(S)
    if _on(S, "chol_factor_lanes"):
        return _factor_cuda(S)
    return chol_factor_lanes_plain(S)


def chol_solve_factored(L, b):
    """x with L Lᵀ x = b; L (B, n, n) lower float32, b (B, n) or (B, n, k)."""
    _check_solve(L, b)
    if _on(L, "chol_solve_factored"):
        return _solve_cuda(L, b)
    return chol_solve_factored_plain(L, b)


def chol_solve_lanes(S, rhs):
    """x (B, n) with S[b] x[b] = rhs[b]; S (B, n, n) SPD float32."""
    _check_factor(S)
    if rhs.dim() != 2:
        raise ValueError(f"rhs must be {tuple(S.shape[:2])}, not "
                         f"{tuple(rhs.shape)}")
    _check_solve(S, rhs)
    return chol_solve_factored(chol_factor_lanes(S)[0], rhs)
