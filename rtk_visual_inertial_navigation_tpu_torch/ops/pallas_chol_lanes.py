"""Batched small SPD solve: CUDA kernel and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_chol_lanes.py``, whose
Pallas kernel factored 128 systems at once with the batch in the TPU's
lanes.  ``chol_solve_lanes(S, rhs)`` keeps that name and contract — solve
S[b] x[b] = rhs[b] for (B, n, n) SPD float32 systems by a Cholesky column
recurrence whose pivot is a·rsqrt(max(a, 1e-30)), then forward and back
substitution — and runs:

  - on CUDA tensors: the hand-written kernel ``csrc/chol_lanes.cu`` (one
    thread block per system, the matrix in shared memory), counted in
    ``ops.pallas_proj.LAUNCHES``;
  - on CPU tensors: ``chol_solve_lanes_plain``, the same recurrence in
    batched torch.

No solve path calls it: the window solves factor with
``torch.linalg.cholesky_ex`` and reuse the factor for their refinement
solves, which a kernel that returns only x cannot serve.  Any other device
or dtype raises, and so does an n whose matrix does not fit in a block's
shared memory; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .pallas_proj import LAUNCHES

PIVOT_FLOOR = 1e-30


def _check(S, rhs):
    if S.dim() != 3 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"S must be (B, n, n), not {tuple(S.shape)}")
    if tuple(rhs.shape) != tuple(S.shape[:2]):
        raise ValueError(f"rhs must be {tuple(S.shape[:2])}, not "
                         f"{tuple(rhs.shape)}")
    if S.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError(f"chol_solve_lanes takes float32, not {S.dtype} / "
                        f"{rhs.dtype}")
    if S.device != rhs.device:
        raise ValueError(f"S on {S.device}, rhs on {rhs.device}")


def chol_solve_lanes_plain(S, rhs):
    """The kernel's recurrence in batched torch (float32, any device)."""
    _check(S, rhs)
    n = S.shape[-1]
    A = S.clone()
    for j in range(n):
        d = torch.rsqrt(torch.clamp_min(A[:, j, j], PIVOT_FLOOR))
        col = A[:, j:, j] * d[:, None]
        A[:, j:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    y = torch.zeros_like(rhs)
    for j in range(n):
        acc = (A[:, j, :j] * y[:, :j]).sum(-1)
        y[:, j] = (rhs[:, j] - acc) / A[:, j, j]
    x = torch.zeros_like(rhs)
    for j in range(n - 1, -1, -1):
        acc = (A[:, j + 1:, j] * x[:, j + 1:]).sum(-1)
        x[:, j] = (y[:, j] - acc) / A[:, j, j]
    return x


def _kernel():
    lib = load("chol_lanes")
    fn = lib.chol_lanes_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.chol_lanes_smem_bytes
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_size_t
    return fn, smem


def _chol_solve_cuda(S, rhs):
    _check(S, rhs)
    B, n = rhs.shape
    S, rhs = S.contiguous(), rhs.contiguous()
    x = torch.empty_like(rhs)
    fn, smem = _kernel()
    stream = torch.cuda.current_stream(S.device).cuda_stream
    rc = fn(S.data_ptr(), rhs.data_ptr(), x.data_ptr(), B, n, stream)
    if rc == 1:        # cudaErrorInvalidValue: the kernel refused this n
        raise ValueError(f"chol_solve_lanes: n={n} needs {smem(n)} bytes of "
                         f"shared memory per system, more than a block of "
                         f"this device may use")
    if rc != 0:
        raise RuntimeError(f"chol_lanes kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["chol_lanes"] += 1
    return x


def chol_solve_lanes(S, rhs):
    """x (B, n) with S[b] x[b] = rhs[b]; S (B, n, n) SPD float32."""
    if S.device.type == "cpu":
        return chol_solve_lanes_plain(S, rhs)
    if S.device.type != "cuda":
        raise ValueError(f"chol_solve_lanes runs on cuda or cpu, not "
                         f"{S.device}")
    return _chol_solve_cuda(S, rhs)
